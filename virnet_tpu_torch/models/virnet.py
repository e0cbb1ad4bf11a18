"""Top-level VIRNet models (counterpart of virnet_tpu/models/virnet.py;
reference networks/VIRNet.py).

``VIRNet``   — blind denoising: SNet predicts a per-pixel noise variance
               sigma, RNet restores the image conditioned on sqrt(sigma).
``VIRNetSR`` — blind SISR: adds KNet, which predicts the blur-kernel
               covariance info (l1, l2, rho); the LR input is
               nearest-upsampled x sf and RNet is conditioned on the
               kernel info and the noise level.

``conv_impl`` chooses how SNet's stack and RNet's tail run: 'fused' (K2 /
K3 and K4) and 'ops' (K1) are the forward-only serving routes, 'torch'
runs them through ``F.conv2d`` with autograd and is what the trainers
build; ``remat`` (RNet's blocks recomputed in the backward,
models/attresunet.py) needs it.

In the denoising model, on shapes that pass ``models/fused.fused_head_supported`` the forward runs
SNet, the sigma epilogue and RNet's head conv through K3 (one launch in
bf16, the SNet level chain in fp32) and continues RNet from the head
activation; other shapes run SNet (K2, or K1
on the 'ops' route), the epilogue and RNet's pad and head in torch.  The
RNet tail is K4 on every shape.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn

from ..eval.profiling import span
from ..ops.fused_conv import exp_clip
from .attresunet import AttResUNet
from .dncnn import DnCNN
from .knet import KernelNet

LOG_MAX = math.log(1e2)
LOG_MIN = math.log(1e-10)


class VIRNet(nn.Module):
    def __init__(self, im_chn: int = 3, sigma_chn: int = 3,
                 n_feat: Sequence[int] = (64, 128, 192), dep_S: int = 5,
                 n_resblocks: int = 2, noise_cond: bool = True,
                 extra_mode: str = "input", conv_impl: str = "fused",
                 remat: bool = False):
        super().__init__()
        _check_remat(remat, conv_impl)
        self.n_feat = tuple(n_feat)
        self.dep_S = dep_S
        self.noise_cond = noise_cond
        self.extra_mode = extra_mode.lower() if noise_cond else "null"
        self.conv_impl = conv_impl
        self.SNet = DnCNN(im_chn, sigma_chn, dep_S, conv_impl=conv_impl)
        self.RNet = AttResUNet(im_chn, sigma_chn, im_chn, n_feat,
                               n_resblocks, self.extra_mode,
                               tail_impl=_tail_impl(conv_impl), remat=remat)

    @property
    def dtype(self) -> torch.dtype:
        return self.SNet.conv1.weight.dtype

    def forward(self, x: torch.Tensor):
        """x (N, H, W, C) noisy, float32 -> (mu (N, H, W, C) float32,
        sigma (N, H, W, sigma_chn) in the parameter dtype)."""
        from .fused import denoise_forward_fused, fused_head_supported

        if fused_head_supported(self, x.shape):
            return denoise_forward_fused(self, x)
        with span("model.snet"):
            logits = self.SNet(x)
            sigma = exp_clip(logits, LOG_MIN, LOG_MAX).to(logits.dtype)
            extra = torch.sqrt(sigma) if self.noise_cond else None
        with span("model.rnet"):
            return self.RNet(x, extra), sigma

    def restore_from_head(self, x: torch.Tensor,
                          head_pre: torch.Tensor) -> torch.Tensor:
        """RNet continuation after the fused prologue (K3)."""
        return self.RNet(x, None, head_pre=head_pre)


def _tail_impl(conv_impl: str) -> str:
    return "torch" if conv_impl == "torch" else "fused"


def _check_remat(remat: bool, conv_impl: str) -> None:
    if remat and conv_impl != "torch":
        raise ValueError("remat recomputes blocks in the backward: it needs "
                         "conv_impl='torch' (the kernels are forward-only)")


def nearest_upsample(x: torch.Tensor, sf: int) -> torch.Tensor:
    """NHWC nearest-neighbour upsample by an integer factor."""
    return x.repeat_interleave(sf, dim=1).repeat_interleave(sf, dim=2)


class VIRNetSR(nn.Module):
    """SISR VIRNet (reference VIRAttResUNetSR, networks/VIRNet.py:48-97)."""

    def __init__(self, im_chn: int = 3, sigma_chn: int = 1,
                 kernel_chn: int = 3, n_feat: Sequence[int] = (64, 128, 192),
                 dep_S: int = 5, dep_K: int = 8, noise_cond: bool = True,
                 kernel_cond: bool = True, n_resblocks: int = 1,
                 extra_mode: str = "down", noise_avg: bool = True,
                 conv_impl: str = "fused", remat: bool = False):
        super().__init__()
        _check_remat(remat, conv_impl)
        self.n_feat = tuple(n_feat)
        self.dep_S = dep_S
        self.dep_K = dep_K
        self.noise_cond = noise_cond
        self.kernel_cond = kernel_cond
        self.noise_avg = noise_avg
        cond = noise_cond or kernel_cond
        self.extra_mode = extra_mode.lower() if cond else "null"
        self.conv_impl = conv_impl
        self.SNet = DnCNN(im_chn, sigma_chn, dep_S, conv_impl=conv_impl,
                          noise_avg=noise_avg)
        self.KNet = KernelNet(im_chn, kernel_chn, num_blocks=dep_K)
        extra_chn = ((kernel_chn if kernel_cond else 0)
                     + (sigma_chn if noise_cond else 0))
        self.RNet = AttResUNet(im_chn, extra_chn, im_chn, n_feat,
                               n_resblocks, self.extra_mode,
                               tail_impl=_tail_impl(conv_impl), remat=remat)

    @property
    def dtype(self) -> torch.dtype:
        return self.SNet.conv1.weight.dtype

    def forward(self, x: torch.Tensor, sf: int):
        """x (N, h, w, C) LR input, sf the integer scale factor -> (mu (N,
        h*sf, w*sf, C), kinfo (N, 3), sigma); sigma is (N, 1, 1, sigma_chn)
        with ``noise_avg``, else a map at the LR size."""
        logits = self.SNet(x)
        sigma = exp_clip(logits, LOG_MIN, LOG_MAX).to(logits.dtype)
        kinfo = self.KNet(x)                                    # N x 3
        x_up = nearest_upsample(x, sf)

        # When every conditioning map is constant per sample (kinfo always
        # is; sigma is with noise_avg), RNet takes the compact (N, 1, 1, E)
        # form: broadcast for the head concat, SFT gates at 1x1.
        compact = not self.noise_cond or self.noise_avg
        extras = []
        if self.kernel_cond:
            kmap = kinfo[:, None, None, :]
            if not compact:
                kmap = kmap.expand(-1, x_up.shape[1], x_up.shape[2], -1)
            extras.append(kmap.to(x.dtype))
        if self.noise_cond:
            s = torch.sqrt(sigma)
            extras.append((s if self.noise_avg
                           else nearest_upsample(s, sf)).to(x.dtype))
        extra = torch.cat(extras, dim=-1) if extras else None
        return self.RNet(x_up, extra), kinfo, sigma


# Released-checkpoint presets (reference scripts/testing_demo.py:21-75)
ARCH_PRESETS = {
    "denoising-syn": dict(im_chn=3, sigma_chn=1, n_feat=(96, 192, 288),
                          dep_S=5, n_resblocks=3, extra_mode="input",
                          noise_cond=True),
    "denoising-real": dict(im_chn=3, sigma_chn=3, n_feat=(96, 160, 224, 288),
                           dep_S=8, n_resblocks=3, extra_mode="input",
                           noise_cond=True),
    "sisr": dict(cls="VIRNetSR", im_chn=3, sigma_chn=1, kernel_chn=3,
                 n_feat=(96, 160, 224), dep_S=5, dep_K=8, n_resblocks=2,
                 extra_mode="both", noise_cond=True, kernel_cond=True,
                 noise_avg=True),
}


def build_model(task: str, **overrides):
    """A model from a released-checkpoint preset name (on the CPU, in
    fp32; move it with ``.to(device, dtype)``)."""
    if task not in ARCH_PRESETS:
        raise ValueError(f"task must be one of {sorted(ARCH_PRESETS)}, "
                         f"got {task!r}")
    cfg = dict(ARCH_PRESETS[task])
    cls = VIRNetSR if cfg.pop("cls", "VIRNet") == "VIRNetSR" else VIRNet
    cfg.update(overrides)
    return cls(**cfg)
