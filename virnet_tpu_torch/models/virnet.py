"""Denoising VIRNet (counterpart of virnet_tpu/models/virnet.py; reference
networks/VIRNet.py:18-46): SNet predicts a per-pixel noise variance
sigma, RNet restores the image conditioned on sqrt(sigma).

On shapes that pass ``models/fused.fused_head_supported`` the forward runs
SNet, the sigma epilogue and RNet's head conv as one K3 launch and
continues RNet from the head activation; other shapes run SNet (K2, or K1
on the 'ops' route), the epilogue and RNet's pad and head in torch.  The
RNet tail is K4 on every shape.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn

from ..ops.fused_conv import exp_clip
from .attresunet import AttResUNet
from .dncnn import DnCNN

LOG_MAX = math.log(1e2)
LOG_MIN = math.log(1e-10)


class VIRNet(nn.Module):
    def __init__(self, im_chn: int = 3, sigma_chn: int = 3,
                 n_feat: Sequence[int] = (64, 128, 192), dep_S: int = 5,
                 n_resblocks: int = 2, noise_cond: bool = True,
                 extra_mode: str = "input", conv_impl: str = "fused"):
        super().__init__()
        self.n_feat = tuple(n_feat)
        self.dep_S = dep_S
        self.noise_cond = noise_cond
        self.extra_mode = extra_mode.lower() if noise_cond else "null"
        self.conv_impl = conv_impl
        self.SNet = DnCNN(im_chn, sigma_chn, dep_S, conv_impl=conv_impl)
        self.RNet = AttResUNet(im_chn, sigma_chn, im_chn, n_feat,
                               n_resblocks, self.extra_mode)

    @property
    def dtype(self) -> torch.dtype:
        return self.SNet.conv1.weight.dtype

    def forward(self, x: torch.Tensor):
        """x (N, H, W, C) noisy, float32 -> (mu (N, H, W, C) float32,
        sigma (N, H, W, sigma_chn) in the parameter dtype)."""
        from .fused import denoise_forward_fused, fused_head_supported

        if fused_head_supported(self, x.shape):
            return denoise_forward_fused(self, x)
        logits = self.SNet(x)
        sigma = exp_clip(logits, LOG_MIN, LOG_MAX).to(logits.dtype)
        extra = torch.sqrt(sigma) if self.noise_cond else None
        return self.RNet(x, extra), sigma

    def restore_from_head(self, x: torch.Tensor,
                          head_pre: torch.Tensor) -> torch.Tensor:
        """RNet continuation after the fused prologue (K3)."""
        return self.RNet(x, None, head_pre=head_pre)


# Released-checkpoint presets (reference scripts/testing_demo.py:21-75);
# the SISR preset comes with the SISR slice.
ARCH_PRESETS = {
    "denoising-syn": dict(im_chn=3, sigma_chn=1, n_feat=(96, 192, 288),
                          dep_S=5, n_resblocks=3, extra_mode="input",
                          noise_cond=True),
    "denoising-real": dict(im_chn=3, sigma_chn=3, n_feat=(96, 160, 224, 288),
                           dep_S=8, n_resblocks=3, extra_mode="input",
                           noise_cond=True),
}


def build_model(task: str, **overrides) -> VIRNet:
    """A model from a released-checkpoint preset name (on the CPU, in
    fp32; move it with ``.to(device, dtype)``)."""
    if task not in ARCH_PRESETS:
        raise ValueError(f"task must be one of {sorted(ARCH_PRESETS)}, "
                         f"got {task!r}")
    cfg = dict(ARCH_PRESETS[task])
    cfg.update(overrides)
    return VIRNet(**cfg)
