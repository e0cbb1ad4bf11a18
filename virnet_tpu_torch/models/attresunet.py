"""RNet — the attention-conditioned residual U-Net (counterpart of
virnet_tpu/models/attresunet.py; reference networks/AttResUNet.py).

The input is reflect-padded to a multiple of 2^(depth-1) and the output
cropped back, with a global residual.  Extra maps (sqrt(sigma)) condition
the head input ('input'/'both') and/or every scale of the down path
('down'/'both') through SFT AttLayers.  The down path is n_resblocks
AttResBlocks and a stride-2 conv per scale; the up path a 2x2-stride-2
ConvTranspose, an additive skip and unconditioned AttResBlocks.  The tail
conv and the residual run as one K4 launch on the card.

Parameter names are the reference torch keys (``head``,
``down_path.{i}.body.{j}.conv{1,2}``, ``down_path.{i}.downsampler``,
``up_path.{k}.upsampler``, ``up_path.{k}.body.{b}``, ``tail``);
``up_path[k]`` is the JAX package's ``up_{depth-2-k}``.  Inside, tensors
are NCHW in shape and channels_last in memory.  The compact (N, 1, 1, C)
conditioning of the SISR model is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.fused_conv import conv3x3_tail_residual
from ..ops.pad import pad_to_multiple
from ..ops.upsample import conv_transpose_2x2
from .common import (conv, conv_hwio, lrelu, make_conv, to_nchw, to_nhwc,
                     torch_default_init_)

MODES = ("null", "input", "down", "both")


class AttLayer(nn.Module):
    def __init__(self, out_chn: int, extra_chn: int):
        super().__init__()
        nf1, nf2 = out_chn // 8, out_chn // 4
        self.conv1 = make_conv(extra_chn, nf1, 1)
        self.conv2 = make_conv(nf1, nf2, 1)
        self.mul_conv = make_conv(nf2, out_chn, 1)
        self.add_conv = make_conv(nf2, out_chn, 1)

    def forward(self, extra):
        f = lrelu(conv(self.conv1, extra), 0.2)
        f = lrelu(conv(self.conv2, f), 0.2)
        # sigmoid in float64 for the reason ops/fused_conv.exp_clip gives
        mul = conv(self.mul_conv, f)
        return (torch.sigmoid(mul.double()).to(mul.dtype),
                conv(self.add_conv, f))


class AttResBlock(nn.Module):
    """``extra_chn`` > 0 makes the block conditioned (sft1/sft2)."""

    def __init__(self, nf: int, extra_chn: int = 0):
        super().__init__()
        if extra_chn > 0:
            self.sft1 = AttLayer(nf, extra_chn)
            self.sft2 = AttLayer(nf, extra_chn)
        self.conditioned = extra_chn > 0
        self.conv1 = make_conv(nf, nf, 3)
        self.conv2 = make_conv(nf, nf, 3)

    def forward(self, x, extra):
        t = x
        if self.conditioned:
            mul, add = self.sft1(extra)
            t = x * mul + add
        f = conv(self.conv1, lrelu(t, 0.2))
        if self.conditioned:
            mul, add = self.sft2(extra)
            f = f * mul + add
        f = conv(self.conv2, lrelu(f, 0.2))
        return x + f


class DownBlock(nn.Module):
    def __init__(self, nf: int, nf_next: Optional[int], n_resblocks: int,
                 extra_chn: int):
        super().__init__()
        self.body = nn.ModuleList(
            [AttResBlock(nf, extra_chn) for _ in range(n_resblocks)])
        if nf_next is not None:
            self.downsampler = make_conv(nf, nf_next, 3, stride=2)


class UpBlock(nn.Module):
    def __init__(self, in_chn: int, out_chn: int, n_resblocks: int):
        super().__init__()
        self.upsampler = nn.ConvTranspose2d(in_chn, out_chn, 2, stride=2)
        # the JAX package's torch_kernel_init on the (2, 2, in, out) kernel
        torch_default_init_(self.upsampler.weight, self.upsampler.bias,
                            4 * in_chn)
        self.body = nn.ModuleList(
            [AttResBlock(out_chn, 0) for _ in range(n_resblocks)])

    def forward(self, x, bridge):
        x_up = conv_transpose_2x2(x, self.upsampler.weight,
                                  self.upsampler.bias)
        for ii, blk in enumerate(self.body):
            x_up = blk(x_up + bridge if ii == 0 else x_up, None)
        return x_up


class AttResUNet(nn.Module):
    def __init__(self, in_chn: int = 3, extra_chn: int = 1, out_chn: int = 3,
                 n_feat: Sequence[int] = (64, 128, 196, 256),
                 n_resblocks: int = 2, extra_mode: str = "input"):
        super().__init__()
        mode = extra_mode.lower()
        if mode not in MODES:
            raise ValueError(f"extra_mode must be one of {MODES}")
        self.extra_mode = mode
        self.n_feat = tuple(n_feat)
        depth = len(n_feat)
        head_in = in_chn + (extra_chn if mode in ("input", "both") else 0)
        self.head = make_conv(head_in, n_feat[0], 3)
        extra_down = extra_chn if mode in ("down", "both") else 0
        self.down_path = nn.ModuleList(
            [DownBlock(n_feat[i], n_feat[i + 1] if i + 1 < depth else None,
                       n_resblocks, extra_down)
             for i in range(depth)])
        self.up_path = nn.ModuleList(
            [UpBlock(n_feat[jj + 1], n_feat[jj], n_resblocks)
             for jj in reversed(range(depth - 1))])
        self.tail = make_conv(n_feat[0], out_chn, 3)

    def forward(self, x_in: torch.Tensor, extra_in: Optional[torch.Tensor],
                head_pre: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x_in (N, H, W, C) image, extra_in (N, H, W, E) or None,
        head_pre (N, H, W, n_feat[0]): the head activation computed by
        the fused prologue (K3), legal only where no pad is needed and
        the down path is unconditioned.  Returns NHWC in x_in's dtype."""
        mode = self.extra_mode
        depth = len(self.n_feat)
        h, w = x_in.shape[1], x_in.shape[2]
        mod = 2 ** (depth - 1)
        extra = None
        if head_pre is not None:
            if h % mod or w % mod:
                raise ValueError("head_pre path requires pad-free sizes")
            if mode not in ("null", "input"):
                raise ValueError("head_pre path cannot condition the "
                                 "down path")
            x = to_nchw(head_pre)
        else:
            xp = pad_to_multiple(x_in, mod)
            if mode != "null":
                extra = to_nchw(pad_to_multiple(extra_in, mod))
            head_in = to_nchw(xp)
            if mode in ("input", "both"):
                head_in = torch.cat([head_in, extra.to(head_in.dtype)], 1)
            x = conv(self.head, head_in)

        cond_down = mode in ("down", "both")
        extra_cur = extra
        bridges = []
        for ii, down in enumerate(self.down_path):
            for blk in down.body:
                x = blk(x, extra_cur if cond_down else None)
            if ii + 1 < depth:
                bridges.append(x)
                x = conv(down.downsampler, x)
                if cond_down:
                    extra_cur = F.interpolate(extra, size=x.shape[-2:],
                                              mode="nearest")
        for k, up in enumerate(self.up_path):
            x = up(x, bridges[depth - 2 - k])
        return conv3x3_tail_residual(to_nhwc(x), x_in.contiguous(),
                                     conv_hwio(self.tail), self.tail.bias)
