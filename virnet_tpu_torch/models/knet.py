"""KNet — the blur-kernel covariance estimator (counterpart of
virnet_tpu/models/knet.py; reference networks/KNet.py).

Head: 9x9 conv, stride 4, no bias; body: ``num_blocks`` residual blocks
with channel attention; tail: 3x3 conv and global average pooling to 3
channels read as (l1, l2, rho), l = exp(clamp(., log 1e-4, log 1e2)) and
rho = tanh(.).  Parameter names are the reference torch keys (``head``,
``body.{i}.body.{0,2}``, ``body.{i}.body.3.body.{0,2}``, ``tail.0``), so a
released ``.pth`` loads with ``strict=True``.  exp, tanh and the sigmoid of
the attention run in float64 (see ops/fused_conv.exp_clip).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from .common import conv, lrelu, make_conv, to_nchw

LOG_MAX = math.log(1e2)
LOG_MIN = math.log(1e-4)


class CALayer(nn.Module):
    def __init__(self, nf: int, reduction: int = 16):
        super().__init__()
        # squeeze / LeakyReLU / excite; the activation has no parameters
        # and keeps the reference's indices
        self.body = nn.Sequential(make_conv(nf, nf // reduction, 1),
                                  nn.LeakyReLU(0.2),
                                  make_conv(nf // reduction, nf, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.mean(dim=(2, 3), keepdim=True)
        y = lrelu(conv(self.body[0], y), 0.2)
        y = conv(self.body[2], y)
        return x * torch.sigmoid(y.double()).to(y.dtype)


class RBLayer(nn.Module):
    def __init__(self, nf: int):
        super().__init__()
        self.body = nn.Sequential(make_conv(nf, nf, 3), nn.LeakyReLU(0.2),
                                  make_conv(nf, nf, 3), CALayer(nf))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = lrelu(conv(self.body[0], x), 0.2)
        y = conv(self.body[2], y)
        return self.body[3](y) + x


class KernelNet(nn.Module):
    def __init__(self, in_chn: int = 3, out_chn: int = 3, nf: int = 64,
                 num_blocks: int = 8):
        super().__init__()
        head = nn.Conv2d(in_chn, nf, 9, stride=4, padding=4, bias=False)
        nn.init.uniform_(head.weight, -1.0 / math.sqrt(81 * in_chn),
                         1.0 / math.sqrt(81 * in_chn))
        self.head = head
        self.body = nn.ModuleList([RBLayer(nf) for _ in range(num_blocks)])
        self.tail = nn.Sequential(make_conv(nf, out_chn, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, H, W, C) -> kinfo (N, 3) = (l1, l2, rho)."""
        h = conv(self.head, to_nchw(x))
        for blk in self.body:
            h = blk(h)
        out = conv(self.tail[0], h).mean(dim=(2, 3))           # N x 3
        o64 = out.double()
        lam12 = torch.exp(torch.clamp(o64[:, :2], LOG_MIN, LOG_MAX))
        rho = torch.tanh(o64[:, -1:])
        return torch.cat([lam12, rho], dim=1).to(out.dtype)
