"""SNet — the DnCNN stack that predicts the log noise variance
(counterpart of virnet_tpu/models/dncnn.py; reference networks/DnCNN.py).

conv3x3 -> LeakyReLU(0.25) ``dep - 1`` times with 64 filters, then a 3x3
conv to ``out_chn``; orthogonal init with leaky-relu gain, zero bias.
Parameter names are the reference's: ``conv1``, ``mid_layer.{2i}``,
``conv_last``.  ``noise_avg`` (SISR) averages the logits over H and W to
one value per image and channel.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops import fused_conv as fc
from .common import (conv, hwio, kernel_layout, leaky_relu_gain, lrelu,
                     orthogonal_gain_init_, to_nchw, to_nhwc)


class DnCNN(nn.Module):
    """``conv_impl``: 'fused' runs the whole stack as one K2 launch
    (counterpart of pallas_conv.dncnn_pair_fused), forward-only.
    'torch' runs every conv through ``F.conv2d`` with
    autograd: the training route, the counterpart of ``conv_impl='xla'``
    that the JAX trainers force (models/common.py:train_conv_impl)."""

    def __init__(self, in_chn: int = 3, out_chn: int = 1, dep: int = 5,
                 num_filters: int = 64, slope: float = 0.25,
                 conv_impl: str = "fused", noise_avg: bool = False):
        super().__init__()
        if conv_impl not in ("fused", "torch"):
            raise ValueError(f"conv_impl must be fused|torch, got "
                             f"{conv_impl!r}")
        self.slope = slope
        self.conv_impl = conv_impl
        self.noise_avg = noise_avg
        nf = num_filters
        self.conv1 = nn.Conv2d(in_chn, nf, 3, padding=1)
        mids = []
        for _ in range(dep - 2):
            mids += [nn.Conv2d(nf, nf, 3, padding=1),
                     nn.LeakyReLU(slope, inplace=True)]
        self.mid_layer = nn.Sequential(*mids)
        self.conv_last = nn.Conv2d(nf, out_chn, 3, padding=1)
        gain = leaky_relu_gain(slope)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                orthogonal_gain_init_(m, gain)

    def mids(self):
        return [m for m in self.mid_layer if isinstance(m, nn.Conv2d)]

    def kernel_params(self) -> dict:
        """HWIO weights and biases in the parameter dtype, the mids
        stacked as (L, 3, 3, 64, 64) / (L, 64); cached (``kernel_layout``)."""
        def build(m):
            mids = m.mids()
            return dict(
                w1=hwio(m.conv1.weight), b1=m.conv1.bias,
                wms=torch.stack([hwio(c.weight) for c in mids]),
                bms=torch.stack([c.bias for c in mids]),
                wl=hwio(m.conv_last.weight), bl=m.conv_last.bias)
        return kernel_layout(self, build)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, H, W, in_chn) -> logits (N, H, W, out_chn), NHWC, in the
        compute dtype; (N, 1, 1, out_chn) with ``noise_avg``."""
        y = self._stack(x)
        if self.noise_avg:
            y = y.mean(dim=(1, 2), keepdim=True)
        return y

    def _stack(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv_impl == "torch":
            y = lrelu(conv(self.conv1, to_nchw(x)), self.slope)
            for m in self.mids():
                y = lrelu(conv(m, y), self.slope)
            return to_nhwc(conv(self.conv_last, y))
        p = self.kernel_params()
        x = x.to(p["w1"].dtype).contiguous()
        return fc.dncnn_fused(x, p["w1"], p["b1"], p["wms"], p["bms"],
                              p["wl"], p["bl"], slope=self.slope)
