"""SNet — the DnCNN stack that predicts the log noise variance
(counterpart of virnet_tpu/models/dncnn.py; reference networks/DnCNN.py).

conv3x3 -> LeakyReLU(0.25) ``dep - 1`` times with 64 filters, then a 3x3
conv to ``out_chn``; orthogonal init with leaky-relu gain, zero bias.
Parameter names are the reference's: ``conv1``, ``mid_layer.{2i}``,
``conv_last``.  ``noise_avg`` (SISR) is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops import fused_conv as fc
from .common import (hwio, kernel_layout, leaky_relu_gain,
                     orthogonal_gain_init_)


class DnCNN(nn.Module):
    """``conv_impl``: 'fused' runs the whole stack as one K2 launch
    (counterpart of pallas_conv.dncnn_pair_fused); 'ops' is its per-op
    route (``conv_impl='pair_ops'`` in the JAX package): conv1 and
    conv_last in plain torch, the mids as L launches of K1."""

    def __init__(self, in_chn: int = 3, out_chn: int = 1, dep: int = 5,
                 num_filters: int = 64, slope: float = 0.25,
                 conv_impl: str = "fused"):
        super().__init__()
        if conv_impl not in ("fused", "ops"):
            raise ValueError(f"conv_impl must be fused|ops, got {conv_impl!r}")
        self.slope = slope
        self.conv_impl = conv_impl
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
        parameter dtype."""
        p = self.kernel_params()
        x = x.to(p["w1"].dtype).contiguous()
        if self.conv_impl == "ops":
            y = fc.conv3x3_plain(x, p["w1"], p["b1"], self.slope)
            y = fc.conv3x3_mid_stack(y, p["wms"], p["bms"], self.slope)
            return fc.conv3x3_plain(y, p["wl"], p["bl"])
        return fc.dncnn_fused(x, p["w1"], p["b1"], p["wms"], p["bms"],
                              p["wl"], p["bl"], slope=self.slope)
