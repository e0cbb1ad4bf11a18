"""The UpBlock's 2x2-stride-2 transposed conv (counterpart of
virnet_tpu/ops/upsample.py:conv_transpose_2x2).  XLA computes it outside
any Pallas kernel, so the port leaves it to ``F.conv_transpose2d``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv_transpose_2x2(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor | None = None) -> torch.Tensor:
    """x (N, C, H, W), weight (C, O, 2, 2) in the torch ConvTranspose2d
    layout -> (N, O, 2H, 2W); out[n, o, 2i+a, 2j+b] = sum_c x[n, c, i, j]
    weight[c, o, a, b] + bias[o]."""
    return F.conv_transpose2d(x.to(weight.dtype), weight, bias, stride=2)
