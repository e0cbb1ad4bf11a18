"""Large-image inference: pad buckets and overlapped 4-quadrant tiling
(counterpart of virnet_tpu/eval/tiling.py; reference
utils/util_net.py:27-65).  Tensors are NHWC."""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch


def bucket_size(n: int, multiple: int = 64,
                buckets: Sequence[int] = ()) -> int:
    """Smallest bucket >= n: explicit bucket list if given, else next
    multiple.  multiple <= 1 means exact (no bucketing)."""
    for b in buckets:
        if b >= n:
            return b
    if multiple <= 1:
        return n
    return int(math.ceil(n / multiple) * multiple)


def forward_chop(forward: Callable, x: torch.Tensor, sf: int = 1,
                 shave: int = 10, min_size: int = 160000) -> torch.Tensor:
    """Recursive overlap-shave tiled inference: 4 overlapping quadrants,
    run as one batched forward when small enough, else recursively."""
    n, h, w, c = x.shape
    h_half, w_half = h // 2, w // 2
    h_size, w_size = h_half + shave, w_half + shave
    tiles = [x[:, :h_size, :w_size], x[:, :h_size, w - w_size:],
             x[:, h - h_size:, :w_size], x[:, h - h_size:, w - w_size:]]
    if h_size * w_size < min_size:
        outs = torch.chunk(forward(torch.cat(tiles, dim=0)), 4, dim=0)
    else:
        outs = [forward_chop(forward, t, sf, shave, min_size) for t in tiles]

    h_out, w_out = sf * h, sf * w
    h_half_o, w_half_o = sf * h_half, sf * w_half
    h_size_o, w_size_o = sf * h_size, sf * w_size
    top = torch.cat(
        [outs[0][:, :h_half_o, :w_half_o],
         outs[1][:, :h_half_o, w_size_o - w_out + w_half_o:]], dim=2)
    bottom = torch.cat(
        [outs[2][:, h_size_o - h_out + h_half_o:, :w_half_o],
         outs[3][:, h_size_o - h_out + h_half_o:,
                 w_size_o - w_out + w_half_o:]], dim=2)
    return torch.cat([top, bottom], dim=1)
