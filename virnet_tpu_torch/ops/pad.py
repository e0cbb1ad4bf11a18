"""Spatial padding / cropping on NHWC tensors (counterpart of
virnet_tpu/ops/pad.py).  Reflect padding is numpy ``mode='reflect'`` (no
edge repetition), the reference's ``util_net.pad_input``."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def pad_bottom_right(x: torch.Tensor, hb: int, wb: int) -> torch.Tensor:
    """Reflect-pad NHWC ``x`` at the bottom/right up to (hb, wb)."""
    h, w = x.shape[-3], x.shape[-2]
    if hb == h and wb == w:
        return x
    y = F.pad(x.permute(0, 3, 1, 2), (0, wb - w, 0, hb - h), mode="reflect")
    return y.permute(0, 2, 3, 1).contiguous()


def pad_to_multiple(x: torch.Tensor, mod: int) -> torch.Tensor:
    """Reflect-pad the spatial axes of NHWC ``x`` up to a multiple of
    ``mod`` (bottom/right only)."""
    h, w = x.shape[-3], x.shape[-2]
    return pad_bottom_right(x, int(math.ceil(h / mod) * mod),
                            int(math.ceil(w / mod) * mod))


def crop_spatial(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Crop the spatial axes of NHWC (or HWC) ``x`` to ``h`` x ``w``."""
    return x[..., :h, :w, :]
