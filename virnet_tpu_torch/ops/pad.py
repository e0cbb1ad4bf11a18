"""Spatial padding / cropping on NHWC tensors (counterpart of
virnet_tpu/ops/pad.py).  Reflect padding is numpy ``mode='reflect'`` (no
edge repetition), the reference's ``util_net.pad_input``."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def pad_bottom_right(x: torch.Tensor, hb: int, wb: int) -> torch.Tensor:
    """Reflect-pad NHWC ``x`` at the bottom/right up to (hb, wb), by any
    amount, as numpy's 'reflect' does: torch's reflect pad takes less than
    the axis' size, so a larger pad goes in steps, each reflecting about
    the current edge."""
    h, w = x.shape[-3], x.shape[-2]
    if hb == h and wb == w:
        return x
    if min(h, w) < 2:
        raise ValueError(f"cannot reflect-pad a {h}x{w} image")
    y = x.permute(0, 3, 1, 2)
    while y.shape[-2] < hb or y.shape[-1] < wb:
        ph = min(hb - y.shape[-2], y.shape[-2] - 1)
        pw = min(wb - y.shape[-1], y.shape[-1] - 1)
        y = F.pad(y, (0, pw, 0, ph), mode="reflect")
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


def modcrop(im, sf: int):
    """Crop an HWC (or HW) image so that H and W divide the scale factor
    (reference utils/util_sisr.py:19-23)."""
    h, w = im.shape[:2]
    return im[:h - h % sf, :w - w % sf]
