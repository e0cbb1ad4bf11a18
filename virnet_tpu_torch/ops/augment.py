"""Dihedral-group (x8) flips/rotations and their exact inverses, for
flip-ensemble TTA (counterpart of virnet_tpu/ops/augment.py; reference
utils/util_image.py:296-466).

The tensor forms work on NHWC (or HWC) tensors with the reference's
*tensor* semantics, rotating clockwise; all 8 orientations of a square
batch stack into one batch (``dihedral_stack``), so the x8 ensemble is one
forward.  The numpy forms work on HWC images with the reference's numpy
semantics, rotating counter-clockwise.  Each has its own inverse.

Mode table (rot = clockwise for tensors, counter-clockwise for numpy):
    0: identity                    4: rot180
    1: flip up-down                5: rot180 then flipud
    2: rot90                       6: rot270
    3: rot90 then flipud           7: rot270 then flipud
"""

from __future__ import annotations

import numpy as np
import torch

_HW = (-3, -2)   # the spatial dims of NHWC / HWC


def _flipud(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(x, dims=(_HW[0],))


def _rot90cw(x: torch.Tensor, k: int = 1) -> torch.Tensor:
    return torch.rot90(x, k=-k, dims=_HW)


def dihedral(x: torch.Tensor, mode: int) -> torch.Tensor:
    """Dihedral mode 0..7 of an NHWC (or HWC) tensor."""
    if not 0 <= mode <= 7:
        raise ValueError(f"invalid dihedral mode {mode}")
    y = _rot90cw(x, mode // 2) if mode >= 2 else x
    return _flipud(y) if mode % 2 else y


def dihedral_inverse(x: torch.Tensor, mode: int) -> torch.Tensor:
    """Inverse of :func:`dihedral`."""
    if not 0 <= mode <= 7:
        raise ValueError(f"invalid dihedral mode {mode}")
    y = _flipud(x) if mode % 2 else x
    return _rot90cw(y, -(mode // 2)) if mode >= 2 else y


def dihedral_stack(x: torch.Tensor) -> torch.Tensor:
    """The 8 orientations of a square NHWC batch on a new leading axis,
    (8, N, H, W, C)."""
    return torch.stack([dihedral(x, m) for m in range(8)])


def dihedral_unstack_mean(y8: torch.Tensor) -> torch.Tensor:
    """Invert each orientation of an (8, N, H, W, C) stack and average."""
    return torch.stack([dihedral_inverse(y8[m], m)
                        for m in range(8)]).mean(dim=0)


def dihedral_np(image: np.ndarray, mode: int) -> np.ndarray:
    if mode == 0:
        out = image
    elif mode == 1:
        out = np.flipud(image)
    elif mode == 2:
        out = np.rot90(image)
    elif mode == 3:
        out = np.flipud(np.rot90(image))
    elif mode == 4:
        out = np.rot90(image, k=2)
    elif mode == 5:
        out = np.flipud(np.rot90(image, k=2))
    elif mode == 6:
        out = np.rot90(image, k=3)
    elif mode == 7:
        out = np.flipud(np.rot90(image, k=3))
    else:
        raise ValueError(f"invalid dihedral mode {mode}")
    return np.ascontiguousarray(out)


def dihedral_inverse_np(image: np.ndarray, mode: int) -> np.ndarray:
    if mode == 0:
        out = image
    elif mode == 1:
        out = np.flipud(image)
    elif mode == 2:
        out = np.rot90(image, axes=(1, 0))
    elif mode == 3:
        out = np.rot90(np.flipud(image), axes=(1, 0))
    elif mode == 4:
        out = np.rot90(image, k=2, axes=(1, 0))
    elif mode == 5:
        out = np.rot90(np.flipud(image), k=2, axes=(1, 0))
    elif mode == 6:
        out = np.rot90(image, k=3, axes=(1, 0))
    elif mode == 7:
        out = np.rot90(np.flipud(image), k=3, axes=(1, 0))
    else:
        raise ValueError(f"invalid dihedral mode {mode}")
    return np.ascontiguousarray(out)
