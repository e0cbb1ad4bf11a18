"""Dihedral-group (x8) flips/rotations of HWC numpy images and their exact
inverses, for flip-ensemble TTA (counterpart of the numpy half of
virnet_tpu/ops/augment.py; reference utils/util_image.py:296-466).

Mode table (np.rot90 rotates counter-clockwise):
    0: identity                    4: rot180
    1: flip up-down                5: rot180 then flipud
    2: rot90                       6: rot270
    3: rot90 then flipud           7: rot270 then flipud
"""

from __future__ import annotations

import numpy as np


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
