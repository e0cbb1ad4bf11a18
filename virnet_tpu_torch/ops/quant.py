"""float <-> uint8 with scikit-image-compatible rounding (copy of
virnet_tpu/ops/quant.py:img_as_ubyte, img_as_float32).

The reference scores PSNR/SSIM only after an ``img_as_ubyte`` round trip
(reference: utils/util_image.py:91-116), so the exact rounding mode
(np.rint — round-half-to-even — then clip) is part of the metric protocol.
"""

from __future__ import annotations

import numpy as np


def img_as_ubyte(im: np.ndarray) -> np.ndarray:
    """float [-1, 1] -> uint8, skimage semantics (rint then clip)."""
    if im.dtype == np.uint8:
        return im
    if im.min() < -1.0 or im.max() > 1.0:
        raise ValueError("images with float dtype must be in [-1, 1]")
    out = np.multiply(im, 255.0, dtype=np.float64)
    np.rint(out, out=out)
    np.clip(out, 0, 255, out=out)
    return out.astype(np.uint8)


def img_as_float32(im: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] -> float32 [0, 1] (identity for float input)."""
    if im.dtype == np.uint8:
        return (im / 255.0).astype(np.float32)
    return im.astype(np.float32)
