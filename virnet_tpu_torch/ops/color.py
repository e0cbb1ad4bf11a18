"""Image I/O through cv2 (counterpart of the I/O half of
virnet_tpu/ops/color.py; reference utils/util_image.py:195-234)."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def imread(path, chn: str = "rgb", dtype: str = "float32") -> np.ndarray:
    """Read an image to HWC (reference utils/util_image.py:195-214)."""
    import cv2

    im = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if im is None:
        raise FileNotFoundError(f"cannot read image: {path}")
    if chn.lower() == "rgb" and im.ndim == 3:
        im = cv2.cvtColor(im, cv2.COLOR_BGR2RGB)

    if dtype == "float32":
        im = im.astype(np.float32) / 255.0
    elif dtype == "float64":
        im = im.astype(np.float64) / 255.0
    elif dtype == "uint8":
        pass
    else:
        raise ValueError("dtype must be float32, float64 or uint8")
    return im


def imwrite(im: np.ndarray, path, chn: str = "rgb", qf=None) -> bool:
    """Write an HWC image (reference utils/util_image.py:216-234)."""
    import cv2

    path = Path(path)
    if chn.lower() == "rgb" and im.ndim == 3:
        im = cv2.cvtColor(im, cv2.COLOR_RGB2BGR)
    if qf is not None and path.suffix.lower() in [".jpg", ".jpeg"]:
        return cv2.imwrite(str(path), im,
                           [int(cv2.IMWRITE_JPEG_QUALITY), int(qf)])
    return cv2.imwrite(str(path), im)
