"""Colour conversion, image I/O and JPEG round trips (counterpart of
virnet_tpu/ops/color.py; reference utils/util_image.py:129-257): the host's
numpy conversion and its tensor form for the device metrics.  cv2 is
imported only where files are read or written (and JPEG round trips), so
serving and scoring run without it; torch only by the tensor form, so the
worker processes of data/isp.py start on numpy alone.

The YCbCr conversion has MATLAB's coefficients: the SISR metrics' Y
channel is part of the Table-5 protocol.
"""

from __future__ import annotations

from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    import torch

_YCBCR_VEC = np.array([65.481, 128.553, 24.966]) / 255.0
_YCBCR_MAT = np.array([[65.481, -37.797, 112.0],
                       [128.553, -74.203, -93.786],
                       [24.966, 112.0, -18.214]]) / 255.0
_YCBCR_OFFSET = np.array([16.0, 128.0, 128.0])


def rgb2ycbcr_np(im: np.ndarray, only_y: bool = True) -> np.ndarray:
    """MATLAB rgb2ycbcr; uint8 [0, 255] or float [0, 1] in, the same
    convention out (reference utils/util_image.py:129-153)."""
    if im.dtype == np.uint8:
        im_temp = im.astype(np.float64)
    else:
        im_temp = (im * 255).astype(np.float64)

    if only_y:
        rlt = np.dot(im_temp, _YCBCR_VEC) + 16.0
    else:
        rlt = np.matmul(im_temp, _YCBCR_MAT) + _YCBCR_OFFSET

    if im.dtype == np.uint8:
        rlt = rlt.round()
    else:
        rlt = rlt / 255.0
    return rlt.astype(im.dtype)


def rgb2ycbcr(x: torch.Tensor, only_y: bool = True) -> torch.Tensor:
    """MATLAB rgb2ycbcr for NHWC float [0, 1] tensors, clamped to [0, 1]
    (reference utils/util_image.py:155-176)."""
    import torch

    xt = x * 255.0
    if only_y:
        vec = torch.as_tensor(_YCBCR_VEC, dtype=x.dtype, device=x.device)
        y = xt @ vec[:, None] + 16.0
    else:
        mat = torch.as_tensor(_YCBCR_MAT, dtype=x.dtype, device=x.device)
        off = torch.as_tensor(_YCBCR_OFFSET, dtype=x.dtype, device=x.device)
        y = xt @ mat + off
    return torch.clamp(y / 255.0, 0.0, 1.0)


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


def jpeg_compress(im: np.ndarray, qf: int, chn_in: str = "rgb") -> np.ndarray:
    """Round-trip JPEG compression through cv2's libjpeg (reference
    utils/util_image.py:236-257); float input comes back as float."""
    import cv2

    from .quant import img_as_float32, img_as_ubyte

    rgb = chn_in.lower() == "rgb"
    im_bgr = cv2.cvtColor(im, cv2.COLOR_RGB2BGR) if rgb else im
    if im.dtype != np.uint8:
        im_bgr = img_as_ubyte(im_bgr)
    flag, enc = cv2.imencode(".jpg", im_bgr,
                             [int(cv2.IMWRITE_JPEG_QUALITY), int(qf)])
    if not flag:
        raise RuntimeError("cv2.imencode could not encode the image")
    im_jpg_bgr = cv2.imdecode(enc, 1)
    out = cv2.cvtColor(im_jpg_bgr, cv2.COLOR_BGR2RGB) if rgb else im_jpg_bgr
    if im.dtype != np.uint8:
        out = img_as_float32(out).astype(im.dtype)
    return out
