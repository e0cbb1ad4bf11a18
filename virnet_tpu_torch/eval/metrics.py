"""MATLAB-faithful image quality metrics (counterpart of
virnet_tpu/eval/metrics.py).

The reference's measurement protocol (reference utils/util_image.py:17-116):
uint8 round trip through img_as_ubyte, PSNR on RGB (border crop), SSIM with
the 11x11 sigma=1.5 Gaussian window and 5-px valid crop, per-channel mean;
SISR scores take the MATLAB Y channel with border = sf^2.  Host-side numpy
(SSIM's filter is cv2.filter2D, imported where it is used).
"""

from __future__ import annotations

import math

import numpy as np

from ..ops.color import rgb2ycbcr_np
from ..ops.quant import img_as_ubyte

_SSIM_C1 = (0.01 * 255) ** 2
_SSIM_C2 = (0.03 * 255) ** 2


def _ssim_window() -> np.ndarray:
    k = np.arange(11, dtype=np.float64) - 5
    g = np.exp(-(k ** 2) / (2 * 1.5 ** 2))
    g /= g.sum()
    return np.outer(g, g)


def _ssim_single(img1: np.ndarray, img2: np.ndarray) -> float:
    """SSIM of two 2-D uint8-range arrays, cv2.filter2D semantics
    (BORDER_REFLECT_101) with 5-px valid crop."""
    import cv2

    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    window = _ssim_window()

    mu1 = cv2.filter2D(img1, -1, window)[5:-5, 5:-5]
    mu2 = cv2.filter2D(img2, -1, window)[5:-5, 5:-5]
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = cv2.filter2D(img1 ** 2, -1, window)[5:-5, 5:-5] - mu1_sq
    sigma2_sq = cv2.filter2D(img2 ** 2, -1, window)[5:-5, 5:-5] - mu2_sq
    sigma12 = cv2.filter2D(img1 * img2, -1, window)[5:-5, 5:-5] - mu1_mu2

    ssim_map = ((2 * mu1_mu2 + _SSIM_C1) * (2 * sigma12 + _SSIM_C2)) / (
        (mu1_sq + mu2_sq + _SSIM_C1) * (sigma1_sq + sigma2_sq + _SSIM_C2))
    return float(ssim_map.mean())


def calculate_ssim(im1: np.ndarray, im2: np.ndarray, border: int = 0,
                   ycbcr: bool = False) -> float:
    """HWC (or HW) uint8 images -> MATLAB-equivalent SSIM."""
    if im1.shape != im2.shape:
        raise ValueError("input images must have the same dimensions")
    if ycbcr:
        im1 = rgb2ycbcr_np(im1, True)
        im2 = rgb2ycbcr_np(im2, True)
    h, w = im1.shape[:2]
    im1 = im1[border:h - border, border:w - border]
    im2 = im2[border:h - border, border:w - border]
    if im1.ndim == 2:
        return _ssim_single(im1, im2)
    if im1.shape[2] == 1:
        return _ssim_single(im1[..., 0], im2[..., 0])
    return float(np.mean([_ssim_single(im1[..., i], im2[..., i])
                          for i in range(im1.shape[2])]))


def calculate_psnr(im1: np.ndarray, im2: np.ndarray, border: int = 0,
                   ycbcr: bool = False) -> float:
    """HWC (or HW) uint8 images -> PSNR in dB."""
    if im1.shape != im2.shape:
        raise ValueError("input images must have the same dimensions")
    if ycbcr:
        im1 = rgb2ycbcr_np(im1, True)
        im2 = rgb2ycbcr_np(im2, True)
    h, w = im1.shape[:2]
    im1 = im1[border:h - border, border:w - border].astype(np.float64)
    im2 = im2[border:h - border, border:w - border].astype(np.float64)
    mse = np.mean((im1 - im2) ** 2)
    if mse == 0:
        return float("inf")
    return 20 * math.log10(255.0 / math.sqrt(mse))


def batch_psnr(img: np.ndarray, imclean: np.ndarray, border: int = 0,
               ycbcr: bool = False) -> float:
    """(N, H, W, C) float [0,1] arrays -> mean PSNR after uint8 round-trip
    (reference utils/util_image.py:91-103)."""
    img_u = img_as_ubyte(np.clip(np.asarray(img), 0, 1))
    clean_u = img_as_ubyte(np.clip(np.asarray(imclean), 0, 1))
    return float(np.mean([
        calculate_psnr(clean_u[i], img_u[i], border, ycbcr)
        for i in range(img_u.shape[0])]))


def batch_ssim(img: np.ndarray, imclean: np.ndarray, border: int = 0,
               ycbcr: bool = False) -> float:
    img_u = img_as_ubyte(np.clip(np.asarray(img), 0, 1))
    clean_u = img_as_ubyte(np.clip(np.asarray(imclean), 0, 1))
    return float(np.mean([
        calculate_ssim(clean_u[i], img_u[i], border, ycbcr)
        for i in range(img_u.shape[0])]))
