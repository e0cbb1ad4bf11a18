"""MATLAB-faithful image quality metrics (counterpart of
virnet_tpu/eval/metrics.py).

The reference's measurement protocol (reference utils/util_image.py:17-116):
uint8 round trip through img_as_ubyte, PSNR on RGB (border crop), SSIM with
the 11x11 sigma=1.5 Gaussian window and 5-px valid crop, per-channel mean;
SISR scores take the MATLAB Y channel with border = sf^2.  Host-side numpy,
without cv2: the reference's cv2.filter2D map is cropped by 5 px after an
11x11 filter, so no value kept reads the border, and a 'valid' correlation
gives the same numbers.
"""

from __future__ import annotations

import math

import numpy as np

from ..ops.color import rgb2ycbcr_np
from ..ops.quant import img_as_ubyte

_SSIM_C1 = (0.01 * 255) ** 2
_SSIM_C2 = (0.03 * 255) ** 2


def _ssim_gauss() -> np.ndarray:
    """The 1-D factor of the 11x11 sigma=1.5 Gaussian window."""
    k = np.arange(11, dtype=np.float64) - 5
    g = np.exp(-(k ** 2) / (2 * 1.5 ** 2))
    return g / g.sum()


def _ssim_window() -> np.ndarray:
    g = _ssim_gauss()
    return np.outer(g, g)


def _filter_valid(maps: np.ndarray) -> np.ndarray:
    """'valid' correlation of a stack of 2-D float64 maps (..., H, W) with
    the window, as its two separable passes: the reference's filter2D
    maps after their [5:-5, 5:-5] crop, which no border mode reaches."""
    from numpy.lib.stride_tricks import sliding_window_view

    g = _ssim_gauss()
    out = sliding_window_view(maps, 11, axis=-2) @ g
    return sliding_window_view(out, 11, axis=-1) @ g


def _ssim_maps(img1: np.ndarray, img2: np.ndarray) -> np.ndarray:
    """SSIM maps of two stacks of 2-D uint8-range arrays (..., H, W) over
    the 5-px valid crop."""
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    mu1, mu2, sq1, sq2, cross = _filter_valid(
        np.stack([img1, img2, img1 ** 2, img2 ** 2, img1 * img2]))
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = sq1 - mu1_sq
    sigma2_sq = sq2 - mu2_sq
    sigma12 = cross - mu1_mu2
    return ((2 * mu1_mu2 + _SSIM_C1) * (2 * sigma12 + _SSIM_C2)) / (
        (mu1_sq + mu2_sq + _SSIM_C1) * (sigma1_sq + sigma2_sq + _SSIM_C2))


def calculate_ssim(im1: np.ndarray, im2: np.ndarray, border: int = 0,
                   ycbcr: bool = False) -> float:
    """HWC (or HW) uint8 images -> MATLAB-equivalent SSIM: the mean of the
    per-channel means."""
    if im1.shape != im2.shape:
        raise ValueError("input images must have the same dimensions")
    if ycbcr:
        im1 = rgb2ycbcr_np(im1, True)
        im2 = rgb2ycbcr_np(im2, True)
    h, w = im1.shape[:2]
    im1 = im1[border:h - border, border:w - border]
    im2 = im2[border:h - border, border:w - border]
    if im1.ndim == 2:
        return float(_ssim_maps(im1, im2).mean())
    maps = _ssim_maps(np.ascontiguousarray(np.moveaxis(im1, 2, 0)),
                      np.ascontiguousarray(np.moveaxis(im2, 2, 0)))
    return float(np.mean([m.mean() for m in maps]))


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
