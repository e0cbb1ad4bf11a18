"""Degradation operators of the SISR model: per-sample blur and
downsampling (counterpart of virnet_tpu/ops/degrade.py).

The SISR ELBO differentiates through blur + downsample every step
(reference utils/util_sisr.py:127-144 inside loss/ELBO_simple.py:55-59).
The blur is the hand-written kernels of ``ops/blur.py`` (K5 forward, K6
and K7 backward); the bicubic downsample is two dense matrix products
(``ops/resize.py``).

Padding semantics, both reproduced deliberately:
  * the in-loss path pads with true 'reflect' (torch F.pad reflect);
  * the data path pads with 'symmetric' (edge-repeating), because the
    reference data pipeline uses scipy.ndimage.convolve(mode='reflect'),
    which is numpy 'symmetric'.

``blur_shared`` / ``noise_estimate`` (the sigma^2 prior of real-noise
denoising training) blur with one shared filter through a depthwise
library convolution, as the JAX package leaves them to XLA: they are no
kernel of either package.  The numpy twins ``imconv_np`` / ``degrade_np``
are the seeded host degradation of the SISR eval sets (scipy.ndimage, no
kernel in either package).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .blur import pad_hw, valid_blur
from .kernels import gaussian_filter_kernel
from .resize import resize_nhwc, resize_np


def blur_per_sample(x: torch.Tensor, kernels: torch.Tensor,
                    correlate: bool = True,
                    pad_mode: str = "reflect") -> torch.Tensor:
    """Blur each batch element with its own kernel ('same', padded).

    x (N, H, W, C) float32 images, kernels (N, k, k).  ``correlate=True``
    is cross-correlation (torch convNd semantics, the reference's in-loss
    path); ``False`` is true convolution (kernel flipped, scipy
    semantics).  ``pad_mode`` is 'reflect' (torch F.pad) or 'symmetric'
    (scipy).  Differentiable in x and kernels."""
    k = kernels.shape[-1]
    if not correlate:
        kernels = kernels.flip(-2, -1)
    # (N, k, k) is tiny; the images are never copied or cast here
    kernels = kernels.to(x.dtype).contiguous()
    return valid_blur(pad_hw(x, k // 2, pad_mode), kernels)


def downsample(x: torch.Tensor, sf: int, method: str = "direct") -> torch.Tensor:
    """Downsample NHWC by an integer factor: 'direct' stride or antialiased
    'bicubic' (ResizeRight semantics)."""
    method = method.lower()
    if method == "direct":
        return x[:, ::sf, ::sf, :]
    if method == "bicubic":
        return resize_nhwc(x, scale_factors=1.0 / sf)
    raise ValueError(f"unknown downsampler: {method}")


def degrade_batch(x_hr: torch.Tensor, kernels: torch.Tensor, sf: int,
                  downsampler: str = "bicubic",
                  correlate: bool = True) -> torch.Tensor:
    """Per-sample blur then downsample: the reference's loss-side
    degradation (utils/util_sisr.py:127-144)."""
    return downsample(blur_per_sample(x_hr, kernels, correlate=correlate),
                      sf, downsampler)


def blur_shared(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Blur all batch elements and channels of NHWC ``x`` with one shared
    (k, k) kernel (reflect-padded, 'same', correlation: the kernel is
    symmetric in every use here)."""
    c = x.shape[-1]
    k = kernel.shape[-1]
    xp = pad_hw(x, k // 2, "reflect").permute(0, 3, 1, 2)
    w = kernel.to(x.dtype).expand(c, 1, k, k)
    return F.conv2d(xp, w, groups=c).permute(0, 2, 3, 1)


def noise_estimate(im_noisy: torch.Tensor, im_gt: torch.Tensor,
                   k_size: int) -> torch.Tensor:
    """sigma^2 prior for real data: Gaussian filter of the squared residual
    with the OpenCV default sigma rule, clamped >= 1e-10 (reference
    utils/util_denoising.py:24-63)."""
    kernel = torch.as_tensor(gaussian_filter_kernel(k_size),
                             dtype=im_noisy.dtype, device=im_noisy.device)
    return blur_shared((im_noisy - im_gt) ** 2, kernel).clamp_min(1e-10)


def imconv_np(im: np.ndarray, kernel: np.ndarray,
              padding_mode: str = "reflect",
              correlate: bool = False) -> np.ndarray:
    """scipy.ndimage-style image convolution (reference
    utils/util_sisr.py:110-125).  scipy's 'reflect' is edge-repeating."""
    import scipy.ndimage as snd

    if kernel.ndim != im.ndim:
        kernel = kernel[:, :, np.newaxis]
    if correlate:
        return snd.correlate(im, kernel, mode=padding_mode)
    return snd.convolve(im, kernel, mode=padding_mode)


def degrade_np(im_hr: np.ndarray, kernel: np.ndarray, sf: int,
               nlevel: float = 2.55, qf: Optional[int] = None,
               seed: int = 1234, downsampler: str = "direct") -> np.ndarray:
    """Seeded eval degradation: blur -> clip -> downsample -> Gaussian noise
    -> optional JPEG (reference utils/util_sisr.py:146-177)."""
    im_blur = imconv_np(im_hr, kernel, padding_mode="reflect", correlate=False)
    im_blur = np.clip(im_blur, 0.0, 1.0)

    if downsampler.lower() == "direct":
        im_lr = im_blur[::sf, ::sf]
    elif downsampler.lower() == "bicubic":
        im_lr = resize_np(im_blur, scale_factors=1 / sf, axes=(0, 1))
    else:
        raise ValueError("downsampler must be 'direct' or 'bicubic'")

    rng = np.random.default_rng(seed)
    im_lr = im_lr + rng.standard_normal(size=im_lr.shape) * (nlevel / 255.0)
    im_lr = np.clip(im_lr.astype(np.float32), 0.0, 1.0)

    if qf is not None:
        from .color import jpeg_compress
        im_lr = jpeg_compress(im_lr, qf=int(qf), chn_in="rgb")
    return im_lr
