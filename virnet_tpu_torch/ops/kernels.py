"""Gaussian blur-kernel synthesis (counterpart of virnet_tpu/ops/kernels.py).

Two deliberately different coordinate conventions, mirroring the reference:

* :func:`sigma2kernel` — the differentiable path used by the SISR ELBO;
  grid coordinates are (row, col) pairs, i.e. the first covariance axis is
  the *vertical* image axis (reference utils/util_sisr.py:26-58,
  torch.meshgrid 'ij' semantics).
* :func:`anisotropic_gaussian_np` — the host-side data-synthesis twin; grid
  coordinates are (col, row) pairs, i.e. the first covariance axis is the
  *horizontal* image axis (reference utils/util_sisr.py:60-93, np.meshgrid
  'xy' semantics).  The mismatch exists in the reference and the model is
  trained through it, so both are reproduced exactly.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def _kernel_center(k_size: int, sf: int, shift: bool) -> float:
    if shift:
        return k_size // 2 + 0.5 * (sf - k_size % 2)
    return float(k_size // 2)


def _inv2x2(cov: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a batch of 2x2 matrices, with a jitter on
    the diagonal of (near-)singular inputs — the analogue of the
    reference's try/except around torch.inverse (utils/util_sisr.py:37-40).
    """
    a = cov[..., 0, 0]
    b = cov[..., 0, 1]
    c = cov[..., 1, 0]
    d = cov[..., 1, 1]
    det = a * d - b * c
    jitter = torch.where(det.abs() < 1e-12, 1e-5, 0.0).to(cov.dtype)
    a = a + jitter
    d = d + jitter
    det = a * d - b * c
    inv = torch.stack([torch.stack([d, -b], dim=-1),
                       torch.stack([-c, a], dim=-1)], dim=-2)
    return inv / det[..., None, None]


def sigma2kernel(cov: torch.Tensor, k_size: int = 21, sf: int = 3,
                 shift: bool = False) -> torch.Tensor:
    """Differentiable softmax-normalized Gaussian kernel from covariance:
    cov (N, 2, 2), first axis = image rows -> (N, k_size, k_size), each
    summing to 1.  The softmax runs in float64 and is rounded back
    (PyTorch's CPU float32 exp is not reliable at 1e-7; see
    ops/fused_conv.exp_clip)."""
    cov = cov.reshape(-1, 2, 2)
    inv = _inv2x2(cov)                                     # N x 2 x 2
    center = _kernel_center(k_size, sf, shift)
    r = torch.arange(k_size, dtype=cov.dtype, device=cov.device) - center
    # grid of (row, col) offsets, flattened rows-first to (k^2, 2)
    z = torch.stack([r.repeat_interleave(k_size), r.repeat(k_size)], dim=-1)
    quad = -0.5 * torch.einsum("ki,nij,kj->nk", z, inv, z)  # N x k^2
    kernel = torch.softmax(quad.double(), dim=1).to(cov.dtype)
    return kernel.reshape(-1, k_size, k_size)


def kinfo2kernel(kinfo: torch.Tensor, k_size: int = 21, sf: int = 3,
                 shift: bool = False) -> torch.Tensor:
    """(l1, l2, rho) triples -> covariance -> kernel (reference
    utils/util_sisr.py:95-107)."""
    kinfo = kinfo.reshape(-1, 3)
    v1, v2, rho = kinfo[:, 0], kinfo[:, 1], kinfo[:, 2]
    direction = torch.sqrt(v1) * torch.sqrt(v2) * rho
    cov = torch.stack([torch.stack([v1, direction], dim=-1),
                       torch.stack([direction, v2], dim=-1)], dim=-2)
    return sigma2kernel(cov, k_size, sf, shift)


def anisotropic_gaussian_np(k_size: int = 21, sf: int = 4,
                            lambda_1: float = 1.2, lambda_2: float = 5.0,
                            theta: float = 0.0,
                            shift: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side anisotropic Gaussian synthesis for training/eval data.
    Returns (kernel (k, k) float, kinfo = [s1, s2, rho]); 'xy' meshgrid
    convention of the reference data path."""
    lam = np.diag([lambda_1, lambda_2])
    u = np.array([[np.cos(theta), -np.sin(theta)],
                  [np.sin(theta), np.cos(theta)]])
    sigma = u @ lam @ u.T
    inv_sigma = np.linalg.inv(sigma)

    center = _kernel_center(k_size, sf, shift)

    xx, yy = np.meshgrid(np.arange(k_size), np.arange(k_size))
    z = np.stack([xx, yy], axis=2).astype(np.float32) - center   # k x k x 2
    quad = -0.5 * np.einsum("hwi,ij,hwj->hw", z, inv_sigma, z)
    flat = quad.reshape(-1)
    flat = flat - flat.max()
    e = np.exp(flat)
    kernel = (e / e.sum()).reshape(k_size, k_size)

    s1, s2 = sigma[0, 0], sigma[1, 1]
    rho = sigma[0, 1] / (math.sqrt(s1) * math.sqrt(s2))
    return kernel, np.array([s1, s2, rho])


def tidy_kernel(kernel: np.ndarray, expect_size: int = 21) -> np.ndarray:
    """Center-pad (or center-crop + renormalize) a kernel to a target size
    (reference utils/util_sisr.py:179-196)."""
    k_size = kernel.shape[-1]
    if expect_size >= k_size:
        out = np.zeros([expect_size, expect_size], dtype=kernel.dtype)
        start = expect_size // 2 - k_size // 2
        out[start:start + k_size, start:start + k_size] = kernel
        return out
    start = k_size // 2 - expect_size // 2
    out = kernel[start:start + expect_size, start:start + expect_size].copy()
    out /= out.sum()
    return out


def gaussian_filter_kernel(ksize: int, sigma: float = -1.0) -> np.ndarray:
    """2-D separable Gaussian filter kernel, OpenCV ``getGaussianKernel``
    semantics: when ``sigma <= 0`` it defaults to the OpenCV size rule
    0.3*((ksize-1)*0.5 - 1) + 0.8 (reference utils/util_denoising.py:24-40).
    """
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    k1 = np.exp(-(x ** 2) / (2 * sigma ** 2))
    k1 /= k1.sum()
    k2 = np.outer(k1, k1)
    return k2 / k2.sum()
