"""On-device SISR degradation synthesis for training (counterpart of
virnet_tpu/data/sisr_synth.py; reference datasets/SISRDatasets.py:66-122):
per-sample anisotropic Gaussian kernels, blur, bicubic/direct downsampling
and Gaussian noise for the whole batch, on the card, under ``no_grad``.

Parity notes:
  * kernel sampling: l1 ~ U(0.2, sf); l2 ~ U(l1, sf) w.p. 0.7 else l1;
    theta ~ U(0, pi); the *variances* fed to the covariance are l^2 (the
    reference passes lambda**2, datasets/SISRDatasets.py:82-87);
  * the data-path kernel uses the numpy (x, y) coordinate convention — the
    transpose of the in-loss kernel (see ops/kernels.py) — so the kernel
    is transposed to match;
  * the host pipeline pads with scipy's edge-repeating 'reflect'
    (= 'symmetric') and uses true convolution (flipped kernel);
  * the JPEG noise branch (``add_jpeg``) needs ops/jpeg.py, which is not
    ported yet.

Every draw takes a ``torch.Generator`` or the drawn tensors themselves
(``draws``), so a test can hand this package and the JAX package the same
numbers.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..ops.degrade import blur_per_sample, downsample
from ..ops.kernels import sigma2kernel


class SISRBatch(NamedTuple):
    im_hr: torch.Tensor      # N x H x W x C
    im_lr: torch.Tensor      # N x H/sf x W/sf x C
    im_blur: torch.Tensor    # N x H/sf x W/sf x C (pre-noise LR)
    kinfo: torch.Tensor      # N x 3 (s1, s2, rho): marginal variances + corr
    nlevel: torch.Tensor     # N x 1 noise std


def _uniform(shape, lo, hi, generator, device):
    return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                       device=device)


def sample_kernel_params(batch: int, sf: int,
                         generator: Optional[torch.Generator] = None,
                         draws: Optional[dict] = None, device="cpu"):
    """Sample (l1, l2, theta) per the reference distribution; returns the
    covariance matrices (N, 2, 2) in the *data* (x-first) convention and
    kinfo (N, 3) = (S00, S11, rho).  ``draws``: dict(lam1 in [0.2, sf),
    lam2_u and iso_u in [0, 1), theta in [0, pi)), each (N,)."""
    if draws is None:
        draws = dict(
            lam1=_uniform((batch,), 0.2, float(sf), generator, device),
            lam2_u=_uniform((batch,), 0.0, 1.0, generator, device),
            iso_u=_uniform((batch,), 0.0, 1.0, generator, device),
            theta=_uniform((batch,), 0.0, math.pi, generator, device))
    lam1, theta = draws["lam1"], draws["theta"]
    lam2 = lam1 + draws["lam2_u"] * (float(sf) - lam1)    # U(lam1, sf)
    lam2 = torch.where(draws["iso_u"] >= 0.7, lam1, lam2)  # w.p. 0.3 isotropic

    v1, v2 = lam1 ** 2, lam2 ** 2                          # variances
    c, s = torch.cos(theta), torch.sin(theta)
    # S = U diag(v1, v2) U^T with U = [[c, -s], [s, c]]
    s00 = c * c * v1 + s * s * v2
    s11 = s * s * v1 + c * c * v2
    s01 = c * s * (v1 - v2)
    cov = torch.stack([torch.stack([s00, s01], -1),
                       torch.stack([s01, s11], -1)], -2)   # N x 2 x 2
    rho = s01 / (torch.sqrt(s00) * torch.sqrt(s11))
    return cov, torch.stack([s00, s11, rho], dim=-1)


def blur_symmetric_convolve(x: torch.Tensor,
                            kernels: torch.Tensor) -> torch.Tensor:
    """Per-sample true convolution with scipy-compatible 'symmetric'
    padding: the host data path's semantics (K5 on the card)."""
    return blur_per_sample(x, kernels, correlate=False, pad_mode="symmetric")


@torch.no_grad()
def synthesize_sisr_batch(im_hr: torch.Tensor, sf: int, k_size: int = 21,
                          kernel_shift: bool = False,
                          downsampler: str = "bicubic",
                          noise_level=(0.1, 15.0), add_jpeg: bool = False,
                          noise_jpeg=(0.1, 10.0),
                          generator: Optional[torch.Generator] = None,
                          draws: Optional[dict] = None) -> SISRBatch:
    """HR batch (N, H, W, C) float32 -> degraded training batch, on the
    device of ``im_hr``.  ``draws`` holds the kernel draws of
    ``sample_kernel_params`` plus ``nlevel`` (N,), the noise std, and
    ``noise``, standard normals of the LR shape."""
    if add_jpeg:
        raise NotImplementedError(
            "the JPEG noise branch needs ops/jpeg.py, which is not ported "
            "yet")
    batch, dev = im_hr.shape[0], im_hr.device
    cov, kinfo = sample_kernel_params(batch, sf, generator, draws, dev)
    # torch-convention kernel transposed == numpy/data-convention kernel
    kernels = sigma2kernel(cov, k_size, sf, shift=kernel_shift).transpose(
        -2, -1).contiguous()

    im_blur = blur_symmetric_convolve(im_hr, kernels).clamp_(0.0, 1.0)
    im_blur_lr = downsample(im_blur, sf, downsampler)

    if draws is None:
        std = _uniform((batch,), noise_level[0] / 255.0,
                       noise_level[1] / 255.0, generator, dev)
        noise = torch.randn(im_blur_lr.shape, generator=generator, device=dev)
    else:
        std, noise = draws["nlevel"], draws["noise"]
    im_lr = torch.clamp(im_blur_lr + noise * std.view(batch, 1, 1, 1),
                        0.0, 1.0)
    return SISRBatch(im_hr=im_hr, im_lr=im_lr, im_blur=im_blur_lr,
                     kinfo=kinfo, nlevel=std.reshape(batch, 1))
