"""Deterministic and random sigma-field (noise level map) generators
(copy of virnet_tpu/ops/sigma_fields.py; reference
utils/util_denoising.py:12-22, 69-124, datasets/DenoisingDatasets.py:190-211).

Host-side numpy: the fields are small and feed seeded eval pipelines whose
bits are part of the test contract (the Table-1 non-i.i.d. benchmark and
the in-training validation set).
"""

from __future__ import annotations

import math

import numpy as np


def gaussian_bump(h: int, w: int, center, scale: float) -> np.ndarray:
    """Normalized 2-D Gaussian bump at an arbitrary (row, col) center."""
    ch, cw = center
    ii, jj = np.meshgrid(np.arange(h, dtype=np.float64),
                         np.arange(w, dtype=np.float64), indexing="ij")
    kk = np.exp((-(ii - ch) ** 2 - (jj - cw) ** 2) / (2 * scale ** 2))
    return kk / kk.sum()


def peaks(n: int) -> np.ndarray:
    """MATLAB ``peaks`` function on an n x n grid over [-3, 3]^2."""
    x = np.linspace(-3, 3, n)
    xx, yy = np.meshgrid(x, x)
    zz = (3 * (1 - xx) ** 2 * np.exp(-xx ** 2 - (yy + 1) ** 2)
          - 10 * (xx / 5.0 - xx ** 3 - yy ** 5) * np.exp(-xx ** 2 - yy ** 2)
          - 1 / 3.0 * np.exp(-(xx + 1) ** 2 - yy ** 2))
    return zz


def sincos_kernel() -> np.ndarray:
    """sin(x)+cos(y) benchmark field on a 256^2 grid."""
    xx, yy = np.meshgrid(np.linspace(1, 10, 256), np.linspace(1, 20, 256))
    return np.sin(xx) + np.cos(yy)


def gauss_kernel_mix(h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    """Mixture-of-Gaussians field on a 32-px grid of random centers/scales."""
    pch_size = 32
    k_h = math.floor(h / pch_size)
    k_w = math.floor(w / pch_size)
    k = k_h * k_w

    center_w = rng.uniform(low=0, high=pch_size, size=(k_h, k_w))
    center_w = center_w + (np.arange(k_w) * pch_size).reshape(1, -1)
    center_w = center_w.reshape(1, 1, k).astype(np.float32)

    center_h = rng.uniform(low=0, high=pch_size, size=(k_h, k_w))
    center_h = center_h + (np.arange(k_h) * pch_size).reshape(-1, 1)
    center_h = center_h.reshape(1, 1, k).astype(np.float32)

    scale = rng.uniform(low=pch_size / 2, high=pch_size,
                        size=(1, 1, k)).astype(np.float32)

    xx, yy = np.meshgrid(np.arange(0, w), np.arange(0, h))
    xx = xx[:, :, np.newaxis].astype(np.float32)
    yy = yy[:, :, np.newaxis].astype(np.float32)
    zz = (1.0 / (2 * np.pi * scale ** 2)
          * np.exp((-(xx - center_w) ** 2 - (yy - center_h) ** 2)
                   / (2 * scale ** 2)))
    return zz.sum(axis=2) / k


def rescale_field(field: np.ndarray, down: float, up: float) -> np.ndarray:
    """Affinely rescale an arbitrary field into [down, up] (σ units)."""
    lo, hi = field.min(), field.max()
    return (down + (field - lo) / (hi - lo) * (up - down)).astype(np.float32)


def benchmark_sigma_field(case: str, shape=(256, 256),
                          rng: np.random.Generator | None = None,
                          down: float = 10 / 255.0,
                          up: float = 75 / 255.0) -> np.ndarray:
    """The three Table-1 non-i.i.d. benchmark σ fields, rescaled to
    [10, 75]/255 (reference scripts/denoising_virnet_syn.py:101-108)."""
    if case == "peaks":
        field = peaks(shape[0])
    elif case == "sincos":
        field = sincos_kernel()
    elif case == "gauss_mix":
        assert rng is not None, "gauss_mix needs an RNG"
        field = gauss_kernel_mix(shape[0], shape[1], rng)
    else:
        raise ValueError(f"unknown sigma field case: {case}")
    return rescale_field(field, down, up)
