"""Anti-aliased separable resampling (ResizeRight-equivalent; counterpart
of virnet_tpu/ops/resize.py).

The reference vendors ResizeRight (ResizeRight/resize_right.py) and uses its
bicubic mode both to synthesize SISR training pairs and *inside the SISR
ELBO* (utils/util_sisr.py:127-144), so numerical parity here directly moves
PSNR.  The math reproduced exactly:

  * projected grid   p(o) = o/s + (in-1)/2 - (out-1)/(2s)
  * antialiasing     for s<1: kernel(x) -> s*kernel(s*x), support /= s
  * field of view    left = ceil(p - support/2 - eps); fov = left + [0..W)
  * mirror trick     fov is remapped through [0..n-1, n-1..0] BEFORE the
                     weights are evaluated (distances are taken to the
                     mirrored index values — a quirk of ResizeRight that is
                     reproduced deliberately; see resize_right.py:265-297)
  * normalization    weights sum to 1 per output pixel

Each resized axis is a dense (out_sz, in_sz) weight matrix computed once on
the host in float64 and cached; applying it is one ``torch.matmul`` per
axis, with the matrix cast to the input dtype and its device copy cached
per (device, dtype).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch

_F32_EPS = float(np.finfo(np.float32).eps)


# ---------------------------------------------------------------------------
# Interpolation kernels (support size, callable) — float64 numpy
# ---------------------------------------------------------------------------

def _cubic(x):
    absx = np.abs(x)
    absx2 = absx ** 2
    absx3 = absx ** 3
    return (1.5 * absx3 - 2.5 * absx2 + 1.0) * (absx <= 1.0) + (
        -0.5 * absx3 + 2.5 * absx2 - 4.0 * absx + 2.0
    ) * ((1.0 < absx) & (absx <= 2.0))


def _lanczos(x, a):
    eps = _F32_EPS
    return ((np.sin(np.pi * x) * np.sin(np.pi * x / a) + eps)
            / ((np.pi ** 2 * x ** 2 / a) + eps)) * (np.abs(x) < a)


def _linear(x):
    return (x + 1) * ((-1 <= x) & (x < 0)) + (1 - x) * ((0 <= x) & (x <= 1))


def _box(x):
    return ((-1 <= x) & (x < 0)).astype(np.float64) + (
        (0 <= x) & (x <= 1)
    ).astype(np.float64)


_KERNELS = {
    "cubic": (_cubic, 4.0),
    "lanczos2": (lambda x: _lanczos(x, 2), 4.0),
    "lanczos3": (lambda x: _lanczos(x, 3), 6.0),
    "linear": (_linear, 2.0),
    "box": (_box, 1.0),
}


# ---------------------------------------------------------------------------
# Weight-matrix construction
# ---------------------------------------------------------------------------

@lru_cache(maxsize=256)
def resize_matrix(in_sz: int, out_sz: int, scale: float,
                  method: str = "cubic", antialias: bool = True) -> np.ndarray:
    """Dense (out_sz, in_sz) float64 resampling matrix for one axis."""
    kernel, support = _KERNELS[method]
    if antialias and scale < 1.0:
        base_kernel = kernel
        kernel = lambda x: scale * base_kernel(scale * x)  # noqa: E731
        support = support / scale

    out_coords = np.arange(out_sz, dtype=np.float64)
    projected = (out_coords / scale + (in_sz - 1) / 2
                 - (out_sz - 1) / (2 * scale))

    left = np.ceil(projected - support / 2 - _F32_EPS).astype(np.int64)
    window = int(math.ceil(support - _F32_EPS))
    fov = left[:, None] + np.arange(window)[None, :]          # (out, window)

    mirror = np.concatenate([np.arange(in_sz), np.arange(in_sz - 1, -1, -1)])
    fov = mirror[np.remainder(fov, mirror.shape[0])]

    weights = kernel(projected[:, None] - fov)                 # (out, window)
    wsum = weights.sum(axis=1, keepdims=True)
    wsum[wsum == 0] = 1.0
    weights = weights / wsum

    mat = np.zeros((out_sz, in_sz), dtype=np.float64)
    np.add.at(mat, (np.repeat(np.arange(out_sz), window), fov.ravel()),
              weights.ravel())
    mat.setflags(write=False)
    return mat


def _resolve_sizes(in_sizes: Sequence[int],
                   scale_factors, out_shape) -> Tuple[list, list]:
    """Per-axis (scale, out_sz) resolution, matching ResizeRight defaults."""
    n = len(in_sizes)
    if scale_factors is None and out_shape is None:
        raise ValueError("either scale_factors or out_shape is required")
    if out_shape is not None:
        out_shape = list(out_shape)
        assert len(out_shape) == n
        if scale_factors is None:
            scale_factors = [o / i for o, i in zip(out_shape, in_sizes)]
    if scale_factors is not None:
        if not isinstance(scale_factors, (list, tuple)):
            scale_factors = [scale_factors] * n
        scale_factors = [float(s) for s in scale_factors]
        if out_shape is None:
            out_shape = [int(math.ceil(s * i))
                         for s, i in zip(scale_factors, in_sizes)]
    return scale_factors, out_shape


# ---------------------------------------------------------------------------
# Application
# ---------------------------------------------------------------------------

def resize_np(im: np.ndarray,
              scale_factors=None,
              out_shape=None,
              axes: Sequence[int] = (0, 1),
              method: str = "cubic",
              antialias: bool = True) -> np.ndarray:
    """Host-side resize in float64 (parity with the reference numpy path,
    which promotes to float64 through integer-arange arithmetic)."""
    axes = [a % im.ndim for a in axes]
    in_sizes = [im.shape[a] for a in axes]
    scales, outs = _resolve_sizes(in_sizes, scale_factors, out_shape)

    # process dims sorted by ascending scale (downscales first) — stable sort,
    # same order as the reference
    order = sorted(range(len(axes)), key=lambda i: scales[i])
    out = im.astype(np.float64, copy=False)
    for i in order:
        if scales[i] == 1.0 and outs[i] == in_sizes[i]:
            continue
        mat = resize_matrix(in_sizes[i], outs[i], scales[i], method, antialias)
        out = np.moveaxis(np.tensordot(mat, np.moveaxis(out, axes[i], 0),
                                       axes=([1], [0])), 0, axes[i])
    return out


_DEVICE_MATS: dict = {}


def _matrix_on(x: torch.Tensor, in_sz: int, out_sz: int, scale: float,
               method: str, antialias: bool) -> torch.Tensor:
    key = (in_sz, out_sz, scale, method, antialias, x.device, x.dtype)
    mat = _DEVICE_MATS.get(key)
    if mat is None:
        mat = torch.from_numpy(np.array(resize_matrix(
            in_sz, out_sz, scale, method, antialias))).to(x.device, x.dtype)
        _DEVICE_MATS[key] = mat
    return mat


def resize_nhwc(x: torch.Tensor, scale_factors=None, out_shape=None,
                method: str = "cubic",
                antialias: bool = True) -> torch.Tensor:
    """Resize the H and W axes of an NHWC tensor: out = M_h x along H and
    M_w x along W, the axes taken in ascending order of scale (stable), as
    the reference does.  Both products keep NHWC contiguous in the forward
    and in the backward."""
    n, h, w, c = x.shape
    in_sizes = [h, w]
    scales, outs = _resolve_sizes(in_sizes, scale_factors, out_shape)
    for i in sorted(range(2), key=lambda i: scales[i]):
        if scales[i] == 1.0 and outs[i] == in_sizes[i]:
            continue
        mat = _matrix_on(x, in_sizes[i], outs[i], scales[i], method,
                         antialias)
        if i == 0:
            # (out_h, H) @ (N, H, W*C)
            x = torch.matmul(mat, x.reshape(n, x.shape[1], -1)).reshape(
                n, outs[0], x.shape[2], c)
        else:
            # (out_w, W) @ (N, H, W, C), broadcast over N and H
            x = torch.matmul(mat, x)
    return x
