"""The per-sample blur kernels (forward, dX, dW), each beside its plain
PyTorch version (counterpart of virnet_tpu/ops/pallas_blur.py).

  K5 ``blur_valid`` <- pallas_blur._blur_pallas_valid, _blur_mxu_valid
  K6 ``blur_dx``    <- pallas_blur._blur_mxu_dx (and the fallback of _dx_blur)
  K7 ``blur_dw``    <- pallas_blur._blur_mxu_dw, _blur_pallas_dw

Images are NHWC float32 and kernels (N, k, k) float32; the CUDA sources
are in ``csrc/blur.cu``, which builds K5 and K6 for the k of
``SUPPORTED_K`` (the configs' 21, the tests' 3, 5, 7, and 15) and any C
(a block takes up to 8 channels); the plain versions take any k.
``valid_blur`` is the op with a
gradient: forward K5, backward K6 and K7.  The padding stays outside it,
so autograd folds the halo back according to the pad mode (``pad_hw``).
A wrapper given CPU tensors runs the plain version (the k*k shifted-slice
loop in f32); given CUDA tensors it launches its kernel or raises.  K7 is
deterministic (fixed summation order, no atomics), so the backward is
bitwise reproducible.
"""

from __future__ import annotations

import torch

from .fused_conv import COPIES, LAUNCHES, _check, _fn, _on_cpu, _ret, _stream

SUPPORTED_K = (3, 5, 7, 15, 21)


def _check_k(k: int) -> None:
    if k not in SUPPORTED_K:
        raise ValueError(f"the blur kernels are built for k in "
                         f"{SUPPORTED_K}, got {k}")


def _shapes(xp: torch.Tensor, kernels: torch.Tensor):
    n, hp, wp, c = xp.shape
    k = kernels.shape[-1]
    if tuple(kernels.shape) != (n, k, k):
        raise ValueError(f"kernels: shape {tuple(kernels.shape)}, expected "
                         f"({n}, k, k)")
    if hp < k or wp < k:
        raise ValueError(f"padded input {hp}x{wp} is smaller than k={k}")
    return n, hp - k + 1, wp - k + 1, c, k


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def blur_valid_plain(xp: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """out[n, y, x, c] = sum_{dy,dx} kernels[n, dy, dx]
    * xp[n, y+dy, x+dx, c]; (N, Hp, Wp, C) -> (N, Hp-k+1, Wp-k+1, C)."""
    n, h, w, c, k = _shapes(xp, kernels)
    out = xp.new_zeros((n, h, w, c))
    for dy in range(k):
        for dx in range(k):
            out = out + (kernels[:, dy, dx].view(n, 1, 1, 1)
                         * xp[:, dy:dy + h, dx:dx + w])
    return out


def blur_dx_plain(g: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """dxp[n, p, q, c] = sum_{dy,dx} kernels[n, dy, dx] * g[n, p-dy, q-dx,
    c] with g zero outside the image; (N, H, W, C) -> (N, H+k-1, W+k-1, C)."""
    n, h, w, c = g.shape
    k = kernels.shape[-1]
    out = g.new_zeros((n, h + k - 1, w + k - 1, c))
    for dy in range(k):
        for dx in range(k):
            out[:, dy:dy + h, dx:dx + w] += (
                kernels[:, dy, dx].view(n, 1, 1, 1) * g)
    return out


def blur_dw_plain(xp: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dw[n, dy, dx] = sum_{c,y,x} g[n, y, x, c] * xp[n, y+dy, x+dx, c];
    xp (N, H+k-1, W+k-1, C), g (N, H, W, C) -> (N, k, k)."""
    n, h, w, _ = g.shape
    k = xp.shape[1] - h + 1
    out = xp.new_zeros((n, k, k))
    for dy in range(k):
        for dx in range(k):
            out[:, dy, dx] = (g * xp[:, dy:dy + h, dx:dx + w]).sum((1, 2, 3))
    return out


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def blur_valid(xp: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """K5: VALID correlation of each sample with its own kernel."""
    if _on_cpu(xp, kernels):
        return blur_valid_plain(xp, kernels)
    n, h, w, c, k = _shapes(xp, kernels)
    _check_k(k)
    _check(xp, "xp", torch.float32, (n, h + k - 1, w + k - 1, c))
    _check(kernels, "kernels", torch.float32, (n, k, k))
    out = torch.empty((n, h, w, c), dtype=torch.float32, device=xp.device)
    _ret(_fn("vt_blur_valid")(xp.data_ptr(), kernels.data_ptr(),
                              out.data_ptr(), n, h, w, c, k, _stream(xp)),
         "vt_blur_valid")
    LAUNCHES["blur_valid"] += 1
    return out


def blur_dx(g: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """K6: the gradient of K5 with respect to its padded input."""
    if _on_cpu(g, kernels):
        return blur_dx_plain(g, kernels)
    n, h, w, c = g.shape
    k = kernels.shape[-1]
    _check_k(k)
    _check(g, "g", torch.float32, (n, h, w, c))
    _check(kernels, "kernels", torch.float32, (n, k, k))
    out = torch.empty((n, h + k - 1, w + k - 1, c), dtype=torch.float32,
                      device=g.device)
    _ret(_fn("vt_blur_dx")(g.data_ptr(), kernels.data_ptr(), out.data_ptr(),
                           n, h, w, c, k, _stream(g)), "vt_blur_dx")
    LAUNCHES["blur_dx"] += 1
    return out


def blur_dw(xp: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K7: the gradient of K5 with respect to the kernels (one launch of
    the chunk kernel and one of the fixed-order chunk sum)."""
    if _on_cpu(xp, g):
        return blur_dw_plain(xp, g)
    n, h, w, c = g.shape
    k = xp.shape[1] - h + 1
    _check_k(k)
    _check(g, "g", torch.float32, (n, h, w, c))
    _check(xp, "xp", torch.float32, (n, h + k - 1, w + k - 1, c))
    elems = _fn("vt_blur_dw_scratch_elems")(n, h, w, c, k)
    if elems <= 0:
        raise ValueError(f"blur_dw: shapes xp {tuple(xp.shape)}, g "
                         f"{tuple(g.shape)} do not fit the kernel")
    scratch = torch.empty(elems, dtype=torch.float32, device=xp.device)
    out = torch.empty((n, k, k), dtype=torch.float32, device=xp.device)
    _ret(_fn("vt_blur_dw")(xp.data_ptr(), g.data_ptr(), scratch.data_ptr(),
                           out.data_ptr(), n, h, w, c, k, _stream(xp)),
         "vt_blur_dw")
    LAUNCHES["blur_dw"] += 1
    return out


# ---------------------------------------------------------------------------
# the op with a gradient
# ---------------------------------------------------------------------------

class _ValidBlur(torch.autograd.Function):
    """blur_valid with blur_dx / blur_dw as its backward (counterpart of
    the custom VJP at pallas_blur.py:423-473, minus the padding)."""

    @staticmethod
    def forward(ctx, xp, kernels):
        ctx.save_for_backward(xp, kernels)
        return blur_valid(xp, kernels)

    @staticmethod
    def backward(ctx, g):
        xp, kernels = ctx.saved_tensors
        if not g.is_contiguous():
            # a broadcast or permuted cotangent; counted, never silent
            g = g.contiguous()
            COPIES["blur_cotangent"] += 1
        dxp = blur_dx(g, kernels) if ctx.needs_input_grad[0] else None
        dw = blur_dw(xp, g) if ctx.needs_input_grad[1] else None
        return dxp, dw


def valid_blur(xp: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Differentiable VALID per-sample correlation: xp (N, Hp, Wp, C),
    kernels (N, k, k) -> (N, Hp-k+1, Wp-k+1, C)."""
    return _ValidBlur.apply(xp, kernels)


def pad_hw(x: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    """Pad the H and W axes of NHWC ``x`` by ``pad`` on every side:
    'reflect' mirrors without repeating the edge pixel (torch ``F.pad``
    reflect, numpy 'reflect'), 'symmetric' repeats it (numpy 'symmetric',
    scipy.ndimage 'reflect'; torch has no such mode).  Built from slices,
    flips and one concatenation per axis: differentiable, contiguous NHWC
    out, and a deterministic backward."""
    if mode not in ("reflect", "symmetric"):
        raise ValueError(f"pad_mode must be reflect|symmetric, got {mode!r}")
    if pad == 0:
        return x
    first = 1 if mode == "reflect" else 0
    for axis in (1, 2):
        size = x.shape[axis]
        if pad + first > size:
            raise ValueError(f"{mode} padding by {pad} needs an axis of at "
                             f"least {pad + first}, got {size}")
        lo = x.narrow(axis, first, pad).flip(axis)
        hi = x.narrow(axis, size - first - pad, pad).flip(axis)
        x = torch.cat([lo, x, hi], dim=axis)
    return x
