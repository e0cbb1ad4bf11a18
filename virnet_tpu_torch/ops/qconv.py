"""W8A8 integer convolution, the int8 serving path (counterpart of
virnet_tpu/ops/qconv.py), with K9 beside its plain PyTorch version.

  K9 ``conv_s8`` <- no Pallas kernel: the JAX package leaves its int8
                    product to XLA (``lax.conv_general_dilated`` with
                    ``preferred_element_type=int32``); K9 is the hand-written
                    s8 tensor-core convolution of csrc/conv_w8a8.cu

The scheme is the JAX package's, with no calibration state:

  * activations: a symmetric int8 scale per input channel, the absmax over
    (N, H, W) divided by 127, so it depends on the whole batch.  A scale
    per input channel cannot be applied after the sum over input channels,
    so it is folded into the weight, ``w'[.., i, o] = w[.., i, o] * sx[i]``;
  * weights: a symmetric scale per output channel, the absmax of the
    folded weight over (kh, kw, Ci);
  * int32 sums, then ``float32(acc) * sw[o]`` and the bias added in
    float32 as a second rounding.

Rounding is half to even (``torch.round``, as ``jnp.round``), clipped to
+-127; a scale is at least 1e-12 / 127, so a dead channel quantizes to
zeros.  Every quotient is a division of two tensors: on the card PyTorch
computes ``t / 127.0`` as ``t * (1 / 127.0)``, an ulp away at times, and
one ulp moves an int8 level at every tie.  Quantization is plain PyTorch on
every device, as the JAX package leaves it to XLA; the product and its
dequantizing epilogue are K9 on the card.

Tensors are NHWC with HWIO weights, as in the JAX package.  ``conv_s8``
given CPU tensors runs the plain version: ``F.conv2d`` in float64 of the
int8 values, exact because |acc| <= k^2 * Ci * 127^2 (4.2e7 at RNet's widest
288 channels) < 2^53, rounded to int32; given CUDA tensors it launches K9
or raises.  ``LAUNCHES['conv_w8a8']`` counts K9's launches.
"""

from __future__ import annotations

import contextvars
import threading

import torch
import torch.nn.functional as F

from .fused_conv import (LAUNCHES, _aligned, _check, _fn, _forward_only,
                         _on_cpu, _ret, _stream)
from .jpeg import _divide

QMAX = 127.0
EPS = 1e-12
KC = 32        # K9 takes its input channels 32 at a time
CO_ALIGN = 8   # and its output channels 8 at a time (one mma n-tile)

__all__ = ["quantize_symmetric", "conv_w8a8", "conv_s8", "conv_s8_plain",
           "int32_sums", "AbsmaxGroup", "run_lockstep"]

# ---------------------------------------------------------------------------
# scales shared by the replicas of one batch
# ---------------------------------------------------------------------------

class AbsmaxGroup:
    """The activation absmax of each quantized conv taken over the chunks
    of one batch that ``size`` threads run in lockstep, one chunk each (the
    replicas of ``Restorer(mesh=...)``): every thread hands its chunk's
    absmax and gets back the maximum over all chunks on its own device, so
    every chunk quantizes with the scale of the whole batch, as the JAX
    package's jit over a sharded batch does.  The threads must run the same
    sequence of quantized convs; a thread that fails calls ``abort`` so
    that the others raise instead of waiting."""

    def __init__(self, size: int):
        self.size = size
        self._slots: list = [None] * size
        self._barrier = threading.Barrier(size)

    def reduce(self, rank: int, absmax: torch.Tensor) -> torch.Tensor:
        self._slots[rank] = absmax
        self._barrier.wait()
        out = absmax
        for other in self._slots:
            out = torch.maximum(out, other.to(absmax.device))
        self._barrier.wait()   # every thread has read the slots
        return out

    def abort(self) -> None:
        self._barrier.abort()


# (group, rank) of the thread's chunk inside run_lockstep, else None
_GROUP = contextvars.ContextVar("virnet_tpu_torch_absmax_group",
                                default=None)


def run_lockstep(calls):
    """Run ``calls`` (functions of no arguments, each on one chunk of a
    batch) in one thread each and one ``AbsmaxGroup``, so that every chunk
    quantizes with the scales of the whole batch; each thread runs in a
    copy of the caller's context.  Returns the results in order; re-raises
    the first failure (the others are aborted, not left waiting)."""
    group = AbsmaxGroup(len(calls))
    results: list = [None] * len(calls)
    errors: list = [None] * len(calls)

    def run(rank, fn):
        _GROUP.set((group, rank))     # this thread's own context copy
        try:
            results[rank] = fn()
        except BaseException as err:   # noqa: BLE001 - re-raised below
            errors[rank] = err
            group.abort()

    threads = [threading.Thread(target=contextvars.copy_context().run,
                                args=(run, rank, fn))
               for rank, fn in enumerate(calls)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failed = [e for e in errors if e is not None]
    if failed:
        raise next((e for e in failed
                    if not isinstance(e, threading.BrokenBarrierError)),
                   failed[0])
    return results


# ---------------------------------------------------------------------------
# quantization (plain PyTorch on every device)
# ---------------------------------------------------------------------------

def quantize_symmetric(x: torch.Tensor, dims, shared: bool = False):
    """Symmetric absmax int8 quantization over ``dims`` (kept as size 1).
    Returns (q int8, scale float32) with x ~ q * scale.  ``shared`` takes
    the absmax over the whole batch of the enclosing ``run_lockstep``."""
    s = x.abs().amax(dim=dims, keepdim=True).float()
    grp = _GROUP.get() if shared else None
    if grp is not None:
        s = grp[0].reduce(grp[1], s)
    s = _divide(torch.clamp_min(s, EPS), QMAX)
    q = torch.clamp(torch.round(_divide(x.float(), s)), -QMAX, QMAX)
    return q.to(torch.int8), s


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def int32_sums(xq: torch.Tensor, kq: torch.Tensor,
               padding: int) -> torch.Tensor:
    """The int32 sums of the 'same' convolution of int8 NHWC ``xq`` by int8
    HWIO ``kq`` with zero padding ``padding``: ``F.conv2d`` in float64 of
    the int8 values (exact, see the module docstring), rounded to int32;
    NHWC out."""
    acc = F.conv2d(xq.double().permute(0, 3, 1, 2),
                   kq.double().permute(3, 2, 0, 1), padding=padding)
    return torch.round(acc).to(torch.int32).permute(0, 2, 3, 1)


def dequantize(acc: torch.Tensor, sw: torch.Tensor, bias,
               out_dtype) -> torch.Tensor:
    """float32(acc) * sw[o], then + bias[o] in float32 (two roundings),
    then one rounding to ``out_dtype``."""
    y = acc.float() * sw.reshape(-1).float()
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def conv_s8_plain(xq, kq, sw, bias=None, out_dtype=torch.float32):
    """K9's function: int8 NHWC ``xq`` (N, H, W, Ci) by int8 HWIO ``kq``
    (k, k, Ci, Co), zero 'same' padding k // 2, int32 sums, dequantized by
    the per-output-channel ``sw`` (Co,) and ``bias`` (Co,) or None ->
    (N, H, W, Co) in ``out_dtype``."""
    acc = int32_sums(xq, kq, kq.shape[0] // 2)
    return dequantize(acc, sw, bias, out_dtype).contiguous()


# ---------------------------------------------------------------------------
# K9
# ---------------------------------------------------------------------------

_OUT = {torch.float32: 0, torch.bfloat16: 1}


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def kernel_operands(xq: torch.Tensor, kq: torch.Tensor):
    """What K9 reads: ``xq`` with its channels zero-padded to a multiple of
    32 (exact: zero channels add zero products), and ``kq`` as (k*k, Co8,
    Ci32) int8, each output channel's input channels contiguous (the B
    operand of mma.sync's row.col layout), zero-padded likewise to Co8 a
    multiple of 8.  The padding is a copy only where a width is not
    already a multiple."""
    ci = xq.shape[3]
    k, _, _, co = kq.shape
    cip, cop = _round_up(ci, KC), _round_up(co, CO_ALIGN)
    if cip != ci:
        xq = F.pad(xq, (0, cip - ci))
    wk = kq.permute(0, 1, 3, 2).reshape(k * k, co, ci)
    wk = F.pad(wk, (0, cip - ci, 0, cop - co)).contiguous()
    return xq.contiguous(), wk


def conv_s8(xq, kq, sw, bias=None, out_dtype=torch.float32) -> torch.Tensor:
    """K9: ``conv_s8_plain``'s function.  On the card k is 1 or 3, Co at
    least 1, ``out_dtype`` float32 or bfloat16, ``sw`` and ``bias`` float32
    (Co,); the operands are padded and laid out by ``kernel_operands``."""
    ts = [xq, kq, sw] + ([] if bias is None else [bias])
    if _on_cpu(*ts):
        return conv_s8_plain(xq, kq, sw, bias, out_dtype)
    n, h, w, ci = xq.shape
    k, k2, ci_k, co = kq.shape
    if k not in (1, 3) or k2 != k:
        raise ValueError(f"K9 takes 1x1 and 3x3 kernels, got {k}x{k2}")
    if ci_k != ci:
        raise ValueError(f"kernel has {ci_k} input channels, x has {ci}")
    if out_dtype not in _OUT:
        raise TypeError(f"K9 writes float32 or bfloat16, got {out_dtype}")
    _check(xq, "xq", torch.int8, (n, h, w, ci))
    _check(kq, "kq", torch.int8, (k, k, ci, co))
    _check(sw, "sw", torch.float32, (co,))
    if bias is not None:
        _check(bias, "bias", torch.float32, (co,))
    xk, wk = kernel_operands(xq, kq)
    y = torch.empty((n, h, w, co), dtype=out_dtype, device=xq.device)
    _aligned(xq=xk, kq=wk)
    _ret(_fn("vt_conv_w8a8")(
        xk.data_ptr(), wk.data_ptr(), sw.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(), n, h, w,
        xk.shape[3], co, wk.shape[1], k, _OUT[out_dtype], _stream(xq)),
        "vt_conv_w8a8")
    LAUNCHES["conv_w8a8"] += 1
    return y


def conv_w8a8(x: torch.Tensor, kernel: torch.Tensor, bias=None, *,
              out_dtype=torch.float32, stride: int = 1,
              padding=None) -> torch.Tensor:
    """int8 x int8 -> int32 convolution of float NHWC ``x`` (N, H, W, Ci)
    by float HWIO ``kernel`` (k, k, Ci, Co), both quantized here as the
    module docstring says; (N, H, W, Co) in ``out_dtype`` (float32 is the
    JAX function's output).  Stride 1 and 'same' padding only: the convs
    the int8 gate takes (models/common.int8_gated)."""
    _forward_only("conv_w8a8", x, kernel,
                  *([] if bias is None else [bias]))
    k = kernel.shape[0]
    if stride != 1 or (padding is not None and padding != k // 2):
        raise ValueError("conv_w8a8 takes stride 1 and padding k // 2")
    xq, sx = quantize_symmetric(x, (0, 1, 2), shared=True)
    folded = kernel.float() * sx.reshape(1, 1, -1, 1)
    kq, sw = quantize_symmetric(folded, (0, 1, 2))
    b = None if bias is None else bias.float()
    return conv_s8(xq, kq, sw.reshape(-1), b, out_dtype)
