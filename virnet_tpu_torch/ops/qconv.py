"""W8A8 integer convolution, the int8 serving path (counterpart of
virnet_tpu/ops/qconv.py), with K9 and K10 beside their plain PyTorch
versions.

  K10 ``absmax_nhwc`` <- no Pallas kernel: the per-channel absmax of the
                         activations (XLA's reduction in the JAX package);
                         csrc/conv_w8a8.cu, one read of x
  K9 ``conv_q8``      <- no Pallas kernel: the JAX package leaves its
                         quantize and its int8 product to XLA
                         (``lax.conv_general_dilated`` with
                         ``preferred_element_type=int32``); K9 is the
                         hand-written s8 tensor-core convolution of
                         csrc/conv_w8a8.cu, which quantizes the float
                         activations as it stages them

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
one ulp moves an int8 level at every tie; K9 divides with the IEEE
quotient too.

On the card ``conv_w8a8`` is K10 (the absmax), the lockstep group's
reduce, the scales on (Ci,), the weights' fold and quantize (a small
tensor, PyTorch), then K9 on the float activations: no PyTorch pass over
an activation-sized tensor.  On the CPU it is the plain route,
``quantize_symmetric`` and ``conv_s8_plain``: ``F.conv2d`` in float64 of
the int8 values, exact because |acc| <= k^2 * Ci * 127^2 (4.2e7 at RNet's
widest 288 channels) < 2^53, rounded to int32.  Given CUDA tensors a
wrapper launches its kernel or raises.  Tensors are NHWC with HWIO
weights, as in the JAX package.  ``LAUNCHES['absmax_nhwc']`` and
``LAUNCHES['conv_w8a8']`` count the launches.
"""

from __future__ import annotations

import contextvars
import ctypes
import threading

import torch
import torch.nn.functional as F

from .fused_conv import (_DTYPES, LAUNCHES, _aligned, _check, _dtype_code,
                         _fn, _forward_only, _on_cpu, _ret, _stream)
from .jpeg import _divide

QMAX = 127.0
EPS = 1e-12
KC = 32        # K9 takes its input channels 32 at a time

__all__ = ["quantize_symmetric", "quantize_with", "scale_of", "conv_w8a8",
           "conv_q8", "conv_q8_plain", "conv_s8_plain", "absmax_nhwc",
           "absmax_plain", "int32_sums", "AbsmaxGroup", "run_lockstep"]

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


def _batch_absmax(absmax: torch.Tensor) -> torch.Tensor:
    """``absmax``, one chunk's, as the maximum over the chunks of the
    enclosing ``run_lockstep`` (the whole batch's); unchanged outside it."""
    grp = _GROUP.get()
    return absmax if grp is None else grp[0].reduce(grp[1], absmax)


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

def scale_of(absmax: torch.Tensor) -> torch.Tensor:
    """The symmetric int8 scale of an absmax: max(absmax, 1e-12) / 127, a
    division of two tensors."""
    return _divide(torch.clamp_min(absmax, EPS), QMAX)


def quantize_with(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clamp(round(x / scale), -127, 127) as int8, ``scale`` broadcast
    against float32 ``x``."""
    return torch.clamp(torch.round(_divide(x.float(), scale)), -QMAX,
                       QMAX).to(torch.int8)


def quantize_symmetric(x: torch.Tensor, dims):
    """Symmetric absmax int8 quantization over ``dims`` (kept as size 1).
    Returns (q int8, scale float32) with x ~ q * scale."""
    s = scale_of(x.abs().amax(dim=dims, keepdim=True).float())
    return quantize_with(x, s), s


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def absmax_plain(x: torch.Tensor) -> torch.Tensor:
    """K10's function: the per-channel max |x| over (N, H, W) of NHWC
    ``x``, float32 (Ci,)."""
    return x.abs().amax(dim=(0, 1, 2)).float()


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
    """The int8 product: int8 NHWC ``xq`` (N, H, W, Ci) by int8 HWIO ``kq``
    (k, k, Ci, Co), zero 'same' padding k // 2, int32 sums, dequantized by
    the per-output-channel ``sw`` (Co,) and ``bias`` (Co,) or None ->
    (N, H, W, Co) in ``out_dtype``."""
    acc = int32_sums(xq, kq, kq.shape[0] // 2)
    return dequantize(acc, sw, bias, out_dtype).contiguous()


def conv_q8_plain(x, sx, kq, sw, bias=None, out_dtype=torch.float32):
    """K9's function: float NHWC ``x`` quantized with the per-channel
    scales ``sx`` (Ci,) (``quantize_with``), then ``conv_s8_plain``."""
    return conv_s8_plain(quantize_with(x, sx), kq, sw, bias, out_dtype)


# ---------------------------------------------------------------------------
# K10 and K9
# ---------------------------------------------------------------------------

def absmax_nhwc(x: torch.Tensor) -> torch.Tensor:
    """K10: ``absmax_plain``'s function, bit for bit (a max does not depend
    on order).  On the card ``x`` is contiguous float32 or bfloat16."""
    if _on_cpu(x):
        return absmax_plain(x)
    n, h, w, c = x.shape
    code = _dtype_code(x)
    _check(x, "x", x.dtype, (n, h, w, c))
    out = torch.empty(c, dtype=torch.float32, device=x.device)
    _ret(_fn("vt_absmax_nhwc")(x.data_ptr(), out.data_ptr(), n * h * w, c,
                               code, _stream(x)), "vt_absmax_nhwc")
    LAUNCHES["absmax_nhwc"] += 1
    return out


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def kernel_weights(kq: torch.Tensor) -> torch.Tensor:
    """What K9 reads of HWIO int8 ``kq`` (k, k, Ci, Co): (Cip / 32, k*k,
    Co, 32) int8 with Cip = Ci rounded up to 32 and zeros past Ci, each
    output channel's 32 input channels of a chunk contiguous (the B
    operand of mma.sync's row.col layout): a weight-sized copy."""
    k, _, ci, co = kq.shape
    cip = _round_up(ci, KC)
    wk = F.pad(kq.reshape(k * k, ci, co), (0, 0, 0, cip - ci))
    return wk.reshape(k * k, cip // KC, KC, co).permute(1, 0, 3, 2) \
        .contiguous()


def conv_q8_plan(k: int, ci: int, co: int,
                 out_dtype=torch.bfloat16) -> dict:
    """How K9 splits Co on the card: co_blk output channels a block (a
    width wgmma takes), the number of splits, the last split's channels
    (co_blk, or 32), and the shared memory a block takes (card only)."""
    out = (ctypes.c_int * 4)()
    _ret(_fn("vt_conv_w8a8_plan")(k, ci, co, _DTYPES[out_dtype], out),
         "vt_conv_w8a8_plan")
    return dict(co_blk=out[0], splits=out[1], tail=out[2],
                smem_bytes=out[3])


def conv_q8(x, sx, kq, sw, bias=None, out_dtype=torch.float32):
    """K9: ``conv_q8_plain``'s function, bit for bit.  On the card ``x``
    is contiguous bfloat16 (the int8 mode's activations), k is 1 or 3,
    ``out_dtype`` float32 or bfloat16, ``sx`` float32 (Ci,), ``sw`` and
    ``bias`` float32 (Co,); the weights are laid out by
    ``kernel_weights``."""
    ts = [x, sx, kq, sw] + ([] if bias is None else [bias])
    if _on_cpu(*ts):
        return conv_q8_plain(x, sx, kq, sw, bias, out_dtype)
    n, h, w, ci = x.shape
    k, k2, ci_k, co = kq.shape
    if k not in (1, 3) or k2 != k:
        raise ValueError(f"K9 takes 1x1 and 3x3 kernels, got {k}x{k2}")
    if ci_k != ci:
        raise ValueError(f"kernel has {ci_k} input channels, x has {ci}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"K9 reads bfloat16, got {x.dtype}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"K9 writes float32 or bfloat16, got {out_dtype}")
    _check(x, "x", x.dtype, (n, h, w, ci))
    _check(sx, "sx", torch.float32, (ci,))
    _check(kq, "kq", torch.int8, (k, k, ci, co))
    _check(sw, "sw", torch.float32, (co,))
    if bias is not None:
        _check(bias, "bias", torch.float32, (co,))
    wk = kernel_weights(kq)
    y = torch.empty((n, h, w, co), dtype=out_dtype, device=x.device)
    _aligned(sx=sx, kq=wk)
    _ret(_fn("vt_conv_w8a8")(
        x.data_ptr(), sx.data_ptr(), wk.data_ptr(), sw.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(), n, h, w,
        ci, co, k, _DTYPES[out_dtype], _stream(x)),
        "vt_conv_w8a8")
    LAUNCHES["conv_w8a8"] += 1
    return y


def conv_w8a8(x: torch.Tensor, kernel: torch.Tensor, bias=None, *,
              out_dtype=torch.float32, stride: int = 1,
              padding=None) -> torch.Tensor:
    """int8 x int8 -> int32 convolution of float NHWC ``x`` (N, H, W, Ci)
    by float HWIO ``kernel`` (k, k, Ci, Co), both quantized as the module
    docstring says; (N, H, W, Co) in ``out_dtype`` (float32 is the JAX
    function's output).  Stride 1 and 'same' padding only: the convs the
    int8 gate takes (models/common.int8_gated).  Inside ``run_lockstep``
    the activation absmax is the whole batch's."""
    _forward_only("conv_w8a8", x, kernel,
                  *([] if bias is None else [bias]))
    k = kernel.shape[0]
    if stride != 1 or (padding is not None and padding != k // 2):
        raise ValueError("conv_w8a8 takes stride 1 and padding k // 2")
    sx = scale_of(_batch_absmax(absmax_nhwc(x)))
    folded = kernel.float() * sx.reshape(1, 1, -1, 1)
    kq, sw = quantize_symmetric(folded, (0, 1, 2))
    b = None if bias is None else bias.float()
    return conv_q8(x, sx, kq, sw.reshape(-1), b, out_dtype)
