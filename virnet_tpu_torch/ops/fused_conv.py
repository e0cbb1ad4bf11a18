"""The CUDA kernels of the denoising forward, each beside its plain PyTorch
version (counterpart of virnet_tpu/ops/pallas_conv.py).

  K1 ``conv3x3_mid``           <- pallas_conv.conv3x3_mid_pair,
                                  conv3x3_mid_stack_pair (as L launches)
  K2 ``dncnn_fused``           <- pallas_conv.dncnn_pair_fused, a chain of
                                  level kernels: snet_conv1, L x K1,
                                  snet_last (csrc/snet_levels.cu)
  K3 ``dncnn_head_fused``      <- pallas_conv.dncnn_head_fused (halo, carry);
                                  the level chain with the last level's
                                  sigma + head mode: in bf16 the kernels of
                                  csrc/dncnn_head.cu, mids on its wgmma
                                  ``dncnn_head_mid``; in fp32 K2's kernels
  K4 ``conv3x3_tail_residual`` <- pallas_conv.conv3x3_tail_residual
  K8 ``dncnn_head_slabzero``   <- pallas_conv.dncnn_head_fused (slabzero),
                                  a speed probe that no product path routes:
                                  K3's kernels on the input cut into slabs

All tensors are NHWC and conv weights HWIO, as in the JAX package.  Every
conv accumulates in f32 and rounds once to the activation dtype (float32
or bfloat16); the plain versions (``*_plain``) follow the same rounding
with ``F.conv2d`` in f32.  A wrapper given CPU tensors runs the plain
version; given CUDA tensors it launches its kernel or raises — there is no
fallback.  ``LAUNCHES`` counts kernel launches per wrapper, those of the
blur kernels in ``ops/blur.py``, of K9 and K10 in ``ops/qconv.py`` and of
K11 in ``ops/resblock.py`` too.

These kernels are forward-only, like the Pallas kernels they replace
(virnet_tpu/models/common.py:train_conv_impl): with autograd recording and
an input that requires grad, every wrapper raises, on the CPU and on the
card alike.  Training runs the same convolutions through ``F.conv2d``
(``conv_impl='torch'`` on the models).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

LAUNCHES = {"conv3x3_mid": 0, "dncnn_fused": 0, "dncnn_head_fused": 0,
            "dncnn_head_mid": 0, "conv3x3_tail_residual": 0,
            "dncnn_head_slabzero": 0,
            "blur_valid": 0, "blur_dx": 0, "blur_dw": 0, "conv_w8a8": 0,
            "absmax_nhwc": 0, "resblock_conv": 0}
# copies a wrapper had to make of an input it was handed in another layout
COPIES = {"blur_cotangent": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "vt_conv3x3_mid": ("conv3x3_mid",
                       [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P]),
    "vt_snet_conv1": ("snet_levels", [_P] * 4 + [_I] * 5 + [_F, _P]),
    "vt_snet_last": ("snet_levels", [_P] * 8 + [_I] * 8 + [_F, _F, _P]),
    "vt_dncnn_head_conv1": ("dncnn_head", [_P] * 4 + [_I] * 4 + [_F, _P]),
    "vt_dncnn_head_mid": ("dncnn_head", [_P] * 4 + [_I] * 3 + [_F, _P]),
    "vt_dncnn_head_last": ("dncnn_head", [_P] * 8 + [_I] * 6 + [_F, _F, _P]),
    "vt_tail_residual": ("tail_residual", [_P] * 5 + [_I] * 7 + [_P]),
    "vt_blur_valid": ("blur", [_P] * 3 + [_I] * 5 + [_P]),
    "vt_blur_dx": ("blur", [_P] * 3 + [_I] * 5 + [_P]),
    "vt_blur_dw_scratch_elems": ("blur", [_I] * 5),
    "vt_blur_dw": ("blur", [_P] * 4 + [_I] * 5 + [_P]),
    "vt_absmax_nhwc": ("conv_w8a8", [_P, _P, ctypes.c_longlong, _I, _I,
                                     _P]),
    "vt_conv_w8a8_plan": ("conv_w8a8", [_I] * 4 + [ctypes.POINTER(_I)]),
    "vt_conv_w8a8": ("conv_w8a8", [_P] * 6 + [_I] * 7 + [_P]),
    "vt_resblock_conv": ("resblock_conv", [_P] * 5 + [_I] * 8 + [_P]),
}
_FNS: dict = {}


def reset_launches() -> None:
    for counts in (LAUNCHES, COPIES):
        for k in counts:
            counts[k] = 0


def _fn(symbol: str):
    fn = _FNS.get(symbol)
    if fn is None:
        lib, argtypes = _SIGNATURES[symbol]
        fn = getattr(_build.load(lib), symbol)
        fn.argtypes = argtypes
        fn.restype = (ctypes.c_longlong if symbol.endswith("_scratch_elems")
                      else ctypes.c_int)
        _FNS[symbol] = fn
    return fn


def _on_cpu(*ts) -> bool:
    """True when every tensor lies on the CPU; raises on a mix or on a
    device that is neither CPU nor CUDA."""
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in ts}) == 1:
        return False
    raise ValueError(f"tensors must all lie on the CPU or on one CUDA "
                     f"device, got {sorted(str(t.device) for t in ts)}")


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous (NHWC / HWIO)")


def _forward_only(name: str, *ts) -> None:
    """Raise when autograd would record through a kernel that has no
    backward: its output would carry no graph and the parameters behind
    it would silently get no gradient."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in ts):
        raise RuntimeError(
            f"{name} is forward-only (no backward kernel): run it under "
            f"torch.no_grad() / inference_mode(), or build the model with "
            f"conv_impl='torch' for training")


def _dtype_code(x: torch.Tensor) -> int:
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernels take float32 or bfloat16, got {x.dtype}")
    return _DTYPES[x.dtype]


def _ret(err: int, symbol: str) -> None:
    if err != 0:
        raise RuntimeError(f"{symbol} failed: cudaError {err}")


def _aligned(**ts) -> None:
    """Raise unless every tensor's data starts on a 16-byte boundary: the
    kernel copies it to shared memory by 16-byte asynchronous copies or
    writes it by 16-byte stores, which fault on a misaligned address."""
    for name, t in ts.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data must start 16-byte aligned (the "
                             f"kernel moves 16 bytes at a time); pass a "
                             f"fresh contiguous tensor, not an offset view")


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def _seq(ws):
    return [ws] if isinstance(ws, torch.Tensor) else list(ws)


def _stack(ws) -> torch.Tensor:
    return ws if isinstance(ws, torch.Tensor) else torch.stack(list(ws))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def conv3x3_f32(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """'same' 3x3 conv in f32 of NHWC x with HWIO w, + b; NHWC f32 out."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2).contiguous(),
                 w.float().permute(3, 2, 0, 1).contiguous(), b.float(),
                 padding=1)
    return y.permute(0, 2, 3, 1)


def conv3x3_plain(x, w, b, slope=None) -> torch.Tensor:
    """'same' 3x3 conv + bias (+ LeakyReLU), f32 accumulation, one rounding
    to x's dtype.  Also the port of the XLA-only pallas_conv helpers
    (conv3x3_in_pair, conv3x3_narrow_out, conv3x3_out_pair)."""
    y = conv3x3_f32(x, w, b)
    if slope is not None:
        y = F.leaky_relu(y, slope)
    return y.to(x.dtype).contiguous()


conv3x3_mid_plain = conv3x3_plain


def dncnn_fused_plain(x, w1, b1, wms, bms, wl, bl, slope=0.25):
    y = conv3x3_plain(x, w1, b1, slope)
    for wm, bm in zip(wms, bms):
        y = conv3x3_plain(y, wm, bm, slope)
    return conv3x3_plain(y, wl, bl)


def exp_clip(logits, lmin, lmax) -> torch.Tensor:
    """exp(clip(logits, lmin, lmax)) in float64.  float64 because
    PyTorch's CPU float32 exp was measured to lose up to 1.5e-4 relative
    precision in some processes (its vector-math path), which is above
    the sigma tolerances; rounded back, the result is exp to <= 1 ulp."""
    return torch.exp(torch.clamp(logits.double(), lmin, lmax))


def dncnn_head_fused_plain(x, w1, b1, wms, bms, wl, bl, wh, bh, slope=0.25,
                           lmin=-23.025850929940457, lmax=4.605170185988092):
    logits = dncnn_fused_plain(x, w1, b1, wms, bms, wl, bl, slope)
    sig = exp_clip(logits, lmin, lmax)
    ext = torch.sqrt(sig).to(x.dtype)
    head = conv3x3_plain(torch.cat([x, ext], dim=-1), wh, bh)
    return head, sig.to(x.dtype)


def _check_rows(h: int, rows: int) -> None:
    if rows < 1 or h % rows:
        raise ValueError(f"rows={rows} must divide the image height {h}")


def dncnn_head_slabzero_plain(x, w1, b1, wms, bms, wl, bl, wh, bh, rows=32,
                              slope=0.25, lmin=-23.025850929940457,
                              lmax=4.605170185988092):
    """K8's function: x shifted down one row under a row of zeros (the last
    row dropped), cut into (N*H/rows) slabs of ``rows`` rows, each through
    ``dncnn_head_fused_plain`` as an image of its own."""
    n, h, w, _ = x.shape
    _check_rows(h, rows)
    head, sig = dncnn_head_fused_plain(slab_rows_up(x, rows), w1, b1, wms,
                                       bms, wl, bl, wh, bh, slope, lmin, lmax)
    return head.reshape(n, h, w, -1), sig.reshape(n, h, w, -1)


def slab_rows_up(x, rows) -> torch.Tensor:
    """What K8 computes on, and its kernels read in place: x shifted down
    one row under a row of zeros (the last row dropped), as (N*H/rows,
    rows, W, C) slabs; row 0 of every image's first slab is zero."""
    n, h, w, c = x.shape
    return F.pad(x, (0, 0, 0, 0, 1, 0))[:, :h].reshape(n * h // rows, rows,
                                                       w, c)


def conv3x3_tail_residual_plain(feats, x_in, w, b):
    h, w_img = x_in.shape[1], x_in.shape[2]
    y = conv3x3_plain(feats, w, b)[:, :h, :w_img]
    return (y.float() + x_in.float()).to(x_in.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def conv3x3_mid(x, w, b, slope=None) -> torch.Tensor:
    """K1: x (N, H, W, 64), w HWIO (3, 3, 64, 64), b (64,) -> (N, H, W,
    64), all in x's dtype.  On the card x and w must be contiguous and
    start 16-byte aligned; any N, H, W >= 1."""
    _forward_only("conv3x3_mid", x, w, b)
    if _on_cpu(x, w, b):
        return conv3x3_mid_plain(x, w, b, slope)
    n, h, wd, c = x.shape
    if c != 64:
        raise ValueError(f"conv3x3_mid takes 64 channels, got {c}")
    code = _dtype_code(x)
    _check(x, "x", x.dtype, (n, h, wd, 64))
    _check(w, "w", x.dtype, (3, 3, 64, 64))
    _check(b, "b", x.dtype, (64,))
    y = torch.empty_like(x)
    _aligned(x=x, w=w, y=y)
    _ret(_fn("vt_conv3x3_mid")(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), n, h, wd,
        code, float(slope or 0.0), int(slope is not None), _stream(x)),
        "vt_conv3x3_mid")
    LAUNCHES["conv3x3_mid"] += 1
    return y


def conv3x3_mid_stack(x, wms, bms, slope=None) -> torch.Tensor:
    """L chained K1 convs (counterpart of conv3x3_mid_stack_pair): one
    launch per conv; fusing the stack is later work."""
    for w, b in zip(wms, bms):
        x = conv3x3_mid(x, w, b, slope)
    return x


def dncnn_head_mid(x, w, b, slope=0.25) -> torch.Tensor:
    """One mid level of K3 and K8 in bf16: lrelu(conv3x3(x, w) + b, slope)
    with f32 sums and one rounding, x (N, H, W, 64), w HWIO (3, 3, 64,
    64), b (64,) -> (N, H, W, 64).  On the card every tensor is bfloat16
    and contiguous, x and w start 16-byte aligned; any N, H, W >= 1
    (csrc/dncnn_head.cu's wgmma kernel)."""
    _forward_only("dncnn_head_mid", x, w, b)
    if _on_cpu(x, w, b):
        return conv3x3_plain(x, w, b, slope)
    n, h, wd, _ = x.shape
    bf = torch.bfloat16
    _check(x, "x", bf, (n, h, wd, 64))
    _check(w, "w", bf, (3, 3, 64, 64))
    _check(b, "b", bf, (64,))
    y = torch.empty_like(x)
    _aligned(x=x, w=w, y=y)
    _ret(_fn("vt_dncnn_head_mid")(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), n, h, wd,
        float(slope), _stream(x)), "vt_dncnn_head_mid")
    LAUNCHES["dncnn_head_mid"] += 1
    return y


def _dncnn_launch(head: bool, x, w1, b1, wms, bms, wl, bl, wh, bh, slope,
                  lmin, lmax, rows=None):
    """Check and launch K2 (``head`` False), K3, or with ``rows`` K8: the
    SNet level by level, conv1 into a 64-channel level map, one launch per
    mid level, then the last level: the logits (``head`` False), or sigma
    and the head conv on [x | sqrt(sigma)].  K3 and K8 in bf16 (``head``
    and bf16) launch csrc/dncnn_head.cu's kernels, the mids on
    ``dncnn_head_mid``; K2, and K3 and K8 in fp32, launch
    csrc/snet_levels.cu's snet_conv1 and snet_last with K1 for the mids
    (counted under ``conv3x3_mid``).  K8 runs the chain on the view of x
    cut into slabs of ``rows`` rows (``xs`` slabs per image), conv1 and
    the last level reading x one row up; its outputs are x's shape.  Level
    maps are ``torch.empty`` on x's device; every launch goes on its
    current stream."""
    n, h, wd, ci = x.shape
    dt = x.dtype
    code = _dtype_code(x)
    wm = _stack(wms)
    bm = _stack(bms)
    L = wm.shape[0]
    co = wl.shape[3]
    _check(x, "x", dt, (n, h, wd, 3))
    _check(w1, "w1", dt, (3, 3, 3, 64))
    _check(b1, "b1", dt, (64,))
    _check(wm, "wms", dt, (L, 3, 3, 64, 64))
    _check(bm, "bms", dt, (L, 64))
    if co not in (1, 2, 3):
        raise ValueError(f"conv_last must have 1-3 outputs, got {co}")
    _check(wl, "wl", dt, (3, 3, 64, co))
    _check(bl, "bl", dt, (co,))
    if L < 1:
        raise ValueError("the fused SNet needs at least one mid conv")
    cf = 0
    if head:
        cf = wh.shape[3]
        if cf % 16 or cf > 256:
            raise ValueError(f"head width must be a multiple of 16 up to "
                             f"256, got {cf}")
        _check(wh, "wh", dt, (3, 3, 3 + co, cf))
        _check(bh, "bh", dt, (cf,))
    _aligned(wms=wm)
    xs = 0
    if rows is not None:           # K8: the slab view
        xs = h // rows
        n, h = n * xs, rows
    ours = head and dt == torch.bfloat16
    st = _stream(x)
    y = torch.empty((n, h, wd, 64), dtype=dt, device=x.device)
    if ours:
        _ret(_fn("vt_dncnn_head_conv1")(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), y.data_ptr(), n, h,
            wd, xs, float(slope), st), "vt_dncnn_head_conv1")
    else:
        _ret(_fn("vt_snet_conv1")(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), y.data_ptr(), n, h,
            wd, xs, code, float(slope), st), "vt_snet_conv1")
    mid = dncnn_head_mid if ours else conv3x3_mid
    for w, b in zip(wm, bm):
        y = mid(y, w, b, slope)
    out0 = torch.empty((*x.shape[:3], cf if head else co), dtype=dt,
                       device=x.device)
    out1 = (torch.empty((*x.shape[:3], co), dtype=dt, device=x.device)
            if head else None)
    if ours:
        _ret(_fn("vt_dncnn_head_last")(
            y.data_ptr(), x.data_ptr(), wl.data_ptr(), bl.data_ptr(),
            wh.data_ptr(), bh.data_ptr(), out0.data_ptr(), out1.data_ptr(),
            n, h, wd, co, cf, xs, float(lmin), float(lmax), st),
            "vt_dncnn_head_last")
    else:
        _ret(_fn("vt_snet_last")(
            y.data_ptr(), x.data_ptr(), wl.data_ptr(), bl.data_ptr(),
            wh.data_ptr() if head else None, bh.data_ptr() if head else None,
            out0.data_ptr(), out1.data_ptr() if head else None, n, h, wd,
            co, cf, int(head), xs, code, float(lmin), float(lmax), st),
            "vt_snet_last")
    return out0, out1


def dncnn_fused(x, w1, b1, wms, bms, wl, bl, slope=0.25) -> torch.Tensor:
    """K2, the whole SNet: x (N, H, W, 3) -> logits (N, H, W, co), any H
    and W.  wms/bms: list of HWIO (3, 3, 64, 64) / (64,) or the stacked
    (L, ...) tensors.  On the card the level chain of csrc/snet_levels.cu
    with K1 for the mids (the stacked mid weights must start 16-byte
    aligned)."""
    _forward_only("dncnn_fused", x, w1, b1, *_seq(wms), *_seq(bms), wl, bl)
    if _on_cpu(x, w1, b1, wl, bl):
        return dncnn_fused_plain(x, w1, b1, wms, bms, wl, bl, slope)
    out, _ = _dncnn_launch(False, x, w1, b1, wms, bms, wl, bl, None, None,
                           slope, 0.0, 0.0)
    LAUNCHES["dncnn_fused"] += 1
    return out


def dncnn_head_fused(x, w1, b1, wms, bms, wl, bl, wh, bh, slope=0.25,
                     lmin=-23.025850929940457, lmax=4.605170185988092):
    """K3, SNet + sigma epilogue + RNet head conv: x (N, H, W, 3) ->
    (head (N, H, W, cf), sigma (N, H, W, co)).  sigma = exp(clip(logits,
    lmin, lmax)); head = conv3x3([x | sqrt(sigma)], wh) + bh with
    sqrt(sigma) zero outside the image.  On the card the level chain
    (``_dncnn_launch``), 2 + L launches: in bf16 csrc/dncnn_head.cu's conv1,
    L ``dncnn_head_mid`` and last level; in fp32 csrc/snet_levels.cu's
    snet_conv1 and snet_last with K1 for the mids.  The stacked mid
    weights must start 16-byte aligned.  One ``dncnn_head_fused`` count a
    call, and in bf16 one ``dncnn_head_mid`` count a mid level."""
    _forward_only("dncnn_head_fused", x, w1, b1, *_seq(wms), *_seq(bms), wl,
                  bl, wh, bh)
    if _on_cpu(x, w1, b1, wl, bl, wh, bh):
        return dncnn_head_fused_plain(x, w1, b1, wms, bms, wl, bl, wh, bh,
                                      slope, lmin, lmax)
    head, sigma = _dncnn_launch(True, x, w1, b1, wms, bms, wl, bl, wh, bh,
                                slope, lmin, lmax)
    LAUNCHES["dncnn_head_fused"] += 1
    return head, sigma


def dncnn_head_slabzero(x, w1, b1, wms, bms, wl, bl, wh, bh, rows=32,
                        slope=0.25, lmin=-23.025850929940457,
                        lmax=4.605170185988092):
    """K8, a speed probe only: K3's function with every ``rows``-row slab
    of the image treated as an image of its own.  Slab t reads image rows
    [t*rows - 1, t*rows + rows - 1) (row -1 is zeros) and writes output
    rows [t*rows, (t+1)*rows).  The result is therefore WRONG within L+2
    rows of every slab edge and shifted down one row against the true
    prologue (as the JAX package's mode='slabzero' is); farther inside a
    slab it equals K3's output one row up.  Never routed by ``VIRNet``,
    ``Restorer`` or any command line but the probe's
    (cli/bench_fused_head).  ``rows`` must divide H; there is no automatic
    slab size.

    On the card it runs K3's own level chain on the view of x cut into
    slabs, with x read one row up (no shifted copy is made): conv1 and the
    last level read x in place, the level maps and the mids see slab edges
    as image edges, and nothing is recomputed, as for K3 (bf16: the
    kernels of csrc/dncnn_head.cu, mids under ``dncnn_head_mid``; fp32:
    snet_conv1, K1 per mid level under ``conv3x3_mid``, snet_last)."""
    _forward_only("dncnn_head_slabzero", x, w1, b1, *_seq(wms), *_seq(bms),
                  wl, bl, wh, bh)
    _check_rows(x.shape[1], rows)
    if _on_cpu(x, w1, b1, wl, bl, wh, bh):
        return dncnn_head_slabzero_plain(x, w1, b1, wms, bms, wl, bl, wh, bh,
                                         rows, slope, lmin, lmax)
    head, sigma = _dncnn_launch(True, x, w1, b1, wms, bms, wl, bl, wh, bh,
                                slope, lmin, lmax, rows=int(rows))
    LAUNCHES["dncnn_head_slabzero"] += 1
    return head, sigma


def conv3x3_tail_residual(feats, x_in, w, b) -> torch.Tensor:
    """K4: conv3x3(feats, w) + b, rounded to feats' dtype, then + x_in in
    f32.  feats (N, Hp, Wp, C) at the padded size, x_in (N, h, w, 3) f32
    with h <= Hp, w <= Wp -> (N, h, w, 3) f32.  On the card C is a
    multiple of 4 up to 256 (any odd width), and feats must start 16-byte
    aligned."""
    _forward_only("conv3x3_tail_residual", feats, x_in, w, b)
    if _on_cpu(feats, x_in, w, b):
        return conv3x3_tail_residual_plain(feats, x_in, w, b)
    n, hp, wp, c = feats.shape
    h, w_img = x_in.shape[1], x_in.shape[2]
    code = _dtype_code(feats)
    if c < 4 or c % 4 or c > 256 or h > hp or w_img > wp:
        raise ValueError(f"tail: features {tuple(feats.shape)} and x_in "
                         f"{tuple(x_in.shape)} do not fit the kernel")
    _check(feats, "feats", feats.dtype, (n, hp, wp, c))
    _check(x_in, "x_in", torch.float32, (n, h, w_img, 3))
    _check(w, "w", feats.dtype, (3, 3, c, 3))
    _check(b, "b", feats.dtype, (3,))
    out = torch.empty_like(x_in)
    _aligned(feats=feats, out=out)
    _ret(_fn("vt_tail_residual")(
        feats.data_ptr(), x_in.data_ptr(), w.data_ptr(), b.data_ptr(),
        out.data_ptr(), n, hp, wp, h, w_img, c, code, _stream(feats)),
        "vt_tail_residual")
    LAUNCHES["conv3x3_tail_residual"] += 1
    return out
