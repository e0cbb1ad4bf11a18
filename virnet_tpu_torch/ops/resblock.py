"""K11 ``resblock_conv``: one 3x3 convolution of an unconditioned RNet
AttResBlock with the block's elementwise passes inside, beside its plain
PyTorch version.

  K11 ``resblock_conv`` <- no Pallas kernel: the JAX package runs RNet's
                           body convolutions through XLA, which fuses the
                           bias, LeakyReLU and residual passes into them;
                           K11 is the hand-written bf16 wgmma convolution
                           of csrc/resblock_conv.cu that does the same

An unconditioned block, ``x + conv2(lrelu(conv1(lrelu(x))))`` with
LeakyReLU(0.2) (models/attresunet.py; ``SLOPE``), is two calls:

  * ``mode='first'``:  ``lrelu(conv(lrelu(x), W1) + b1)``;
  * ``mode='second'``: ``residual + conv(y, W2) + b2``.

Each sums in float32 and rounds once to x's dtype; the LeakyReLU of the
input is taken in x's dtype first, as ``F.leaky_relu`` gives it.  Today's
cuDNN route rounds after the conv, the bias, each LeakyReLU and the
residual; the function is the same.

The kernel reads its weights laid out by ``kernel_weights`` (the B
operand of each split and chunk of 16 input channels contiguous): the
model caches that copy (models/common.kernel_layout).  The output channels
are cut into ``plan(ci, co)`` splits of N, a width the kernel was built
for.  A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches K11 or raises.  Forward-only, like every kernel of
ops/fused_conv.py.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .fused_conv import (LAUNCHES, _aligned, _check, _fn, _forward_only,
                         _on_cpu, _ret, _stream, conv3x3_f32)

SLOPE = 0.2                  # the blocks' LeakyReLU, fixed in the kernel
KC = 16                      # input channels a step of the kernel
WIDTHS = (112, 96, 80, 64)   # the N a block may take (the kernel's builds)
MODES = ("first", "second")


@functools.lru_cache(maxsize=None)
def plan(ci: int, co: int):
    """(N, splits): how K11 cuts ``co`` output channels, the width of
    ``WIDTHS`` that computes the fewest padded channels, then the one of
    fewest splits (96 -> 96, 160 -> 2 x 80, 192 -> 2 x 96, 224 -> 2 x
    112, 288 -> 3 x 96); None where K11 does not take the widths (both
    positive multiples of 16)."""
    if not all(c % KC == 0 and c >= KC for c in (ci, co)):
        return None
    n = min(WIDTHS, key=lambda w: (-(-co // w) * w, -(-co // w)))
    return n, -(-co // n)


def _plan_of(ci: int, co: int):
    p = plan(ci, co)
    if p is None:
        raise ValueError(f"K11 takes widths that are positive multiples of "
                         f"{KC}, got {ci} -> {co}")
    return p


def kernel_weights(w: torch.Tensor) -> torch.Tensor:
    """What K11 reads of HWIO ``w`` (3, 3, Ci, Co): (splits, Ci / 16, 9, 2,
    N, 8), element [s, c, t, h, n, e] = w[t // 3, t % 3, 16c + 8h + e, sN +
    n] (zeros past Co): each split's weights of a chunk of 16 input
    channels, the 9 taps' B operands, contiguous.  A weight-sized copy."""
    kh, kw, ci, co = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"K11 takes 3x3 kernels, got {kh}x{kw}")
    n, splits = _plan_of(ci, co)
    wp = F.pad(w, (0, splits * n - co))
    return wp.reshape(9, ci // KC, 2, 8, splits, n).permute(
        4, 1, 0, 2, 5, 3).contiguous()


def hwio_weights(wk: torch.Tensor, co: int) -> torch.Tensor:
    """HWIO (3, 3, Ci, co) back from ``kernel_weights``' layout."""
    splits, chunks, _, _, n, _ = wk.shape
    w = wk.permute(2, 1, 3, 5, 0, 4).reshape(3, 3, chunks * KC, splits * n)
    return w[..., :co]


def _second(mode: str) -> bool:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    return mode == "second"


def resblock_conv_plain(x, w, b, mode, residual=None):
    """K11's function: x NHWC (N, H, W, Ci), w HWIO (3, 3, Ci, Co), b
    (Co,); 'first' ``lrelu(conv(lrelu(x)) + b)``, 'second' ``residual +
    conv(x) + b`` with ``residual`` (N, H, W, Co); float32 sums, one
    rounding to x's dtype."""
    second = _second(mode)
    y = conv3x3_f32(x if second else F.leaky_relu(x, SLOPE), w, b)
    y = y + residual.float() if second else F.leaky_relu(y, SLOPE)
    return y.to(x.dtype).contiguous()


def resblock_conv(x, wk, b, mode, residual=None):
    """K11: ``resblock_conv_plain``'s function with the weights laid out
    by ``kernel_weights``.  On the card every tensor is bfloat16 and
    contiguous, x and wk start 16-byte aligned, and the widths are ones
    ``plan`` takes; any N, H, W >= 1."""
    second = _second(mode)
    if second and residual is None:
        raise ValueError("mode 'second' adds the block's input: pass "
                         "residual")
    ts = (x, wk, b) + ((residual,) if second else ())
    _forward_only("resblock_conv", *ts)
    co = b.shape[0]
    if _on_cpu(*ts):
        return resblock_conv_plain(x, hwio_weights(wk, co), b, mode,
                                   residual)
    nb, h, w, ci = x.shape
    n, splits = _plan_of(ci, co)
    bf = torch.bfloat16
    _check(x, "x", bf, (nb, h, w, ci))
    _check(wk, "wk", bf, (splits, ci // KC, 9, 2, n, 8))
    _check(b, "b", bf, (co,))
    if second:
        _check(residual, "residual", bf, (nb, h, w, co))
    y = torch.empty((nb, h, w, co), dtype=bf, device=x.device)
    _aligned(x=x, wk=wk)
    _ret(_fn("vt_resblock_conv")(
        x.data_ptr(), wk.data_ptr(), b.data_ptr(),
        residual.data_ptr() if second else None, y.data_ptr(), nb, h, w, ci,
        co, int(second), n, splits, _stream(x)),
        "vt_resblock_conv")
    LAUNCHES["resblock_conv"] += 1
    return y
