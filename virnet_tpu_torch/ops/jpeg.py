"""JPEG degradation as tensor ops: block-DCT quantization on the device
(counterpart of virnet_tpu/ops/jpeg.py).

The reference applies real libjpeg round trips as a SISR training noise
type (utils/util_image.py:236-257, used datasets/SISRDatasets.py:102-114).
This module is the lossy core of baseline JPEG in PyTorch: RGB->YCbCr,
4:2:0 chroma subsampling, 8x8 block DCT, quantization against the libjpeg
quality-scaled standard tables, then the decode half (dequantization,
IDCT, fancy chroma upsampling, YCbCr->RGB), so the JPEG noise branch runs
inside the training step with a per-sample quality factor.  It is a float
approximation of libjpeg, not a bit replica (its integer DCT, rounding
biases and entropy coding are not modeled); the host path
(``ops/color.jpeg_compress``) is the exact-semantics option.

Numerics.  The two 8x8 DCT products of each block are written out as
ordered float32 multiply-adds over the eight taps (``_dct_rows``), not as
a matmul: a matmul on the card would run in TF32 whenever a caller has
switched ``allow_tf32`` on, and TF32 moves many coefficients across a
quantization bin.  A division by a constant other than a power of two is
a division of two tensors (``_divide``).  Elementwise float32 products,
sums and quotients give the same bits on the CPU and on the card whatever
the process flags say.  The
rounding rules are JAX's: ``torch.round`` rounds half to even like
``jnp.round``, the table scale ``5000 / q`` is floored (libjpeg's integer
division), the MCU pad replicates the edge and the fancy upsample clamps
at the edges.  Where a coefficient over its table entry lies exactly on
k + 0.5, two correct float32 sums may round to different bins; that
moves one 8x8 luma block or one 16x16 chroma MCU by a quantization step.
Where a decoded value lies on k + 0.5, its pixel may land one level
apart.  Those ties are the only way this module and the JAX one part.

JPEG algorithm constants follow ITU-T T.81 (the standard quantization
tables, Annex K) and libjpeg's ``jpeg_quality_scaling``.
"""

from __future__ import annotations

import numpy as np
import torch

# ITU-T T.81 Annex K base quantization tables (row-major 8x8)
_LUMA_Q = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], dtype=np.float32)

_CHROMA_Q = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
], dtype=np.float32)


def _dct_matrix() -> np.ndarray:
    """Orthonormal 8-point DCT-II matrix (D @ x == DCT(x)), float32."""
    k = np.arange(8)[:, None]
    n = np.arange(8)[None, :]
    d = np.cos((2 * n + 1) * k * np.pi / 16) * np.sqrt(2.0 / 8.0)
    d[0] /= np.sqrt(2.0)
    return d.astype(np.float32)


_DCT = _dct_matrix()
_CONSTS = {"dct": _DCT, "dct_t": np.ascontiguousarray(_DCT.T),
           "luma": _LUMA_Q, "chroma": _CHROMA_Q}
_DEVICE_CONSTS: dict = {}


def _const(name: str, device) -> torch.Tensor:
    """A float32 constant of this module on ``device``, copied there once:
    a copy from pageable host memory on every call would make the host
    wait for the card each time."""
    key = (name, torch.device(device))
    t = _DEVICE_CONSTS.get(key)
    if t is None:
        t = _DEVICE_CONSTS[key] = torch.from_numpy(_CONSTS[name]).to(device)
    return t


def _divide(a, b):
    """a / b in IEEE float32 division, a or b a Python number: PyTorch
    computes ``t / 2.5`` on the card as ``t * (1 / 2.5)`` and ``2.5 / t``
    as ``reciprocal(t) * 2.5``, each a rounding away from the quotient;
    dividing two tensors gives the quotient on every device."""
    if not torch.is_tensor(a):
        a = torch.full_like(b, a)
    if not torch.is_tensor(b):
        b = torch.full_like(a, b)
    return a / b


def quality_tables(quality, device=None):
    """libjpeg ``jpeg_quality_scaling`` + table build.  ``quality``: a
    scalar or an (N,) tensor in [1, 100].  Returns (luma, chroma) float32
    tables shaped like quality + (8, 8)."""
    q = torch.as_tensor(quality, dtype=torch.float32, device=device)
    q = q.clamp(1.0, 100.0)
    # libjpeg computes 5000 / quality in integer arithmetic: floor it
    scale = torch.where(q < 50.0, torch.floor(_divide(5000.0, q)),
                        200.0 - 2.0 * q)
    scale = scale[..., None, None]

    def build(base):
        t = torch.floor(_divide(_const(base, q.device) * scale + 50.0,
                                100.0))
        return t.clamp(1.0, 255.0)

    return build("luma"), build("chroma")


def _rgb_to_ycc(rgb):
    """JPEG full-range BT.601 RGB->YCbCr on [0, 255] values."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168735892 * r - 0.331264108 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418687589 * g - 0.081312411 * b
    return y, cb, cr


def _ycc_to_rgb(y, cb, cr):
    cb = cb - 128.0
    cr = cr - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136286 * cb - 0.714136286 * cr
    b = y + 1.772 * cb
    return torch.stack([r, g, b], dim=-1)


def _pad_to(x, mult):
    """Edge-replicate pad the trailing two dims to a multiple of ``mult``."""
    ph, pw = (-x.shape[-2]) % mult, (-x.shape[-1]) % mult
    if ph == 0 and pw == 0:
        return x
    x = torch.cat([x, x[..., -1:, :].expand(*x.shape[:-2], ph, x.shape[-1])],
                  dim=-2)
    return torch.cat([x, x[..., -1:].expand(*x.shape[:-1], pw)], dim=-1)


def _blockify(plane):
    """(..., H, W) -> (..., H//8, W//8, 8, 8)."""
    *lead, h, w = plane.shape
    return plane.reshape(*lead, h // 8, 8, w // 8, 8).transpose(-3, -2)


def _unblockify(blocks):
    *lead, nh, nw, _, _ = blocks.shape
    return blocks.transpose(-3, -2).reshape(*lead, nh * 8, nw * 8)


def _dct_rows(m, x):
    """out[..., i, k] = sum_j m[i, j] * x[..., j, k], as eight float32
    multiply-adds in the order j = 0..7 (no matmul: see the module
    docstring).  ``m`` is an (8, 8) float32 tensor."""
    out = m[:, 0, None] * x[..., 0, None, :]
    for j in range(1, 8):
        out = out + m[:, j, None] * x[..., j, None, :]
    return out


def _coefficients(plane):
    """The DCT coefficients of each 8x8 block of a (..., H, W) plane:
    D @ block @ D^T, (..., H//8, W//8, 8, 8)."""
    d = _const("dct", plane.device)
    t = _dct_rows(d, _blockify(plane - 128.0))           # D @ x
    return _dct_rows(d, t.transpose(-2, -1)).transpose(-2, -1)  # (.) @ D^T


def _expand_table(table):
    # per-sample (N, 8, 8) tables against blocks (N, nh, nw, 8, 8)
    return table[..., None, None, :, :] if table.dim() > 2 else table


def _quantize_plane(plane, table):
    """DCT -> quantize -> dequantize -> IDCT of one (..., H, W) plane."""
    d = _const("dct_t", plane.device)
    table = _expand_table(table)
    coef = torch.round(_coefficients(plane) / table) * table
    t = _dct_rows(d, coef)                                # D^T @ c
    out = _dct_rows(d, t.transpose(-2, -1)).transpose(-2, -1)  # (.) @ D
    return _unblockify(out) + 128.0


def _downsample_420(plane):
    """2x2 box average over the trailing two dims (libjpeg h2v2 encode)."""
    *lead, h, w = plane.shape
    return plane.reshape(*lead, h // 2, 2, w // 2, 2).mean(dim=(-3, -1))


def _upsample_fancy_1d(x, dim):
    """libjpeg h2v2 fancy upsampling along one dim (triangle filter):
    out[2i] = (3 x[i] + x[i-1]) / 4, out[2i+1] = (3 x[i] + x[i+1]) / 4,
    edges clamped."""
    x = x.movedim(dim, -1)
    prev = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    nxt = torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
    even = (3.0 * x + prev) / 4.0
    odd = (3.0 * x + nxt) / 4.0
    out = torch.stack([even, odd], dim=-1).reshape(*x.shape[:-1],
                                                   x.shape[-1] * 2)
    return out.movedim(-1, dim)


def _upsample_420(plane):
    return _upsample_fancy_1d(_upsample_fancy_1d(plane, -1), -2)


def _planes(x, subsample):
    """The uint8-rounded luma plane of ``x`` and its two chroma planes
    stacked on a new leading dim (Cb, Cr share the chroma table, so they
    go through the codec together), edge-padded to whole MCUs, chroma
    2x2-averaged (and rounded) under 4:2:0."""
    u8 = torch.round(x.float().clamp(0.0, 1.0) * 255.0)
    # libjpeg stores Y/Cb/Cr samples as uint8 rows before the DCT
    mcu = 16 if subsample else 8
    y, cb, cr = _rgb_to_ycc(u8)
    y = _pad_to(torch.round(y), mcu)
    c = _pad_to(torch.round(torch.stack([cb, cr])), mcu)
    if subsample:
        c = torch.round(_downsample_420(c))
    return y, c


def _decoded(x, quality, subsample):
    """The decoded RGB of the round trip before its final rounding, on
    [0, 255] (float32, x's shape)."""
    h, w = x.shape[-3], x.shape[-2]
    luma_t, chroma_t = quality_tables(quality, x.device)
    y, c = _planes(x, subsample)
    y = _quantize_plane(y, luma_t)
    c = _quantize_plane(c, chroma_t)
    if subsample:
        c = _upsample_420(c)
    c = c[..., :h, :w]
    return _ycc_to_rgb(y[..., :h, :w], c[0], c[1])


@torch.no_grad()
def jpeg_degrade(x: torch.Tensor, quality, subsample: bool = True
                 ) -> torch.Tensor:
    """JPEG round-trip degradation of float RGB images, on ``x``'s device.

    x: (..., H, W, 3) float in [0, 1] (any leading batch dims).
    quality: a scalar or a per-sample tensor broadcastable to the leading
        dims (e.g. (N,) for x of (N, H, W, 3)), in [1, 100].
    subsample: 4:2:0 chroma subsampling (the cv2/libjpeg default); False
        gives 4:4:4.

    Returns float32 images of x's shape on the uint8 grid / 255, as the
    reference's uint8 round trip (utils/util_image.py:245-257) does."""
    rgb = _decoded(x, quality, subsample)
    # the decoder writes uint8 samples: land on the uint8 grid
    return _divide(torch.round(rgb.clamp(0.0, 255.0)), 255.0)


@torch.no_grad()
def _rounded_values(x: torch.Tensor, quality, subsample: bool = True):
    """The values ``jpeg_degrade`` rounds, in float64: coef / table of
    each block of the luma plane ((..., H//8, W//8, 8, 8) over the padded
    plane) and of the chroma planes ((2, ...) likewise: Cb, Cr), and the
    decoded RGB before its final rounding (x's shape)."""
    luma_t, chroma_t = quality_tables(quality, x.device)
    d = _const("dct", x.device).double()
    ratios = tuple(
        d @ _blockify(plane.double() - 128.0) @ d.T
        / _expand_table(table).double()
        for plane, table in zip(_planes(x, subsample), (luma_t, chroma_t)))
    return ratios, _decoded(x, quality, subsample).double()


def _ties(x: torch.Tensor, quality, subsample: bool = True):
    """Where two correct float32 evaluations of ``jpeg_degrade(x,
    quality)`` may part (module docstring), for x of (N, H, W, 3): per
    pixel (N, H, W), whether its 8x8 luma block, or a chroma MCU whose
    samples its upsampled chroma reads, holds a coefficient whose coef /
    table is within 1e-3 of k + 0.5; per value (N, H, W, 3), whether its
    decoded value is within 1e-3 of k + 0.5."""
    h, w = x.shape[1:3]
    ratios, decoded = _rounded_values(x, quality, subsample)

    def on_half(v):
        return (v - torch.floor(v) - 0.5).abs() < 1e-3

    def to_px(blocks, rep):
        return blocks.repeat_interleave(rep, 1).repeat_interleave(
            rep, 2)[:, :h, :w]

    def tie_blocks(r):
        return on_half(r).flatten(-2).any(-1)

    chroma = tie_blocks(ratios[1]).any(0)                 # Cb or Cr
    if subsample:
        # the fancy upsample reads the chroma samples one step around
        samples = chroma.float().repeat_interleave(8, 1).repeat_interleave(
            8, 2)
        chroma = to_px(torch.nn.functional.max_pool2d(
            samples[:, None], 3, 1, 1)[:, 0].bool(), 2)
    else:
        chroma = to_px(chroma, 8)
    return to_px(tie_blocks(ratios[0]), 8) | chroma, on_half(decoded)


def _untied(x: torch.Tensor, quality, a: torch.Tensor, b: torch.Tensor,
            subsample: bool = True) -> torch.Tensor:
    """The pixels (N, H, W) where two outputs ``a`` and ``b`` of
    ``jpeg_degrade(x, quality)`` differ without a tie to explain it: not
    in a tie block of ``_ties``, and not one level apart only in channels
    whose decoded value is a tie."""
    blocks, values = _ties(x, quality, subsample)
    levels = (a.double() - b.double()).abs() * 255
    one_level = ((levels < 0.5)
                 | (((levels - 1).abs() < 1e-3) & values)).all(-1)
    return (a != b).any(-1) & ~blocks & ~one_level
