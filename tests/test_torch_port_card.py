"""The CUDA kernels against their plain PyTorch versions on the card, at
small odd shapes, for both presets' SNet shapes (syn: L=3, co=1; real:
L=6, co=3), in fp32 with TF32 off and in bf16.  Skips without a CUDA
device.  Imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_port_card.py -q
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from virnet_tpu_torch.ops import fused_conv as fc


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _snet(rng, L, co, cf):
    return dict(w1=_rand(rng, (3, 3, 3, 64), 0.2), b1=_rand(rng, (64,), 0.05),
                wms=[_rand(rng, (3, 3, 64, 64), 0.04) for _ in range(L)],
                bms=[_rand(rng, (64,), 0.05) for _ in range(L)],
                wl=_rand(rng, (3, 3, 64, co), 0.04),
                bl=_rand(rng, (co,), 0.05),
                wh=_rand(rng, (3, 3, 3 + co, cf), 0.1),
                bh=_rand(rng, (cf,), 0.05))


def _close(got, want, dtype, sigma=False):
    """fp32: atol 1e-4 (rtol 1e-5 for sigma), the same function with only
    the summation order changed.  bf16: both sides round each conv once
    to bf16, so a 1-ulp flip can carry through later levels; 4 bf16 ulps
    (2^-6) of the tensor's scale (of log sigma for sigma), where a wrong
    tap moves outputs by a large part of their scale."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        if sigma:
            torch.testing.assert_close(got, want, atol=0, rtol=1e-5)
        else:
            torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
        return
    if sigma:
        got, want = torch.log(got), torch.log(want)
    tol = 2 ** -6 * max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("L,co", [(3, 1), (6, 3)], ids=["syn", "real"])
def test_kernels_match_plain_on_card(L, co, dtype):
    """K1-K4 against their plain versions on the card (K8 has its own
    test below)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from virnet_tpu_torch.precision import set_parity_mode

    set_parity_mode()
    rng = np.random.default_rng(8)
    dev = "cuda"
    p = _snet(rng, L, co, cf=96)
    keys = ("w1", "b1", "wms", "bms", "wl", "bl")
    g = {k: (torch.stack([_t(w) for w in v]) if isinstance(v, list)
             else _t(v)).to(dev, dtype) for k, v in p.items()}
    x = _t(rng.random((2, 37, 45, 3), dtype=np.float32)).to(dev, dtype)
    args = [g[k] for k in keys]
    _close(fc.dncnn_fused(x, *args), fc.dncnn_fused_plain(x, *args), dtype)
    xh = x[:, :32, :40].contiguous()
    h, s = fc.dncnn_head_fused(xh, *args, g["wh"], g["bh"])
    h_ref, s_ref = fc.dncnn_head_fused_plain(xh, *args, g["wh"], g["bh"])
    _close(h, h_ref, dtype)
    _close(s, s_ref, dtype, sigma=True)
    xm = _t(_rand(rng, (1, 19, 23, 64))).to(dev, dtype)
    _close(fc.conv3x3_mid(xm, g["wms"][0], g["bms"][0], 0.25),
           fc.conv3x3_mid_plain(xm, g["wms"][0], g["bms"][0], 0.25), dtype)
    feats = _t(_rand(rng, (1, 24, 28, 96))).to(dev, dtype)
    x_in = _t(rng.random((1, 21, 26, 3), dtype=np.float32)).to(dev)
    wt = _t(_rand(rng, (3, 3, 96, 3), 0.05)).to(dev, dtype)
    bt = _t(_rand(rng, (3,), 0.1)).to(dev, dtype)
    _close(fc.conv3x3_tail_residual(feats, x_in, wt, bt),
           fc.conv3x3_tail_residual_plain(feats, x_in, wt, bt), dtype)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("L,co,shape,rows", [
    (3, 1, (2, 32, 40, 3), 16),     # syn, two slabs per image
    (3, 1, (1, 24, 37, 3), 8),      # odd width, H no multiple of 32
    (6, 3, (2, 32, 24, 3), 32),     # real, one slab per image
    (6, 3, (1, 12, 20, 3), 4),      # slabs shorter than L + 2
    (3, 1, (2, 128, 48, 3), 64),    # tiles of 32 rows: an inner tile edge
    (6, 3, (1, 96, 50, 3), 48),     # rows > 32 and W no multiple of 24
], ids=["syn-r16", "syn-odd-r8", "real-r32", "real-r4", "syn-r64",
        "real-r48-w50"])
def test_slabzero_kernel_matches_plain_on_card(L, co, shape, rows, dtype):
    """K8 against its plain version on the card, to K3's tolerances (bf16:
    csrc/dncnn_head.cu on the slab view, tiles of min(rows, 32) x 24; fp32:
    the level chain); one K8 count per call, and in fp32 one K1 launch per
    mid level; rows far from slab edges equal K3 one row up."""
    _need_card()
    from virnet_tpu_torch.precision import set_parity_mode

    set_parity_mode()
    rng = np.random.default_rng(11)
    p = _snet(rng, L, co, cf=96)
    g = {k: (torch.stack([_t(w) for w in v]) if isinstance(v, list)
             else _t(v)).to("cuda", dtype) for k, v in p.items()}
    args = [g[k] for k in ("w1", "b1", "wms", "bms", "wl", "bl", "wh", "bh")]
    x = _t(rng.random(shape, dtype=np.float32)).to("cuda", dtype)
    fc.reset_launches()
    head, sig = fc.dncnn_head_slabzero(x, *args, rows=rows)
    torch.cuda.synchronize()
    assert fc.LAUNCHES["dncnn_head_slabzero"] == 1
    assert fc.LAUNCHES["dncnn_head_fused"] == 0
    assert fc.LAUNCHES["conv3x3_mid"] == (L if dtype == torch.float32 else 0)
    assert sum(fc.LAUNCHES.values()) == 1 + fc.LAUNCHES["conv3x3_mid"]
    head_ref, sig_ref = fc.dncnn_head_slabzero_plain(x, *args, rows=rows)
    _close(head, head_ref, dtype)
    _close(sig, sig_ref, dtype, sigma=True)
    far = [r for r in range(shape[1]) if L + 3 <= r % rows < rows - (L + 3)]
    if far:
        h3, s3 = fc.dncnn_head_fused(x, *args)
        up = [r - 1 for r in far]
        _close(head[:, far], h3[:, up], dtype)
        _close(sig[:, far], s3[:, up], dtype, sigma=True)


def test_slabzero_kernel_raises_on_what_it_does_not_take():
    _need_card()
    rng = np.random.default_rng(12)
    p = _snet(rng, 3, 1, cf=96)
    g = {k: (torch.stack([_t(w) for w in v]) if isinstance(v, list)
             else _t(v)).cuda() for k, v in p.items()}
    args = [g[k] for k in ("w1", "b1", "wms", "bms", "wl", "bl", "wh", "bh")]
    x = torch.rand(1, 32, 32, 3, device="cuda")
    with pytest.raises(ValueError, match="must divide"):
        fc.dncnn_head_slabzero(x, *args, rows=12)
    with pytest.raises(TypeError):
        fc.dncnn_head_slabzero(x.double(), *args, rows=16)
    with pytest.raises(ValueError):
        fc.dncnn_head_slabzero(x.cpu(), *args, rows=16)
    with pytest.raises(RuntimeError, match="forward-only"):
        fc.dncnn_head_slabzero(x.requires_grad_(), *args, rows=16)


@pytest.mark.parametrize("n,h,w,c,k", [
    (2, 13, 17, 2, 5),      # ragged: smaller than one tile
    (1, 3, 4, 3, 7),        # H and W smaller than k
    (2, 40, 150, 3, 21),    # several tiles and chunks, the training k
    (1, 33, 20, 1, 3), (1, 20, 33, 4, 15), (3, 16, 128, 1, 3),
    # K5/K6's tiles (R rows x 3 lx pixels, lx = 8, 16 or 32 by the width):
    # W*C 189, 192, 195, H under one tile, odd C up to 7
    (2, 5, 63, 3, 21), (1, 7, 64, 3, 3), (2, 9, 65, 3, 21),
    (1, 17, 40, 5, 3), (1, 6, 11, 7, 21),
    # bands of 8 and 16 lanes (rows of 212 and 45 pixels), more than one
    # group of 8 channels (C = 9, 16, 20)
    (2, 26, 192, 3, 21), (1, 30, 25, 3, 21), (1, 14, 45, 1, 5),
    (1, 12, 30, 9, 5), (2, 9, 20, 16, 3), (1, 10, 70, 20, 7),
    # K7's tiling (strips of 8 rows, ranges of 96 pixels, runs of 3, tap
    # blocks of A dy x 3 dx, channel groups of up to 8, a skew for even
    # groups): H not a multiple of 8, W*C not a multiple of 288, every k,
    # C = 1, 2, 3, 9 and 45 at k = 21
    (2, 9, 97, 3, 21), (1, 17, 95, 2, 15), (1, 1, 1, 1, 3),
    (3, 8, 96, 3, 5), (1, 23, 101, 9, 7), (1, 5, 33, 45, 21),
    (2, 11, 7, 1, 21), (1, 16, 193, 3, 21), (1, 12, 9, 2, 3),
])
def test_blur_kernels_match_plain_on_card(n, h, w, c, k):
    """K5, K6, K7 against their plain versions on the card (f32 sums in
    another order: forward and dX atol 2e-5 on inputs in [0, 1) with taps
    summing to 1, dW 1e-5 of max|dW|), and K6, K7 bitwise equal when run
    twice."""
    _need_card()
    from virnet_tpu_torch.ops import blur

    rng = np.random.default_rng(9)
    dev = "cuda"
    xp = _t(rng.random((n, h + k - 1, w + k - 1, c), dtype=np.float32)).to(dev)
    g = _t(rng.random((n, h, w, c), dtype=np.float32)).to(dev)
    kern = rng.random((n, k, k), dtype=np.float32)
    kern = _t(kern / kern.sum((1, 2), keepdims=True)).to(dev)
    fc.reset_launches()
    out, dxp, dw = (blur.blur_valid(xp, kern), blur.blur_dx(g, kern),
                    blur.blur_dw(xp, g))
    torch.cuda.synchronize()
    assert fc.LAUNCHES["blur_valid"] == fc.LAUNCHES["blur_dx"] == 1
    assert fc.LAUNCHES["blur_dw"] == 1
    torch.testing.assert_close(out, blur.blur_valid_plain(xp, kern),
                               atol=2e-5, rtol=0)
    torch.testing.assert_close(dxp, blur.blur_dx_plain(g, kern), atol=2e-5,
                               rtol=0)
    want = blur.blur_dw_plain(xp, g)
    torch.testing.assert_close(dw, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    assert torch.equal(blur.blur_dx(g, kern), dxp)
    assert torch.equal(blur.blur_dw(xp, g), dw)


@pytest.mark.parametrize("pad_mode", ["reflect", "symmetric"])
def test_blur_op_gradients_on_card(pad_mode):
    """The public op on the card (K5 forward, K6 and K7 backward) against
    the same op on the CPU (plain versions): value atol 2e-5, gradients
    1e-5 of their max."""
    _need_card()
    from virnet_tpu_torch.ops.degrade import blur_per_sample

    rng = np.random.default_rng(10)
    x = rng.random((2, 24, 30, 3), dtype=np.float32)
    kern = rng.random((2, 7, 7), dtype=np.float32)
    kern /= kern.sum((1, 2), keepdims=True)
    g = rng.random(x.shape, dtype=np.float32)
    res = []
    for dev in ("cpu", "cuda"):
        xt = _t(x).to(dev).requires_grad_()
        kt = _t(kern).to(dev).requires_grad_()
        out = blur_per_sample(xt, kt, correlate=False, pad_mode=pad_mode)
        dx, dk = torch.autograd.grad((out * _t(g).to(dev)).sum(), (xt, kt))
        res.append([t.detach().cpu() for t in (out, dx, dk)])
    for a, b in zip(*res):
        torch.testing.assert_close(b, a, rtol=0,
                                   atol=max(2e-5, 1e-5 * float(a.abs().max())))


def test_blur_kernels_raise_on_what_they_do_not_take():
    _need_card()
    from virnet_tpu_torch.ops import blur

    xp = torch.rand(1, 12, 12, 3, device="cuda")
    kern = torch.rand(1, 5, 5, device="cuda")
    with pytest.raises(TypeError):
        blur.blur_valid(xp.double(), kern.double())
    with pytest.raises(ValueError):
        blur.blur_valid(xp.permute(0, 2, 1, 3), kern)
    with pytest.raises(ValueError):
        blur.blur_valid(torch.rand(1, 30, 30, 3, device="cuda"),
                        torch.rand(1, 27, 27, device="cuda"))
    with pytest.raises(ValueError):
        blur.blur_valid(xp.cpu(), kern)
    # K7: a k it is not built for, and more samples than it takes
    with pytest.raises(ValueError):
        blur.blur_dw(torch.rand(1, 30, 30, 3, device="cuda"),
                     torch.rand(1, 22, 22, 3, device="cuda"))
    with pytest.raises(ValueError, match="do not fit"):
        blur.blur_dw(torch.rand(65536, 3, 3, 1, device="cuda"),
                     torch.rand(65536, 1, 1, 1, device="cuda"))


_DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                                  ids=["fp32", "bf16"])


@_DTYPES
@pytest.mark.parametrize("shape,slope", [
    ((2, 17, 15), 0.25),    # bf16 tile (16x16) + 1 / - 1
    ((2, 15, 17), None),
    ((3, 9, 7), 0.25),      # f32 tile (8x8) + 1 / - 1
    ((2, 7, 9), 0.25),
    ((2, 33, 47), 0.25),    # several tiles, ragged both ways
    ((1, 1, 3), None),      # smaller than any tile
], ids=["17x15", "15x17", "9x7", "7x9", "33x47", "1x3"])
def test_mid_conv_tiling_matches_plain_on_card(shape, slope, dtype):
    """K1 against its plain version on the card around the tile sizes of
    both dtypes, N > 1, with and without LeakyReLU; one launch per call."""
    _need_card()
    from virnet_tpu_torch.precision import set_parity_mode

    set_parity_mode()
    rng = np.random.default_rng(13)
    x = _t(_rand(rng, (*shape, 64))).to("cuda", dtype)
    w = _t(_rand(rng, (3, 3, 64, 64), 0.04)).to("cuda", dtype)
    b = _t(_rand(rng, (64,), 0.05)).to("cuda", dtype)
    fc.reset_launches()
    got = fc.conv3x3_mid(x, w, b, slope)
    torch.cuda.synchronize()
    assert fc.LAUNCHES["conv3x3_mid"] == 1
    _close(got, fc.conv3x3_mid_plain(x, w, b, slope), dtype)


@_DTYPES
@pytest.mark.parametrize("n,hp,wp,h,w,c", [
    (2, 17, 17, 17, 17, 96),    # tile (16x16) + 1, no padding
    (2, 15, 15, 15, 15, 96),    # tile - 1
    (2, 12, 20, 9, 15, 96),     # padded: h < Hp, w < Wp
    (3, 17, 33, 17, 31, 20),    # C no multiple of 16, padded width
    (1, 5, 40, 5, 37, 44),      # C * 2 B no multiple of 16 (8-byte copies)
    (1, 16, 16, 16, 16, 4),     # one whole tile, the narrowest C
    (2, 18, 18, 17, 17, 256),   # the widest C
    (1, 33, 9, 31, 9, 8),       # several tiles down, one across
], ids=["17x17", "15x15", "padded", "c20", "c44", "c4", "c256", "33x9"])
def test_tail_tiling_matches_plain_on_card(n, hp, wp, h, w, c, dtype):
    """K4 against its plain version on the card: tile sizes +- 1, the
    padded case, widths C that do not fill a 16-channel block; one launch
    per call."""
    _need_card()
    from virnet_tpu_torch.precision import set_parity_mode

    set_parity_mode()
    rng = np.random.default_rng(14)
    feats = _t(_rand(rng, (n, hp, wp, c))).to("cuda", dtype)
    x_in = _t(rng.random((n, h, w, 3), dtype=np.float32)).cuda()
    wt = _t(_rand(rng, (3, 3, c, 3), 0.05)).to("cuda", dtype)
    bt = _t(_rand(rng, (3,), 0.1)).to("cuda", dtype)
    fc.reset_launches()
    got = fc.conv3x3_tail_residual(feats, x_in, wt, bt)
    torch.cuda.synchronize()
    assert fc.LAUNCHES["conv3x3_tail_residual"] == 1
    _close(got, fc.conv3x3_tail_residual_plain(feats, x_in, wt, bt), dtype)


def _offset(t):
    """A contiguous copy of ``t`` whose data starts one element past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def test_mid_and_tail_raise_on_what_they_do_not_take():
    _need_card()
    x = torch.rand(1, 8, 8, 64, device="cuda")
    w = torch.rand(3, 3, 64, 64, device="cuda")
    b = torch.rand(64, device="cuda")
    with pytest.raises(ValueError, match="64 channels"):
        fc.conv3x3_mid(x[..., :32].contiguous(), w, b)
    with pytest.raises(TypeError):
        fc.conv3x3_mid(x.double(), w.double(), b.double())
    with pytest.raises(TypeError):
        fc.conv3x3_mid(x, w.bfloat16(), b)
    with pytest.raises(ValueError, match="contiguous"):
        fc.conv3x3_mid(x.permute(0, 2, 1, 3), w, b)
    with pytest.raises(ValueError, match="aligned"):
        fc.conv3x3_mid(_offset(x), w, b)
    with pytest.raises(ValueError, match="aligned"):
        fc.conv3x3_mid(x, _offset(w), b)
    with pytest.raises(ValueError):
        fc.conv3x3_mid(x, w.cpu(), b)
    with pytest.raises(RuntimeError, match="forward-only"):
        fc.conv3x3_mid(x, w.requires_grad_(), b)

    feats = torch.rand(1, 8, 16, 96, device="cuda")
    x_in = torch.rand(1, 8, 16, 3, device="cuda")
    wt = torch.rand(3, 3, 96, 3, device="cuda")
    bt = torch.rand(3, device="cuda")
    for c in (6, 260):
        with pytest.raises(ValueError, match="do not fit"):
            fc.conv3x3_tail_residual(
                torch.rand(1, 8, 16, c, device="cuda"), x_in,
                torch.rand(3, 3, c, 3, device="cuda"), bt)
    with pytest.raises(ValueError, match="do not fit"):
        fc.conv3x3_tail_residual(feats, torch.rand(1, 9, 16, 3,
                                                   device="cuda"), wt, bt)
    with pytest.raises(TypeError):
        fc.conv3x3_tail_residual(feats, x_in.bfloat16(), wt, bt)
    with pytest.raises(ValueError, match="aligned"):
        fc.conv3x3_tail_residual(_offset(feats), x_in, wt, bt)
    # x_in is read 4 bytes at a time: an offset one is taken
    torch.testing.assert_close(
        fc.conv3x3_tail_residual(feats, _offset(x_in), wt, bt),
        fc.conv3x3_tail_residual(feats, x_in, wt, bt), atol=0, rtol=0)
    with pytest.raises(RuntimeError, match="forward-only"):
        fc.conv3x3_tail_residual(feats.requires_grad_(), x_in, wt, bt)


# the output tile of csrc/dncnn_head.cu (K3 in bf16); its mid levels run
# in rectangles of at most 32 columns and 256 pixels
K3_TILE = 24


def _head_args(rng, L, co, cf, dtype=torch.bfloat16):
    p = _snet(rng, L, co, cf)
    g = {k: (torch.stack([_t(w) for w in v]) if isinstance(v, list)
             else _t(v)).to("cuda", dtype) for k, v in p.items()}
    return [g[k] for k in ("w1", "b1", "wms", "bms", "wl", "bl", "wh", "bh")]


@pytest.mark.parametrize("cf", [16, 96, 256])
@pytest.mark.parametrize("L,co", [(1, 1), (3, 1), (6, 3)],
                         ids=["L1", "syn", "real"])
def test_head_kernel_bf16_matches_plain_on_card(L, co, cf):
    """K3 in bf16 (csrc/dncnn_head.cu) against its plain version on the
    card: one pixel, the tile size -1 / +1, two whole tiles across, and an
    odd size; exactly one launch per call."""
    _need_card()
    rng = np.random.default_rng(16)
    args = _head_args(rng, L, co, cf)
    t = K3_TILE
    for shape in ((1, 1, 1, 3), (1, t - 1, t + 1, 3), (2, t, 2 * t, 3),
                  (1, 37, 45, 3)):
        x = _t(rng.random(shape, dtype=np.float32)).to("cuda", torch.bfloat16)
        fc.reset_launches()
        head, sig = fc.dncnn_head_fused(x, *args)
        torch.cuda.synchronize()
        assert fc.LAUNCHES["dncnn_head_fused"] == 1, shape
        assert sum(fc.LAUNCHES.values()) == 1, shape
        assert head.shape == (*shape[:3], cf) and sig.shape == (*shape[:3], co)
        h_ref, s_ref = fc.dncnn_head_fused_plain(x, *args)
        _close(head, h_ref, torch.bfloat16)
        _close(sig, s_ref, torch.bfloat16, sigma=True)


def test_head_kernel_bf16_raises_on_what_it_does_not_take():
    _need_card()
    rng = np.random.default_rng(17)
    args = _head_args(rng, 3, 1, 96)
    x = torch.rand(1, 30, 30, 3, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="aligned"):
        fc.dncnn_head_fused(_offset(x), *args)
    wh24 = torch.rand(3, 3, 4, 24, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="multiple of 16"):
        fc.dncnn_head_fused(x, *args[:6], wh24, args[7][:24].contiguous())
    a4 = _head_args(rng, 3, 4, 96)
    with pytest.raises(ValueError, match="1-3 outputs"):
        fc.dncnn_head_fused(x, *a4)


# the output tile of csrc/snet_levels.cu's kernels (K2 both dtypes, K3
# fp32): one pixel per thread of a 16x16 block
CHAIN_TILE = 16
_CHAIN_SHAPES = ((1, 1, 1, 3), (1, 7, 9, 3), (1, 15, 17, 3), (2, 17, 33, 3),
                 (1, 321, 481, 3))


@_DTYPES
@pytest.mark.parametrize("L,co", [(1, 1), (3, 1), (6, 3)],
                         ids=["L1", "syn", "real"])
def test_dncnn_level_chain_matches_plain_on_card(L, co, dtype):
    """K2 (csrc/snet_levels.cu: snet_conv1, L launches of K1, snet_last in
    its logits mode) against its plain version on the card: one pixel,
    odd sizes around the 16x16 tile, batch 2 and a CBSD68 image's size;
    one dncnn_fused call and L K1 launches per call, nothing else."""
    _need_card()
    from virnet_tpu_torch.precision import set_parity_mode

    set_parity_mode()
    rng = np.random.default_rng(18)
    args = _head_args(rng, L, co, 16, dtype)[:6]
    for shape in _CHAIN_SHAPES:
        x = _t(rng.random(shape, dtype=np.float32)).to("cuda", dtype)
        fc.reset_launches()
        got = fc.dncnn_fused(x, *args)
        torch.cuda.synchronize()
        assert fc.LAUNCHES["dncnn_fused"] == 1, shape
        assert fc.LAUNCHES["conv3x3_mid"] == L, shape
        assert sum(fc.LAUNCHES.values()) == 1 + L, shape
        assert got.shape == (*shape[:3], co) and got.dtype == dtype
        _close(got, fc.dncnn_fused_plain(x, *args), dtype)


@pytest.mark.parametrize("cf", [16, 96, 256])
@pytest.mark.parametrize("L,co", [(1, 1), (3, 1), (6, 3)],
                         ids=["L1", "syn", "real"])
def test_head_level_chain_fp32_matches_plain_on_card(L, co, cf):
    """K3 in fp32 (the level chain with snet_last's sigma + head mode)
    against its plain version on the card: head atol 1e-4, sigma rtol
    1e-5; one dncnn_head_fused call and L K1 launches per call."""
    _need_card()
    from virnet_tpu_torch.precision import set_parity_mode

    set_parity_mode()
    rng = np.random.default_rng(19)
    args = _head_args(rng, L, co, cf, torch.float32)
    for shape in _CHAIN_SHAPES:
        x = _t(rng.random(shape, dtype=np.float32)).cuda()
        fc.reset_launches()
        head, sig = fc.dncnn_head_fused(x, *args)
        torch.cuda.synchronize()
        assert fc.LAUNCHES["dncnn_head_fused"] == 1, shape
        assert fc.LAUNCHES["conv3x3_mid"] == L, shape
        assert sum(fc.LAUNCHES.values()) == 1 + L, shape
        assert head.shape == (*shape[:3], cf) and sig.shape == (*shape[:3], co)
        h_ref, s_ref = fc.dncnn_head_fused_plain(x, *args)
        _close(head, h_ref, torch.float32)
        _close(sig, s_ref, torch.float32, sigma=True)


@pytest.mark.parametrize("L,co,cf", [(3, 1, 96), (6, 3, 16)],
                         ids=["syn", "real"])
def test_head_level_chain_bf16_matches_plain_on_card(L, co, cf):
    """The level chain's sigma + head mode in bf16, which only the
    measurement beside K3 bf16 runs (K3 bf16 itself is dncnn_head.cu),
    against the plain version at the bf16 bars."""
    _need_card()
    rng = np.random.default_rng(20)
    args = _head_args(rng, L, co, cf)
    for shape in ((1, 1, 1, 3), (2, 17, 33, 3), (1, 64, 48, 3)):
        x = _t(rng.random(shape, dtype=np.float32)).to("cuda", torch.bfloat16)
        head, sig = fc._snet_chain(True, x, *args, 0.25, -23.025850929940457,
                                   4.605170185988092)
        torch.cuda.synchronize()
        h_ref, s_ref = fc.dncnn_head_fused_plain(x, *args)
        _close(head, h_ref, torch.bfloat16)
        _close(sig, s_ref, torch.bfloat16, sigma=True)


@_DTYPES
def test_level_chain_raises_on_what_it_does_not_take(dtype):
    """K2 and fp32 K3 refuse before any launch: unaligned stacked mid
    weights, a head width that is no multiple of 16, co = 4, mixed
    dtypes, a CPU weight, and inputs that require grad."""
    _need_card()
    rng = np.random.default_rng(21)
    args = _head_args(rng, 3, 1, 96, dtype)
    x = torch.rand(1, 20, 20, 3, device="cuda").to(dtype)
    fc.reset_launches()
    bad_wm = args[:2] + [_offset(args[2])] + args[3:6]
    with pytest.raises(ValueError, match="aligned"):
        fc.dncnn_fused(x, *bad_wm)
    with pytest.raises(TypeError):
        fc.dncnn_fused(x.double(), *args[:6])
    with pytest.raises(ValueError):
        fc.dncnn_fused(x, *args[:5], args[5].cpu())
    a4 = _head_args(rng, 3, 4, 96, dtype)
    with pytest.raises(ValueError, match="1-3 outputs"):
        fc.dncnn_fused(x, *a4[:6])
    with pytest.raises(RuntimeError, match="forward-only"):
        fc.dncnn_fused(x, args[0].clone().requires_grad_(), *args[1:6])
    assert sum(fc.LAUNCHES.values()) == 0
    if dtype == torch.bfloat16:
        return
    with pytest.raises(ValueError, match="aligned"):
        fc.dncnn_head_fused(x, *bad_wm, *args[6:])
    wh24 = torch.rand(3, 3, 4, 24, device="cuda")
    with pytest.raises(ValueError, match="multiple of 16"):
        fc.dncnn_head_fused(x, *args[:6], wh24, args[7][:24].contiguous())
    with pytest.raises(ValueError, match="1-3 outputs"):
        fc.dncnn_head_fused(x, *a4)
    assert sum(fc.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------------
# K9 and K10, the int8 serving mode's convolution and absmax
# ---------------------------------------------------------------------------

def _fast_path_misses(v, s):
    """Where K9's quantize leaves its fast path for the IEEE quotient:
    float32 ``v`` against scale ``s``, y = v * (1 / s) rounded twice, off
    the path where y lies within 2^-14 of a half-integer or |y| >= 127.25
    (csrc/conv_w8a8.cu, quantize_px).  Returns that mask and the one of
    the values whose rint(y) is not rint(v / s), which only the quotient
    rounds right."""
    f32 = np.float32
    y = v * (f32(1) / s)
    magic = f32(12582912.0)
    miss = ~((np.abs(((y + magic) - magic) - y) < f32(0.5 - 2.0 ** -14))
             & (np.abs(y) < f32(127.25)))
    return miss, np.rint(y) != np.rint(v / s)


def _q8_args(rng, n, h, w, ci, co, k, device="cuda"):
    """bf16 activations whose channels span a factor of 100 in range,
    their per-channel scales (K10's plain version under scale_of, channel
    0's a power of two), int8 weights, scales and a bias, on the card.
    The first pixels carry values that leave K9's fast quantize for the
    IEEE quotient: exact rounding ties of their scale (channel 0, clamped
    ones at +-127.5 and beyond among them) and, in every channel, values
    whose product by the scale's reciprocal lies within 2^-14 of a
    half-integer, those that it would round otherwise first."""
    from virnet_tpu_torch.ops import qconv

    x = (rng.standard_normal((n, h, w, ci))
         * rng.uniform(0.05, 5.0, ci)).astype(np.float32)
    x = torch.from_numpy(x).to(torch.bfloat16)
    sx = qconv.scale_of(qconv.absmax_plain(x))
    sx[0] = 2.0 ** -5
    flat = x.view(-1, ci)
    m = flat.shape[0]
    ties = np.array([-127.5, -2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 127.5, 200.5],
                    np.float32) * np.float32(2.0 ** -5)
    flat[:min(m, ties.size), 0] = torch.from_numpy(ties[:m])
    # every bf16 value as float32, those in a channel's range kept
    every = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    amax = qconv.absmax_plain(x).numpy()
    s = sx.numpy()
    n_miss = n_odd = 0
    for c in range(1, ci):
        v = every[np.isfinite(every) & (np.abs(every) <= amax[c])]
        miss, odd = _fast_path_misses(v, s[c])
        pick = np.concatenate([amax[c:c + 1], v[odd],
                               v[miss & ~odd]])[:m]   # the max stays
        flat[:pick.size, c] = torch.from_numpy(pick)
        n_miss += pick.size - 1
        n_odd += min(int(odd.sum()), m - 1)
    assert qconv.absmax_plain(x)[1:].equal(torch.from_numpy(amax[1:]))
    got_miss, got_odd = _fast_path_misses(
        flat.float().numpy()[:, 1:], s[1:])
    assert got_miss.sum() >= n_miss and got_odd.sum() >= n_odd
    assert n_miss > 0 and (m < 8 or n_odd > 0)
    assert _fast_path_misses(flat.float().numpy()[:ties.size, 0],
                             s[0])[0].all()
    kq = torch.from_numpy(rng.integers(-127, 128, (k, k, ci, co),
                                       dtype=np.int8))
    sw = torch.from_numpy(rng.uniform(1e-6, 1e-4, co).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.1, co).astype(np.float32))
    return tuple(t.to(device) for t in (x, sx, kq, sw, bias))


@pytest.mark.parametrize("k,ci,co,nhw", [
    (3, 64, 64, (2, 37, 45)), (3, 96, 96, (1, 16, 16)),
    (3, 288, 288, (1, 9, 23)), (3, 20, 40, (1, 8, 17)),
    (3, 160, 224, (2, 3, 5)), (1, 24, 96, (3, 1, 1)),
    (1, 40, 160, (2, 5, 7)), (1, 16, 13, (1, 3, 3)),
    (3, 192, 192, (1, 33, 19)), (1, 28, 56, (1, 17, 18)),
    (3, 224, 224, (1, 11, 13)), (1, 56, 224, (2, 4, 9))])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_conv_w8a8_kernel_matches_plain_on_card(k, ci, co, nhw, out):
    """K9 (float activations quantized in the kernel, the s8 product and
    the two-rounding epilogue) against its plain version on the card and
    on the CPU: the same bits, with and without a bias, one launch a
    call; and the int32 sums on small integers fed as float with scale 1
    (so that q = x)."""
    _need_card()
    from virnet_tpu_torch.ops import qconv

    rng = np.random.default_rng(k + ci + co)
    x, sx, kq, sw, bias = _q8_args(rng, *nhw, ci, co, k)
    fc.reset_launches()
    for b in (bias, None):
        got = qconv.conv_q8(x, sx, kq, sw, b, out)
        torch.cuda.synchronize()
        assert got.dtype == out and got.shape == (*nhw, co)
        assert torch.equal(got, qconv.conv_q8_plain(x, sx, kq, sw, b, out))
        assert torch.equal(got.cpu(), qconv.conv_q8_plain(
            x.cpu(), sx.cpu(), kq.cpu(), sw.cpu(),
            None if b is None else b.cpu(), out))
    assert fc.LAUNCHES["conv_w8a8"] == 2
    small = torch.from_numpy(rng.integers(-8, 9, (*nhw, ci))).to(
        torch.bfloat16).cuda()
    sums = qconv.conv_q8(small, torch.ones(ci, device="cuda"), kq,
                         torch.ones(co, device="cuda"), None, torch.float32)
    want = qconv.int32_sums(small.to(torch.int8), kq, k // 2).float()
    assert torch.equal(sums, want)


@pytest.mark.parametrize("shape", [(32, 16, 16, 96), (1, 37, 45, 64),
                                   (2, 9, 23, 288), (3, 1, 1, 24),
                                   (1, 5, 7, 20), (2, 3, 3, 13),
                                   (1, 300, 301, 160)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_absmax_kernel_matches_plain_on_card(shape, dtype):
    """K10 against its plain version: the same bits (a max is exact), on
    the 16-byte path and on the one for any width, with a dead channel, a
    channel whose largest magnitude is negative, and a NaN that the
    channel's max keeps; one launch a call."""
    _need_card()
    from virnet_tpu_torch.ops import qconv

    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 100, shape[-1]))
    x[..., 0] = 0.0
    x[(0,) * 3 + (1,)] = -1e4
    x = torch.from_numpy(x.astype(np.float32)).to(dtype).cuda()
    fc.reset_launches()
    got = qconv.absmax_nhwc(x)
    torch.cuda.synchronize()
    assert torch.equal(got, qconv.absmax_plain(x))
    assert torch.equal(got.cpu(), qconv.absmax_plain(x.cpu()))
    assert got[0] == 0 and got[1] == 1e4 if dtype == torch.float32 else True
    x.view(-1)[-1] = float("nan")
    nan = qconv.absmax_nhwc(x)
    assert torch.isnan(nan[-1]) and torch.equal(nan[:-1], got[:-1])
    assert fc.LAUNCHES["absmax_nhwc"] == 2


def test_conv_w8a8_kernel_raises_on_what_it_does_not_take():
    """A 5x5 kernel, int8 or float32 activations, a bias of another
    dtype, widths that disagree, a non-contiguous input, a float16 output;
    K10 on float16: raised before any launch."""
    _need_card()
    from virnet_tpu_torch.ops import qconv

    rng = np.random.default_rng(30)
    x, sx, kq, sw, bias = _q8_args(rng, 1, 8, 8, 32, 32, 3)
    fc.reset_launches()
    k5 = torch.zeros(5, 5, 32, 32, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="1x1 and 3x3"):
        qconv.conv_q8(x, sx, k5, sw, bias)
    for bad in (torch.int8, torch.float32):
        with pytest.raises(TypeError):
            qconv.conv_q8(x.to(bad), sx, kq, sw, bias)
    with pytest.raises(TypeError):
        qconv.conv_q8(x, sx, kq, sw, bias.double())
    with pytest.raises(ValueError, match="input channels"):
        qconv.conv_q8(x[..., :16].contiguous(), sx, kq, sw, bias)
    with pytest.raises(ValueError, match="contiguous"):
        qconv.conv_q8(x.transpose(1, 2), sx, kq, sw, bias)
    with pytest.raises(TypeError):
        qconv.conv_q8(x, sx, kq, sw, bias, torch.float16)
    with pytest.raises(TypeError):
        qconv.absmax_nhwc(x.half())
    assert fc.LAUNCHES["conv_w8a8"] == 0 and fc.LAUNCHES["absmax_nhwc"] == 0


def test_conv_w8a8_plan_splits_without_padding():
    """K9's split of Co at the gated widths: one block of all channels up
    to 96, else splits of a width wgmma takes (32-96), the last of them
    32 wide where 32 are left, that add up to Co exactly (no padded
    n-tile), every block inside the 227 KB a block may have, for both
    output dtypes."""
    _need_card()
    from virnet_tpu_torch.ops import qconv

    for k, ci, co in [(3, 64, 64), (3, 96, 96), (3, 160, 160),
                      (3, 192, 192), (3, 224, 224), (3, 288, 288),
                      (1, 24, 96), (1, 40, 160), (1, 56, 224)]:
        for out in (torch.bfloat16, torch.float32):
            p = qconv.conv_q8_plan(k, ci, co, out)
            assert p["co_blk"] in (32, 48, 64, 80, 96)
            assert p["tail"] in (32, p["co_blk"])
            assert p["co_blk"] * (p["splits"] - 1) + p["tail"] == co, p
            assert p["smem_bytes"] <= 232448
            if co <= 96:
                assert p["splits"] == 1
    p = qconv.conv_q8_plan(3, 224, 224)
    assert (p["co_blk"], p["splits"], p["tail"]) == (64, 4, 32)


# K11 (ops/resblock.py): RNet's body convs at the flagship batch's three
# scales (32 x 256^2 x 96, 32 x 128^2 x 192, 32 x 64^2 x 288), the real
# preset's 160 and 224 wide, and odd sizes around the 32 x 8 tile
@pytest.mark.parametrize("mode", ["first", "second"])
@pytest.mark.parametrize("nf,shape", [
    (96, (32, 256, 256)), (192, (32, 128, 128)), (288, (32, 64, 64)),
    (160, (4, 128, 128)), (224, (4, 64, 64)), (96, (1, 37, 45)),
    (288, (2, 9, 13)), (160, (1, 1, 1)), (224, (3, 33, 7))])
def test_resblock_conv_kernel_matches_plain_on_card(nf, shape, mode):
    """K11 against its plain version on the card (TF32 off), one launch a
    call: both sum the same products in float32 and round once, so they
    differ by the summation order alone (4 bf16 ulps of the scale)."""
    _need_card()
    from virnet_tpu_torch.ops import resblock
    from virnet_tpu_torch.precision import set_parity_mode

    set_parity_mode()
    rng = np.random.default_rng(nf + sum(shape))
    bound = 1 / np.sqrt(9 * nf)    # the models' init
    dev, bf = "cuda", torch.bfloat16
    x = _t(_rand(rng, (*shape, nf))).to(dev, bf)
    w = _t(rng.uniform(-bound, bound, (3, 3, nf, nf)).astype(
        np.float32)).to(dev, bf)
    b = _t(rng.uniform(-bound, bound, nf).astype(np.float32)).to(dev, bf)
    res = _t(_rand(rng, (*shape, nf))).to(dev, bf)
    wk = resblock.kernel_weights(w)
    fc.reset_launches()
    got = resblock.resblock_conv(x, wk, b, mode, residual=res)
    torch.cuda.synchronize()
    assert fc.LAUNCHES["resblock_conv"] == 1
    assert got.dtype == bf and got.shape == (*shape, nf)
    # the plain version off cuDNN, whose heuristics pick FFT for these
    # shapes in float32 with TF32 off (precision.py)
    with torch.backends.cudnn.flags(enabled=False):
        want = resblock.resblock_conv_plain(x, w, b, mode, residual=res)
    _close(got, want, bf)
    d = (got.float() - want.float()).abs()
    assert float(d.mean()) < 1e-3 * float(want.float().abs().mean())


def test_resblock_conv_kernel_raises_on_what_it_does_not_take():
    """fp32 activations, widths K11 does not take, weights not in its
    layout, a missing residual, a non-contiguous or misaligned input:
    raised before any launch."""
    _need_card()
    from virnet_tpu_torch.ops import resblock

    rng = np.random.default_rng(31)
    dev, bf = "cuda", torch.bfloat16
    x = _t(_rand(rng, (1, 8, 8, 32))).to(dev, bf)
    w = _t(_rand(rng, (3, 3, 32, 32), 0.05)).to(dev, bf)
    b = torch.zeros(32, device=dev, dtype=bf)
    wk = resblock.kernel_weights(w)
    fc.reset_launches()
    with pytest.raises(TypeError):
        resblock.resblock_conv(x.float(), wk, b, "first")
    with pytest.raises(ValueError, match="multiples of 16"):
        resblock.resblock_conv(x[..., :24].contiguous(), wk, b, "first")
    with pytest.raises(ValueError, match="shape"):
        resblock.resblock_conv(x, w, b, "first")
    with pytest.raises(ValueError, match="residual"):
        resblock.resblock_conv(x, wk, b, "second")
    with pytest.raises(ValueError, match="contiguous"):
        resblock.resblock_conv(x.transpose(1, 2), wk, b, "first")
    flat = torch.empty(x.numel() + 4, device=dev, dtype=bf)
    with pytest.raises(ValueError, match="aligned"):
        resblock.resblock_conv(flat[4:].view(x.shape), wk, b, "first")
    assert fc.LAUNCHES["resblock_conv"] == 0


# the released serving paths: (task, compute, the shape of the request's
# input on the card, a batch for restore_batch or an image for
# restore_image, and the launches of ours one request makes).  256^2
# passes the fused-head gate (K3), 321 x 481 fails it (K2: snet_conv1, K1
# once per mid level, snet_last); bf16 runs each unconditioned RNet block
# as two K11 launches (15 blocks of denoising-syn, 21 of denoising-real).
# tests/test_torch_port_engine.py holds the same table on the CPU.
SERVING_PATHS = {
    "syn-bf16-batch": ("denoising-syn", "bf16", (2, 256, 256, 3), dict(
        dncnn_head_fused=1, resblock_conv=30, conv3x3_tail_residual=1)),
    "syn-bf16-odd": ("denoising-syn", "bf16", (321, 481, 3), dict(
        dncnn_fused=1, conv3x3_mid=3, resblock_conv=30,
        conv3x3_tail_residual=1)),
    "syn-fp32-odd": ("denoising-syn", "fp32", (321, 481, 3), dict(
        dncnn_fused=1, conv3x3_mid=3, conv3x3_tail_residual=1)),
    "real-bf16-batch": ("denoising-real", "bf16", (4, 256, 256, 3), dict(
        dncnn_head_fused=1, resblock_conv=42, conv3x3_tail_residual=1)),
}
DEMO_CKPTS = {task: Path(__file__).resolve().parents[1] / "model_zoo" /
              f"virnet_{task.replace('-', '_')}_demo.pth"
              for task in ("denoising-syn", "denoising-real")}


@pytest.mark.parametrize("case", list(SERVING_PATHS))
def test_serving_paths_launch_exactly_their_kernels(case):
    """One request of each released serving path on the card launches
    exactly its kernels of SERVING_PATHS and nothing else of ours; in bf16
    the output agrees with the same weights on today's library route
    (every body block's K11 off) within 4 bf16 ulps of the image scale."""
    _need_card()
    from virnet_tpu_torch.eval.engine import Restorer
    from virnet_tpu_torch.models.attresunet import AttResBlock

    task, compute, shape, want = SERVING_PATHS[case]
    r = Restorer(task, ckpt_path=DEMO_CKPTS[task], compute=compute)
    x = np.random.default_rng(32).random(shape, dtype=np.float32)
    if len(shape) == 4:
        x = torch.from_numpy(x).cuda()
    request = r.restore_batch if len(shape) == 4 else r.restore_image
    fc.reset_launches()
    got = request(x)
    torch.cuda.synchronize()
    assert {k: n for k, n in fc.LAUNCHES.items() if n} == want
    if compute == "fp32":
        return
    for m in r.model.modules():
        if isinstance(m, AttResBlock):
            m.kernels = False
    fc.reset_launches()
    want_out = request(x)
    assert fc.LAUNCHES["resblock_conv"] == 0
    _close(torch.as_tensor(got), torch.as_tensor(want_out), torch.bfloat16)


@pytest.mark.parametrize("compute", ["fp32", "bf16"])
def test_numpy_requests_cross_through_page_locked_blocks(compute):
    """Restorer.restore_batch on the card: a numpy batch's result is a
    page-locked host tensor equal bit for bit to the tensor request's
    result (which stays on the card), a float64 batch converts as before,
    every numpy request counts one page-locked copy each way in
    ``engine.COPIES``, and a result kept from one request is unchanged
    after the next returns (no block the caller holds is handed out
    again)."""
    _need_card()
    from virnet_tpu_torch.eval import engine

    r = engine.Restorer("denoising-syn", ckpt_path=DEMO_CKPTS["denoising-syn"],
                        compute=compute)
    rng = np.random.default_rng(25)
    x, x2 = (rng.random((2, 64, 72, 3), dtype=np.float32) for _ in range(2))
    want = r.restore_batch(torch.from_numpy(x).cuda())
    assert want.is_cuda
    before = dict(engine.COPIES)
    got = r.restore_batch(x)
    assert {k: n - before[k] for k, n in engine.COPIES.items()} == \
        {"pinned_in": 1, "pinned_out": 1, "pageable_in": 0,
         "pageable_out": 0}
    assert got.device.type == "cpu" and got.is_pinned()
    assert torch.equal(got, want.cpu())
    kept = got.clone()
    other = r.restore_batch(x2)
    assert other.is_pinned() and not torch.equal(other, got)
    assert torch.equal(got, kept)
    del other
    again = r.restore_batch(x.astype(np.float64))
    assert again.is_pinned() and torch.equal(again, kept)
    assert engine.COPIES["pinned_in"] - before["pinned_in"] == 3
    assert engine.COPIES["pinned_out"] - before["pinned_out"] == 3


def test_numpy_image_on_the_chop_path_crosses_page_locked(monkeypatch):
    """restore_image above the chop threshold (lowered here so that a 40 x
    44 image splits once) on the card: one page-locked copy each way for
    the whole image (the quadrants' forwards take tensors and count none),
    and the bits of ``forward_chop`` over tensor requests."""
    _need_card()
    from virnet_tpu_torch.eval import engine
    from virnet_tpu_torch.eval.tiling import forward_chop

    monkeypatch.setattr(engine, "CHOP_THRESHOLD", 1000)
    r = engine.Restorer("denoising-syn", ckpt_path=DEMO_CKPTS["denoising-syn"],
                        compute="bf16")
    im = np.random.default_rng(26).random((40, 44, 3), dtype=np.float32)
    before = dict(engine.COPIES)
    got = r.restore_image(im)
    assert {k: n - before[k] for k, n in engine.COPIES.items()} == \
        {"pinned_in": 1, "pinned_out": 1, "pageable_in": 0,
         "pageable_out": 0}
    want = forward_chop(r.restore_batch, torch.from_numpy(im[None]).cuda(),
                        shave=10, min_size=1000)[0]
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, want.cpu().numpy())
