"""The CUDA kernels against their plain PyTorch versions on the card, at
small odd shapes, for both presets' SNet shapes (syn: L=3, co=1; real:
L=6, co=3), in fp32 with TF32 off and in bf16.  Skips without a CUDA
device.  Imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_port_card.py -q
"""

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
    """K1-K4 against their plain versions on the card."""
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


@pytest.mark.parametrize("n,h,w,c,k", [
    (2, 13, 17, 2, 5),      # ragged: smaller than one tile
    (1, 3, 4, 3, 7),        # H and W smaller than k
    (2, 40, 150, 3, 21),    # several tiles and chunks, the training k
    (1, 33, 20, 1, 3), (1, 20, 33, 4, 15), (3, 16, 128, 1, 3),
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
