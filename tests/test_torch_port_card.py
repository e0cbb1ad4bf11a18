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
