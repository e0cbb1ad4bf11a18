"""The port's models (virnet_tpu_torch/models) against the JAX package's
(virnet_tpu/models) on the CPU in fp32: a small VIRNet carried across by
``from_jax_params``, and both released denoising presets loaded from
model_zoo/ with ``strict=True``, through the fused prologue and through
the unfused graph."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virnet_tpu.convert import load_torch_checkpoint
from virnet_tpu.convert.torch_export import export_state_dict
from virnet_tpu.models import VIRNet as JaxVIRNet
from virnet_tpu.models import build_model as jax_build_model
from virnet_tpu.models.fused import denoise_forward_fused as jax_fused
from virnet_tpu_torch.convert import from_jax_params, load_pth
from virnet_tpu_torch.models import VIRNet, build_model
from virnet_tpu_torch.models.common import conv_hwio, hwio
from virnet_tpu_torch.models.fused import fused_head_supported

SMALL = dict(sigma_chn=1, n_feat=(16, 24, 32), dep_S=4, n_resblocks=2)
CKPTS = {"denoising-syn": "model_zoo/virnet_denoising_syn_demo.pth",
         "denoising-real": "model_zoo/virnet_denoising_real_demo.pth"}


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _port_forward(model, x):
    with torch.inference_mode():
        mu, sigma = model(torch.from_numpy(x))
    return mu.numpy(), sigma.numpy()


@pytest.mark.parametrize("extra_mode,hw", [
    ("input", (33, 41)),    # pad path: K2 + pad + head + K4 (plain)
    ("input", (32, 40)),    # passes the gate: K3 + RNet + K4 (plain)
    ("down", (32, 40)),     # SFT-conditioned down path
    ("both", (29, 32)),
])
def test_small_virnet_matches_jax(extra_mode, hw):
    jm = JaxVIRNet(extra_mode=extra_mode, **SMALL)
    x = np.random.default_rng(0).random((2, *hw, 3), dtype=np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    mu_j, sig_j = jm.apply({"params": params}, jnp.asarray(x))
    tm = VIRNet(extra_mode=extra_mode, **SMALL)
    tm.load_state_dict(from_jax_params(_np_tree(params)), strict=True)
    assert fused_head_supported(tm, x.shape) == (
        extra_mode == "input" and hw == (32, 40))
    mu, sig = _port_forward(tm, x)
    np.testing.assert_allclose(sig, np.asarray(sig_j), atol=2e-6)
    np.testing.assert_allclose(mu, np.asarray(mu_j), atol=1e-5)


def test_from_jax_params_matches_export_state_dict():
    jm = JaxVIRNet(extra_mode="both", **SMALL)
    params = _np_tree(jm.init(jax.random.PRNGKey(1),
                              jnp.zeros((1, 16, 16, 3)))["params"])
    want = export_state_dict(params, jm)
    got = from_jax_params({"params": params})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("task", sorted(CKPTS))
def test_presets_load_strict_and_match_jax(task):
    sd = load_pth(CKPTS[task])
    model = build_model(task)
    model.load_state_dict(sd, strict=True)
    model.eval()
    jm = jax_build_model(task)
    params = load_torch_checkpoint(CKPTS[task], jm)["params"]
    rng = np.random.default_rng(2)

    # 1x32x32 passes the gate: the port's K3 path against the JAX fused
    # prologue (Pallas in interpret mode)
    x = rng.random((1, 32, 32, 3), dtype=np.float32)
    assert fused_head_supported(model, x.shape)
    mu_j, sig_j = jax_fused(jm, params, jnp.asarray(x), interpret=True)
    mu, sig = _port_forward(model, x)
    np.testing.assert_allclose(sig, np.asarray(sig_j), atol=2e-6)
    np.testing.assert_allclose(mu, np.asarray(mu_j), atol=1e-5)

    # 1x29x35 fails it: K2 + pad + K4 against the unfused JAX graph
    x = rng.random((1, 29, 35, 3), dtype=np.float32)
    assert not fused_head_supported(model, x.shape)
    mu_j, sig_j = jm.apply({"params": params}, jnp.asarray(x))
    mu, sig = _port_forward(model, x)
    np.testing.assert_allclose(sig, np.asarray(sig_j), atol=2e-6)
    np.testing.assert_allclose(mu, np.asarray(mu_j), atol=1e-5)


def test_ops_route_matches_fused_route():
    """conv_impl='ops' (K1 per conv) computes the same function."""
    sd = load_pth(CKPTS["denoising-syn"])
    fused = build_model("denoising-syn")
    ops = build_model("denoising-syn", conv_impl="ops")
    for m in (fused, ops):
        m.load_state_dict(sd, strict=True)
    for hw in ((32, 32), (21, 27)):
        x = np.random.default_rng(3).random((1, *hw, 3), dtype=np.float32)
        assert not fused_head_supported(ops, x.shape)
        a, b = _port_forward(fused, x), _port_forward(ops, x)
        np.testing.assert_allclose(a[0], b[0], atol=1e-5)
        np.testing.assert_allclose(a[1], b[1], atol=2e-6)


def test_fused_gate():
    syn = build_model("denoising-syn")              # depth 3 -> mod 4
    assert fused_head_supported(syn, (1, 64, 64, 3))
    assert not fused_head_supported(syn, (1, 63, 64, 3))
    assert not fused_head_supported(syn, (1, 64, 66, 3))
    real = build_model("denoising-real")            # depth 4 -> mod 8
    assert not fused_head_supported(real, (1, 68, 64, 3))
    assert not fused_head_supported(VIRNet(extra_mode="down", **SMALL),
                                    (1, 64, 64, 3))
    with pytest.raises(ValueError):
        build_model("sisr")


def test_kernel_layout_is_cached_and_follows_the_weights():
    """The kernels' HWIO weights are built once, rebuilt when the weights
    are loaded, cast or updated in place, and differentiable while
    autograd records."""
    torch.manual_seed(0)
    m = VIRNet(**SMALL).eval()
    torch.manual_seed(1)
    other = VIRNet(**SMALL)
    with torch.inference_mode():
        p1 = m.SNet.kernel_params()
        assert m.SNet.kernel_params() is p1
        assert conv_hwio(m.RNet.tail) is conv_hwio(m.RNet.tail)
    m.load_state_dict(other.state_dict(), strict=True)
    with torch.inference_mode():
        p2 = m.SNet.kernel_params()
    assert p2 is not p1
    torch.testing.assert_close(p2["wms"][1],
                               hwio(other.SNet.mid_layer[2].weight),
                               atol=0, rtol=0)
    m.to(torch.bfloat16)
    with torch.inference_mode():
        assert m.SNet.kernel_params()["wms"].dtype == torch.bfloat16
    m.float()
    with torch.no_grad():
        m.RNet.tail.weight.add_(1.0)
        torch.testing.assert_close(conv_hwio(m.RNet.tail),
                                   hwio(m.RNet.tail.weight), atol=0, rtol=0)
    x = torch.from_numpy(np.random.default_rng(4).random(
        (1, 16, 16, 3), dtype=np.float32))
    m.SNet(x).sum().backward()
    assert m.SNet.mid_layer[0].weight.grad.abs().sum() > 0
