"""The SISR half of the port against the JAX package on the CPU in fp32:
KernelNet, DnCNN with noise_avg, VIRNetSR (every extra_mode, compact and
full conditioning), the three released SISR checkpoints, the SISR ELBO and
the on-device batch synthesis.  The random draws are made by the JAX side
(or numpy) and handed to the port, so no test depends on two RNG streams
agreeing."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virnet_tpu.convert import load_torch_checkpoint
from virnet_tpu.data import sisr_synth as jsynth
from virnet_tpu.losses import elbo as jelbo
from virnet_tpu.models import VIRNetSR as JaxVIRNetSR
from virnet_tpu.models import build_model as jax_build_model
from virnet_tpu.models.dncnn import DnCNN as JaxDnCNN
from virnet_tpu.models.knet import KernelNet as JaxKernelNet
from virnet_tpu_torch.convert import from_jax_params, load_pth
from virnet_tpu_torch.data import sisr_synth
from virnet_tpu_torch.losses import elbo
from virnet_tpu_torch.models import DnCNN, KernelNet, VIRNetSR, build_model

SMALL = dict(n_feat=(16, 24, 32), dep_S=3, dep_K=2, n_resblocks=1)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def test_kernelnet_matches_jax():
    """kinfo rtol 1e-5 (exp and tanh of a mean of conv outputs)."""
    x = np.random.default_rng(0).random((2, 24, 28, 3), dtype=np.float32)
    jm = JaxKernelNet(num_blocks=2)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = jm.apply({"params": params}, jnp.asarray(x))
    sd = from_jax_params(dict(
        snet=dict(conv1=dict(kernel=np.zeros((3, 3, 3, 64))),
                  conv_last=dict(kernel=np.zeros((3, 3, 64, 1)))),
        rnet=dict(head=dict(kernel=np.zeros((3, 3, 3, 8))),
                  tail=dict(kernel=np.zeros((3, 3, 8, 3)))),
        knet=_np_tree(params)))
    tm = KernelNet(num_blocks=2)
    tm.load_state_dict(_sub(sd, "KNet."), strict=True)
    with torch.inference_mode():
        got = tm(_t(x))
    assert got.shape == (2, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("conv_impl", ["fused", "torch"])
def test_dncnn_noise_avg_matches_jax(conv_impl):
    """Logits averaged over H and W, keepdims: atol 2e-6."""
    x = np.random.default_rng(1).random((2, 15, 18, 3), dtype=np.float32)
    jm = JaxDnCNN(out_channels=1, dep=4, noise_avg=True)
    params = _np_tree(jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    want = jm.apply({"params": params}, jnp.asarray(x))
    sd = {}
    for name, key in (("conv1", "conv1"), ("mid_1", "mid_layer.0"),
                      ("mid_2", "mid_layer.2"), ("conv_last", "conv_last")):
        sd[f"{key}.weight"] = _t(params[name]["kernel"].transpose(3, 2, 0, 1))
        sd[f"{key}.bias"] = _t(params[name]["bias"])
    tm = DnCNN(3, 1, 4, conv_impl=conv_impl, noise_avg=True)
    tm.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        got = tm(_t(x))
    assert got.shape == (2, 1, 1, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


@pytest.mark.parametrize("extra_mode", ["null", "input", "down", "both"])
@pytest.mark.parametrize("noise_avg", [True, False],
                         ids=["compact", "full"])
def test_small_virnetsr_matches_jax(extra_mode, noise_avg):
    """mu atol 1e-5, sigma and kinfo rtol 1e-5 (kinfo with atol 1e-7 beside
    it: rho = tanh(.) may lie near 0); 13x14 at sf 2 pads inside
    RNet (26x28 to a multiple of 4), and ``noise_avg`` switches between the
    compact (N, 1, 1, E) conditioning and full maps."""
    x = np.random.default_rng(2).random((2, 13, 14, 3), dtype=np.float32)
    kw = dict(extra_mode=extra_mode, noise_avg=noise_avg, **SMALL)
    jm = JaxVIRNetSR(**kw)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x), 2)["params"]
    mu_j, k_j, s_j = jm.apply({"params": params}, jnp.asarray(x), 2)
    for conv_impl in ("fused", "torch"):
        tm = VIRNetSR(conv_impl=conv_impl, **kw)
        tm.load_state_dict(from_jax_params(_np_tree(params)), strict=True)
        with torch.inference_mode():
            mu, kinfo, sigma = tm(_t(x), 2)
        assert mu.shape == (2, 26, 28, 3)
        assert sigma.shape == ((2, 1, 1, 1) if noise_avg else (2, 13, 14, 1))
        np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), atol=1e-5)
        np.testing.assert_allclose(kinfo.numpy(), np.asarray(k_j), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(sigma.numpy(), np.asarray(s_j), rtol=1e-5)


def test_virnetsr_without_conditioning():
    """noise_cond and kernel_cond off: RNet runs unconditioned."""
    x = np.random.default_rng(3).random((1, 12, 12, 3), dtype=np.float32)
    kw = dict(noise_cond=False, kernel_cond=False, **SMALL)
    jm = JaxVIRNetSR(**kw)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x), 3)["params"]
    mu_j, _, _ = jm.apply({"params": params}, jnp.asarray(x), 3)
    tm = VIRNetSR(**kw)
    tm.load_state_dict(from_jax_params(_np_tree(params)), strict=True)
    with torch.inference_mode():
        mu, _, _ = tm(_t(x), 3)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), atol=1e-5)


@pytest.mark.parametrize("sf", [2, 3, 4])
def test_sisr_presets_load_strict_and_match_jax(sf):
    """model_zoo/virnet_sisr_x{sf}_demo.pth loads with strict=True and
    gives what the JAX VIRNetSR gives on convert_state_dict of the same
    file: mu atol 1e-5, sigma and kinfo rtol 1e-5 (kinfo with atol 1e-7
    beside it: rho = tanh(.) may lie near 0)."""
    path = f"model_zoo/virnet_sisr_x{sf}_demo.pth"
    model = build_model("sisr")
    model.load_state_dict(load_pth(path), strict=True)
    model.eval()
    jm = jax_build_model("sisr")
    params = load_torch_checkpoint(path, jm)["params"]
    x = np.random.default_rng(4).random((1, 17, 20, 3), dtype=np.float32)
    mu_j, k_j, s_j = jm.apply({"params": params}, jnp.asarray(x), sf)
    with torch.inference_mode():
        mu, kinfo, sigma = model(_t(x), sf)
    assert mu.shape == (1, 17 * sf, 20 * sf, 3)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), atol=1e-5)
    np.testing.assert_allclose(kinfo.numpy(), np.asarray(k_j), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(s_j), rtol=1e-5)


def test_kl_terms_match_jax():
    rng = np.random.default_rng(5)
    a = (rng.random((2, 1, 1, 1)) + 0.1).astype(np.float32)
    b = (rng.random((2, 1, 1, 1)) + 0.1).astype(np.float32)
    np.testing.assert_allclose(
        float(elbo.kl_inverse_gamma(_t(a), 39.5, _t(b))),
        float(jelbo.kl_inverse_gamma(jnp.asarray(a), 39.5, jnp.asarray(b))),
        rtol=1e-5)
    mu, gt = rng.random((2, 8, 8, 3)), rng.random((2, 8, 8, 3))
    np.testing.assert_allclose(
        float(elbo.kl_gauss(_t(mu.astype(np.float32)),
                            _t(gt.astype(np.float32)), 1e-5)),
        float(jelbo.kl_gauss(jnp.asarray(mu, jnp.float32),
                             jnp.asarray(gt, jnp.float32), 1e-5)), rtol=1e-5)


def _jax_elbo_draws(key, n, kappa0, mu_shape):
    """The draws of virnet_tpu/losses/elbo.py for ``key``, made as
    elbo_sisr (:148, :167), reparam_cov_mat (:95-103) and likelihood_sisr
    (:119) make them, for one mu."""
    k_cov_key, lh_key = jax.random.split(key)
    k_ig, k_rho = jax.random.split(k_cov_key)
    gamma_draw = jax.random.gamma(k_ig, jnp.full((n, 2), kappa0 - 1.0))
    rho_eps = jax.random.normal(k_rho, (n,), jnp.float32)
    z_eps = jax.random.normal(jax.random.split(lh_key, 1)[0], mu_shape,
                              jnp.float32)
    return dict(gamma_draw=_t(gamma_draw), rho_eps=_t(rho_eps),
                z_eps=_t(z_eps))


@pytest.mark.parametrize("sf,k_size,shift,downsampler", [
    (2, 5, False, "bicubic"), (4, 7, True, "bicubic"), (2, 7, False, "direct")])
def test_elbo_sisr_matches_jax(sf, k_size, shift, downsampler):
    """Loss and every aux scalar rtol 1e-5, the resampled kernels atol
    1e-7, gradients wrt mu, sigma and kinfo 1e-4 of each tensor's max."""
    rng = np.random.default_rng(6)
    n, hr = 2, 32
    im_hr = rng.random((n, hr, hr, 3), dtype=np.float32)
    im_lr = rng.random((n, hr // sf, hr // sf, 3), dtype=np.float32)
    mu = (im_hr + 0.01 * rng.standard_normal(im_hr.shape)).astype(np.float32)
    sigma = (1e-3 * (1 + rng.random((n, 1, 1, 1)))).astype(np.float32)
    kinfo = np.array([[1.5, 0.9, 0.2], [0.6, 2.5, -0.4]], np.float32)
    kinfo_gt = np.array([[1.2, 1.0, 0.1], [0.8, 2.0, -0.3]], np.float32)
    prior = ((rng.random((n, 1, 1, 1)) * 10 / 255) ** 2).astype(np.float32)
    alpha0, kappa0, r2, eps2, pen = 40.5, 50.0, 1e-4, 1e-5, (0.02, 2.0)
    key = jax.random.PRNGKey(7)

    def jloss(mu, sigma, kinfo):
        return jelbo.elbo_sisr(key, mu, sigma, kinfo, jnp.asarray(im_hr),
                               jnp.asarray(im_lr), jnp.asarray(prior), alpha0,
                               jnp.asarray(kinfo_gt), kappa0, r2, eps2, sf,
                               k_size, pen, shift, downsampler)

    (loss_j, aux_j), grads_j = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(mu), jnp.asarray(sigma), jnp.asarray(kinfo))

    ts = [_t(mu, True), _t(sigma, True), _t(kinfo, True)]
    loss, aux = elbo.elbo_sisr(
        *ts, _t(im_hr), _t(im_lr), _t(prior), alpha0, _t(kinfo_gt), kappa0,
        r2, eps2, sf, k_size, pen, shift, downsampler,
        noise=_jax_elbo_draws(key, n, kappa0, mu.shape))
    assert sorted(aux) == sorted(aux_j)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    for name in aux_j:
        if name != "kernel":
            np.testing.assert_allclose(float(aux[name].detach()),
                                       float(aux_j[name]), rtol=1e-5,
                                       err_msg=name)
    np.testing.assert_allclose(aux["kernel"].detach().numpy(),
                               np.asarray(aux_j["kernel"]), atol=1e-7)
    grads = torch.autograd.grad(loss, ts)
    for got, want, name in zip(grads, grads_j, ("mu", "sigma", "kinfo")):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=name)


def test_elbo_sisr_with_a_generator_is_reproducible():
    """With a generator instead of injected draws: finite, the same for the
    same seed, different for another, and the Gamma draw carries no
    gradient path of its own (the loss still reaches kinfo)."""
    rng = np.random.default_rng(8)
    im_hr = _t(rng.random((2, 16, 16, 3), dtype=np.float32))
    im_lr = _t(rng.random((2, 8, 8, 3), dtype=np.float32))
    kinfo = _t(np.array([[1.5, 0.9, 0.2], [0.6, 2.5, -0.4]], np.float32), True)
    sigma = _t(np.full((2, 1, 1, 1), 1e-3, np.float32))

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return elbo.elbo_sisr(im_hr, sigma, kinfo, im_hr, im_lr, sigma, 40.5,
                              kinfo.detach(), 50.0, 1e-4, 1e-5, 2, 5,
                              (0.02, 2.0), False, "bicubic", generator=g)[0]

    a, b, c = run(1), run(1), run(2)
    assert torch.isfinite(a) and torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(torch.autograd.grad(a, kinfo)[0]).all()
    draw = elbo.reparam_inv_gamma(torch.full((4000,), 49.0), torch.ones(4000),
                                  torch.Generator().manual_seed(3))
    # E[1/Gamma(49, 1)] = 1/48
    assert abs(float(draw.mean()) - 1 / 48) < 2e-4


def _jax_synth_draws(key, n, sf, lr_shape, noise_level):
    """The draws of virnet_tpu/data/sisr_synth.py for ``key`` (:116,
    :49-55, :127-136)."""
    k_ker, k_nl, k_noise = jax.random.split(key, 3)
    k1, k2, k3, k4 = jax.random.split(k_ker, 4)
    return dict(
        lam1=_t(jax.random.uniform(k1, (n,), minval=0.2, maxval=float(sf))),
        lam2_u=_t(jax.random.uniform(k2, (n,), minval=0.0, maxval=1.0)),
        iso_u=_t(jax.random.uniform(k3, (n,))),
        theta=_t(jax.random.uniform(k4, (n,), minval=0.0, maxval=math.pi)),
        nlevel=_t(jax.random.uniform(k_nl, (n, 1, 1, 1),
                                     minval=noise_level[0] / 255.0,
                                     maxval=noise_level[1] / 255.0)
                  ).reshape(n),
        noise=_t(jax.random.normal(k_noise, lr_shape, jnp.float32)))


@pytest.mark.parametrize("sf,k_size,shift,downsampler", [
    (2, 5, False, "bicubic"), (4, 7, True, "bicubic"), (3, 7, False, "direct")])
def test_synthesize_sisr_batch_matches_jax(sf, k_size, shift, downsampler):
    """Every field of the batch atol 1e-5, with the JAX function's draws
    (symmetric padding, true convolution, transposed kernel, clip before
    the downsample)."""
    n, hr = 4, 24
    im_hr = np.random.default_rng(9).random((n, hr, hr, 3), dtype=np.float32)
    key = jax.random.PRNGKey(10)
    want = jsynth.synthesize_sisr_batch(key, jnp.asarray(im_hr), sf, k_size,
                                        shift, downsampler, (0.1, 15.0))
    draws = _jax_synth_draws(key, n, sf, want.im_lr.shape, (0.1, 15.0))
    got = sisr_synth.synthesize_sisr_batch(_t(im_hr), sf, k_size, shift,
                                           downsampler, (0.1, 15.0),
                                           draws=draws)
    assert got.nlevel.shape == (n, 1)
    for name in ("im_hr", "im_lr", "im_blur", "kinfo", "nlevel"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-5, err_msg=name)


def test_synthesize_sisr_batch_with_a_generator():
    im_hr = _t(np.random.default_rng(11).random((8, 16, 16, 3),
                                                dtype=np.float32))
    g = torch.Generator().manual_seed(0)
    a = sisr_synth.synthesize_sisr_batch(im_hr, 2, 5, generator=g)
    b = sisr_synth.synthesize_sisr_batch(
        im_hr, 2, 5, generator=torch.Generator().manual_seed(0))
    assert a.im_lr.shape == (8, 8, 8, 3) and a.kinfo.shape == (8, 3)
    assert torch.equal(a.im_lr, b.im_lr) and not a.im_lr.requires_grad
    assert float(a.im_lr.min()) >= 0 and float(a.im_lr.max()) <= 1
    assert (a.kinfo[:, :2] > 0).all() and (a.kinfo[:, 2].abs() <= 1).all()
    lo, hi = 0.1 / 255, 15.0 / 255
    assert ((a.nlevel >= lo) & (a.nlevel <= hi)).all()
    # the JPEG branch: its draws follow all the others, so the kernels and
    # the Gaussian std of a JPEG run are those of the Gaussian-only run
    j = sisr_synth.synthesize_sisr_batch(
        im_hr, 2, 5, add_jpeg=True, generator=torch.Generator().manual_seed(0))
    assert torch.equal(j.kinfo, a.kinfo) and torch.equal(j.im_blur, a.im_blur)
    assert float(j.im_lr.min()) >= 0 and float(j.im_lr.max()) <= 1
    jpeg = (j.nlevel != a.nlevel).view(-1)
    # a JPEG sample lands on the uint8 grid; a Gaussian one keeps its std
    on_grid = (j.im_lr * 255 - torch.round(j.im_lr * 255)).abs().amax(
        (1, 2, 3)) < 1e-4
    assert bool(on_grid[jpeg].all()) and 0 < int(jpeg.sum()) < 8
