"""The denoising training path of the port against the JAX package on the
CPU in fp32: the denoising ELBO (value and gradients), the sigma^2 prior
filter, on-device noise synthesis and MixUp given the JAX package's own
draws, the paired patch sampler, one whole training step (synthetic and
real), bitwise checkpoint resume, and the two trainer CLIs."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virnet_tpu.data import denoise_synth as jsynth
from virnet_tpu.data.mixup import mixup_pairs as jax_mixup_pairs
from virnet_tpu.losses import elbo_denoising as jax_elbo_denoising
from virnet_tpu.models import VIRNet as JaxVIRNet
from virnet_tpu.ops.degrade import noise_estimate as jax_noise_estimate
from virnet_tpu.precision import compute_dtype, precision
from virnet_tpu_torch import config
from virnet_tpu_torch.convert import from_jax_params
from virnet_tpu_torch.data import denoise_synth as synth
from virnet_tpu_torch.data.mixup import mixup_pairs
from virnet_tpu_torch.losses.elbo import elbo_denoising
from virnet_tpu_torch.ops.degrade import blur_shared, noise_estimate
from virnet_tpu_torch.train.checkpoint import CheckpointManager
from virnet_tpu_torch.train.loop_denoise import (DenoiseTrainConfig,
                                                 DenoiseTrainer)
from test_torch_port_shared import _one_thread  # noqa: F401 (autouse)

SMALL = dict(n_feat=(16, 24, 32), dep_S=3, n_resblocks=1, batch_size=2,
             patch_size=32, mixed_precision=False)


def _t(a):
    return torch.tensor(np.asarray(a))


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


# ----------------------------------------------------------------- the ELBO

@pytest.mark.parametrize("n_mu", [1, 2], ids=["one-mu", "list-mu"])
@pytest.mark.parametrize("sigma_chn", [1, 3])
def test_elbo_denoising_value_and_grads_match_jax(sigma_chn, n_mu):
    """loss, lh, KL terms rtol 1e-5; d loss / d mu and d loss / d sigma
    rtol 1e-5 of their max (log and digamma in float64 here, float32
    there)."""
    rng = np.random.default_rng(0)
    shape = (2, 12, 10, 3)
    gt = rng.random(shape, dtype=np.float32)
    noisy = (gt + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    mus = [(gt + 0.02 * rng.standard_normal(shape)).astype(np.float32)
           for _ in range(n_mu)]
    sigma = (rng.random((2, 12, 10, sigma_chn)) * 0.02 + 1e-3).astype(
        np.float32)
    prior = (rng.random((2, 12, 10, 1)) * 0.02 + 1e-3).astype(np.float32)
    eps2, alpha0 = 1e-6, 24.5

    def jax_loss(mu_list, sig):
        mu = mu_list if n_mu > 1 else mu_list[0]
        return jax_elbo_denoising(mu, sig, jnp.asarray(noisy),
                                  jnp.asarray(gt), eps2, alpha0,
                                  alpha0 * jnp.asarray(prior))

    want = jax_loss([jnp.asarray(m) for m in mus], jnp.asarray(sigma))
    g_mu, g_sig = jax.grad(lambda m, s: jax_loss(m, s)[0], argnums=(0, 1))(
        [jnp.asarray(m) for m in mus], jnp.asarray(sigma))

    mu_t = [_t(m).requires_grad_() for m in mus]
    sig_t = _t(sigma).requires_grad_()
    got = elbo_denoising(mu_t if n_mu > 1 else mu_t[0], sig_t, _t(noisy),
                         _t(gt), eps2, alpha0, alpha0 * _t(prior))
    for g, w, name in zip(got, want, ("loss", "lh", "klg", "klig")):
        np.testing.assert_allclose(float(g.detach()), float(w), rtol=1e-5,
                                   err_msg=name)
    got[0].backward()
    for g, w in zip(mu_t + [sig_t], list(g_mu) + [g_sig]):
        w = np.asarray(w)
        np.testing.assert_allclose(g.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()))


@pytest.mark.parametrize("shape,k", [((2, 24, 20, 3), 7), ((1, 16, 16, 1), 5)])
def test_noise_estimate_matches_jax(shape, k):
    """The sigma^2 prior of real-noise training: atol 1e-6 on values below
    0.1 (k*k products summed in another order), and the clamp at 1e-10."""
    rng = np.random.default_rng(1)
    gt = rng.random(shape, dtype=np.float32)
    noisy = (gt + 0.2 * rng.standard_normal(shape)).astype(np.float32)
    noisy[0, :8, :8] = gt[0, :8, :8]           # a flat-zero residual patch
    want = np.asarray(jax_noise_estimate(jnp.asarray(noisy), jnp.asarray(gt),
                                         k))
    got = noise_estimate(_t(noisy), _t(gt), k).numpy()
    assert got.shape == shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert got.min() == np.float32(1e-10) == want.min()
    kern = torch.zeros(3, 3)
    kern[1, 1] = 1.0
    torch.testing.assert_close(blur_shared(_t(gt), kern), _t(gt))


# ------------------------------------------------------------ the synthesis

def _jax_synth_draws(key, batch, patch, shape, mode):
    """The draws of virnet_tpu/data/denoise_synth.py for ``key``
    (synthesize_noisy_batch :63, generate_sigma_niid :29-34,
    generate_sigma_iid :53)."""
    k_sigma, k_noise = jax.random.split(key)
    draws = dict(eps=_t(jax.random.normal(k_noise, shape, jnp.float32)))
    if mode == "iid":
        draws["level"] = _t(jax.random.uniform(
            k_sigma, (batch, 1, 1, 1), maxval=jsynth.SIGMA_MAX))
        return draws
    k_center, k_scale, k_updown = jax.random.split(k_sigma, 3)
    draws.update(
        center=_t(jax.random.uniform(k_center, (batch, 2), minval=0.0,
                                     maxval=patch)),
        scale=_t(jax.random.uniform(k_scale, (batch, 1, 1),
                                    minval=patch / 4, maxval=patch / 4 * 3)),
        updown=_t(jax.random.uniform(k_updown, (batch, 2),
                                     maxval=jsynth.SIGMA_MAX)))
    return draws


@pytest.mark.parametrize("mode,clip", [("niid", False), ("niid", True),
                                       ("iid", False)])
def test_synthesize_noisy_batch_matches_jax_given_its_draws(mode, clip):
    """The sigma map, the noisy batch and the sigma^2 prior, atol 1e-6."""
    key = jax.random.PRNGKey(3)
    gt = np.random.default_rng(2).random((3, 24, 24, 3), dtype=np.float32)
    noisy_j, s2_j = jsynth.synthesize_noisy_batch(key, jnp.asarray(gt),
                                                  mode=mode, clip=clip)
    draws = _jax_synth_draws(key, 3, 24, gt.shape, mode)
    noisy, s2 = synth.synthesize_noisy_batch(_t(gt), mode=mode, clip=clip,
                                             draws=draws)
    np.testing.assert_allclose(noisy.numpy(), np.asarray(noisy_j), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(s2.numpy(), np.asarray(s2_j), atol=1e-6,
                               rtol=0)
    assert s2.shape == (3, 24, 24, 1)
    k_sigma = jax.random.split(key)[0]
    gen_j = (jsynth.generate_sigma_niid if mode == "niid"
             else jsynth.generate_sigma_iid)(k_sigma, 3, 24)
    gen = (synth.generate_sigma_niid if mode == "niid"
           else synth.generate_sigma_iid)(3, 24, draws=draws)
    np.testing.assert_allclose(gen.numpy(), np.asarray(gen_j), atol=1e-6,
                               rtol=0)


def test_synthesis_from_a_generator_is_seeded_and_in_range():
    gt = torch.rand(4, 16, 16, 3)
    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(11)
        outs.append(synth.synthesize_noisy_batch(gt, generator=g))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    sigma = outs[0][1].sqrt()
    assert float(sigma.min()) >= 0 and float(sigma.max()) <= 80.0 / 255 + 1e-6
    # a bump: not constant within a sample, unlike the iid mode
    assert float((sigma.amax((1, 2)) - sigma.amin((1, 2))).min()) > 0
    iid = synth.generate_sigma_iid(4, 16, torch.Generator().manual_seed(1))
    assert iid.shape == (4, 16, 16, 1)
    assert float((iid.amax((1, 2)) - iid.amin((1, 2))).max()) == 0
    with pytest.raises(ValueError):
        synth.synthesize_noisy_batch(gt, mode="poisson")


def test_mixup_pairs_matches_jax_given_its_draws():
    key = jax.random.PRNGKey(4)
    rng = np.random.default_rng(3)
    gt = rng.random((5, 8, 8, 3), dtype=np.float32)
    noisy = rng.random((5, 8, 8, 3), dtype=np.float32)
    gt_j, noisy_j = jax_mixup_pairs(key, jnp.asarray(gt), jnp.asarray(noisy))
    k_perm, k_lam = jax.random.split(key)
    indices = _t(jax.random.permutation(k_perm, 5)).long()
    lam = _t(jax.random.beta(k_lam, 0.6, 0.6, (5, 1, 1, 1),
                             dtype=jnp.float32))
    gt_m, noisy_m = mixup_pairs(_t(gt), _t(noisy), draws=(indices, lam))
    np.testing.assert_allclose(gt_m.numpy(), np.asarray(gt_j), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(noisy_m.numpy(), np.asarray(noisy_j),
                               atol=1e-6, rtol=0)


def test_mixup_pairs_from_a_generator():
    """Seeded, the same coefficient and partner for gt and noisy, and
    Beta(0.6, 0.6)'s U shape: most of the mass near 0 and 1."""
    n = 4000
    gt = (torch.arange(n, dtype=torch.float32) / n).view(n, 1, 1, 1)
    noisy = gt + 0.5
    a = mixup_pairs(gt, noisy, generator=torch.Generator().manual_seed(5))
    b = mixup_pairs(gt, noisy, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    torch.testing.assert_close(a[1] - a[0], torch.full_like(gt, 0.5),
                               atol=1e-6, rtol=0)
    # lam itself: mix a one-hot batch with zeros at the partner
    eye = torch.eye(n).view(n, n, 1, 1)
    mixed, _ = mixup_pairs(eye, eye, generator=torch.Generator().manual_seed(7))
    lam = torch.diagonal(mixed[:, :, 0, 0])
    lam = lam[lam < 1.0]                        # drop self-partnered rows
    assert 0.0 < float(lam.min()) and float(lam.max()) < 1.0
    assert abs(float(lam.mean()) - 0.5) < 0.03
    assert float(((lam < 0.1) | (lam > 0.9)).float().mean()) > 0.3


def _paired_folders(tmp_path, rng, n=3, size=(40, 48)):
    import cv2

    root = tmp_path / "patches"
    (root / "noisy").mkdir(parents=True)
    (root / "gt").mkdir()
    for i in range(n):
        gt = (rng.random((*size, 3)) * 255).astype(np.uint8)
        noisy = np.clip(gt + rng.normal(0, 12, gt.shape), 0, 255).astype(
            np.uint8)
        cv2.imwrite(str(root / "gt" / f"sidd_{i}.png"), gt)
        cv2.imwrite(str(root / "noisy" / f"sidd_{i}.png"), noisy)
    return root / "noisy"


def test_paired_patch_sampler_matches_jax_package(tmp_path):
    from virnet_tpu.data import sources as jsources
    from virnet_tpu_torch.data import sources

    noisy_dir = _paired_folders(tmp_path, np.random.default_rng(6))
    a = sources.PairedPatchSampler(noisy_dir, 16, seed=3)
    b = jsources.PairedPatchSampler(noisy_dir, 16, seed=3)
    for (xa, xb) in zip(a.sample(4, raw=True), b.sample(4, raw=True)):
        assert xa.dtype == np.uint8
        np.testing.assert_array_equal(xa, xb)
    a.reset_seed(7)
    b.reset_seed(7)
    for (xa, xb) in zip(a.sample(3), b.sample(3)):
        np.testing.assert_array_equal(xa, xb)
    assert len(a.noisy) == len(a.gt) == 3


# ------------------------------------------------------------ the whole step

def _jax_step(cfg, real, batch, key):
    """loss, aux and gradients of the JAX trainer's loss_fn
    (virnet_tpu/train/loop_denoise.py:134-156) with mixed_precision off."""
    jm = JaxVIRNet(im_chn=cfg.im_chn, sigma_chn=cfg.sigma_chn,
                   n_feat=cfg.n_feat, dep_S=cfg.dep_S,
                   n_resblocks=cfg.n_resblocks, noise_cond=cfg.noise_cond,
                   extra_mode=cfg.extra_mode, noise_avg=False)
    p = cfg.patch_size
    params = jm.init(jax.random.PRNGKey(cfg.seed),
                     jnp.zeros((1, p, p, cfg.im_chn)))["params"]
    alpha0 = 0.5 * float(cfg.var_window) ** 2

    def loss_fn(params, batch, key):
        if real:
            im_noisy, im_gt = batch
            if cfg.use_mixup:
                key, k_mix = jax.random.split(key)
                im_gt, im_noisy = jax_mixup_pairs(k_mix, im_gt, im_noisy)
            sigma_gt = jax_noise_estimate(im_noisy, im_gt, cfg.var_window)
        else:
            im_gt = batch
            im_noisy, sigma_gt = jsynth.synthesize_noisy_batch(
                key, im_gt, mode=cfg.noise_mode)
        beta0 = alpha0 * sigma_gt
        with compute_dtype(None), precision("highest"):
            mu, sigma = jm.apply({"params": params}, im_noisy)
        loss, lh, klg, klig = jax_elbo_denoising(
            mu.astype(jnp.float32), sigma.astype(jnp.float32), im_noisy,
            im_gt, cfg.eps2, alpha0, beta0)
        return loss, dict(lh=lh, kl_gauss=klg, kl_ig=klig)

    batch = jax.tree.map(jnp.asarray, batch)
    (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params, batch, key)
    return params, loss, aux, grads


def _check_step(tr, params, loss_j, aux_j, grads_j, batch, noise):
    import optax

    assert tr.model.conv_impl == "torch"
    tr.model.load_state_dict(from_jax_params(_np_tree(params)), strict=True)
    loss, aux = tr.loss_and_grads(batch, 0, noise)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    for name, want in aux_j.items():
        np.testing.assert_allclose(float(aux[name]), float(want), rtol=1e-5,
                                   err_msg=name)
    want_sd = from_jax_params(_np_tree(grads_j))
    named = dict(tr.model.named_parameters())
    assert sorted(named) == sorted(want_sd)
    for name, p in named.items():
        want = want_sd[name].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), want, rtol=0,
            atol=1e-3 * float(np.abs(want).max()) + 1e-12, err_msg=name)
    out = tr.run_step(batch, 0, noise)
    assert tr.step == 1
    assert sorted(out) == ["gnorm_r", "gnorm_s", "kl_gauss", "kl_ig", "lh",
                           "loss"]
    for key, sub in (("gnorm_r", "rnet"), ("gnorm_s", "snet")):
        np.testing.assert_allclose(
            float(out[key]), float(optax.global_norm(grads_j[sub])),
            rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("mode", ["niid", "iid"])
def test_synthetic_training_step_matches_jax(mode, tmp_path):
    """The path as a whole, synthetic noise: synthesis from the JAX key's
    draws, model, ELBO and backward.  Loss and terms rtol 1e-5, every
    parameter's gradient 1e-3 of its max, gradient norms rtol 1e-4."""
    cfg = DenoiseTrainConfig(noise_mode=mode, save_dir=str(tmp_path), **SMALL)
    gt = np.random.default_rng(7).random((2, 32, 32, 3), dtype=np.float32)
    key = jax.random.PRNGKey(8)
    params, loss_j, aux_j, grads_j = _jax_step(cfg, False, gt, key)
    tr = DenoiseTrainer(cfg, device="cpu")
    noise = dict(synth=_jax_synth_draws(key, 2, 32, gt.shape, mode))
    _check_step(tr, params, loss_j, aux_j, grads_j, gt, noise)


@pytest.mark.parametrize("use_mixup", [True, False], ids=["mixup", "plain"])
def test_real_training_step_matches_jax(use_mixup, tmp_path):
    """The path as a whole, real noise: (noisy, gt) pairs, MixUp from the
    JAX key's draws, the residual-filter prior, three sigma channels."""
    cfg = DenoiseTrainConfig(sigma_chn=3, use_mixup=use_mixup,
                             save_dir=str(tmp_path), **SMALL)
    rng = np.random.default_rng(9)
    gt = rng.random((2, 32, 32, 3), dtype=np.float32)
    noisy = np.clip(gt + 0.08 * rng.standard_normal(gt.shape), 0, 1).astype(
        np.float32)
    key = jax.random.PRNGKey(10)
    params, loss_j, aux_j, grads_j = _jax_step(cfg, True, (noisy, gt), key)
    k_perm, k_lam = jax.random.split(jax.random.split(key)[1])
    noise = dict(mixup=(
        _t(jax.random.permutation(k_perm, 2)).long(),
        _t(jax.random.beta(k_lam, 0.6, 0.6, (2, 1, 1, 1),
                           dtype=jnp.float32))))
    tr = DenoiseTrainer(cfg, real=True, device="cpu")
    _check_step(tr, params, loss_j, aux_j, grads_j, (noisy, gt), noise)


def test_training_lowers_the_elbo_from_uint8_batches(tmp_path):
    """uint8 in, normalised on the device; finite scalars; the ELBO on a
    fixed batch with fixed draws is lower after 8 steps."""
    cfg = DenoiseTrainConfig(save_dir=str(tmp_path), **SMALL)
    tr = DenoiseTrainer(cfg, device="cpu")
    rng = np.random.default_rng(11)
    gt8 = (rng.random((2, 32, 32, 3)) * 255).astype(np.uint8)
    fixed = dict(synth=_jax_synth_draws(jax.random.PRNGKey(1), 2, 32,
                                        gt8.shape, "niid"))
    before = float(tr.loss_and_grads(gt8, 0, fixed)[0])
    for _ in range(8):
        out = tr.run_step(gt8, 0)
        assert all(np.isfinite(float(v)) for v in out.values())
    assert float(tr.loss_and_grads(gt8, 0, fixed)[0]) < before


@pytest.mark.parametrize("real", [False, True], ids=["syn", "real"])
def test_checkpoint_resume_is_bitwise(real, tmp_path):
    """2 steps, save, 2 steps, against restore + 2 steps: the same bits in
    every parameter, Adam moment and returned scalar, on the CPU (the
    generator's draws included: synthesis, or MixUp)."""
    cfg = DenoiseTrainConfig(steps_per_epoch=2, save_dir=str(tmp_path / "a"),
                             **SMALL)
    rng = np.random.default_rng(12)

    def batch():
        gt = rng.random((2, 32, 32, 3), dtype=np.float32)
        if not real:
            return gt
        return ((gt + 0.05 * rng.standard_normal(gt.shape)).astype(
            np.float32), gt)

    batches = [batch() for _ in range(4)]
    a = DenoiseTrainer(cfg, real=real, device="cpu")
    for i in range(2):
        a.run_step(batches[i], 0)
    a.save(0)
    outs_a = [a.run_step(batches[i], 1) for i in (2, 3)]

    b = DenoiseTrainer(cfg, real=real, device="cpu")
    assert b.restore() == 1 and b.step == 2
    outs_b = [b.run_step(batches[i], 1) for i in (2, 3)]
    for oa, ob in zip(outs_a, outs_b):
        for k in oa:
            assert torch.equal(oa[k], ob[k]), k
    for (n, pa), (_, pb) in zip(a.model.named_parameters(),
                                b.model.named_parameters()):
        assert torch.equal(pa, pb), n
    sa, sb = a.optim.state_dict()["adam"], b.optim.state_dict()["adam"]
    for idx, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][idx][k]), (idx, k)
    assert a.optim.count == b.optim.count == 4
    fresh = DenoiseTrainer(DenoiseTrainConfig(
        save_dir=str(tmp_path / "none"), **SMALL), device="cpu")
    assert fresh.restore() == 0


# ------------------------------------------------------------------ the CLIs

@pytest.mark.parametrize("name", ["denoising_syn", "denoising_real"])
def test_build_trainer_takes_the_repo_configs(name, tmp_path):
    """The two CLIs' defaults differ as in the JAX package (warmup 5 vs
    10, clip_grad_R 1e3 vs 5e2); no card here, so the default device
    raises."""
    import importlib

    cli = importlib.import_module(f"virnet_tpu_torch.cli.train_{name}")
    cfg = config.load_config(f"configs/{name}.json")
    cfg.update(save_dir=str(tmp_path), n_feat=[16, 24, 32], dep_S=3,
               batch_size=2, patch_size=32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.build_trainer(cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DenoiseTrainer(DenoiseTrainConfig(save_dir=str(tmp_path)))
    for k in ("warmup_epochs", "clip_grad_R"):
        cfg.pop(k)
    tr = cli.build_trainer(cfg, device="cpu")
    real = name == "denoising_real"
    assert tr.real is real and tr.model.conv_impl == "torch"
    assert (tr.cfg.warmup_epochs, tr.cfg.clip_grad_R, tr.cfg.sigma_chn,
            tr.cfg.extra_mode, tr.cfg.mixed_precision) == (
                (10, 5e2, 3, "input", True) if real
                else (5, 1e3, 1, "input", True))
    assert tr.alpha0 == 24.5
    assert tr.schedule(0) == pytest.approx(1e-4 / (10 if real else 5))


def _tiny_cfg(tmp_path, extra=""):
    path = tmp_path / "cfg.json"
    path.write_text("""{
        # a tiny configuration
        "im_chn": 3, "patch_size": 32, "batch_size": 2, "epochs": 2,
        "steps_per_epoch": 2, "lr": 1e-4, "print_freq": 1,
        "save_dir": "unused", "dep_S": 3, "n_feat": [16, 24, 32],
        "n_resblocks": 1, "extra_mode": "Input", "noise_cond": true,
        "mixed_precision": "False", %s
        "var_window": 7  // comment
    }""" % extra)
    return path


def test_syn_cli_trains_and_resumes_from_a_folder_of_images(tmp_path):
    import cv2

    from virnet_tpu_torch.cli.train_denoising_syn import main

    rng = np.random.default_rng(13)
    im_dir = tmp_path / "images"
    im_dir.mkdir()
    for i in range(3):
        cv2.imwrite(str(im_dir / f"{i}.png"),
                    (rng.random((40, 48, 3)) * 255).astype(np.uint8))
    cfg = _tiny_cfg(tmp_path, '"sigma_chn": 1, "train_data": [["%s", '
                    '"*.png"]], "val_data": "%s",'
                    % (im_dir, tmp_path / "no_val"))
    save = tmp_path / "run"
    main(["--config", str(cfg), "--save_dir", str(save), "--device", "cpu",
          "--epochs", "1"])
    assert CheckpointManager(save).steps() == [1]
    main(["--config", str(cfg), "--save_dir", str(save), "--device", "cpu",
          "--resume", "latest"])
    assert CheckpointManager(save).steps() == [1, 2]
    log = (save / "train.log").read_text()
    assert "resumed at epoch 1, step 2" in log and "KLIG=" in log
    assert "GNorm_R=" in log and log.count("Number of training images: 3") == 2
    with pytest.raises(SystemExit):
        main(["--config", str(_tiny_cfg(
            tmp_path, '"sigma_chn": 1, "train_data": [["%s", "*.jpg"]],'
            % im_dir)), "--save_dir", str(tmp_path / "none"), "--device",
            "cpu"])


def test_real_cli_trains_and_resumes_from_paired_folders(tmp_path):
    from virnet_tpu_torch.cli.train_denoising_real import main

    noisy_dir = _paired_folders(tmp_path, np.random.default_rng(14))
    cfg = _tiny_cfg(tmp_path, '"sigma_chn": 3, "train_pch_dir": "%s", '
                    '"test_noisy_path": "%s", "test_gt_path": "%s",'
                    % (noisy_dir, tmp_path / "n.mat", tmp_path / "g.mat"))
    save = tmp_path / "run"
    main(["--config", str(cfg), "--save_dir", str(save), "--device", "cpu",
          "--epochs", "1"])
    assert CheckpointManager(save).steps() == [1]
    main(["--config", str(cfg), "--save_dir", str(save), "--device", "cpu",
          "--resume", "1"])
    assert CheckpointManager(save).steps() == [1, 2]
    log = (save / "train.log").read_text()
    assert "resumed at epoch 1, step 2" in log
    assert "Number of training patch pairs: 3" in log
    assert "PSNR=" not in log                   # no .mat pair: no validation
    # with the SIDD validation pair there, the next epoch validates on it
    from scipy.io import savemat

    rng = np.random.default_rng(16)
    gt = (rng.random((2, 2, 24, 24, 3)) * 255).astype(np.uint8)
    noisy = np.clip(gt + rng.normal(0, 12, gt.shape), 0, 255).astype(np.uint8)
    savemat(str(tmp_path / "n.mat"), {"ValidationNoisyBlocksSrgb": noisy})
    savemat(str(tmp_path / "g.mat"), {"ValidationGtBlocksSrgb": gt})
    main(["--config", str(cfg), "--save_dir", str(save), "--device", "cpu",
          "--resume", "latest", "--epochs", "3"])
    assert CheckpointManager(save).steps() == [1, 2, 3]
    line = [x for x in (save / "train.log").read_text().splitlines()
            if "test: PSNR=" in x]
    assert len(line) == 1 and "SSIM=" in line[0], line
    assert np.isfinite(float(line[0].split("PSNR=")[1].split(",")[0]))


class _Reached(Exception):
    pass


@pytest.mark.parametrize("key,value,where", [
    ("multihost", "true", "mesh.py"),
    ("coordinator_address", '"localhost:1234"', "mesh.py"),
    ("auto_resume", "true", "resilience.py"),
    ("rss_limit_mb", "4096", "resilience.py"),
    ("num_processes", "2", "mesh.py"),
])
def test_clis_refuse_what_is_not_ported(key, value, where, tmp_path,
                                        monkeypatch):
    """Nothing of these keys is refused any more: in all three trainer
    CLIs each one reaches its module, caught at a seam: the multi-host
    keys train/mesh.init_multihost (through cli.common.
    maybe_init_multihost, before anything is built), ``auto_resume``
    train/resilience.run_with_auto_resume and ``rss_limit_mb`` the
    watchdog's re-exec command (train/resilience.reexec_argv)."""
    import cv2

    from virnet_tpu_torch.cli import (train_denoising_real,
                                      train_denoising_syn, train_sisr)
    from virnet_tpu_torch.train import mesh, resilience

    def reached(name):
        def seam(*args, **kwargs):
            raise _Reached(f"{name}.py {args} {kwargs}")
        return seam

    monkeypatch.setattr(mesh, "init_multihost", reached("mesh"))
    monkeypatch.setattr(resilience, "run_with_auto_resume",
                        reached("resilience"))
    monkeypatch.setattr(resilience, "reexec_argv", reached("resilience"))
    rng = np.random.default_rng(17)
    im_dir = tmp_path / "images"
    im_dir.mkdir()
    for i in range(2):
        cv2.imwrite(str(im_dir / f"{i}.png"),
                    (rng.random((40, 48, 3)) * 255).astype(np.uint8))
    cfg = _tiny_cfg(tmp_path, '"sigma_chn": 1, "%s": %s, "train_data": '
                    '[["%s", "*.png"]], "train_pch_dir": "%s", '
                    '"train_hr_patchs": "%s", "dep_K": 2, "sf": 2, '
                    '"hr_size": 32,' % (key, value, im_dir,
                                        _paired_folders(tmp_path, rng),
                                        im_dir))
    for cli in (train_denoising_syn, train_denoising_real, train_sisr):
        with pytest.raises(_Reached, match=where):
            cli.main(["--config", str(cfg), "--save_dir",
                      str(tmp_path / "run"), "--device", "cpu"])
    off = _tiny_cfg(tmp_path, '"sigma_chn": 1, "device_data": "False", '
                    '"rss_limit_mb": 0, "train_data": [],')
    with pytest.raises(SystemExit):             # gets as far as the data
        train_denoising_syn.main(["--config", str(off), "--save_dir",
                                  str(tmp_path / "run"), "--device", "cpu"])


def test_logging_grid_writer_and_lazy_exports(tmp_path):
    import virnet_tpu_torch as pkg
    from virnet_tpu.train.logging import _to_grid as jax_to_grid
    from virnet_tpu_torch.ops import _build
    from virnet_tpu_torch.train.logging import (TrainWriter, _to_grid,
                                                make_log)

    batch = np.random.default_rng(15).random((5, 6, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(_to_grid(batch), jax_to_grid(batch))
    np.testing.assert_array_equal(_to_grid(batch, normalize=False, pad=1),
                                  jax_to_grid(batch, normalize=False, pad=1))
    for _ in range(2):                          # a second call adds no handler
        logger = make_log(tmp_path / "x.log", name="virnet_tpu_torch.test")
    logger.info("one line")
    assert (tmp_path / "x.log").read_text().count("one line") == 1
    writer = TrainWriter(tmp_path / "logs")
    writer.scalar("Loss_epoch", 1.0, 0)
    writer.image_grid("grid", batch, 0)
    writer.close()
    assert (tmp_path / "logs").is_dir()
    for name in ("DenoiseTrainer", "DenoiseTrainConfig", "elbo_denoising",
                 "SISRTrainer"):
        assert getattr(pkg, name) is not None
    assert not _build._LIBS


def test_cli_messages_name_roadmap_items_by_title():
    """ROADMAP.md's queues are renumbered when they are re-anchored, so a
    message that cited an item by number would go stale.  The last such
    refusal, ``--compute int8``, is gone: the eval options take int8 and
    their help no longer calls it unported, and no string in the port's
    sources cites a ROADMAP item by number."""
    import argparse
    import ast
    import re

    from virnet_tpu_torch.cli import common

    p = argparse.ArgumentParser()
    common.add_eval_args(p)
    assert p.parse_args(["--compute", "int8"]).compute == "int8"
    assert "not ported" not in p.format_help()
    assert not hasattr(common, "refuse_unported_eval")
    root = Path(__file__).resolve().parents[1] / "virnet_tpu_torch"
    for f in sorted(root.rglob("*.py")):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value,
                                                             str):
                msg = node.value
                if "ROADMAP" in msg:
                    assert not re.search(r"\bitems?\s+\d", msg), (f, msg)
