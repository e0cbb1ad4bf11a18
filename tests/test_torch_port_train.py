"""The SISR training path of the port against the JAX package on the CPU
in fp32: one training step's loss and gradients (the path as a whole),
the optimizer stack against the optax chain, bitwise checkpoint resume,
the forward-only kernels' error and the ``conv_impl='torch'`` training
route, the config loader and the trainer CLI's plumbing."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from virnet_tpu import config as jconfig
from virnet_tpu.losses import elbo_sisr as jax_elbo_sisr
from virnet_tpu.models import VIRNetSR as JaxVIRNetSR
from virnet_tpu.train.optim import build_optimizer
from virnet_tpu_torch import config
from virnet_tpu_torch.convert import from_jax_params
from virnet_tpu_torch.models import VIRNet, VIRNetSR
from virnet_tpu_torch.ops import fused_conv as fc
from virnet_tpu_torch.train.checkpoint import CheckpointManager
from virnet_tpu_torch.train.loop_sisr import SISRTrainConfig, SISRTrainer
from virnet_tpu_torch.train.optim import (SubnetAdam,
                                          warmup_cosine_epoch_schedule)

SMALL = dict(n_feat=(16, 24, 32), dep_S=3, dep_K=2, n_resblocks=1,
             batch_size=2, hr_size=32, mixed_precision=False)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _t(a):
    return torch.tensor(np.asarray(a))


def _jax_elbo_draws(key, n, kappa0, mu_shape):
    """The draws of virnet_tpu/losses/elbo.py for ``key`` and one mu
    (elbo_sisr :148, :167; reparam_cov_mat :95-103; likelihood_sisr :119)."""
    k_cov_key, lh_key = jax.random.split(key)
    k_ig, k_rho = jax.random.split(k_cov_key)
    return dict(
        gamma_draw=_t(jax.random.gamma(k_ig, jnp.full((n, 2), kappa0 - 1.0))),
        rho_eps=_t(jax.random.normal(k_rho, (n,), jnp.float32)),
        z_eps=_t(jax.random.normal(jax.random.split(lh_key, 1)[0], mu_shape,
                                   jnp.float32)))


def _host_batch(rng, n, hr, sf):
    return (rng.random((n, hr, hr, 3), dtype=np.float32),
            rng.random((n, hr // sf, hr // sf, 3), dtype=np.float32),
            np.array([[1.2, 1.0, 0.1], [0.8, 2.0, -0.3]], np.float32),
            (rng.random((n, 1)) * 10 / 255 + 1e-3).astype(np.float32))


@pytest.mark.parametrize("sf,k_size", [(2, 5), (4, 7)])
def test_training_step_matches_jax(sf, k_size, tmp_path):
    """The path as a whole: model.apply + elbo_sisr under
    jax.value_and_grad, host-batch form, against
    SISRTrainer(host_batches=True, device='cpu') with the same weights,
    batch and draws.  Loss and aux rtol 1e-5, per-subnet gradient norms
    rtol 1e-4, every parameter's gradient 1e-3 of its max."""
    cfg = SISRTrainConfig(sf=sf, k_size=k_size, save_dir=str(tmp_path),
                          **SMALL)
    rng = np.random.default_rng(0)
    hr, lr, kinfo_gt, nlevel = batch = _host_batch(rng, 2, cfg.hr_size, sf)
    jm = JaxVIRNetSR(n_feat=cfg.n_feat, dep_S=cfg.dep_S, dep_K=cfg.dep_K,
                     n_resblocks=cfg.n_resblocks, extra_mode=cfg.extra_mode,
                     noise_avg=True)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(lr), sf)["params"]
    k_elbo = jax.random.PRNGKey(5)
    alpha0 = 0.5 * cfg.var_window ** 2

    def loss_fn(params):
        mu, kinfo_est, sigma_est = jm.apply({"params": params},
                                            jnp.asarray(lr), sf)
        loss, aux = jax_elbo_sisr(
            k_elbo, mu, sigma_est, kinfo_est, jnp.asarray(hr),
            jnp.asarray(lr), jnp.asarray(nlevel ** 2).reshape(-1, 1, 1, 1),
            alpha0, jnp.asarray(kinfo_gt), cfg.kappa0, cfg.r2, cfg.eps2, sf,
            k_size, cfg.penalty_K, cfg.kernel_shift, cfg.downsampler)
        return loss, {k: v for k, v in aux.items() if k != "kernel"}

    (loss_j, aux_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(
        params)

    tr = SISRTrainer(cfg, device="cpu", host_batches=True)
    assert tr.model.conv_impl == "torch"
    tr.model.load_state_dict(from_jax_params(_np_tree(params)), strict=True)
    noise = dict(elbo=_jax_elbo_draws(k_elbo, 2, cfg.kappa0, hr.shape))
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
    for key, sub in (("gnorm_r", "rnet"), ("gnorm_s", "snet"),
                     ("gnorm_k", "knet")):
        np.testing.assert_allclose(
            float(out[key]), float(optax.global_norm(grads_j[sub])),
            rtol=1e-4, err_msg=key)


def test_training_on_device_synthesis_lowers_the_elbo(tmp_path):
    """HR batches degraded in the step (uint8 in, normalised on the
    device): finite scalars, and the ELBO on a fixed batch with fixed
    noise is lower after 8 steps."""
    cfg = SISRTrainConfig(sf=2, k_size=5, save_dir=str(tmp_path), **SMALL)
    tr = SISRTrainer(cfg, device="cpu")
    rng = np.random.default_rng(1)
    hr8 = (rng.random((2, 32, 32, 3)) * 255).astype(np.uint8)
    fixed = _host_batch(np.random.default_rng(2), 2, 32, 2)
    fixed = (hr8.astype(np.float32) / 255,) + fixed[1:]
    draws = dict(elbo=dict(gamma_draw=torch.full((2, 2), 49.0),
                           rho_eps=torch.zeros(2),
                           z_eps=torch.zeros(2, 32, 32, 3)))
    probe = SISRTrainer(cfg, device="cpu", host_batches=True)

    def fixed_elbo():
        probe.model.load_state_dict(tr.model.state_dict())
        return float(probe.loss_and_grads(fixed, 0, draws)[0])

    before = fixed_elbo()
    for _ in range(8):
        out = tr.run_step(hr8, 0)
        assert all(np.isfinite(float(v)) for v in out.values())
    assert sorted(out) == sorted(
        ["lh", "kl_rnet", "kl_snet", "kl_knet", "kl_knet0", "kl_knet1",
         "kl_knet2", "loss", "gnorm_r", "gnorm_s", "gnorm_k"])
    assert fixed_elbo() < before


def _tiny_subnets(seed):
    torch.manual_seed(seed)
    subnets = {"rnet": torch.nn.Linear(3, 2), "snet": torch.nn.Linear(2, 2),
               "knet": torch.nn.Linear(2, 1, bias=False)}
    with torch.no_grad():
        for m in subnets.values():
            for p in m.parameters():
                p.mul_(0.1)
    return subnets


def test_optimizer_matches_optax_chain():
    """The same given gradients through build_optimizer's optax chain and
    SubnetAdam, 4 steps across an epoch boundary (steps_per_epoch=2) with
    'rnet' above its clip: parameters atol 1e-7 (they stay below 0.125 in
    magnitude, where that is 13 float32 ulps; optax takes 1 - b2**t in
    float32, 3e-5 off at t = 2, which moves an update by 1.5e-5 of the
    learning rate), learning rates rtol 1e-6 (float32 there, float64
    here)."""
    sched = dict(base_lr=1e-3, lr_min=1e-5, epochs=3, warmup_epochs=1,
                 steps_per_epoch=2)
    clip = {"rnet": 0.5, "snet": 1e2, "knet": 5e2}
    subnets = _tiny_subnets(0)
    params = {n: {k: jnp.asarray(v.detach().numpy())
                  for k, v in m.named_parameters()}
              for n, m in subnets.items()}
    tx, schedule = build_optimizer(sched["base_lr"], sched["lr_min"],
                                   sched["epochs"], sched["warmup_epochs"],
                                   sched["steps_per_epoch"], clip_map=clip)
    opt_state = tx.init(params)
    opt = SubnetAdam(subnets, sched["base_lr"], sched["lr_min"],
                     sched["epochs"], sched["warmup_epochs"],
                     sched["steps_per_epoch"], clip_map=clip)
    rng = np.random.default_rng(3)
    for step in range(4):
        grads = {n: {k: rng.standard_normal(v.shape).astype(np.float32)
                     * (3.0 if n == "rnet" else 0.1)
                     for k, v in sub.items()} for n, sub in params.items()}
        np.testing.assert_allclose(opt.schedule(step), float(schedule(step)),
                                   rtol=1e-6)
        updates, opt_state = tx.update(
            jax.tree.map(jnp.asarray, grads), opt_state, params)
        params = optax.apply_updates(params, updates)
        for n, m in subnets.items():
            for k, p in m.named_parameters():
                p.grad = _t(grads[n][k])
        norms = opt.step()
        np.testing.assert_allclose(
            float(norms["rnet"]),
            float(optax.global_norm(jax.tree.map(jnp.asarray,
                                                 grads["rnet"]))), rtol=1e-6)
        assert float(norms["rnet"]) > clip["rnet"]
        for n, m in subnets.items():
            for k, p in m.named_parameters():
                np.testing.assert_allclose(
                    p.detach().numpy(), np.asarray(params[n][k]), atol=1e-7,
                    err_msg=f"step {step} {n}.{k}")
    assert opt.count == 4


def test_schedule_matches_jax_over_epochs():
    args = (2e-4, 1e-6, 12, 3, 5)
    from virnet_tpu.train.optim import \
        warmup_cosine_epoch_schedule as jax_schedule

    mine, theirs = warmup_cosine_epoch_schedule(*args), jax_schedule(*args)
    for step in range(0, 70, 3):
        np.testing.assert_allclose(mine(step), float(theirs(step)), rtol=1e-6)
    assert mine(0) == mine(4) != mine(5)


def test_checkpoint_resume_is_bitwise(tmp_path):
    """2 steps, save, 2 steps, against restore + 2 steps: the same bits in
    every parameter, Adam moment and returned scalar, on the CPU."""
    cfg = SISRTrainConfig(sf=2, k_size=5, steps_per_epoch=2,
                          save_dir=str(tmp_path / "a"), **SMALL)
    rng = np.random.default_rng(4)
    batches = [rng.random((2, 32, 32, 3), dtype=np.float32) for _ in range(4)]
    a = SISRTrainer(cfg, device="cpu")
    for i in range(2):
        a.run_step(batches[i], 0)
    a.save(0)
    outs_a = [a.run_step(batches[i], 1) for i in (2, 3)]

    b = SISRTrainer(cfg, device="cpu")
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
    fresh = SISRTrainer(SISRTrainConfig(
        sf=2, k_size=5, save_dir=str(tmp_path / "none"), **SMALL),
        device="cpu")
    assert fresh.restore() == 0


def test_checkpoint_manager_keeps_the_latest(tmp_path):
    mngr = CheckpointManager(tmp_path, max_to_keep=2)
    assert mngr.latest_step() is None and mngr.restore() is None
    for step in (1, 2, 3):
        mngr.save(step, dict(step=step, w=torch.full((2,), float(step))))
    assert mngr.steps() == [2, 3] and mngr.latest_step() == 3
    assert mngr.restore()["step"] == 3
    assert torch.equal(mngr.restore(2)["w"], torch.full((2,), 2.0))


def test_trainer_entry_points_default_to_the_card(tmp_path):
    """No card here: the trainer and the CLI's build_trainer raise unless
    device='cpu' is passed; add_jpeg with jpeg_in_graph trains on the
    device-side codec, and without it on degraded host batches."""
    from virnet_tpu_torch.cli.train_sisr import build_trainer, main

    cfg = config.load_config("configs/sisr_x4.json")
    cfg.update(save_dir=str(tmp_path), n_feat=[16, 24, 32], dep_S=3, dep_K=2,
               batch_size=2, hr_size=32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_trainer(cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SISRTrainer(SISRTrainConfig(save_dir=str(tmp_path)))
    tr = build_trainer(cfg, device="cpu")
    assert (tr.cfg.sf, tr.cfg.k_size, tr.cfg.downsampler, tr.cfg.extra_mode,
            tr.cfg.mixed_precision, tr.host_batches) == (
                4, 21, "bicubic", "both", True, False)
    cfg.update(add_jpeg=True, jpeg_in_graph="True")
    tr = build_trainer(cfg, device="cpu")
    assert tr.cfg.add_jpeg_in_graph and not tr.host_batches
    out = tr.run_step(np.zeros((2, 32, 32, 3), np.float32), 0)
    assert all(np.isfinite(float(v)) for v in out.values())
    cfg.update(jpeg_in_graph="False")
    tr = build_trainer(cfg, device="cpu")
    assert tr.host_batches and not tr.cfg.add_jpeg_in_graph
    host = tuple(np.full(s, 0.5, np.float32) for s in
                 ((2, 32, 32, 3), (2, 8, 8, 3), (2, 3), (2, 1)))
    host[2][:] = (1.0, 1.0, 0.0)
    host[3][:] = 5 / 255
    out = tr.run_step(host, 0)
    assert all(np.isfinite(float(v)) for v in out.values())
    with pytest.raises(SystemExit):
        main(["--save_dir", str(tmp_path / "cli"), "--device", "cpu"])


def test_cli_trains_and_resumes_from_a_folder_of_pngs(tmp_path):
    import cv2

    rng = np.random.default_rng(5)
    hr_dir = tmp_path / "hr"
    hr_dir.mkdir()
    for i in range(3):
        cv2.imwrite(str(hr_dir / f"{i}.png"),
                    (rng.random((40, 48, 3)) * 255).astype(np.uint8))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text("""{
        # a tiny configuration
        "im_chn": 3, "sigma_chn": 1, "hr_size": 32, "batch_size": 2,
        "epochs": 2, "steps_per_epoch": 2, "lr": 2e-4, "print_freq": 1,
        "save_dir": "unused", "dep_S": 3, "dep_K": 2,
        "n_feat": [16, 24, 32], "n_resblocks": 1, "extra_mode": "Both",
        "train_hr_patchs": "%s", "sf": 2, "k_size": 5,
        "mixed_precision": "False", "downsampler": "Bicubic"  // comment
    }""" % hr_dir)
    from virnet_tpu_torch.cli.train_sisr import main

    save = tmp_path / "run"
    main(["--config", str(cfg_path), "--save_dir", str(save), "--device",
          "cpu", "--epochs", "1"])
    assert CheckpointManager(save).steps() == [1]
    main(["--config", str(cfg_path), "--save_dir", str(save), "--device",
          "cpu", "--resume", "latest"])
    assert CheckpointManager(save).steps() == [1, 2]
    log = (save / "train.log").read_text()
    assert "resumed at epoch 1, step 2" in log and "lh=" in log


def test_patch_sampler_matches_jax_package(tmp_path):
    import cv2

    from virnet_tpu.data import sources as jsources
    from virnet_tpu_torch.data import sources

    rng = np.random.default_rng(6)
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"{i}.png"))
        cv2.imwrite(paths[-1], (rng.random((20, 24, 3)) * 255).astype(np.uint8))
    a = sources.PatchSampler(sources.ImageCache(paths), 16, seed=3)
    b = jsources.PatchSampler(jsources.ImageCache(paths), 16, seed=3)
    np.testing.assert_array_equal(a.sample(4, raw=True), b.sample(4, raw=True))
    a.reset_seed(7)
    b.reset_seed(7)
    np.testing.assert_array_equal(a.sample(3), b.sample(3))
    with pytest.raises(ValueError):
        sources.ImageCache([])


@pytest.mark.parametrize("name", ["sisr_x2", "sisr_x3", "sisr_x4",
                                  "denoising_syn", "denoising_real"])
def test_config_loader_matches_jax_package(name):
    path = f"configs/{name}.json"
    assert config.load_config(path) == jconfig.load_config(path)


def test_config_bool_strings_and_overrides():
    for v, want in (("True", True), ("false", False), (True, True),
                    ("0", False), ("yes", True)):
        assert config.as_bool(v) is want
    with pytest.raises(ValueError):
        config.as_bool("maybe")
    assert config.update_args({"a": 1, "b": 2}, {"a": None, "b": 3}) == {
        "a": 1, "b": 3}


def _snet_args(rng, requires_grad):
    def w(*shape):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32)
                            * 0.1, requires_grad=requires_grad)
    return [w(3, 3, 3, 64), w(64), [w(3, 3, 64, 64)], [w(64)],
            w(3, 3, 64, 1), w(1)]


def test_forward_only_kernels_raise_under_grad():
    """K1-K4 carry no autograd: with grad enabled and an input that
    requires grad every wrapper raises (on the CPU too, where the plain
    version would hide it); under no_grad, or with nothing that requires
    grad, they run."""
    rng = np.random.default_rng(7)
    x = torch.rand(1, 8, 8, 3)
    xm = torch.rand(1, 8, 8, 64)
    args = _snet_args(rng, True)
    wh, bh = torch.rand(3, 3, 4, 16, requires_grad=True), torch.rand(16)
    wt, bt = torch.rand(3, 3, 16, 3), torch.rand(3)
    feats = torch.rand(1, 8, 8, 16, requires_grad=True)
    calls = [
        lambda: fc.conv3x3_mid(xm, args[2][0], args[3][0], 0.25),
        lambda: fc.conv3x3_mid_stack(xm, args[2], args[3], 0.25),
        lambda: fc.dncnn_fused(x, *args),
        lambda: fc.dncnn_head_fused(x, *args, wh, bh),
        lambda: fc.conv3x3_tail_residual(feats, x, wt, bt),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="forward-only"):
            call()
        with torch.no_grad():
            call()
    plain = _snet_args(rng, False)
    assert not fc.dncnn_fused(x, *plain).requires_grad
    model = VIRNet(sigma_chn=1, n_feat=(16, 24, 32), dep_S=3)
    with pytest.raises(RuntimeError, match="conv_impl='torch'"):
        model(x)
    sr = VIRNetSR(n_feat=(16, 24, 32), dep_S=3, dep_K=2)
    with pytest.raises(RuntimeError, match="conv_impl='torch'"):
        sr(x, 2)


@pytest.mark.parametrize("hw", [(16, 20), (13, 15)])
def test_torch_route_equals_fused_route_and_has_gradients(hw):
    """conv_impl='torch' (F.conv2d with autograd) equals the fused route's
    plain versions in value (fp32, atol 1e-5), with and without RNet's
    internal pad, and gives every parameter a gradient.  The weights come
    from a seed of their own, so that they do not depend on which tests
    ran before in the same process."""
    kw = dict(sigma_chn=1, n_feat=(16, 24, 32), dep_S=4, n_resblocks=1)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(8)
        fused = VIRNet(**kw)
    train = VIRNet(conv_impl="torch", **kw)
    train.load_state_dict(fused.state_dict(), strict=True)
    x = _t(np.random.default_rng(8).random((2, *hw, 3), dtype=np.float32))
    with torch.no_grad():
        mu_f, sig_f = fused(x)
    mu, sig = train(x)
    torch.testing.assert_close(mu.detach(), mu_f, atol=1e-5, rtol=0)
    torch.testing.assert_close(sig.detach(), sig_f, atol=1e-5, rtol=0)
    (mu.sum() + sig.sum()).backward()
    for name, p in train.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
    assert train.SNet.conv_last.weight.grad.abs().sum() > 0
    assert train.RNet.tail.weight.grad.abs().sum() > 0
    with pytest.raises(ValueError):
        VIRNet(conv_impl="xla", **kw)


def test_package_lazy_exports_touch_no_build():
    import virnet_tpu_torch as pkg
    from virnet_tpu_torch.ops import _build

    for name in ("VIRNetSR", "SISRTrainer", "SISRTrainConfig", "elbo_sisr",
                 "blur_per_sample", "VIRNet", "Restorer", "load_pth"):
        assert getattr(pkg, name) is not None
    assert "blur" in _build.SOURCES and not _build._LIBS
    with pytest.raises(AttributeError):
        pkg.no_such_name
