"""The port's training runtime on the CPU: the process group
(train/mesh.py) and the trainers' data parallelism, one rank against two
gloo processes at the same global batch; the draws a rank takes; RNet
rematerialization; the RSS watchdog and auto-resume
(train/resilience.py); the kill/resume proof and a watchdog re-exec
through the denoising trainer CLI as subprocesses.  Small seeded models;
this file imports nothing of JAX (the two-process test spawns workers
that import it)."""

import json
import socket
import subprocess
import sys
from pathlib import Path

import logging

import numpy as np
import pytest
import torch

from virnet_tpu_torch.cli import common
from virnet_tpu_torch.train import mesh as mesh_mod
from virnet_tpu_torch.train import resilience
from virnet_tpu_torch.train.checkpoint import CheckpointManager
from virnet_tpu_torch.train.loop_denoise import (DenoiseTrainConfig,
                                                 DenoiseTrainer)
from virnet_tpu_torch.train.loop_sisr import SISRTrainConfig, SISRTrainer
from virnet_tpu_torch.train.mesh import Mesh

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(n_feat=(8, 16), dep_S=3, n_resblocks=1, epochs=2,
             steps_per_epoch=4, mixed_precision=False, print_freq=100)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the tier-1 run has six workers at
    once, and PyTorch's default of a thread per core oversubscribes the
    CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# the process group
# ---------------------------------------------------------------------------

def test_init_multihost_single_process_is_a_no_op(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mesh_mod.init_multihost() == 1
    assert not torch.distributed.is_initialized()
    m = mesh_mod.make_mesh(["cpu"] * 2)
    assert (m.world, m.rank, m.grouped, m.size) == (1, 0, False, 2)
    assert m.distinct() == [torch.device("cpu")]
    assert m.rows(6) == slice(0, 6)


def test_init_multihost_failure_raises_for_several_processes(monkeypatch,
                                                             caplog):
    """A failed join raises when more than one process was asked for and
    is a WARNING otherwise; the address goes to tcp://."""
    seen = []

    def fail(**kw):
        seen.append(kw)
        raise RuntimeError("connection refused")

    monkeypatch.setattr(torch.distributed, "init_process_group", fail)
    # train/logging.make_log, run by an earlier test in this process,
    # turns the package logger's propagation off, and caplog listens at
    # the root: let the warning reach it whatever ran before
    monkeypatch.setattr(logging.getLogger("virnet_tpu_torch"), "propagate",
                        True)
    with pytest.raises(RuntimeError, match="multi-process init failed"):
        mesh_mod.init_multihost("badhost:1", 2, 1, backend="gloo")
    assert seen[0]["init_method"] == "tcp://badhost:1"
    assert (seen[0]["world_size"], seen[0]["rank"]) == (2, 1)
    assert mesh_mod.init_multihost("badhost:1", 1, 0) == 1
    assert "continuing single-process" in caplog.text
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert mesh_mod.init_multihost() == 1
    assert seen[-1]["init_method"] == "env://"


def test_maybe_init_multihost_follows_the_config(monkeypatch):
    """No key: no join; ``multihost`` alone: torchrun's variables (all
    None); the topology from the config otherwise (the JAX CLI's keys,
    tests/test_configs_multihost.py)."""
    calls = []

    def fake(coordinator_address=None, num_processes=None, process_id=None,
             backend=None):
        calls.append((coordinator_address, num_processes, process_id,
                      backend))
        return num_processes or 1

    monkeypatch.setattr(mesh_mod, "init_multihost", fake)
    assert common.maybe_init_multihost({"lr": 1e-4}) == 1
    assert calls == []
    logs = []
    assert common.maybe_init_multihost({"multihost": "True"},
                                       log_fn=logs.append) == 1
    assert calls == [(None, None, None, None)]
    assert common.maybe_init_multihost(
        {"coordinator_address": "host0:8476", "num_processes": 4,
         "process_id": 2}, log_fn=logs.append, backend="gloo") == 4
    assert calls[-1] == ("host0:8476", 4, 2, "gloo")
    assert any("multi-host: 4 process(es)" in m for m in logs)
    mesh = common.trainer_mesh({"lr": 1e-4}, "cpu")
    assert (mesh.devices, mesh.world) == ([torch.device("cpu")], 1)


def test_mesh_rows_and_collectives_without_a_group():
    m = Mesh(["cpu"], world=4, rank=2)
    assert m.rows(8) == slice(4, 6)
    with pytest.raises(ValueError, match="divisible by the world size"):
        m.rows(6)
    batch = (np.arange(8), {"a": torch.arange(16).view(8, 2), "b": None})
    got = m.shard_batch(batch)
    np.testing.assert_array_equal(got[0], [4, 5])
    assert got[1]["a"].tolist() == [[8, 9], [10, 11]] and got[1]["b"] is None
    t = torch.ones(3)
    m.all_reduce_mean_([t])                  # ungrouped: nothing to do
    m.replicate([t])
    m.barrier()
    assert t.tolist() == [1.0, 1.0, 1.0]


# ---------------------------------------------------------------------------
# data parallelism: one rank against two
# ---------------------------------------------------------------------------

def _denoise_cfg(tmp, **kw):
    return DenoiseTrainConfig(batch_size=4, patch_size=16,
                              save_dir=str(tmp), **{**SMALL, **kw})


def _sisr_cfg(tmp, **kw):
    return SISRTrainConfig(batch_size=4, hr_size=16, sf=2, k_size=7,
                           dep_K=2, save_dir=str(tmp), **{**SMALL, **kw})


def _train_all(mesh, tmp) -> dict:
    """Three steps of each trainer on seeded global batches: synthetic
    denoising through train_epoch (the prefetcher moves this rank's
    rows), real denoising with MixUp on paired device records, SISR on
    host HR batches.  Returns each trainer's losses and parameters."""
    from virnet_tpu_torch.data.device_data import DeviceDataset

    rng = np.random.default_rng(0)
    gt = (rng.random((6, 24, 24, 3)) * 255).astype(np.uint8)
    noisy = np.clip(gt + rng.normal(0, 12, gt.shape), 0, 255).astype(
        np.uint8)
    hr = rng.random((3, 4, 16, 16, 3), dtype=np.float32)
    out = {}
    syn = DenoiseTrainer(_denoise_cfg(tmp / "syn", prefetch=2), device="cpu",
                         mesh=mesh)
    losses = []
    for step in range(3):
        stats = syn.train_epoch(0, iter([gt[step:step + 4, :16, :16]]),
                                log_fn=lambda m: None)
        losses.append(stats["loss"])
    out["syn"] = (losses, syn)
    real = DenoiseTrainer(_denoise_cfg(tmp / "real", sigma_chn=3), real=True,
                          device="cpu", mesh=mesh)
    data = DeviceDataset(noisy, gt, device="cpu")
    out["real"] = ([float(real.run_step_device(data, 1)["loss"])
                    for _ in range(3)], real)
    sisr = SISRTrainer(_sisr_cfg(tmp / "sisr"), device="cpu", mesh=mesh)
    out["sisr"] = ([float(sisr.run_step(hr[i], 0)["loss"])
                    for i in range(3)], sisr)
    return {k: dict(losses=v[0], step=v[1].step,
                    params={n: p.detach().clone() for n, p in
                            v[1].model.state_dict().items()})
            for k, v in out.items()}


def _dp_worker(rank, world, port, out_dir):
    torch.set_num_threads(1)
    mesh_mod.init_multihost(f"localhost:{port}", world, rank,
                            backend="gloo", timeout_s=120)
    try:
        mesh = mesh_mod.make_mesh(["cpu"])
        res = _train_all(mesh, Path(out_dir) / f"r{rank}")
        torch.save(res, Path(out_dir) / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def test_two_gloo_ranks_take_the_steps_of_one_process(tmp_path):
    """Two processes over gloo (a free port, one spawn for the three
    trainers) against one process without a group, at the same global
    batch: losses rtol 1e-5 and parameters atol 1e-5 (the JAX bars of
    tests/test_multidevice_equivalence.py), and the two ranks report the
    same losses and hold the same parameters."""
    import torch.multiprocessing as mp

    mp.spawn(_dp_worker, args=(2, _free_port(), str(tmp_path)), nprocs=2,
             join=True)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    one = _train_all(None, tmp_path / "one")
    for kind, want in one.items():
        r0, r1 = ranks[0][kind], ranks[1][kind]
        assert r0["losses"] == r1["losses"], kind
        assert r0["step"] == want["step"] == 3
        np.testing.assert_allclose(r0["losses"], want["losses"], rtol=1e-5,
                                   err_msg=kind)
        for name, p in want["params"].items():
            assert torch.equal(r0["params"][name], r1["params"][name])
            np.testing.assert_allclose(r0["params"][name].numpy(),
                                       p.numpy(), atol=1e-5,
                                       err_msg=f"{kind} {name}")


def _recording(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def rec(*args, **kwargs):
        calls.append((args, kwargs))
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, rec)


def test_a_rank_takes_the_global_draws_rows(tmp_path, monkeypatch):
    """Rank 1 of 2 (no group: the collectives are left out) draws the
    step's random tensors at the global batch's shape and keeps rows 2:4:
    its synthesis and ELBO draws, and the batch it synthesizes, are those
    rows of the one-process step's; the draws at the global shape are
    what the generator gives inline (synthesize_sisr_batch without
    draws)."""
    from virnet_tpu_torch.data import sisr_synth
    from virnet_tpu_torch.train import loop_sisr

    hr = np.random.default_rng(1).random((4, 16, 16, 3), dtype=np.float32)
    seen = {}
    for rank, mesh in ((None, None), (1, Mesh(["cpu"], world=2, rank=1))):
        synth, elbo = [], []
        with monkeypatch.context() as m:
            _recording(m, loop_sisr, "synthesize_sisr_batch", synth)
            _recording(m, loop_sisr, "elbo_sisr", elbo)
            tr = SISRTrainer(_sisr_cfg(tmp_path), device="cpu", mesh=mesh)
            tr.loss_and_grads(hr, 0)
        seen[rank] = (synth[0], elbo[0][1]["noise"], tr)
    (s_all, e_all, tr), (s_one, e_one, _) = seen[None], seen[1]
    for k, v in s_all[1]["draws"].items():
        assert torch.equal(s_one[1]["draws"][k], v[2:4]), k
    assert torch.equal(s_one[0][0], torch.from_numpy(hr[2:4]))
    for k in ("gamma_draw", "rho_eps"):
        assert torch.equal(e_one[k], e_all[k][2:4]), k
    assert torch.equal(e_one["z_eps"][0], e_all["z_eps"][0][2:4])
    g = torch.Generator().manual_seed(loop_sisr.step_seed(tr.cfg.seed, 0, 0))
    inline = sisr_synth.synthesize_sisr_batch(
        torch.from_numpy(hr), 2, 7, noise_level=tr.cfg.noise_level,
        generator=g)
    replay = sisr_synth.synthesize_sisr_batch(
        torch.from_numpy(hr), 2, 7, noise_level=tr.cfg.noise_level,
        draws=s_all[1]["draws"])
    for a, b in zip(inline, replay):
        assert torch.equal(a, b)


def test_draw_functions_are_the_inline_draws():
    """Each module's draws function gives what its function draws inline
    from the same generator state (so a rank that draws up front draws
    what one process draws)."""
    from virnet_tpu_torch.data import denoise_synth, device_data, mixup
    from virnet_tpu_torch.losses import elbo

    def gen():
        return torch.Generator().manual_seed(3)

    gt = torch.rand(3, 12, 12, 3)
    for mode in ("niid", "iid"):
        a = denoise_synth.synthesize_noisy_batch(gt, mode, generator=gen())
        d = denoise_synth.noisy_batch_draws(gt.shape, mode, gen())
        b = denoise_synth.synthesize_noisy_batch(gt, mode, draws=d)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    recs = torch.randint(0, 255, (5, 20, 20, 3), dtype=torch.uint8)
    a = device_data.sample_patches(recs, 4, 8, generator=gen())
    d = device_data.patch_draws(recs.shape, 4, 8, True, gen())
    assert torch.equal(a, device_data.sample_patches(recs, 4, 8, draws=d))
    clean, noisy = torch.rand(4, 8, 8, 3), torch.rand(4, 8, 8, 3)
    a = mixup.mixup_pairs(clean, noisy, generator=gen())
    b = mixup.mixup_pairs(clean, noisy,
                          draws=mixup.mixup_draws(4, generator=gen()))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    im_hr, im_lr = torch.rand(2, 16, 16, 3), torch.rand(2, 8, 8, 3)
    kinfo = torch.tensor([[1.5, 0.9, 0.2], [0.6, 2.5, -0.4]])
    sigma = torch.full((2, 1, 1, 1), 1e-3)

    def loss(**kw):
        return elbo.elbo_sisr(im_hr, sigma, kinfo, im_hr, im_lr, sigma,
                              40.5, kinfo, 50.0, 1e-4, 1e-5, 2, 5,
                              (0.02, 2.0), False, "bicubic", **kw)[0]

    d = elbo.sisr_elbo_draws(2, im_hr.shape, 50.0, generator=gen())
    assert torch.equal(loss(generator=gen()), loss(noise=d))
    for sf, method in ((3, "bicubic"), (3, "direct"), (4, "bicubic")):
        d = sisr_synth_draws(sf, method)
        assert d["noise"].shape[1:3] == sisr_synth_lr(sf, method)


def sisr_synth_draws(sf, method):
    from virnet_tpu_torch.data.sisr_synth import sisr_batch_draws

    return sisr_batch_draws((2, 50, 47, 3), sf, method,
                            generator=torch.Generator().manual_seed(0))


def sisr_synth_lr(sf, method):
    from virnet_tpu_torch.ops.degrade import downsample

    return tuple(downsample(torch.zeros(1, 50, 47, 3), sf, method).shape[1:3])


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["denoise", "sisr"])
def test_remat_gives_the_same_bits(kind, tmp_path):
    """A trainer step with RNet's blocks recomputed in the backward gives
    the plain step's loss and every gradient bit for bit (the SISR model
    also with its SFT gates recomputed); remat needs the torch build."""
    from virnet_tpu_torch.models.attresunet import AttResBlock
    from virnet_tpu_torch.models.virnet import VIRNet

    outs = []
    for remat in (False, True):
        if kind == "sisr":
            tr = SISRTrainer(_sisr_cfg(tmp_path, remat=remat), device="cpu")
            for m in tr.model.RNet.modules():
                if isinstance(m, AttResBlock):
                    m.remat_gates = remat
            batch = np.random.default_rng(2).random((4, 16, 16, 3),
                                                    dtype=np.float32)
        else:
            tr = DenoiseTrainer(_denoise_cfg(tmp_path, remat=remat),
                                device="cpu")
            batch = np.random.default_rng(2).random((4, 16, 16, 3),
                                                    dtype=np.float32)
        assert tr.model.RNet.remat == remat
        loss, _ = tr.loss_and_grads(batch, 0)
        outs.append((loss, {n: p.grad.clone() for n, p in
                            tr.model.named_parameters()}))
    assert torch.equal(outs[0][0], outs[1][0])
    assert outs[0][1].keys() == outs[1][1].keys()
    for name, g in outs[0][1].items():
        assert torch.equal(g, outs[1][1][name]), name
    with pytest.raises(ValueError, match="conv_impl='torch'"):
        VIRNet(remat=True)


# ---------------------------------------------------------------------------
# resilience
# ---------------------------------------------------------------------------

def test_rss_mb_and_reexec_argv():
    assert 10.0 < resilience.rss_mb() < 1e6
    argv = resilience.reexec_argv("pkg.mod", ["--config", "c.json"])
    assert argv == [sys.executable, "-m", "pkg.mod", "--config", "c.json",
                    "--resume", "latest"]
    # a --resume already on the command line gives way to --resume
    # latest, in either form and wherever it stands, so that a re-exec
    # restores the checkpoint just written and not the epoch it started at
    assert resilience.reexec_argv("pkg.mod", ["--resume", "7"])[3:] == [
        "--resume", "latest"]
    for args in (["--resume", "3", "--x", "1"], ["--resume=3", "--x", "1"],
                 ["--x", "1", "--resume", "3"],
                 ["--resume", "2", "--x", "1", "--resume=3"]):
        assert resilience.reexec_argv("pkg.mod", args)[3:] == [
            "--x", "1", "--resume", "latest"], args
    mid = resilience.reexec_argv("pkg.mod", ["--config", "c.json",
                                             "--resume", "3", "--epochs",
                                             "9"])
    assert mid[3:] == ["--config", "c.json", "--epochs", "9", "--resume",
                       "latest"]


def test_watchdog_below_the_limit_disabled_and_firing(monkeypatch):
    """Below the limit and switched off it does nothing; at the limit it
    runs the cleanup, then the exec, and counts the lineage; a failing
    cleanup is logged and the exec goes on; with two processes it
    raises, naming the reason (tests/test_rss_watchdog.py:28-80)."""
    # set, so that the lineage count the watchdog writes is undone too
    monkeypatch.setenv(resilience._RSS_RESTART_ENV, "0")
    calls = []
    assert resilience.maybe_reexec_on_rss(
        1e9, ["x"], log_fn=lambda *_: None,
        _exec=lambda *a: calls.append(a), _rss=lambda: 100.0) is False
    assert resilience.maybe_reexec_on_rss(0, ["x"], _rss=lambda: 1e9) is False
    assert not calls
    order = []
    assert resilience.maybe_reexec_on_rss(
        100.0, ["/bin/prog", "a"], log_fn=lambda *_: None,
        cleanup=lambda: order.append("cleanup"),
        _exec=lambda p, a: order.append(("exec", p, a)),
        _rss=lambda: 101.0) is True
    assert order == ["cleanup", ("exec", "/bin/prog", ["/bin/prog", "a"])]
    assert resilience.rss_restart_count() == 1
    logs, execs = [], []

    def bad_cleanup():
        raise RuntimeError("writer already closed")

    assert resilience.maybe_reexec_on_rss(
        1.0, ["p"], log_fn=logs.append, cleanup=bad_cleanup,
        _exec=lambda p, a: execs.append(p), _rss=lambda: 2.0) is True
    assert execs == ["p"] and "cleanup raised" in logs[-1]
    assert resilience.rss_restart_count() == 2
    with pytest.raises(RuntimeError, match="cannot rejoin"):
        resilience.maybe_reexec_on_rss(1.0, ["p"], world=2,
                                       _exec=lambda *a: None,
                                       _rss=lambda: 2.0)
    with pytest.raises(RuntimeError, match="2 processes"):
        common.epoch_rss_watchdog({"rss_limit_mb": 10}, "m", [], None, None,
                                  world=2)
    common.epoch_rss_watchdog({"rss_limit_mb": 0}, "m", [], None, None,
                              world=2)()


def test_run_with_auto_resume_retries_then_gives_up():
    """A crash restarts from restore_fn's epoch; past max_restarts the
    error is raised."""
    starts, fails = [], [2]

    def train(epoch):
        starts.append(epoch)
        if fails[0]:
            fails[0] -= 1
            raise RuntimeError("boom")

    resilience.run_with_auto_resume(train, lambda: len(starts),
                                    max_restarts=3, backoff_s=0.0,
                                    log_fn=lambda *_: None)
    assert starts == [0, 1, 2]

    def always(epoch):
        raise ValueError("always")

    with pytest.raises(ValueError, match="always"):
        resilience.run_with_auto_resume(always, lambda: 0, max_restarts=1,
                                        backoff_s=0.0,
                                        log_fn=lambda *_: None)


# ---------------------------------------------------------------------------
# the trainer CLI as subprocesses
# ---------------------------------------------------------------------------

def _cli_config(tmp_path, **extra):
    import cv2

    im_dir = tmp_path / "images"
    im_dir.mkdir(exist_ok=True)
    rng = np.random.default_rng(12)
    for i in range(3):
        cv2.imwrite(str(im_dir / f"{i}.png"),
                    (rng.random((40, 48, 3)) * 255).astype(np.uint8))
    cfg = dict(im_chn=3, sigma_chn=1, patch_size=16, batch_size=2, epochs=2,
               steps_per_epoch=4, lr=1e-3, print_freq=1, dep_S=3,
               n_feat=[8, 16], n_resblocks=1, extra_mode="Input",
               noise_cond=True, mixed_precision=False, prefetch=0,
               train_data=[[str(im_dir), "*.png"]], save_dir="unused",
               **extra)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    return path


def test_kill_resume_proof_is_bitwise(tmp_path, monkeypatch):
    """cli/resilience_proof on the CPU: run A uninterrupted, run B
    SIGKILLed at epoch 2 step 2 of 40 (before the epoch's checkpoint) and
    relaunched with --resume latest; the final checkpoints are equal
    tensor for tensor."""
    from virnet_tpu_torch.cli.resilience_proof import main

    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # the children's threads
    res = main(["--config", str(_cli_config(tmp_path)), "--epochs", "2",
                "--steps_per_epoch", "40", "--kill_step", "2", "--work_dir",
                str(tmp_path / "work"), "--device", "cpu", "--timeout_s",
                "300"])
    assert res["match"] and res["final_ckpt_step"] == [2, 2]
    assert res["ckpt_step_at_kill"] == 1 and res["leaves_compared"] > 50


def test_watchdog_reexecs_the_trainer_cli_which_resumes(tmp_path):
    """The synthetic trainer CLI with rss_limit_mb=1 for one epoch: the
    epoch's end re-execs the process with --resume latest, and the new
    process resumes from the epoch's checkpoint."""
    import os

    save = tmp_path / "run"
    env = {k: v for k, v in os.environ.items()
           if k != resilience._RSS_RESTART_ENV}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "virnet_tpu_torch.cli.train_denoising_syn",
         "--config", str(_cli_config(tmp_path, rss_limit_mb=1)),
         "--save_dir", str(save), "--device", "cpu", "--epochs", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    log = (save / "train.log").read_text()
    assert "re-exec #1 with --resume latest" in log
    assert "resumed at epoch 1, step 4" in log
    assert CheckpointManager(save).steps() == [1]


@pytest.mark.parametrize("route", ["pack", "device_data"])
def test_endurance_runs_on_the_cpu(route, tmp_path):
    """cli/endurance at a tiny size on the CPU (real mode's full-width
    model, 2 x 16^2, a seeded pack of 4 records): it steps, reports the
    share of time spent waiting on input, and its loss stays finite."""
    from virnet_tpu_torch.cli.endurance import main

    res = main(["--minutes", "0.002", "--mode", "real", "--batch_size", "2",
                "--patch_size", "16", "--pack_records", "4", "--sync_every",
                "1", "--save_dir", str(tmp_path), "--device", "cpu"]
               + (["--device_data"] if route == "device_data" else []))
    assert res["steps"] >= 1 and res["final_loss_finite"]
    assert res["device_data"] == (route == "device_data")
    assert 0.0 <= res["input_fraction"] < 1.0
