"""The released real-noise denoiser (``denoising-real``: an 8-layer SNet
with a 3-channel sigma, a 4-level RNet at 96/160/224/288) that the
benchmark serves on whole photos (portbench/configs/denoising_real.json):
the port's model against the benchmark's plain reference at the preset's
published widths, and the span ``model.rnet.deep`` (RNet below its top
level, models/attresunet.py) with its reader.  CPU only: the port runs its
kernels' plain versions here.  Imports no JAX."""

import importlib.util
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.reference import models as R
from virnet_tpu_torch.eval import profiling
from virnet_tpu_torch.models import ARCH_PRESETS, build_model
from virnet_tpu_torch.models import attresunet
from virnet_tpu_torch.ops import fused_conv, resblock

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
CONFIGS = {"denoising-syn": "denoising_syn", "denoising-real": "denoising_real"}
# K11 launches a forward (two a body block) in all, and inside the deep
# span: syn's levels 1-2 down (6 blocks) and its level-1 up block (3);
# real's levels 1-3 down (9) and its level-2 and level-1 up blocks (6)
K11_LAUNCHES = {"denoising-syn": (30, 18), "denoising-real": (42, 30)}


def config(task):
    path = REPO / "portbench/configs" / f"{CONFIGS[task]}.json"
    return json.loads(path.read_text())


@pytest.fixture(autouse=True)
def _fresh():
    """No records from another test; one intra-op thread (the suite runs
    six workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.clear()
    yield
    profiling.clear()
    torch.set_num_threads(n)


def test_the_configuration_is_the_preset():
    cfg = config("denoising-real")
    arch = dict(cfg["arch"])
    assert arch.pop("cls") == "VIRNet" and cfg["reduced"] == []
    preset = dict(ARCH_PRESETS["denoising-real"])
    preset["n_feat"] = list(preset["n_feat"])
    assert arch == preset
    # the reference's tensors are the released file's, name and shape
    sd = R.load_state(REPO / cfg["weights"])
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: s for k, s, _ in R.param_specs(cfg["arch"])}


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("shape", [
    (1, 48, 64),     # multiples of 8: K3's fused head, RNet without a pad
    (1, 37, 53),     # odd: K2's SNet, RNet's reflect pad and head conv
])
def test_fp32_model_is_the_plain_reference(shape, seed):
    """The port's fp32 forward (plain kernel versions) against the plain
    reference on seeded weights of the preset's published widths.  Both
    sum in float32 in another order through some fifty chained convs of
    up to 9 x 288 terms: mu (magnitude ~2) read 1.2e-6 apart, sigma
    (exp of the logits, so the logits' absolute rounding becomes relative)
    4.5e-6; the tolerances keep some ten times that room."""
    arch = config("denoising-real")["arch"]
    p = R.seeded_params(arch, seed, CPU)
    model = build_model("denoising-real")
    model.load_state_dict(p, strict=True)
    model.eval()
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(*shape, 3, generator=g)
    with torch.no_grad():
        mu, sigma = model(x)
        want_mu, want_sigma = R.virnet(x.permute(0, 3, 1, 2), p, arch)
    assert sigma.shape == (*shape, 3)
    torch.testing.assert_close(mu, want_mu.permute(0, 2, 3, 1), rtol=0,
                               atol=2e-5)
    torch.testing.assert_close(sigma, want_sigma.permute(0, 2, 3, 1),
                               rtol=5e-5, atol=0)


def _counting(monkeypatch):
    """Every unconditioned block takes K11's route, whose CPU wrapper runs
    the plain version, and each call counts one launch, as the card's
    does: the launch counts of a forward on the card, here."""
    real = resblock.resblock_conv

    def counted(*a, **kw):
        fused_conv.LAUNCHES["resblock_conv"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(resblock, "resblock_conv", counted)
    monkeypatch.setattr(attresunet.AttResBlock, "takes_kernel",
                        lambda self, x, extra: not self.conditioned
                        and extra is None)


@pytest.mark.parametrize("task", sorted(CONFIGS))
@pytest.mark.parametrize("shape", [(1, 16, 24, 3), (1, 13, 19, 3)])
def test_deep_span_once_a_forward_and_launches_counted_once(
        task, shape, monkeypatch):
    from virnet_tpu_torch.eval.engine import Restorer

    _counting(monkeypatch)
    cfg = config(task)
    r = Restorer(task, ckpt_path=REPO / cfg["weights"], device="cpu")
    x = np.random.default_rng(0).random(shape, dtype=np.float32)
    before = sum(fused_conv.LAUNCHES.values())
    r.restore_batch(x)
    assert profiling.records() == []          # no session: nothing kept
    assert sum(fused_conv.LAUNCHES.values()) - before == \
        K11_LAUNCHES[task][0]
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            r.restore_batch(x)
    recs = profiling.records()
    by_id = {rec.id: rec for rec in recs}
    deep = [rec for rec in recs if rec.name == "model.rnet.deep"]
    assert len(deep) == 2                     # once a forward
    for rec in deep:
        assert by_id[rec.parent].name == "model.rnet"
    roots = ("engine.restore_batch",)
    total, inner = K11_LAUNCHES[task]
    # the root counts each launch once, nested spans or not
    assert profiling.call_values("launches", None, roots) == [total, total]
    assert profiling.call_values("launches", "model.rnet.deep", roots) == [
        inner, inner]
    assert profiling.call_values("launches", "model.rnet", roots) == [
        total, total]


def _reader(name):
    path = REPO / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_deep_reader_reads_the_median_request(monkeypatch):
    read = _reader("rnet_deep_card_ms.serve").read
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    assert read(on_card) is None              # nothing recorded
    recs, ids = [], iter(range(100))
    ms = 1_000_000
    for call, k in enumerate((3.0, 1.0, 2.0)):
        t = 1000.0 * call
        root = profiling.Record(next(ids), "engine.restore_batch", None,
                                call, int(t * ms), int((t + 40) * ms),
                                t * ms, (t + 41) * ms)
        rnet = profiling.Record(next(ids), "model.rnet", root.id, call,
                                int(t * ms), int((t + 30) * ms), t * ms,
                                (t + 30) * ms)
        deep = profiling.Record(next(ids), "model.rnet.deep", rnet.id, call,
                                int(t * ms), int((t + 9) * ms),
                                (t + 5) * ms, (t + 5 + 10 * k) * ms)
        recs += [root, rnet, deep]
    monkeypatch.setattr(profiling, "records", lambda: recs)
    assert read(on_card) == pytest.approx(20.0)
    assert read(types.SimpleNamespace(device=CPU)) is None


def test_deep_reader_has_its_manifest_entry():
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    m = {e["name"]: e for e in manifest["per_layer"]}[
        "rnet_deep_card_ms.serve"]
    assert m["source"] == "program_span" and m["layer"] == "models/"
    assert m["workloads"] == ["denoising_syn.serve_batch_bf16",
                              "denoising_real.serve_photo_bf16"]
