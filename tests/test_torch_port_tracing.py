"""The port's tracing (virnet_tpu_torch/eval/profiling.py): spans off
unless a torch.profiler session records, their records (parent, call,
host and card times, launches, self time), the bounded buffer, the spans
the Restorer and the SISR step record, and the benchmark's readers of
them (portbench/metrics/).  Imports no JAX; the card test skips without a
card and runs on one with

    python -m pytest --noconftest tests/test_torch_port_tracing.py -q
"""

import importlib.util
import json
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from virnet_tpu_torch.eval import profiling

REPO = Path(__file__).resolve().parents[1]
SYN = REPO / "model_zoo" / "virnet_denoising_syn_demo.pth"
SERVE_CELLS = ["denoising_syn.serve_batch_bf16",
               "denoising_syn.serve_image_fp32",
               "denoising_real.serve_photo_bf16"]
SERVE_SPANS = {"engine.restore_batch", "engine.copy_in", "model.snet",
               "model.rnet", "model.rnet.deep"}
TRAIN_SPANS = {"train.step", "train.data", "train.forward", "train.elbo",
               "train.backward", "optim.step"}


@pytest.fixture(autouse=True)
def _fresh():
    """No records from another test; one intra-op thread (the tier-1 run
    has six workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.clear()
    yield
    profiling.clear()
    torch.set_num_threads(n)


def _cpu_session():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_span_is_the_shared_noop_and_records_nothing():
    a, b = profiling.span("a"), profiling.span("b")
    assert a is b
    with a, b:
        pass
    assert profiling.records() == [] and profiling.dropped() == 0


def test_nested_spans_record_parent_call_times_and_self_time():
    with _cpu_session() as prof:
        with profiling.span("outer"):
            time.sleep(0.002)
            with profiling.span("inner"):
                time.sleep(0.004)
            with profiling.span("inner"):
                time.sleep(0.001)
        with profiling.span("outer"):
            pass
    recs = profiling.records()
    assert [r.name for r in recs] == ["outer", "inner", "inner", "outer"]
    o1, i1, i2, o2 = recs
    assert o1.parent is None and o2.parent is None
    assert i1.parent == i2.parent == o1.id
    assert i1.call == i2.call == o1.call != o2.call
    assert o1.host_start <= i1.host_start <= i1.host_end <= i2.host_start \
        <= i2.host_end <= o1.host_end <= o2.host_start
    assert all(r.card_start is None and r.launches == 0 for r in recs)
    s = profiling.summary()
    assert s["outer"]["count"] == 2 and s["outer"]["calls"] == 2
    assert s["inner"]["count"] == 2 and s["inner"]["calls"] == 1
    inner = profiling.host_ms(i1) + profiling.host_ms(i2)
    assert s["outer"]["self_host_ms"] == pytest.approx(
        s["outer"]["host_ms"] - inner)
    assert s["inner"]["self_host_ms"] == pytest.approx(inner)
    assert 2.0 <= s["outer"]["self_host_ms"] and 5.0 <= inner
    assert s["outer"]["card_ms"] is None
    assert profiling.call_values("host_ms", "inner") == [pytest.approx(
        inner)]
    assert len(profiling.call_values("host_ms")) == 2
    notes = {e.name for e in prof.events()
             if getattr(e, "is_user_annotation", False)}
    assert {"outer", "inner"} <= notes


def test_the_buffer_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "LIMIT", 3)
    with _cpu_session():
        for _ in range(5):
            with profiling.span("s"):
                pass
    assert len(profiling.records()) == 3 and profiling.dropped() == 2
    profiling.clear()
    assert profiling.records() == [] and profiling.dropped() == 0


def _names():
    return {r.name for r in profiling.records()}


@pytest.mark.parametrize("entry,shape", [
    ("restore_batch", (2, 16, 16, 3)),     # the fused head (K3's plain)
    ("restore_image", (13, 17, 3)),        # SNet, then RNet whole
])
def test_restorer_records_the_serving_spans(entry, shape):
    from virnet_tpu_torch.eval.engine import Restorer

    r = Restorer("denoising-syn", ckpt_path=SYN, device="cpu")
    x = np.random.default_rng(0).random(shape, dtype=np.float32)
    getattr(r, entry)(x)
    assert profiling.records() == []
    with _cpu_session():
        getattr(r, entry)(x)
    want = SERVE_SPANS | ({"engine.restore_image"}
                          if entry == "restore_image" else set())
    assert _names() == want
    roots = [rec for rec in profiling.records() if rec.parent is None]
    assert [rec.name for rec in roots] == [f"engine.{entry}"]
    assert len(profiling.call_values("host_ms", "engine.copy_in")) == 1


def test_sisr_step_records_the_training_spans(tmp_path):
    from virnet_tpu_torch.data.device_data import DeviceDataset
    from virnet_tpu_torch.train.loop_sisr import SISRTrainConfig, SISRTrainer

    cfg = SISRTrainConfig(n_feat=(16, 24, 32), dep_S=3, dep_K=2,
                          n_resblocks=1, batch_size=2, hr_size=16, sf=2,
                          k_size=7, mixed_precision=False,
                          save_dir=str(tmp_path))
    tr = SISRTrainer(cfg, device="cpu")
    recs = np.random.default_rng(0).integers(0, 256, (3, 24, 24, 3),
                                             dtype=np.uint8)
    ds = DeviceDataset(recs, device="cpu")
    with _cpu_session():
        tr.run_step_device(ds, 0)
        tr.run_step_device(ds, 0)
    # RNet's forward records its levels below the top inside the step's
    assert _names() == TRAIN_SPANS | {"model.rnet.deep"}
    assert len(profiling.call_values("host_ms", "train.elbo",
                                     ("train.step",))) == 2
    s = profiling.summary()
    phases = sum(s[n]["host_ms"] for n in TRAIN_SPANS - {"train.step"})
    assert phases <= s["train.step"]["host_ms"]


# ------------------------------------------------- the benchmark's readers

READS = {   # reader: (its value on the synthetic records, reads the card)
    "copy_in_host_ms.serve": (2.0, False),
    "copy_out_host_ms.serve": (1.5, False),
    "snet_card_ms.serve": (4.0, True),
    "rnet_card_ms.serve": (20.0, True),
    "own_launches.serve": (2, True),
    "data_host_ms.train": (3.0, False),
    "forward_host_ms.train": (4.0, False),
    "elbo_host_ms.train": (5.0, False),
    "backward_host_ms.train": (6.0, False),
    "optimizer_host_ms.train": (7.0, False),
    "queue_ms.train": (1.5, True),
    "own_launches.train": (4, True),
}
MS = 1_000_000


def _synthetic():
    """Three requests (one of them wrapped in restore_image) and three
    training steps, with card times; the middle call of each kind is the
    median, the others lie on either side of it."""
    ids = iter(range(1000))
    out = []

    def rec(name, parent, call, host, card=None, launches=0):
        r = profiling.Record(next(ids), name,
                             None if parent is None else parent.id, call,
                             int(host[0] * MS), int(host[1] * MS),
                             *(None, None) if card is None
                             else (card[0] * MS, card[1] * MS), launches)
        out.append(r)
        return r

    for call, k in enumerate((0.5, 1.0, 2.0)):
        t = 1000.0 * call
        parent = None
        if call == 1:
            parent = rec("engine.restore_image", None, call, (t, t + 40),
                         (t, t + 41), launches=round(2 * k))
        root = rec("engine.restore_batch", parent, call, (t, t + 40),
                   (t, t + 41), launches=round(2 * k))
        rec("engine.copy_in", root, call, (t, t + 2 * k))
        rec("engine.copy_out", root, call, (t + 38, t + 38 + 1.5 * k))
        rec("model.snet", root, call, (t + 3, t + 4), (t + 3, t + 3 + 4 * k),
            round(k))
        rec("model.rnet", root, call, (t + 5, t + 6),
            (t + 8, t + 8 + 20 * k), round(k))
    for step, k in enumerate((1.0, 0.5, 2.0)):
        t, call = 10000.0 + 1000.0 * step, 3 + step
        root = rec("train.step", None, call, (t, t + 30),
                   (t, t + 30 + 1.5 * k), launches=round(4 * k))
        for i, name in enumerate(("train.data", "train.forward",
                                  "train.elbo", "train.backward",
                                  "optim.step")):
            rec(name, root, call, (t, t + (3 + i) * k))
    return out


def _reader(name):
    path = REPO / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(READS))
def test_each_reader_reads_the_median_call(name, monkeypatch):
    want, card = READS[name]
    read = _reader(name).read
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    on_cpu = types.SimpleNamespace(device=torch.device("cpu"))
    assert read(on_card) is None                  # nothing recorded
    recs = _synthetic()
    monkeypatch.setattr(profiling, "records", lambda: recs)
    assert read(on_card) == pytest.approx(want)
    assert (read(on_cpu) is None) if card else \
        read(on_cpu) == pytest.approx(want)


def test_every_new_reader_has_its_manifest_entry():
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in manifest["per_layer"]}
    for name in READS:
        m = entries[name]
        assert m["source"] == ("program_counter" if "launches" in name
                               else "program_span")
        assert m["workloads"] == (SERVE_CELLS if name.endswith(".serve")
                                  else ["sisr_x4.train_bf16"])


# ------------------------------------------------------------------ the card

def test_card_spans_times_anchor_and_launches(tmp_path):
    """bf16 restore_batch at 32 x 256^2: the spans record under a session
    of the card alone, card times are ordered and nest, 32 launches (K3,
    K11 twice in each of the 15 body blocks, K4) a call, the numpy
    batch's result copied out in a span of its own, and trace() writes
    both files with the spans as user annotations on the kernels'
    clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: card times and launches exist "
                    "only on the card")
    from virnet_tpu_torch.eval.engine import Restorer

    r = Restorer("denoising-syn", ckpt_path=SYN, compute="bf16")
    x = np.random.default_rng(0).random((32, 256, 256, 3), dtype=np.float32)
    r.restore_batch(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        for _ in range(2):
            r.restore_batch(x)
    recs = profiling.records()
    assert {rec.name for rec in recs} == SERVE_SPANS | {"engine.copy_out"}
    by_id = {rec.id: rec for rec in recs}
    for rec in recs:
        assert rec.card_start is not None
        assert rec.card_start <= rec.card_end
        if rec.parent is not None:
            p = by_id[rec.parent]
            assert p.card_start <= rec.card_start <= rec.card_end \
                <= p.card_end
    roots = [rec for rec in recs if rec.parent is None]
    assert [rec.launches for rec in roots] == [32, 32]
    assert all(rec.card_end >= rec.host_start for rec in roots)
    # the forward's card time is most of the call's
    s = profiling.summary(recs)
    fwd = s["model.snet"]["card_ms"] + s["model.rnet"]["card_ms"]
    assert 0.5 * s["engine.restore_batch"]["card_ms"] < fwd \
        <= s["engine.restore_batch"]["card_ms"]

    profiling.clear()
    with profiling.trace(tmp_path / "tr"):
        r.restore_batch(x)
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    notes = {e["name"]: e for e in events
             if e.get("cat") == "user_annotation"}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert {"engine.copy_in", "engine.copy_out", "model.snet",
            "model.rnet"} <= set(notes)
    assert kernels
    k0 = min(e["ts"] for e in kernels)
    k1 = max(e["ts"] + e.get("dur", 0) for e in kernels)
    call = notes["engine.restore_batch"]
    assert call["ts"] <= k0 and k0 - call["ts"] < 1e6 and k1 > call["ts"]
    spans = json.loads((tmp_path / "tr" / "spans.json").read_text())
    assert {rec["name"] for rec in spans["records"]} == \
        SERVE_SPANS | {"engine.copy_out"}
    assert spans["summary"]["engine.restore_batch"]["launches"] == 32
