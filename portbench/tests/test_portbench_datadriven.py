"""A later change adds a cell, a traffic mix and a per-layer metric with
new files and manifest entries alone: no file of the harness is edited."""

import json

from portbench.tests.helpers import run_cell, tiny_root

READER = '''"""Host operators a request, from the traced tail."""


def read(ctx):
    if ctx.trace is None:
        return None
    return len(ctx.trace.host) / ctx.trace.units
'''


def test_a_new_cell_from_new_files(tmp_path):
    root = tiny_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    bench = root / "portbench"
    (bench / "traffic" / "serve_batch_fp32_iid.json").write_text(json.dumps(
        {"kind": "serve", "entry": "restore_batch", "compute": "fp32",
         "batch": 2, "shapes": [[24, 40]], "pool": 2, "noise": "iid",
         "noise_level": [5, 50], "warmup": 1, "sample": 2,
         "profile": 2}))
    (bench / "checks" / "denoising_syn.serve_batch_fp32_iid.json").write_text(
        json.dumps({"limits": {"gap_max": 1e-4}}))
    (bench / "metrics" / "host_ops.serve.py").write_text(READER)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cell = "denoising_syn.serve_batch_fp32_iid"
    manifest["workloads"].append(
        {"name": cell, "config": "denoising_syn",
         "traffic": "serve_batch_fp32_iid", "chips": 1, "why": "a test cell"})
    for m in manifest["end_to_end"]:
        if "workloads" in m and m["name"] != "train_samples_per_s":
            m["workloads"].append(cell)
    manifest["per_layer"].append(
        {"name": "host_ops.serve", "unit": "ops", "better": "lower",
         "source": "device_trace", "layer": "eval/engine.py",
         "moves": "restore_mp_per_s", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    for p, body in before.items():
        assert p.read_bytes() == body
    rc, res, _ = run_cell(root, cell, trace=0)
    assert rc == 0 and res["correct"] is True
    assert set(res["metrics"]) == {"restore_mp_per_s", "request_ms_p95",
                                   "setup_s"}
    rc, res, _ = run_cell(root, cell, trace=1)
    assert rc == 0 and res["metrics"]["host_ops.serve"]["value"] > 0
    assert res["metrics"]["host_ops.serve"]["unit"] == "ops"
