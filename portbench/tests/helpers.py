"""A small copy of the benchmark for CPU tests: the harness's files, the
manifest, and traffic and configurations small enough for the CPU; the
released weights through a link to the checkout's model_zoo.  The tiny
serving mixes run fp32 and the tiny training step without autocast: on
the CPU, bf16 at these sizes says nothing about the card's rounding, and
what the CPU tests hold is the harness's path and its faults."""

from __future__ import annotations

import contextlib
import io
import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_TRAFFIC = {
    "serve_batch_bf16": {"kind": "serve", "entry": "restore_batch",
                         "compute": "fp32", "batch": 2,
                         "shapes": [[32, 32]], "pool": 2, "noise": "niid",
                         "noise_level": [0, 75], "warmup": 1, "sample": 2,
                         "profile": 2},
    "serve_image_fp32": {"kind": "serve", "entry": "restore_image",
                         "compute": "fp32", "batch": 1,
                         "shapes": [[21, 29], [29, 21]], "pool": 2,
                         "noise": "niid", "noise_level": [0, 75],
                         "warmup": 1, "sample": 2, "profile": 2},
    "train_bf16": {"kind": "train", "records": 4, "record_size": 64,
                   "draw_sets": 6, "checked_steps": 3, "warmup_steps": 1,
                   "profile": 2},
}
TINY_TRAIN = {"batch_size": 2, "hr_size": 48, "mixed_precision": False}
TINY_SR_ARCH = {"n_feat": [16, 32, 48], "dep_K": 2, "n_resblocks": 1}


def tiny_root(tmp: Path, limits: dict | None = None) -> Path:
    """A checkout-like directory: BENCHMARK.json, portbench/ with the
    tiny traffic, a tiny training configuration, and model_zoo/."""
    root = tmp / "root"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "model_zoo").symlink_to(REPO / "model_zoo")
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for name, spec in TINY_TRAFFIC.items():
        (root / "portbench" / "traffic" / f"{name}.json").write_text(
            json.dumps(spec))
    # the training cell takes a configuration of its own, cut to the CPU
    configs = root / "portbench" / "configs"
    cfg = json.loads((configs / "sisr_x4.json").read_text())
    cfg["arch"].update(TINY_SR_ARCH)
    cfg["train"].update(TINY_TRAIN)
    (configs / "sisr_x4_tiny.json").write_text(json.dumps(cfg))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append(dict(
        name="sisr_x4_tiny", source="a CPU test's cut of sisr_x4",
        file="portbench/configs/sisr_x4_tiny.json", reduced=["arch"],
        why="CPU tests"))
    for w in manifest["workloads"]:
        if w["name"] == "sisr_x4.train_bf16":
            w["config"] = "sisr_x4_tiny"
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    for cell, lim in (limits or {}).items():
        (root / "portbench" / "checks" / f"{cell}.json").write_text(
            json.dumps({"limits": lim}))
    return root


def run_cell(root: Path, cell: str, seed: int = 5, seconds: float = 0.5,
             trace: int = 0) -> tuple:
    """(exit code, the last stdout line as JSON or None, stderr) of one run
    of ``cell`` on the CPU, in this process."""
    import torch

    sys.path.insert(0, str(root))
    for name in [m for m in sys.modules if m == "portbench"
                 or m.startswith("portbench.")]:
        del sys.modules[name]
    try:
        from portbench.core.main import main
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(["--workload", cell, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", str(trace)], root=root,
                      device=torch.device("cpu"))
    finally:
        sys.path.remove(str(root))
        for name in [m for m in sys.modules if m == "portbench"
                     or m.startswith("portbench.")]:
            del sys.modules[name]
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
