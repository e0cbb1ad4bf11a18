"""The harness's main: one run of one cell, its result as one JSON line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name BENCHMARK.json gives it:
``configs/<config>.json``, ``traffic/<traffic>.json`` (whose ``kind``
picks the serving or the training driver), ``checks/<cell>.json`` (the
numbers that decide ``correct`` and their limits), ``metrics/<metric>.py``
(a ``read(ctx)`` that returns the metric or None when it finds nothing to
read) and ``counts/<kernel>.py`` (a kernel's operations and bytes).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

from .cell import Cell, load_module

FORBIDDEN = ("jax", "jaxlib", "flax", "virnet_tpu")
EXIT_NO_CARD, EXIT_NO_PROGRAM, EXIT_JAX = 3, 2, 4


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def jax_loaded() -> list:
    """Top-level names in sys.modules that the run may not hold, compared
    whole (the port's own name begins with the JAX package's)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Context:
    """What a per-layer reader sees."""

    def __init__(self, cell, out, device, peaks):
        self.cell, self.out, self.device, self.peaks = cell, out, device, peaks
        self.trace = out.trace

    def counts(self, name: str):
        return load_module(self.cell.bench / "counts" / f"{name}.py")


def main(argv=None, root=None, t_process=None, device=None) -> int:
    """``device`` skips the look for a card (the harness's own tests drive
    a run on the CPU with it)."""
    t_process = time.perf_counter() if t_process is None else t_process
    args = parse(argv)
    root = Path(root)
    cell = Cell.load(root, args.workload)
    if importlib.util.find_spec("virnet_tpu_torch") is None:
        log("virnet_tpu_torch is not importable here: the benchmark needs "
            "the program's checkout around it")
        return EXIT_NO_PROGRAM
    import torch

    from . import device as card
    if device is None:
        try:
            device = card.require(cell.chips)
        except card.NoCard as exc:
            log(str(exc))
            return EXIT_NO_CARD
    torch.set_num_threads(2)
    driver = importlib.import_module(f"portbench.core.{cell.traffic['kind']}")
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace), device,
                     t_process)
    peaks = card.peaks(device)
    if args.trace:
        ctx = Context(cell, out, device, peaks)
        metrics = {}
        for m in cell.per_layer:
            value = load_module(cell.bench / "metrics" /
                                f"{m['name']}.py").read(ctx)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
    else:
        values = dict(out.end_to_end, setup_s=out.setup_s)
        metrics = {m["name"]: dict(value=values[m["name"]], unit=m["unit"])
                   for m in cell.end_to_end}
    dev = card.describe(device, cell.chips, out.memory_peak_bytes)
    if args.trace and out.trace is not None:
        dev.update(busy_s=out.trace.busy_s, window_s=out.trace.window_s)

    from .judge import verdict, worst_of
    judged = driver.judge(cell, out, device)
    answers = judged if isinstance(judged, list) else [judged]
    failed = sum(not verdict(a, cell.limits)[0] for a in answers)
    numbers = worst_of(answers)
    correct, rows = verdict(numbers, cell.limits)
    found = jax_loaded()
    if found:
        log(f"modules of JAX or the JAX package are loaded: {found}")
        return EXIT_JAX
    result = dict(correct=correct, attempted=out.attempted, failed=failed,
                  metrics=metrics, device=dev)
    if args.trace and out.trace is not None:
        result["breakdown"] = out.trace.breakdown()
    result["check"] = {name: dict(value=value, limit=limit)
                       for name, value, limit in rows}
    for k, v in list(numbers.items()) + list(out.extra.items()):
        if k not in cell.limits and isinstance(v, (int, float, str)):
            log(f"reading {k} {v}")
    for name, value, limit in rows:
        ok = (isinstance(value, (int, float)) and math.isfinite(value)
              and value <= limit)
        log(f"check {name} {value!r} limit {limit!r} "
            f"{'ok' if ok else 'FAIL'}")
    print(json.dumps(result), flush=True)
    return 0
