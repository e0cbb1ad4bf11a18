#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, on the card: the
numbers each cell compares, for the program on many seeds and for the
control on a few, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--seconds 2] [--out PATH]

The controls are those the cell's ``checks/<cell>.json`` lists
(core/controls.py): what a later change could be tempted to put in the
program's place, one precision below the one the cell states, and the
faults a training step can have.  Every number the harness computes is
read, compared or not.  Prints one JSON object a reading and a summary:
the program's largest reading of each number and each control's
smallest.
"""

import time

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    from run import fixed_caches

    fixed_caches(ROOT)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.core import controls, device as card, serve, train
    from portbench.core.cell import Cell
    from portbench.core.judge import train_gaps, worst_of

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    cell = Cell.load(ROOT, args.workload)
    dev = card.require(cell.chips)
    seeds = [int(s) for s in args.seeds.split(",")]
    cseeds = [int(s) for s in args.control_seeds.split(",")]
    names = cell.check["controls"]
    rows = []

    def record(who, seed, numbers, secs):
        row = dict(who=who, seed=seed, seconds=secs, **numbers)
        rows.append(row)
        print(json.dumps(row), flush=True)

    if cell.traffic["kind"] == "serve":
        for who in ["program", *names]:
            make = None if who == "program" else controls.serving(who)
            for seed in (seeds if who == "program" else cseeds):
                t = time.perf_counter()
                out = serve.run(cell, seed, args.seconds, False, dev,
                                time.perf_counter(), make_call=make)
                nums = worst_of(serve.judge(cell, out, dev))
                nums.update(requests=out.attempted,
                            mp_per_s=out.end_to_end["restore_mp_per_s"])
                record(who, seed, nums, time.perf_counter() - t)
    else:
        for seed in seeds:
            t = time.perf_counter()
            out = train.run(cell, seed, args.seconds, False, dev,
                            time.perf_counter())
            ref = train.reference_steps(cell, out, dev)
            nums = train_gaps(out.extra["prog"], ref, out.extra["params0"])
            nums.update(steps=out.attempted, loss=out.extra["prog"]["loss"])
            record("program", seed, nums, time.perf_counter() - t)
            for who in (names if seed in cseeds else []):
                t = time.perf_counter()
                record(who, seed, controls.training(who, cell, seed, out,
                                                    ref, dev),
                       time.perf_counter() - t)
            del out
            torch.cuda.empty_cache()
    summary = {}
    for r in rows:
        for k, v in r.items():
            if isinstance(v, float) and k != "seconds":
                key = f"{r['who']}.{k}"
                agg = max if r["who"] == "program" else min
                summary[key] = agg(summary.get(key, v), v)
    print(json.dumps(dict(summary=summary, card=torch.cuda.get_device_name(),
                          power_limit_w=card.power_limit_w(dev))), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(rows=rows, summary=summary)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
