"""On the card (skipped without one): a short run of every cell comes out
correct through the benchmark's own command, and each control and fault
its check lists (core/controls.py), put in the program's place at the
cell's own size, comes out not correct."""

import json
import subprocess
import sys
import time

import pytest

from portbench.tests.helpers import REPO

MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark runs on the card only")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(card, cell):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "2147483711", "--seconds", "2", "--trace", "0"], cwd=REPO,
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, proc.stderr[-2000:]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1


def _fails(cell, numbers) -> bool:
    from portbench.core.judge import verdict, worst_of

    answers = numbers if isinstance(numbers, list) else [numbers]
    return not verdict(worst_of(answers), cell.limits)[0]


@pytest.mark.parametrize("cell", CELLS)
def test_every_control_is_not_correct(card, cell):
    from portbench.core import controls, serve, train
    from portbench.core.cell import Cell

    c = Cell.load(REPO, cell)
    seed = 2147483712
    if c.traffic["kind"] == "train":
        out = train.run(c, seed, 0.0, False, card, time.perf_counter())
        ref = train.reference_steps(c, out, card)
        for name in c.check["controls"]:
            assert _fails(c, controls.training(name, c, seed, out, ref,
                                               card)), name
        return
    for name in c.check["controls"]:
        out = serve.run(c, seed, 1.0, False, card, time.perf_counter(),
                        make_call=controls.serving(name))
        assert _fails(c, serve.judge(c, out, card)), name
