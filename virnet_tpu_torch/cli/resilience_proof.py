"""Kill/resume bitwise-equivalence proof for the training runtime
(counterpart of virnet_tpu/cli/resilience_proof.py).

The reference's crash story is a manual restart that reloads weights only
and replays the LR scheduler (train_denoising_syn.py:91-105, 262-268), so
an interrupted run and an uninterrupted run end at different optimizer
states.  The port checkpoints the full train state (parameters, Adam
moments, counters and the generator, train/checkpoint.py) and draws every
step's randomness from (seed, epoch, step), so the claim is stronger: a
run SIGKILLed mid-epoch and resumed from its last epoch checkpoint ends
with bitwise the state of a run that was never interrupted.

The proof drives the denoising trainer CLI as subprocesses:

  run A:  train --config ...                      (uninterrupted)
  run B:  train --config ...                      (SIGKILL mid-epoch)
          train --config ... --resume latest      (relaunch)
  check:  the final checkpoints of A and B are equal tensor for tensor,
          bitwise (parameters, optimizer state, counters, generator)

    python -m virnet_tpu_torch.cli.resilience_proof \
        --config configs/denoising_syn.json --epochs 2 \
        --steps_per_epoch 20 --work_dir ./resilience \
        --override train_data='[["/path/to/pool", "*.png"]]' [--device cpu]

It prints one JSON line and exits non-zero when the states differ.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

TRAINER = "virnet_tpu_torch.cli.train_denoising_syn"


def _write_cfg(base: dict, save_dir: Path, path: Path) -> Path:
    cfg = dict(base)
    cfg["save_dir"] = str(save_dir)
    path.write_text(json.dumps(cfg, indent=1))
    return path


def _spawn(cfg_path: Path, device: str, *extra: str) -> subprocess.Popen:
    cmd = [sys.executable, "-m", TRAINER, "--config", str(cfg_path),
           "--device", device, *extra]
    return subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                            stderr=subprocess.STDOUT)


def _wait(proc: subprocess.Popen, timeout_s: float) -> int:
    try:
        return proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise SystemExit(f"child pid {proc.pid} timed out after "
                         f"{timeout_s:.0f}s")


def _wait_for_marker(log_path: Path, pattern: str, proc: subprocess.Popen,
                     timeout_s: float) -> bool:
    """Poll ``log_path`` until a line matches ``pattern`` (True), or the
    process exits or the time runs out (False)."""
    rx = re.compile(pattern)
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if log_path.exists() and rx.search(
                log_path.read_text(errors="replace")):
            return True
        if proc.poll() is not None:
            return False
        time.sleep(0.05)
    return False


def _final_state(save_dir: Path):
    from ..train.checkpoint import CheckpointManager

    mngr = CheckpointManager(save_dir)
    step = mngr.latest_step()
    if step is None:
        raise RuntimeError(f"no checkpoint under {save_dir}")
    return step, mngr.restore(step)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def compare_states(state_a, state_b):
    """Leaf-for-leaf bitwise comparison of two checkpoint trees; returns
    (match, number of leaves, the mismatches)."""
    la, lb = list(_leaves(state_a)), list(_leaves(state_b))
    if [p for p, _ in la] != [p for p, _ in lb]:
        return False, len(la), ["tree structure differs"]
    bad = []
    for (path, a), (_, b) in zip(la, lb):
        if torch.is_tensor(a) and torch.is_tensor(b):
            same = (a.shape == b.shape and a.dtype == b.dtype
                    and torch.equal(a, b))
            diff = (float((a.double() - b.double()).abs().max())
                    if not same and a.shape == b.shape
                    and a.dtype == b.dtype and a.is_floating_point()
                    else "shape/dtype/values")
        else:
            same, diff = a == b, f"{a!r} vs {b!r}"
        if not same:
            bad.append(f"{path}: {diff}")
    return not bad, len(la), bad


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--steps_per_epoch", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--work_dir", default="./resilience_proof")
    p.add_argument("--kill_epoch", type=int, default=None,
                   help="1-based epoch to SIGKILL run B in (default: last)")
    p.add_argument("--kill_step", type=int, default=None,
                   help="step within the epoch whose log line triggers the "
                        "kill (default: steps_per_epoch // 2, rounded to "
                        "print_freq)")
    p.add_argument("--timeout_s", type=float, default=3600.0,
                   help="per-phase timeout")
    p.add_argument("--device", default="cuda",
                   help="the trainers' device (cuda, or cpu)")
    p.add_argument("--override", action="append", default=[],
                   metavar="KEY=JSON", help="config override, the value "
                   "parsed as JSON (else taken as a string)")
    args = p.parse_args(argv)

    from ..config import load_config
    from ..train.checkpoint import CheckpointManager

    base = load_config(args.config)
    base["epochs"] = args.epochs
    base["steps_per_epoch"] = args.steps_per_epoch
    if args.batch_size:
        base["batch_size"] = args.batch_size
    for ov in args.override:
        k, _, v = ov.partition("=")
        try:
            base[k] = json.loads(v)
        except json.JSONDecodeError:
            base[k] = v

    work = Path(args.work_dir)
    work.mkdir(parents=True, exist_ok=True)
    dir_a, dir_b = work / "run_a", work / "run_b"
    cfg_a = _write_cfg(base, dir_a, work / "cfg_a.json")
    cfg_b = _write_cfg(base, dir_b, work / "cfg_b.json")

    kill_epoch = args.kill_epoch or args.epochs
    print_freq = int(base.get("print_freq", 100))
    kill_step = args.kill_step or args.steps_per_epoch // 2
    kill_step = max(print_freq, (kill_step // print_freq) * print_freq)
    # the trainer's progress-line format (train/loop_denoise.py)
    marker = (rf"\[Epoch:\s*{kill_epoch}/.*train:"
              rf"{kill_step:05d}/{args.steps_per_epoch:05d}")

    t0 = time.monotonic()
    print(f"[resilience] run A (uninterrupted) -> {dir_a}", flush=True)
    rc = _wait(_spawn(cfg_a, args.device), args.timeout_s)
    if rc != 0:
        raise SystemExit(f"run A failed rc={rc} (log: {dir_a}/train.log)")
    t_a = time.monotonic() - t0

    print(f"[resilience] run B: SIGKILL at epoch {kill_epoch} step "
          f"{kill_step}", flush=True)
    proc = _spawn(cfg_b, args.device)
    if not _wait_for_marker(dir_b / "train.log", marker, proc,
                            args.timeout_s):
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        raise SystemExit(f"run B never reached the kill marker {marker!r} "
                         f"(log: {dir_b}/train.log)")
    proc.kill()                      # SIGKILL: no cleanup, no atexit
    proc.wait()
    at_kill = CheckpointManager(dir_b).latest_step()
    if at_kill is not None and at_kill >= kill_epoch:
        raise SystemExit(
            f"run B wrote epoch {at_kill}'s checkpoint before the kill "
            f"landed: no proof; give the epoch more steps after the kill "
            f"step")
    print(f"[resilience] SIGKILLed run B (pid {proc.pid}) with its latest "
          f"checkpoint at epoch {at_kill}; relaunching with --resume "
          f"latest", flush=True)
    rc = _wait(_spawn(cfg_b, args.device, "--resume", "latest"),
               args.timeout_s)
    if rc != 0:
        raise SystemExit(f"run B resume failed rc={rc} "
                         f"(log: {dir_b}/train.log)")

    step_a, state_a = _final_state(dir_a)
    step_b, state_b = _final_state(dir_b)
    match, n_leaves, bad = compare_states(state_a, state_b)
    result = {
        "metric": "resilience_bitwise_resume",
        "match": bool(match and step_a == step_b),
        "final_ckpt_step": [int(step_a), int(step_b)],
        "leaves_compared": int(n_leaves),
        "epochs": args.epochs,
        "steps_per_epoch": args.steps_per_epoch,
        "killed_at": f"epoch {kill_epoch} step {kill_step}",
        "ckpt_step_at_kill": None if at_kill is None else int(at_kill),
        "run_a_wall_s": round(t_a, 1),
        "device": args.device,
        "mismatched_leaves": bad[:10],
    }
    print(json.dumps(result), flush=True)
    if not result["match"]:
        raise SystemExit(1)
    return result


if __name__ == "__main__":
    main()
