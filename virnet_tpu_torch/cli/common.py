"""Shared plumbing of the trainer command lines (counterpart of
virnet_tpu/cli/common.py)."""

from __future__ import annotations

import argparse
from typing import Dict

from ..config import as_bool, load_config, update_args

# config keys of the JAX trainers whose modules are not ported yet, with
# where ROADMAP.md queues them: by the item's title, never its number,
# which changes when the queue is renumbered
_QUEUE = "in ROADMAP.md's Queue 1, modules still to port"
_INPUT = f"the input pipeline, {_QUEUE}"
_RUNTIME = f"multi-device and runtime, {_QUEUE}"
UNPORTED = {
    "device_data": f"data/device_data.py ({_INPUT})",
    "train_pack_file": f"data/packdb.py ({_INPUT})",
    "auto_resume": f"train/resilience.py ({_RUNTIME})",
    "rss_limit_mb": f"train/resilience.py ({_RUNTIME})",
    "multihost": f"train/mesh.py ({_RUNTIME})",
    "coordinator_address": f"train/mesh.py ({_RUNTIME})",
    "num_processes": f"train/mesh.py ({_RUNTIME})",
    "process_id": f"train/mesh.py ({_RUNTIME})",
}
VALIDATION = ("per-epoch validation needs data/eval_sets.py and "
              "eval/metrics.py (metrics, eval sets and trainer validation, "
              f"{_QUEUE})")


def trainer_argparser(default_config: str,
                      description: str = "") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--save_dir", default=None, type=str,
                   help="path to save models and logs")
    p.add_argument("--config", default=default_config, type=str)
    p.add_argument("--resume", default=None, type=str,
                   help="'latest' or a saved epoch number")
    p.add_argument("--epochs", default=None, type=int)
    p.add_argument("--steps_per_epoch", default=None, type=int)
    p.add_argument("--batch_size", default=None, type=int)
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (default) or cpu")
    return p


def load_trainer_config(args) -> Dict:
    """The config file with the command line's overrides (``--device`` is
    the caller's, not the config's)."""
    return update_args(load_config(args.config),
                       {k: v for k, v in vars(args).items()
                        if k not in ("config", "device")})


def _asked(val) -> bool:
    """Whether a config value switches its feature on: a true boolean (or
    its "True"/"1" string), a non-zero number, or any other non-empty
    string (a path, an address)."""
    if val is None or val == "":
        return False
    try:
        return as_bool(val)
    except ValueError:
        return bool(val)


def refuse_unported(cfg: Dict) -> None:
    """Raise when the config asks for a module of the JAX trainers that is
    not ported yet, naming it: a run must not go on without what its
    config asked for."""
    for key, where in UNPORTED.items():
        if _asked(cfg.get(key)):
            raise NotImplementedError(
                f"config key {key!r} needs {where}, which is not ported yet")


def resume_epoch(trainer, resume, log_fn) -> int:
    """Restore ``resume`` ('latest' or a saved epoch number; nothing when
    empty) and return the epoch to continue from."""
    if not resume:
        return 0
    epoch = trainer.restore(None if resume == "latest" else int(resume))
    log_fn(f"resumed at epoch {epoch}, step {trainer.step}")
    return epoch
