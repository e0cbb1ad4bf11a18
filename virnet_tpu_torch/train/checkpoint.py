"""Checkpointing of the full train state: parameters, Adam moments, the
step and epoch counters and the generator's state (counterpart of
virnet_tpu/train/checkpoint.py).

One file per saved step, ``<save_dir>/ckpts/step_<step>.pt``, written with
``torch.save`` to a temporary name and renamed, read with
``torch.load(weights_only=True)``.  The contract is bitwise resume:
restoring and stepping gives what stepping without the restore gives.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch


class CheckpointManager:
    def __init__(self, save_dir, max_to_keep: int = 5):
        self.dir = Path(save_dir).absolute() / "ckpts"
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}.pt"

    def steps(self) -> List[int]:
        return sorted(int(p.stem.split("_")[1])
                      for p in self.dir.glob("step_*.pt"))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Dict[str, Any]) -> None:
        tmp = self._path(step).with_suffix(f".tmp{os.getpid()}")
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-self.max_to_keep]:
            self._path(old).unlink()

    def restore(self, step: Optional[int] = None,
                map_location="cpu") -> Optional[Dict[str, Any]]:
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        return torch.load(self._path(step), map_location=map_location,
                          weights_only=True)
