"""What one run of a cell hands back to the harness's main."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import torch


@dataclass
class Outcome:
    setup_s: float
    attempted: int             # requests or steps timed in the window
    window_s: float
    end_to_end: dict
    compute: str               # 'bf16' or 'fp32': the peak mfu reads
    unit_flops: float = 0.0    # model FLOPs of one request or step
    trace: Optional[Any] = None
    memory_peak_bytes: int = 0
    kept: list = field(default_factory=list)
    pools: Any = None
    extra: dict = field(default_factory=dict)

    def read_memory(self, device) -> None:
        if device.type == "cuda":
            torch.cuda.synchronize()
            self.memory_peak_bytes = int(
                torch.cuda.max_memory_allocated(device))
