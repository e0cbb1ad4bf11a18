"""Model analysis: parameter counts, FLOPs, timing (counterpart of
virnet_tpu/eval/analysis.py; the reference's thop and CUDA-event tooling,
utils/util_net.py:10-18, 82-98).

FLOPs come from torch.utils.flop_counter.FlopCounterMode, which counts the
convolutions and matrix products of one call (2 per multiply-add) and no
elementwise work; XLA's cost analysis, which the JAX package reads, counts
that too, so the JAX figures are somewhat higher.  The port's kernels (K2,
K3, K4) are opaque to the counter and would count 0, so ``model_flops``
counts a ``conv_impl='torch'`` build of the model on the meta device: the
same layers, no weights or data, nothing computed.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode


def calculate_parameters(model) -> int:
    """Parameters of an nn.Module, or elements of a state dict."""
    tensors = (model.parameters() if isinstance(model, torch.nn.Module)
               else model.values())
    return sum(int(t.numel()) for t in tensors)


def calculate_flops(fn: Callable, *args) -> float:
    """FLOPs of one call of ``fn(*args)``: its convolutions and matrix
    products, 2 per multiply-add."""
    counter = FlopCounterMode(display=False)
    with torch.inference_mode(), counter:
        fn(*args)
    return float(counter.get_total_flops())


def model_flops(task: str, h: int, w: int, sf: Optional[int] = None,
                **overrides) -> float:
    """FLOPs of one forward of the ``task`` preset (with ``overrides``) on
    a 1 x h x w x 3 input (the LR input for SISR at scale ``sf``), counted
    on a ``conv_impl='torch'`` build on the meta device (see the module
    docstring)."""
    from ..models import build_model

    overrides = dict(overrides, conv_impl="torch")
    with torch.device("meta"):
        model = build_model(task, **overrides).eval()
        x = torch.zeros(1, h, w, 3)
    return calculate_flops(model, *((x,) if sf is None else (x, sf)))


def measure_time(fn: Callable, args, num_forward: int = 100) -> float:
    """Mean seconds per call of ``fn(*args)`` after one warm-up call, the
    run ending in a synchronisation with the card when there is one."""
    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    fn(*args)
    sync()
    tic = time.perf_counter()
    for _ in range(num_forward):
        fn(*args)
    sync()
    return (time.perf_counter() - tic) / num_forward


def schedule_preview(schedule: Callable, epochs: int,
                     steps_per_epoch: int) -> Dict[int, float]:
    """Per-epoch learning rates (reference util_net.test_scheduler)."""
    return {e: float(schedule(e * steps_per_epoch)) for e in range(epochs)}


def calculate_eta_min(epochs: int, eta_max: float, lr_min: float,
                      t_max: int) -> float:
    """The cosine schedule's eta_min that ends at ``lr_min`` (reference
    utils/util_net.py:67-74)."""
    coef = 0.5 * (1 + math.cos((epochs - 1) / t_max * math.pi))
    return (lr_min - eta_max * coef) / (1 - coef)
