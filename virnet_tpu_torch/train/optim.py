"""Optimizer stack: warmup+cosine epoch schedule, per-subnet gradient
clipping, Adam (counterpart of virnet_tpu/train/optim.py).

Schedule semantics replicate GradualWarmupScheduler(multiplier=1) wrapping
CosineAnnealingLR (reference train_denoising_syn.py:77-85), stepped per
*epoch*:

    lr(e) = base * (e+1)/warmup                      e <  warmup
    lr(e) = lr_min + (base-lr_min)(1+cos(pi e'/T))/2  e >= warmup,
            e' = e - warmup, T = epochs - warmup

Per-subnet clipping replicates the reference's separate
``clip_grad_norm_(param_R/S/K)`` calls (train_SISR.py:226-228): the global
norm is computed and clipped independently over each subnet's parameters,
with the scale min(1, max_norm / (norm + 1e-6)).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn


def warmup_cosine_epoch_schedule(base_lr: float, lr_min: float, epochs: int,
                                 warmup_epochs: int,
                                 steps_per_epoch: int) -> Callable[[int], float]:
    """schedule(step) -> learning rate, constant within each epoch."""
    t_max = max(epochs - warmup_epochs, 1)

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        if epoch < warmup_epochs:
            return base_lr * (epoch + 1.0) / max(warmup_epochs, 1)
        e_cos = max(epoch - warmup_epochs, 0)
        return lr_min + 0.5 * (base_lr - lr_min) * (
            1.0 + math.cos(math.pi * e_cos / t_max))

    return schedule


def _grads(module: nn.Module):
    return [p.grad for p in module.parameters() if p.grad is not None]


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (a 0-d tensor)."""
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(grads)))


def subnet_grad_norms(subnets: Dict[str, nn.Module]) -> Dict[str, torch.Tensor]:
    """Pre-clip gradient norm per subnet (for logging, as the reference
    logs GNorm_D / GNorm_S)."""
    return {name: global_norm(_grads(m)) for name, m in subnets.items()}


def clip_by_subnet_norm(subnets: Dict[str, nn.Module],
                        clip_map: Dict[str, float],
                        norms: Dict[str, torch.Tensor]) -> None:
    """Scale each listed subnet's gradients in place by
    min(1, max_norm / (norm + 1e-6)), ``norms`` being their pre-clip norms;
    subnets not listed pass unclipped.  No host synchronisation: the scale
    stays on the device."""
    for name, max_norm in clip_map.items():
        scale = torch.clamp(max_norm / (norms[name] + 1e-6), max=1.0)
        torch._foreach_mul_(_grads(subnets[name]), scale)


class SubnetAdam:
    """clip-per-subnet -> Adam (betas 0.9/0.999, eps 1e-8) with the
    warmup+cosine epoch schedule: the learning rate of update number t
    (0-based) is schedule(t), as optax evaluates a schedule."""

    def __init__(self, subnets: Dict[str, nn.Module], base_lr: float,
                 lr_min: float, epochs: int, warmup_epochs: int,
                 steps_per_epoch: int,
                 clip_map: Optional[Dict[str, float]] = None):
        self.subnets = subnets
        self.clip_map = dict(clip_map or {})
        self.schedule = warmup_cosine_epoch_schedule(
            base_lr, lr_min, epochs, warmup_epochs, steps_per_epoch)
        # the parameters in a fixed order (subnets, then each one's own)
        self.params = [p for m in subnets.values() for p in m.parameters()]
        self.adam = torch.optim.Adam(self.params, lr=base_lr,
                                     betas=(0.9, 0.999),
                                     eps=1e-8)
        self.count = 0

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> Dict[str, torch.Tensor]:
        """Clip, update, count.  Returns the pre-clip norm per subnet."""
        norms = subnet_grad_norms(self.subnets)
        clip_by_subnet_norm(self.subnets, self.clip_map, norms)
        lr = self.schedule(self.count)
        for group in self.adam.param_groups:
            group["lr"] = lr
        self.adam.step()
        self.count += 1
        return norms

    def state_dict(self) -> dict:
        return dict(adam=self.adam.state_dict(), count=self.count)

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])
