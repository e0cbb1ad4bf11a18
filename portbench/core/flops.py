"""Model FLOPs of one forward, counted from the configuration's layer
shapes: the plain reference model run on the meta device under
``torch.utils.flop_counter.FlopCounterMode``, which counts 2 FLOPs per
multiply-add of every convolution and matrix product over its whole
(padded) input, as thop counts MACs, and no elementwise work.  Nothing is
computed and no weight is read.
"""

from __future__ import annotations

from functools import lru_cache

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference.models import param_specs, virnet, virnet_sr


def _freeze(arch: dict) -> tuple:
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                        for k, v in arch.items()))


@lru_cache(maxsize=64)
def _forward_flops(arch_items: tuple, n: int, h: int, w: int,
                   sf: int) -> float:
    arch = {k: list(v) if isinstance(v, tuple) else v for k, v in arch_items}
    with torch.device("meta"):
        p = {k: torch.empty(shape) for k, shape, _ in param_specs(arch)}
        x = torch.empty(n, arch["im_chn"], h, w)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        if arch["cls"] == "VIRNetSR":
            virnet_sr(x, sf, p, arch)
        else:
            virnet(x, p, arch)
    return float(counter.get_total_flops())


def forward_flops(arch: dict, n: int, h: int, w: int, sf: int = 1) -> float:
    """FLOPs of one forward of ``arch`` on an (n, h, w) input (the LR input
    of the SISR model at scale ``sf``)."""
    return _forward_flops(_freeze(arch), n, h, w, sf)
