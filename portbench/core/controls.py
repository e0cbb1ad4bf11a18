"""The controls and faults a cell's check has to fail, by the names its
``checks/<cell>.json`` lists under ``controls``.

Serving: ``int8``, the program's own int8 path (``compute='int8'``);
``ref_fp8``, the plain reference with every convolution's input and weight
rounded to fp8 (e4m3, one scale a tensor); ``ref_tf32``, the plain
reference with TF32 on.  Each is a request function put in the program's
place.  Training: ``ref_fp8``, the reference's steps with fp8
convolutions; ``half_batch``, the reference's steps with the second half
of every batch left out; ``unchanged``, the program's trainer with a step
that leaves its state unchanged.
"""

from __future__ import annotations

import time

from . import serve, train
from .judge import train_gaps


def serving(name: str):
    from ..reference.models import fp8_quant

    return {"int8": lambda c, d: serve.program(c, d, "int8"),
            "ref_fp8": lambda c, d: serve.reference(c, d, fp8_quant),
            "ref_tf32": lambda c, d: serve.reference(c, d, tf32=True),
            }[name]


def unchanged_state(cell, device):
    """The program's trainer whose optimizer computes its norms and
    updates nothing."""
    from virnet_tpu_torch.train.optim import subnet_grad_norms

    trainer, dataset, step = train.program(cell, device)
    trainer.optim.step = lambda: subnet_grad_norms(trainer.optim.subnets)
    return trainer, dataset, step


def training(name: str, cell, seed: int, out, ref: dict, device) -> dict:
    """The numbers of training control ``name`` on ``out``'s weights,
    records and draws, against the reference's steps ``ref``."""
    from ..reference.models import fp8_quant

    if name == "unchanged":
        frozen = train.run(cell, seed, 0.0, False, device,
                           time.perf_counter(), make_program=unchanged_state)
        return train.judge(cell, frozen, device)
    kw = dict(quant=fp8_quant) if name == "ref_fp8" else dict(half_batch=True)
    return train_gaps(train.reference_steps(cell, out, device, **kw), ref,
                      out.extra["params0"])
