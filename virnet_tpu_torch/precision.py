"""Compute modes (counterpart of virnet_tpu/precision.py).

* ``'fp32'`` — the parity mode: fp32 weights and activations, and TF32
  off for both cuDNN convolutions and matmuls, which is what
  ``Precision.HIGHEST`` means on the TPU side.
* ``'bf16'`` — the fast path: bf16 weights and activations, fp32 image in
  and out (the RNet residual and the restored image stay fp32).
"""

from __future__ import annotations

import contextlib

import torch

COMPUTE_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def compute_dtype(compute: str) -> torch.dtype:
    if compute not in COMPUTE_DTYPES:
        raise ValueError(f"compute must be fp32|bf16, got {compute!r}")
    return COMPUTE_DTYPES[compute]


def set_parity_mode() -> None:
    """Full fp32 convolutions and matmuls on the card (TF32 off), for the
    whole process from here on."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@contextlib.contextmanager
def parity_mode():
    """TF32 off inside the block; the two process-wide flags are put back
    as they were on the way out."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    set_parity_mode()
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  Raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain PyTorch "
            "versions of the kernels on the CPU")
    return dev
