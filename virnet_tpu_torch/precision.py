"""Compute modes (counterpart of virnet_tpu/precision.py).

* ``'fp32'`` — the parity mode: fp32 weights and activations, and TF32
  off for both cuDNN convolutions and matmuls, which is what
  ``Precision.HIGHEST`` means on the TPU side.
* ``'bf16'`` — the fast path: bf16 weights and activations, fp32 image in
  and out (the RNet residual and the restored image stay fp32).
* ``'int8'`` — quantized serving: the convolutions that the int8 gate takes
  (``models/common.int8_gated``) run W8A8 (ops/qconv.py, K9 on the card)
  from their fp32 weights, everything else as in ``'bf16'``
  (``int8_convs``).  Not checkpoint-faithful: its cost is measured.

Serving in fp32 on the card runs the library convolutions on PyTorch's
im2col route (im2col and a cuBLAS sgemm, TF32 off) instead of cuDNN
(``im2col_convs``): with TF32 off, cuDNN's heuristics pick FFT algorithms
for RNet's 3x3 convolutions at many image sizes (on an H100, 396,288 gemv
launches and 1.26 s of device time for one 321x481 image), while the
im2col route serves the image in about 33 ms.  bf16 keeps cuDNN, whose
bf16 kernels are the faster route.  Where cuDNN does not pick FFT it is
up to about a fifth faster in fp32 (PERF.md); a trial per shape would
cost the FFT forward itself, so the route holds for every shape.  The
choice is a context variable that
the port's convolution helpers (``models/common.conv``,
``ops/upsample.conv_transpose_2x2``) read: it holds for the thread (or
task) that set it and for the block alone, and no process-wide flag
changes.
"""

from __future__ import annotations

import contextlib
import contextvars

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


@contextlib.contextmanager
def train_step_mode():
    """The trainers' flag scope: TF32 off (``parity_mode``), and cuDNN on
    deterministic algorithms with autotuning off, so that the same steps
    give the same bits on every run (the trainers' contract is bitwise
    resume, train/checkpoint.py); the process-wide flags are put back as
    they were on the way out."""
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        with parity_mode():
            yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


_IM2COL = contextvars.ContextVar("virnet_tpu_torch_im2col_convs",
                                 default=False)


@contextlib.contextmanager
def im2col_convs(on: bool = True):
    """The port's convolutions take the im2col route inside the block when
    ``on`` (see the module docstring); the route before the block holds
    again on the way out.  Nests, and other threads do not see it."""
    token = _IM2COL.set(bool(on))
    try:
        yield
    finally:
        _IM2COL.reset(token)


def im2col_on() -> bool:
    """Whether the current block asks for the im2col route."""
    return _IM2COL.get()


_INT8 = contextvars.ContextVar("virnet_tpu_torch_int8_convs", default=None)


@contextlib.contextmanager
def int8_convs(dtype=torch.bfloat16):
    """Inside the block the convolutions that the int8 gate takes run W8A8
    and write ``dtype``, the compute dtype (``models/common.conv``); None
    switches the mode off.  A context variable like ``im2col_convs``:
    nests, and other threads do not see it."""
    token = _INT8.set(dtype)
    try:
        yield
    finally:
        _INT8.reset(token)


def int8_dtype():
    """The output dtype of the int8 mode of the current block, or None when
    the mode is off."""
    return _INT8.get()


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  Raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain PyTorch "
            "versions of the kernels on the CPU")
    return dev
