"""virnet_tpu_torch — the PyTorch/CUDA port of virnet_tpu for NVIDIA Hopper.

The denoising VIRNet forward (SNet -> sigma epilogue -> RNet) served by
``Restorer`` and the demo CLI.  Every Pallas kernel on that path is a CUDA
C++ kernel for ``sm_90a`` under ``csrc/``, built with nvcc at first use and
bound with ctypes (``ops/_build.py``); each sits beside its plain PyTorch
version in ``ops/fused_conv.py``.  Public tensors are NHWC, like the JAX
package.  Entry points run on the card unless the caller passes
``device="cpu"``.

Layout
------
ops/      padding, ConvTranspose, the four kernel wrappers, image I/O, TTA
models/   torch.nn modules under the reference torch state-dict keys
eval/     Restorer (pad buckets, TTA, folder batches) and tiled inference
cli/      the demo command line
csrc/     the CUDA sources
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy convenience exports (importing the package builds nothing)."""
    if name in ("VIRNet", "build_model", "ARCH_PRESETS"):
        from . import models
        return getattr(models, name)
    if name == "Restorer":
        from .eval.engine import Restorer
        return Restorer
    if name in ("load_pth", "from_jax_params"):
        from . import convert
        return getattr(convert, name)
    raise AttributeError(name)
