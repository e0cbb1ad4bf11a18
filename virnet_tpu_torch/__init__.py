"""virnet_tpu_torch — the PyTorch/CUDA port of virnet_tpu for NVIDIA Hopper.

Three paths so far: the denoising VIRNet forward (SNet -> sigma epilogue
-> RNet) served by ``Restorer`` and the demo CLI; the blind-SISR training
step (``SISRTrainer``: on-device degradation synthesis, VIRNetSR, the SISR
ELBO through the per-sample blur, clipped Adam); and the denoising training
step (``DenoiseTrainer``: on-device noise synthesis, or real pairs with
MixUp and the residual-filter prior, the denoising ELBO).  Every Pallas
kernel of the JAX package is a CUDA C++ kernel for ``sm_90a`` under
``csrc/``, built with nvcc at first use and bound with ctypes
(``ops/_build.py``); each sits beside its plain PyTorch version in
``ops/fused_conv.py`` (the conv kernels K1-K4 and the halo-free probe K8,
forward-only) or ``ops/blur.py`` (the blur kernels K5-K7, forward and
backward).  Public tensors are NHWC, like the JAX package.
Entry points run on the card unless the caller passes ``device="cpu"``.

Layout
------
ops/      the kernel wrappers, padding, blur/downsample degradation, blur
          kernel synthesis, ResizeRight matrices, image I/O, TTA
models/   torch.nn modules under the reference torch state-dict keys
losses/   the denoising and SISR ELBOs
data/     on-device noise and SISR batch synthesis, MixUp, host patch
          sampling
train/    optimizer stack, checkpoints, logging, the denoising and SISR
          trainers
eval/     Restorer (pad buckets, TTA, folder batches) and tiled inference
cli/      the demo, the three trainers and the fused-prologue A/B
          (bench_fused_head)
csrc/     the CUDA sources
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy convenience exports (importing the package builds nothing)."""
    if name in ("VIRNet", "VIRNetSR", "build_model", "ARCH_PRESETS"):
        from . import models
        return getattr(models, name)
    if name == "Restorer":
        from .eval.engine import Restorer
        return Restorer
    if name in ("SISRTrainer", "SISRTrainConfig"):
        from .train import loop_sisr
        return getattr(loop_sisr, name)
    if name in ("DenoiseTrainer", "DenoiseTrainConfig"):
        from .train import loop_denoise
        return getattr(loop_denoise, name)
    if name in ("elbo_sisr", "elbo_denoising"):
        from .losses import elbo
        return getattr(elbo, name)
    if name == "blur_per_sample":
        from .ops.degrade import blur_per_sample
        return blur_per_sample
    if name in ("load_pth", "from_jax_params"):
        from . import convert
        return getattr(convert, name)
    raise AttributeError(name)
