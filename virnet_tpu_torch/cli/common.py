"""Shared plumbing of the command lines (counterpart of
virnet_tpu/cli/common.py): the trainers' arguments and config, the
refusals of what is not ported (config keys, the eval CLIs' options),
resume, and per-epoch validation."""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from ..config import as_bool, load_config, update_args
from ..eval.analysis import calculate_parameters, model_flops
from ..eval.metrics import batch_psnr, batch_ssim
from ..eval.tiling import bucket_size
from ..ops.pad import pad_bottom_right
from ..precision import im2col_convs

# config keys of the JAX trainers whose modules are not ported yet, with
# where ROADMAP.md queues them: by the item's title, never its number,
# which changes when the queue is renumbered
_QUEUE = "in ROADMAP.md's Queue 1, modules still to port"
_RUNTIME = f"multi-device and runtime, {_QUEUE}"
_REMAINDER = f"the remainder, {_QUEUE}"
UNPORTED = {
    "auto_resume": f"train/resilience.py ({_RUNTIME})",
    "rss_limit_mb": f"train/resilience.py ({_RUNTIME})",
    "multihost": f"train/mesh.py ({_RUNTIME})",
    "coordinator_address": f"train/mesh.py ({_RUNTIME})",
    "num_processes": f"train/mesh.py ({_RUNTIME})",
    "process_id": f"train/mesh.py ({_RUNTIME})",
}


def add_eval_args(p: argparse.ArgumentParser) -> None:
    """The device and compute options of the eval command lines, and the
    JAX package's options that are not ported yet (refused by
    ``refuse_unported_eval``)."""
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) runs the CUDA kernels; cpu runs "
                        "their plain PyTorch versions")
    p.add_argument("--compute", type=str, default="fp32",
                   choices=["fp32", "bf16", "int8"],
                   help="fp32 (default) = checkpoint-faithful parity "
                        "eval; bf16 = fast path; int8 is not ported yet")
    p.add_argument("--mesh", action="store_true",
                   help="data-parallel eval over devices (not ported yet)")


def refuse_unported_eval(args) -> None:
    """Raise when an eval command line asks for a module that is not
    ported yet, naming it."""
    if args.mesh:
        raise NotImplementedError(
            f"--mesh needs train/mesh.py and eval/spatial.py ({_RUNTIME}), "
            "which are not ported yet")
    if args.compute == "int8":
        raise NotImplementedError(
            f"--compute int8 needs ops/qconv.py ({_REMAINDER}), which is "
            "not ported yet")


def log_model_size(logger, restorer, sizes=(256, 512)) -> None:
    """The reference's thop lines: parameters, and FLOPs of one forward at
    each size (the LR input of size // sf for SISR)."""
    logger.info(f"Number of parameters: "
                f"{calculate_parameters(restorer.model) / 1000 ** 2:.2f}M")
    for size in sizes:
        s = size // restorer.sf
        flops = model_flops(restorer.task, s, s,
                            restorer.sf if restorer.sisr else None,
                            **restorer.model_overrides)
        logger.info(f"FLOPs for {size}: {flops / 1000 ** 3:.2f}G")


def trainer_argparser(default_config: str,
                      description: str = "") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--save_dir", default=None, type=str,
                   help="path to save models and logs")
    p.add_argument("--config", default=default_config, type=str)
    p.add_argument("--resume", default=None, type=str,
                   help="'latest' or a saved epoch number")
    p.add_argument("--epochs", default=None, type=int)
    p.add_argument("--steps_per_epoch", default=None, type=int)
    p.add_argument("--batch_size", default=None, type=int)
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (default) or cpu")
    return p


def load_trainer_config(args) -> Dict:
    """The config file with the command line's overrides (``--device`` is
    the caller's, not the config's)."""
    return update_args(load_config(args.config),
                       {k: v for k, v in vars(args).items()
                        if k not in ("config", "device")})


def _asked(val) -> bool:
    """Whether a config value switches its feature on: a true boolean (or
    its "True"/"1" string), a non-zero number, or any other non-empty
    string (a path, an address)."""
    if val is None or val == "":
        return False
    try:
        return as_bool(val)
    except ValueError:
        return bool(val)


def refuse_unported(cfg: Dict) -> None:
    """Raise when the config asks for a module of the JAX trainers that is
    not ported yet, naming it: a run must not go on without what its
    config asked for."""
    for key, where in UNPORTED.items():
        if _asked(cfg.get(key)):
            raise NotImplementedError(
                f"config key {key!r} needs {where}, which is not ported yet")


def resume_epoch(trainer, resume, log_fn) -> int:
    """Restore ``resume`` ('latest' or a saved epoch number; nothing when
    empty) and return the epoch to continue from."""
    if not resume:
        return 0
    epoch = trainer.restore(None if resume == "latest" else int(resume))
    log_fn(f"resumed at epoch {epoch}, step {trainer.step}")
    return epoch


VAL_PAD_MULTIPLE = 64   # the JAX trainers' validation pad buckets


def eval_restore_fn(model: torch.nn.Module, device, sf: Optional[int] = None):
    """A single-image restore closure over the model's current weights, for
    per-epoch validation: the image reflect-padded to a multiple of
    ``VAL_PAD_MULTIPLE``, one forward in eval mode and fp32 (no autocast)
    on ``device`` (on the card, the library convolutions on the im2col
    route: ``precision.im2col_convs``), cropped back (``sf`` times larger for SISR) and clamped
    to [0, 1]."""
    scale = 1 if sf is None else sf

    def restore(im_hwc: np.ndarray) -> np.ndarray:
        h, w = im_hwc.shape[:2]
        x = torch.as_tensor(im_hwc[None], dtype=torch.float32).to(device)
        x = pad_bottom_right(x, bucket_size(h, VAL_PAD_MULTIPLE),
                             bucket_size(w, VAL_PAD_MULTIPLE))
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode(), im2col_convs(
                    torch.device(device).type == "cuda"):
                out = model(x)[0] if sf is None else model(x, sf)[0]
        finally:
            model.train(was_training)
        out = out[0, :h * scale, :w * scale].float().clamp(0.0, 1.0)
        return out.cpu().numpy()

    return restore


def eval_on_pairs(restore, pairs, border: int = 0,
                  ycbcr: bool = False) -> Dict[str, float]:
    """``pairs`` yields (noisy or LR, GT) float32 HWC images; returns the
    mean PSNR and SSIM under the reference's uint8 round-trip protocol."""
    psnrs, ssims = [], []
    for inp, gt in pairs:
        out = restore(inp)
        psnrs.append(batch_psnr(out[None], gt[None], border, ycbcr))
        ssims.append(batch_ssim(out[None], gt[None], border, ycbcr))
    return dict(psnr=float(np.mean(psnrs)), ssim=float(np.mean(ssims)))


def validate(restore, pairs, epoch: int, logger, writer, label: str = "test",
             tag: str = "test", border: int = 0,
             ycbcr: bool = False) -> Dict[str, float]:
    """One set's validation: PSNR and SSIM logged as ``label`` and written
    as the TensorBoard scalars ``PSNR_epoch_<tag>`` / ``SSIM_epoch_<tag>``
    (the JAX trainers' names)."""
    metrics = eval_on_pairs(restore, pairs, border, ycbcr)
    logger.info(f"{label}: PSNR={metrics['psnr']:4.2f}, "
                f"SSIM={metrics['ssim']:5.4f}")
    writer.scalar(f"PSNR_epoch_{tag}", metrics["psnr"], epoch)
    writer.scalar(f"SSIM_epoch_{tag}", metrics["ssim"], epoch)
    return metrics
