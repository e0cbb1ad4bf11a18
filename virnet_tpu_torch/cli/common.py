"""Shared plumbing of the command lines (counterpart of
virnet_tpu/cli/common.py): the trainers' arguments and config, the
process group, the RSS watchdog, resume, per-epoch validation with its
TensorBoard image grids, and the eval CLIs' options."""

from __future__ import annotations

import argparse
import contextlib
from typing import Dict, Optional

import numpy as np
import torch

from ..config import as_bool, load_config, update_args
from ..eval.analysis import calculate_parameters, model_flops
from ..eval.metrics import batch_psnr, batch_ssim
from ..eval.tiling import bucket_size
from ..ops.pad import pad_bottom_right
from ..precision import im2col_convs


def add_eval_args(p: argparse.ArgumentParser) -> None:
    """The device, compute and mesh options of the eval command lines."""
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) runs the CUDA kernels; cpu runs "
                        "their plain PyTorch versions")
    p.add_argument("--compute", type=str, default="fp32",
                   choices=["fp32", "bf16", "int8"],
                   help="fp32 (default) = checkpoint-faithful parity "
                        "eval; bf16 = fast path; int8 = W8A8 serving (not "
                        "checkpoint-faithful)")
    p.add_argument("--mesh", action="store_true",
                   help="data-parallel eval: each batch split over every "
                        "visible card (outputs as without it)")


def eval_mesh(args, logger):
    """The mesh of ``--mesh`` (every visible card; the device of
    ``--device`` alone when that is the CPU), or None."""
    if not args.mesh:
        return None
    from ..train.mesh import make_mesh

    mesh = (make_mesh([args.device])
            if torch.device(args.device).type == "cpu" else make_mesh())
    logger.info(f"data-parallel eval over {mesh.size} devices")
    return mesh


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
                   help="cuda (default) or cpu; a rank of a multi-process "
                        "run takes cuda:LOCAL_RANK")
    p.add_argument("--auto_resume", action="store_true", default=None,
                   help="restart from the latest checkpoint after a crash "
                        "(train/resilience.py)")
    p.add_argument("--rss_limit_mb", default=None, type=float,
                   help="re-exec with --resume latest after an epoch whose "
                        "end finds the resident set at or above this many "
                        "MB (0 or absent: off; single-process runs only)")
    return p


def maybe_init_multihost(cfg: Dict, log_fn=print,
                         backend: Optional[str] = None) -> int:
    """Join the process group when the config asks for it (the
    reference's DDP launcher variables, train_denoising_syn.py:35-39):
    ``coordinator_address`` / ``num_processes`` / ``process_id`` from the
    config, or, with ``multihost: true`` alone, torchrun's variables.  A
    config with none of these keys runs single-process.  Returns the
    number of processes."""
    from ..train import mesh as mesh_mod

    keys = ("coordinator_address", "num_processes", "process_id")
    if not (as_bool(cfg.get("multihost", False))
            or any(cfg.get(k) is not None for k in keys)):
        return 1
    n = mesh_mod.init_multihost(cfg.get("coordinator_address"),
                                num_processes=cfg.get("num_processes"),
                                process_id=cfg.get("process_id"),
                                backend=backend)
    log_fn(f"multi-host: {n} process(es)")
    return n


def trainer_mesh(cfg: Dict, device: str, log_fn=print):
    """This process's mesh of one device, in the process group of the
    config (``maybe_init_multihost``; gloo when ``device`` is the CPU).
    A rank takes the card ``cuda:LOCAL_RANK`` (torchrun's variable), else
    ``cuda:<process_id % cards>``, set before the group is joined."""
    import os

    from ..train.mesh import make_mesh

    dev = torch.device(device)
    local = os.environ.get("LOCAL_RANK", cfg.get("process_id"))
    if dev.type == "cuda" and dev.index is None and local is not None:
        dev = torch.device("cuda", int(local) % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    maybe_init_multihost(cfg, log_fn, "gloo" if dev.type == "cpu" else None)
    return make_mesh([dev])


def epoch_rss_watchdog(cfg: Dict, module: str, argv, logger, writer,
                       world: int = 1):
    """The per-epoch RSS watchdog of a trainer CLI: call the returned
    closure right after the epoch's checkpoint is written; it re-execs
    the process (resume is bitwise) once RSS reaches ``rss_limit_mb``.  A
    no-op when the limit is unset; raises at once with ``world`` > 1
    (train/resilience.check_watchdog_world)."""
    from ..train.resilience import (check_watchdog_world,
                                    maybe_reexec_on_rss, reexec_argv)

    limit = float(cfg.get("rss_limit_mb") or 0)
    check_watchdog_world(limit, world)
    if limit <= 0:
        return lambda: None
    cmd = reexec_argv(module, argv)
    return lambda: maybe_reexec_on_rss(limit, cmd, log_fn=logger.info,
                                       cleanup=writer.close)


def run_epochs(cfg: Dict, trainer, epoch_fn, log_fn) -> None:
    """``epoch_fn(epoch)`` from the resumed epoch to the config's last:
    with ``auto_resume`` under train/resilience.run_with_auto_resume
    (each attempt resumes from the latest checkpoint), else from
    ``resume`` ('latest', a saved epoch number, or nothing)."""
    def train(start: int) -> None:
        for epoch in range(start, cfg["epochs"]):
            epoch_fn(epoch)

    if _asked(cfg.get("auto_resume")):
        from ..train.resilience import run_with_auto_resume

        run_with_auto_resume(train, trainer.restore, log_fn=log_fn)
    else:
        train(resume_epoch(trainer, cfg.get("resume"), log_fn))


def load_trainer_config(args) -> Dict:
    """The config file with the command line's overrides (``--device`` is
    the caller's, not the config's)."""
    return update_args(load_config(args.config),
                       {k: v for k, v in vars(args).items()
                        if k not in ("config", "device")})


def train_log(save_dir, rank: int):
    """The trainer's logger: console and ``<save_dir>/train.log`` on rank
    0, the console alone on the other ranks."""
    from ..train.logging import make_log

    return make_log(save_dir / "train.log" if rank == 0 else None)


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
        with eval_forward(model, device):
            out = model(x)[0] if sf is None else model(x, sf)[0]
        out = out[0, :h * scale, :w * scale].float().clamp(0.0, 1.0)
        return out.cpu().numpy()

    return restore


@contextlib.contextmanager
def eval_forward(model: torch.nn.Module, device):
    """The block of one validation forward: the model in eval mode under
    ``inference_mode``, and on the card the library convolutions on the
    im2col route; the model's mode is put back after."""
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode(), im2col_convs(
                torch.device(device).type == "cuda"):
            yield
    finally:
        model.train(was_training)


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


def log_val_image_grids(writer, restore, pairs, epoch: int, tag: str = "test",
                        max_images: int = 4, crop: int = 256) -> None:
    """TensorBoard image grids of (restored, GT, input) for the first
    ``max_images`` of ``pairs`` (the reference's vutils.make_grid
    summaries, train_denoising_syn.py:199-211): each image clipped to
    [0, 1] and cut to its top-left ``crop`` x ``crop``, then all three
    lists to their common h x w, written as ``"<tag> Restored images"``,
    ``"<tag> GroundTruth"`` and ``"<tag> Input"``.  Without a writer
    backend (``writer.enabled`` false) nothing is restored."""
    if not writer.enabled:
        return
    ins, outs, gts = [], [], []
    for inp, gt in pairs:
        if len(ins) >= max_images:
            break
        ins.append(np.clip(inp[:crop, :crop], 0, 1))
        outs.append(np.clip(restore(inp)[:crop, :crop], 0, 1))
        gts.append(np.clip(gt[:crop, :crop], 0, 1))
    if not outs:
        return
    h = min(x.shape[0] for x in ins + outs + gts)
    w = min(x.shape[1] for x in ins + outs + gts)

    def stack(xs):
        return np.stack([x[:h, :w] for x in xs])

    writer.image_grid(f"{tag} Restored images", stack(outs), epoch)
    writer.image_grid(f"{tag} GroundTruth", stack(gts), epoch)
    writer.image_grid(f"{tag} Input", stack(ins), epoch)
