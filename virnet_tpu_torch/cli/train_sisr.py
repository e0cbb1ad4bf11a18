"""Blind-SISR trainer CLI (counterpart of virnet_tpu/cli/train_sisr.py;
reference train_SISR.py).

    python -m virnet_tpu_torch.cli.train_sisr \
        --config configs/sisr_x4.json --save_dir ./run1 [--device cpu]

HR patches stream from a RAM cache of the PNGs under the config's
``train_hr_patchs`` through the prefetcher (``prefetch`` batches ahead,
default 2; 0 switches it off), and the whole degradation pipeline runs on
the device inside the train step.  ``add_jpeg`` adds the JPEG noise
type: with ``jpeg_in_graph`` on the device (ops/jpeg.py), otherwise with
libjpeg on the host (data/sisr_host.py, the reference's own semantics),
which degrades whole batches there.  ``device_data`` crops
``device_records_per_image`` (default 4) records of
``device_record_size``^2 (default max(hr_size, 256)) from each image once,
keeps them on the device and samples every batch there; it needs the
degradation on the device, so it is refused with host JPEG.  Per epoch:
validation on the images under ``val_hr_path`` (Set14 in the configs;
skipped when there are none), one
``data/eval_sets.SISRValSet`` per noise type (Gaussian; JPEG too with
``add_jpeg``), PSNR and SSIM on the Y channel with a border of sf^2
logged and written as TensorBoard scalars (where tensorboardX is
installed); a checkpoint under ``<save_dir>/ckpts``.  The trainer runs on
the card unless ``--device cpu`` is given.  ``--resume latest`` (or a
saved epoch number) continues from a checkpoint.

Not ported yet: the TensorBoard image and kernel summaries; ``auto_resume``,
the RSS watchdog and multi-host runs are refused when the config asks for
them.
"""

from __future__ import annotations

from pathlib import Path

from ..config import as_bool
from ..data.device_data import DeviceDataset, records_from_images
from ..data.eval_sets import SISRValSet
from ..data.sisr_host import HostSISRSampler
from ..data.sources import ImageCache, PatchSampler
from ..train.logging import TrainWriter, make_log
from ..train.loop_sisr import SISRTrainConfig, SISRTrainer
from .common import (eval_restore_fn, load_trainer_config, refuse_unported,
                     resume_epoch, trainer_argparser, validate)


def build_trainer(cfg: dict, device="cuda") -> SISRTrainer:
    tcfg = SISRTrainConfig(
        im_chn=cfg["im_chn"], sigma_chn=cfg["sigma_chn"],
        dep_S=cfg["dep_S"], dep_K=cfg["dep_K"], n_feat=tuple(cfg["n_feat"]),
        n_resblocks=cfg["n_resblocks"],
        extra_mode=str(cfg.get("extra_mode", "Both")).lower(),
        noise_cond=as_bool(cfg.get("noise_cond", True)),
        kernel_cond=as_bool(cfg.get("kernel_cond", True)),
        sf=cfg["sf"], k_size=cfg.get("k_size", 21),
        kernel_shift=as_bool(cfg.get("kernel_shift", False)),
        downsampler=str(cfg.get("downsampler", "Bicubic")).lower(),
        noise_level=tuple(cfg.get("noise_level", (0.01, 15))),
        batch_size=cfg["batch_size"], hr_size=cfg["hr_size"],
        epochs=cfg["epochs"], warmup_epochs=cfg.get("warmup_epochs", 0),
        steps_per_epoch=cfg.get("steps_per_epoch", 10000),
        lr=cfg["lr"], lr_min=cfg.get("lr_min", 1e-6),
        clip_grad_R=cfg.get("clip_grad_R", 5e2),
        clip_grad_S=cfg.get("clip_grad_S", 1e2),
        clip_grad_K=cfg.get("clip_grad_K", 5e2),
        eps2=cfg.get("eps2", 1e-5), r2=cfg.get("r2", 1e-4),
        var_window=cfg.get("var_window", 9),
        kappa0=cfg.get("kappa0", 50),
        penalty_K=tuple(cfg.get("penalty_K", (0.02, 2))),
        prefetch=int(cfg.get("prefetch", 2)),
        mixed_precision=as_bool(cfg.get("mixed_precision", True)),
        remat=as_bool(cfg.get("remat", False)),
        add_jpeg_in_graph=(as_bool(cfg.get("add_jpeg", False))
                           and as_bool(cfg.get("jpeg_in_graph", False))),
        noise_jpeg=tuple(cfg.get("noise_jpeg", (0.1, 10))),
        save_dir=cfg["save_dir"], print_freq=cfg.get("print_freq", 100))
    # JPEG noise with exact libjpeg round trips needs already degraded
    # host batches
    host_batches = (as_bool(cfg.get("add_jpeg", False))
                    and not as_bool(cfg.get("jpeg_in_graph", False)))
    return SISRTrainer(tcfg, device=device, host_batches=host_batches)


def sisr_val_sets(cfg: dict) -> dict:
    """One SISRValSet per noise type over the .bmp (else .png) images under
    ``val_hr_path`` (reference train_SISR.py:277-321); empty without
    images."""
    if not cfg.get("val_hr_path"):
        return {}
    root = Path(cfg["val_hr_path"])
    paths = (sorted(str(p) for p in root.glob("*.bmp"))
             or sorted(str(p) for p in root.glob("*.png")))
    if not paths:
        return {}
    noise_types = ["Gaussian"]
    if as_bool(cfg.get("add_jpeg", False)):
        noise_types.append("JPEG")
    return {nt: SISRValSet(
        paths, sf=cfg["sf"], k_size=cfg.get("k_size", 21),
        kernel_shift=as_bool(cfg.get("kernel_shift", False)),
        downsampler=str(cfg.get("downsampler", "Bicubic")).lower(),
        noise_type=nt) for nt in noise_types}


def main(argv=None) -> None:
    args = trainer_argparser("configs/sisr_x4.json",
                             __doc__.splitlines()[0]).parse_args(argv)
    cfg = load_trainer_config(args)
    refuse_unported(cfg)
    save_dir = Path(cfg["save_dir"])
    save_dir.mkdir(parents=True, exist_ok=True)
    logger = make_log(save_dir / "train.log")
    for k, v in sorted(cfg.items()):
        logger.info(f"{k:<16s}: {v}")

    trainer = build_trainer(cfg, device=args.device)
    hr_paths = sorted(str(p) for p in
                      Path(cfg["train_hr_patchs"]).glob("*.png"))
    if not hr_paths:
        raise SystemExit("no HR patches found — check train_hr_patchs")
    logger.info(f"Number of HR patches: {len(hr_paths)}")
    dataset = sampler = None
    if as_bool(cfg.get("device_data", False)):
        if trainer.host_batches:
            raise SystemExit("device_data is incompatible with the JPEG "
                             "noise branch (host-side libjpeg)")
        dataset = DeviceDataset(records_from_images(
            hr_paths,
            int(cfg.get("device_record_size", max(cfg["hr_size"], 256))),
            per_image=int(cfg.get("device_records_per_image", 4))),
            device=trainer.device)
        logger.info(f"Device-resident HR records: {dataset.num_records} x "
                    f"{dataset.rec_shape}")
    elif trainer.host_batches:
        sampler = HostSISRSampler(
            ImageCache(hr_paths), cfg["hr_size"], cfg["sf"],
            k_size=cfg.get("k_size", 21),
            kernel_shift=as_bool(cfg.get("kernel_shift", False)),
            downsampler=str(cfg.get("downsampler", "Bicubic")).lower(),
            noise_level=tuple(cfg.get("noise_level", (0.1, 15))),
            noise_jpeg=tuple(cfg.get("noise_jpeg", (0.1, 10))),
            add_jpeg=True)
    else:
        sampler = PatchSampler(ImageCache(hr_paths), cfg["hr_size"])
    sf = cfg["sf"]
    val_sets = sisr_val_sets(cfg)
    writer = TrainWriter(save_dir / "logs")
    steps = cfg.get("steps_per_epoch", 10000)

    for epoch in range(resume_epoch(trainer, cfg.get("resume"), logger.info),
                       cfg["epochs"]):
        if dataset is not None:
            stats = trainer.train_epoch_device(epoch, dataset, steps,
                                               log_fn=logger.info)
        else:
            sampler.reset_seed(epoch * 1000)
            # HR patches go as uint8 (normalized on the device); the host
            # sampler's degraded batches are float
            batches = (sampler.sample(cfg["batch_size"])
                       if trainer.host_batches else
                       sampler.sample(cfg["batch_size"], raw=True)
                       for _ in range(steps))
            stats = trainer.train_epoch(epoch, batches, log_fn=logger.info)
        writer.scalar("Loss_epoch", stats.get("loss", 0.0), epoch)
        for nt, val_set in val_sets.items():
            validate(eval_restore_fn(trainer.model, trainer.device, sf=sf),
                     ((lr, hr) for hr, lr, _ in val_set), epoch, logger,
                     writer, label=f"test[{nt}]", tag=f"test_{nt}",
                     border=sf ** 2, ycbcr=True)
        trainer.save(epoch)
        logger.info(f"epoch {epoch + 1} took {stats['epoch_time']:.2f}s, "
                    f"loss {stats.get('loss', 0.0):.4f}")
    writer.close()


if __name__ == "__main__":
    main()
