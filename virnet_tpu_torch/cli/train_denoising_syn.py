"""Synthetic-denoising trainer CLI (counterpart of
virnet_tpu/cli/train_denoising_syn.py; reference train_denoising_syn.py).

    python -m virnet_tpu_torch.cli.train_denoising_syn \
        --config configs/denoising_syn.json --save_dir ./run1 [--device cpu]

The host serves GT patch batches from a RAM cache of the images under the
config's ``train_data`` (dir, glob) pairs, through the prefetcher
(``prefetch`` batches ahead, default 2; 0 switches it off); sigma maps
and noise are synthesized on the device inside the train step.  With
``device_data`` the host instead crops ``device_records_per_image``
(default 8) GT records of ``device_record_size``^2 (default 256) from
each image once, keeps them on the device, and every batch is sampled
there.  Per epoch: validation on the PNGs under ``val_data`` with the
fixed-seed noise of ``data/eval_sets.DenoiseValSet`` (skipped when there
are none), PSNR and SSIM logged; a checkpoint under ``<save_dir>/ckpts``;
the epoch's mean loss and the validation scores as TensorBoard scalars,
and image grids of the first four restored, GT and noisy images (where
tensorboardX is installed).  ``--resume latest`` (or a saved epoch number) continues
from a checkpoint.  The trainer runs on the card unless ``--device cpu``
is given.

Several processes (``torchrun --nproc_per_node N -m ...`` with
``multihost: true`` in the config, or ``coordinator_address``,
``num_processes`` and ``process_id`` in it) train one data-parallel run,
a card each (train/mesh.py): every rank samples the global batch from the
same seed and keeps its rows; rank 0 alone logs to the file, validates
and writes checkpoints.  ``auto_resume`` (or ``--auto_resume``) restarts
from the latest checkpoint after a crash; ``rss_limit_mb`` (or
``--rss_limit_mb``) re-execs a single-process run with ``--resume latest``
after an epoch that ends at or above that resident set
(train/resilience.py).
"""

from __future__ import annotations

from pathlib import Path

from ..config import as_bool
from ..data.device_data import DeviceDataset, records_from_images
from ..data.eval_sets import DenoiseValSet
from ..data.sources import ImageCache, PatchSampler, glob_images
from ..train.logging import TrainWriter
from ..train.loop_denoise import DenoiseTrainConfig, DenoiseTrainer
from .common import (epoch_rss_watchdog, eval_restore_fn,
                     load_trainer_config, log_val_image_grids, run_epochs,
                     train_log, trainer_argparser, trainer_mesh, validate)


def build_trainer(cfg: dict, device="cuda", mesh=None) -> DenoiseTrainer:
    tcfg = DenoiseTrainConfig(
        im_chn=cfg["im_chn"], sigma_chn=cfg["sigma_chn"],
        dep_S=cfg["dep_S"], n_feat=tuple(cfg["n_feat"]),
        n_resblocks=cfg["n_resblocks"],
        noise_cond=as_bool(cfg.get("noise_cond", True)),
        extra_mode=str(cfg.get("extra_mode", "Input")).lower(),
        batch_size=cfg["batch_size"], patch_size=cfg["patch_size"],
        epochs=cfg["epochs"], warmup_epochs=cfg.get("warmup_epochs", 5),
        steps_per_epoch=cfg.get("steps_per_epoch", 10000),
        lr=cfg["lr"], lr_min=cfg.get("lr_min", 1e-6),
        clip_grad_R=cfg.get("clip_grad_R", 1e3),
        clip_grad_S=cfg.get("clip_grad_S", 1e2),
        eps2=cfg.get("eps2", 1e-6), var_window=cfg.get("var_window", 7),
        noise_mode=cfg.get("noise_mode", "niid"),
        prefetch=int(cfg.get("prefetch", 2)),
        mixed_precision=as_bool(cfg.get("mixed_precision", True)),
        remat=as_bool(cfg.get("remat", False)),
        save_dir=cfg["save_dir"], print_freq=cfg.get("print_freq", 100))
    return DenoiseTrainer(tcfg, device=device, mesh=mesh)


def validate_epoch(trainer: DenoiseTrainer, val_set, epoch: int, logger,
                   writer) -> dict:
    """The per-epoch validation on a ``DenoiseValSet``: PSNR and SSIM, then
    the image grids, under the JAX trainer's tag ``test``.  Returns the
    scores."""
    restore = eval_restore_fn(trainer.model, trainer.device)
    scores = validate(restore, iter(val_set), epoch, logger, writer)
    log_val_image_grids(writer, restore, iter(val_set), epoch)
    return scores


def main(argv=None) -> None:
    args = trainer_argparser("configs/denoising_syn.json",
                             __doc__.splitlines()[0]).parse_args(argv)
    cfg = load_trainer_config(args)
    save_dir = Path(cfg["save_dir"])
    save_dir.mkdir(parents=True, exist_ok=True)
    mesh = trainer_mesh(cfg, args.device)
    rank0 = mesh.rank == 0
    logger = train_log(save_dir, mesh.rank)
    for k, v in sorted(cfg.items()):
        logger.info(f"{k:<16s}: {v}")

    trainer = build_trainer(cfg, device=mesh.devices[0], mesh=mesh)
    writer = TrainWriter(save_dir / "logs") if rank0 else None
    rss_check = epoch_rss_watchdog(
        cfg, "virnet_tpu_torch.cli.train_denoising_syn", argv, logger,
        writer, mesh.world)

    # training data: union of the configured (dir, glob) sources
    train_paths = glob_images(*[tuple(x) for x in cfg["train_data"]])
    if not train_paths:
        raise SystemExit("no training images found — check train_data paths")
    logger.info(f"Number of training images: {len(train_paths)}")
    dataset = sampler = None
    if as_bool(cfg.get("device_data", False)):
        dataset = DeviceDataset(records_from_images(
            train_paths, int(cfg.get("device_record_size", 256)),
            per_image=int(cfg.get("device_records_per_image", 8))),
            device=trainer.device)
        logger.info(f"Device-resident GT records: {dataset.num_records} x "
                    f"{dataset.rec_shape}")
    else:
        sampler = PatchSampler(ImageCache(train_paths), cfg["patch_size"])
    val_paths = (sorted(str(p) for p in Path(cfg["val_data"]).glob("*.png"))
                 if cfg.get("val_data") else [])
    val_set = DenoiseValSet(val_paths) if val_paths else None
    steps = cfg.get("steps_per_epoch", 10000)

    def epoch_fn(epoch: int) -> None:
        if dataset is not None:
            stats = trainer.train_epoch_device(epoch, dataset, steps,
                                               log_fn=logger.info)
        else:
            sampler.reset_seed(epoch)
            # every rank samples the global batch (uint8 to the device,
            # this rank's rows only; the trainer normalizes there)
            batches = (sampler.sample(cfg["batch_size"], raw=True)
                       for _ in range(steps))
            stats = trainer.train_epoch(epoch, batches, log_fn=logger.info)
        logger.info(f"train: Loss={stats.get('loss', 0):+.2e}, "
                    f"lh={stats.get('lh', 0):+.2e}, "
                    f"KLG={stats.get('kl_gauss', 0):+.2e}, "
                    f"KLIG={stats.get('kl_ig', 0):+.2e}")
        if rank0:
            writer.scalar("Loss_epoch", stats.get("loss", 0.0), epoch)
            if val_set is not None:
                validate_epoch(trainer, val_set, epoch, logger, writer)
        trainer.save(epoch)
        logger.info(f"epoch {epoch + 1} took {stats['epoch_time']:.2f}s")
        rss_check()

    run_epochs(cfg, trainer, epoch_fn, logger.info)
    if writer is not None:
        writer.close()


if __name__ == "__main__":
    main()
