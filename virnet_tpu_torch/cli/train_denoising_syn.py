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
the epoch's mean loss and the validation scores as TensorBoard scalars
(where tensorboardX is installed).  ``--resume latest`` (or a saved epoch number) continues
from a checkpoint.  The trainer runs on the card unless ``--device cpu``
is given.

Not ported yet, and refused when the config asks for them:
``auto_resume``, the RSS watchdog and multi-host runs.
"""

from __future__ import annotations

from pathlib import Path

from ..config import as_bool
from ..data.device_data import DeviceDataset, records_from_images
from ..data.eval_sets import DenoiseValSet
from ..data.sources import ImageCache, PatchSampler, glob_images
from ..train.logging import TrainWriter, make_log
from ..train.loop_denoise import DenoiseTrainConfig, DenoiseTrainer
from .common import (eval_restore_fn, load_trainer_config, refuse_unported,
                     resume_epoch, trainer_argparser, validate)


def build_trainer(cfg: dict, device="cuda") -> DenoiseTrainer:
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
    return DenoiseTrainer(tcfg, device=device)


def main(argv=None) -> None:
    args = trainer_argparser("configs/denoising_syn.json",
                             __doc__.splitlines()[0]).parse_args(argv)
    cfg = load_trainer_config(args)
    refuse_unported(cfg)
    save_dir = Path(cfg["save_dir"])
    save_dir.mkdir(parents=True, exist_ok=True)
    logger = make_log(save_dir / "train.log")
    for k, v in sorted(cfg.items()):
        logger.info(f"{k:<16s}: {v}")

    trainer = build_trainer(cfg, device=args.device)
    writer = TrainWriter(save_dir / "logs")

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

    for epoch in range(resume_epoch(trainer, cfg.get("resume"), logger.info),
                       cfg["epochs"]):
        if dataset is not None:
            stats = trainer.train_epoch_device(epoch, dataset, steps,
                                               log_fn=logger.info)
        else:
            sampler.reset_seed(epoch)
            # uint8 to the device; the trainer normalizes there
            batches = (sampler.sample(cfg["batch_size"], raw=True)
                       for _ in range(steps))
            stats = trainer.train_epoch(epoch, batches, log_fn=logger.info)
        writer.scalar("Loss_epoch", stats.get("loss", 0.0), epoch)
        logger.info(f"train: Loss={stats.get('loss', 0):+.2e}, "
                    f"lh={stats.get('lh', 0):+.2e}, "
                    f"KLG={stats.get('kl_gauss', 0):+.2e}, "
                    f"KLIG={stats.get('kl_ig', 0):+.2e}")
        if val_set is not None:
            validate(eval_restore_fn(trainer.model, trainer.device),
                     iter(val_set), epoch, logger, writer)
        trainer.save(epoch)
        logger.info(f"epoch {epoch + 1} took {stats['epoch_time']:.2f}s")
    writer.close()


if __name__ == "__main__":
    main()
