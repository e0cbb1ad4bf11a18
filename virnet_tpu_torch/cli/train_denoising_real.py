"""Real-noise (SIDD) denoising trainer CLI (counterpart of
virnet_tpu/cli/train_denoising_real.py; reference train_denoising_real.py).

    python -m virnet_tpu_torch.cli.train_denoising_real \
        --config configs/denoising_real.json --save_dir ./run1 [--device cpu]

Paired noisy/GT patches come from a SIDD-style folder pair
(<root>/noisy/*.png, <root>/gt/*.png, the config's ``train_pch_dir`` being
the noisy folder), or from the pack file ``train_pack_file`` through the
native sampler of data/packdb.py (a pack is written by
``data/packdb.pack_from_folders`` or converted from the reference's LMDB
by ``data/lmdb_convert``), through the prefetcher (``prefetch`` batches
ahead, default 2; 0 switches it off).  ``device_data`` keeps the pack's
records on the device and samples every batch there; it needs
``train_pack_file``.  MixUp and the sigma^2-prior residual filter run on
the device inside the train step.  Per epoch: validation on the SIDD
validation .mat pair (``test_noisy_path``, ``test_gt_path``; skipped when
either is missing), PSNR and SSIM logged; a checkpoint under
``<save_dir>/ckpts``; the epoch's mean loss and the validation scores as
TensorBoard scalars, and image grids of the first four restored, GT and
noisy blocks (where tensorboardX is installed).  ``--resume
latest`` (or a saved epoch number) continues from a checkpoint.  The
trainer runs on the card unless ``--device cpu`` is given.

Several processes, ``auto_resume`` and ``rss_limit_mb`` work as in
cli/train_denoising_syn.py; with MixUp every rank moves the whole global
batch to its card (train/loop_denoise.py).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..config import as_bool
from ..data.device_data import DeviceDataset
from ..data.packdb import PackDBSampler
from ..data.sources import PairedPatchSampler
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
        epochs=cfg["epochs"], warmup_epochs=cfg.get("warmup_epochs", 10),
        steps_per_epoch=cfg.get("steps_per_epoch", 10000),
        lr=cfg["lr"], lr_min=cfg.get("lr_min", 1e-6),
        clip_grad_R=cfg.get("clip_grad_R", 5e2),
        clip_grad_S=cfg.get("clip_grad_S", 1e2),
        eps2=cfg.get("eps2", 1e-6), var_window=cfg.get("var_window", 7),
        use_mixup=as_bool(cfg.get("use_mixup", True)),
        prefetch=int(cfg.get("prefetch", 2)),
        mixed_precision=as_bool(cfg.get("mixed_precision", True)),
        remat=as_bool(cfg.get("remat", False)),
        save_dir=cfg["save_dir"], print_freq=cfg.get("print_freq", 100))
    return DenoiseTrainer(tcfg, real=True, device=device, mesh=mesh)


def sidd_val_pairs(noisy_mat: str, gt_mat: str):
    """Yield (noisy, gt) float32 HWC pairs from the SIDD validation .mat
    files (reference datasets/DenoisingDatasets.py:157-177)."""
    from scipy.io import loadmat

    noisy = loadmat(noisy_mat)["ValidationNoisyBlocksSrgb"]
    gt = loadmat(gt_mat)["ValidationGtBlocksSrgb"]
    h, w, c = noisy.shape[2:]
    noisy = noisy.reshape(-1, h, w, c)
    gt = gt.reshape(-1, h, w, c)
    for i in range(noisy.shape[0]):
        yield (noisy[i].astype(np.float32) / 255.0,
               gt[i].astype(np.float32) / 255.0)


def main(argv=None) -> None:
    args = trainer_argparser("configs/denoising_real.json",
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
        cfg, "virnet_tpu_torch.cli.train_denoising_real", argv, logger,
        writer, mesh.world)

    dataset = sampler = None
    if as_bool(cfg.get("device_data", False)):
        if not cfg.get("train_pack_file"):
            raise ValueError("device_data=true needs train_pack_file "
                             "(fixed-size records); pack folders with "
                             "data/packdb.pack_from_folders or convert "
                             "LMDB via data/lmdb_convert")
        dataset = DeviceDataset.from_packdb(cfg["train_pack_file"],
                                            device=trainer.device)
        logger.info(f"Device-resident records: {dataset.num_records} x "
                    f"{dataset.rec_shape}")
    elif cfg.get("train_pack_file"):
        sampler = PackDBSampler(cfg["train_pack_file"], cfg["patch_size"])
        logger.info(f"Number of training records (packdb): {len(sampler)}")
    else:
        if not any(Path(cfg["train_pch_dir"]).glob("*.png")):
            raise SystemExit("no training patches found — check "
                             "train_pch_dir")
        sampler = PairedPatchSampler(cfg["train_pch_dir"],
                                     cfg["patch_size"])
        logger.info(f"Number of training patch pairs: "
                    f"{len(sampler.noisy)}")
    have_val = all(cfg.get(k) and Path(cfg[k]).exists()
                   for k in ("test_noisy_path", "test_gt_path"))
    steps = cfg.get("steps_per_epoch", 10000)

    def epoch_fn(epoch: int) -> None:
        if dataset is not None:
            stats = trainer.train_epoch_device(epoch, dataset, steps,
                                               log_fn=logger.info)
        else:
            sampler.reset_seed(epoch)
            # every rank samples the global batch (uint8 pairs to the
            # device; the trainer normalizes there)
            batches = (sampler.sample(cfg["batch_size"], raw=True)
                       for _ in range(steps))
            stats = trainer.train_epoch(epoch, batches, log_fn=logger.info)
        if rank0:
            writer.scalar("Loss_epoch", stats.get("loss", 0.0), epoch)
            if have_val:
                restore = eval_restore_fn(trainer.model, trainer.device)
                validate(restore, sidd_val_pairs(cfg["test_noisy_path"],
                                                 cfg["test_gt_path"]),
                         epoch, logger, writer)
                log_val_image_grids(
                    writer, restore,
                    sidd_val_pairs(cfg["test_noisy_path"],
                                   cfg["test_gt_path"]), epoch)
        trainer.save(epoch)
        logger.info(f"epoch {epoch + 1} took {stats['epoch_time']:.2f}s")
        rss_check()

    run_epochs(cfg, trainer, epoch_fn, logger.info)
    if writer is not None:
        writer.close()


if __name__ == "__main__":
    main()
