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
TensorBoard scalars (where tensorboardX is installed).  ``--resume
latest`` (or a saved epoch number) continues from a checkpoint.  The
trainer runs on the card unless ``--device cpu`` is given.

Not ported yet, and refused when the config asks for them:
``auto_resume``, the RSS watchdog and multi-host runs.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..config import as_bool
from ..data.device_data import DeviceDataset
from ..data.packdb import PackDBSampler
from ..data.sources import PairedPatchSampler
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
    return DenoiseTrainer(tcfg, real=True, device=device)


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
    refuse_unported(cfg)
    save_dir = Path(cfg["save_dir"])
    save_dir.mkdir(parents=True, exist_ok=True)
    logger = make_log(save_dir / "train.log")
    for k, v in sorted(cfg.items()):
        logger.info(f"{k:<16s}: {v}")

    trainer = build_trainer(cfg, device=args.device)
    writer = TrainWriter(save_dir / "logs")

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

    for epoch in range(resume_epoch(trainer, cfg.get("resume"), logger.info),
                       cfg["epochs"]):
        if dataset is not None:
            stats = trainer.train_epoch_device(epoch, dataset, steps,
                                               log_fn=logger.info)
        else:
            sampler.reset_seed(epoch)
            # uint8 pairs to the device; the trainer normalizes there
            batches = (sampler.sample(cfg["batch_size"], raw=True)
                       for _ in range(steps))
            stats = trainer.train_epoch(epoch, batches, log_fn=logger.info)
        writer.scalar("Loss_epoch", stats.get("loss", 0.0), epoch)
        if have_val:
            validate(eval_restore_fn(trainer.model, trainer.device),
                     sidd_val_pairs(cfg["test_noisy_path"],
                                    cfg["test_gt_path"]),
                     epoch, logger, writer)
        trainer.save(epoch)
        logger.info(f"epoch {epoch + 1} took {stats['epoch_time']:.2f}s")
    writer.close()


if __name__ == "__main__":
    main()
