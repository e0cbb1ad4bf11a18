"""Blind-SISR trainer CLI (counterpart of virnet_tpu/cli/train_sisr.py;
reference train_SISR.py).

    python -m virnet_tpu_torch.cli.train_sisr \
        --config configs/sisr_x4.json --save_dir ./run1 [--device cpu]

HR patches stream from a RAM cache of the PNGs under the config's
``train_hr_patchs``; the whole degradation pipeline runs on the device
inside the train step.  The trainer runs on the card unless ``--device
cpu`` is given.  ``--resume latest`` (or a saved epoch number) continues
from a checkpoint under ``<save_dir>/ckpts``.

Not ported yet: per-epoch validation on Set14, TensorBoard summaries and
the host-side JPEG degradation (data/sisr_host.py); device-resident data,
``auto_resume``, the RSS watchdog and multi-host runs are refused when the
config asks for them.
"""

from __future__ import annotations

from pathlib import Path

from ..config import as_bool
from ..data.sources import ImageCache, PatchSampler
from ..train.logging import make_log
from ..train.loop_sisr import SISRTrainConfig, SISRTrainer
from .common import (load_trainer_config, refuse_unported, resume_epoch,
                     trainer_argparser)


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
    if trainer.host_batches:
        raise NotImplementedError(
            "add_jpeg without jpeg_in_graph needs the host-side degradation "
            "(data/sisr_host.py), which is not ported yet")
    hr_paths = sorted(str(p) for p in
                      Path(cfg["train_hr_patchs"]).glob("*.png"))
    if not hr_paths:
        raise SystemExit("no HR patches found — check train_hr_patchs")
    logger.info(f"Number of HR patches: {len(hr_paths)}")
    sampler = PatchSampler(ImageCache(hr_paths), cfg["hr_size"])
    steps = cfg.get("steps_per_epoch", 10000)

    for epoch in range(resume_epoch(trainer, cfg.get("resume"), logger.info),
                       cfg["epochs"]):
        sampler.reset_seed(epoch * 1000)
        batches = (sampler.sample(cfg["batch_size"], raw=True)
                   for _ in range(steps))
        stats = trainer.train_epoch(epoch, batches, log_fn=logger.info)
        trainer.save(epoch)
        logger.info(f"epoch {epoch + 1} took {stats['epoch_time']:.2f}s, "
                    f"loss {stats.get('loss', 0.0):.4f}")


if __name__ == "__main__":
    main()
