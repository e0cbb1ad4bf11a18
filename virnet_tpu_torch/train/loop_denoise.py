"""Denoising trainers, synthetic and real noise (counterpart of
virnet_tpu/train/loop_denoise.py; the reference's train_denoising_syn.py /
train_denoising_real.py).

Synthetic mode: the host serves GT patch batches, and the sigma maps and
the noise are made on the device under ``no_grad`` inside the step
(data/denoise_synth.py).  Real mode (``real=True``): the host serves
(noisy, gt) pairs; MixUp and the sigma^2 prior, a Gaussian filter of the
squared residual (ops/degrade.noise_estimate), run on the device inside the
step.

Matching reference semantics: Adam + warmup-cosine per-epoch learning rate,
per-subnet gradient clipping (RNet, SNet), alpha0 = 0.5 * var_window^2 and
beta0 = alpha0 * sigma_gt.  The model is built with ``conv_impl='torch'``:
the fused SNet, head and tail kernels are forward-only, as the Pallas
kernels they replace are, so the step launches no kernel of this package.

Input: host batches (``train_epoch``, through the prefetcher of
data/prefetch.py when ``cfg.prefetch > 0``) or records resident on the
device (``run_step_device`` / ``train_epoch_device``, data/device_data.py:
GT records for synthetic mode, paired records for real mode, whose noisy
and GT crops share their record, offsets and dihedral mode); the patch
draws come from the step's generator before the synthesis draws.  Not
ported yet: the data mesh and RNet rematerialization (``remat`` is
accepted and does nothing).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from ..data.denoise_synth import synthesize_noisy_batch
from ..data.device_data import DeviceDataset, sample_patches
from ..data.mixup import mixup_pairs
from ..data.prefetch import DevicePrefetcher
from ..losses.elbo import elbo_denoising
from ..models.virnet import VIRNet
from ..ops.degrade import noise_estimate
from ..precision import parity_mode, resolve_device
from .checkpoint import CheckpointManager
from .loop_sisr import step_seed
from .optim import SubnetAdam


@dataclass
class DenoiseTrainConfig:
    # model
    im_chn: int = 3
    sigma_chn: int = 1
    dep_S: int = 5
    n_feat: tuple = (96, 192, 288)
    n_resblocks: int = 3
    noise_cond: bool = True
    extra_mode: str = "input"
    # training
    batch_size: int = 16
    patch_size: int = 128
    epochs: int = 120
    warmup_epochs: int = 5
    steps_per_epoch: int = 10000
    lr: float = 1e-4
    lr_min: float = 1e-6
    clip_grad_R: float = 1e3
    clip_grad_S: float = 1e2
    eps2: float = 1e-6
    var_window: int = 7
    noise_mode: str = "niid"    # niid | iid  (synthetic mode)
    prefetch: int = 2           # host batches in flight ahead of the step
                                # (data/prefetch.py; 0 switches it off)
    mixed_precision: bool = True  # bf16 autocast around the model forward
                                  # (parameters and Adam state stay fp32)
    remat: bool = False         # accepted for config compatibility; a no-op
    use_mixup: bool = True      # real-data mode only (reference
                                # train_denoising_real.py:163)
    seed: int = 1234
    save_dir: str = "./train_save"
    print_freq: int = 100


class DenoiseTrainer:
    """Synthetic-noise denoising trainer.  For real-data training pass
    ``real=True`` and feed (noisy, gt) batches; the sigma^2 prior is then
    estimated from the residual inside the step (reference
    train_denoising_real.py:164).  ``device`` defaults to the card; pass
    ``device="cpu"`` to run on the CPU."""

    def __init__(self, cfg: DenoiseTrainConfig, real: bool = False,
                 device="cuda"):
        self.cfg = cfg
        self.real = real
        self.device = resolve_device(device)

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            model = VIRNet(
                im_chn=cfg.im_chn, sigma_chn=cfg.sigma_chn, n_feat=cfg.n_feat,
                dep_S=cfg.dep_S, n_resblocks=cfg.n_resblocks,
                noise_cond=cfg.noise_cond, extra_mode=cfg.extra_mode,
                conv_impl="torch")
        self.model = model.to(self.device).train()
        self.subnets = {"rnet": self.model.RNet, "snet": self.model.SNet}
        self.optim = SubnetAdam(
            self.subnets, cfg.lr, cfg.lr_min, cfg.epochs, cfg.warmup_epochs,
            cfg.steps_per_epoch,
            clip_map={"rnet": cfg.clip_grad_R, "snet": cfg.clip_grad_S})
        self.schedule = self.optim.schedule
        self.step = 0
        self.alpha0 = 0.5 * float(cfg.var_window) ** 2
        self.generator = torch.Generator(device=self.device)
        self.ckpt = CheckpointManager(cfg.save_dir)

    # ------------------------------------------------------------------ step

    def _to_device(self, t) -> torch.Tensor:
        t = torch.as_tensor(t).to(self.device, non_blocking=True)
        if t.dtype == torch.uint8:
            # uint8 batches normalize on the device (4x smaller transfer)
            return t.float() / 255.0
        return t.float()

    @torch.no_grad()
    def _batch(self, data, noise: Optional[dict]):
        """(im_noisy, im_gt, sigma_gt) on the device."""
        cfg = self.cfg
        noise = noise or {}
        if isinstance(data, DeviceDataset):
            data = self._sample(data, noise.get("sample"))
        if self.real:
            im_noisy, im_gt = (self._to_device(t) for t in data)
            if cfg.use_mixup:
                im_gt, im_noisy = mixup_pairs(
                    im_gt, im_noisy, generator=self.generator,
                    draws=noise.get("mixup"))
            return im_noisy, im_gt, noise_estimate(im_noisy, im_gt,
                                                   cfg.var_window)
        im_gt = self._to_device(data)
        im_noisy, sigma_gt = synthesize_noisy_batch(
            im_gt, mode=cfg.noise_mode, generator=self.generator,
            draws=noise.get("synth"))
        return im_noisy, im_gt, sigma_gt

    def _sample(self, dataset: DeviceDataset, draws: Optional[dict]):
        """A uint8 batch drawn on the device from ``dataset``'s records: GT
        patches (synthetic) or (noisy, gt) pairs with shared draws
        (real)."""
        if dataset.paired != self.real:
            raise ValueError(
                "real-noise training needs paired (noisy, gt) records and "
                "synthetic training GT records alone; got "
                f"{'paired' if dataset.paired else 'unpaired'} records")
        arrays = dataset.arrays
        return sample_patches(arrays[0], self.cfg.batch_size,
                              self.cfg.patch_size,
                              extra=arrays[1] if self.real else None,
                              generator=self.generator, draws=draws)

    def loss_and_grads(self, batch, epoch: int, noise: Optional[dict] = None):
        """Forward and backward of one step; the gradients are left in the
        parameters' ``.grad``.  ``batch``: GT NHWC (synthetic) or a (noisy,
        gt) pair (real), float in [0, 1] or uint8, or a DeviceDataset to
        sample from.  ``noise``: dict(synth=the draws of
        synthesize_noisy_batch, mixup=(indices, lam), sample=the draws of
        data/device_data.sample_patches), each optional, in place of the
        per-step generator.  Returns (loss, aux scalars).  TF32 is off from
        the synthesis to the end of the backward (the convolutions run in
        bf16 under autocast when ``mixed_precision``), and the process-wide
        flags are put back afterwards."""
        with parity_mode():
            return self._loss_and_grads(batch, epoch, noise)

    def _loss_and_grads(self, batch, epoch: int, noise: Optional[dict]):
        cfg = self.cfg
        self.generator.manual_seed(step_seed(cfg.seed, epoch, self.step))
        im_noisy, im_gt, sigma_gt = self._batch(batch, noise)
        beta0 = self.alpha0 * sigma_gt
        self.optim.zero_grad()
        with torch.autocast(self.device.type, torch.bfloat16,
                            enabled=cfg.mixed_precision):
            mu, sigma = self.model(im_noisy)
        loss, lh, klg, klig = elbo_denoising(
            mu.float(), sigma.float(), im_noisy, im_gt, cfg.eps2,
            self.alpha0, beta0)
        loss.backward()
        return loss.detach(), dict(lh=lh.detach(), kl_gauss=klg.detach(),
                                   kl_ig=klig.detach())

    def run_step(self, batch, epoch: int,
                 noise: Optional[dict] = None) -> Dict[str, torch.Tensor]:
        """One optimization step.  Returns the loss, the ELBO's terms and
        the pre-clip gradient norms as 0-d tensors on the device (no host
        synchronisation)."""
        loss, aux = self.loss_and_grads(batch, epoch, noise)
        norms = self.optim.step()
        self.step += 1
        aux.update(loss=loss, gnorm_r=norms["rnet"], gnorm_s=norms["snet"])
        return aux

    def run_step_device(self, dataset: DeviceDataset, epoch: int,
                        noise: Optional[dict] = None
                        ) -> Dict[str, torch.Tensor]:
        """One optimization step on a batch sampled on the device from
        ``dataset``'s records: sampling, synthesis (or MixUp) draw from
        the step's generator, so a resumed run draws what the
        uninterrupted run would have."""
        return self.run_step(dataset, epoch, noise)

    def train_epoch(self, epoch: int, batch_iter,
                    log_fn: Optional[Callable] = None) -> Dict[str, float]:
        """One epoch over host batches, through the prefetcher when
        ``cfg.prefetch > 0``; its stats come back as ``prefetch_*``."""
        if self.cfg.prefetch <= 0:
            return self._epoch(epoch, batch_iter, self.cfg.steps_per_epoch,
                               log_fn)
        with DevicePrefetcher(batch_iter, self.device,
                              self.cfg.prefetch) as batches:
            out = self._epoch(epoch, batches, self.cfg.steps_per_epoch,
                              log_fn)
        out.update({f"prefetch_{k}": v for k, v in batches.stats.items()})
        return out

    def train_epoch_device(self, epoch: int, dataset: DeviceDataset,
                           steps: int, log_fn: Optional[Callable] = None
                           ) -> Dict[str, float]:
        """``steps`` steps of ``run_step_device`` on ``dataset``."""
        return self._epoch(epoch, (dataset for _ in range(steps)), steps,
                           log_fn)

    def _epoch(self, epoch: int, batches, steps: int,
               log_fn: Optional[Callable]) -> Dict[str, float]:
        cfg = self.cfg
        tic = time.time()
        sums: Dict[str, float] = {}
        count = 0
        for ii, batch in enumerate(batches):
            aux = self.run_step(batch, epoch)
            if (ii + 1) % cfg.print_freq == 0 or ii == 0:
                vals = {k: float(v) for k, v in aux.items()}
                lr = self.schedule(self.step)
                msg = (f"[Epoch:{epoch + 1:>2d}/{cfg.epochs:<2d}] "
                       f"train:{ii + 1:0>5d}/{steps:0>5d}, "
                       f"lh={vals['lh']:+4.2f}, KLG={vals['kl_gauss']:+7.2f}, "
                       f"KLIG={vals['kl_ig']:+6.2f}, "
                       f"GNorm_R={vals['gnorm_r']:.1e}, "
                       f"GNorm_S={vals['gnorm_s']:.1e}, lr={lr:.2e}")
                (log_fn or print)(msg)
                for k, v in vals.items():
                    sums[k] = sums.get(k, 0.0) + v
                count += 1
        out = {k: v / max(count, 1) for k, v in sums.items()}
        out["epoch_time"] = time.time() - tic
        return out

    # ----------------------------------------------------------- checkpoints

    def save(self, epoch: int) -> None:
        self.ckpt.save(epoch + 1, dict(
            params=self.model.state_dict(), opt_state=self.optim.state_dict(),
            step=self.step, epoch=epoch + 1,
            generator=self.generator.get_state()))

    def restore(self, step: Optional[int] = None) -> int:
        """Load the given (default: latest) checkpoint; returns the epoch
        to continue from, 0 when there is none."""
        state = self.ckpt.restore(step, map_location=self.device)
        if state is None:
            return 0
        self.model.load_state_dict(state["params"], strict=True)
        self.optim.load_state_dict(state["opt_state"])
        self.step = int(state["step"])
        self.generator.set_state(state["generator"].cpu())
        return int(state["epoch"])
