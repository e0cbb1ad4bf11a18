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
draws come from the step's generator before the synthesis draws.

Data parallelism (``mesh``) works as in train/loop_sisr.py: each rank
draws every random tensor of the step at the global batch's shape and
keeps its rows, and the gradients, the loss and the ELBO's terms are
averaged over the ranks after the backward.  MixUp pairs each row with
another row of the whole global batch, so with MixUp each rank takes the
whole global batch (the prefetcher moves all of it), mixes it and keeps
its rows.  ``remat`` recomputes RNet's blocks in the backward
(models/attresunet.py).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from ..data.denoise_synth import noisy_batch_draws, synthesize_noisy_batch
from ..data.device_data import DeviceDataset, patch_draws, sample_patches
from ..data.mixup import mixup_draws, mixup_pairs
from ..data.prefetch import DevicePrefetcher
from ..losses.elbo import elbo_denoising
from ..models.virnet import VIRNet
from ..ops.degrade import noise_estimate
from ..precision import resolve_device, train_step_mode
from .checkpoint import CheckpointManager
from .loop_sisr import step_seed
from .mesh import Mesh, map_rows
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
    remat: bool = False         # recompute RNet's blocks in the backward
                                # (torch.utils.checkpoint)
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
    ``device="cpu"`` to run on the CPU.  ``mesh`` (train/mesh.py) makes
    the trainer one rank of a data-parallel run; the batch size must
    divide by its world size."""

    def __init__(self, cfg: DenoiseTrainConfig, real: bool = False,
                 device="cuda", mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.real = real
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else Mesh([self.device])
        self.mesh.rows(cfg.batch_size)          # divisibility

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            model = VIRNet(
                im_chn=cfg.im_chn, sigma_chn=cfg.sigma_chn, n_feat=cfg.n_feat,
                dep_S=cfg.dep_S, n_resblocks=cfg.n_resblocks,
                noise_cond=cfg.noise_cond, extra_mode=cfg.extra_mode,
                conv_impl="torch", remat=cfg.remat)
        self.model = model.to(self.device).train()
        self.mesh.replicate(self.model.parameters())
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

    @property
    def mixes_rows(self) -> bool:
        """Whether a step mixes rows across the batch (MixUp): a rank then
        takes the whole global batch."""
        return self.real and self.cfg.use_mixup

    def _gt_shape(self, data, local: bool) -> tuple:
        """The global batch's shape (N, p, p, C)."""
        if isinstance(data, DeviceDataset):
            p = self.cfg.patch_size
            return (self.cfg.batch_size, p, p, data.rec_shape[-1])
        n, *rest = (data[1] if self.real else data).shape
        return (n * (self.mesh.world if local else 1), *rest)

    def _draws(self, data, noise: dict, shape: tuple) -> dict:
        """Every draw of the step at the global batch's ``shape``, in the
        generator's order (sample, then mixup or synth); a part that
        ``noise`` holds is taken as it is and not drawn."""
        cfg, g, dev = self.cfg, self.generator, self.device
        out = dict(noise)
        if isinstance(data, DeviceDataset) and out.get("sample") is None:
            out["sample"] = patch_draws(data.arrays[0].shape, shape[0],
                                        cfg.patch_size, True, g, dev)
        if self.mixes_rows and out.get("mixup") is None:
            out["mixup"] = mixup_draws(shape[0], generator=g, device=dev)
        elif not self.real and out.get("synth") is None:
            out["synth"] = noisy_batch_draws(shape, cfg.noise_mode, g, dev)
        return out

    @torch.no_grad()
    def _batch(self, data, noise: dict, rows: slice, local: bool):
        """This rank's (im_noisy, im_gt, sigma_gt) on the device."""
        cfg = self.cfg
        whole = self.mixes_rows      # MixUp needs the global batch
        if isinstance(data, DeviceDataset):
            data = self._sample(data, noise["sample"] if whole
                                else map_rows(noise["sample"], rows))
        elif not (local or whole):
            data = map_rows(data, rows)
        if self.real:
            im_noisy, im_gt = (self._to_device(t) for t in data)
            if whole:
                im_gt, im_noisy = mixup_pairs(im_gt, im_noisy,
                                              draws=noise["mixup"])
                im_gt, im_noisy = im_gt[rows], im_noisy[rows]
            return im_noisy, im_gt, noise_estimate(im_noisy, im_gt,
                                                   cfg.var_window)
        im_gt = self._to_device(data)
        im_noisy, sigma_gt = synthesize_noisy_batch(
            im_gt, mode=cfg.noise_mode, draws=map_rows(noise["synth"], rows))
        return im_noisy, im_gt, sigma_gt

    def _sample(self, dataset: DeviceDataset, draws: dict):
        """A uint8 batch gathered on the device from ``dataset``'s records
        by ``draws``: GT patches (synthetic) or (noisy, gt) pairs with
        shared draws (real)."""
        if dataset.paired != self.real:
            raise ValueError(
                "real-noise training needs paired (noisy, gt) records and "
                "synthetic training GT records alone; got "
                f"{'paired' if dataset.paired else 'unpaired'} records")
        arrays = dataset.arrays
        return sample_patches(arrays[0], draws["idx"].shape[0],
                              self.cfg.patch_size,
                              extra=arrays[1] if self.real else None,
                              draws=draws)

    def loss_and_grads(self, batch, epoch: int, noise: Optional[dict] = None,
                       local: bool = False):
        """Forward and backward of one step; the gradients are left in the
        parameters' ``.grad`` (averaged over the ranks of a mesh).
        ``batch``: the global batch, GT NHWC (synthetic) or a (noisy, gt)
        pair (real), float in [0, 1] or uint8 (this rank's rows of it
        with ``local``), or a DeviceDataset to sample from.  ``noise``:
        dict(synth=the draws of synthesize_noisy_batch, mixup=(indices,
        lam), sample=the draws of data/device_data.sample_patches) at the
        global batch's shape, each optional, in place of the per-step
        generator.  Returns (loss, aux scalars), averaged over the ranks.
        Inside ``precision.train_step_mode``: TF32 off from the synthesis
        to the end of the backward (the convolutions run in bf16 under
        autocast when ``mixed_precision``) and cuDNN deterministic; the
        process-wide flags are put back afterwards."""
        with train_step_mode():
            return self._loss_and_grads(batch, epoch, noise or {}, local)

    def _loss_and_grads(self, batch, epoch: int, noise: dict, local: bool):
        cfg = self.cfg
        self.generator.manual_seed(step_seed(cfg.seed, epoch, self.step))
        shape = self._gt_shape(batch, local)
        rows = self.mesh.rows(shape[0])
        im_noisy, im_gt, sigma_gt = self._batch(
            batch, self._draws(batch, noise, shape), rows, local)
        beta0 = self.alpha0 * sigma_gt
        self.optim.zero_grad()
        with torch.autocast(self.device.type, torch.bfloat16,
                            enabled=cfg.mixed_precision):
            mu, sigma = self.model(im_noisy)
        loss, lh, klg, klig = elbo_denoising(
            mu.float(), sigma.float(), im_noisy, im_gt, cfg.eps2,
            self.alpha0, beta0)
        loss.backward()
        loss = loss.detach()
        aux = dict(lh=lh.detach(), kl_gauss=klg.detach(),
                   kl_ig=klig.detach())
        self.mesh.all_reduce_mean_(
            [p.grad for p in self.optim.params if p.grad is not None]
            + [loss, *aux.values()])
        return loss, aux

    def run_step(self, batch, epoch: int, noise: Optional[dict] = None,
                 local: bool = False) -> Dict[str, torch.Tensor]:
        """One optimization step on a global batch (this rank's rows of it
        with ``local``).  Returns the loss, the ELBO's terms and the
        pre-clip gradient norms as 0-d tensors on the device (no host
        synchronisation)."""
        loss, aux = self.loss_and_grads(batch, epoch, noise, local)
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
        """One epoch over global host batches, through the prefetcher
        when ``cfg.prefetch > 0`` (which moves this rank's rows only, or
        the whole batch when the step mixes rows); its stats come back as
        ``prefetch_*``."""
        if self.cfg.prefetch <= 0:
            return self._epoch(epoch, batch_iter, self.cfg.steps_per_epoch,
                               log_fn)
        rows = (None if self.mixes_rows
                else self.mesh.rows(self.cfg.batch_size))
        with DevicePrefetcher(batch_iter, self.device, self.cfg.prefetch,
                              rows) as batches:
            out = self._epoch(epoch, batches, self.cfg.steps_per_epoch,
                              log_fn, local=rows is not None)
        out.update({f"prefetch_{k}": v for k, v in batches.stats.items()})
        return out

    def train_epoch_device(self, epoch: int, dataset: DeviceDataset,
                           steps: int, log_fn: Optional[Callable] = None
                           ) -> Dict[str, float]:
        """``steps`` steps of ``run_step_device`` on ``dataset``."""
        return self._epoch(epoch, (dataset for _ in range(steps)), steps,
                           log_fn)

    def _epoch(self, epoch: int, batches, steps: int,
               log_fn: Optional[Callable],
               local: bool = False) -> Dict[str, float]:
        cfg = self.cfg
        tic = time.time()
        sums: Dict[str, float] = {}
        count = 0
        for ii, batch in enumerate(batches):
            aux = self.run_step(batch, epoch, local=local)
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
        """Rank 0 writes the checkpoint; every rank waits for it."""
        if self.mesh.rank == 0:
            self.ckpt.save(epoch + 1, dict(
                params=self.model.state_dict(),
                opt_state=self.optim.state_dict(), step=self.step,
                epoch=epoch + 1, generator=self.generator.get_state()))
        self.mesh.barrier()

    def restore(self, step: Optional[int] = None) -> int:
        """Load the given (default: latest) checkpoint; returns the epoch
        to continue from, 0 when there is none."""
        state = self.ckpt.restore(step, map_location=self.device)
        if state is None:
            return 0
        self.model.load_state_dict(state["params"], strict=True)
        self.mesh.replicate(self.model.parameters())
        self.optim.load_state_dict(state["opt_state"])
        self.step = int(state["step"])
        self.generator.set_state(state["generator"].cpu())
        return int(state["epoch"])
