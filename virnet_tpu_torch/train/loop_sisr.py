"""Blind-SISR trainer (counterpart of virnet_tpu/train/loop_sisr.py; the
reference's train_SISR.py).

The whole degradation pipeline (per-sample anisotropic kernels, blur,
antialiased bicubic downsample, Gaussian noise) runs on the device under
``no_grad`` (data/sisr_synth.py); the host only serves HR patch batches.
The ELBO resamples the kernel covariance and differentiates through the
degradation every step (losses/elbo.py): the per-sample blur runs twice
forward (synthesis, likelihood) and once each as dX and dW, all as the
kernels of ops/blur.py.

Matching reference semantics: Adam + cosine (no warmup,
train_SISR.py:99-101), three per-subnet clip norms (:184, :226-228),
sigma prior = nlevel^2, alpha0 = 0.5 * var_window^2, kappa0 and penalty_K
from the config.  The model is built with ``conv_impl='torch'``: the fused
SNet and tail kernels are forward-only.

Input: host HR batches (``train_epoch``, through the prefetcher of
data/prefetch.py when ``cfg.prefetch > 0``), already degraded host batches
(``host_batches``, the libjpeg path of data/sisr_host.py), or HR records
resident on the device (``run_step_device`` / ``train_epoch_device``,
data/device_data.py), where the patch draws come from the step's
generator before the synthesis draws.

Data parallelism (``mesh``, train/mesh.py): one process per card, each
with a full replica of the parameters (broadcast from rank 0 at
construction and restore).  Every rank seeds the step's generator alike,
draws every random tensor of the step at the global batch's shape and
keeps its rows, and takes its rows of the global batch; after the
backward the gradients, the loss and the ELBO's terms are averaged over
the ranks (one flat buffer), so the clip norms are global and a run of N
ranks takes the steps of one process at the same global batch.  ``remat``
recomputes RNet's blocks in the backward (models/attresunet.py).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from ..data.device_data import DeviceDataset, patch_draws, sample_patches
from ..data.prefetch import DevicePrefetcher
from ..data.sisr_synth import (SISRBatch, sisr_batch_draws,
                               synthesize_sisr_batch)
from ..eval.profiling import span
from ..losses.elbo import elbo_sisr, sisr_elbo_draws
from ..models.virnet import VIRNetSR
from ..precision import resolve_device, train_step_mode
from .checkpoint import CheckpointManager
from .mesh import Mesh, map_rows
from .optim import SubnetAdam


@dataclass
class SISRTrainConfig:
    # model
    im_chn: int = 3
    sigma_chn: int = 1
    kernel_chn: int = 3
    dep_S: int = 5
    dep_K: int = 8
    n_feat: tuple = (96, 160, 224)
    n_resblocks: int = 2
    extra_mode: str = "both"
    noise_cond: bool = True
    kernel_cond: bool = True
    # degradation
    sf: int = 4
    k_size: int = 21
    kernel_shift: bool = False
    downsampler: str = "bicubic"
    noise_level: tuple = (0.01, 15.0)
    add_jpeg_in_graph: bool = False   # device-side JPEG noise branch
                                      # (ops/jpeg.py)
    noise_jpeg: tuple = (0.1, 10.0)
    # training
    batch_size: int = 16
    hr_size: int = 192
    epochs: int = 120
    warmup_epochs: int = 0
    steps_per_epoch: int = 10000
    lr: float = 2e-4
    lr_min: float = 1e-6
    clip_grad_R: float = 5e2
    clip_grad_S: float = 1e2
    clip_grad_K: float = 5e2
    eps2: float = 1e-5
    r2: float = 1e-4
    var_window: int = 9
    kappa0: float = 50.0
    penalty_K: tuple = (0.02, 2.0)
    prefetch: int = 2           # host batches in flight ahead of the step
                                # (data/prefetch.py; 0 switches it off)
    mixed_precision: bool = True  # bf16 autocast around the model forward
                                  # (parameters and Adam state stay fp32)
    remat: bool = False         # recompute RNet's blocks in the backward
                                # (torch.utils.checkpoint)
    seed: int = 1234
    save_dir: str = "./train_save_sisr"
    print_freq: int = 100


def step_seed(seed: int, epoch: int, step: int) -> int:
    """One seed per (seed, epoch, step): a resumed run draws what the
    uninterrupted run would have drawn."""
    return ((seed * 1_000_003 + epoch) * 1_000_003 + step) % (2 ** 63 - 1)


class SISRTrainer:
    """``host_batches=True`` consumes already degraded (hr, lr, kinfo,
    nlevel) batches; otherwise HR batches are degraded on the device
    (data/sisr_synth.py).  ``device`` defaults to the card; pass
    ``device="cpu"`` to run the kernels' plain versions on the CPU.
    ``mesh`` (train/mesh.py) makes the trainer one rank of a
    data-parallel run; the batch size must divide by its world size."""

    def __init__(self, cfg: SISRTrainConfig, device="cuda",
                 host_batches: bool = False, mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.host_batches = host_batches
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else Mesh([self.device])
        self.mesh.rows(cfg.batch_size)          # divisibility

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            model = VIRNetSR(
                im_chn=cfg.im_chn, sigma_chn=cfg.sigma_chn,
                kernel_chn=cfg.kernel_chn, n_feat=cfg.n_feat,
                dep_S=cfg.dep_S, dep_K=cfg.dep_K, noise_cond=cfg.noise_cond,
                kernel_cond=cfg.kernel_cond, n_resblocks=cfg.n_resblocks,
                extra_mode=cfg.extra_mode, noise_avg=True,
                conv_impl="torch", remat=cfg.remat)
        self.model = model.to(self.device).train()
        self.mesh.replicate(self.model.parameters())
        self.subnets = {"rnet": self.model.RNet, "snet": self.model.SNet,
                        "knet": self.model.KNet}
        self.optim = SubnetAdam(
            self.subnets, cfg.lr, cfg.lr_min, cfg.epochs, cfg.warmup_epochs,
            cfg.steps_per_epoch,
            clip_map={"rnet": cfg.clip_grad_R, "snet": cfg.clip_grad_S,
                      "knet": cfg.clip_grad_K})
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

    def _hr_shape(self, data, local: bool) -> tuple:
        """The global HR batch's shape (N, H, W, C)."""
        if isinstance(data, DeviceDataset):
            hr = self.cfg.hr_size
            return (self.cfg.batch_size, hr, hr, data.rec_shape[-1])
        n, *rest = (data[0] if self.host_batches else data).shape
        return (n * (self.mesh.world if local else 1), *rest)

    def _draws(self, data, noise: dict, shape: tuple) -> dict:
        """Every draw of the step at the global HR batch's ``shape``, in
        the generator's order (sample, synth, elbo); a part that ``noise``
        holds is taken as it is and not drawn."""
        cfg, g, dev = self.cfg, self.generator, self.device
        out = dict(noise)
        if isinstance(data, DeviceDataset) and out.get("sample") is None:
            out["sample"] = patch_draws(data.arrays[0].shape, shape[0],
                                        cfg.hr_size, True, g, dev)
        if not self.host_batches and out.get("synth") is None:
            out["synth"] = sisr_batch_draws(
                shape, cfg.sf, cfg.downsampler, cfg.noise_level,
                cfg.add_jpeg_in_graph, cfg.noise_jpeg, g, dev)
        out["elbo"] = sisr_elbo_draws(shape[0], shape, cfg.kappa0, 1, g, dev,
                                      given=out.get("elbo"))
        return out

    def _batch(self, data, noise: dict, rows: slice,
               local: bool) -> SISRBatch:
        """This rank's rows of the step's batch, degraded on the device
        (or already degraded host batches)."""
        cfg = self.cfg
        if isinstance(data, DeviceDataset):
            if self.host_batches:
                raise ValueError("device-resident data requires on-device "
                                 "degradation (host_batches=False)")
            data = sample_patches(data.arrays[0], rows.stop - rows.start,
                                  cfg.hr_size, draws=noise["sample"])
        elif not local:
            data = map_rows(data, rows)
        if self.host_batches:
            im_hr, im_lr, kinfo_gt, nlevel = (self._to_device(t)
                                              for t in data)
            return SISRBatch(im_hr=im_hr, im_lr=im_lr, im_blur=im_lr,
                             kinfo=kinfo_gt, nlevel=nlevel)
        return synthesize_sisr_batch(
            self._to_device(data), cfg.sf, cfg.k_size,
            cfg.kernel_shift, cfg.downsampler, cfg.noise_level,
            add_jpeg=cfg.add_jpeg_in_graph, noise_jpeg=cfg.noise_jpeg,
            draws=noise["synth"])

    def loss_and_grads(self, data, epoch: int, noise: Optional[dict] = None,
                       local: bool = False):
        """Forward and backward of one step; the gradients are left in the
        parameters' ``.grad`` (averaged over the ranks of a mesh).
        ``data``: the global batch (this rank's rows of it with
        ``local``), or a DeviceDataset.  ``noise``: dict(synth=the draws
        of synthesize_sisr_batch, elbo=the noise of elbo_sisr, sample=the
        draws of data/device_data.sample_patches) at the global batch's
        shape, each optional, in place of the per-step generator.
        Returns (loss, aux scalars), averaged over the ranks.  Inside
        ``precision.train_step_mode``: TF32 off from the synthesis to the
        end of the backward (the blur, the resize and the ELBO are full
        f32; the convolutions run in bf16 under autocast when
        ``mixed_precision``) and cuDNN deterministic; the process-wide
        flags are put back afterwards."""
        with train_step_mode():
            return self._loss_and_grads(data, epoch, noise or {}, local)

    def _loss_and_grads(self, data, epoch: int, noise: dict, local: bool):
        cfg = self.cfg
        with span("train.data"):
            self.generator.manual_seed(step_seed(cfg.seed, epoch, self.step))
            shape = self._hr_shape(data, local)
            rows = self.mesh.rows(shape[0])
            noise = map_rows(self._draws(data, noise, shape), rows)
            batch = self._batch(data, noise, rows, local)
            sigma_prior = (batch.nlevel ** 2).reshape(-1, 1, 1, 1)
        self.optim.zero_grad()
        with span("train.forward"), torch.autocast(
                self.device.type, torch.bfloat16,
                enabled=cfg.mixed_precision):
            mu, kinfo_est, sigma_est = self.model(batch.im_lr, cfg.sf)
        with span("train.elbo"):
            loss, aux = elbo_sisr(
                mu.float(), sigma_est.float(), kinfo_est.float(),
                batch.im_hr, batch.im_lr, sigma_prior, self.alpha0,
                batch.kinfo, cfg.kappa0, cfg.r2, cfg.eps2, cfg.sf,
                cfg.k_size, cfg.penalty_K, cfg.kernel_shift,
                cfg.downsampler, noise=noise["elbo"])
        with span("train.backward"):
            loss.backward()
            loss = loss.detach()
            scalars = {k: v.detach() for k, v in aux.items()
                       if k != "kernel"}
            self.mesh.all_reduce_mean_(
                [p.grad for p in self.optim.params if p.grad is not None]
                + [loss, *scalars.values()])
        return loss, scalars

    def run_step(self, im_hr_batch, epoch: int,
                 noise: Optional[dict] = None,
                 local: bool = False) -> Dict[str, torch.Tensor]:
        """One training step on a global HR batch (N, H, W, C), float in
        [0, 1] or uint8 (or the host-batch tuple; this rank's rows of it
        with ``local``).  Returns the loss, the ELBO's terms and the
        pre-clip gradient norms as 0-d tensors on the device (no host
        synchronisation)."""
        with span("train.step"):
            loss, aux = self.loss_and_grads(im_hr_batch, epoch, noise, local)
            norms = self.optim.step()
            self.step += 1
        aux.update(loss=loss, gnorm_r=norms["rnet"], gnorm_s=norms["snet"],
                   gnorm_k=norms["knet"])
        return aux

    def run_step_device(self, dataset: DeviceDataset, epoch: int,
                        noise: Optional[dict] = None
                        ) -> Dict[str, torch.Tensor]:
        """One training step on an HR batch sampled on the device from
        ``dataset``'s records (random record, crop and dihedral mode), then
        degraded there: sampling, synthesis and the ELBO all draw from the
        step's generator, so a resumed run draws what the uninterrupted
        run would have.  Raises with ``host_batches``."""
        return self.run_step(dataset, epoch, noise)

    def train_epoch(self, epoch: int, batch_iter,
                    log_fn: Optional[Callable] = None) -> Dict[str, float]:
        """One epoch over global host batches, through the prefetcher
        (which moves this rank's rows only) when ``cfg.prefetch > 0``; its
        stats come back as ``prefetch_*``."""
        if self.cfg.prefetch <= 0:
            return self._epoch(epoch, batch_iter, self.cfg.steps_per_epoch,
                               log_fn)
        with DevicePrefetcher(batch_iter, self.device, self.cfg.prefetch,
                              self.mesh.rows(self.cfg.batch_size)
                              ) as batches:
            out = self._epoch(epoch, batches, self.cfg.steps_per_epoch,
                              log_fn, local=True)
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
                       f"lh={vals['lh']:+4.2f}, KLR={vals['kl_rnet']:+6.2f}, "
                       f"KLS={vals['kl_snet']:+6.2f}, "
                       f"KLK={vals['kl_knet']:+6.2f}, lr={lr:.2e}")
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
