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

Not ported yet: the data mesh, the device prefetcher and device-resident
data (``run_step_device``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from ..data.sisr_synth import SISRBatch, synthesize_sisr_batch
from ..losses.elbo import elbo_sisr
from ..models.virnet import VIRNetSR
from ..precision import parity_mode, resolve_device
from .checkpoint import CheckpointManager
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
    add_jpeg_in_graph: bool = False   # device-side JPEG noise branch; needs
                                      # ops/jpeg.py, not ported yet: raises
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
    prefetch: int = 2           # accepted for config compatibility; no
                                # prefetcher is ported yet, so it is a no-op
    mixed_precision: bool = True  # bf16 autocast around the model forward
                                  # (parameters and Adam state stay fp32)
    remat: bool = False         # accepted for config compatibility; a no-op
    seed: int = 1234
    save_dir: str = "./train_save_sisr"
    print_freq: int = 100


def _step_seed(seed: int, epoch: int, step: int) -> int:
    """One seed per (seed, epoch, step): a resumed run draws what the
    uninterrupted run would have drawn."""
    return ((seed * 1_000_003 + epoch) * 1_000_003 + step) % (2 ** 63 - 1)


class SISRTrainer:
    """``host_batches=True`` consumes already degraded (hr, lr, kinfo,
    nlevel) batches; otherwise HR batches are degraded on the device
    (data/sisr_synth.py).  ``device`` defaults to the card; pass
    ``device="cpu"`` to run the kernels' plain versions on the CPU."""

    def __init__(self, cfg: SISRTrainConfig, device="cuda",
                 host_batches: bool = False):
        self.cfg = cfg
        self.host_batches = host_batches
        self.device = resolve_device(device)

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            model = VIRNetSR(
                im_chn=cfg.im_chn, sigma_chn=cfg.sigma_chn,
                kernel_chn=cfg.kernel_chn, n_feat=cfg.n_feat,
                dep_S=cfg.dep_S, dep_K=cfg.dep_K, noise_cond=cfg.noise_cond,
                kernel_cond=cfg.kernel_cond, n_resblocks=cfg.n_resblocks,
                extra_mode=cfg.extra_mode, noise_avg=True,
                conv_impl="torch")
        self.model = model.to(self.device).train()
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

    def _batch(self, data, noise: Optional[dict]) -> SISRBatch:
        cfg = self.cfg
        if self.host_batches:
            im_hr, im_lr, kinfo_gt, nlevel = (self._to_device(t)
                                              for t in data)
            return SISRBatch(im_hr=im_hr, im_lr=im_lr, im_blur=im_lr,
                             kinfo=kinfo_gt, nlevel=nlevel)
        return synthesize_sisr_batch(
            self._to_device(data), cfg.sf, cfg.k_size,
            cfg.kernel_shift, cfg.downsampler, cfg.noise_level,
            add_jpeg=cfg.add_jpeg_in_graph, noise_jpeg=cfg.noise_jpeg,
            generator=self.generator, draws=(noise or {}).get("synth"))

    def loss_and_grads(self, data, epoch: int, noise: Optional[dict] = None):
        """Forward and backward of one step; the gradients are left in the
        parameters' ``.grad``.  ``noise``: dict(synth=the draws of
        synthesize_sisr_batch, elbo=the noise of elbo_sisr), each optional,
        in place of the per-step generator.  Returns (loss, aux scalars).
        TF32 is off from the synthesis to the end of the backward (the
        blur, the resize and the ELBO are full f32; the convolutions run
        in bf16 under autocast when ``mixed_precision``), and the
        process-wide flags are put back afterwards."""
        with parity_mode():
            return self._loss_and_grads(data, epoch, noise)

    def _loss_and_grads(self, data, epoch: int, noise: Optional[dict]):
        cfg = self.cfg
        self.generator.manual_seed(_step_seed(cfg.seed, epoch, self.step))
        batch = self._batch(data, noise)
        sigma_prior = (batch.nlevel ** 2).reshape(-1, 1, 1, 1)
        self.optim.zero_grad()
        with torch.autocast(self.device.type, torch.bfloat16,
                            enabled=cfg.mixed_precision):
            mu, kinfo_est, sigma_est = self.model(batch.im_lr, cfg.sf)
        loss, aux = elbo_sisr(
            mu.float(), sigma_est.float(), kinfo_est.float(), batch.im_hr,
            batch.im_lr, sigma_prior, self.alpha0, batch.kinfo, cfg.kappa0,
            cfg.r2, cfg.eps2, cfg.sf, cfg.k_size, cfg.penalty_K,
            cfg.kernel_shift, cfg.downsampler, generator=self.generator,
            noise=(noise or {}).get("elbo"))
        loss.backward()
        scalars = {k: v.detach() for k, v in aux.items() if k != "kernel"}
        return loss.detach(), scalars

    def run_step(self, im_hr_batch, epoch: int,
                 noise: Optional[dict] = None) -> Dict[str, torch.Tensor]:
        """One training step on an HR batch (N, H, W, C), float in [0, 1]
        or uint8 (or the host-batch tuple).  Returns the loss, the ELBO's
        terms and the pre-clip gradient norms as 0-d tensors on the
        device (no host synchronisation)."""
        loss, aux = self.loss_and_grads(im_hr_batch, epoch, noise)
        norms = self.optim.step()
        self.step += 1
        aux.update(loss=loss, gnorm_r=norms["rnet"], gnorm_s=norms["snet"],
                   gnorm_k=norms["knet"])
        return aux

    def train_epoch(self, epoch: int, batch_iter,
                    log_fn: Optional[Callable] = None) -> Dict[str, float]:
        cfg = self.cfg
        tic = time.time()
        sums: Dict[str, float] = {}
        count = 0
        for ii, batch in enumerate(batch_iter):
            aux = self.run_step(batch, epoch)
            if (ii + 1) % cfg.print_freq == 0 or ii == 0:
                vals = {k: float(v) for k, v in aux.items()}
                lr = self.schedule(self.step)
                msg = (f"[Epoch:{epoch + 1:>2d}/{cfg.epochs:<2d}] "
                       f"train:{ii + 1:0>5d}/{cfg.steps_per_epoch:0>5d}, "
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
