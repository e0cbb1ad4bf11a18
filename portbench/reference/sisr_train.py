"""Plain reference of one blind-SISR training step: the batch assembled from
uint8 records, its degradation, the ELBO, the backward, the clip of each
subnet's gradients and Adam.

Written from the reference repository's train_SISR.py, datasets/
SISRDatasets.py, loss/ELBO_simple.py, utils/util_sisr.py and its vendored
ResizeRight, in plain PyTorch (NCHW float32, grouped ``F.conv2d`` for the
per-sample blur, autograd for every gradient).  Every random number comes
in ``draws``, the same tensors the benchmark hands the program.  It imports
nothing of the program under test.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from .models import virnet_sr

_F32_EPS = float(np.finfo(np.float32).eps)
_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)
BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


# ------------------------------------------------------------------ batch

def dihedral(im: torch.Tensor, mode: int) -> torch.Tensor:
    """Dihedral ``mode`` 0..7 of one HWC image: rot180 when mode // 2 >= 2,
    then a clockwise quarter turn when mode // 2 is odd, then an up-down
    flip when mode is odd."""
    if mode // 2 >= 2:
        im = im.flip(0, 1)
    if (mode // 2) % 2 == 1:
        im = torch.rot90(im, -1, (0, 1))
    if mode % 2 == 1:
        im = im.flip(0)
    return im


def crop_batch(records: torch.Tensor, sample: dict, patch: int):
    """(B, patch, patch, C) float32 in [0, 1]: record ``idx``, offsets
    ``oh`` / ``ow`` and dihedral ``mode`` of each sample."""
    out = []
    for i, oh, ow, m in zip(*(sample[k].tolist()
                              for k in ("idx", "oh", "ow", "mode"))):
        crop = records[i, oh:oh + patch, ow:ow + patch]
        out.append(dihedral(crop, m))
    return torch.stack(out).float() / 255.0


# ------------------------------------------------------------ degradation

def _cubic(x):
    a = np.abs(x)
    return ((1.5 * a ** 3 - 2.5 * a ** 2 + 1.0) * (a <= 1.0)
            + (-0.5 * a ** 3 + 2.5 * a ** 2 - 4.0 * a + 2.0)
            * ((1.0 < a) & (a <= 2.0)))


@lru_cache(maxsize=32)
def resize_matrix(in_sz: int, out_sz: int, scale: float) -> np.ndarray:
    """ResizeRight's antialiased bicubic resampling of one axis as a dense
    (out, in) float64 matrix, its mirrored field of view included."""
    support = 4.0
    kernel = _cubic
    if scale < 1.0:
        kernel = lambda x: scale * _cubic(scale * x)  # noqa: E731
        support = support / scale
    proj = (np.arange(out_sz, dtype=np.float64) / scale + (in_sz - 1) / 2
            - (out_sz - 1) / (2 * scale))
    left = np.ceil(proj - support / 2 - _F32_EPS).astype(np.int64)
    window = int(math.ceil(support - _F32_EPS))
    fov = left[:, None] + np.arange(window)[None, :]
    mirror = np.concatenate([np.arange(in_sz), np.arange(in_sz - 1, -1, -1)])
    fov = mirror[np.remainder(fov, mirror.shape[0])]
    w = kernel(proj[:, None] - fov)
    s = w.sum(axis=1, keepdims=True)
    s[s == 0] = 1.0
    w = w / s
    mat = np.zeros((out_sz, in_sz))
    np.add.at(mat, (np.repeat(np.arange(out_sz), window), fov.ravel()),
              w.ravel())
    return mat


def bicubic_down(x: torch.Tensor, sf: int) -> torch.Tensor:
    """NCHW antialiased bicubic downsample by ``sf`` (rows, then columns)."""
    h, w = x.shape[-2:]
    mh = torch.from_numpy(resize_matrix(h, math.ceil(h / sf), 1.0 / sf))
    mw = torch.from_numpy(resize_matrix(w, math.ceil(w / sf), 1.0 / sf))
    x = torch.einsum("oh,nchw->ncow", mh.to(x), x)
    return torch.einsum("pw,nchw->nchp", mw.to(x), x)


def pad_symmetric(x: torch.Tensor, pad: int) -> torch.Tensor:
    """NCHW edge-repeating padding (numpy 'symmetric', scipy 'reflect')."""
    x = torch.cat([x[..., :pad, :].flip(-2), x, x[..., -pad:, :].flip(-2)],
                  -2)
    return torch.cat([x[..., :pad].flip(-1), x, x[..., -pad:].flip(-1)], -1)


def blur(x: torch.Tensor, kernels: torch.Tensor, pad_mode: str
         ) -> torch.Tensor:
    """Cross-correlate each NCHW image with its own (k, k) kernel, 'same'
    size, through one grouped convolution."""
    n, c, h, w = x.shape
    k = kernels.shape[-1]
    xp = (pad_symmetric(x, k // 2) if pad_mode == "symmetric"
          else F.pad(x, (k // 2,) * 4, mode="reflect"))
    wk = kernels.to(x.dtype).repeat_interleave(c, 0).unsqueeze(1)
    out = F.conv2d(xp.reshape(1, n * c, *xp.shape[-2:]), wk, groups=n * c)
    return out.view(n, c, h, w)


def _inv2x2(cov):
    a, b, c, d = cov[..., 0, 0], cov[..., 0, 1], cov[..., 1, 0], cov[..., 1, 1]
    det = a * d - b * c
    jitter = torch.where(det.abs() < 1e-12, 1e-5, 0.0).to(cov.dtype)
    a, d = a + jitter, d + jitter
    det = a * d - b * c
    return torch.stack([torch.stack([d, -b], -1),
                        torch.stack([-c, a], -1)], -2) / det[..., None, None]


def sigma2kernel(cov, k_size, sf, shift=False):
    """Softmax-normalised Gaussian kernels (N, k, k) of 2x2 covariances whose
    first axis is the image's rows (utils/util_sisr.py:26-58)."""
    inv = _inv2x2(cov.reshape(-1, 2, 2))
    center = (k_size // 2 + 0.5 * (sf - k_size % 2) if shift
              else float(k_size // 2))
    r = torch.arange(k_size, dtype=cov.dtype, device=cov.device) - center
    z = torch.stack([r.repeat_interleave(k_size), r.repeat(k_size)], -1)
    quad = -0.5 * torch.einsum("ki,nij,kj->nk", z, inv, z)
    return torch.softmax(quad.double(), 1).to(cov.dtype).reshape(
        -1, k_size, k_size)


def kernel_params(synth: dict, sf: int):
    """Covariances (data convention) and kinfo (s00, s11, rho) of the drawn
    anisotropic Gaussians (datasets/SISRDatasets.py:82-87)."""
    lam1, theta = synth["lam1"], synth["theta"]
    lam2 = lam1 + synth["lam2_u"] * (float(sf) - lam1)
    lam2 = torch.where(synth["iso_u"] >= 0.7, lam1, lam2)
    v1, v2 = lam1 ** 2, lam2 ** 2
    c, s = torch.cos(theta), torch.sin(theta)
    s00 = c * c * v1 + s * s * v2
    s11 = s * s * v1 + c * c * v2
    s01 = c * s * (v1 - v2)
    cov = torch.stack([torch.stack([s00, s01], -1),
                       torch.stack([s01, s11], -1)], -2)
    rho = s01 / (torch.sqrt(s00) * torch.sqrt(s11))
    return cov, torch.stack([s00, s11, rho], -1)


@torch.no_grad()
def synthesize(hr: torch.Tensor, synth: dict, cfg: dict) -> dict:
    """HR NCHW batch -> the degraded training batch: per-sample blur (true
    convolution, edge-repeating pad), clamp, bicubic downsample, Gaussian
    noise, clamp."""
    sf, k = cfg["sf"], cfg["k_size"]
    cov, kinfo = kernel_params(synth, sf)
    kernels = sigma2kernel(cov, k, sf, cfg["kernel_shift"]).transpose(-2, -1)
    im_blur = blur(hr, kernels.flip(-2, -1), "symmetric").clamp(0.0, 1.0)
    lr = bicubic_down(im_blur, sf)
    noise = synth["noise"].permute(0, 3, 1, 2)
    lr = (lr + noise * synth["nlevel"].view(-1, 1, 1, 1)).clamp(0.0, 1.0)
    return dict(hr=hr, lr=lr, kinfo=kinfo,
                nlevel=synth["nlevel"].view(-1, 1))


# ------------------------------------------------------------------- ELBO

def _kl_inv_gamma(beta_q, alpha_p, beta_p):
    return (alpha_p * (beta_p / beta_q - 1.0)
            + alpha_p * (torch.log(beta_q.double())
                         - torch.log(beta_p.double())).to(beta_q.dtype)
            ).mean()


def _kl_gauss(mu_q, mu_p, var_p):
    return 0.5 * ((mu_q - mu_p) ** 2 / var_p).mean()


def elbo(mu, sigma_est, kinfo_est, batch, elbo_draws, cfg):
    """The SISR ELBO (loss/ELBO_simple.py:82-138) and its terms."""
    sf, k = cfg["sf"], cfg["k_size"]
    kappa0, r2, eps2 = cfg["kappa0"], cfg["r2"], cfg["eps2"]
    alpha0 = 0.5 * float(cfg["var_window"]) ** 2
    kinfo_gt = batch["kinfo"]
    sigma_prior = (batch["nlevel"] ** 2).view(-1, 1, 1, 1)
    kl_rnet = _kl_gauss(mu, batch["hr"], eps2)
    beta = sigma_est * alpha0
    kl_snet = _kl_inv_gamma(beta, alpha0 - 1, sigma_prior * alpha0)
    kl0 = _kl_inv_gamma(kappa0 * kinfo_est[:, 0], kappa0 - 1,
                        kappa0 * kinfo_gt[:, 0])
    kl1 = _kl_inv_gamma(kappa0 * kinfo_est[:, 1], kappa0 - 1,
                        kappa0 * kinfo_gt[:, 1])
    kl2 = _kl_gauss(kinfo_est[:, 2], kinfo_gt[:, 2], r2) * cfg["penalty_K"][0]
    kl_knet = (kl0 + kl1 + kl2) / 3 * cfg["penalty_K"][1]
    # the kernel covariance resampled: Inverse-Gamma variances, a Gaussian
    # correlation, the off-diagonal through detached square roots
    k_var = kinfo_est[:, :2] * kappa0 / elbo_draws["gamma_draw"]
    v1, v2 = k_var[:, 0], k_var[:, 1]
    rho = kinfo_est[:, 2] + math.sqrt(r2) * elbo_draws["rho_eps"]
    off = torch.sqrt(v1.detach()) * torch.sqrt(v2.detach()) * rho.clamp(-1, 1)
    cov = torch.stack([torch.stack([v1, off], -1),
                       torch.stack([off, v2], -1)], -2)
    kernels = sigma2kernel(cov, k, sf, cfg["kernel_shift"])
    z = mu + elbo_draws["z_eps"].permute(0, 3, 1, 2) * math.sqrt(eps2)
    z_lr = bicubic_down(blur(z, kernels, "reflect"), sf)
    digamma = float(torch.special.digamma(
        torch.tensor(alpha0 - 1, dtype=torch.float64)))
    lh = (_HALF_LOG_2PI
          + 0.5 * (torch.log(beta.double()).to(beta.dtype) - digamma)
          + 0.5 * (alpha0 - 1) / beta * (batch["lr"] - z_lr) ** 2).mean()
    loss = lh + kl_rnet + kl_snet + kl_knet
    return loss, dict(lh=lh, kl_rnet=kl_rnet, kl_snet=kl_snet,
                      kl_knet=kl_knet)


# ------------------------------------------------------------------- steps

SUBNETS = ("RNet.", "SNet.", "KNet.")


def train_steps(params0: dict, records: torch.Tensor, draws: list,
                cfg: dict, arch: dict, quant=None) -> dict:
    """``len(draws)`` steps from ``params0`` (not modified): for each the
    loss and the ELBO's terms; the first step's gradients as Adam gets them
    (after each subnet's clip); and the parameters after the last step."""
    clip = {"RNet.": cfg["clip_grad_R"], "SNet.": cfg["clip_grad_S"],
            "KNet.": cfg["clip_grad_K"]}
    names = list(params0)
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    lr = cfg["lr"]      # epoch 0 of the cosine schedule is its base rate
    out: dict = dict(loss=[], terms=[])
    for t, d in enumerate(draws, start=1):
        hr = crop_batch(records, d["sample"], cfg["hr_size"])
        batch = synthesize(hr.permute(0, 3, 1, 2), d["synth"], cfg)
        mu, kinfo, sigma = virnet_sr(batch["lr"], cfg["sf"], p, arch, quant)
        loss, terms = elbo(mu, sigma, kinfo, batch, d["elbo"], cfg)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [p[k] for k in names])))
        with torch.no_grad():
            for prefix, max_norm in clip.items():
                keys = [k for k in names if k.startswith(prefix)]
                norm = torch.linalg.vector_norm(torch.stack(
                    [torch.linalg.vector_norm(grads[k]) for k in keys]))
                scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
                for k in keys:
                    grads[k] = grads[k] * scale
            if t == 1:
                out["grad1"] = {k: g.clone() for k, g in grads.items()}
            for k in names:
                g = grads[k]
                m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v2[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                mhat = m[k] / (1 - BETAS[0] ** t)
                vhat = v2[k] / (1 - BETAS[1] ** t)
                p[k].sub_(lr * mhat / (vhat.sqrt() + ADAM_EPS))
        out["loss"].append(float(loss.detach()))
        out["terms"].append({k: float(v.detach()) for k, v in terms.items()})
    out["params"] = {k: v.detach() for k, v in p.items()}
    return out
