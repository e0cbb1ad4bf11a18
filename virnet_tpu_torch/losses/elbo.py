"""Evidence-lower-bound objectives (counterpart of
virnet_tpu/losses/elbo.py; reference loss/ELBO_simple.py).

The posteriors are parameterized by the three networks:
  * q(Z)   = N(mu, eps2)             — RNet output, fixed small variance
  * q(s2)  = Inv-Gamma(a0-1, s_hat*a0) — SNet output scales the prior shape
  * q(l_i) = Inv-Gamma(k0-1, k0*l_hat_i), q(rho) = N(rho_hat, r2) — KNet

All sampling is reparameterized.  Each function that samples takes a
``torch.Generator`` or the drawn tensors themselves (``gamma_draw``,
``rho_eps``, ``z_eps``), so that a test can hand this package and the JAX
package the same numbers.  The shape parameter of every Gamma draw is a
constant (k0 - 1), so the draw itself needs no gradient: it is sampled
under ``no_grad`` and the Inverse-Gamma sample is beta / draw.  The SISR
likelihood differentiates through kernel synthesis, the per-sample blur
(kernels K5-K7 of ops/blur.py) and the antialiased bicubic downsample
every step (reference loss/ELBO_simple.py:55-59, 124-134).

On the CPU log goes through float64 (see ops/fused_conv.exp_clip); on the
card it stays in the tensor's dtype.  digamma of the constant shape is a
host float64.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Union

import torch

from ..ops.degrade import degrade_batch
from ..ops.kernels import sigma2kernel

MuLike = Union[torch.Tensor, List[torch.Tensor]]

_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


def _log(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return torch.log(x.double()).to(x.dtype)
    return torch.log(x)


def _digamma(alpha: float) -> float:
    return float(torch.special.digamma(
        torch.tensor(float(alpha), dtype=torch.float64)))


def kl_inverse_gamma(beta_q: torch.Tensor, alpha_p, beta_p) -> torch.Tensor:
    """Simplified Inv-Gamma/Inv-Gamma KL, mean-reduced (reference
    loss/ELBO_simple.py:12-14)."""
    out = alpha_p * (beta_p / beta_q - 1.0) + alpha_p * (
        _log(beta_q) - _log(beta_p))
    return out.mean()


def kl_gauss(mu_q: torch.Tensor, mu_p: torch.Tensor, var_p) -> torch.Tensor:
    """0.5 * mean((mu_q - mu_p)^2 / var_p)."""
    return 0.5 * ((mu_q - mu_p) ** 2 / var_p).mean()


def _as_list(mu: MuLike) -> List[torch.Tensor]:
    return list(mu) if isinstance(mu, (list, tuple)) else [mu]


def likelihood_denoising(x: torch.Tensor, mu_q: torch.Tensor, var_q: float,
                         alpha_q: float, beta_q: torch.Tensor) -> torch.Tensor:
    """Gaussian likelihood under the Inv-Gamma noise posterior (reference
    loss/ELBO_simple.py:18-21)."""
    temp = 0.5 * (_log(beta_q) - _digamma(alpha_q)
                  + alpha_q / beta_q * ((x - mu_q) ** 2 + var_q))
    return temp.mean() + _HALF_LOG_2PI


def elbo_denoising(mu: MuLike, sigma_est: torch.Tensor,
                   im_noisy: torch.Tensor, im_gt: torch.Tensor, eps2: float,
                   alpha0: float, beta0: torch.Tensor):
    """Denoising ELBO (reference loss/ELBO_simple.py:23-53).  ``mu`` may be
    a list of estimates, whose terms are averaged.  Returns (loss,
    likelihood, kl_gauss, kl_inv_gamma)."""
    mus = _as_list(mu)
    klg = sum(kl_gauss(m, im_gt, eps2) for m in mus) / len(mus)

    beta = sigma_est * alpha0
    klig = kl_inverse_gamma(beta, alpha0 - 1, beta0)

    lh = sum(likelihood_denoising(im_noisy, m, eps2, alpha0 - 1, beta)
             for m in mus) / len(mus)
    return lh + klg + klig, lh, klg, klig


def reparam_inv_gamma(alpha: torch.Tensor, beta: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      gamma_draw: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Pathwise Inverse-Gamma sample: beta / Gamma(alpha, 1), with the
    gradient through beta only (``alpha`` is a constant here)."""
    if gamma_draw is None:
        with torch.no_grad():
            gamma_draw = torch._standard_gamma(alpha.detach(),
                                               generator=generator)
    return beta / gamma_draw


def reparam_cov_mat(kinfo_est: torch.Tensor, kappa0: float, rho_var: float,
                    generator: Optional[torch.Generator] = None,
                    gamma_draw: Optional[torch.Tensor] = None,
                    rho_eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Resample the 2x2 kernel covariance (reference
    loss/ELBO_simple.py:66-80).

    kinfo_est: (N, 3) = (l1, l2, rho).  The off-diagonal uses detached
    square roots of the resampled variances, as the reference does.
    ``gamma_draw`` (N, 2) standard-Gamma(k0 - 1) draws and ``rho_eps``
    (N,) standard normals replace the generator.  Returns (N, 2, 2)."""
    alpha_k = torch.full_like(kinfo_est[:, :2], kappa0 - 1.0)
    beta_k = kinfo_est[:, :2] * kappa0
    k_var = reparam_inv_gamma(alpha_k, beta_k, generator, gamma_draw)
    v1, v2 = k_var[:, 0], k_var[:, 1]

    rho_mean = kinfo_est[:, 2]
    if rho_eps is None:
        rho_eps = torch.randn(rho_mean.shape, generator=generator,
                              dtype=rho_mean.dtype, device=rho_mean.device)
    rho = rho_mean + math.sqrt(rho_var) * rho_eps
    direction = (torch.sqrt(v1.detach()) * torch.sqrt(v2.detach())
                 * torch.clamp(rho, -1.0, 1.0))
    return torch.stack([torch.stack([v1, direction], dim=-1),
                        torch.stack([direction, v2], dim=-1)], dim=-2)


def likelihood_sisr(x_lr: torch.Tensor, kernels: torch.Tensor, sf: int,
                    mu_q: torch.Tensor, var_q: float, alpha_q: float,
                    beta_q: torch.Tensor, downsampler: str,
                    generator: Optional[torch.Generator] = None,
                    z_eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Degradation-consistency likelihood: sample z ~ q(Z), degrade it with
    the resampled kernel, score against the LR input (reference
    loss/ELBO_simple.py:55-59).  ``z_eps``: standard normals of mu_q's
    shape, in place of the generator."""
    if z_eps is None:
        z_eps = torch.randn(mu_q.shape, generator=generator,
                            dtype=mu_q.dtype, device=mu_q.device)
    zz = mu_q + z_eps * math.sqrt(var_q)
    zz_blur = degrade_batch(zz, kernels, sf, downsampler, correlate=True)
    out = (_HALF_LOG_2PI + 0.5 * (_log(beta_q) - _digamma(alpha_q))
           + 0.5 * alpha_q / beta_q * (x_lr - zz_blur) ** 2)
    return out.mean()


def sisr_elbo_draws(n: int, mu_shape, kappa0: float, n_mu: int = 1,
                    generator: Optional[torch.Generator] = None,
                    device="cpu", dtype=torch.float32,
                    mu_dtype=torch.float32,
                    given: Optional[dict] = None) -> dict:
    """Every draw of ``elbo_sisr`` for ``n`` samples and ``n_mu`` estimates
    of ``mu_shape``, in the generator's order: ``gamma_draw`` (n, 2)
    Standard-Gamma(kappa0 - 1), ``rho_eps`` (n,) and ``z_eps`` (one
    standard normal tensor per estimate); a draw in ``given`` is taken as
    it is and not drawn.  A data-parallel rank draws the global batch's
    and keeps its rows."""
    given = given or {}
    out = {}
    out["gamma_draw"] = given.get("gamma_draw")
    if out["gamma_draw"] is None:
        with torch.no_grad():
            out["gamma_draw"] = torch._standard_gamma(
                torch.full((n, 2), kappa0 - 1.0, dtype=dtype, device=device),
                generator=generator)
    out["rho_eps"] = given.get("rho_eps")
    if out["rho_eps"] is None:
        out["rho_eps"] = torch.randn((n,), generator=generator, dtype=dtype,
                                     device=device)
    out["z_eps"] = given.get("z_eps")
    if out["z_eps"] is None:
        out["z_eps"] = [torch.randn(tuple(mu_shape), generator=generator,
                                    dtype=mu_dtype, device=device)
                        for _ in range(n_mu)]
    return out


def elbo_sisr(mu: MuLike, sigma_est: torch.Tensor, kinfo_est: torch.Tensor,
              im_hr: torch.Tensor, im_lr: torch.Tensor,
              sigma_prior: torch.Tensor, alpha0: float,
              kinfo_gt: torch.Tensor, kappa0: float, r2: float, eps2: float,
              sf: int, k_size: int, penalty_K: Sequence[float], shift: bool,
              downsampler: str,
              generator: Optional[torch.Generator] = None,
              noise: Optional[dict] = None):
    """SISR ELBO (reference loss/ELBO_simple.py:82-138).

    ``noise``: dict(gamma_draw (N, 2), rho_eps (N,), z_eps: one tensor of
    mu's shape per mu) in place of the generator.  Returns (loss, aux)
    with aux = dict(lh, kl_rnet, kl_snet, kl_knet, kl_knet0, kl_knet1,
    kl_knet2, kernel)."""
    mus = _as_list(mu)
    noise = sisr_elbo_draws(kinfo_est.shape[0], mus[0].shape, kappa0,
                            len(mus), generator, kinfo_est.device,
                            kinfo_est.dtype, mus[0].dtype, noise)
    kl_rnet = sum(kl_gauss(m, im_hr, eps2) for m in mus) / len(mus)

    beta0 = sigma_prior * alpha0
    beta = sigma_est * alpha0
    kl_snet = kl_inverse_gamma(beta, alpha0 - 1, beta0)

    kl_knet0 = kl_inverse_gamma(kappa0 * kinfo_est[:, 0], kappa0 - 1,
                                kappa0 * kinfo_gt[:, 0])
    kl_knet1 = kl_inverse_gamma(kappa0 * kinfo_est[:, 1], kappa0 - 1,
                                kappa0 * kinfo_gt[:, 1])
    kl_knet2 = kl_gauss(kinfo_est[:, 2], kinfo_gt[:, 2], r2) * penalty_K[0]
    kl_knet = (kl_knet0 + kl_knet1 + kl_knet2) / 3 * penalty_K[1]

    k_cov = reparam_cov_mat(kinfo_est, kappa0, r2, generator,
                            noise["gamma_draw"], noise["rho_eps"])
    kernels = sigma2kernel(k_cov, k_size, sf, shift)           # N x k x k

    z_eps = _as_list(noise["z_eps"])
    lh = sum(likelihood_sisr(im_lr, kernels, sf, m, eps2, alpha0 - 1, beta,
                             downsampler, generator, z)
             for m, z in zip(mus, z_eps)) / len(mus)

    loss = lh + kl_rnet + kl_snet + kl_knet
    aux = dict(lh=lh, kl_rnet=kl_rnet, kl_snet=kl_snet, kl_knet=kl_knet,
               kl_knet0=kl_knet0, kl_knet1=kl_knet1, kl_knet2=kl_knet2,
               kernel=kernels)
    return loss, aux
