from .elbo import (elbo_sisr, kl_gauss, kl_inverse_gamma, likelihood_sisr,
                   reparam_cov_mat, reparam_inv_gamma)

__all__ = ["elbo_sisr", "kl_gauss", "kl_inverse_gamma", "likelihood_sisr",
           "reparam_cov_mat", "reparam_inv_gamma"]
