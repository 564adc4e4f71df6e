"""Normal-Wishart hyperprior sampling for BPMF (Salakhutdinov & Mnih 2008).

The conditional posterior of (mu, Lambda) given a factor matrix X (n x K)
with NW(mu0, beta0, W0, nu0) prior is Normal-Wishart with

    beta* = beta0 + n            nu* = nu0 + n
    mu*   = (beta0 mu0 + n xbar) / beta*
    W*^-1 = W0^-1 + n S + (beta0 n / beta*) (xbar - mu0)(xbar - mu0)^T

computed from the sufficient statistics (sum_x, sum_xxT, n), as
`repro.core.hyper` does. The noise is explicit: a `WishartNoise` carries the
chi2 and normal draws of the Bartlett decomposition and the normal draw of
mu, so the tests can feed the reference's own `jax.random` draws.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class NWPrior(NamedTuple):
    mu0: torch.Tensor     # (K,)
    beta0: float
    w0_inv: torch.Tensor  # (K, K) inverse scale matrix
    nu0: float


class HyperParams(NamedTuple):
    mu: torch.Tensor    # (K,)
    lam: torch.Tensor   # (K, K) precision


class WishartNoise(NamedTuple):
    """The random draws of one Normal-Wishart sample."""

    chi2: torch.Tensor    # (K,) chi2(nu* - i) draws, Bartlett diagonal
    normal: torch.Tensor  # (K, K) N(0, 1); only the strict lower part is used
    z: torch.Tensor       # (K,) N(0, 1) for mu


def default_prior(k: int, dtype=torch.float32, device="cpu") -> NWPrior:
    return NWPrior(
        mu0=torch.zeros(k, dtype=dtype, device=device),
        beta0=2.0,
        w0_inv=torch.eye(k, dtype=dtype, device=device),
        nu0=float(k),
    )


def init_hyper(k: int, dtype=torch.float32, device="cpu") -> HyperParams:
    return HyperParams(
        mu=torch.zeros(k, dtype=dtype, device=device),
        lam=torch.eye(k, dtype=dtype, device=device),
    )


def draw_wishart_noise(prior: NWPrior, n: int, generator: torch.Generator
                       ) -> WishartNoise:
    """Draw the noise `sample_normal_wishart` consumes for a factor matrix
    of n rows (the chi2 degrees of freedom are nu0 + n - i)."""
    k = prior.mu0.shape[0]
    dtype, device = prior.mu0.dtype, prior.mu0.device
    df = prior.nu0 + n - torch.arange(k, dtype=dtype, device=device)
    # chi2(nu) = 2 * Gamma(nu / 2); torch._standard_gamma is the gamma
    # sampler that takes a Generator (torch.distributions' does not)
    chi2 = 2.0 * torch._standard_gamma(df / 2.0, generator=generator)
    normal = torch.randn((k, k), generator=generator, dtype=dtype, device=device)
    z = torch.randn((k,), generator=generator, dtype=dtype, device=device)
    return WishartNoise(chi2=chi2, normal=normal, z=z)


def cholesky_or_nan(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, NaN for a batch element that is not positive
    definite (what jnp.linalg.cholesky returns) instead of raising."""
    chol, info = torch.linalg.cholesky_ex(a)
    # in place: a half-sweep's batch of factors is gigabytes on the card
    return chol.masked_fill_((info != 0)[..., None, None], float("nan"))


def sample_wishart(scale_chol: torch.Tensor, chi2: torch.Tensor,
                   normal: torch.Tensor) -> torch.Tensor:
    """Wishart sample via the Bartlett decomposition: A is lower triangular
    with A_ii = sqrt(chi2_i) and A_ij = normal_ij below the diagonal; the
    sample is (L A)(L A)^T with L = chol(S)."""
    a = torch.tril(normal, -1) + torch.diag(torch.sqrt(chi2))
    la = scale_chol @ a
    return la @ la.T


def sample_normal_wishart(
    sum_x: torch.Tensor,
    sum_xxt: torch.Tensor,
    n: int,
    prior: NWPrior,
    noise: WishartNoise,
) -> HyperParams:
    """Sample (mu, Lambda) ~ NW-posterior given sufficient statistics."""
    k = sum_x.shape[-1]
    dtype, device = sum_x.dtype, sum_x.device
    xbar = sum_x / n
    n_s = sum_xxt - n * torch.outer(xbar, xbar)

    beta_star = prior.beta0 + n
    mu_star = (prior.beta0 * prior.mu0 + n * xbar) / beta_star
    diff = xbar - prior.mu0
    w_star_inv = (prior.w0_inv + n_s
                  + (prior.beta0 * n / beta_star) * torch.outer(diff, diff))
    w_star_inv = 0.5 * (w_star_inv + w_star_inv.T)
    l_inv = cholesky_or_nan(w_star_inv)
    eye = torch.eye(k, dtype=dtype, device=device)
    l_inv_sol = torch.linalg.solve_triangular(l_inv, eye, upper=False)
    w_star = l_inv_sol.T @ l_inv_sol  # = (L L^T)^-1

    scale_chol = cholesky_or_nan(0.5 * (w_star + w_star.T))
    lam = sample_wishart(scale_chol, noise.chi2, noise.normal)
    lam = 0.5 * (lam + lam.T)

    # mu ~ N(mu*, (beta* Lambda)^-1): mu = mu* + chol(beta* Lambda)^-T z
    lam_chol = cholesky_or_nan(beta_star * lam + 1e-6 * eye)
    mu = mu_star + torch.linalg.solve_triangular(
        lam_chol.T, noise.z[:, None], upper=True
    )[:, 0]
    return HyperParams(mu=mu, lam=lam)
