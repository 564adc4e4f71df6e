"""The random inputs of the Gibbs chain, drawn by the benchmark: the
initial factors and every sweep's noise.

A sweep of Algorithm 1 consumes, for each side in the order the sweep
visits them (items, then users): a Normal-Wishart draw, by the Bartlett
decomposition (K chi2 draws with nu0 + n - i degrees of freedom for
i = 0..K-1, a K x K standard normal of which the strict lower part is
used, and a K-vector standard normal for mu), and a standard normal
(n, K) for the factor solves. The benchmark draws them and hands the same
tensors to the program (`GibbsSampler.sweep(state, noise)`) and to the
reference, so a sweep is a deterministic function of its inputs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SideNoise(NamedTuple):
    chi2: torch.Tensor    # (K,)
    normal: torch.Tensor  # (K, K)
    z_mu: torch.Tensor    # (K,)
    z: torch.Tensor       # (n, K)


class SweepInputs(NamedTuple):
    items: SideNoise
    users: SideNoise


def side_noise(n: int, k: int, nu0: float, gen: torch.Generator) -> SideNoise:
    dev = gen.device
    df = nu0 + n - torch.arange(k, dtype=torch.float64, device=dev)
    # chi2(nu) = 2 Gamma(nu / 2)
    chi2 = (2.0 * torch._standard_gamma(df / 2.0, generator=gen)).float()
    normal = torch.randn((k, k), generator=gen, device=dev)
    z_mu = torch.randn((k,), generator=gen, device=dev)
    z = torch.randn((n, k), generator=gen, device=dev)
    return SideNoise(chi2, normal, z_mu, z)


def sweep_noise(m: int, n: int, k: int, nu0: float, gen: torch.Generator
                ) -> SweepInputs:
    """One sweep's noise for m users and n items."""
    items = side_noise(n, k, nu0, gen)
    return SweepInputs(items=items, users=side_noise(m, k, nu0, gen))


def initial_factors(m: int, n: int, k: int, scale: float, gen: torch.Generator
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(U (m, k), V (n, k)), each entry N(0, scale^2)."""
    dev = gen.device
    u = scale * torch.randn((m, k), generator=gen, device=dev)
    v = scale * torch.randn((n, k), generator=gen, device=dev)
    return u, v
