"""Serving's S retained posterior draws, made on the device from a seed.

A retained draw of BPMF is a pair of factor matrices (U_s, V_s) near a
common posterior mode. The benchmark makes one mode, U0 (m, K) and V0
(n, K) with entries N(0, sigma^2), sigma = K^-1/4 so that u . v is of
order one, and each draw as the mode plus N(0, (spread sigma)^2) noise.
The hyperparameters a draw carries (mu, Lambda of each side) are zero and
the identity: top-N reads none of them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.data.seeds import generator


class Draws(NamedTuple):
    u: torch.Tensor   # (S, m, K)
    v: torch.Tensor   # (S, n, K)
    global_mean: float
    alpha: float


def draws(cfg: dict, n_draws: int, seed: int, device) -> Draws:
    """`n_draws` draws at the configuration's shape and rank."""
    m, n = int(cfg["data"]["n_users"]), int(cfg["data"]["n_items"])
    k = int(cfg["model"]["k"])
    spread = float(cfg["serve"]["draw_spread"])
    gen = generator(seed, "draws", device)
    sigma = k ** -0.25
    u0 = sigma * torch.randn((m, k), generator=gen, device=device)
    v0 = sigma * torch.randn((n, k), generator=gen, device=device)
    u = u0 + spread * sigma * torch.randn((n_draws, m, k), generator=gen, device=device)
    v = v0 + spread * sigma * torch.randn((n_draws, n, k), generator=gen, device=device)
    return Draws(u, v, float(cfg["serve"]["global_mean"]), float(cfg["model"]["alpha"]))
