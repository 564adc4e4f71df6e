"""The plain BPMF Gibbs sweep, from the raw ratings.

Algorithm 1 of arXiv:1705.10633 (Bayesian probabilistic matrix
factorisation, Salakhutdinov and Mnih 2008), written from the published
equations. One sweep, given the factors (U, V), both sides' hyper-
parameters and the sweep's noise:

  items:  (mu_V, Lambda_V) ~ NW posterior given V, by the Bartlett
          decomposition with the given chi2 and normal draws;
          for every item j:
            Lambda_j = Lambda_V + alpha sum_{i in R_j} u_i u_i^T
            b_j      = Lambda_V mu_V + alpha sum_{i in R_j} r_ij u_i
            v_j      = L_j^-T (L_j^-1 b_j + z_j),  L_j L_j^T = Lambda_j
          (an item without ratings keeps the prior: Lambda_j = Lambda_V);
  users:  the same from U's statistics, given the new V;
  then, once `step` has reached the burn-in, the posterior-predictive sum
  over the test ratings gains u_i . v_j + the global mean.

Ratings are centred on their global mean. The Normal-Wishart prior is
mu0 = 0, beta0, W0^-1 = I, nu0; mu is drawn from N(mu*, (beta* Lambda +
1e-6 I)^-1). Everything runs in the precision of an `Arith`: float64 for
the reference, a lower one for the controls. The statistics are Gram
products of each target's ratings, CHUNK at a time, the chunks of a
target then summed; a block of chunks at a time, so the reference fits
beside the program's inputs on one card.

Imports nothing of the program.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.arith import Arith


class Side(NamedTuple):
    """One side's ratings, sorted by target (the item for the item
    half-sweep): the source index (the counterpart row) and the centred
    rating of each, and the number of targets. Each target's ratings are
    laid out in chunks of CHUNK: rating i goes to chunk `chunk[i]`, slot
    `slot[i]`; chunk c belongs to target `chunk_target[c]`."""

    source: torch.Tensor
    vals: torch.Tensor      # float64, centred
    n_targets: int
    chunk: torch.Tensor
    slot: torch.Tensor
    chunk_target: torch.Tensor


class State(NamedTuple):
    u: torch.Tensor
    v: torch.Tensor
    mu_u: torch.Tensor
    lam_u: torch.Tensor
    mu_v: torch.Tensor
    lam_v: torch.Tensor
    step: int
    pred_sum: torch.Tensor
    pred_count: int


class Prior(NamedTuple):
    beta0: float
    nu0: float


class Noise(NamedTuple):
    """One side's noise: chi2 (K,), normal (K, K), z_mu (K,), z (n, K)."""

    chi2: torch.Tensor
    normal: torch.Tensor
    z_mu: torch.Tensor
    z: torch.Tensor


#: ratings a chunk of one target's Gram product holds
CHUNK = 32


def side(target: torch.Tensor, source: torch.Tensor, vals: torch.Tensor,
         n_targets: int) -> Side:
    order = torch.sort(target, stable=True).indices
    target = target[order]
    counts = torch.bincount(target, minlength=n_targets)
    chunks = (counts + CHUNK - 1) // CHUNK
    first_chunk = torch.cumsum(chunks, 0) - chunks
    rank = torch.arange(target.shape[0], device=target.device) - (
        torch.cumsum(counts, 0) - counts)[target]
    return Side(source[order], vals[order].double(), n_targets,
                first_chunk[target] + rank // CHUNK, rank % CHUNK,
                torch.repeat_interleave(torch.arange(n_targets, device=target.device),
                                        chunks))


def normal_wishart(x: torch.Tensor, prior: Prior, noise: Noise, ar: Arith
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(mu, Lambda) drawn from the Normal-Wishart posterior given x (n, K)."""
    x = ar.cast(x)
    n, k = x.shape
    dt, dev = x.dtype, x.device
    eye = torch.eye(k, dtype=dt, device=dev)
    xbar = x.sum(0) / n
    scatter = ar.mm(x.T, x) - n * torch.outer(xbar, xbar)
    beta = prior.beta0 + n
    mu_star = n * xbar / beta
    w_inv = eye + scatter + (prior.beta0 * n / beta) * torch.outer(xbar, xbar)
    w_inv = 0.5 * (w_inv + w_inv.T)
    w = torch.cholesky_inverse(torch.linalg.cholesky(w_inv))
    scale = torch.linalg.cholesky(0.5 * (w + w.T))
    a = torch.tril(ar.cast(noise.normal), -1) + torch.diag(torch.sqrt(ar.cast(noise.chi2)))
    la = ar.mm(scale, a)
    lam = ar.mm(la, la.T)
    lam = 0.5 * (lam + lam.T)
    chol = torch.linalg.cholesky(beta * lam + 1e-6 * eye)
    mu = mu_star + torch.linalg.solve_triangular(
        chol.T, ar.cast(noise.z_mu)[:, None], upper=True)[:, 0]
    return mu, lam


def statistics(cp: torch.Tensor, s: Side, ar: Arith, block: int = 1 << 16
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum u u^T (n_targets, K, K), sum r u (n_targets, K)) over each
    target's ratings, with u the counterpart rows: each chunk's Gram
    product X^T X and X^T r, then the chunks of a target summed in order,
    `block` chunks at a time."""
    k = cp.shape[1]
    dt, dev = ar.dtype, cp.device
    gram = torch.zeros((s.n_targets, k, k), dtype=dt, device=dev)
    rhs = torch.zeros((s.n_targets, k), dtype=dt, device=dev)
    n_chunks = s.chunk_target.shape[0]
    for c0 in range(0, n_chunks, block):
        c1 = min(c0 + block, n_chunks)
        r0, r1 = (int(i) for i in torch.searchsorted(
            s.chunk, torch.tensor([c0, c1], device=dev)))
        x = torch.zeros((c1 - c0, CHUNK, k), dtype=dt, device=dev)
        r = torch.zeros((c1 - c0, CHUNK, 1), dtype=dt, device=dev)
        at = (s.chunk[r0:r1] - c0, s.slot[r0:r1])
        x[at] = ar.operand(cp[s.source[r0:r1]])
        r[at] = ar.operand(s.vals[r0:r1])[:, None]
        xt = x.mT
        ids, counts = torch.unique_consecutive(s.chunk_target[c0:c1], return_counts=True)
        gram[ids] += torch.segment_reduce(xt @ x, "sum", lengths=counts, axis=0)
        rhs[ids] += torch.segment_reduce((xt @ r)[..., 0], "sum", lengths=counts, axis=0)
    return gram, rhs


def draw_side(cp: torch.Tensor, s: Side, mu: torch.Tensor, lam: torch.Tensor,
              z: torch.Tensor, alpha: float, ar: Arith, block: int = 1 << 15
              ) -> torch.Tensor:
    """Every target's factor drawn from its conditional posterior. A system
    that is not positive definite gives a row of NaN."""
    gram, rhs = statistics(cp, s, ar)
    prior_rhs = ar.mm(lam, mu[:, None])[:, 0]
    out = torch.empty((s.n_targets, lam.shape[0]), dtype=ar.dtype, device=cp.device)
    for j in range(0, s.n_targets, block):
        prec = lam + alpha * gram[j:j + block]
        b = prior_rhs + alpha * rhs[j:j + block]
        chol, info = torch.linalg.cholesky_ex(prec)
        y = torch.linalg.solve_triangular(chol, b[..., None], upper=False)
        x = torch.linalg.solve_triangular(chol.mT, y + ar.cast(z[j:j + block])[..., None],
                                          upper=True)[..., 0]
        x[info != 0] = float("nan")
        out[j:j + block] = x
    return out


def sweep(st: State, items: Side, users: Side, test_rows: torch.Tensor,
          test_cols: torch.Tensor, noise: tuple[Noise, Noise], prior: Prior,
          alpha: float, burn_in: int, global_mean: float, ar: Arith) -> State:
    """One Gibbs sweep: items, then users, then the prediction."""
    n_items, n_users = noise
    mu_v, lam_v = normal_wishart(st.v, prior, n_items, ar)
    v = draw_side(st.u, items, mu_v, lam_v, n_items.z, alpha, ar)
    mu_u, lam_u = normal_wishart(st.u, prior, n_users, ar)
    u = draw_side(v, users, mu_u, lam_u, n_users.z, alpha, ar)
    pred_sum, count = st.pred_sum, st.pred_count
    if st.step >= burn_in:
        pred_sum = pred_sum + (u[test_rows] * v[test_cols]).sum(-1) + global_mean
        count += 1
    return State(u, v, mu_u, lam_u, mu_v, lam_v, st.step + 1, pred_sum, count)
