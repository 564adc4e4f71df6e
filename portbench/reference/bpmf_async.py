"""The plain asynchronous distributed BPMF sweep, from the raw ratings.

arXiv:1705.10633 Sec 4 runs BPMF over P nodes whose item and user updates
share one ring of one-sided exchanges: the user half-sweep does not wait
for the item half-sweep's new factors, it conditions on the item factors
of the previous sweep (stale by exactly one draw). Where the shards sit
and how the blocks travel do not change what a sweep computes, so the
reference is the whole-matrix sweep in that order. From the state (U, V)
and the sweep's noise:

  items:  (mu_V, Lambda_V) ~ NW posterior given the old V;
          every v_j drawn from its conditional given the OLD U;
  users:  (mu_U, Lambda_U) ~ NW posterior given the old U;
          every u_i drawn from its conditional given the OLD V;

each side exactly as Algorithm 1 draws it (`reference/bpmf.py`: `side`,
`normal_wishart`, `draw_side`, whose noise and prior it takes). The
sweep's new V is the fresh draw the next sweep reads. Products are IEEE
(TF32 off on the card); the precision is an `Arith`'s.

Imports nothing of the program.
"""
from __future__ import annotations

from portbench.reference import bpmf
from portbench.reference.arith import Arith, no_tf32


def sweep(st: bpmf.State, items: bpmf.Side, users: bpmf.Side,
          noise: tuple[bpmf.Noise, bpmf.Noise], prior: bpmf.Prior, alpha: float,
          ar: Arith) -> bpmf.State:
    """One asynchronous sweep: both hyper draws and both half-sweeps read
    the state's factors. The prediction sum is not kept (the distributed
    sweep makes none)."""
    n_items, n_users = noise
    with no_tf32():
        mu_v, lam_v = bpmf.normal_wishart(st.v, prior, n_items, ar)
        mu_u, lam_u = bpmf.normal_wishart(st.u, prior, n_users, ar)
        v = bpmf.draw_side(st.u, items, mu_v, lam_v, n_items.z, alpha, ar)
        u = bpmf.draw_side(st.v, users, mu_u, lam_u, n_users.z, alpha, ar)
    return st._replace(u=u, v=v, mu_u=mu_u, lam_u=lam_u, mu_v=mu_v, lam_v=lam_v,
                       step=st.step + 1)
