"""AdamW with global-norm clipping, a copy of `repro/optim/adamw.py`.

The JAX package updates a parameter pytree whose layers are stacked on a
leading n_layers axis; the port updates a model's named parameters, one
tensor a layer, in `named_parameters()` order. Two things follow:

  * weight decay applies to a leaf of rank 2 or more in JAX. A per-layer
    tensor of the port is one slice of a stacked JAX leaf, so its JAX rank
    is its own plus the axes it is stacked on (`jax_rank`): one for a
    decoder's `layers`, whisper's `enc_layers` and `dec_layers` and the
    xLSTM's `slstm`, two for the xLSTM's `mlstm` and Zamba2's `mamba`,
    none for Zamba2's one `shared` block. So the per-layer norm scales,
    biases and gates are decayed, as they are in JAX, and only the
    unstacked 1-D leaves (the final norms' scales, the shared block's
    norms) are not;
  * the moments and parameters are updated in place, one leaf at a time
    and in slices of at most UPDATE_SLICE elements, in fp32 with each
    result cast back to its tensor's dtype, as JAX computes it. An
    out-of-place update of gemma2-2b's 590 M-entry embedding would make
    several fp32 temporaries of 2.4 GB.

Moments are stored in `moment_dtype` (fp32 by default).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, NamedTuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.launch.cost import steps
from repro_torch.models.transformer import param_leaf

#: entries of one leaf updated at a time: bounds the fp32 temporaries
UPDATE_SLICE = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: torch.dtype = torch.float32


class AdamWState(NamedTuple):
    m: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]
    step: torch.Tensor               # 0-d int32, on the CPU


def jax_rank(name: str, p: torch.Tensor) -> int:
    """The rank of the JAX leaf that parameter `name` is (a slice of): its
    own rank plus one for each integer part of its name, each of which
    indexes a stacked axis of the JAX leaf (`param_leaf`'s rule):
    "layers.3.attn.bq" is a (L, H hd) leaf, "mlstm.1.4.b_if" a (G, n_m, 2H)
    one, "shared.ln_attn.scale" a (d,) one."""
    return p.dim() + sum(part.isdigit() for part in name.split("."))


def _named(params: nn.Module | Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def adamw_init(params: nn.Module | Mapping[str, torch.Tensor], cfg: AdamWConfig
               ) -> AdamWState:
    named = _named(params)
    return AdamWState(
        m={n: torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
           for n, p in named.items()},
        v={n: torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
           for n, p in named.items()},
        step=torch.zeros((), dtype=torch.int32),
    )


def _moment_tensor(a: Any) -> torch.Tensor:
    """A JAX moment leaf as a tensor of its own dtype (bf16 by its bits)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":                  # ml_dtypes
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def opt_state_from_numpy(state: Any, params: nn.Module) -> AdamWState:
    """The JAX package's AdamWState (`m` and `v` trees shaped as the
    parameter tree, layers stacked; `step`) as an AdamWState for `params`,
    leaf by leaf by the paths `params_from_numpy` takes, each moment in its
    own dtype, on its parameter's device."""
    moments = ({}, {})
    for name, p in params.named_parameters():
        for tree, out in zip((state.m, state.v), moments):
            value = _moment_tensor(param_leaf(tree, name)[1])
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"{name}: moment has {tuple(value.shape)}, the "
                                 f"parameter {tuple(p.shape)}")
            out[name] = value.to(device=p.device)
    return AdamWState(m=moments[0], v=moments[1],
                      step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32))


def global_norm(grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves, in order, of each leaf's fp32 sum of
    squares: a 0-d fp32 tensor on the leaves' device."""
    total = None
    for g in grads.values():
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _clip_scale(grads: Mapping[str, torch.Tensor], max_norm: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(min(1, max_norm / max(norm, 1e-9)), norm): 0-d fp32 tensors."""
    gnorm = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0), gnorm


def _clipped(g: torch.Tensor, scale: torch.Tensor | None) -> torch.Tensor:
    """g * scale in fp32, rounded to g's dtype, as fp32: JAX's
    `(g.astype(f32) * scale).astype(g.dtype)`. A bf16 `g.mul_(scale)`
    would round the scale to bf16 first on the card."""
    gf = g.float()
    return gf if scale is None else (gf * scale).to(g.dtype).float()


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float
                        ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """Scale every gradient by min(1, max_norm / max(norm, 1e-9)), in place
    (computed in fp32, cast back to the gradient's dtype); returns the
    gradients and the norm before clipping."""
    scale, gnorm = _clip_scale(grads, max_norm)
    for g in grads.values():
        g.copy_(g.float() * scale)
    return dict(grads), gnorm


def adamw_update(grads: Mapping[str, torch.Tensor], state: AdamWState,
                 params: nn.Module | Mapping[str, torch.Tensor], cfg: AdamWConfig,
                 lr: torch.Tensor | float | None = None
                 ) -> tuple[dict[str, torch.Tensor], AdamWState, dict]:
    """One AdamW step over `params`, in place: returns (params, new state,
    {"grad_norm": the norm before clipping}). When cfg.clip_norm > 0 each
    slice's gradient is clipped as it is read (the gradients themselves are
    left as they are). `lr` may be a 0-d tensor (the schedule's) or a
    number; cfg.lr when None. Parameters that are DTensors (a train state
    on a mesh) update shard by shard: each gradient placed as its
    parameter, then the update on the local shards, the moments sharded as
    their parameters; the norm of the clipping is the global one."""
    named = _named(params)
    grads = {n: grads[n] for n in named}
    if cfg.clip_norm > 0:
        scale, gnorm = _clip_scale(grads, cfg.clip_norm)
    else:
        scale, gnorm = None, torch.zeros(())
    step = state.step + 1
    lr = torch.as_tensor(cfg.lr if lr is None else lr, dtype=torch.float32).cpu()
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.tensor(cfg.b1, dtype=torch.float32) ** stepf
    b2c = 1.0 - torch.tensor(cfg.b2, dtype=torch.float32) ** stepf
    if isinstance(scale, DTensor):
        scale = scale.to_local()
    with torch.no_grad():
        for name, p in named.items():
            decay = cfg.weight_decay > 0 and jax_rank(name, p) >= 2
            g, m, v, w = grads[name], state.m[name], state.v[name], p
            if isinstance(p, DTensor):
                if tuple(g.placements) != tuple(p.placements):
                    g = g.redistribute(p.device_mesh, p.placements)
                g, m, v, w = (t.to_local() for t in (g, m, v, p))
            flat = [g.reshape(-1)] + [t.view(-1) for t in (m, v, w)]
            parts = [t.split(UPDATE_SLICE) for t in flat]
            for i in steps(len(parts[0])):
                _update_slice(*(part[i] for part in parts), cfg, lr, b1c, b2c, decay, scale)
    return named, AdamWState(m=state.m, v=state.v, step=step), {"grad_norm": gnorm}


def _update_slice(g, m, v, p, cfg: AdamWConfig, lr, b1c, b2c, decay: bool,
                  scale: torch.Tensor | None) -> None:
    """The JAX update of one slice, each step rounded to fp32 as there
    (g clipped by `scale` first, see `_clipped`):

        m = b1 m + (1 - b1) g        v = b2 v + (1 - b2) g g
        delta = (m / b1c) / (sqrt(v / b2c) + eps) [+ wd p]
        p = p - lr delta
    """
    gf = _clipped(g, scale)
    mf = m.float() * cfg.b1 + (1 - cfg.b1) * gf
    vf = v.float() * cfg.b2 + (1 - cfg.b2) * gf * gf
    m.copy_(mf)
    v.copy_(vf)
    delta = mf.div_(b1c).div_(vf.div_(b2c).sqrt_().add_(cfg.eps))
    del vf
    pf = p.float()
    if decay:
        delta.add_(cfg.weight_decay * pf)
    p.copy_(pf.sub_(lr * delta))
