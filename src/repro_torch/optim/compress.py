"""int8 gradient compression with error feedback, ported from
`repro/optim/compress.py`.

Each gradient is quantised to int8 against a per-tensor scale before it is
summed over shards, and the quantisation residual is carried in an
error-feedback buffer, so the scheme is unbiased over time. The JAX
package sums over a mesh axis inside shard_map (`psum`, `pmax`); here the
P shards' gradient trees are held in one process, as the distributed
sampler holds its shards (`core/distributed.py`), and `compressed_psum`
takes them as a list. A tree is a dict of tensors by name, as
`named_parameters()` gives it. Rounding is half to even (`torch.round`, as
`jnp.round`); every operation is JAX's, in fp32, so the results are its
bits.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import nn

Tree = dict[str, torch.Tensor]


class CompressState(NamedTuple):
    error: Tree  # residuals, by the gradients' names, fp32


def compress_init(params: nn.Module | Tree) -> CompressState:
    """Zero residuals shaped as the parameters, fp32, on their devices."""
    items = params.named_parameters() if isinstance(params, nn.Module) else params.items()
    return CompressState(error={n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                                for n, p in items})


def _scale(gf: torch.Tensor) -> torch.Tensor:
    """max(max |gf|, 1e-12) / 127 as a 0-d fp32 tensor."""
    return gf.abs().max().clamp(min=1e-12) / 127.0


def _quantise(gf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.round(gf / scale).clamp(-127, 127).to(torch.int8)


def int8_compress(g: torch.Tensor, error: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(q int8, scale 0-d fp32, new error) of g plus the carried error."""
    gf = g.float() + error
    scale = _scale(gf)
    q = _quantise(gf, scale)
    return q, scale, gf - int8_decompress(q, scale)


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(grads: Sequence[Tree], states: Sequence[CompressState]
                    ) -> tuple[list[Tree], list[CompressState]]:
    """The sum over P shards of their gradient trees, in int8 with error
    feedback: (each shard's copy of the sum, each shard's new state).

    For each tensor, the shared scale is the max over the shards' scales
    (integer payloads sum correctly only under one scale), each shard
    quantises its gradient plus its carried error with it, the int8
    payloads are summed in int32 on the first shard's device in shard
    order (exact), and each shard's residual against the shared-scale
    dequantisation is its new error. The sum goes back to every shard's
    device, as an all-reduce leaves it."""
    if len(grads) != len(states) or not grads:
        raise ValueError(f"{len(grads)} gradient trees and {len(states)} states")
    names = list(grads[0])
    for p, (g, st) in enumerate(zip(grads, states)):
        if list(g) != names or set(st.error) != set(names):
            raise ValueError(f"shard {p}'s gradients or errors are not named as shard 0's")
    home = grads[0][names[0]].device
    sums: Tree = {}
    errors: list[Tree] = [{} for _ in grads]
    for name in names:
        gfs = [g[name].float() + st.error[name] for g, st in zip(grads, states)]
        scale = torch.stack([_scale(gf).to(home) for gf in gfs]).max()
        total = torch.zeros(gfs[0].shape, dtype=torch.int32, device=home)
        for p, gf in enumerate(gfs):
            q = _quantise(gf, scale.to(gf.device))
            errors[p][name] = gf - int8_decompress(q, scale.to(gf.device))
            total += q.to(home, torch.int32)
        sums[name] = total.float() * scale
    out = [{n: t.to(g[n].device) for n, t in sums.items()} for g in grads]
    return out, [CompressState(error=e) for e in errors]
