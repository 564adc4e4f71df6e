"""The ranks of tests/test_torch_mesh.py: four CPU processes on a gloo
process group, the port's mesh paths against its mesh-free ones.

    python tests/torch_mesh_ranks.py DIR

reads DIR/inputs.npz (written by the test) and has rank 0 write
DIR/ranks.npz:

  - a reduced gemma2-2b train step in fp32 on a (2, 2) ("data", "model")
    mesh (`launch.train.shard_state`) and without a mesh, from the inputs'
    parameters and batch: loss, grad_norm and lr, the gradients before the
    step and the parameters after it, each gathered whole;
  - elastic restore: a reduced gemma2-2b state (bf16 parameters) placed on
    the (2, 2) mesh, gathered into a CheckpointStore by rank 0, restored
    onto a (4, 1) mesh (`checkpoint.elastic.restore_resharded`); whether
    every tensor came back with its bits;
  - the MoE's expert-parallel region (reduced granite-moe-3b-a800m, opt,
    fp32) at model = 2 and the mesh-free grouped dispatch on the inputs'
    tokens and weights: outputs and aux losses;
  - a reduced gemma2-2b prefill of 16 tokens and 3 decode steps with the
    K/V cache sharded on its sequence over "model" (the split softmax) and
    without a mesh: every step's logits;
  - decode on the mesh for the reduced gemma2-2b, xlstm-350m, zamba2-7b
    and whisper-medium in fp32 from the inputs' parameters, at B = 4 (the
    batch over "data", recurrent states over "model") and B = 1 (the K/V
    sequence over ("data", "model"), the states on a head dim or a
    stacked axis): a prefill of 16 tokens and 3 steps on the mesh and
    without it, every step's logits and the final caches (gathered whole
    on the mesh); one step on the mesh from the zeros of `init_cache` (the
    plant: a step that does not read its states); and the placements of
    the states the steps took.
"""
import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

N_RANKS = 4


def _tree(flat: dict, prefix: str) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        if key.startswith(prefix):
            node = tree
            *path, leaf = key[len(prefix):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = val
    return tree


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _fp32(cfg):
    return dataclasses.replace(cfg, dtype=torch.float32, param_dtype=torch.float32)


def _step(inputs: dict, mesh, res: dict) -> None:
    from repro_torch.configs import REGISTRY, reduced
    from repro_torch.launch.train import TrainState, make_train_step, shard_batch, shard_state
    from repro_torch.models import api
    from repro_torch.models.layers import active_mesh
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = _fp32(reduced(REGISTRY["gemma2-2b"]))
    opt = AdamWConfig(lr=1e-3)
    batch = {"tokens": torch.from_numpy(inputs["tokens"]),
             "labels": torch.from_numpy(inputs["labels"])}
    model = api.build_model(cfg, device="cpu")

    def state():
        params = api.params_from_numpy(_tree(inputs, "gemma/"), cfg, device="cpu")
        return TrainState(params=params, opt=adamw_init(params, opt),
                          step=torch.zeros((), dtype=torch.int32))

    plain, placed = state(), state()
    placed = shard_state(cfg, placed, mesh)
    shape = api.ShapeSpec("mesh_test", batch["tokens"].shape[1], batch["tokens"].shape[0],
                          "train")
    dbatch = shard_batch(batch, api.input_pspecs(cfg, shape, mesh), mesh)
    # the gradients, then the step
    model.loss_fn(plain.params, batch)[0].backward()
    with active_mesh(mesh):
        model.loss_fn(placed.params, dbatch)[0].backward()
    for (n, p), (_, q) in zip(plain.params.named_parameters(), placed.params.named_parameters()):
        res[f"grad_free/{n}"] = p.grad.numpy().copy()
        res[f"grad_mesh/{n}"] = _whole(q.grad).numpy().copy()
        p.grad = q.grad = None
    step = make_train_step(cfg, opt, total_steps=20, device="cpu")
    plain, m_free = step(plain, batch)
    placed, m_mesh = step(placed, dbatch)
    for key in ("loss", "grad_norm", "lr"):
        res[f"free/{key}"] = np.asarray(float(_whole(m_free[key])))
        res[f"mesh/{key}"] = np.asarray(float(_whole(m_mesh[key])))
    for (n, p), (_, q) in zip(plain.params.named_parameters(), placed.params.named_parameters()):
        res[f"param_free/{n}"] = p.detach().numpy().copy()
        res[f"param_mesh/{n}"] = _whole(q.detach()).numpy().copy()


def _restore(out: Path, mesh, res: dict) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.checkpoint.elastic import restore_resharded
    from repro_torch.configs import REGISTRY, reduced
    from repro_torch.launch.train import adamw_config, init_train_state, shard_state, \
        train_state_shapes
    from repro_torch.models import api
    from repro_torch.runtime.trainer import state_arrays, state_tensors

    cfg = reduced(REGISTRY["gemma2-2b"])                 # bf16 parameters
    opt = adamw_config(cfg)
    state = init_train_state(cfg, 3, opt, device="cpu")
    with torch.no_grad():
        for t in state.opt.m.values():
            t.normal_(generator=torch.Generator().manual_seed(5))
    state = shard_state(cfg, state, mesh)
    arrays = state_arrays(state)
    store = CheckpointStore(out / "ckpt", keep=1)
    if dist.get_rank() == 0:
        store.save(7, arrays)
    dist.barrier()
    mesh41 = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
    like = train_state_shapes(cfg, opt)
    got = restore_resharded(store, like, api.train_state_pspecs(cfg, like, mesh41), mesh41)
    before, after = state_tensors(state), state_tensors(got)
    same = True
    for name, t in before.items():
        a, b = _whole(t).detach(), _whole(after[name]).detach()
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        same &= a.dtype == b.dtype and torch.equal(a, b)
    placed41 = all(tuple(p.device_mesh.mesh.shape) == (4, 1) for p in got.params.parameters())
    res["restore/bitwise"] = np.asarray(bool(same))
    res["restore/on_4x1"] = np.asarray(bool(placed41))


def _ep(inputs: dict, mesh, res: dict) -> None:
    from torch import nn

    from repro_torch.configs import REGISTRY, apply_variant, reduced
    from repro_torch.launch.train import shard_module, shardings_of
    from repro_torch.models import api
    from repro_torch.models.layers import MoE, active_mesh, distribute, moe_block, \
        partial_placements, region, replicated

    cfg = _fp32(apply_variant(reduced(REGISTRY["granite-moe-3b-a800m"]), "opt"))

    def holder():
        h = nn.Module()
        h.moe = MoE(cfg, generator=None, device=torch.device("cpu"))
        with torch.no_grad():
            for k in ("router", "w_gate", "w_up", "w_down"):
                getattr(h.moe, k).copy_(torch.from_numpy(inputs[f"moe/{k}"]))
        return h

    x = torch.from_numpy(inputs["moe_x"])
    ref = holder()
    with torch.no_grad():
        out, aux = moe_block(ref.moe, x, cfg)
    res["ep/grouped_out"], res["ep/grouped_aux"] = out.numpy(), np.asarray(float(aux))
    placed = holder()
    shard_module(placed, shardings_of(api.param_pspecs(cfg, placed, mesh), mesh), mesh)
    with torch.no_grad(), active_mesh(mesh):
        dx = distribute(x, ("data", "model", None))
        y, a = region(lambda blk, xx: moe_block(blk.moe, xx, cfg), placed, (dx,),
                      (tuple(dx.placements), partial_placements()))
        res["ep/mesh_out"] = _whole(y).numpy()
        res["ep/mesh_aux"] = np.asarray(float(_whole(replicated(a))))
        res["ep/experts_sharded"] = np.asarray(
            placed.moe.w_gate.to_local().shape[0] * 2 == cfg.n_experts_pad)


def _decode(inputs: dict, mesh, res: dict) -> None:
    from repro_torch.configs import REGISTRY, reduced
    from repro_torch.models import api
    from repro_torch.models.layers import active_mesh, distribute

    cfg = _fp32(reduced(REGISTRY["gemma2-2b"]))
    model = api.build_model(cfg, device="cpu")
    params = api.params_from_numpy(_tree(inputs, "gemma/"), cfg, device="cpu")
    prompt = torch.from_numpy(inputs["tokens"][:2, :16])
    nxt = torch.from_numpy(inputs["tokens"][:2, 16:19])
    out = model.prefill_fn(params, {"tokens": prompt})
    logits, cache = [out["logits"]], out["cache"]
    for i in range(3):
        cache, lg = model.decode_fn(params, cache, {"tokens": nxt[:, i:i + 1]})
        logits.append(lg)
    res["decode/free"] = torch.stack(logits).numpy()
    from repro_torch.launch.train import shard_module, shardings_of

    shard_module(params, shardings_of(api.param_pspecs(cfg, params, mesh), mesh), mesh)
    with active_mesh(mesh):
        out = model.prefill_fn(params, {"tokens": distribute(prompt, (("data",), "model"))})
        logits, cache = [out["logits"]], out["cache"]
        sharded = cache["k"].to_local().shape[2] * 2 == cache["k"].shape[2]
        for i in range(3):
            cache, lg = model.decode_fn(params, cache,
                                        {"tokens": distribute(nxt[:, i:i + 1], (("data",), None))})
            logits.append(lg)
        res["decode/mesh"] = torch.stack([_whole(t) for t in logits]).numpy()
    res["decode/cache_sharded"] = np.asarray(bool(sharded))


DECODE_ARCHS = ("gemma2-2b", "xlstm-350m", "zamba2-7b", "whisper-medium")
#: reduced configs whose B = 1 states shard as the full-width long_500k
#: cell's do: one xLSTM head (C and n on dk, m whole, the sLSTM on hd),
#: one group of three Mamba2 layers (heads, and the conv's channels)
DECODE_VARIANTS = {"xlstm-350m.h1": ("xlstm-350m", {"n_heads": 1, "n_kv_heads": 1}),
                   "zamba2-7b.g3": ("zamba2-7b", {"n_layers": 3, "attn_every": 3})}


def decode_cases():
    """(name, config, batches) of the decode runs."""
    from repro_torch.configs import REGISTRY, reduced

    cases = [(a, _fp32(reduced(REGISTRY[a])), (4, 1)) for a in DECODE_ARCHS]
    return cases + [(n, dataclasses.replace(_fp32(reduced(REGISTRY[a])), **ch), (1,))
                    for n, (a, ch) in DECODE_VARIANTS.items()]


def _decode_families(inputs: dict, mesh, res: dict) -> None:
    from repro_torch.launch.train import shard_module, shardings_of
    from repro_torch.models import api
    from repro_torch.models.layers import active_mesh, distribute, spec_placements

    for arch, cfg, batches in decode_cases():
        model = api.build_model(cfg, device="cpu")
        for b in batches:
            toks = torch.from_numpy(inputs[f"dec/{arch}/tokens"][:b].astype(np.int64))
            batch = {"tokens": toks[:, :16]}
            if cfg.family == "audio":
                batch["frames"] = torch.from_numpy(inputs[f"dec/{arch}/frames"][:b])
            params = api.params_from_numpy(_tree(inputs, f"{arch}/"), cfg, device="cpu")
            out = model.prefill_fn(params, batch)
            logits, cache = [out["logits"]], out["cache"]
            for i in range(3):
                cache, lg = model.decode_fn(params, cache, {"tokens": toks[:, 16 + i:17 + i]})
                logits.append(lg)
            key = f"family/{arch}/{b}"
            res[f"{key}/free"] = torch.stack(logits).numpy()
            free_cache = dict(_named(cache))
            shard_module(params, shardings_of(api.param_pspecs(cfg, params, mesh), mesh), mesh)
            prefill = api.ShapeSpec("mesh_test", 16, b, "prefill")
            step = api.ShapeSpec("mesh_test", 16, b, "decode")
            with active_mesh(mesh):
                ips = api.input_pspecs(cfg, prefill, mesh)
                out = model.prefill_fn(params, {k: distribute(v, ips[k]) for k, v in batch.items()})
                logits, cache = [_whole(out["logits"])], out["cache"]
                placed = {k: str(tuple(v.placements)) for k, v in _named(cache)}
                specs = dict(_named(api.cache_pspecs(cfg, api.ShapeSpec("c", 80, b, "decode"),
                                                     mesh), cache))
                res[f"{key}/as_specs"] = np.asarray(all(
                    tuple(v.placements) == spec_placements(specs[k], mesh)
                    for k, v in _named(cache)))
                dspec = api.input_pspecs(cfg, step, mesh)["tokens"]
                for i in range(3):
                    cache, lg = model.decode_fn(params, cache,
                                                {"tokens": distribute(toks[:, 16 + i:17 + i], dspec)})
                    logits.append(_whole(lg))
                res[f"{key}/mesh"] = torch.stack(logits).numpy()
                # the final cache gathered whole against the mesh-free one:
                # each shard holds its own slots and states
                res[f"{key}/cache_err"] = np.asarray(max(
                    float((_whole(v).float() - free_cache[k].float()).abs().max())
                    for k, v in _named(cache)))
                zeros = model.init_cache(b, 16 + 64)       # the prefill's rows, its headroom 64
                _, lg = model.decode_fn(params, zeros, {"tokens": distribute(toks[:, 16:17], dspec)})
                res[f"{key}/zero"] = _whole(lg).numpy()
            res[f"{key}/placements"] = np.asarray(json.dumps(placed))


def _named(tree, like=None, prefix=""):
    """(path, leaf) of a cache, or of a tree shaped as the cache `like` (its
    specs, each a tuple itself): the cache's dicts and tuples."""
    like = tree if like is None else like
    if isinstance(like, dict):
        for k in like:
            yield from _named(tree[k], like[k], f"{prefix}{k}/")
    elif isinstance(like, (tuple, list)):
        for i, sub in enumerate(like):
            yield from _named(tree[i], sub, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def rank_main(rank: int, out: str) -> None:
    torch.set_num_threads(1)
    out = Path(out)
    dist.init_process_group("gloo", init_method=f"file://{out / 'pg'}", rank=rank,
                            world_size=N_RANKS)
    from torch.distributed.device_mesh import init_device_mesh

    inputs = dict(np.load(out / "inputs.npz"))
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    res: dict = {}
    _step(inputs, mesh, res)
    _restore(out, mesh, res)
    _ep(inputs, mesh, res)
    _decode(inputs, mesh, res)
    with torch.no_grad():
        _decode_families(inputs, mesh, res)
    if rank == 0:
        np.savez(out / "ranks.npz", **res)
    dist.barrier()
    dist.destroy_process_group()


def main() -> None:
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    mp.spawn(rank_main, args=(sys.argv[1],), nprocs=N_RANKS)


if __name__ == "__main__":
    main()
