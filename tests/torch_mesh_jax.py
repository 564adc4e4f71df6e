"""The JAX side of tests/test_torch_mesh.py, run in its own process: the
JAX package on 8 forced CPU devices (XLA_FLAGS set before JAX starts).

    python tests/torch_mesh_jax.py DIR

reads DIR/inputs.npz (written by the test) and writes into DIR:

  - cells.json: the reduced smollm-360m and granite-moe-3b-a800m train
    cells (base, B = 8, S = 64) compiled on a (2, 4) mesh: per-device
    argument bytes, `HloCostModel` flops and collective bytes and counts;
  - step.npz: one jitted train step of the reduced gemma2-2b in fp32 on a
    (2, 2) mesh from the inputs' parameters and batch: loss, grad_norm,
    lr and the new parameters by the port's names;
  - ep.npz: `_moe_ep_shard_map` of the reduced granite-moe-3b-a800m (opt,
    fp32) on a (2, 2) mesh on the inputs' tokens and MoE weights;
  - decode_cells.json: the reduced xlstm-350m, zamba2-7b and whisper-medium
    decode cells (S = 64, B = 8 and B = 1) compiled on a (2, 4) mesh:
    per-device argument bytes;
  - decode.npz: the reduced gemma2-2b, xlstm-350m, zamba2-7b and
    whisper-medium in fp32 from the inputs' parameters, at B = 4 and B = 1
    (and two variants at B = 1, `DECODE_VARIANTS`):
    a prefill of 16 tokens, then 3 steps of the jitted `decode_fn` on a
    (2, 2) mesh with the cache placed by `cache_pspecs` and the tokens by
    `input_pspecs`: the prefill's and each step's logits.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from repro.configs import REGISTRY, reduced  # noqa: E402
from repro.configs.variants import apply_variant  # noqa: E402
from repro.launch import dryrun as jdry  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.launch.hlo_analysis import HloCostModel  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models.layers import _moe_ep_shard_map  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402


def unflatten(flat: dict, prefix: str) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        if not key.startswith(prefix):
            continue
        node = tree
        *path, leaf = key[len(prefix):].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(val)
    return tree


def flat_port(tree, prefix=""):
    """{port name: array} of a JAX tree, the stacked layers split."""
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(flat_port(val, name + "/"))
        else:
            out[name] = np.asarray(val)
    return out


def _mesh22():
    """A (2, 2) mesh of Auto axes: GSPMD partitions the step, as it does
    the dry-run's cells (arrays placed on Explicit axes would carry their
    shardings into the types, where the embedding's gather has none)."""
    auto = (jax.sharding.AxisType.Auto,) * 2
    return jax.make_mesh((2, 2), ("data", "model"), auto, devices=jax.devices()[:4])


def cells(out: Path) -> None:
    shape = japi.ShapeSpec("mesh_test", 64, 8, "train")
    rec = {}
    for arch in ("smollm-360m", "granite-moe-3b-a800m"):
        cfg = reduced(REGISTRY[arch])
        mesh = jax.make_mesh((2, 4), ("data", "model"), devices=jax.devices()[:8])
        compiled = jdry.lower_cell(cfg, shape, mesh).compile()
        cost = HloCostModel(compiled.as_text()).analyze()
        rec[arch] = dict(argument_bytes=int(compiled.memory_analysis().argument_size_in_bytes),
                         flops=float(cost["flops"]),
                         collective_bytes=cost["collective_bytes"],
                         collective_counts=cost["collective_counts"])
    (out / "cells.json").write_text(json.dumps(rec, indent=1))


def step(inputs: dict, out: Path) -> None:
    cfg = dataclasses.replace(reduced(REGISTRY["gemma2-2b"]), dtype=jnp.float32,
                              param_dtype=jnp.float32)
    params = unflatten(inputs, "gemma/")
    opt = jadamw.AdamWConfig(lr=1e-3)
    state = jtrain.TrainState(params=params, opt=jadamw.adamw_init(params, opt),
                              step=jnp.zeros((), jnp.int32))
    batch = {"tokens": jnp.asarray(inputs["tokens"]), "labels": jnp.asarray(inputs["labels"])}
    mesh = _mesh22()
    state_sh = jtrain.shardings_of(
        japi.train_state_pspecs(cfg, jax.eval_shape(lambda: state), mesh), mesh)
    shape = japi.ShapeSpec("mesh_test", batch["tokens"].shape[1], batch["tokens"].shape[0],
                           "train")
    ips = japi.input_pspecs(cfg, shape, mesh)
    batch_sh = {k: NamedSharding(mesh, ips[k]) for k in batch}
    jitted = jax.jit(jtrain.make_train_step(cfg, opt, total_steps=20),
                     in_shardings=(state_sh, batch_sh), out_shardings=(state_sh, None))
    with mesh:
        new, metrics = jitted(jax.device_put(state, state_sh), jax.device_put(batch, batch_sh))
    res = {f"param/{k}": v for k, v in flat_port(jax.device_get(new.params)).items()}
    res.update({k: np.asarray(metrics[k]) for k in ("loss", "grad_norm", "lr")})
    np.savez(out / "step.npz", **res)


def ep(inputs: dict, out: Path) -> None:
    cfg = dataclasses.replace(apply_variant(reduced(REGISTRY["granite-moe-3b-a800m"]), "opt"),
                              dtype=jnp.float32, param_dtype=jnp.float32)
    params = {k: jnp.asarray(inputs[f"moe/{k}"]) for k in ("router", "w_gate", "w_up", "w_down")}
    x = jnp.asarray(inputs["moe_x"])
    mesh = _mesh22()
    fn = jax.jit(lambda p, xx: _moe_ep_shard_map(p, xx, cfg, mesh))
    with mesh:
        y, aux = fn(params, x)
    np.savez(out / "ep.npz", out=np.asarray(y), aux=np.asarray(aux))


#: the configs whose decode on a mesh the test holds to the JAX package's,
#: and reduced variants (B = 1 only) whose states shard as the full-width
#: long_500k cell's (tests/torch_mesh_ranks.py)
DECODE_ARCHS = ("gemma2-2b", "xlstm-350m", "zamba2-7b", "whisper-medium")
DECODE_VARIANTS = {"xlstm-350m.h1": ("xlstm-350m", {"n_heads": 1, "n_kv_heads": 1}),
                   "zamba2-7b.g3": ("zamba2-7b", {"n_layers": 3, "attn_every": 3})}


def decode_cases():
    def fp32(arch, **changes):
        return dataclasses.replace(reduced(REGISTRY[arch]), dtype=jnp.float32,
                                   param_dtype=jnp.float32, **changes)

    return [(a, fp32(a), (4, 1)) for a in DECODE_ARCHS] + [
        (n, fp32(a, **ch), (1,)) for n, (a, ch) in DECODE_VARIANTS.items()]


def decode_cells(out: Path) -> None:
    mesh = jax.make_mesh((2, 4), ("data", "model"), devices=jax.devices()[:8])
    rec = {}
    for arch in DECODE_ARCHS[1:]:
        cfg = reduced(REGISTRY[arch])
        for b in (8, 1):
            shape = japi.ShapeSpec("mesh_test", 64, b, "decode")
            compiled = jdry.lower_cell(cfg, shape, mesh).compile()
            rec[f"{arch}/{b}"] = int(compiled.memory_analysis().argument_size_in_bytes)
    (out / "decode_cells.json").write_text(json.dumps(rec, indent=1))


def decode(inputs: dict, out: Path) -> None:
    mesh = _mesh22()
    res = {}
    for arch, cfg, batches in decode_cases():
        model = japi.build_model(cfg)
        params = unflatten(inputs, f"{arch}/")
        params_sh = jtrain.shardings_of(japi.param_pspecs(cfg, params, mesh), mesh)
        for b in batches:
            toks = inputs[f"dec/{arch}/tokens"][:b]
            batch = {"tokens": jnp.asarray(toks[:, :16])}
            if cfg.family == "audio":
                batch["frames"] = jnp.asarray(inputs[f"dec/{arch}/frames"][:b])
            pre = jax.jit(model.prefill_fn)(params, batch)
            shape = japi.ShapeSpec("mesh_test", 16 + 64, b, "decode")
            cache_sh = jtrain.shardings_of(japi.cache_pspecs(cfg, shape, mesh), mesh)
            tok_sh = NamedSharding(mesh, japi.input_pspecs(cfg, shape, mesh)["tokens"])
            fn = jax.jit(model.decode_fn, in_shardings=(params_sh, cache_sh, {"tokens": tok_sh}),
                         out_shardings=(cache_sh, None))
            logits = [np.asarray(pre["logits"])]
            with mesh:
                p = jax.device_put(params, params_sh)
                cache = jax.device_put(pre["cache"], cache_sh)
                for i in range(3):
                    t = jax.device_put(jnp.asarray(toks[:, 16 + i:17 + i]), tok_sh)
                    cache, lg = fn(p, cache, {"tokens": t})
                    logits.append(np.asarray(lg))
            res[f"{arch}/{b}"] = np.stack(logits)
    np.savez(out / "decode.npz", **res)


def main() -> None:
    out = Path(sys.argv[1])
    inputs = dict(np.load(out / "inputs.npz"))
    cells(out)
    step(inputs, out)
    ep(inputs, out)
    decode_cells(out)
    decode(inputs, out)


if __name__ == "__main__":
    main()
