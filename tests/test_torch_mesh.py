"""The port's device mesh against the JAX package and against its own
mesh-free paths, on the CPU.

  * The sharding rules (`models/api.py`: param_pspecs, train_state_pspecs,
    input_pspecs, cache_pspecs) for the ten configs at full size and
    reduced, on (16, 16), (2, 16, 16) and (2, 4) meshes, equal the JAX
    package's on an AbstractMesh dim for dim (the JAX leaves' stacked axes
    are never sharded; their body dims are the port tensor's dims).
  * Per-device argument bytes and flops of the reduced smollm-360m and
    granite-moe-3b-a800m train cells (base, B = 8, S = 64) on a (2, 4)
    mesh: the port's meta-device count in a fake world of 8 ranks against
    the JAX compile on 8 forced CPU devices (tests/torch_mesh_jax.py, a
    subprocess): the argument bytes exactly, the flops within 10% of
    `HloCostModel`'s. The collectives differ by design (GSPMD picks its
    own; the port's are DTensor's and its regions') and are only printed.
    Only the base variant: the JAX package's `opt` train cell does not
    lower on a concrete mesh under jax 0.9 (a ShardingTypeError from the
    head's einsum, ROADMAP.md queue 3), so its expert-parallel region is
    held to `_moe_ep_shard_map` directly.
  * Values, in one run of 4 gloo ranks (tests/torch_mesh_ranks.py, a
    subprocess) on a (2, 2) ("data", "model") mesh:
      - the reduced gemma2-2b train step in fp32: the loss, grad_norm and
        lr at rtol 1e-5, the gradients before the step within 1e-5 of each
        one's largest magnitude, and the parameters after it at rtol 1e-5
        and atol 1e-7, against the port's mesh-free step; against the JAX
        package's jitted step on a (2, 2) mesh of its forced devices at
        tests/test_torch_train.py's tolerances (loss, grad_norm and lr at
        rtol 1e-5, the parameters at rtol 1e-4 and atol 1e-6);
      - `restore_resharded` from (2, 2) to (4, 1): every tensor's bits;
      - the expert-parallel MoE region at model = 2 against the mesh-free
        grouped dispatch (the output within 1e-5 of its largest
        magnitude; the aux loss differs by design: the JAX package's EP
        averages each batch shard's, `pmean`) and against the JAX
        package's `_moe_ep_shard_map` on the same inputs at
        tests/test_torch_moe.py's tolerances (1e-5 of the output's largest
        magnitude, aux at rtol 1e-6);
      - decode over a K/V cache sharded on its sequence (the split
        softmax) against the mesh-free decode: the logits of a prefill and
        3 steps at rtol 1e-5, atol 1e-5;
      - decode of the reduced gemma2-2b, xlstm-350m, zamba2-7b and
        whisper-medium in fp32 at B = 4 and B = 1 (the K/V sequence over
        ("data", "model"), the recurrent states on a head dim or a stacked
        axis), the cache at `cache_pspecs`' placements: a prefill and 3
        steps against the mesh-free decode (rtol, atol 1e-5) and against
        the JAX package's jitted decode_fn on a (2, 2) mesh of its forced
        devices with the cache placed by its `cache_pspecs` (rtol, atol
        1e-4); a step from zero states differs by more than 1e-2.
  * The reduced xLSTM, Zamba2 and whisper decode cells (B = 8 and 1) on a
    (2, 4) mesh: the arguments the port's step reads, per device, equal
    the JAX compile's argument size.
  * On the (1, 1) host mesh, the recurrent families' prefill and a decode
    step bit for bit the mesh-free ones, and the zero-state plant.
  * The mesh dry-run (`launch/dryrun.py --mesh`): one full-size cell's
    record on the 16 x 16 mesh, the cost counter's collectives, and the
    decode cells with zamba2-7b's long_500k on 2 x 16 x 16.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import REGISTRY as JREGISTRY, reduced as jreduced  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro_torch.configs import REGISTRY, apply_variant, reduced  # noqa: E402
from repro_torch.launch import dryrun, mesh as lmesh  # noqa: E402
from repro_torch.launch.cost import CostCounter  # noqa: E402
from repro_torch.launch.train import adamw_config, train_state_shapes  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.transformer import param_leaf  # noqa: E402

TESTS = Path(__file__).resolve().parent
SRC = str(TESTS.parent / "src")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
#: the subprocesses' limit; both take some 20 s
RUN_TIMEOUT_S = 240
#: the configs whose decode on a (2, 2) mesh is held to the mesh-free
#: decode and to the JAX package's (tests/torch_mesh_ranks.py,
#: tests/torch_mesh_jax.py)
DECODE_ARCHS = ("gemma2-2b", "xlstm-350m", "zamba2-7b", "whisper-medium")
#: reduced variants, run at B = 1, whose states shard as the full-width
#: long_500k cell's: one xLSTM head (C and n over dk, m whole, the sLSTM
#: over hd, the conv over channels), one group of three Mamba2 layers
#: (mamba_h over heads, its conv over channels)
DECODE_VARIANTS = {"xlstm-350m.h1": ("xlstm-350m", {"n_heads": 1, "n_kv_heads": 1}),
                   "zamba2-7b.g3": ("zamba2-7b", {"n_layers": 3, "attn_every": 3})}


def _amesh(name: str) -> AbstractMesh:
    shape, axes = MESHES[name]
    try:
        return AbstractMesh(shape, axes)
    except TypeError:                                      # older jax: pairs
        return AbstractMesh(tuple(zip(axes, shape)))


def _norm(spec, ndim: int) -> tuple:
    """A JAX PartitionSpec (or a port spec) as a tuple of ndim entries, a
    one-name tuple as the name."""
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(tuple(spec))):
        if isinstance(e, (tuple, list)):
            e = tuple(e) if len(e) > 1 else (e[0] if e else None)
        out.append(e)
    return tuple(out)


def _jleaf(tree, name: str):
    for key in [q for q in name.split(".") if not q.isdigit()]:
        tree = tree[key]
    return tree


def _cfgs(arch: str):
    return [(REGISTRY[arch], JREGISTRY[arch]), (reduced(REGISTRY[arch]), jreduced(JREGISTRY[arch]))]


def _check_params(pspec: dict, jspec, params) -> None:
    for n, p in params.items():
        st = api.stacked_axes(n)
        want = _norm(_jleaf(jspec, n), p.dim() + st)
        assert want[:st] == (None,) * st, (n, want)
        assert _norm(pspec[n], p.dim()) == want[st:], (n, pspec[n], want)


# ---------------------------------------------------------------------------
# The sharding rules, dim for dim
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(JREGISTRY))
def test_param_and_train_state_specs_match_jax(arch, mesh):
    axes = dict(zip(MESHES[mesh][1], MESHES[mesh][0]))
    for pc, jc in _cfgs(arch):
        jshapes = jax.eval_shape(lambda c=jc: japi.build_model(c).init(jax.random.PRNGKey(0)))
        state = train_state_shapes(pc, adamw_config(pc))
        params = dict(state.params.named_parameters())
        _check_params(api.param_pspecs(pc, state.params, axes),
                      japi.param_pspecs(jc, jshapes, _amesh(mesh)), params)
        jstate = jtrain.train_state_shapes(jc, JAdamWConfig(moment_dtype=jc.moment_dtype))
        jspecs = japi.train_state_pspecs(jc, jstate, _amesh(mesh))
        specs = api.train_state_pspecs(pc, state, axes)
        _check_params(specs.params, jspecs.params, params)
        _check_params(specs.opt.m, jspecs.opt.m, state.opt.m)
        _check_params(specs.opt.v, jspecs.opt.v, state.opt.v)
        assert specs.step == () and specs.opt.step == () == tuple(jspecs.step)


def _flat(tree, like, prefix=()):
    """(path, leaf) of a tree whose structure is `like`'s (a cache: its
    dicts and tuples; a spec is itself a tuple)."""
    if isinstance(like, dict):
        for k in like:
            yield from _flat(tree[k], like[k], prefix + (str(k),))
    elif isinstance(like, (tuple, list)):
        for i, sub in enumerate(like):
            yield from _flat(tree[i], sub, prefix + (str(i),))
    else:
        yield prefix, tree


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(JREGISTRY))
def test_input_and_cache_specs_match_jax(arch, mesh):
    axes = dict(zip(MESHES[mesh][1], MESHES[mesh][0]))
    for (pc, jc), small in zip(_cfgs(arch), (False, True)):
        shapes = [s for s in api.supported_shapes(pc)]
        if small:
            shapes = [api.ShapeSpec(s.name, 64, 8, s.kind) for s in shapes]
        for s in shapes:
            js = japi.ShapeSpec(s.name, s.seq_len, s.global_batch, s.kind)
            assert api.batch_axes_for(axes, s.global_batch) == \
                japi.batch_axes_for(_amesh(mesh), s.global_batch)
            got = api.input_pspecs(pc, s, axes)
            want = japi.input_pspecs(jc, js, _amesh(mesh))
            assert set(got) == set(want)
            for k in got:
                assert _norm(got[k], len(got[k])) == _norm(want[k], len(got[k])), (s.name, k)
            if s.kind != "decode":
                continue
            cache = api.build_model(pc, device="meta").empty_cache(s.global_batch, s.seq_len)
            leaves = dict(_flat(cache, cache))
            got = dict(_flat(api.cache_pspecs(pc, s, axes), cache))
            want = {k: v for k, v in jax.tree_util.tree_flatten_with_path(
                japi.cache_pspecs(jc, js, _amesh(mesh)),
                is_leaf=lambda x: type(x).__name__ == "PartitionSpec")[0]}
            want = {tuple(str(getattr(q, "key", getattr(q, "idx", q))) for q in path): v
                    for path, v in want.items()}
            assert set(got) == set(want) == set(leaves), (s.name, sorted(got), sorted(want))
            for k, spec in got.items():
                nd = leaves[k].dim()
                assert _norm(spec, nd) == _norm(want[k], nd), (s.name, k, spec, want[k])


def test_placements_of_specs():
    """A spec's names become Shard placements of a DeviceMesh, the rest
    Replicate; a (pod, data) entry shards its dim over both, pod major."""
    from torch.distributed.tensor import Replicate, Shard

    with lmesh.fake_world(512):
        m = lmesh.make_production_mesh(multi_pod=True, device="meta")
        assert m.mesh_dim_names == ("pod", "data", "model") and tuple(m.mesh.shape) == (2, 16, 16)
        assert api.placements((("pod", "data"), None, "model"), m) == (Shard(0), Shard(0), Shard(2))
        assert api.placements((None, "data"), m) == (Replicate(), Shard(1), Replicate())
    with lmesh.fake_world(256):
        m = lmesh.make_production_mesh(device="meta")
        assert tuple(m.mesh.shape) == (16, 16) and tuple(m.get_coordinate()) == (15, 15)
    with pytest.raises(RuntimeError, match="needs a world of 256"):
        lmesh.make_production_mesh(device="meta")


# ---------------------------------------------------------------------------
# The JAX process and the gloo ranks, run once
# ---------------------------------------------------------------------------
def _inputs(d: Path) -> None:
    """The runs' inputs: the reduced gemma2-2b's fp32 parameters from the
    JAX package's init, a batch, and MoE weights and tokens from numpy."""
    jc = dataclasses.replace(jreduced(JREGISTRY["gemma2-2b"]), dtype=jnp.float32,
                             param_dtype=jnp.float32)
    params = japi.build_model(jc).init(jax.random.PRNGKey(0))
    flat = {"gemma/" + "/".join(str(getattr(q, "key", q)) for q in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    rng = np.random.default_rng(0)
    flat["tokens"] = rng.integers(0, jc.vocab_size, (4, 64), dtype=np.int32)
    flat["labels"] = rng.integers(0, jc.vocab_size, (4, 64), dtype=np.int32)
    mc = apply_variant(reduced(REGISTRY["granite-moe-3b-a800m"]), "opt")
    d_, f, e, ep = mc.d_model, mc.moe_d_ff, mc.n_experts, mc.n_experts_pad or mc.n_experts
    flat["moe/router"] = rng.normal(0, d_ ** -0.5, (d_, e)).astype(np.float32)
    flat["moe/w_gate"] = rng.normal(0, d_ ** -0.5, (ep, d_, f)).astype(np.float32)
    flat["moe/w_up"] = rng.normal(0, d_ ** -0.5, (ep, d_, f)).astype(np.float32)
    flat["moe/w_down"] = rng.normal(0, f ** -0.5, (ep, f, d_)).astype(np.float32)
    flat["moe_x"] = rng.normal(0, 1, (4, 64, d_)).astype(np.float32)
    for arch in DECODE_ARCHS + tuple(DECODE_VARIANTS):
        base, changes = DECODE_VARIANTS.get(arch, (arch, {}))
        jc = dataclasses.replace(jreduced(JREGISTRY[base]), dtype=jnp.float32,
                                 param_dtype=jnp.float32, **changes)
        tree = japi.build_model(jc).init(jax.random.PRNGKey(1))
        flat.update({f"{arch}/" + "/".join(str(getattr(q, "key", q)) for q in path): np.asarray(v)
                     for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]})
        flat[f"dec/{arch}/tokens"] = rng.integers(0, jc.vocab_size, (4, 19), dtype=np.int32)
        if jc.family == "audio":
            flat[f"dec/{arch}/frames"] = rng.normal(
                0, 1, (4, jc.encoder_seq, jc.d_model)).astype(np.float32)
    np.savez(d / "inputs.npz", **flat)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    _inputs(d)
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
               JAX_PLATFORMS="cpu", GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen([sys.executable, str(TESTS / script), str(d)], env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, script in (("jax", "torch_mesh_jax.py"),
                                  ("ranks", "torch_mesh_ranks.py"))}
    logs = {}
    for name, p in procs.items():
        try:
            logs[name] = p.communicate(timeout=RUN_TIMEOUT_S)[0]
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            raise
        assert p.returncode == 0, f"{name} failed:\n{logs[name][-4000:]}"
    return dict(cells=json.loads((d / "cells.json").read_text()),
                step=dict(np.load(d / "step.npz")), ep=dict(np.load(d / "ep.npz")),
                ranks=dict(np.load(d / "ranks.npz")),
                decode_cells=json.loads((d / "decode_cells.json").read_text()),
                decode=dict(np.load(d / "decode.npz")))


def _jtree(flat: dict, prefix: str) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        if key.startswith(prefix):
            node = tree
            *path, leaf = key[len(prefix):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = val
    return tree


# ---------------------------------------------------------------------------
# Per-device argument bytes and flops against the JAX compile
# ---------------------------------------------------------------------------
def _count_cell(arch: str) -> CostCounter:
    cfg = reduced(REGISTRY[arch])
    shape = api.ShapeSpec("mesh_test", 64, 8, "train")
    with lmesh.fake_world(8):
        from torch.distributed.device_mesh import init_device_mesh

        m = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        return dryrun.lower_cell(cfg, shape, m)[0]


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-3b-a800m"])
def test_per_device_bytes_and_flops_match_the_jax_compile(arch, runs):
    counter = _count_cell(arch)
    want = runs["cells"][arch]
    assert counter.argument_bytes == want["argument_bytes"]
    assert abs(counter.flops / want["flops"] - 1.0) < 0.10, (counter.flops, want["flops"])
    coll = counter.collectives()
    print(f"{arch}: port collectives {coll['counts']} {coll['bytes']}; "
          f"JAX {want['collective_counts']} {want['collective_bytes']}")
    assert sum(coll["counts"].values()) > 0


# ---------------------------------------------------------------------------
# Values on 4 gloo ranks
# ---------------------------------------------------------------------------
def test_mesh_train_step_matches_the_mesh_free_step(runs):
    r = runs["ranks"]
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(r[f"mesh/{key}"], r[f"free/{key}"], rtol=1e-5, err_msg=key)
    names = [k[len("grad_free/"):] for k in r if k.startswith("grad_free/")]
    assert names
    for n in names:
        want = r[f"grad_free/{n}"]
        atol = 1e-5 * max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(r[f"grad_mesh/{n}"], want, rtol=0, atol=atol, err_msg=n)
        np.testing.assert_allclose(r[f"param_mesh/{n}"], r[f"param_free/{n}"], rtol=1e-5,
                                   atol=1e-7, err_msg=n)


def test_mesh_train_step_matches_jax_on_a_mesh(runs):
    r, j = runs["ranks"], runs["step"]
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(r[f"mesh/{key}"], j[key], rtol=1e-5, err_msg=key)
    jparams = _jtree(j, "param/")
    for k in [k for k in r if k.startswith("param_mesh/")]:
        n = k[len("param_mesh/"):]
        np.testing.assert_allclose(r[k], np.asarray(param_leaf(jparams, n)[1]), rtol=1e-4,
                                   atol=1e-6, err_msg=n)


def test_restore_resharded_2x2_to_4x1_keeps_the_bits(runs):
    assert bool(runs["ranks"]["restore/on_4x1"])
    assert bool(runs["ranks"]["restore/bitwise"])


def test_ep_moe_region_matches_the_grouped_dispatch(runs):
    r = runs["ranks"]
    assert bool(r["ep/experts_sharded"])
    want = r["ep/grouped_out"]
    np.testing.assert_allclose(r["ep/mesh_out"], want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_ep_moe_region_matches_jax_moe_ep_shard_map(runs):
    r, j = runs["ranks"], runs["ep"]
    np.testing.assert_allclose(r["ep/mesh_out"], j["out"], rtol=0,
                               atol=1e-5 * float(np.abs(j["out"]).max()))
    np.testing.assert_allclose(r["ep/mesh_aux"], j["aux"], rtol=1e-6)


def test_sequence_sharded_decode_matches_the_unsharded_decode(runs):
    r = runs["ranks"]
    assert bool(r["decode/cache_sharded"])
    np.testing.assert_allclose(r["decode/mesh"], r["decode/free"], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Decode on a mesh: the recurrent states, the split softmax over two axes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DECODE_ARCHS[1:])
def test_decode_cell_bytes_match_the_jax_compile(arch, runs):
    """The reduced decode cells (S = 64) at B = 8 (the batch over "data",
    the recurrent states' batch over "model") and B = 1 (the K/V sequence
    over ("data", "model"), the states on a head dim or a stacked axis) on
    a (2, 4) mesh: the arguments the port's step reads, per device, equal
    the JAX compile's argument size, which counts only the arguments its
    program uses (whisper's decode reads no encoder weight and no
    cross-attention K or V weight)."""
    for b in (8, 1):
        with lmesh.fake_world(8):
            from torch.distributed.device_mesh import init_device_mesh

            m = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
            counter = dryrun.lower_cell(reduced(REGISTRY[arch]),
                                        api.ShapeSpec("mesh_test", 64, b, "decode"), m)[0]
        assert counter.read_argument_bytes == runs["decode_cells"][f"{arch}/{b}"], (arch, b)
        if arch != "whisper-medium":
            assert counter.read_argument_bytes == counter.argument_bytes


@pytest.mark.parametrize("b", [4, 1])
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_mesh_decode_matches_the_mesh_free_decode(arch, b, runs):
    """A prefill of 16 tokens and 3 decode steps on the (2, 2) mesh, the
    cache at `cache_pspecs`' placements, against the port's mesh-free
    decode (rtol, atol 1e-5), the logits and the final cache gathered
    whole (each shard its own slots: at B = 1 a split softmax that
    reduced over "model" alone kept the "data" ranks' slots as copies of
    the first ones'); a step from `init_cache`'s zeros differs
    from the first step by more than 1e-2 (a step that ran a one-token
    prefill from zero states would not)."""
    r = runs["ranks"]
    key = f"family/{arch}/{b}"
    assert bool(r[f"{key}/as_specs"]), str(r[f"{key}/placements"])
    placed = json.loads(str(r[f"{key}/placements"]))
    kv = {"gemma2-2b": "k", "zamba2-7b": "attn_k", "whisper-medium": "k"}.get(arch)
    if kv is not None:
        want = "(Shard(dim=2), Shard(dim=2))" if b == 1 else "(Shard(dim=1), Shard(dim=2))"
        assert placed[kv] == want, placed
    np.testing.assert_allclose(r[f"{key}/mesh"], r[f"{key}/free"], rtol=1e-5, atol=1e-5)
    assert float(r[f"{key}/cache_err"]) <= 1e-5
    assert float(np.abs(r[f"{key}/zero"] - r[f"{key}/mesh"][1]).max()) > 1e-2


@pytest.mark.parametrize("b", [4, 1])
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_mesh_decode_matches_jax_on_a_mesh(arch, b, runs):
    """The same prefill and 3 steps against the JAX package's jitted
    decode_fn on a (2, 2) mesh of forced CPU devices, the cache placed by
    its `cache_pspecs`, at tests/test_torch_ssm.py's fp32 tolerance."""
    np.testing.assert_allclose(runs["ranks"][f"family/{arch}/{b}/mesh"],
                               runs["decode"][f"{arch}/{b}"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,placed", [
    ("xlstm-350m.h1", {"mlstm/0": 4, "mlstm/1": 4, "mlstm/2": None, "slstm/0": 3, "conv": 4}),
    ("zamba2-7b.g3", {"mamba_h": 3, "mamba_conv": 4})])
def test_mesh_decode_with_states_on_a_head_dim(name, placed, runs):
    """The variants at B = 1, their states sharded over "model" as the
    full-width long_500k cell's (C's dk, the sLSTM's hd, Mamba2's heads,
    the convs' channels; the mLSTM's m whole): the pieces' partial sums
    all-reduced. Against the mesh-free decode (1e-5) and the JAX package's
    decode on a (2, 2) mesh (1e-4); the zero-state plant."""
    r = runs["ranks"]
    key = f"family/{name}/1"
    got = json.loads(str(r[f"{key}/placements"]))
    for leaf, dim in placed.items():
        want = "(Replicate(), Replicate())" if dim is None else f"(Replicate(), Shard(dim={dim}))"
        assert got[leaf] == want, (leaf, got[leaf])
    assert bool(r[f"{key}/as_specs"])
    np.testing.assert_allclose(r[f"{key}/mesh"], r[f"{key}/free"], rtol=1e-5, atol=1e-5)
    assert float(r[f"{key}/cache_err"]) <= 1e-5
    np.testing.assert_allclose(r[f"{key}/mesh"], runs["decode"][f"{name}/1"], rtol=1e-4,
                               atol=1e-4)
    assert float(np.abs(r[f"{key}/zero"] - r[f"{key}/mesh"][1]).max()) > 1e-2


@pytest.mark.parametrize("arch", DECODE_ARCHS[1:])
def test_recurrent_decode_on_a_mesh_reads_its_states(arch):
    """On the (1, 1) host mesh (a gloo group of one rank), reduced configs
    in fp32: a prefill of 16 tokens gives the mesh-free logits, bit for
    bit; a decode step after it gives the mesh-free step's logits and
    states, bit for bit, and differs by more than 1e-2 from a step taken
    from `init_cache`'s zeros: the plant that catches a step that does not
    read its states (a one-token prefill from zeros)."""
    from repro_torch.launch.train import shard_module, shardings_of
    from repro_torch.models.layers import active_mesh, distribute

    cfg = dataclasses.replace(reduced(REGISTRY[arch]), dtype=torch.float32,
                              param_dtype=torch.float32)
    model = api.build_model(cfg, device="cpu")
    params = model.init(0)
    rng = np.random.default_rng(31)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int64))
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int64))
    batch = {"tokens": prompt}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(
            rng.normal(0, 1, (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        out = model.prefill_fn(params, batch)
        free_cache, free = model.decode_fn(params, out["cache"], {"tokens": nxt})
        free_pre = out["logits"]

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    mesh = lmesh.make_host_mesh(device="cpu")
    try:
        shard_module(params, shardings_of(api.param_pspecs(cfg, params, mesh), mesh), mesh)
        shape = api.ShapeSpec("mesh_test", 16, 2, "prefill")
        ips = api.input_pspecs(cfg, shape, mesh)
        step = {"tokens": distribute(nxt, (("data",), None), mesh)}
        with torch.no_grad(), active_mesh(mesh):
            out = model.prefill_fn(params, {k: distribute(v, ips[k]) for k, v in batch.items()})
            np.testing.assert_array_equal(whole(out["logits"]).numpy(), free_pre.numpy())
            cache, got = model.decode_fn(params, out["cache"], step)
            _, zero = model.decode_fn(params, model.init_cache(2, 16 + 64), step)
        np.testing.assert_array_equal(whole(got).numpy(), free.numpy())
        for (k, a), (_, c) in zip(_flat(free_cache, free_cache), _flat(cache, free_cache)):
            np.testing.assert_array_equal(whole(c).numpy(), a.numpy(), err_msg="/".join(k))
        assert float((whole(zero) - free).abs().max()) > 1e-2
    finally:
        lmesh.close_host_group()


# ---------------------------------------------------------------------------
# The mesh dry-run
# ---------------------------------------------------------------------------
def test_mesh_dryrun_runs_the_decode_cells_and_the_two_axis_shard():
    """`--mesh` runs the 24 decode cells too (decode_32k for the ten
    configs, long_500k for the xLSTM and Zamba2, on each mesh); zamba2-7b's
    long_500k on 2 x 16 x 16 ends ok with the split softmax's all-reduces
    counted, and its per-device attn_k is 1/256 of the one-card cache's:
    the one sequence sharded over ("data", "model")."""
    from repro_torch.models.layers import active_mesh

    decode = [c for c in dryrun.all_cells() if api.shape_by_name(c[1]).kind == "decode"]
    assert len(decode) == 12
    rec = dryrun.run_cell("zamba2-7b", "long_500k", save=False, mesh="multi")
    assert rec["ok"], rec.get("error")
    assert rec["mesh"] == "2x16x16" and rec["collective_counts"]["all-reduce"] > 0
    assert rec["collective_bytes"]["all-reduce"] > 0
    cfg = REGISTRY["zamba2-7b"]
    shape = api.shape_by_name("long_500k")
    with lmesh.fake_world(512):
        m = lmesh.make_production_mesh(multi_pod=True, device="meta")
        with active_mesh(m):
            cache = api.build_model(cfg, device="meta").init_cache(shape.global_batch,
                                                                    shape.seq_len)
    k = cache["attn_k"]
    assert k.to_local().numel() * 256 == k.numel()
    assert k.to_local().shape[2] * 256 == shape.seq_len


def test_mesh_dryrun_record_on_the_pod_mesh():
    """gemma2-2b's train_4k on 16 x 16: the record's per-device fields, the
    collectives by kind, and the per-device flops a 256th of the one-card
    cell's, up to the replicated work (the norms' gradient sums, the
    optimizer's global norm) and the busiest rank's causal share."""
    rec = dryrun.run_cell("gemma2-2b", "train_4k", save=False, mesh="single")
    assert rec["ok"], rec.get("error")
    assert rec["n_devices"] == 256 and rec["mesh"] == "16x16"
    for key in ("per_device_flops", "per_device_hbm_bytes", "collective_bytes",
                "collective_counts", "wire_bytes", "fits", "useful_flops_ratio", "roofline"):
        assert key in rec
    assert set(rec["collective_bytes"]) == {"all-gather", "all-reduce", "reduce-scatter",
                                            "all-to-all", "collective-permute"}
    assert rec["collective_counts"]["all-gather"] > 0 and rec["fits"]
    assert rec["memory"]["peak_bytes"] < 80e9
    one = dryrun.run_cell("gemma2-2b", "train_4k", save=False)
    assert 0.9 < rec["flops"] * 256 / one["flops"] < 1.3
    assert rec["roofline"]["collective_s"] == pytest.approx(
        rec["collective_total_bytes"] / lmesh.NVLINK_BYTES_PER_S)
