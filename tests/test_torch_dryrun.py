"""The port's dry-run and cost model against the JAX package on the CPU.

`repro_torch.launch.dryrun` runs each (architecture x shape) cell on the
meta device under `launch/cost.py::CostCounter`; `launch/bpmf_dryrun.py`
runs a BPMF sweep there from plan shapes alone. Held to the JAX package:
parameter counts (total and active), the cell list, model FLOPs, input
specs, the train state's leaves and moment dtypes, `roofline_terms`,
`plan_shape` and the BPMF model FLOPs, all exactly; and the counter's
flops against `repro/launch/hlo_analysis.py::HloCostModel` on the
CPU-compiled JAX loss and its gradient, within 1%, for the reduced
smollm-360m and granite-moe-3b-a800m at B = 2, S = 32 with remat off (both
packages take the direct attention path there: `reduced` sets
chunked_attn_min_len = 64). The JAX dry-run modules set XLA_FLAGS when
imported; `_jax_module` puts the variable back at once (no JAX backend
has started by then).
"""
import dataclasses
import importlib
import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: pytest-xdist runs several workers on the same cores,
# and torch's default thread count each would oversubscribe them
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY as JREGISTRY, reduced as jreduced  # noqa: E402
from repro.launch.hlo_analysis import HloCostModel, roofline_terms as jroofline  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro_torch.configs import REGISTRY, reduced  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import bpmf_dryrun, cost, dryrun  # noqa: E402
from repro_torch.launch.cost import CostCounter  # noqa: E402
from repro_torch.launch.train import adamw_config, train_state_shapes  # noqa: E402
from repro_torch.models import api  # noqa: E402

META = torch.device("meta")


def _jax_module(name: str):
    """A JAX dry-run module, imported with XLA_FLAGS put back as it was."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(name)
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


def _dtype_name(dt) -> str:
    return str(dt).split(".")[-1] if isinstance(dt, torch.dtype) else np.dtype(dt).name


# ---------------------------------------------------------------------------
# The model API's helpers, exactly
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(JREGISTRY))
def test_count_params_matches_jax(arch):
    """Total and active counts, full and reduced, for every config of both
    registries (the same set): kimi's 1.04 T total and its MoE's active."""
    assert set(REGISTRY) == set(JREGISTRY)
    for port, ref_cfg in ((REGISTRY[arch], JREGISTRY[arch]),
                          (reduced(REGISTRY[arch]), jreduced(JREGISTRY[arch]))):
        assert api.count_params(port) == japi.count_params(ref_cfg)


def test_cells_shapes_and_model_flops_match_jax():
    jdry = _jax_module("repro.launch.dryrun")
    assert dryrun.all_cells() == jdry.all_cells()
    assert len(dryrun.all_cells()) == 32
    assert [dataclasses.astuple(s) for s in api.LM_SHAPES] == [
        dataclasses.astuple(s) for s in japi.LM_SHAPES]
    for arch in REGISTRY:
        names = [s.name for s in api.supported_shapes(REGISTRY[arch])]
        assert names == [s.name for s in japi.supported_shapes(JREGISTRY[arch])]
        for name in names:
            assert api.model_flops_per_step(REGISTRY[arch], api.shape_by_name(name)) == \
                japi.model_flops_per_step(JREGISTRY[arch], japi.shape_by_name(name))
    with pytest.raises(KeyError):
        api.shape_by_name("no_such_shape")


@pytest.mark.parametrize("arch", sorted(JREGISTRY))
def test_input_specs_match_jax(arch):
    for shape in api.LM_SHAPES:
        mine = api.input_specs(REGISTRY[arch], shape)
        theirs = japi.input_specs(JREGISTRY[arch], japi.shape_by_name(shape.name))
        assert list(mine) == list(theirs)
        for key, t in mine.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(theirs[key].shape), (key, shape.name)
            assert _dtype_name(t.dtype) == np.dtype(theirs[key].dtype).name


@pytest.mark.parametrize("arch", sorted(JREGISTRY))
def test_train_state_shapes_match_jax(arch):
    """Every leaf of the JAX train state (parameters, both moments) has the
    port's shape, by `param_leaf`'s names, in the config's moment dtype
    (bf16 for kimi), all on the meta device; the step is a scalar."""
    cfg, jcfg = REGISTRY[arch], JREGISTRY[arch]
    state = train_state_shapes(cfg)
    jstate = japi_train_state_shapes(jcfg)

    def leaves(tree) -> dict:
        return {".".join(str(getattr(p, "key", p)) for p in path): sd
                for path, sd in jax.tree_util.tree_leaves_with_path(tree)}

    want = {k: v.shape for k, v in leaves(jstate.params).items()}
    got = {k.replace(".*", ""): v for k, v in api.jax_leaf_shapes(state.params).items()}
    assert got == want
    moment = np.dtype(jcfg.moment_dtype).name
    assert _dtype_name(cfg.moment_dtype) == moment
    assert moment == ("bfloat16" if arch == "kimi-k2-1t-a32b" else "float32")
    for tree, jtree in ((state.opt.m, jstate.opt.m), (state.opt.v, jstate.opt.v)):
        assert {np.dtype(sd.dtype).name for sd in leaves(jtree).values()} == {moment}
        assert {_dtype_name(t.dtype) for t in tree.values()} == {moment}
        assert all(t.device.type == "meta" and t.shape == p.shape
                   for t, p in zip(tree.values(), state.params.parameters()))
    assert all(p.device.type == "meta" for p in state.params.parameters())
    assert state.step.shape == () and jstate.step.shape == ()


def japi_train_state_shapes(jcfg):
    from repro.launch.train import train_state_shapes as jshapes

    return jshapes(jcfg, JAdamWConfig(moment_dtype=jcfg.moment_dtype))


def test_roofline_terms_plan_shape_and_bpmf_flops_match_jax():
    args = dict(flops=3.2e15, hbm_bytes=7.5e12, collective_bytes_per_device=2.5e11,
                n_devices=4, peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9)
    assert cost.roofline_terms(**args) == jroofline(**args)
    assert cost.roofline_terms(**dict(args, hbm_bytes=1e15)) == \
        jroofline(**dict(args, hbm_bytes=1e15))
    jb = _jax_module("repro.launch.bpmf_dryrun")
    assert bpmf_dryrun.DATASETS == jb.DATASETS
    for (m, n, nnz) in jb.DATASETS.values():
        for p in (1, 4, 256, 512):
            assert bpmf_dryrun.plan_shape(m, n, nnz, p, 32) == jb.plan_shape(m, n, nnz, p, 32)
            assert bpmf_dryrun.plan_shape(n, m, nnz, p, 32) == jb.plan_shape(n, m, nnz, p, 32)
        # the JAX dry-run computes its model FLOPs inline in run_cell
        k = 64
        assert bpmf_dryrun.model_flops(m, n, nnz, k) == \
            2.0 * nnz * k * k + (m + n) * (2 / 3 * k**3 + 4 * k * k)


# ---------------------------------------------------------------------------
# The counter's flops against the HLO cost model
# ---------------------------------------------------------------------------
def _jax_flops(jcfg, b: int, s: int, grad: bool) -> float:
    model = japi.build_model(jcfg)
    params = model.init(jax.random.PRNGKey(0))
    batch = {"tokens": jnp.zeros((b, s), jnp.int32), "labels": jnp.zeros((b, s), jnp.int32)}
    fn = (jax.grad(lambda p, x: model.loss_fn(p, x)[0]) if grad
          else lambda p, x: model.loss_fn(p, x)[0])
    hlo = jax.jit(fn).lower(params, batch).compile().as_text()
    return float(HloCostModel(hlo).analyze()["flops"])


def _port_flops(cfg, b: int, s: int, grad: bool) -> float:
    model = api.build_model(cfg, device=META)
    params = model.init()
    batch = api.input_specs(cfg, api.ShapeSpec("t", s, b, "train"))
    with CostCounter() as counter:
        if grad:
            model.loss_fn(params, batch)[0].backward()
        else:
            with torch.no_grad():
                model.loss_fn(params, batch)
    return counter.flops


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-3b-a800m"])
def test_counter_flops_within_1pct_of_hlo_cost_model(arch):
    """The forward (the loss) and the train step's gradient of the reduced
    config at B = 2, S = 32, remat off. Both count the products' 2 m n k and
    nothing else; the structures match: the same GEMMs (the MoE's expert
    einsums over the (E_pad, cap, d) buffer, its fp32 router, the tied head
    in fp32), the direct attention path in both. The gradient's products
    are the transposes of the forward's in both packages."""
    cfg = dataclasses.replace(reduced(REGISTRY[arch]), remat=False)
    jcfg = dataclasses.replace(jreduced(JREGISTRY[arch]), remat=False)
    assert cfg.chunked_attn_min_len > 32
    for grad in (False, True):
        mine, theirs = _port_flops(cfg, 2, 32, grad), _jax_flops(jcfg, 2, 32, grad)
        print(f"{arch} {'grad' if grad else 'forward'}: counter {mine:.6g}, "
              f"HloCostModel {theirs:.6g}, ratio {mine / theirs:.5f}")
        assert mine == pytest.approx(theirs, rel=0.01)


# ---------------------------------------------------------------------------
# The meta path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_meta_pass_runs_every_kind_on_the_reduced_config(arch):
    """lower_cell on the meta device for a train, prefill, decode and
    forward cell of the reduced config (B = 2, S = 128: past
    chunked_attn_min_len, so a train or forward cell of a decoder takes the
    flash op's fake), counting flops and launching no kernel."""
    cfg = reduced(REGISTRY[arch])
    ops.reset_launches()
    for kind in ("train", "prefill", "decode", "forward"):
        counter, out_bytes = dryrun.lower_cell(cfg, api.ShapeSpec(kind, 128, 2, kind))
        rec = dryrun.cell_record(cfg, api.ShapeSpec(kind, 128, 2, kind), counter, out_bytes)
        assert rec["flops"] > 0 and rec["hbm_bytes"] > 0 and out_bytes > 0, kind
        assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"] > 0
        assert rec["fits_one_card"] and rec["roofline"]["step_lower_bound_s"] > 0
    assert sum(ops.launches().values()) == 0


def test_full_size_cells_on_meta_and_kimi_does_not_fit():
    ops.reset_launches()
    gemma = dryrun.run_cell("gemma2-2b", "prefill_32k", save=False)
    kimi = dryrun.run_cell("kimi-k2-1t-a32b", "decode_32k", save=False)
    for rec in (gemma, kimi):
        assert rec["ok"], rec.get("traceback")
        assert rec["top_flops"] and rec["top_bytes"] and not rec["launches"]
    assert kimi["params_total"] == pytest.approx(1.041e12, rel=1e-3)
    assert kimi["fits_one_card"] is False
    # the bf16 KV cache of 61 layers x 128 x 32,768 positions alone
    assert kimi["memory"]["argument_bytes"] > 61 * 128 * 32_768 * 8 * 112 * 2 * 2
    assert gemma["tokens_per_step"] == 32 * 32_768
    assert gemma["model_flops"] == api.model_flops_per_step(
        REGISTRY["gemma2-2b"], api.shape_by_name("prefill_32k"))
    assert sum(ops.launches().values()) == 0
    assert "ok  params" in dryrun.summary_line(kimi)


def _chip_smoke():
    """chip_smoke.py loaded as a module, for its constants (its main()
    runs only as a script)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("arch", ["zamba2-7b", "qwen2-vl-7b", "granite-20b"])
def test_cut_train_cells_fit_one_card(arch):
    """The train steps chip_smoke.py runs on the card at full width and a
    cut depth (CUT_TRAIN_LAYERS: zamba2-7b 54 of 81, qwen2-vl-7b 8 of 28,
    granite-20b 8 of 52), at B = 1, S = 8,192, lower on the meta device
    with a modelled peak under 72 GB (80 GB less a tenth for what the
    allocator adds), and count the flash pair's calls the step's structure
    gives: zamba's shared block once an application (outside the remat),
    a decoder layer's forward twice (forward and recompute) and its
    backward once. zamba2-7b's reaches the backward's fake at D = 112."""
    layers = _chip_smoke().CUT_TRAIN_LAYERS[arch]
    cfg = dataclasses.replace(REGISTRY[arch], n_layers=layers)
    assert layers < REGISTRY[arch].n_layers
    ops.reset_launches()
    counter, _ = dryrun.lower_cell(cfg, api.ShapeSpec("train", 8192, 1, "train"))
    assert counter.peak_bytes < 72e9, counter.peak_bytes
    calls = {name.split(".")[-1]: rec[0] for name, rec in counter.by_op.items()
             if "flash" in name}
    groups = layers // cfg.attn_every if cfg.family == "hybrid" else 0
    want = ({"flash_forward": groups, "flash_attention_bwd": groups} if groups else
            {"flash_forward": 2 * layers, "flash_attention_bwd": layers})
    assert calls == want
    assert (cfg.hd == 112) == (arch == "zamba2-7b")
    assert sum(ops.launches().values()) == 0


def _flash_args(dtype, d=32):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((4, 64, d), generator=g).to(dtype)
    k = torch.randn((2, 64, d), generator=g).to(dtype)
    v = torch.randn((2, 64, d), generator=g).to(dtype)
    return q, k, v


def _shapes(out):
    return [(tuple(t.shape), t.dtype) for t in out]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_ops_return_the_real_ops_shapes(dtype):
    """Each kernel's op on CPU tensors (its plain version) and on meta
    tensors (its fake) gives outputs of the same shapes and dtypes, the
    empty o32 of an fp32 forward and of a forward without `keep` included."""
    def both(fn, *args):
        real = fn(*args)
        fake = fn(*(a.to(META) if isinstance(a, torch.Tensor) else a for a in args))
        assert all(t.device.type == "meta" for t in fake)
        assert _shapes(real) == _shapes(fake), fn
        return real

    q, k, v = _flash_args(dtype)
    for keep in (True, False):
        out, lse, o32 = both(ops.flash_forward, q, k, v, True, 16, 0.0, 0.2, keep)
    o = ref.flash_attention_fwd_ref(q, k, v, causal=True, window=16, softcap=0.0,
                                    scale=0.2)
    both(torch.ops.repro_torch.flash_attention_bwd, q, k, v, q.clone(), o[1],
         o[2].float(), True, 16, 0.0, 0.2)
    if dtype != torch.float32:
        return
    g = torch.Generator().manual_seed(1)
    r, w, n, kk = 12, 5, 20, 8
    idx = torch.randint(0, n, (r, w), generator=g, dtype=torch.int32)
    val = torch.randn((r, w), generator=g)
    msk = (torch.rand((r, w), generator=g) > 0.3).float()
    seg = torch.tensor([0, 0, 1, 1, 1, 2, 3, 3, 4, 5, 5, 5], dtype=torch.int32)
    ptr = torch.tensor(ops.segment_offsets(seg.numpy(), 6))
    for vmat in (torch.randn((n, kk), generator=g), torch.randn((3, n, kk), generator=g)):
        both(torch.ops.repro_torch.gather_syrk_seg, idx, val, msk, seg, 6, vmat, False,
             False, ptr)
        both(torch.ops.repro_torch.gather_syrk_seg, idx, val, msk,
             torch.arange(r, dtype=torch.int32), r, vmat, False, True, None)
    both(torch.ops.repro_torch.masked_syrk, torch.randn((r, w, kk), generator=g), val)
    a = torch.randn((r, kk, kk), generator=g)
    prec = a @ a.transpose(1, 2) + kk * torch.eye(kk)
    both(torch.ops.repro_torch.chol_solve_sample, prec, torch.randn((r, kk), generator=g),
         torch.randn((r, kk), generator=g))
    both(torch.ops.repro_torch.topn_scores, torch.randn((6, kk), generator=g),
         torch.randn((50, kk), generator=g), 7, None)
    with pytest.raises(ValueError, match="seg_ptr"):
        torch.ops.repro_torch.gather_syrk_seg(idx.to(META), val.to(META), msk.to(META),
                                              seg.to(META), 6, vmat.to(META), False, False,
                                              None)


def test_kernel_flop_formulas_count_the_functions_work():
    """The flop counter reads the kernels' registered formulas: syrk
    K(K + 1) + 2K a rating slot, the solve n(K^3/3 + 2K^2), top-N 2 B N K,
    flash 2 D a visible pair a product (2 forward, 5 backward)."""
    from torch.utils.flop_counter import FlopCounterMode

    def flops(fn, *args):
        with FlopCounterMode(display=False) as fc:
            fn(*(a.to(META) if isinstance(a, torch.Tensor) else a for a in args))
        return fc.get_total_flops()

    e = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt)  # noqa: E731
    i32 = torch.int32
    assert flops(torch.ops.repro_torch.gather_syrk_seg, e(10, 4, dt=i32), e(10, 4), e(10, 4),
                 e(10, dt=i32), 3, e(2, 50, 16), False, False, e(4, dt=i32)) == \
        2 * 10 * 4 * (16 * 17 + 32)
    assert flops(torch.ops.repro_torch.masked_syrk, e(10, 4, 16), e(10, 4)) == \
        10 * 4 * (16 * 17 + 32)
    assert flops(torch.ops.repro_torch.chol_solve_sample, e(7, 16, 16), e(7, 16),
                 e(7, 16)) == pytest.approx(7 * (16 ** 3 / 3 + 2 * 16 * 16))
    assert flops(torch.ops.repro_torch.topn_scores, e(6, 16), e(50, 16), 5, None) == \
        2 * 6 * 50 * 16
    q, k, v = (e(8, 256, 64, dt=torch.bfloat16), e(2, 256, 64, dt=torch.bfloat16),
               e(2, 256, 64, dt=torch.bfloat16))
    pairs = ops.visible_pairs(256, window=100)
    assert pairs == sum(min(i + 1, 100) for i in range(256))
    assert flops(ops.flash_forward, q, k, v, True, 100, 0.0, 0.125, True) == \
        2 * 2 * 64 * 8 * pairs
    assert flops(torch.ops.repro_torch.flash_attention_bwd, q, k, v, q, e(8, 256),
                 e(8, 256, 64), False, 0, 0.0, 0.125) == 5 * 2 * 64 * 8 * 256 * 256


def test_steps_counts_the_full_loops():
    """A loop under `steps` on the meta device runs four iterations and
    counts the rest as repeats of the third, forward and backward: the
    counts equal the full loop's (the xLSTM's sLSTM over 256 steps and its
    mLSTM over 4 chunks of 64, remat on and off; zamba2's SSD over 8 chunks
    of 32, remat on (a loop recomputed inside the backward) and off),
    flops, bytes, ops and peak alike; and no loop runs short on the CPU."""
    xl = reduced(REGISTRY["xlstm-350m"])
    zb = dataclasses.replace(reduced(REGISTRY["zamba2-7b"]), ssm_chunk=32)
    for cfg, kind in ((xl, "train"), (dataclasses.replace(xl, remat=True), "train"),
                      (xl, "prefill"), (zb, "train"), (dataclasses.replace(zb, remat=True), "train"),
                      (zb, "prefill")):
        cut, full = dryrun.cut_and_full(cfg, api.ShapeSpec(kind, 256, 1, kind))
        assert cut.pop("repeated_ops") > 0 and full.pop("repeated_ops") == 0
        assert cut == full, (cfg.name, kind, cfg.remat)
    assert list(cost.steps(6)) == list(range(6))
    ran = [torch.zeros(2) for _ in range(7)]
    assert cost.steps(7).full(ran) == ran


def test_counter_reads_cache_and_peak_of_a_known_program():
    """Bytes and the peak on a small program: an op's distinct inputs and
    outputs, free views, a write-only copy, and the peak of live bytes."""
    a = torch.empty((256, 256), device=META)
    b = torch.empty((256, 256), device=META)
    with CostCounter([a, b]) as counter:
        c = a @ b                       # reads a, b; writes c
        d = c * c                       # reads c once; writes d
        del c
        d.t()                           # a view: free
        d.copy_(a)                      # writes d (reads a)
        e = d + 1.0
    n = 256 * 256 * 4
    assert counter.flops == 2 * 256 ** 3 and counter.tensor_flops == 0
    assert counter.hbm_bytes == 3 * n + 2 * n + 2 * n + 2 * n
    assert counter.argument_bytes == 2 * n
    assert counter.peak_bytes == 2 * n + 2 * n          # c and d live at once
    assert e.shape == (256, 256) and counter.n_ops == 4


@pytest.mark.parametrize("mode", ["ring", "allgather", "async"])
@pytest.mark.parametrize("engine", ["einsum", "fused"])
def test_bpmf_dryrun_sweeps_two_shards(mode, engine):
    """run_cell at --shards 2 on a tiny dataset's dims, every mode and
    engine: ok, no launch, the exchange's bytes counted; and a real
    sampler's plans' twins on the meta device at their exact shapes."""
    ops.reset_launches()
    rec = bpmf_dryrun.run_cell("tiny", mode, shards=2, k=8, width=4, engine=engine,
                               dims=(40, 30, 300), save=False)
    assert rec["ok"], rec.get("traceback")
    assert rec["flops"] > 0 and rec["exchange_bytes"] > 0 and rec["fits_one_card"]
    assert rec["per_shard_flops"] == rec["flops"] / 2
    assert rec["model_flops"] == bpmf_dryrun.model_flops(40, 30, 300, 8)
    from repro_torch.core.distributed import DistributedBPMF
    from repro_torch.data.datasets import synthetic_lowrank

    ratings, _, _ = synthetic_lowrank(40, 30, 4, 300, seed=0)
    real = DistributedBPMF(ratings, None, devices=["cpu", "cpu"], k=8, width="auto",
                           mode=mode, engine=engine)
    u_side, v_side = bpmf_dryrun.sides_of(real)
    twin = DistributedBPMF.from_sides(40, 30, u_side, v_side, k=8, mode=mode, engine=engine)
    counter = bpmf_dryrun.count_sweep(twin)
    assert counter.flops > 0 and counter.exchange_bytes > 0
    plan = real._u.plans[0] if mode == "allgather" else real._u.plans[0][1]
    tw = u_side.plans[0] if mode == "allgather" else u_side.plans[0][1]
    assert tw.indices.shape == plan.indices.shape and tw.n_segments == plan.n_segments
    assert sum(ops.launches().values()) == 0
