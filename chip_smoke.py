#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--phases build,data,...] [--src DIR]

No arguments and no PYTHONPATH: the script finds `src/repro_torch` beside
itself first, then under the working directory. It needs one CUDA card and
exits non-zero, printing no result, without one. `--phases` runs a subset,
in order, and `--src` names another `src` directory, such as a parent
commit's unpacked with `git archive`, to run the same phases against it:
the way two commits are compared in one call on one card. A subset prints
no kernels line and no result line. Phases:

  1. build    every CUDA kernel with nvcc (one process per source, all at
              once), and print the card's name and power limit and each
              kernel's ptxas lines (registers, spills), named by cu++filt
  2. data     chembl_like(scale=1.0) with a 0.1 test split, and the
              balanced bucket plans of both sides (through GibbsSampler)
  3. kernels  each BPMF training kernel at K = 64 against its plain
              PyTorch version on the card at the run's shapes (the syrk
              kernels bit for bit; the solve on both half-sweeps' systems
              as a sweep builds them and as the prior hyperparameters give
              them, the same bits on two calls), timed beside its bound and one
              PyTorch call that computes the same function where there is
              one; gather_syrk_seg also through its launcher alone (the
              wrapper's host share), and each bucket the syrk kernels'
              narrow paths can stage down both paths, to show where the
              threshold lies
  4. ranks    the same kernels at K = 16, 24 and 32 (24 through the
              wrappers' padding), the solve timed at each
  5. topn     top-N at serving's shapes, bit for bit in one slab and in
              several, timed beside topk(u @ v.T); the CUDA kernels of one
              call counted in its profile
  6. train    GibbsSampler(engine="fused") for 8 sweeps (burn-in 4),
              retaining draws into a SampleStore, then 2 sweeps with
              engine="kernel"; the launch counts are asserted
  7. parity   one half-sweep per side for "fused" and "kernel", and a
              3-sweep "fused" chain, against the plain path under the same
              state and noise; then at the quickstart's shape and rank
              (chembl_like(0.01), k = 32, alpha 2.0) both half-sweeps and
              3-sweep chains of "fused" and "kernel" against "einsum"
  8. learning movielens_like(0.05), alpha=4.0: posterior-mean RMSE <= 0.545
  9. serve    PosteriorEnsemble.load -> TopNRecommender.recommend for 4,096
              users with seen-item exclusion, against the plain path, and
              where one batch's time goes (kernel on the card, host)
 10. foldin   cold-start fold-in of 4,096 ChEMBL users (their training
              ratings as new users) against the 4 retained draws, batches
              of 256 and 4,096, engines fused and kernel: every launch held
              against its plain version on its own inputs (syrk kernels
              bit for bit, the solve within 2e-3 and the same bits twice),
              the outputs against the plain path and each other, clones of
              the 64 best-constrained users against the trained ensemble,
              no plan-schema miss on a second batch of each profile; ms,
              launches and peak memory per batch, each kernel timed at the
              fold-in's shapes
 11. cotrain  the chain of phase train goes on for 12 sweeps in a trainer
              thread, publishing each retained draw into a channel
              (window 4); a 4-host, 2-replica ClusterCoordinator attached
              to it (one host killed at its first stage) and a
              RecommendFrontend(n_hosts=4, replicas=2) adopt each publish
              while two request threads send user ids (seen items
              excluded) and cold-start ratings: epochs monotone, the last
              publish committed, no shard rebuilt, the tier and the
              frontend bit for bit equal to one host at the last epoch;
              then the quorum barrier at full size (the epoch holds while
              both owners of a shard hang mid-stage); queries/s, p50/p99,
              publish -> fresh p50/p99, the sweep while serving
 12. serve_faults faults planted in the fold-in (statistics a user off,
              the fused kernel given one draw's factors, noise in the
              posterior mean) and in the barrier (a commit after one
              shard): each must fail a check of phase 10 or 11
 13. dist     the paper's distributed sampler at the ChEMBL shape: P = 4
              item shards on the one card (width "auto", K = 64, alpha
              1.5), modes ring, allgather and async through the fused
              engine and ring through einsum: every gather_syrk_seg launch
              of a ring and an allgather sweep bit for bit against its
              plain version; ring against allgather after one sweep (1e-4,
              1e-3) and in rmse after 8 (1e-3); async's fresh v bit for bit
              ring's, its rmse within 0.05; a ring planted to forward to
              p - 1 must fail; sweep seconds, item updates/s and peak
              memory per mode and engine; profiles of a ring and an async
              sweep (the exchange copies' ms and the share of it beside
              kernels); each launch of a ring and an allgather sweep timed
              at its shapes beside its plain version and its bound
 14. sgld     the minibatch SGLD samplers and the ALS baseline, which launch
              none of the five kernels (einsum statistics, library solves):
              SGLDSampler at the ChEMBL shape (K = 64, alpha 1.5) at budgets
              of 4,096 and 65,536 lanes, step seconds, steps/s, sampled
              lanes/s, peak memory and the device's idle share; two chains
              of 10 steps equal bit for bit; the reference's accuracy gates
              on their splits (SGLD within 0.05 of fused Gibbs, Gibbs <= ALS
              + 0.02) and an ALS sweep timed at the ChEMBL shape;
              DistributedSGLD with 4 shards on the card in each mode, step
              seconds and peak memory, the full-budget ring gradient against
              allgather's, async's fresh v bit for bit ring's and a ring
              planted to forward the wrong way; the order-fixed segment sum
              bit for bit the plain version's on the ChEMBL buckets
 15. lm_kernels  the flash-attention kernel against its plain version at
              the gemma2-2b forward's shapes, (8, 8,192, 256) bf16 with 4
              KV heads, causal, softcap 50, window 4,096 and 0; at a
              ragged S = 8,000 and in fp32; bf16 within 3e-2 and within a
              bf16 ulp, also on peaked scores (q x 6), where the ulp limit
              must reject the plain versions of neighbouring functions (a
              dropped softcap, K a row off, a window a tile short) and
              the kernel lies within an ulp of float64; at q x 16 and
              softcap 0 within 3e-2 and no farther from float64 than the
              plain version; timed
              beside its bound (4 bf16 tensor passes a visible pair), the
              bound of P V on the fp32 pipes and flex_attention (compiled,
              softcap 50 by score_mod) and, at softcap 0,
              beside scaled_dot_product_attention; digests of an fp32 and a bf16
              output, to hold the kernels' bits against another commit's
 16. lm_eval  the full-width gemma2-2b forward (DecoderModel.loss_fn, seeded
              init) on one TokenStream batch, B = 1, S = 8,192: 26 flash
              launches and a finite loss; loss and last-position logits
              against the same forward down the direct attention path, in
              bf16 and in fp32, and each layer's flash attention on its own
              inputs against float64; again with every wq x 16, where the
              attention scores pass the softcap of 50, with the two paths'
              distance at 1 to 26 layers; the forward's profile shows its
              26 launches on the bf16 tensor-core kernel
 17. lm_serve launch.serve.generate: prefill of 4 x 2,048 prompts, then 31
              greedy decode steps, with no flash launch; the cache
              invariant prefill(t) == prefill(t[:-1]) + decode(t[-1]) in
              fp32 and in bf16
 18. lm_train gemma2-2b training, lm_eval's parameters freed first: the
              flash backward kernel through FlashAttention at (8, 8,192,
              256) bf16 with 4 KV heads, softcap 50, window 4,096 and 0,
              on peaked scores (q x 6) and in fp32 at S = 2,000, each
              head's dq, dk and dv within one bf16 ulp of its largest
              magnitude of the float64 plain version and, in bf16, few of
              their elements more than half their own bf16 ulp from it;
              timed beside its bound (with its achieved bf16 TFLOP/s),
              flex_attention's backward and, at softcap 0,
              scaled_dot_product_attention's backward; the full-width step's gradients on the flash path
              against the direct path and both against the fp32 direct
              path (loss, global norm, each parameter); make_train_step at
              every published width, 26 layers, remat on, B = 1, S =
              8,192: a warm-up step whose loss is lm_eval's bit for bit,
              3 timed steps (seconds, tokens/s, peak memory, model-FLOPs
              share, launches a step), a profiled step and a step at S =
              4,096; runtime.Trainer at reduced gemma2-2b with a failure
              at step 7 (restored bit for bit from step 5, final step 12);
              lm_eval's parameters drawn again from their seed
 19. lm_faults   faults planted one at a time in the bf16 flash launches
              (window a tile short, K a row off, a dropped softcap, the
              last also under the wq x 16 forwards), in the decode step
              (it misses its own slot) and in the bf16 backward launches
              (lse read a row off, the softcap dropped, and a build of the
              kernel that takes P and dS in one bf16 term instead of
              three): each must fail one of the checks of phase 16, 17 or
              18
 20. report   one JSON line of kernels, the card line, and the last line
              {"ok": true, "device": {...}}

The main path is phases 6, 9, 16, 17 and 18, the serving tier's paths are
phases 10 and 11, the distributed sampler's phase 13 and the SGLD and ALS
path phase 14: the launch counters are set to 0 just before each and read
just after (the kernels line's `launches`, `foldin_launches`,
`cotrain_launches`, `dist_launches`, `sgld_launches` and `lm_train_launches`,
the SGLD ones all 0; lm_train's are its 3 timed steps). foldin and cotrain
need train, serve_faults needs foldin and cotrain, dist and sgld need data,
lm_train needs lm_eval, lm_faults needs lm_eval, lm_serve and lm_train. Any
failed check exits non-zero before the last line. No BPMF phase was cut to
make room for the LM ones.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

# the card's published peaks (NVIDIA H100 SXM data sheet): the bounds below
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_TENSOR_FLOPS = 989e12
SECTOR = 32                            # bytes: the least the memory moves at once
K = 64
# flops of one rating's statistics: the symmetric v v^T needs K(K+1)/2
# multiply-adds, r v needs K
SYRK_FLOPS = K * (K + 1) + 2 * K
# the widest row masked_syrk's narrow path can stage at K
# (csrc/masked_syrk.cu: STAGE_FLOATS / K)
SYRK_STAGE_VECTORS = 4096 // K
TOPK = 10
N_USERS_SERVED = 4096
OTHER_RANKS = (16, 24, 32)             # the BPMF kernels' other ranks the repo runs
TOPN_PREVIOUS_MS = 5.710               # the previous top-N kernel (sort-based) at these shapes, PERF.md §6
TOPN_SLAB = 1024                       # items a slab in the forced multi-slab check
TOL = dict(rtol=1e-4, atol=1e-3)       # the JAX kernel tests' (tests/test_kernels.py:171)
CHOL_TOL = dict(rtol=2e-3, atol=2e-3)  # tests/test_kernels.py:56
RMSE_LIMIT = 0.545                     # JAX reference 0.5338 on the CPU, global mean 0.5580
# the serving tier: cold-start fold-in and train-while-serve
FOLDIN_BATCHES = (256, 4096)           # cold users a fold-in batch
FOLDIN_ENGINES = ("fused", "kernel")
FOLDIN_KERNELS = ("gather_syrk_seg", "masked_syrk", "chol_solve_sample")
FOLDIN_CLONE_ATOL = 0.25               # tests/test_serve.py:169, on the RMS here
CLONE_Z_RMS = (0.8, 1.25)              # difference / its sigma: a standard normal
CLONE_Z_MAX = 6.0                      # P(|z| > 6) ~ 2e-9 a value, ~10^4 values
COTRAIN_SWEEPS = 12                    # burn-in 4 (the sampler's): 8 publishes
COTRAIN_VICTIM = 1                     # the host killed at its first stage
COTRAIN_BATCH = 256                    # warm requests a flush (the frontend's max batch)
COTRAIN_COLD = 32                      # cold-start requests a flush
SAMPLE_FIELDS = ("u", "v", "hyper_u_mu", "hyper_u_lam", "hyper_v_mu", "hyper_v_lam",
                 "global_mean", "alpha")
# the distributed sampler (phase dist): P item shards, all on cuda:0
DIST_SHARDS = 4
DIST_RUNS = (("ring", "fused"), ("allgather", "fused"), ("async", "fused"), ("ring", "einsum"))
DIST_SWEEPS = 8                        # the chain the RMSE gates read
DIST_RMSE_ALLGATHER = 1e-3             # ring against allgather, examples/distributed_bpmf.py:43-44
DIST_RMSE_ASYNC = 0.05                 # async against ring, tests/test_distributed.py:164
SGLD_BUDGETS = (4096, 65536)           # padded lanes a half-step: the reference's default, 16x
SGLD_TIMED = 20                        # steps timed, one by one, after SGLD_WARM
SGLD_WARM = 5
SGLD_DET_STEPS = 10                    # the two chains held bit for bit
SGLD_GATE = 0.05                       # tests/test_sgld.py::test_sgld_converges_and_tracks_gibbs
ALS_GATE = 0.02                        # tests/test_bpmf.py::test_bpmf_beats_or_matches_als
PROFILE_MARGIN_S = 0.2                 # idle before and after the recorded call (_profile)
# the LM path: gemma2-2b at full width
LM_SEQ = 8192                          # the cache-free forward's S: chunked_attn_min_len
LM_SERVE = (4, 2048, 32)               # prompts, prompt length, new tokens (31 decode steps)
FLASH_TOL = {"bf16": dict(rtol=3e-2, atol=3e-2),    # tests/test_kernels.py:91
             "fp32": dict(rtol=3e-4, atol=3e-4)}    # tests/test_kernels.py:88
# At S = 8,192 the outputs of N(0,1) inputs average v over thousands of
# keys and are about 0.02: 3e-2 is as large as they are. The kernel and
# its plain version both compute in fp32 and round the output to bf16
# once, so they may differ by one bf16 ulp of the value (at most 2^-7 of
# it) and, below that, by the fp32 sums' order (under 1e-6 at these
# shapes). Every bf16 case is also held to that, which implies 3e-2.
FLASH_BF16_ULP_TOL = dict(rtol=2.0 ** -7, atol=1e-5)
FP32_DIGEST_SEED = 17                  # the inputs of the fp32 flash output's digest
# q is drawn at this scale in the peaked cases: scores of std 6 reach 20
# and more, where the softcap of 50 bends them and a few keys carry each
# row, so a dropped softcap or a misplaced key changes the output by more
# than an ulp.
PEAK_SCALE = 6.0
# The LM checks. At full width, any bf16 forward of gemma2-2b's 26 layers
# lands about 0.065 (0.011 on average) from the fp32 forward of the same
# weights in its last-position logits, through the direct attention path
# as through the flash kernel, and so do prefill(t) and prefill(t[:-1]) +
# decode(t[-1]) (on an NVIDIA H100 80GB HBM3 at 700 W); the noise checks
# below print these distances on every run. That is above the 3e-2 of the
# JAX tests, which run 2 layers at d_model 128. So the bf16 logits are
# held to that noise floor: no more than NOISE_FACTOR times the distance
# of the JAX package's own direct path (or of the full prefill) to the
# fp32 forward, in max and in mean. The readings sit at 0.98-1.04 times
# it; the faults that phase lm_faults plants move it 1.37 times and more.
# The bf16 loss is a mean over 8,192 positions: the kernel path's sits
# 2.9e-4 (2.3e-5 relative) from the direct path's, and a K read a row off
# moves it 4.5e-3. The JAX tests' tolerances apply in fp32, where the
# kernel path holds to 1.5e-5 and the cache invariant to 1.2e-5.
LM_LOSS_RTOL = 1e-4                    # bf16 loss, kernel path against direct path
NOISE_FACTOR = 1.25
LM_FP32_TOL = dict(rtol=1e-3, atol=1e-3)   # fp32 logits: kernel path against direct
                                           # path, and the cache invariant
LM_FP32_LOSS_RTOL = 1e-4
# every layer's wq is multiplied by this in the second set of lm_eval
# forwards (a power of two: the bf16 weights scale exactly and are
# restored exactly): scores of std about 1 at random init become std about
# 16, whose tails pass the softcap of 50 (tests/test_torch_lm.py does the
# same at the reduced size, where x 8 leaves the largest score at 30)
WQ_SCALE = 16.0
CACHE_TOL = dict(rtol=3e-2, atol=3e-2)     # tests/test_models.py:78, in fp32 at full width
# With every wq x 16 the two attention paths are each within 3.5e-5 of the
# float64 attention of every layer's own inputs in fp32, and the layers
# carry that on: the paths' fp32 last-position logits sit 7.6e-6 apart
# after 1 layer, 2.1e-5 after 2, 6.3e-5 after 4, 4.7e-4 after 8, 3.5e-3
# after 16 and 1.8e-2 after 26 (phase lm_eval's depth sweep on an NVIDIA
# H100 80GB HBM3 at 700 W). The limit is about 2.7 times that last
# reading; a softcap dropped in fp32 moves it to 5.0.
LM_WQ_FP32_LOGITS_ATOL = 5e-2
# Each layer's bf16 flash attention against float64: one bf16 ulp of the
# value (the output is rounded once) and, below it, the error of the fp32
# sums the kernel rounds from. At random-init scores the layers take an
# atol of 8.8e-7 beside that rtol; at wq x 16 they take 1.03e-5, above
# FLASH_BF16_ULP_TOL's 1e-5, as the fp32 forward's layers sit up to 3.5e-5
# from float64 there. The scaled forwards' limit is 1e-4.
WQ_BF16_LAYER_TOL = dict(rtol=2.0 ** -7, atol=1e-4)
# LM training (phase lm_train)
BWD_SEED = 23                          # the backward check's inputs
BWD_FP32_SEQ = 2000                    # the fp32 backward case's S, ragged against its tiles
# The backward kernel against its float64 plain version: each gradient of
# each head within one bf16 ulp of its largest magnitude (the lm_kernels
# convention), and an atol of at least 1e-5, the forward's floor
# (FLASH_BF16_ULP_TOL): a gradient entry that is 0 exactly comes out of
# fp32 sums in two orders at about 1e-7.
GRAD_ULP_FLOOR = 1e-5
# That limit cannot tell how P and dS enter the tensor-core products: a
# build that takes them in one bf16 term (x2 and x3 dropped from
# add_product) passes it at 0.59-0.92 ulp. The bf16 gradients are
# therefore also held element by element: a sum rounded to bf16 once is
# float64's value rounded to bf16 except where float64 lies within the
# sum's error of a rounding midpoint, so at most this share of a
# gradient's elements may lie more than half their own bf16 ulp from
# float64. On an NVIDIA H100 80GB HBM3 at 700 W the kernel's shares are
# 4.1e-3 to 1.26e-2 in the three bf16 cases and the one-term build's
# 0.370-0.426 (phase lm_faults plants it). A two-term build's, 4.4e-3 to
# 9.8e-3, cannot be told from the kernel's by its output: what the third
# term carries lies below the error of the tensor cores' sums.
BWD_MISROUNDED_SHARE = 0.05
LM_TRAIN_STEPS = 3                     # timed steps after one warm-up
LM_TRAIN_SHORT = 4096                  # the train_4k shape's length (models/api.py::LM_SHAPES)
# The full-width gradients of the two attention paths (lm_train). They
# differ by bf16 rounding: the direct path rounds the probabilities to bf16
# before P V (as the JAX package's does) and the flash path keeps them in
# fp32, and the 26 layers carry that on. Measured on an NVIDIA H100 80GB
# HBM3 at 700 W (PR 22): the losses 1.1e-5 apart relative (LM_LOSS_RTOL
# holds them), the global gradient norms 6.8e-5 and 9.3e-5 apart relative,
# each parameter's gradient at most 0.019 apart relative in the 2-norm
# (the attention projections of the first layers), and each parameter's
# flash gradient 0.93-1.14 times as far from the fp32 direct path's (bf16
# weights cast to fp32) as the bf16 direct path's, median 0.99. The limits
# sit at 5x, 2.6x and the lm_eval noise factor (NOISE_FACTOR).
GRAD_NORM_RTOL = 5e-4
LM_GRAD_RTOL = 0.05
GRAD_NOISE_FACTOR = NOISE_FACTOR


def lower_triangle_bytes(k: int) -> int:
    """Bytes a read of the lower triangle of one row-major fp32 k x k matrix
    moves, in whole sectors (each row starts on a sector when 4k % 32 == 0)."""
    return sum(-(-(i + 1) * 4 // SECTOR) * SECTOR for i in range(k))


def demangle(names: list[str], nvcc: str) -> dict[str, str]:
    """The kernels that mangled entry names name, by the CUDA toolkit's
    cu++filt beside nvcc: e.g. gather_syrk_rows_kernel<64, float, double>."""
    if not names:
        return {}
    out = subprocess.run([str(Path(nvcc).with_name("cu++filt")), "-p", *names],
                         capture_output=True, text=True, check=True)
    return {name: text.replace("<unnamed>::", "").replace("(int)", "").strip()
            for name, text in zip(names, out.stdout.splitlines())}


def _find_src() -> Path | None:
    for base in (Path(__file__).resolve().parent, Path.cwd()):
        if (base / "src" / "repro_torch" / "__init__.py").is_file():
            return base / "src"
    return None


class Checks:
    def __init__(self):
        self.failed: list[str] = []

    def __call__(self, ok: bool, what: str) -> bool:
        print(f"  {'pass' if ok else 'FAIL'}: {what}", flush=True)
        if not ok:
            self.failed.append(what)
        return ok


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


PHASES = ("build", "data", "kernels", "ranks", "topn", "train", "parity", "learning",
          "serve", "foldin", "cotrain", "serve_faults", "dist", "sgld", "lm_kernels",
          "lm_eval", "lm_serve", "lm_train", "lm_faults")


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated phases to run, in the script's order")
    ap.add_argument("--src", default=None,
                    help="a src directory holding repro_torch (default: the checkout's)")
    args = ap.parse_args()
    phases = args.phases.split(",")
    if not set(phases) <= set(PHASES):
        ap.error(f"unknown phases {sorted(set(phases) - set(PHASES))}")
    src = Path(args.src).resolve() if args.src else _find_src()
    if src is None or not (src / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke: no src/repro_torch beside this script or under the "
              "working directory", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    # torch.compile (the flex_attention library times) keeps its caches in
    # the checkout's build directory and compiles in this process
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(src.parent / "build" / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(src.parent / "build" / "triton"))
    os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the kernels run only on the card",
              file=sys.stderr)
        return 2
    smoke = Smoke(torch, phases, own_src=args.src is None)
    print(f"package: {src / 'repro_torch'}")
    # bound before any runs: phase data sets attributes (train, test) that
    # share names with phases
    for phase in [getattr(smoke, name) for name in PHASES if name in phases]:
        print(f"== {phase.__name__}", flush=True)
        t0 = time.perf_counter()
        try:
            phase()
        except Exception:  # report the phase and go on; the run fails below
            traceback.print_exc()
            smoke.check(False, f"phase {phase.__name__} raised")
        print(f"   ({time.perf_counter() - t0:.1f} s)", flush=True)
    if smoke.check.failed:
        print(f"chip_smoke: {len(smoke.check.failed)} checks failed:",
              file=sys.stderr)
        for what in smoke.check.failed:
            print(f"  {what}", file=sys.stderr)
        return 1
    if len(phases) < len(PHASES):
        # the launch counts of phases that did not run were never read
        print(f"chip_smoke: phases {','.join(phases)} passed; a subset prints no "
              "kernels line and no result")
        return 0
    print(json.dumps({"kernels": smoke.kernel_rows()}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


class Smoke:
    def __init__(self, torch, phases, own_src: bool):
        import numpy as np

        from repro_torch.kernels import build, ops, ref

        self.torch, self.np = torch, np
        self.build_mod, self.ops, self.ref = build, ops, ref
        self.dev = torch.device("cuda")
        # stated, not assumed: fp32 products stay IEEE fp32 (no TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.check = Checks()
        self.gen = torch.Generator(device=self.dev).manual_seed(1234)
        self.tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
        self.store_dir = Path(self.tmp.name) / "samples"
        self.phases = phases
        self.own_src = own_src
        self.rows: dict[str, dict] = {}
        self.main_launches: dict[str, int] = {}
        # flex_attention, the library call of the flash rows at softcap 50:
        # one score_mod and one block mask a window, made once so that the
        # compiled call is not traced again
        self.flex_compiled = None
        self.flex_masks: dict[int, object] = {}
        self.flex_softcap = lambda score, b, h, q_idx, kv_idx: 50.0 * torch.tanh(score / 50.0)
        # the serving tier's paths (foldin, cotrain): their launches apart
        self.path_launches: dict[str, dict[str, int]] = {}

    # ------------------------------------------------------------ helpers
    def sync(self):
        self.torch.cuda.synchronize()

    def cuda_ms(self, fn, reps: int = 5) -> float:
        """Mean device time of fn over reps calls after one warm-up call."""
        fn()
        self.sync()
        start = self.torch.cuda.Event(enable_timing=True)
        end = self.torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    @staticmethod
    def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
        tb, tf = n_bytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
        return (tb, "bytes") if tb >= tf else (tf, "operations")

    @staticmethod
    def _blocks(a, b, axis: int, elems: int = 1 << 26):
        """(a, b) in float64, cut along `axis` into blocks of about `elems`
        entries: a stacked bucket's statistics are ~10 GB in fp32."""
        n = a.shape[axis]
        step = max(1, elems * n // max(a.numel(), 1))
        for i in range(0, n, step):
            m = min(step, n - i)
            yield a.narrow(axis, i, m).double(), b.narrow(axis, i, m).double()

    def max_err(self, a, b, axis: int = 0) -> float:
        return max((float((x - y).abs().max()) for x, y in self._blocks(a, b, axis)
                    if x.numel()), default=0.0)

    def verdict(self, a, b, what: str, tol=TOL, axis: int = 0
                ) -> tuple[bool, str, float]:
        """Whether a and b are allclose at tol, what to print, max abs err."""
        err = self.max_err(a, b, axis)
        ok = all(bool(self.torch.allclose(x, y, **tol))
                 for x, y in self._blocks(a, b, axis))
        return ok, f"{what}: max abs err {err:.3e} ({tol})", err

    def close(self, a, b, what: str, tol=TOL, axis: int = 0) -> float:
        ok, text, err = self.verdict(a, b, what, tol, axis)
        self.check(ok, text)
        return err

    @staticmethod
    def noise_verdict(got, base, ref, what: str, base_name: str) -> tuple[bool, str]:
        """got's distance to the fp32 reference `ref`, in max and in mean,
        within NOISE_FACTOR of `base`'s: no farther from fp32 than the bf16
        noise floor that `base` shows."""
        eg, eb = (got.float() - ref).abs(), (base.float() - ref).abs()
        mg, mb = float(eg.max()), float(eb.max())
        ag, ab = float(eg.mean()), float(eb.mean())
        return (mg <= NOISE_FACTOR * mb and ag <= NOISE_FACTOR * ab,
                f"{what}: max |diff| to fp32 {mg:.3e}, mean {ag:.3e}; {base_name}: "
                f"max {mb:.3e}, mean {ab:.3e} (within {NOISE_FACTOR}x)")

    def randn(self, *shape):
        return self.torch.randn(shape, generator=self.gen, device=self.dev)

    def flex(self, window: int):
        """torch.nn.attention.flex_attention under torch.compile, and the
        keyword arguments with which it computes the flash kernels'
        function at the LM shapes: causal with the window (a block mask),
        softcap 50 (a score_mod), GQA (enable_gqa). For the kernels line's
        library times only: the port never calls it."""
        torch = self.torch
        from torch.nn.attention import flex_attention as fa

        if window not in self.flex_masks:
            def visible(b, h, q_idx, kv_idx):
                seen = q_idx >= kv_idx
                return seen & (q_idx - kv_idx < window) if window else seen
            self.flex_masks[window] = fa.create_block_mask(visible, None, None, LM_SEQ,
                                                           LM_SEQ, device=self.dev)
        if self.flex_compiled is None:
            self.flex_compiled = torch.compile(fa.flex_attention, dynamic=False)
        return self.flex_compiled, dict(score_mod=self.flex_softcap,
                                        block_mask=self.flex_masks[window], enable_gqa=True)

    def add_row(self, name, source, replaces, **kw):
        self.rows[name] = dict(name=name, route="cuda",
                               source=f"src/repro_torch/csrc/{source}",
                               replaces=replaces, **kw)

    def kernel_rows(self) -> list[dict]:
        rows = []
        for name, row in self.rows.items():
            row = dict(row, launches=self.main_launches[name],
                       **{f"{path}_launches": counts[name]
                          for path, counts in self.path_launches.items()})
            rows.append({k: row[k] for k in (
                "name", "route", "source", "replaces", "launches", "max_abs_err",
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")} | row)
        return rows

    # ------------------------------------------------------------ phases
    def build(self):
        torch = self.torch
        line = card_line()
        print(f"card: {line}; {torch.cuda.get_device_name(0)}, capability "
              f"{torch.cuda.get_device_capability(0)}; torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}")
        t0 = time.perf_counter()
        self.build_mod.build_all()
        print(f"built {len(self.build_mod.KERNELS)} kernels in "
              f"{time.perf_counter() - t0:.2f} s (one nvcc per source, in parallel)")
        for name in sorted(set(self.build_mod.KERNELS) - set(self.build_mod.ptxas_log)):
            print(f"  ptxas {name}: built before this run, no compiler output here")
        import re

        entry_re = re.compile(r"Compiling entry function '([^']+)'")
        logs = sorted(self.build_mod.ptxas_log.items())
        kernel = demangle([m.group(1) for _, log in logs for m in entry_re.finditer(log)],
                          self.build_mod._nvcc())
        for name, log in logs:
            entry = "?"
            for text in log.splitlines():
                if m := entry_re.search(text):
                    entry = kernel[m.group(1)]
                elif "Used" in text or "spill" in text:
                    print(f"  ptxas {name} {entry}: {text.replace('ptxas info    :', '').strip()}")

    def data(self):
        from repro_torch.core import GibbsSampler
        from repro_torch.data import chembl_like, train_test_split
        from repro_torch.serve import SeenIndex

        t0 = time.perf_counter()
        ratings, _, _ = chembl_like(scale=1.0, seed=0)
        self.train, self.test = train_test_split(ratings, 0.1, seed=1)
        print(f"chembl_like(scale=1.0): {ratings.shape[0]:,} x {ratings.shape[1]:,}, "
              f"{len(ratings.vals):,} ratings; train {len(self.train.vals):,}, "
              f"test {len(self.test.vals):,} ({time.perf_counter() - t0:.1f} s)")
        self.check(ratings.shape == (483_500, 5_775), "chembl_like is 483,500 x 5,775")
        t0 = time.perf_counter()
        self.sampler = GibbsSampler(self.train, self.test, k=K, burn_in=4,
                                    engine="fused")
        print(f"plans built and placed in {time.perf_counter() - t0:.1f} s")
        for side, plan in (("user", self.sampler.user_plan_host),
                           ("item", self.sampler.item_plan_host)):
            print(f"  {side} plan: padding efficiency "
                  f"{plan.padding_efficiency:.4f}, buckets (width, rows, segments) "
                  f"{[(b.width, b.rows, b.n_segments) for b in plan.buckets]}")
        self.n_buckets = len(self.sampler.user_buckets) + len(self.sampler.item_buckets)
        self.seen = SeenIndex(self.train)

    def _bucket_sides(self, u, v):
        s = self.sampler
        return [("item", b, u) for b in s.item_buckets] + [
            ("user", b, v) for b in s.user_buckets]

    def kernels(self):
        torch, ops, ref = self.torch, self.ops, self.ref
        s = self.sampler
        u = 0.3 * self.randn(s.m, K)
        v = 0.3 * self.randn(s.n, K)
        stacks = {"item": torch.stack([u * (1 + 0.1 * i) for i in range(4)]),
                  "user": torch.stack([v * (1 - 0.1 * i) for i in range(4)])}

        # --- gather_syrk_seg: every bucket of both plans, fp32, bf16, S=4,
        # bit for bit; timed through the wrapper and, for the checkout's own
        # package (the C signature of another's under --src may differ),
        # through the launcher alone, and each identity bucket the narrow
        # path can stage down both of its paths, to show where the
        # threshold lies
        direct = self.own_src
        tot = dict(ms=0.0, plain=0.0, bound=0.0, err=0.0, bytes=0.0, flops=0.0,
                   launcher=0.0)
        for side, b, cp in self._bucket_sides(u, v):
            tag = (f"{side} width {b.width} ({b.indices.shape[0]} rows, "
                   f"{b.n_segments} segments)")
            args = (b.indices, b.values, b.mask, b.seg_ids, b.n_segments)
            kw = dict(identity_segments=b.identity_segments)

            def kern(cp=cp, bf16=False):
                return ops.gather_syrk_seg(*args, cp, bf16_gather=bf16,
                                           seg_ptr=b.seg_ptr, **kw)

            def plain(cp=cp, bf16=False):
                return ref.gather_syrk_seg_ref(*args, cp, bf16_gather=bf16, **kw)

            err = 0.0
            for bf16, stacked in ((False, False), (True, False), (False, True)):
                c = stacks[side] if stacked else cp
                mode = "bf16 gather" if bf16 else "stacked S=4" if stacked else "fp32"
                (pk, rk), (pp, rp) = kern(c, bf16), plain(c, bf16)
                self.sync()
                err = max(err, self.max_err(pk, pp, -3), self.max_err(rk, rp, -2))
                self.check(torch.equal(pk, pp) and torch.equal(rk, rp),
                           f"gather_syrk_seg {tag} {mode}: prec and rhs equal the "
                           "plain version's bit for bit")
                if mode == "fp32":
                    p64, r64 = ref.gather_syrk_seg_ref(
                        b.indices, b.values.double(), b.mask.double(), b.seg_ids,
                        b.n_segments, cp.double(), **kw)
                    ek = max(self.max_err(pk, p64, -3), self.max_err(rk, r64, -2))
                    ep = max(self.max_err(pp, p64, -3), self.max_err(rp, r64, -2))
                    self.check(ek <= ep, f"gather_syrk_seg {tag}: error against "
                               f"float64 {ek:.3e} <= the plain version's {ep:.3e}")
                    del p64, r64
                del pk, rk, pp, rp
            # 20 calls: the small buckets take tens of microseconds
            ms = self.cuda_ms(kern, reps=20)
            pms = self.cuda_ms(plain, reps=3)
            paths = ""
            if direct:
                lms = self.cuda_ms(self.seg_launch(b, cp, ops.SYRK_NARROW_MAX_W), reps=20)
                tot["launcher"] += lms
                paths = f", {lms:.3f} ms launcher alone"
                if b.identity_segments and b.width <= SYRK_STAGE_VECTORS:
                    want = plain()
                    for path, narrow_max in (("narrow", SYRK_STAGE_VECTORS), ("wide", 0)):
                        launch = self.seg_launch(b, cp, narrow_max)
                        got = launch()
                        self.sync()
                        self.check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                                   f"gather_syrk_seg {tag} down the {path} path: bit for bit")
                        del got
                        paths += f", {self.cuda_ms(launch, reps=20):.3f} ms {path} path"
                    del want
            if not b.identity_segments:
                # the row pass and the segment pass of one call, apart
                self._profile(kern, ms, f"gather_syrk_seg {tag}, one call")
            mask = b.mask > 0
            nnz = int(mask.sum())
            distinct = int(torch.unique(b.indices[mask]).numel())
            r, w = b.indices.shape
            n_bytes = (r * w * 12 + r * 4 + distinct * K * 4
                       + b.n_segments * (K * K + K) * 4)
            flops = nnz * SYRK_FLOPS
            bms, by = self.bound_ms(n_bytes, flops)
            print(f"    gather_syrk_seg {tag}: {ms:.3f} ms kernel{paths}, {pms:.3f} ms "
                  f"plain, bound {bms:.3f} ms ({by})")
            for key, val in (("ms", ms), ("plain", pms), ("bound", bms),
                             ("bytes", n_bytes), ("flops", flops)):
                tot[key] += val
            tot["err"] = max(tot["err"], err)
        bms, by = self.bound_ms(tot["bytes"], tot["flops"])
        alone = f", {tot['launcher']:.3f} ms launcher alone" if direct else ""
        print(f"  gather_syrk_seg, one sweep's buckets: {tot['ms']:.3f} ms kernel{alone}, "
              f"{tot['plain']:.3f} ms plain, bound {bms:.3f} ms ({by})")
        self.add_row("gather_syrk_seg", "gather_syrk_seg.cu",
                     "src/repro/kernels/bpmf_gather_syrk.py:149",
                     max_abs_err=tot["err"], ms=tot["ms"], plain_ms=tot["plain"],
                     bound_ms=bms, bound_by=by, library_ms=None,
                     launcher_ms=tot["launcher"] if direct else None,
                     shapes="one fused sweep: every bucket of both plans, fp32, K=64; "
                            "launcher_ms: the kernels alone, without the wrapper")
        del stacks

        # --- masked_syrk: the kernel engine's pre-gathered blocks, every bucket;
        # where the package has a narrow path, each bucket it can stage is
        # also timed down both paths, bits checked: where the threshold lies
        two_paths = hasattr(ops, "SYRK_NARROW_MAX_W")
        tot = dict(ms=0.0, plain=0.0, lib=0.0, err=0.0, bytes=0.0, flops=0.0)
        for side, b, cp in self._bucket_sides(u, v):
            vm = (cp[b.indices.long()] * b.mask[..., None]).contiguous()
            rv = (b.values * b.mask).contiguous()
            tag = f"{side} width {b.width} ({vm.shape[0]} rows)"
            pk, rk = ops.masked_syrk(vm, rv)
            pp, rp = ref.masked_syrk_ref(vm, rv)
            self.sync()
            err = max(self.max_err(pk, pp), self.max_err(rk, rp))
            self.check(torch.equal(pk, pp) and torch.equal(rk, rp),
                       f"masked_syrk {tag}: prec and rhs equal the plain version's "
                       f"bit for bit (max abs err {err:.3e})")
            vt = vm.transpose(1, 2)
            ms = self.cuda_ms(lambda: ops.masked_syrk(vm, rv))
            pms = self.cuda_ms(lambda: ref.masked_syrk_ref(vm, rv), reps=3)
            lms = self.cuda_ms(lambda: (torch.bmm(vt, vm),
                                        torch.bmm(rv[:, None, :], vm)), reps=3)
            r, w, _ = vm.shape
            n_bytes = r * w * (K + 1) * 4 + r * (K * K + K) * 4
            flops = r * w * SYRK_FLOPS
            bms, _ = self.bound_ms(n_bytes, flops)
            paths = ""
            if two_paths and w <= SYRK_STAGE_VECTORS:
                for path, narrow_max in (("narrow", SYRK_STAGE_VECTORS), ("wide", 0)):
                    pw, rw = self.syrk_path(vm, rv, narrow_max)
                    self.sync()
                    self.check(torch.equal(pw, pp) and torch.equal(rw, rp),
                               f"masked_syrk {tag} down the {path} path: bit for bit")
                    del pw, rw
                    t = self.cuda_ms(lambda: self.syrk_path(vm, rv, narrow_max))
                    paths += f", {t:.3f} ms {path} path"
            print(f"    masked_syrk {tag}: {ms:.3f} ms kernel{paths}, {pms:.3f} ms plain, "
                  f"{lms:.3f} ms bmm, bound {bms:.3f} ms")
            for key, val in (("ms", ms), ("plain", pms), ("lib", lms),
                             ("bytes", n_bytes), ("flops", flops)):
                tot[key] += val
            tot["err"] = max(tot["err"], err)
            del vm, vt, rv, pk, rk, pp, rp
        bms, by = self.bound_ms(tot["bytes"], tot["flops"])
        print(f"  masked_syrk, one kernel-engine sweep's buckets: {tot['ms']:.3f} ms "
              f"kernel, {tot['plain']:.3f} ms plain, {tot['lib']:.3f} ms bmm, bound "
              f"{bms:.3f} ms ({by})")
        self.add_row("masked_syrk", "masked_syrk.cu",
                     "src/repro/kernels/bpmf_syrk.py:48",
                     max_abs_err=tot["err"], ms=tot["ms"], plain_ms=tot["plain"],
                     bound_ms=bms, bound_by=by, library_ms=tot["lib"],
                     shapes="one kernel-engine sweep: every bucket of both plans; "
                            "library = 2 bmm per bucket")

        # --- chol_solve_sample: the systems of both half-sweeps (483,500 user
        # and 5,775 item systems) as the sampler builds them, from the state
        # after two fused sweeps: its factors and sampled hyperparameters;
        # and again from the prior hyperparameters and factors of 0.3 N(0, 1),
        # on which the previous kernel's divisions took a slower path. The
        # row holds the sweep's systems; both readings are printed.
        from repro_torch.core.gibbs import posterior_systems
        from repro_torch.core.hyper import init_hyper

        state = s.run(2, seed=0)
        prior = init_hyper(K, device=self.dev)
        systems = {
            "sweep": {"user": (state.v, s.user_buckets, s.m, state.hyper_u),
                      "item": (state.u, s.item_buckets, s.n, state.hyper_v)},
            "prior": {"user": (v, s.user_buckets, s.m, prior),
                      "item": (u, s.item_buckets, s.n, prior)}}
        half = {}
        for origin, sides in systems.items():
            for side, (cp, buckets, n, hyper) in sides.items():
                prec, rhs = posterior_systems(cp, buckets, n, hyper, s.alpha,
                                              engine="fused")
                z = self.randn(n, K)
                tag = f"{tuple(prec.shape)} {side} systems, {origin}"
                xk = ops.chol_solve_sample(prec, rhs, z)
                xp = ref.chol_solve_sample_ref(prec, rhs, z)
                self.sync()
                err = self.close(xk, xp, f"chol_solve_sample on {tag}", CHOL_TOL)
                self.check(torch.equal(ops.chol_solve_sample(prec, rhs, z), xk),
                           f"chol_solve_sample {tag}: the same bits on a second call")
                del xk, xp

                def library(prec=prec, rhs=rhs, z=z):
                    chol, _ = torch.linalg.cholesky_ex(prec)
                    y = torch.linalg.solve_triangular(chol, rhs[..., None], upper=False)
                    return torch.linalg.solve_triangular(chol.transpose(-1, -2),
                                                         y + z[..., None], upper=True)

                ms = self.cuda_ms(lambda: ops.chol_solve_sample(prec, rhs, z))
                pms = self.cuda_ms(lambda: ref.chol_solve_sample_ref(prec, rhs, z), reps=2)
                lms = self.cuda_ms(library, reps=3)
                # a Cholesky reads only the lower triangle; rhs and z in, x out
                bms, by = self.bound_ms(n * (lower_triangle_bytes(K) + 3 * K * 4),
                                        n * (K ** 3 / 3 + 2 * K * K))
                print(f"    chol_solve_sample, {n:,} {side} systems ({origin}): {ms:.3f} "
                      f"ms kernel, {pms:.3f} ms plain, {lms:.3f} ms library, bound "
                      f"{bms:.3f} ms ({by})")
                half[origin, side] = dict(err=err, ms=ms, plain=pms, lib=lms, bound=bms,
                                          by=by)
                del prec, rhs, z
        del state
        # a kernel-engine sweep solves both halves: its row is their sum
        tot = {(origin, key): sum(half[origin, side][key] for side in ("user", "item"))
               for origin in systems for key in ("ms", "plain", "lib", "bound")}
        for origin in systems:
            print(f"  chol_solve_sample, one kernel-engine sweep's two halves ({origin}): "
                  f"{tot[origin, 'ms']:.3f} ms kernel, {tot[origin, 'plain']:.3f} ms plain, "
                  f"{tot[origin, 'lib']:.3f} ms library, bound {tot[origin, 'bound']:.3f} ms")
        self.add_row("chol_solve_sample", "chol_solve.cu",
                     "src/repro/kernels/chol_solve.py:80",
                     max_abs_err=max(h["err"] for h in half.values()),
                     ms=tot["sweep", "ms"], plain_ms=tot["sweep", "plain"],
                     bound_ms=tot["sweep", "bound"], bound_by=half["sweep", "user"]["by"],
                     library_ms=tot["sweep", "lib"],
                     user_half_ms=half["sweep", "user"]["ms"],
                     item_half_ms=half["sweep", "item"]["ms"],
                     user_half_bound_ms=half["sweep", "user"]["bound"],
                     item_half_bound_ms=half["sweep", "item"]["bound"],
                     prior_systems_ms=tot["prior", "ms"],
                     prior_systems_library_ms=tot["prior", "lib"],
                     shapes=f"one kernel-engine sweep: ({s.m}, 64, 64) user and ({s.n}, "
                            "64, 64) item systems of the state after two fused sweeps; "
                            "prior_systems: built from the prior hyperparameters and "
                            "factors of 0.3 N(0, 1); library = cholesky_ex + 2 "
                            "solve_triangular")
        # not positive definite: no error, non-finite exactly where the plain
        # version is, as in the reference kernel
        eye = torch.eye(K, device=self.dev)
        bad = torch.stack([-eye, eye * torch.linspace(-1, 1, K, device=self.dev), 2 * eye])
        ones = torch.ones(3, K, device=self.dev)
        xk = ops.chol_solve_sample(bad, ones, ones)
        xp = ref.chol_solve_sample_ref(bad, ones, ones)
        self.sync()
        fin = torch.isfinite(xp)
        self.check(torch.equal(torch.isfinite(xk), fin)
                   and bool(torch.allclose(xk[fin], xp[fin], **CHOL_TOL)),
                   "chol_solve_sample on systems that are not positive definite: "
                   "finite where the plain version is, and equal there")

    def seg_launch(self, b, cp, narrow_max_w: int):
        """A call of gather_syrk_seg's launcher alone on one bucket's fp32
        statistics, outputs allocated once, outside the launch count: the
        kernels without the wrapper. Returns the call; it returns the
        outputs."""
        torch = self.torch
        r, w = b.indices.shape
        n, k = cp.shape
        p = b.n_segments
        prec = torch.empty((p, k, k), device=self.dev)
        rhs = torch.empty((p, k), device=self.dev)
        rows = ((None, None) if b.identity_segments else
                (torch.empty((r, k, k), device=self.dev, dtype=torch.float64),
                 torch.empty((r, k), device=self.dev, dtype=torch.float64)))
        lib = self.build_mod.library("gather_syrk_seg")
        ptr = None if b.identity_segments else b.seg_ptr.data_ptr()

        def launch():
            err = lib.gather_syrk_seg_launch(
                b.indices.data_ptr(), b.values.data_ptr(), b.mask.data_ptr(),
                cp.data_ptr(), 0, *(None if x is None else x.data_ptr() for x in rows),
                ptr, prec.data_ptr(), rhs.data_ptr(), r, w, n, 1, p, k, narrow_max_w,
                torch.cuda.current_stream().cuda_stream)
            self.build_mod.check("gather_syrk_seg", err)
            return prec, rhs

        return launch

    def syrk_path(self, vm, rv, narrow_max_w: int):
        """masked_syrk's kernel with the narrow path taking rows up to
        narrow_max_w wide (0: none), by a direct call of the launcher,
        outside the launch count."""
        torch = self.torch
        r, w, k = vm.shape
        prec = torch.empty((r, k, k), device=self.dev)
        rhs = torch.empty((r, k), device=self.dev)
        err = self.build_mod.library("masked_syrk").masked_syrk_launch(
            vm.data_ptr(), rv.data_ptr(), prec.data_ptr(), rhs.data_ptr(), r, w, k,
            narrow_max_w, torch.cuda.current_stream().cuda_stream)
        self.build_mod.check("masked_syrk", err)
        return prec, rhs

    def topn(self):
        """topn_scores at serving's shapes: 4,096 users x 5,775 items at
        S*K = 256, with planted ties; k is the candidate count serving
        fetches for seen-item exclusion. Bit for bit against the plain
        version in one slab and in several, and the CUDA kernels one call
        launches, counted in a profile of that call."""
        torch, ops, ref, s = self.torch, self.ops, self.ref, self.sampler
        fetch = min(1 << (TOPK + self.seen.max_degree - 1).bit_length(), s.n)
        uu = self.randn(N_USERS_SERVED, 4 * K)
        vv = self.randn(s.n, 4 * K)
        copy = min(100, s.n - 2)
        for a, b in ((copy, 7), (s.n - 1, 7), (s.n // 2, 1), (s.n // 2 + 1, 1)):
            vv[a] = vv[b]   # planted ties, inside and across the item tiles
        vk, ik = ops.topn_scores(uu, vv, fetch)
        vp, ip = ref.topn_scores_ref(uu, vv, fetch)
        self.sync()
        same = torch.equal(ik, ip) and torch.equal(vk, vp)
        self.check(same, f"topn_scores u {tuple(uu.shape)}, v {tuple(vv.shape)}, "
                   f"k {fetch}: values and indices equal the plain version's bit for bit")
        vk2, ik2 = ops.topn_scores(uu, vv, fetch, slab=TOPN_SLAB)
        self.sync()
        self.check(torch.equal(ik2, ip) and torch.equal(vk2, vp),
                   f"topn_scores over slabs of {TOPN_SLAB} items (a running best "
                   "carried across them): values and indices equal the plain version's "
                   "bit for bit")
        del vk2, ik2
        rows = ik[(ik == 7).any(1) & (ik == copy).any(1)]
        first = (rows == 7).int().argmax(1)
        self.check(rows.shape[0] > 0 and bool(((rows == copy).int().argmax(1)
                                                == first + 1).all()),
                   f"planted ties in the top-{fetch} of {rows.shape[0]} users go "
                   f"to the lowest item index (7 right before its copy {copy})")
        ms = self.cuda_ms(lambda: ops.topn_scores(uu, vv, fetch))
        pms = self.cuda_ms(lambda: ref.topn_scores_ref(uu, vv, fetch), reps=2)
        lms = self.cuda_ms(lambda: torch.topk(uu @ vv.T, fetch, dim=1), reps=5)
        ms_slabs = self.cuda_ms(lambda: ops.topn_scores(uu, vv, fetch, slab=TOPN_SLAB))
        # the CUDA kernels of one call, as the profiler saw them launched,
        # against the slab rule of the wrapper
        b, d = uu.shape
        per_call = {}
        for tag, slab, wall in (("one slab", None, ms), ("slabs of 1,024", TOPN_SLAB,
                                                          ms_slabs)):
            rule = ops.topn_kernel_launches(b, s.n, fetch, slab)

            def topn_kernels(ev):
                return sum(e.count for e in ev if "topn_score_kernel" in e.key
                           or "topn_select_kernel" in e.key)

            # complete: no fewer of top-N's kernels than the rule's
            events = self._profile(lambda: ops.topn_scores(uu, vv, fetch, slab=slab),
                                   wall, f"topn_scores call, {tag}",
                                   complete=lambda ev: topn_kernels(ev) >= rule)
            seen = topn_kernels(events)
            self.check(seen == rule, f"topn_scores, {tag}: the profile shows {seen} CUDA "
                       f"kernels launched in one call, the slab rule says {rule}")
            per_call[tag] = seen
        bms, by = self.bound_ms((b + s.n) * d * 4 + b * fetch * 8, 2.0 * b * s.n * d)
        # mul-then-add issues two fp32 instructions a term where an FMA
        # issues one: twice the operations bound at the same issue rate
        mul_add_ms = 2.0 * (2.0 * b * s.n * d) / FP32_FLOPS * 1e3
        print(f"    topn_scores: {ms:.3f} ms kernel ({per_call['one slab']} CUDA kernels a "
              f"call), {pms:.3f} ms plain, {lms:.3f} ms topk(u @ v.T) ({ms / lms:.2f}x), "
              f"bound {bms:.3f} ms ({by}), mul-then-add bound {mul_add_ms:.3f} ms; "
              f"{TOPN_PREVIOUS_MS / ms:.1f}x faster than the previous kernel's "
              f"{TOPN_PREVIOUS_MS} ms; in slabs of {TOPN_SLAB} items {ms_slabs:.3f} ms "
              f"({per_call['slabs of 1,024']} CUDA kernels a call)")
        self.add_row("topn_scores", "topn.cu", "src/repro/kernels/bpmf_topn.py:81",
                     max_abs_err=self.max_err(vk, vp), ms=ms, plain_ms=pms,
                     bound_ms=bms, bound_by=by, library_ms=lms,
                     mul_add_bound_ms=mul_add_ms,
                     cuda_kernels_per_call=per_call["one slab"],
                     multi_slab_ms=ms_slabs,
                     multi_slab_cuda_kernels_per_call=per_call["slabs of 1,024"],
                     shapes=f"u ({b}, {d}), v ({s.n}, {d}), topk {fetch}; multi-slab: "
                            f"slabs of {TOPN_SLAB} items; library = topk(u @ v.T)")

    def ranks(self):
        """The BPMF kernels at the other ranks the repo runs, against their
        plain versions as at K = 64: every bucket of both plans, bit for bit
        (gather_syrk_seg in fp32, with bf16 gather and over 4 stacked draws,
        masked_syrk on the kernel engine's pre-gathered blocks) and the
        user systems of one half-sweep (chol_solve_sample), with factors
        drawn at each rank."""
        from repro_torch.core.gibbs import posterior_systems
        from repro_torch.core.hyper import init_hyper

        torch, ops, ref, s = self.torch, self.ops, self.ref, self.sampler
        for k in OTHER_RANKS:
            u = 0.3 * self.randn(s.m, k)
            v = 0.3 * self.randn(s.n, k)
            err = {"gather_syrk_seg": 0.0, "masked_syrk": 0.0}
            stacks = {"item": torch.stack([u * (1 + 0.1 * i) for i in range(4)]),
                      "user": torch.stack([v * (1 - 0.1 * i) for i in range(4)])}
            for side, b, cp in self._bucket_sides(u, v):
                args = (b.indices, b.values, b.mask, b.seg_ids, b.n_segments)
                kw = dict(identity_segments=b.identity_segments)
                for mode, c, bf16 in (("fp32", cp, False), ("bf16 gather", cp, True),
                                      ("stacked S=4", stacks[side], False)):
                    pk, rk = ops.gather_syrk_seg(*args, c, seg_ptr=b.seg_ptr,
                                                 bf16_gather=bf16, **kw)
                    pp, rp = ref.gather_syrk_seg_ref(*args, c, bf16_gather=bf16, **kw)
                    self.sync()
                    ok = (torch.equal(pk, pp) and torch.equal(rk, rp)
                          and pk.shape[-3:] == (b.n_segments, k, k))
                    e = max(self.max_err(pk, pp, -3), self.max_err(rk, rp, -2))
                    self.check(ok, f"K={k} gather_syrk_seg {side} width {b.width} {mode}: "
                               f"bit for bit (max abs err {e:.3e})")
                    err["gather_syrk_seg"] = max(err["gather_syrk_seg"], e)
                    del pk, rk, pp, rp
                vm = (cp[b.indices.long()] * b.mask[..., None]).contiguous()
                rv = (b.values * b.mask).contiguous()
                pk, rk = ops.masked_syrk(vm, rv)
                pp, rp = ref.masked_syrk_ref(vm, rv)
                self.sync()
                ok = torch.equal(pk, pp) and torch.equal(rk, rp)
                e = max(self.max_err(pk, pp), self.max_err(rk, rp))
                self.check(ok, f"K={k} masked_syrk {side} width {b.width}: bit for bit "
                           f"(max abs err {e:.3e})")
                err["masked_syrk"] = max(err["masked_syrk"], e)
                del vm, rv, pk, rk, pp, rp
            del stacks
            prec, rhs = posterior_systems(v, s.user_buckets, s.m,
                                          init_hyper(k, device=self.dev), s.alpha,
                                          engine="fused")
            z = self.randn(s.m, k)
            xk = ops.chol_solve_sample(prec, rhs, z)
            xp = ref.chol_solve_sample_ref(prec, rhs, z)
            self.sync()
            err["chol_solve_sample"] = self.close(
                xk, xp, f"K={k} chol_solve_sample on {tuple(prec.shape)} user systems",
                CHOL_TOL)
            ms = self.cuda_ms(lambda: ops.chol_solve_sample(prec, rhs, z))
            print(f"    K={k} chol_solve_sample, {s.m:,} user systems: {ms:.3f} ms kernel")
            self.rows["chol_solve_sample"].setdefault("user_half_ms_other_ranks", {})[k] = ms
            del prec, rhs, z, xk, xp
            eye = torch.eye(k, device=self.dev)
            bad = torch.stack([-eye, eye * torch.linspace(-1, 1, k, device=self.dev),
                               2 * eye])
            ones = torch.ones(3, k, device=self.dev)
            xk = ops.chol_solve_sample(bad, ones, ones)
            xp = ref.chol_solve_sample_ref(bad, ones, ones)
            self.sync()
            fin = torch.isfinite(xp)
            self.check(torch.equal(torch.isfinite(xk), fin)
                       and bool(torch.allclose(xk[fin], xp[fin], **CHOL_TOL)),
                       f"K={k} chol_solve_sample on systems that are not positive "
                       "definite: finite where the plain version is, and equal there")
            for name, e in err.items():
                self.rows[name].setdefault("max_abs_err_other_ranks", {})[k] = e
            print(f"  K={k}: max abs err against the plain versions {err}")

    def train(self):
        from repro_torch.checkpoint import SampleStore
        from repro_torch.core import GibbsSampler

        torch, ops, s = self.torch, self.ops, self.sampler
        torch.cuda.reset_peak_memory_stats()
        store = SampleStore(self.store_dir, keep=8)
        n_sweeps = 8
        ops.reset_launches()                    # the main path starts here
        t0 = time.perf_counter()
        state = s.run(n_sweeps, seed=0, store=store)
        self.sync()
        t_run = time.perf_counter() - t0
        ksampler = GibbsSampler(self.train, self.test, k=K, burn_in=4, engine="kernel")
        kstate, ktimes = state, []
        for _ in range(2):
            t0 = time.perf_counter()
            kstate = ksampler.sweep(kstate)
            self.sync()
            ktimes.append(time.perf_counter() - t0)
        launches = dict(ops.LAUNCHES)           # ... and is read here
        self.kernel_sweep_s = ktimes[-1]
        print(f"fused run of {n_sweeps} sweeps with retention: {t_run:.3f} s; "
              f"kernel-engine sweeps {[round(t, 4) for t in ktimes]} s; "
              f"launches {launches}")
        self.check(launches["gather_syrk_seg"] == self.n_buckets * n_sweeps,
                   f"gather_syrk_seg launched once per bucket per fused sweep "
                   f"({self.n_buckets} x {n_sweeps})")
        self.check(launches["masked_syrk"] == self.n_buckets * 2,
                   f"masked_syrk launched once per bucket per kernel-engine sweep "
                   f"({self.n_buckets} x 2)")
        self.check(launches["chol_solve_sample"] == 2 * 2,
                   "chol_solve_sample launched once per kernel-engine half-sweep (2 x 2)")
        self.check(launches["topn_scores"] == 0, "training launched no top-N kernel")
        self.main_launches.update(launches)
        self.check(store.steps() == list(range(s.burn_in + 1, n_sweeps + 1)),
                   f"retained draws at steps {store.steps()}")
        for name, st in (("fused", state), ("kernel", kstate)):
            self.check(bool(torch.isfinite(st.u).all() and torch.isfinite(st.v).all()),
                       f"{name} factors are finite")
        rmse = s.rmse(state)
        gm = float(self.np.sqrt(self.np.mean((self.test.vals - s.global_mean) ** 2)))
        print(f"posterior-mean test rmse {rmse:.4f} (global-mean predictor {gm:.4f}), "
              f"kernel-engine sample rmse {ksampler.sample_rmse(kstate):.4f}")
        self.check(bool(self.np.isfinite(rmse)), "posterior-mean rmse is finite")

        # steady-state sweep time and where one sweep's device time goes
        times = []
        st = state
        for _ in range(4):
            t0 = time.perf_counter()
            st = s.sweep(st)
            self.sync()
            times.append(time.perf_counter() - t0)
        med = sorted(times)[len(times) // 2]
        peak = torch.cuda.max_memory_allocated() / 1e9
        self.sweep_s, self.peak_gb = med, peak
        print(f"fused sweep seconds {[round(t, 4) for t in times]}; median {med:.4f} s; "
              f"item updates/s {(s.m + s.n) / med:,.0f}; peak device memory {peak:.2f} GB")
        self._profile(lambda: s.sweep(st), med * 1e3)
        self._profile(lambda: ksampler.sweep(kstate), ktimes[-1] * 1e3,
                      "kernel-engine sweep")
        self.state = state

    def _profile(self, fn, wall: float, what: str = "sweep", trace: Path | None = None,
                 complete=bool) -> list:
        """Device time by kernel of one call of fn under torch.profiler; the
        idle share is taken against `wall`, the call's unprofiled time in ms
        (the profiler's own start-up would swamp a wall clock around it).
        Returns the trace's device events, one per kernel name, each with
        its launch count (none where the trace holds no device time).

        fn runs twice: once as the profiler's warm-up step, unrecorded, then
        recorded. Recorded from the start, a profiler session after the
        first in a process can miss the first kernel its window launches
        (on the H100: top-N's score kernel, one of a sweep's). `trace` names
        a file for the recorded call's timeline (a Chrome trace).

        The profiler has dropped a trace's device events on the H100 now
        and then: all of a top-N call's or part of one (1 of 2 kernels,
        9 of 12), or part of a sweep's (364 of 397 kernels; a ring sweep's
        652 of 760). The profiler keeps only device events that it places
        inside its recording window, and a skew between the card's clock
        and the host's can place the call's first or last kernels outside
        it; so the recorded call sits PROFILE_MARGIN_S of idle inside the
        window at each end. A trace that `complete(events)` rejects (by
        default: one without device time) is taken again, up to twice,
        and said so (PERF.md §6)."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile, schedule

        def ready(p):
            traces.append(p.key_averages())
            if trace is not None:
                p.export_chrome_trace(str(trace))

        for attempt in range(3):
            self.sync()
            traces = []
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1),
                         on_trace_ready=ready) as prof:
                for recorded in (False, True):
                    if recorded:
                        time.sleep(PROFILE_MARGIN_S)
                    fn()
                    self.sync()
                    if recorded:
                        time.sleep(PROFILE_MARGIN_S)
                    prof.step()
            # the step's own span ("ProfilerStep*") is no kernel
            events = [e for e in (traces[0] if traces else [])
                      if getattr(e, "device_time_total", 0) > 0
                      and e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.key.startswith("ProfilerStep")]
            if complete(events) or attempt == 2:
                break
            print(f"profiled {what}: the trace holds {sum(e.count for e in events)} "
                  "kernels, cut by the profiler; profiling again")
        busy = sum(e.device_time_total for e in events) / 1e3
        if not events:
            print(f"profiled {what}: no device time in the trace (not measured)")
            return events
        print(f"profiled {what}: {busy:.1f} ms device busy in "
              f"{sum(e.count for e in events)} kernels against {wall:.1f} ms "
              f"unprofiled wall (idle share {max(0.0, 1 - busy / wall):.3f})")
        for e in sorted(events, key=lambda e: -e.device_time_total)[:10]:
            print(f"  {e.device_time_total / 1e3:9.2f} ms  x{e.count:<5d} {e.key[:90]}")
        return events

    def parity(self):
        from repro_torch.core import GibbsSampler
        from repro_torch.core.gibbs import update_factors

        torch, s, st = self.torch, self.sampler, self.state
        plain = GibbsSampler(self.train, self.test, k=K, burn_in=4, engine="einsum")
        noise = s.draw_noise()
        sides = (("item", st.u, s.item_buckets, s.n, st.hyper_v, noise.z_v),
                 ("user", st.v, s.user_buckets, s.m, st.hyper_u, noise.z_u))
        for side, cp, buckets, n, hyper, z in sides:
            want, _ = update_factors(cp, buckets, n, hyper, s.alpha, z=z, engine="einsum")
            for engine in ("fused", "kernel"):
                got, _ = update_factors(cp, buckets, n, hyper, s.alpha, z=z, engine=engine)
                self.sync()
                self.close(got, want, f"{engine} {side} half-sweep against the plain path")
                del got
            del want
        chain = {"fused": st, "plain": st}
        for _ in range(3):
            nz = s.draw_noise()
            chain["fused"] = s.sweep(chain["fused"], nz)
            chain["plain"] = plain.sweep(chain["plain"], nz)
        self.sync()
        for name in ("u", "v"):
            self.close(getattr(chain["fused"], name), getattr(chain["plain"], name),
                       f"3-sweep fused chain {name} against the plain path")
        self.parity_quickstart()

    def parity_quickstart(self):
        """The quickstart's shape and rank (examples/quickstart.py:
        chembl_like(scale=0.01), k = 32, alpha 2.0): both half-sweeps and a
        3-sweep chain of "fused" and of "kernel" against "einsum", under the
        same state and noise."""
        from repro_torch.core import GibbsSampler
        from repro_torch.core.gibbs import update_factors
        from repro_torch.data import chembl_like, train_test_split

        ops, k = self.ops, 32
        ratings, _, _ = chembl_like(scale=0.01, seed=0)
        train, test = train_test_split(ratings, 0.1, seed=1)
        engines = ("einsum", "fused", "kernel")
        samplers = {e: GibbsSampler(train, test, k=k, alpha=2.0, burn_in=8, engine=e)
                    for e in engines}
        plain = samplers["einsum"]
        print(f"chembl_like(scale=0.01) {ratings.shape}, {len(train.vals):,} train "
              f"ratings, k={k}, alpha 2.0")
        ops.reset_launches()
        st = plain.init(seed=0)
        for _ in range(2):                      # a state past the initial draw
            st = plain.sweep(st)
        noise = plain.draw_noise()
        for side, cp, buckets, n, hyper, z in (
                ("item", st.u, plain.item_buckets, plain.n, st.hyper_v, noise.z_v),
                ("user", st.v, plain.user_buckets, plain.m, st.hyper_u, noise.z_u)):
            want, _ = update_factors(cp, buckets, n, hyper, plain.alpha, z=z,
                                     engine="einsum")
            for engine in ("fused", "kernel"):
                got, _ = update_factors(cp, buckets, n, hyper, plain.alpha, z=z,
                                        engine=engine)
                self.sync()
                self.close(got, want, f"k={k} {engine} {side} half-sweep against the "
                           "plain path")
        chain = dict.fromkeys(engines, st)
        for _ in range(3):
            nz = plain.draw_noise()
            for e in engines:
                chain[e] = samplers[e].sweep(chain[e], nz)
        self.sync()
        for e in ("fused", "kernel"):
            for name in ("u", "v"):
                self.close(getattr(chain[e], name), getattr(chain["einsum"], name),
                           f"k={k} 3-sweep {e} chain {name} against the plain path")
        launches = dict(ops.LAUNCHES)
        self.check(all(launches[n] > 0 for n in
                       ("gather_syrk_seg", "masked_syrk", "chol_solve_sample")),
                   f"k={k}: the fused and kernel engines ran their kernels ({launches})")

    def learning(self):
        from repro_torch.core import GibbsSampler
        from repro_torch.data import movielens_like, train_test_split

        np = self.np
        ratings, _, _ = movielens_like(scale=0.05, seed=0)
        train, test = train_test_split(ratings, 0.1, seed=1)
        sampler = GibbsSampler(train, test, k=K, alpha=4.0, burn_in=6, engine="fused")
        t0 = time.perf_counter()
        state = sampler.run(12, seed=0)
        self.sync()
        rmse = sampler.rmse(state)
        gm = float(np.sqrt(np.mean((test.vals - sampler.global_mean) ** 2)))
        print(f"movielens_like(0.05) {ratings.shape}: 12 fused sweeps in "
              f"{time.perf_counter() - t0:.2f} s; posterior-mean rmse {rmse:.4f}, "
              f"global-mean predictor {gm:.4f}")
        self.rmse_learn = rmse
        self.check(rmse <= RMSE_LIMIT, f"posterior-mean rmse {rmse:.4f} <= {RMSE_LIMIT}")

    def serve(self):
        from repro_torch.serve import PosteriorEnsemble, TopNRecommender

        np, torch, ops, s = self.np, self.torch, self.ops, self.sampler
        users = np.sort(np.random.default_rng(0).choice(s.m, N_USERS_SERVED,
                                                        replace=False))
        ops.reset_launches()                    # the main path starts here
        ens = PosteriorEnsemble.load(self.store_dir)
        rec = TopNRecommender(ens)
        vals, items = rec.recommend(users, TOPK, seen=self.seen)
        self.sync()
        launches = dict(ops.LAUNCHES)           # ... and is read here
        print(f"served {len(users)} users from {ens.n_samples} draws "
              f"(S*K = {ens.n_samples * ens.k}); launches {launches}")
        self.check(ens.n_samples == 4 and ens.k == K, "the ensemble holds the 4 retained draws")
        self.check(launches["topn_scores"] == 1 and sum(launches.values()) == 1,
                   "serving launched the top-N kernel once per request batch")
        self.main_launches["topn_scores"] = launches["topn_scores"]
        self.check(vals.shape == items.shape == (len(users), TOPK), "result shape")
        self.check(bool(np.isfinite(vals).all()), "every value is finite")
        self.check(bool(((items >= 0) & (items < s.n)).all()), "every index is in range")
        self.check(not any(np.isin(items[r], self.seen[u]).any()
                           for r, u in enumerate(users)),
                   "no user is recommended an item they rated")
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            rec.recommend(users, TOPK, seen=self.seen)
        dt = (time.perf_counter() - t0) / reps
        print(f"recommend: {dt * 1e3:.1f} ms a batch of {len(users)}, "
              f"{len(users) / dt:,.0f} queries/s (host exclusion included)")
        self.serve_split(rec, users)
        # the plain path: the same draws and calls with every tensor on the CPU
        pens = PosteriorEnsemble.load(self.store_dir, device="cpu")
        pv, pi = TopNRecommender(pens, device="cpu").recommend(users, TOPK, seen=self.seen)
        self.check(np.array_equal(items, pi) and np.array_equal(vals, pv),
                   "top-N values and indices equal the plain path's")
        parts = [f"top-N {len(users) / dt:,.0f} queries/s"]
        if "learning" in self.phases:
            parts.insert(0, f"learning rmse {self.rmse_learn:.4f}")
        if "train" in self.phases:
            parts.insert(0, f"fused sweep {self.sweep_s:.4f} s, "
                            f"{(s.m + s.n) / self.sweep_s:,.0f} item updates/s, peak "
                            f"{self.peak_gb:.2f} GB")
        print(f"summary: {'; '.join(parts)}")

    def serve_split(self, rec, users, reps: int = 5):
        """Where one recommend() batch's time goes: the top-N kernel's
        device time (CUDA events around each launch), the rest of scoring
        and fetching (row gather, launch, copy back: the same call without
        exclusion lists), and the host's exclusion and merge (the
        difference). Medians of `reps` batches, on a line of its own."""
        import statistics

        torch, ops = self.torch, self.ops
        real, events = ops.topn_scores, []

        def timed(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real(*a, **kw)
            end.record()
            events.append((start, end))
            return out

        hint = TOPK + self.seen.max_degree
        walls = {"recommend": [], "no exclusion": []}
        ops.topn_scores = timed
        try:
            for _ in range(reps):
                for name, call in (
                        ("recommend", lambda: rec.recommend(users, TOPK, seen=self.seen)),
                        ("no exclusion", lambda: rec._serve(TOPK, user_ids=users,
                                                           fetch_hint=hint))):
                    self.sync()
                    t0 = time.perf_counter()
                    call()
                    walls[name].append((time.perf_counter() - t0) * 1e3)
        finally:
            ops.topn_scores = real
        self.sync()
        kernel = statistics.median(a.elapsed_time(b) for a, b in events)
        total = statistics.median(walls["recommend"])
        fetch = statistics.median(walls["no exclusion"])
        split = dict(batch_ms=total, kernel_device_ms=kernel,
                     gather_launch_copy_ms=fetch - kernel,
                     host_exclusion_merge_ms=total - fetch,
                     users=len(users), topk=TOPK, fetch_hint=hint)
        print(f"serve split: one recommend() batch of {len(users)} users {total:.3f} ms = "
              f"top-N kernel {kernel:.3f} ms on the card + {fetch - kernel:.3f} ms row "
              f"gather, launch and copy back + {total - fetch:.3f} ms host exclusion and "
              f"merge (medians of {reps}) {json.dumps(split)}")
        self.serve_split_numbers = split

    # ------------------------------------------------------------ the serving tier
    def _cold_batch(self, users, shift: int = 0):
        """The training ratings of `users` as a batch of new users (row b is
        users[b]); `shift` moves every item id by that many places (mod N):
        fresh items, the same rating-count profile."""
        np = self.np
        from repro_torch.data import SparseRatings

        indptr, cols, vals = self._train_csr()
        counts = indptr[users + 1] - indptr[users]
        take = np.concatenate([np.arange(indptr[u], indptr[u + 1]) for u in users])
        rows = np.repeat(np.arange(len(users)), counts).astype(np.int32)
        items = ((cols[take] + shift) % self.sampler.n).astype(np.int32)
        return SparseRatings(rows, items, vals[take].astype(np.float32),
                             (len(users), self.sampler.n))

    def _train_csr(self):
        """The training ratings by user, (indptr, items, values)."""
        if not hasattr(self, "train_csr"):
            from repro_torch.data import csr_from_coo

            self.train_csr = csr_from_coo(self.train.rows, self.train.cols,
                                          self.train.vals, self.sampler.m)
        return self.train_csr

    def _recorded(self):
        """A context that records, outermost call only, each BPMF kernel
        wrapper's arguments and outputs: [(name, args, kwargs, out)]."""
        import contextlib

        ops = self.ops

        @contextlib.contextmanager
        def ctx():
            calls, depth, saved = [], [0], {}
            for name in FOLDIN_KERNELS:
                real = saved[name] = getattr(ops, name)

                def rec(*a, _real=real, _name=name, **kw):
                    depth[0] += 1
                    try:
                        out = _real(*a, **kw)
                    finally:
                        depth[0] -= 1
                    if depth[0] == 0:   # the wrappers recurse on leading axes
                        calls.append((_name, a, kw, out))
                    return out
                setattr(ops, name, rec)
            try:
                yield calls
            finally:
                for name, real in saved.items():
                    setattr(ops, name, real)
        return ctx()

    def _kernel_verdicts(self, calls, tag: str) -> list[tuple[bool, str]]:
        """Each recorded launch against its plain version on its own inputs:
        the syrk kernels bit for bit, the solve within 2e-3 and the same
        bits on a second call (that call is not counted: it runs after the
        path's counts are read)."""
        torch, ref, ops = self.torch, self.ref, self.ops
        out = []
        for name, a, kw, got in calls:
            if name == "gather_syrk_seg":
                want = ref.gather_syrk_seg_ref(*a, bf16_gather=kw["bf16_gather"],
                                               identity_segments=kw["identity_segments"])
                ok = all(torch.equal(g, w) for g, w in zip(got, want))
                out.append((ok, f"{tag}: gather_syrk_seg {tuple(a[0].shape)} over "
                                f"{a[5].shape[0]} draws equals its plain version bit "
                                "for bit"))
            elif name == "masked_syrk":
                vm, rv = a
                want = ref.masked_syrk_ref(vm.reshape((-1,) + vm.shape[-2:]),
                                           rv.reshape((-1, rv.shape[-1])))
                ok = all(torch.equal(g.reshape(w.shape), w) for g, w in zip(got, want))
                out.append((ok, f"{tag}: masked_syrk {tuple(vm.shape)} (draws folded "
                                "into rows) equals its plain version bit for bit"))
            else:
                prec, rhs, z = a
                k = prec.shape[-1]
                want = ref.chol_solve_sample_ref(prec.reshape(-1, k, k),
                                                 rhs.reshape(-1, k), z.reshape(-1, k))
                g = got.reshape(want.shape)
                ok, text, _ = self.verdict(g, want, f"{tag}: chol_solve_sample over "
                                           f"{want.shape[0]:,} systems ({tuple(prec.shape[:-2])})",
                                           CHOL_TOL)
                again = ops.chol_solve_sample(prec, rhs, z)
                out.append((ok and bool(torch.equal(again, got)),
                            text + ", the same bits on a second call"))
        return out

    def foldin_verdicts(self, batches: dict, *, clones: bool = True
                        ) -> tuple[list[tuple[bool, str]], dict]:
        """Fold each cold batch in through engines fused and kernel (plan
        cache on, explicit noise) and through the plain path (einsum, exact
        shapes); hold the kernels each call launched against their plain
        versions on those inputs, the three outputs to each other, and the
        ChEMBL clones' predictions against the trained ensemble. Returns the
        verdicts and, per (batch, engine), the recorded calls."""
        from repro_torch.serve import fold_in

        ens, cache = self.foldin_ens, self.foldin_cache
        verdicts, recorded = [], {}
        for b, ratings in batches.items():
            z = self.foldin_z[:, :b]
            plain = fold_in(None, ratings, ens, z=z, engine="einsum")
            for engine in FOLDIN_ENGINES:
                with self._recorded() as calls:
                    got = fold_in(None, ratings, ens, z=z, engine=engine,
                                  plan_cache=cache)
                self.sync()
                recorded[b, engine] = (calls, got)
                ok, text, _ = self.verdict(got, plain, f"fold-in B={b} {engine} "
                                           "against the plain path")
                verdicts.append((ok, text))
            verdicts.append(self.verdict(recorded[b, "fused"][1], recorded[b, "kernel"][1],
                                         f"fold-in B={b} fused against kernel")[:2])
        if clones:
            verdicts += self.clone_verdicts()
        return verdicts, recorded

    def clone_verdicts(self) -> list[tuple[bool, str]]:
        """Clones of the 64 best-constrained users, folded in with
        sample=False through the fused engine, against the trained ensemble
        on each of their training items (after
        tests/test_serve.py::test_foldin_clone_matches_trained_user).

        A trained user's draw u^s was sampled from exactly the conditional
        the fold-in solves, so the difference d of the two predictions is
        that draw's own noise, of variance sum_s v^T Lambda_s^-1 v / S^2,
        computed here in float64 from the draws. The chain at alpha 1.5
        learns little in 8 sweeps (ROADMAP.md queue 3): Lambda_u is large
        and the predictions sit close to the global mean, so the noise's
        tails pass 0.25 on single items. The check holds the RMS of d to
        FOLDIN_CLONE_ATOL, and d / sigma to the standard normal it must be:
        RMS within CLONE_Z_RMS, no value beyond CLONE_Z_MAX."""
        torch, np = self.torch, self.np
        from repro_torch.serve import fold_in

        ens = self.foldin_ens
        indptr = self._train_csr()[0]
        best = np.argsort(-np.diff(indptr), kind="stable")[:64]
        clones = self._cold_batch(best)
        u = fold_in(None, clones, ens, sample=False, engine="fused")
        users = best[clones.rows]
        want, _ = ens.score(users, clones.cols)
        got, _ = ens.score_factors(u[:, clones.rows], clones.cols)
        d = (got - want).double()
        var = torch.zeros_like(d)
        s_n = ens.n_samples
        for b in range(len(best)):
            m = torch.as_tensor(clones.rows == b, device=d.device)
            for s in range(s_n):
                v = ens.v[s, clones.cols[clones.rows == b]].double()
                prec = ens.hyper_u_lam[s].double() + ens.alpha * v.T @ v
                var[m] += (torch.linalg.solve(prec, v.T).T * v).sum(1) / s_n ** 2
        z = d / var.sqrt()
        rms, zrms, zmax = (float(d.pow(2).mean().sqrt()), float(z.pow(2).mean().sqrt()),
                           float(z.abs().max()))
        deg = np.diff(indptr)[best]
        return [(rms <= FOLDIN_CLONE_ATOL and CLONE_Z_RMS[0] <= zrms <= CLONE_Z_RMS[1]
                 and zmax <= CLONE_Z_MAX,
                 f"fold-in clones of the 64 best-constrained users ({len(users):,} "
                 f"ratings, degrees {int(deg.min())}-{int(deg.max())}) predict their "
                 f"items: |diff| RMS {rms:.3e} (<= {FOLDIN_CLONE_ATOL}), max "
                 f"{float(d.abs().max()):.3e}; diff / sigma RMS {zrms:.3f} (in "
                 f"{CLONE_Z_RMS}), max {zmax:.2f} (<= {CLONE_Z_MAX}); the trained "
                 f"predictions' spread {float(want.std()):.3e}")]

    def foldin(self):
        """Cold-start fold-in at the ChEMBL shape: 4,096 users drawn with
        seed 0, their training ratings as new users, against the 4 retained
        draws, in batches of 256 and 4,096."""
        import statistics

        torch, np, ops = self.torch, self.np, self.ops
        from repro_torch.serve import FoldInPlanCache, PosteriorEnsemble, fold_in
        from repro_torch.serve import foldin as foldin_mod

        s = self.sampler
        users = np.sort(np.random.default_rng(0).choice(s.m, max(FOLDIN_BATCHES),
                                                        replace=False))
        self.foldin_ens = ens = PosteriorEnsemble.load(self.store_dir)
        self.foldin_cache = FoldInPlanCache()
        self.foldin_z = torch.randn((ens.n_samples, max(FOLDIN_BATCHES), ens.k),
                                    generator=self.gen, device=self.dev)
        batches = {b: self._cold_batch(users[:b]) for b in FOLDIN_BATCHES}
        for b, r in batches.items():
            print(f"  cold batch B={b}: {r.nnz:,} ratings, "
                  f"{int((np.bincount(r.rows, minlength=b) == 0).sum())} users with none")
        ops.reset_launches()                    # the fold-in path starts here
        verdicts, recorded = self.foldin_verdicts(batches, clones=False)
        launches = ops.launches()               # ... and is read here
        self.path_launches["foldin"] = launches
        print(f"fold-in path launches {launches}")
        for name in FOLDIN_KERNELS:
            self.check(launches[name] > 0, f"the fold-in path launched {name}")
        for ok, what in verdicts + self._all_kernel_verdicts(recorded) + self.clone_verdicts():
            self.check(ok, what)
        # the plan cache: a second batch of each profile misses no schema
        misses = foldin_mod.trace_count()
        for b in FOLDIN_BATCHES:
            for engine in FOLDIN_ENGINES:
                fold_in(None, self._cold_batch(users[:b], shift=1), ens, sample=False,
                        engine=engine, plan_cache=self.foldin_cache)
        self.check(foldin_mod.trace_count() == misses,
                   f"a second batch of each profile missed no plan schema "
                   f"({self.foldin_cache.stats()})")
        # per batch: wall ms (median of 5 after a warm-up), launches, peak memory
        self.foldin_numbers = {}
        for b, ratings in batches.items():
            z = self.foldin_z[:, :b]
            for engine in FOLDIN_ENGINES + ("einsum",):
                cache = self.foldin_cache if engine != "einsum" else None

                def call():
                    fold_in(None, ratings, ens, z=z, engine=engine, plan_cache=cache)
                    self.sync()

                call()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                times = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    call()
                    times.append((time.perf_counter() - t0) * 1e3)
                peak = (torch.cuda.max_memory_allocated() - base) / 1e6
                ms = statistics.median(times)
                per_call = ({} if engine == "einsum" else
                            {n: sum(c[0] == n for c in recorded[b, engine][0])
                             for n in FOLDIN_KERNELS})
                self.foldin_numbers[b, engine] = dict(ms=ms, peak_mb=peak,
                                                      launches=per_call)
                print(f"  fold-in B={b:5d} {engine:6s}: {ms:8.3f} ms (median of 5), "
                      f"kernel launches {per_call or 'none (plain path)'}, peak "
                      f"{peak:.1f} MB above the resident {base / 1e9:.2f} GB")
        self.foldin_split(batches[max(FOLDIN_BATCHES)])
        self.foldin_rows(recorded[max(FOLDIN_BATCHES), "fused"][0]
                         + recorded[max(FOLDIN_BATCHES), "kernel"][0])

    def _all_kernel_verdicts(self, recorded) -> list[tuple[bool, str]]:
        out = []
        for (b, engine), (calls, _) in recorded.items():
            out += self._kernel_verdicts(calls, f"fold-in B={b} {engine}")
        return out

    def foldin_split(self, ratings):
        """Where one B=4,096 fused fold-in goes: host planning (the bucket
        plan, the cache's padding, the upload), and the device time by
        kernel of the call (profile)."""
        from repro_torch.core.buckets import pad_bucket
        from repro_torch.core.gibbs import device_plan
        from repro_torch.serve import foldin as foldin_mod

        ens, cache = self.foldin_ens, self.foldin_cache
        t0 = time.perf_counter()
        buckets = foldin_mod._plan(ratings, ens, cache.widths).buckets
        _, targets = cache.schema(tuple((b.width, b.rows, b.n_segments) for b in buckets),
                                  ratings.shape[0], ens.n_items)
        device_plan([pad_bucket(b, rows, segs) for b, (_, rows, segs)
                     in zip(buckets, targets)], self.dev)
        self.sync()
        host_ms = (time.perf_counter() - t0) * 1e3
        wall = self.foldin_numbers[ratings.shape[0], "fused"]["ms"]
        events = self._profile(
            lambda: foldin_mod.fold_in(None, ratings, ens, z=self.foldin_z, engine="fused",
                                       plan_cache=cache),
            wall, f"fused fold-in of B={ratings.shape[0]}")
        busy = sum(e.device_time_total for e in events) / 1e3
        kern = sum(e.device_time_total for e in events
                   if "gather_syrk" in e.key or "segment_reduce" in e.key) / 1e3
        print(f"fold-in split: B={ratings.shape[0]} fused {wall:.3f} ms wall = host "
              f"planning, padding and upload {host_ms:.3f} ms, then {wall - host_ms:.3f} ms "
              f"of launches and device work ({busy:.3f} ms device busy in the profile, "
              f"of it the gather_syrk_seg kernels {kern:.3f} ms)")

    def foldin_rows(self, calls):
        """The kernels line's fold-in numbers: each kernel's launches of one
        B=4,096 fold-in (fused and kernel engines), timed again on their
        recorded inputs (outside the counted run), beside the plain version
        and the bound."""
        torch, ops, ref = self.torch, self.ops, self.ref
        tot = {}
        for name, a, kw, _ in calls:
            t = tot.setdefault(name, dict(ms=0.0, plain=0.0, lib=None, bytes=0.0,
                                          flops=0.0, n=0))
            t["n"] += 1
            if name == "gather_syrk_seg":
                idx, _, mask, _, n_seg, v = a
                t["ms"] += self.cuda_ms(lambda: ops.gather_syrk_seg(*a, **kw))
                t["plain"] += self.cuda_ms(lambda: ref.gather_syrk_seg_ref(
                    *a, bf16_gather=kw["bf16_gather"],
                    identity_segments=kw["identity_segments"]), reps=2)
                m = mask > 0
                s, k = v.shape[0], v.shape[-1]
                distinct = int(torch.unique(idx[m]).numel())
                r, w = idx.shape
                t["bytes"] += (r * w * 12 + r * 4 + s * distinct * k * 4
                               + s * n_seg * (k * k + k) * 4)
                t["flops"] += s * int(m.sum()) * SYRK_FLOPS
            elif name == "masked_syrk":
                vm, rv = a
                t["ms"] += self.cuda_ms(lambda: ops.masked_syrk(vm, rv))
                vm3 = vm.reshape((-1,) + vm.shape[-2:])
                rv2 = rv.reshape((-1, rv.shape[-1])).contiguous()
                t["plain"] += self.cuda_ms(lambda: ref.masked_syrk_ref(vm3, rv2), reps=2)
                vt = vm3.transpose(1, 2)
                t["lib"] = (t["lib"] or 0.0) + self.cuda_ms(
                    lambda: (torch.bmm(vt, vm3), torch.bmm(rv2[:, None, :], vm3)), reps=3)
                r, w, k = vm3.shape
                t["bytes"] += r * w * (k + 1) * 4 + r * (k * k + k) * 4
                t["flops"] += r * w * SYRK_FLOPS
            else:
                prec, rhs, z = a
                k = prec.shape[-1]
                p3, r2, z2 = prec.reshape(-1, k, k), rhs.reshape(-1, k), z.reshape(-1, k)
                t["ms"] += self.cuda_ms(lambda: ops.chol_solve_sample(prec, rhs, z))
                t["plain"] += self.cuda_ms(lambda: ref.chol_solve_sample_ref(p3, r2, z2),
                                           reps=2)

                def library():
                    chol, _ = torch.linalg.cholesky_ex(p3)
                    y = torch.linalg.solve_triangular(chol, r2[..., None], upper=False)
                    return torch.linalg.solve_triangular(chol.transpose(-1, -2),
                                                         y + z2[..., None], upper=True)

                t["lib"] = (t["lib"] or 0.0) + self.cuda_ms(library, reps=3)
                n = p3.shape[0]
                t["bytes"] += n * (lower_triangle_bytes(k) + 3 * k * 4)
                t["flops"] += n * (k ** 3 / 3 + 2 * k * k)
        for name, t in tot.items():
            bms, by = self.bound_ms(t["bytes"], t["flops"])
            lib = "" if t["lib"] is None else f", {t['lib']:.3f} ms library"
            print(f"  fold-in B=4,096, {name}: {t['n']} launches {t['ms']:.3f} ms kernel, "
                  f"{t['plain']:.3f} ms plain{lib}, bound {bms:.3f} ms ({by})")
            self.rows.setdefault(name, {}).update(foldin_ms=t["ms"], foldin_plain_ms=t["plain"],
                                   foldin_library_ms=t["lib"], foldin_bound_ms=bms,
                                   foldin_bound_by=by, foldin_calls_per_batch=t["n"])

    # ------------------------------------------------------------ co-train
    def cotrain(self):
        """Train while serving at the ChEMBL shape: a trainer thread goes on
        from phase train's chain for COTRAIN_SWEEPS sweeps (burn-in 4) and
        publishes each retained draw into a channel (window 4), which a
        4-host, 2-replica tier attached to it (one host killed mid-publish)
        and a RecommendFrontend(n_hosts=4, replicas=2) adopt while request
        threads send user ids (seen items excluded) and cold-start ratings."""
        import statistics
        import threading

        np, ops, s = self.np, self.ops, self.sampler
        from repro_torch.serve import (
            ClusterCoordinator,
            FaultEvent,
            FaultPlan,
            PosteriorEnsemble,
            PublicationChannel,
            RecommendFrontend,
            TopNRecommender,
        )
        from repro_torch.serve.faults import DEAD

        boot = PosteriorEnsemble.load(self.store_dir)
        ch = PublicationChannel(window=4)
        for d in boot.samples:   # the trained window: the tier starts at its epoch
            ch.publish(d.step, {k: getattr(d, k) for k in SAMPLE_FIELDS})
        plan = FaultPlan([FaultEvent(seam="stage", action="kill", host=COTRAIN_VICTIM)])
        rng = np.random.default_rng(3)
        cold_users = rng.choice(s.m, 64, replace=False)
        cold = self._cold_batch(cold_users)
        cold_reqs = [(cold.cols[cold.rows == b], cold.vals[cold.rows == b])
                     for b in range(len(cold_users))]

        ops.reset_launches()                    # the co-train path starts here
        tier = ClusterCoordinator(boot, n_hosts=4, replicas=2, channel=ch, faults=plan)
        fe = RecommendFrontend(channel=ch, seen=self.train, n_hosts=4, replicas=2,
                               max_batch=COTRAIN_BATCH, engine="fused")
        stop, errors = threading.Event(), []
        served = {"warm": [], "cold": []}       # per thread: [(epoch, n), ...]
        trained = {}

        def trainer():
            try:
                t0 = time.perf_counter()
                trained["state"] = s.run(COTRAIN_SWEEPS, state=self.state, publish=ch)
                self.sync()
                trained["s"] = time.perf_counter() - t0
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)
            finally:
                ch.close()

        def requests(kind):
            r = np.random.default_rng({"warm": 1, "cold": 2}[kind])
            try:
                while not stop.is_set():
                    if kind == "warm":
                        for u in r.integers(0, s.m, COTRAIN_BATCH):
                            fe.submit(int(u), topk=TOPK)
                    else:
                        for i in r.integers(0, len(cold_reqs), COTRAIN_COLD):
                            fe.submit_ratings(*cold_reqs[i], topk=TOPK)
                    res = fe.flush()   # may hold the other thread's requests too
                    if res:
                        served[kind].append((min(x.epoch for x in res),
                                             max(x.epoch for x in res), len(res)))
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)

        threads = [threading.Thread(target=trainer, name="trainer")] + [
            threading.Thread(target=requests, args=(k,), name=f"requests-{k}")
            for k in ("warm", "cold")]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        threads[0].join(timeout=600)
        last = ch.epoch
        fresh_ok = tier.wait_epoch(last, timeout=120) and fe.wait_epoch(last, timeout=120)
        stop.set()
        for t in threads[1:]:
            t.join(timeout=120)
        wall = time.perf_counter() - t0
        self.sync()
        launches = ops.launches()               # ... and is read here
        self.path_launches["cotrain"] = launches
        tier.close()
        fe.close()
        for e in errors:
            traceback.print_exception(e)
        self.check(not errors and not any(t.is_alive() for t in threads),
                   f"trainer and request threads ended cleanly ({len(errors)} errors)")
        self.check(fresh_ok, f"tier and frontend adopted the last publish, epoch {last}")
        n_pub = ch.seq - len(boot.samples)
        n_req = sum(n for v in served.values() for *_, n in v)
        qps = n_req / wall
        lat = fe.latency_percentiles()
        fresh = tier.freshness_percentiles()
        swap = np.percentile(np.asarray(fe.publish_to_swap_s), [50, 99]) * 1e3
        sweep_s = trained.get("s", float("nan")) / COTRAIN_SWEEPS
        print(f"co-train: {COTRAIN_SWEEPS} sweeps, {n_pub} publishes (epochs "
              f"{boot.epoch + 1}-{last}), {n_req:,} requests in {wall:.2f} s -> "
              f"{qps:,.0f} queries/s; launches {launches}")
        print(f"  request p50 {lat['p50'] * 1e3:.2f} ms, p99 {lat['p99'] * 1e3:.2f} ms; "
              f"publish -> all-shards-fresh p50 {fresh['p50'] * 1e3:.1f} ms, p99 "
              f"{fresh['p99'] * 1e3:.1f} ms ({tier.commits} commits); publish -> "
              f"frontend swap p50 {swap[0]:.1f} ms, p99 {swap[1]:.1f} ms "
              f"({fe.swaps} swaps, {fe.rebinds} rebinds)")
        train_s = getattr(self, "sweep_s", float("nan"))
        print(f"  sweep while serving {sweep_s:.4f} s (wall of the trainer's run / "
              f"{COTRAIN_SWEEPS}, publishes' host copies included) against phase "
              f"train's {train_s:.4f} s")
        for kind, seq in served.items():
            lo = [e for e, _, _ in seq]
            self.check(bool(seq) and lo == sorted(lo) and all(a <= b for a, b, _ in seq),
                       f"{kind} requests: served epochs monotone over {len(seq)} flushes "
                       f"({lo[0] if lo else None} -> {seq[-1][1] if seq else None})")
        stats = tier.stats()
        self.check(tier.epoch == last and tier.commits >= 1,
                   f"every publish committed: the tier's last commit is the last "
                   f"publish, epoch {last} ({tier.commits} commits for {n_pub} publishes; "
                   "a host skips to the newest publish it sees)")
        self.check(tier.health.state(COTRAIN_VICTIM) == DEAD and bool(plan.fired_log),
                   f"host {COTRAIN_VICTIM} was killed mid-publish (seam stage)")
        self.check(stats["n_hosts"] == 4 and stats["reassignments"] == 0,
                   f"the tier kept its 4 hosts and rebuilt no shard "
                   f"(replicas 2 carry one lost host): {stats['n_hosts']} hosts, "
                   f"{stats['reassignments']} reassignments, "
                   f"{stats['gather_failovers']} gather failovers")
        self.check(launches["topn_scores"] > 0 and launches["gather_syrk_seg"] > 0,
                   "the co-train path launched top-N (serving) and gather_syrk_seg "
                   "(training, cold-start fold-in)")
        # after the last commit: the tier and the frontend against one host
        users = np.sort(np.random.default_rng(0).choice(s.m, N_USERS_SERVED,
                                                        replace=False))
        single = TopNRecommender(tier.ensemble)
        wv, wi = single.recommend(users, TOPK, seen=self.seen)
        tv, ti = tier.recommend(users, TOPK, seen=self.seen)
        self.check(tier.ensemble.epoch == last and np.array_equal(ti, wi)
                   and np.array_equal(tv, wv),
                   f"after the last commit the tier's top-N for {len(users):,} users "
                   "equals a single-host TopNRecommender on the committed ensemble, "
                   "bit for bit")
        for u in users:
            fe.submit(int(u), topk=TOPK)
        res = sorted(fe.flush(), key=lambda x: x.ticket)
        fi = np.stack([x.items for x in res])
        fv = np.stack([x.scores for x in res])
        self.check(all(x.epoch == last for x in res) and np.array_equal(fi, wi)
                   and np.array_equal(fv, wv),
                   f"the frontend serves the same {len(users):,} users bit for bit at "
                   f"epoch {last}")
        self.tier_topn(tier, users[:COTRAIN_BATCH])
        self.cotrain_numbers = dict(
            queries_per_s=qps, requests=n_req, wall_s=wall, request_p50_ms=lat["p50"] * 1e3,
            request_p99_ms=lat["p99"] * 1e3, fresh_p50_ms=fresh["p50"] * 1e3,
            fresh_p99_ms=fresh["p99"] * 1e3, swap_p50_ms=float(swap[0]),
            swap_p99_ms=float(swap[1]), sweep_s_serving=sweep_s, sweep_s_train=train_s,
            publishes=n_pub, commits=tier.commits, swaps=fe.swaps, rebinds=fe.rebinds,
            gather_failovers=stats["gather_failovers"])
        print(f"co-train numbers {json.dumps(self.cotrain_numbers)}")
        self.cotrain_draws = ch.snapshot().draws
        for ok, what in self.barrier_verdicts():
            self.check(ok, what)
        t0 = time.perf_counter()
        s.sample_dict(trained["state"])
        print(f"  one publish's copy off the card (sample_dict): "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms")

    def tier_topn(self, tier, users):
        """topn_scores at one shard host's shapes in the co-train tier: a
        warm flush's rows against shard 0 of 2 (2,888 items), k the fetch
        the seen-item exclusion asks for; bit for bit against its plain
        version on those inputs, timed beside its bound and topk(u @ v.T)."""
        torch, ops, ref = self.torch, self.ops, self.ref
        _, binding = tier._snapshot()[2][0]
        rows = binding.u_replica[torch.as_tensor(users, device=self.dev)]
        v = binding.v_shard
        fetch = 1 << (TOPK + self.seen.max_degree - 1).bit_length()
        k = min(fetch, v.shape[0])
        got, want = ops.topn_scores(rows, v, k), ref.topn_scores_ref(rows, v, k)
        self.sync()
        self.check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                   f"topn_scores at a shard host's shapes, u {tuple(rows.shape)}, v "
                   f"{tuple(v.shape)}, k {k}: equal to the plain version bit for bit")
        ms = self.cuda_ms(lambda: ops.topn_scores(rows, v, k))
        pms = self.cuda_ms(lambda: ref.topn_scores_ref(rows, v, k), reps=2)
        lms = self.cuda_ms(lambda: torch.topk(rows @ v.T, k, dim=1))
        b, d = rows.shape
        bms, by = self.bound_ms((b + v.shape[0]) * d * 4 + b * k * 8,
                                2.0 * b * v.shape[0] * d)
        print(f"  topn_scores at a shard host's shapes: {ms:.3f} ms kernel, {pms:.3f} ms "
              f"plain, {lms:.3f} ms topk(u @ v.T), bound {bms:.3f} ms ({by})")
        self.rows.setdefault("topn_scores", {}).update(
            cotrain_ms=ms, cotrain_plain_ms=pms, cotrain_library_ms=lms,
            cotrain_bound_ms=bms, cotrain_bound_by=by,
            cotrain_shapes=f"u ({b}, {d}), v ({v.shape[0]}, {d}), topk {k}: one shard "
                           "host of the 4-host, 2-replica tier")

    def barrier_verdicts(self) -> list[tuple[bool, str]]:
        """The quorum barrier at full size: a 4-host, 2-replica tier booted
        on the co-trained window's first three draws; the fourth is published
        while both owners of shard 1 hang mid-stage. The epoch must hold,
        serving the old one, until they are released; then it commits."""
        import threading

        np = self.np
        from repro_torch.serve import (
            ClusterCoordinator,
            FaultEvent,
            FaultPlan,
            PosteriorEnsemble,
            PublicationChannel,
            TopNRecommender,
        )

        draws = self.cotrain_draws
        ch = PublicationChannel(window=3)
        for d in draws[:3]:
            ch.publish(d.step, {k: getattr(d, k) for k in SAMPLE_FIELDS})
        old = PosteriorEnsemble(ch.snapshot().draws)
        plan = FaultPlan([FaultEvent(seam="stage", action="hang", host=h) for h in (1, 3)],
                         hang_timeout=120)
        tier = ClusterCoordinator(old, n_hosts=4, replicas=2, channel=ch, faults=plan)
        users = np.arange(N_USERS_SERVED)
        out = []
        try:
            ch.publish(draws[3].step, {k: getattr(draws[3], k) for k in SAMPLE_FIELDS})
            deadline, tick = time.monotonic() + 120, threading.Event()
            while time.monotonic() < deadline and not (
                    plan.hanging == {1, 3}
                    and (tier.epoch > old.epoch
                         or set(tier.stats()["quorum"][0]["staged"].values())
                         == {draws[3].step})):
                tick.wait(0.01)
            out.append((plan.hanging == {1, 3},
                        "barrier: both owners of shard 1 hang mid-stage"))
            held = tier.epoch
            ov, oi = TopNRecommender(old).recommend(users, TOPK)
            tv, ti = tier.recommend(users, TOPK)
            out.append((held == old.epoch and np.array_equal(ti, oi)
                        and np.array_equal(tv, ov),
                        f"barrier: with shard 1 stalled the epoch holds at {old.epoch} "
                        f"(reads {held}) and serves it bit for bit"))
            plan.release()
            committed = tier.wait_epoch(draws[3].step, timeout=120)
            nv, ni = TopNRecommender(tier.ensemble).recommend(users, TOPK)
            tv, ti = tier.recommend(users, TOPK)
            out.append((committed and np.array_equal(ti, ni) and np.array_equal(tv, nv),
                        f"barrier: released, epoch {draws[3].step} commits and serves "
                        "bit for bit"))
        finally:
            plan.release()
            ch.close()
            tier.close()
        return out

    def serve_faults(self):
        """Faults planted in the serving tier, one at a time, each run through
        the checks of phase foldin or cotrain: at least one must fail. The
        plants patch module and class attributes and are undone after."""
        torch, ops = self.torch, self.ops
        from repro_torch.serve import ClusterCoordinator
        from repro_torch.serve import foldin as foldin_mod

        real_stats, real_seg = foldin_mod.bucket_stats, ops.gather_syrk_seg
        real_commit, real_noise = ClusterCoordinator._commit_locked, foldin_mod._noise

        def noise_in_the_mean(generator, z, sample, ensemble, n_new):
            if sample:
                return real_noise(generator, z, sample, ensemble, n_new)
            return torch.randn((ensemble.n_samples, n_new, ensemble.k),
                               generator=self.gen, device=ensemble.device)

        def stats_one_user_off(v, b, **kw):
            p, r = real_stats(v, b, **kw)
            return p.roll(1, dims=1), r.roll(1, dims=1)

        def first_draw_only(indices, values, mask, seg_ids, n_segments, v, **kw):
            if v.dim() == 3:
                v = v[:1].expand_as(v).contiguous()
            return real_seg(indices, values, mask, seg_ids, n_segments, v, **kw)

        def one_shard_quorum(tier, t_publish):
            n = tier._n_shards
            tier._n_shards = 1   # one staged shard counts as the quorum
            try:
                return real_commit(tier, t_publish)
            finally:
                tier._n_shards = n

        users = self.np.sort(self.np.random.default_rng(0).choice(
            self.sampler.m, max(FOLDIN_BATCHES), replace=False))
        batch = {min(FOLDIN_BATCHES): self._cold_batch(users[:min(FOLDIN_BATCHES)])}

        def foldin_checks():
            verdicts, recorded = self.foldin_verdicts(batch)
            return verdicts + self._all_kernel_verdicts(recorded)

        plants = [("fold-in: each bucket's statistics land one user off", foldin_mod,
                   "bucket_stats", stats_one_user_off, foldin_checks),
                  ("fold-in: the fused kernel reads the first draw's factors for "
                   "every draw", ops, "gather_syrk_seg", first_draw_only, foldin_checks),
                  ("fold-in: sample=False still draws posterior noise", foldin_mod,
                   "_noise", noise_in_the_mean, foldin_checks),
                  ("tier: a commit flips the epoch once one shard has staged it",
                   ClusterCoordinator, "_commit_locked", one_shard_quorum,
                   self.barrier_verdicts)]
        for name, owner, attr, fn, checks in plants:
            saved = getattr(owner, attr)
            setattr(owner, attr, fn)
            try:
                verdicts = checks()
            finally:
                setattr(owner, attr, saved)
            caught = [what for ok, what in verdicts if not ok]
            for ok, what in verdicts:
                print(f"    {name}: {'passes' if ok else 'FAILS'} {what}")
            self.check(bool(caught), f"planted fault '{name}' fails {len(caught)} of "
                       f"{len(verdicts)} checks")
        self.check(foldin_mod.bucket_stats is real_stats and ops.gather_syrk_seg is real_seg
                   and ClusterCoordinator._commit_locked is real_commit
                   and foldin_mod._noise is real_noise, "every plant undone")

    # ------------------------------------------------------------ distributed
    def dist(self):
        """The paper's distributed sampler at the ChEMBL shape: P = 4 item
        shards, all on cuda:0, the grid plans at width "auto", K = 64,
        alpha 1.5; modes ring, allgather and async with the fused engine,
        ring also with einsum. The distributed path is one sweep of each
        fused mode from one state under one noise, every gather_syrk_seg
        launch of the ring and allgather sweeps held bit for bit against
        its plain version on its own inputs as it is made; then the modes
        against each other after one sweep and after DIST_SWEEPS, a ring
        planted to forward the wrong way, sweep seconds, profiles of a ring
        and an async sweep (the exchange's copies and their overlap with
        the kernels), and each launch of a sweep timed at its shapes."""
        import statistics

        torch, ops, ref = self.torch, self.ops, self.ref
        from repro_torch.core import exchange
        from repro_torch.core.distributed import DIST_MODES, DistributedBPMF

        devices = [self.dev] * DIST_SHARDS      # the one card (cuda:0) takes every shard
        samplers = {}
        for mode, engine in DIST_RUNS:
            t0 = time.perf_counter()
            samplers[mode, engine] = DistributedBPMF(
                self.train, self.test, devices=devices, k=K, alpha=1.5, width="auto",
                mode=mode, engine=engine)
            print(f"  {mode} {engine}: partitions and grid plans built and placed in "
                  f"{time.perf_counter() - t0:.2f} s")
        fused = {mode: samplers[mode, "fused"] for mode in DIST_MODES}
        ring, gather = fused["ring"], fused["allgather"]
        for side, plan in (("user", ring.u_plan), ("item", ring.v_plan)):
            n_dense = plan.seg_dense[:, :, -1] + 1
            print(f"  {side} plan: (P, P, R, W) {plan.indices.shape}, lane efficiency "
                  f"{plan.stats()['lane_efficiency']}, n_loc {plan.n_loc:,}, most segments "
                  f"in a block {int(n_dense.max()):,}")
        n_items = ring.m + ring.n

        def cat(st, name):
            return torch.cat(getattr(st, name))

        # the distributed path: one sweep of each fused mode, every kernel
        # launch of ring and allgather checked as it is made (the plain
        # version launches no kernel)
        s0 = ring.init(seed=0)
        noise = ring.draw_noise()
        real, checked = ops.gather_syrk_seg, []

        def checking(*a, **kw):
            out = real(*a, **kw)
            want = ref.gather_syrk_seg_ref(*a[:6])
            same = torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
            err = max(self.max_err(out[0], want[0], -3), self.max_err(out[1], want[1], -2))
            checked.append((same, tuple(a[0].shape), a[4], err))
            return out

        first = {}
        self.sync()
        ops.reset_launches()                    # the distributed path starts here
        ops.gather_syrk_seg = checking
        try:
            for mode in ("ring", "allgather"):
                first[mode] = fused[mode].sweep(s0, noise)
        finally:
            ops.gather_syrk_seg = real
        first["async"] = fused["async"].sweep(s0, noise)
        self.sync()
        launches = ops.launches()               # ... and is read here
        self.path_launches["dist"] = launches
        p2 = DIST_SHARDS * DIST_SHARDS
        print(f"distributed path launches (one ring, one allgather, one async sweep) {launches}")
        self.check(launches["gather_syrk_seg"] == 2 * p2 + 2 * DIST_SHARDS + 2 * p2
                   and sum(launches.values()) == launches["gather_syrk_seg"],
                   f"the distributed path launched gather_syrk_seg {2 * p2} times a ring "
                   f"sweep, {2 * DIST_SHARDS} an allgather sweep and {2 * p2} an async "
                   "sweep, and no other kernel")
        for mode, calls in (("ring", checked[:2 * p2]), ("allgather", checked[2 * p2:])):
            shapes = sorted({c[1] for c in calls})
            self.check(len(calls) > 0 and all(c[0] for c in calls),
                       f"every gather_syrk_seg launch of the fused {mode} sweep ({len(calls)}, "
                       f"rows x width {shapes[0]}..{shapes[-1]}, up to "
                       f"{max(c[2] for c in calls):,} segments) equals its plain version bit "
                       f"for bit (max abs err {max(c[3] for c in calls):.3e})")
        dist_err = max(c[3] for c in checked)
        for name in ("u", "v"):
            self.close(cat(first["ring"], name), cat(first["allgather"], name),
                       f"one sweep from the same state under the same noise: ring {name} "
                       "against allgather")
        self.check(torch.equal(cat(first["async"], "v"), cat(first["ring"], "v")),
                   "one sweep: async's fresh v equals ring's bit for bit")
        einsum = samplers["ring", "einsum"]
        e1 = einsum.sweep(s0, noise)
        for name in ("u", "v"):
            self.close(cat(e1, name), cat(first["ring"], name),
                       f"one sweep: the einsum ring's {name} against the fused ring's")
        del e1

        # a planted fault: the ring forwards each block to p - 1
        saved = exchange.RingExchange.shift
        exchange.RingExchange.shift = -1
        try:
            planted = ring.sweep(s0, noise)
        finally:
            exchange.RingExchange.shift = saved
        ok, text, _ = self.verdict(cat(planted, "v"), cat(first["allgather"], "v"),
                                   "ring v against allgather")
        print(f"    planted fault 'the ring forwards to p - 1': {'passes' if ok else 'FAILS'} "
              f"{text}")
        self.check(not ok and exchange.RingExchange.shift == 1,
                   "planted fault 'the ring forwards to p - 1' fails ring against "
                   "allgather, and is undone")
        del planted

        # the chains: DIST_SWEEPS sweeps of each fused mode under one noise
        states = dict(first)
        for _ in range(DIST_SWEEPS - 1):
            nz = ring.draw_noise()
            for mode in DIST_MODES:
                states[mode] = fused[mode].sweep(states[mode], nz)
        rmse = {mode: fused[mode].rmse(states[mode]) for mode in DIST_MODES}
        gm = float(self.np.sqrt(self.np.mean((self.test.vals - ring.global_mean) ** 2)))
        print(f"test rmse after {DIST_SWEEPS} sweeps {rmse} (global-mean predictor {gm:.4f})")
        self.check(all(self.np.isfinite(r) for r in rmse.values()), "the rmse is finite")
        self.check(abs(rmse["ring"] - rmse["allgather"]) <= DIST_RMSE_ALLGATHER,
                   f"ring and allgather rmse within {DIST_RMSE_ALLGATHER} after "
                   f"{DIST_SWEEPS} sweeps")
        self.check(abs(rmse["ring"] - rmse["async"]) <= DIST_RMSE_ASYNC,
                   f"async and ring rmse within {DIST_RMSE_ASYNC} after {DIST_SWEEPS} sweeps")

        # sweep seconds: the median of 4 steady sweeps, item updates/s, peak
        numbers = {}
        for mode, engine in DIST_RUNS:
            d, st = samplers[mode, engine], states[mode]
            self.sync()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            times = []
            for _ in range(4):
                t0 = time.perf_counter()
                st = d.sweep(st)
                self.sync()
                times.append(time.perf_counter() - t0)
            med = statistics.median(times)
            peak = torch.cuda.max_memory_allocated()
            numbers[mode, engine] = dict(s=med, peak_gb=peak / 1e9,
                                         above_gb=(peak - base) / 1e9)
            print(f"  {mode:9s} {engine:6s}: sweep seconds {[round(t, 4) for t in times]}; "
                  f"median {med:.4f} s; item updates/s {n_items / med:,.0f}; peak device "
                  f"memory {peak / 1e9:.2f} GB, {(peak - base) / 1e9:.2f} GB above the "
                  f"resident {base / 1e9:.2f}")
            if engine == "fused":
                states[mode] = st
        if "train" in self.phases:
            print(f"  beside phase train's single-device fused sweep {self.sweep_s:.4f} s, "
                  f"{n_items / self.sweep_s:,.0f} item updates/s, peak {self.peak_gb:.2f} GB")
        self.dist_numbers = numbers

        # where a ring and an async sweep's device time goes, and how much
        # of the exchange's copy time overlaps the kernels
        for mode in ("ring", "async"):
            d, st = fused[mode], states[mode]
            trace = Path(self.tmp.name) / f"dist_{mode}.json"
            # complete: the sweep's 32 gather_syrk_seg row passes are all in it
            events = self._profile(
                lambda: d.sweep(st, noise), numbers[mode, "fused"]["s"] * 1e3,
                f"fused {mode} sweep, {DIST_SHARDS} shards on one card", trace=trace,
                complete=lambda ev: 2 * p2 == sum(
                    e.count for e in ev if "gather_syrk_rows_kernel" in e.key))
            self.dist_split(events, trace, mode)
        del states
        self.dist_rows(ring, gather, s0, dist_err)
        del samplers, fused, ring, gather, first, s0, noise
        torch.cuda.empty_cache()

    def dist_split(self, events, trace: Path, mode: str):
        """One profiled sweep: gather_syrk_seg's and the library solve's
        device ms (profile), and the ring's forwards as the timeline shows
        them: device-to-device copies on a stream that runs no kernel, their
        ms, and the share of it that overlaps kernels on other streams."""
        def ms(*keys):
            return sum(e.device_time_total for e in events
                       if any(k in e.key for k in keys)) / 1e3

        busy = sum(e.device_time_total for e in events) / 1e3
        kern = ms("gather_syrk", "segment_reduce_kernel")
        solve = ms("potrf", "trsm", "triu_tril")
        timeline = [e for e in json.loads(trace.read_text())["traceEvents"]
                    if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy")]

        def stream(e):
            return e.get("args", {}).get("stream", e.get("tid"))

        compute = {stream(e) for e in timeline if e["cat"] == "kernel"}
        copies = [(e["ts"], e["ts"] + e["dur"]) for e in timeline
                  if e["cat"] == "gpu_memcpy" and "DtoD" in e["name"]
                  and stream(e) not in compute]
        spans = []
        for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in timeline
                           if e["cat"] == "kernel"):
            if spans and a <= spans[-1][1]:
                spans[-1][1] = max(spans[-1][1], b)
            else:
                spans.append([a, b])
        copy_us = sum(b - a for a, b in copies)
        both_us = sum(max(0.0, min(b, d) - max(a, c)) for a, b in copies for c, d in spans)
        share = both_us / copy_us if copy_us else float("nan")
        forwards = 2 * DIST_SHARDS * (DIST_SHARDS - 1)
        print(f"dist split ({mode}): {busy:.2f} ms device busy; gather_syrk_seg "
              f"{kern:.2f} ms, library solve (potrf, trsm, triu_tril) {solve:.2f} ms; "
              f"{len(copies)} exchange copies on their own stream {copy_us / 1e3:.3f} ms, "
              f"{both_us / 1e3:.3f} ms of it beside kernels (overlapped share {share:.3f})")
        self.check(len(copies) == forwards,
                   f"the {mode} sweep's profile shows its {forwards} forwards as "
                   "device-to-device copies on a stream of their own")
        self.dist_numbers[mode, "split"] = dict(busy_ms=busy, gather_syrk_seg_ms=kern,
                                                solve_ms=solve, copies=len(copies),
                                                copy_ms=copy_us / 1e3, overlap_share=share)

    def dist_rows(self, ring, gather, state, err: float):
        """gather_syrk_seg's kernels-line numbers at the grid plans' shapes:
        the 32 launches of a ring sweep and the 8 of an allgather sweep, on
        the initial state's blocks, each timed beside its plain version and
        its bound (outside the counted run)."""
        torch, ops, ref = self.torch, self.ops, self.ref
        us, vs = state.u, state.v
        calls = {
            "ring": [(ring._v.plans[p][q], us[q]) for p in range(DIST_SHARDS)
                     for q in range(DIST_SHARDS)]
            + [(ring._u.plans[p][q], vs[q]) for p in range(DIST_SHARDS)
               for q in range(DIST_SHARDS)],
            "allgather": [(gather._v.plans[p], torch.cat(us)) for p in range(DIST_SHARDS)]
            + [(gather._u.plans[p], torch.cat(vs)) for p in range(DIST_SHARDS)]}
        row = {"dist_max_abs_err": err}
        for mode, todo in calls.items():
            tot = dict(ms=0.0, plain=0.0, bytes=0.0, flops=0.0)
            widest = (0, 0.0)
            for b, cp in todo:
                args = (b.indices, b.values, b.mask, b.seg_dense, b.n_segments, cp)
                ms = self.cuda_ms(lambda: ops.gather_syrk_seg(*args, seg_ptr=b.seg_ptr))
                pms = self.cuda_ms(lambda: ref.gather_syrk_seg_ref(*args), reps=1)
                m = b.mask > 0
                r, w = b.indices.shape
                distinct = int(torch.unique(b.indices[m]).numel())
                tot["ms"] += ms
                tot["plain"] += pms
                tot["bytes"] += (r * w * 12 + r * 4 + distinct * K * 4
                                 + b.n_segments * (K * K + K) * 4)
                tot["flops"] += int(m.sum()) * SYRK_FLOPS
                widest = max(widest, (r, ms))
            bms, by = self.bound_ms(tot["bytes"], tot["flops"])
            print(f"  gather_syrk_seg, one {mode} sweep's {len(todo)} launches: "
                  f"{tot['ms']:.3f} ms kernel, {tot['plain']:.3f} ms plain, bound "
                  f"{bms:.3f} ms ({by}); the launch of {widest[0]:,} rows {widest[1]:.3f} ms")
            row.update({f"dist_{mode}_ms": tot["ms"], f"dist_{mode}_plain_ms": tot["plain"],
                        f"dist_{mode}_bound_ms": bms, f"dist_{mode}_bound_by": by,
                        f"dist_{mode}_launches_per_sweep": len(todo)})
        row["dist_shapes"] = (f"{DIST_SHARDS} shards at the ChEMBL shape, K=64, width "
                              f"{ring.u_plan.width}/{ring.v_plan.width} (user/item plan); "
                              "the initial state's blocks")
        self.rows.setdefault("gather_syrk_seg", {}).update(row)

    # ------------------------------------------------------------ SGLD and ALS
    def sgld(self):
        """The minibatch SGLD samplers and the ALS baseline. Neither launches
        one of the five kernels: the statistics are einsums, the solves the
        library's, as in the JAX package (PERF.md §6). The path's launch
        counts are read all the same, and must be 0."""
        from repro_torch.core import ALS, GibbsSampler, SGLDSampler

        ops = self.ops
        self.sgld_numbers = {}
        self.sync()
        ops.reset_launches()                    # the SGLD and ALS path starts here
        for budget in SGLD_BUDGETS:
            s = SGLDSampler(self.train, self.test, k=K, alpha=1.5, burn_in=10**9,
                            minibatch=budget)
            self.sgld_single(s, budget)
        self.sgld_determinism(SGLDSampler)
        self.als_sweep(ALS)
        self.sgld_dist()
        self.sync()
        launches = ops.launches()               # ... and is read here
        self.path_launches["sgld"] = launches
        self.check(sum(launches.values()) == 0,
                   f"the SGLD and ALS path launched none of the five kernels {launches}")
        # the gates' Gibbs chains are the fused engine's: outside the counted run
        self.sgld_gates(GibbsSampler, SGLDSampler, ALS)
        self.segment_sums()

    def _step_times(self, step, state, n: int):
        """Each of n steps timed on its own (host clock, synchronised):
        the state after them and the times."""
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            state = step(state)
            self.sync()
            times.append(time.perf_counter() - t0)
        return state, times

    def sgld_single(self, s, budget: int):
        import statistics

        torch = self.torch
        lanes = sum(r * b.width for r, b in zip(s.user_rows, s.user_plan_host.buckets)) + sum(
            r * b.width for r, b in zip(s.item_rows, s.item_plan_host.buckets))
        st = s.init(0)
        st, _ = self._step_times(s.sweep, st, SGLD_WARM)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        st, times = self._step_times(s.sweep, st, SGLD_TIMED)
        med = statistics.median(times)
        above = (torch.cuda.max_memory_allocated() - base) / 1e9
        ratio = med / self.sweep_s if hasattr(self, "sweep_s") else float("nan")
        print(f"  SGLDSampler budget {budget:,} lanes ({lanes:,} sampled a step, "
              f"{sum(s.user_rows) + sum(s.item_rows):,} rows): step seconds median "
              f"{med:.5f} (min {min(times):.5f}, max {max(times):.5f}) of {SGLD_TIMED}; "
              f"{1 / med:,.1f} steps/s; {lanes / med:,.0f} sampled lanes/s; peak "
              f"{above:.3f} GB above the resident {base / 1e9:.2f} GB; "
              f"{ratio:.4f} of phase train's fused sweep")
        self.check(bool(torch.isfinite(st.u).all() and torch.isfinite(st.v).all()),
                   f"SGLD budget {budget}: factors finite after "
                   f"{SGLD_WARM + SGLD_TIMED} steps")
        events = self._profile(lambda: s.sweep(st), med * 1e3, f"SGLD step, budget {budget:,}")
        busy = sum(e.device_time_total for e in events) / 1e3
        idle = max(0.0, 1 - busy / (med * 1e3)) if events else float("nan")
        print(f"  SGLD step, budget {budget:,}: device busy {busy:.3f} ms of {med * 1e3:.3f} "
              f"ms, idle share {idle:.3f}: "
              f"{'host-bound' if idle > 0.5 else 'not host-bound'}")
        self.sgld_numbers[budget] = dict(step_s=med, steps_per_s=1 / med, lanes=lanes,
                                         lanes_per_s=lanes / med, above_gb=above,
                                         of_fused_sweep=ratio, busy_ms=busy, idle=idle)

    def sgld_determinism(self, SGLDSampler):
        torch = self.torch
        runs = []
        for _ in range(2):
            s = SGLDSampler(self.train, self.test, k=K, alpha=1.5, burn_in=SGLD_DET_STEPS // 2,
                            minibatch=SGLD_BUDGETS[0])
            runs.append(s.run(SGLD_DET_STEPS, seed=7))
        a, b = runs
        same = all(torch.equal(getattr(a, f), getattr(b, f)) for f in ("u", "v", "pred_sum"))
        self.check(same and a.pred_count == b.pred_count > 0,
                   f"two SGLD chains of {SGLD_DET_STEPS} steps from one seed at the ChEMBL "
                   "shape are equal bit for bit (u, v, the predictive sum)")

    def sgld_gates(self, GibbsSampler, SGLDSampler, ALS):
        """The reference's accuracy gates on their own splits, on the card."""
        from repro_torch.data import synthetic_lowrank, train_test_split

        ratings, _, _ = synthetic_lowrank(300, 200, k_true=6, nnz=9000, noise=0.3, seed=2)
        train, test = train_test_split(ratings, 0.1, seed=3)
        g = GibbsSampler(train, test, k=16, alpha=4.0, burn_in=5, engine="fused")
        gs = g.run(15, seed=0)
        s = SGLDSampler(train, test, k=16, alpha=4.0, burn_in=250, minibatch=2048,
                        step_size=1.0, step_decay=1.0, step_t0=50.0, clip=6.0,
                        temp_warmup=250, hyper_every=5, accum_every=5)
        t0 = time.perf_counter()
        ss = s.run(500, seed=0)
        self.sync()
        t_run = time.perf_counter() - t0
        gap = s.rmse(ss) - g.rmse(gs)
        self.check(gap < SGLD_GATE,
                   f"SGLD posterior mean after 500 steps within {SGLD_GATE} of fused Gibbs "
                   f"after 15 sweeps (rmse {s.rmse(ss):.4f} against {g.rmse(gs):.4f}, gap "
                   f"{gap:+.4f}; 500 steps in {t_run:.2f} s)")

        ratings, _, _ = synthetic_lowrank(250, 180, k_true=8, nnz=8000, noise=0.3, seed=1)
        train, test = train_test_split(ratings, 0.1, seed=2)
        g = GibbsSampler(train, test, k=16, alpha=1.0 / 0.09, burn_in=8, widths=(8, 32, 128))
        gs = g.run(30, seed=0)
        als = ALS(train, test, k=16, lam_reg=0.3, widths=(8, 32, 128))
        sa = als.run(12)
        self.check(g.rmse(gs) <= als.rmse(sa) + ALS_GATE,
                   f"Gibbs no worse than ALS + {ALS_GATE} (rmse {g.rmse(gs):.4f} against "
                   f"{als.rmse(sa):.4f})")

    def als_sweep(self, ALS):
        """An ALS sweep at the ChEMBL shape, K = 64."""
        import statistics

        als = ALS(self.train, self.test, k=K)
        st = als.init(0)
        st, _ = self._step_times(als.sweep, st, 1)
        torch = self.torch
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        st, times = self._step_times(als.sweep, st, 3)
        med = statistics.median(times)
        above = (torch.cuda.max_memory_allocated() - base) / 1e9
        rmse = als.rmse(st)
        print(f"  ALS at the ChEMBL shape, K={K}, lambda {als.lam_reg}: sweep seconds "
              f"{[round(t, 4) for t in times]}, median {med:.4f}; test rmse after 4 sweeps "
              f"{rmse:.4f}; peak {above:.2f} GB above the resident {base / 1e9:.2f} GB")
        self.check(bool(self.np.isfinite(rmse)), "ALS at the ChEMBL shape: finite rmse")
        self.sgld_numbers["als"] = dict(sweep_s=med, rmse=rmse, above_gb=above)

    def sgld_dist(self):
        """DistributedSGLD at the ChEMBL shape, 4 shards on cuda:0."""
        import statistics

        torch = self.torch
        from repro_torch.core import exchange
        from repro_torch.core.distributed import DIST_MODES
        from repro_torch.core.sgld import DistributedSGLD

        devices = [self.dev] * DIST_SHARDS
        kw = dict(devices=devices, k=K, alpha=1.5, width="auto")
        samplers = {mode: DistributedSGLD(self.train, self.test, mode=mode, **kw)
                    for mode in DIST_MODES}
        ring = samplers["ring"]
        print(f"  DistributedSGLD: {DIST_SHARDS} shards, rows a block (user, item) "
              f"{ring.cfg.u_rows}, {ring.cfg.v_rows} of {ring.u_plan.indices.shape[2]:,}, "
              f"{ring.v_plan.indices.shape[2]:,}")
        s0 = ring.init(0)
        noise = ring.draw_noise()
        v_ring = torch.cat(ring.sweep(s0, noise).v)
        v_async = torch.cat(samplers["async"].sweep(s0, noise).v)
        self.check(torch.equal(v_ring, v_async),
                   "DistributedSGLD, one step: async's fresh v equals ring's bit for bit")
        for mode, d in samplers.items():
            st = d.init(0)
            st, _ = self._step_times(d.sweep, st, 2)
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            st, times = self._step_times(d.sweep, st, 8)
            med = statistics.median(times)
            above = (torch.cuda.max_memory_allocated() - base) / 1e9
            ok = all(bool(torch.isfinite(x).all()) for x in st.u + st.v)
            self.check(ok, f"DistributedSGLD {mode}: factors finite after 10 steps")
            print(f"  DistributedSGLD {mode:9s}: step seconds median {med:.5f} (min "
                  f"{min(times):.5f}, max {max(times):.5f}) of 8; peak {above:.3f} GB "
                  f"above the resident {base / 1e9:.2f} GB")
            self.sgld_numbers[f"dist_{mode}"] = dict(step_s=med, above_gb=above)
        del samplers, ring, s0, noise, v_ring, v_async

        # the full-budget gradient: ring against allgather, and the plant
        full = {mode: DistributedSGLD(self.train, self.test, mode=mode, minibatch=10**9, **kw)
                for mode in ("ring", "allgather")}
        st = full["ring"].init(0)

        def grads(d):
            out = []
            for counter, factors, side, s_rows in ((st.u, st.v, d._v, d.cfg.v_rows),
                                                   (st.v, st.u, d._u, d.cfg.u_rows)):
                rows = ((None,) * DIST_SHARDS if d.mode == "allgather"
                        else ((None,) * DIST_SHARDS,) * DIST_SHARDS)
                out.append(torch.cat(d._grad_phase(counter, factors, side, rows, s_rows)))
            return out

        want = grads(full["allgather"])
        for name, got, w in zip(("v", "u"), grads(full["ring"]), want):
            self.close(got, w, f"DistributedSGLD full budget: ring's {name} likelihood "
                              "gradient against allgather's")
        saved = exchange.RingExchange.shift
        exchange.RingExchange.shift = -1
        try:
            planted = grads(full["ring"])
        finally:
            exchange.RingExchange.shift = saved
        ok, text, _ = self.verdict(planted[0], want[0], "ring v gradient against allgather")
        print(f"    planted fault 'the ring forwards to p - 1': {'passes' if ok else 'FAILS'} "
              f"{text}")
        self.check(not ok and exchange.RingExchange.shift == 1,
                   "planted fault 'the ring forwards to p - 1' fails the full-budget "
                   "gradient check, and is undone")
        del full, st, want, planted
        torch.cuda.empty_cache()

    def segment_sums(self):
        """The step-0 repair on the card: the engines' segment sum
        (torch.segment_reduce over the plan's offsets) bit for bit the
        plain version's row-order sums on every ChEMBL bucket, and the same
        bits on a second call; then the times it moved, as the other phases
        of this run read them."""
        torch, ref = self.torch, self.ref
        from repro_torch.core.gibbs import segment_reduce_rows

        g = torch.Generator(device=self.dev).manual_seed(11)
        u = 0.3 * torch.randn((self.sampler.m, K), generator=g, device=self.dev)
        v = 0.3 * torch.randn((self.sampler.n, K), generator=g, device=self.dev)
        results, rows_total = [], 0
        for side, b, cp in self._bucket_sides(u, v):
            vm = cp[b.indices.long()] * b.mask[..., None]
            for rows in (torch.einsum("rwk,rwl->rkl", vm, vm),
                         torch.einsum("rwk,rw->rk", vm, b.values * b.mask)):
                a = segment_reduce_rows(rows, b.seg_ptr)
                again = segment_reduce_rows(rows, b.seg_ptr)
                want = ref.segment_sums_in_order(rows, b.seg_ids, b.n_segments)
                results.append(torch.equal(a, want) and torch.equal(a, again))
                del a, again, want, rows
            rows_total += b.indices.shape[0]
            del vm
        self.check(all(results),
                   f"the order-fixed segment sum equals the plain row-order sums bit for bit "
                   f"and itself on a second call, on all {self.n_buckets} ChEMBL buckets "
                   f"({rows_total:,} rows; prec and rhs)")
        parts = []
        if hasattr(self, "kernel_sweep_s"):
            parts.append(f"kernel-engine sweep {self.kernel_sweep_s:.4f} s")
        if ("ring", "einsum") in getattr(self, "dist_numbers", {}):
            parts.append(f"einsum ring sweep {self.dist_numbers['ring', 'einsum']['s']:.4f} s")
        if (4096, "kernel") in getattr(self, "foldin_numbers", {}):
            parts.append(f"fold-in B=4,096 kernel engine "
                         f"{self.foldin_numbers[4096, 'kernel']['ms']:.3f} ms")
        print(f"  after the repair, this run: {'; '.join(parts) or 'none of the phases ran'}")
        del u, v
        torch.cuda.empty_cache()

    # ------------------------------------------------------------ the LM path
    def lm_kernels(self):
        """The flash kernel at the forward's shapes: q (8, S, 256) and k, v
        (4, S, 256), the query heads of one KV head side by side."""
        torch, ops, ref = self.torch, self.ops, self.ref
        bh, bhk, d = 8, 4, 256

        def qkv(s, dtype, q_scale=1.0):
            return ((q_scale * self.randn(bh, s, d)).to(dtype),
                    self.randn(bhk, s, d).to(dtype), self.randn(bhk, s, d).to(dtype))

        def check(q, k, v, tag, dtype, **kw):
            got = ops.flash_attention(q, k, v, **kw).float()
            want = ref.flash_attention_ref(q, k, v, **kw).float()
            self.sync()
            err = self.close(got, want, f"flash_attention {tag}", FLASH_TOL[dtype])
            if dtype == "bf16":
                self.close(got, want, f"flash_attention {tag}, within a bf16 ulp",
                           FLASH_BF16_ULP_TOL)
            return err

        def against_float64(q, k, v, got, want, tag, **kw):
            """The least atol beside the one-ulp rtol with which the kernel's
            output, the plain version's and the float64 attention rounded
            to bf16 meet: the kernel within one bf16 ulp of float64, or no
            farther from it than the plain version."""
            exact = self.exact_attention(
                *(t.transpose(0, 1)[None] for t in (q, k, v)), causal=kw["causal"],
                window=kw["window"], attn_softcap=kw["softcap"], scale=None)[0].transpose(0, 1)
            rtol = FLASH_BF16_ULP_TOL["rtol"]

            def need(a, b):
                return float(((a.double() - b.double()).abs() - rtol * b.double().abs()).max())

            nk, npl = need(got, exact), need(want, exact)
            ne = need(exact.to(torch.bfloat16), want)
            self.check(nk <= max(FLASH_BF16_ULP_TOL["atol"], npl),
                       f"flash_attention {tag} against float64: the kernel takes an atol "
                       f"of {nk:.2e} beside the one-ulp rtol, the plain version "
                       f"{npl:.2e}; the float64 value rounded to bf16 takes {ne:.2e} against "
                       "the plain version (the kernel within one ulp of float64, or no "
                       "farther than the plain version)")
            del exact

        def faults(q, k, v, kind, inputs, require, **kw):
            """The plain versions of neighbouring functions, held against
            the right one's: which of the two bf16 limits rejects each."""
            want = ref.flash_attention_ref(q, k, v, **kw).float()
            wrong = {"softcap dropped": dict(kw, softcap=0.0),
                     "K a row off": dict(kw, k=k.roll(1, dims=1))}
            if kw["window"]:
                wrong["window a tile (64 keys) short"] = dict(kw, window=kw["window"] - 64)
            for fault, fkw in wrong.items():
                fkw = {"k": k} | fkw
                out = ref.flash_attention_ref(q, fkw.pop("k"), v, **fkw).float()
                ulp, _, err = self.verdict(out, want, "", FLASH_BF16_ULP_TOL)
                loose, _, _ = self.verdict(out, want, "", FLASH_TOL["bf16"])
                text = (f"{kind}, {inputs}: the plain version with {fault} is "
                        f"{err:.3e} off; the ulp limit {'passes' if ulp else 'rejects'} "
                        f"it, 3e-2 {'passes' if loose else 'rejects'} it")
                if require:
                    self.check(not ulp, text)
                else:
                    print(f"  info: {text}")
                del out

        q, k, v = qkv(LM_SEQ, torch.bfloat16)
        n_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
        per = {}
        for window, kind in ((4096, "local"), (0, "global")):
            kw = dict(causal=True, window=window, softcap=50.0)
            err = check(q, k, v, f"{kind} (8, {LM_SEQ}, 256) bf16, window {window}, "
                        "softcap 50", "bf16", **kw)
            faults(q, k, v, kind, "N(0,1) inputs", False, **kw)
            ms = self.cuda_ms(lambda: ops.flash_attention(q, k, v, **kw))
            pms = self.cuda_ms(lambda: ref.flash_attention_ref(q, k, v, **kw), reps=2)
            # The bound: QK^T takes bf16 inputs, whose products are exact in
            # fp32, so it is one bf16 tensor pass over the visible pairs. P
            # stays fp32; split into three bf16 terms that sum to it exactly
            # (csrc/flash_attention.cu), P V is three more passes: four in
            # all. Beside it: the bound before the tensor-core kernel, with
            # P V on the fp32 pipes, and both products at one peak.
            qk_flops = pv_flops = 2.0 * d * bh * visible_pairs(LM_SEQ, window)
            tb = n_bytes / HBM_BYTES_PER_S * 1e3
            to = 4 * qk_flops / BF16_TENSOR_FLOPS * 1e3
            bms, by = (tb, "bytes") if tb >= to else (to, "operations")
            b_pv32 = max(tb, (qk_flops / BF16_TENSOR_FLOPS + pv_flops / FP32_FLOPS) * 1e3)
            b32 = max(tb, (qk_flops + pv_flops) / FP32_FLOPS * 1e3)
            b16 = max(tb, (qk_flops + pv_flops) / BF16_TENSOR_FLOPS * 1e3)
            # softcap 0: the function scaled_dot_product_attention computes
            kw0 = dict(kw, softcap=0.0)
            mask = None
            if window:
                pos = torch.arange(LM_SEQ, device=self.dev)
                diff = pos[:, None] - pos[None, :]
                mask = (diff >= 0) & (diff < window)

            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(
                    q[None], k[None], v[None], attn_mask=mask, is_causal=mask is None,
                    enable_gqa=True)[0]

            err0 = self.close(ops.flash_attention(q, k, v, **kw0).float(), sdpa().float(),
                              f"flash_attention {kind} softcap 0 against "
                              "scaled_dot_product_attention", FLASH_TOL["bf16"])
            ms0 = self.cuda_ms(lambda: ops.flash_attention(q, k, v, **kw0))
            lms0 = self.cuda_ms(sdpa)
            # softcap 50: flex_attention computes it in one library call
            flex, fkw = self.flex(window)
            self.close(flex(q[None], k[None], v[None], **fkw)[0].float(),
                       ops.flash_attention(q, k, v, **kw).float(),
                       f"flash_attention {kind} softcap 50: flex_attention against the "
                       "kernel", FLASH_TOL["bf16"])
            lms = self.cuda_ms(lambda: flex(q[None], k[None], v[None], **fkw))
            print(f"    flash_attention {kind}: {ms:.3f} ms kernel, {pms:.3f} ms plain, "
                  f"bound {bms:.3f} ms ({by}: 4 bf16 tensor passes a visible pair, "
                  f"QK^T and the 3-term P V; kernel at {ms / bms:.2f}x); with P V on "
                  f"the fp32 pipes {b_pv32:.3f} ms (kernel at {ms / b_pv32:.2f}x); all "
                  f"at the fp32 peak {b32:.3f} ms, both products in one bf16 tensor "
                  f"pass each {b16:.3f} ms; flex_attention {lms:.3f} ms; softcap 0: "
                  f"{ms0:.3f} ms kernel, {lms0:.3f} ms scaled_dot_product_attention (agree "
                  f"to {err0:.2e})")
            per[kind] = dict(err=err, ms=ms, plain=pms, bound=bms, b_pv32=b_pv32,
                             b32=b32, b16=b16, by=by, ms0=ms0, lib0=lms0, lib=lms)
            del mask
        del q, k, v
        # peaked scores, where the softcap and each key count: the kernel
        # within an ulp, and that limit rejects the neighbouring functions
        q, k, v = qkv(LM_SEQ, torch.bfloat16, PEAK_SCALE)
        for window, kind in ((4096, "local"), (0, "global")):
            kw = dict(causal=True, window=window, softcap=50.0)
            tag = f"{kind} (8, {LM_SEQ}, 256) bf16, q x {PEAK_SCALE}, window {window}, softcap 50"
            check(q, k, v, tag, "bf16", **kw)
            against_float64(q, k, v, ops.flash_attention(q, k, v, **kw),
                            ref.flash_attention_ref(q, k, v, **kw), tag, **kw)
            faults(q, k, v, kind, f"q x {PEAK_SCALE}", True, **kw)
        del q, k, v
        # scores of std 16 with no softcap, the most peaked inputs: the fp32
        # plain version's own rounding is past an ulp of the float64 value
        # here, so the kernel is held to 3e-2 of it and to float64
        q, k, v = qkv(LM_SEQ, torch.bfloat16, WQ_SCALE)
        kw = dict(causal=True, window=4096, softcap=0.0)
        tag = f"local (8, {LM_SEQ}, 256) bf16, q x {WQ_SCALE:g}, window 4096, softcap 0"
        got, want = ops.flash_attention(q, k, v, **kw), ref.flash_attention_ref(q, k, v, **kw)
        self.sync()
        self.close(got.float(), want.float(), f"flash_attention {tag}", FLASH_TOL["bf16"])
        against_float64(q, k, v, got, want, tag, **kw)
        del q, k, v, got, want
        # a ragged sequence, and fp32
        for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
            q, k, v = qkv(LM_SEQ - 192, dtype)
            check(q, k, v, f"ragged (8, {LM_SEQ - 192}, 256) {name}, window 4096, softcap 50",
                  name, causal=True, window=4096, softcap=50.0)
        q, k, v = qkv(LM_SEQ, torch.float32)
        check(q, k, v, f"(8, {LM_SEQ}, 256) fp32, window 0, softcap 50", "fp32",
              causal=True, window=0, softcap=50.0)
        # the fp32 kernel's bits on inputs of their own seed, to hold
        # against another commit's run
        g = torch.Generator(device=self.dev).manual_seed(FP32_DIGEST_SEED)
        q, k, v = (torch.randn(n, LM_SEQ, d, generator=g, device=self.dev)
                   for n in (bh, bhk, bhk))
        out = ops.flash_attention(q, k, v, causal=True, window=0, softcap=50.0)
        digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
        print(f"  fp32 flash output (8, {LM_SEQ}, 256), window 0, softcap 50, inputs "
              f"of seed {FP32_DIGEST_SEED}: sha256 {digest}")
        out = ops.flash_attention(*(t.to(torch.bfloat16) for t in (q, k, v)), causal=True,
                                  window=0, softcap=50.0)
        digest = hashlib.sha256(out.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]
        print(f"  bf16 flash output, the same inputs rounded to bf16: sha256 {digest}")
        del out
        # scores of std 16 (q x WQ_SCALE), most of whose tails the softcap
        # bends, as in lm_eval's scaled forwards: the kernel in fp32
        q, k, v = qkv(LM_SEQ, torch.float32, WQ_SCALE)
        for window in (4096, 0):
            check(q, k, v, f"(8, {LM_SEQ}, 256) fp32, q x {WQ_SCALE:g}, window {window}, "
                  "softcap 50", "fp32", causal=True, window=window, softcap=50.0)
        del q, k, v
        # the row: one forward's attention, 13 local and 13 global launches
        n = 13

        def total(key):
            return n * (per["local"][key] + per["global"][key])

        self.add_row("flash_attention", "flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:78",
                     max_abs_err=max(p["err"] for p in per.values()), ms=total("ms"),
                     plain_ms=total("plain"), bound_ms=total("bound"),
                     bound_by=per["global"]["by"],
                     library_ms=total("lib"),
                     library="torch.nn.attention.flex_attention under torch.compile: "
                             "score_mod 50 tanh(s / 50), a causal and window block mask, "
                             "enable_gqa",
                     shapes=f"one gemma2-2b forward's attention: 13 local (window 4096) + "
                            f"13 global launches, q (8, {LM_SEQ}, 256), k/v (4, {LM_SEQ}, "
                            "256) bf16, causal, softcap 50; bound: 4 bf16 tensor passes "
                            "a visible pair (QK^T, and P V with the fp32 P split into "
                            "three exact bf16 terms)",
                     bound_ms_pv_fp32_pipes=total("b_pv32"),
                     bound_note="bound_ms was bound_ms_pv_fp32_pipes (QK^T at the bf16 "
                                "tensor peak, P V at the fp32 peak) while P V ran on the "
                                "fp32 pipes; the bf16 kernel runs it on the tensor cores",
                     bound_ms_all_fp32_peak=total("b32"),
                     bound_ms_all_bf16_tensor_peak=total("b16"),
                     softcap0_ms=total("ms0"),
                     softcap0_library_ms=total("lib0"),
                     softcap0_library="scaled_dot_product_attention, enable_gqa, "
                                            "the same causal and window mask")

    def lm_eval(self):
        import dataclasses

        from repro_torch.configs import get_config
        from repro_torch.data.tokens import TokenStream
        from repro_torch.models import DecoderModel
        from repro_torch.models import transformer as tfm

        torch, ops = self.torch, self.ops
        cfg = get_config("gemma2-2b")
        model = DecoderModel(cfg)
        t0 = time.perf_counter()
        params = model.init(seed=0)
        self.sync()
        n_params = sum(p.numel() for p in params.parameters())
        print(f"gemma2-2b init on the card: {n_params:,} parameters in "
              f"{time.perf_counter() - t0:.2f} s")
        self.lm = (model, params)
        batch = TokenStream(cfg, 1, LM_SEQ, seed=0)(0)
        tokens = torch.as_tensor(batch["tokens"], device=self.dev)
        positions = torch.arange(LM_SEQ, dtype=torch.int32, device=self.dev)[None]
        with torch.no_grad():
            model.loss_fn(params, batch)           # warm-up: cuBLAS plans, allocator
            self.sync()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()                   # the main path starts here
            t0 = time.perf_counter()
            loss, metrics = model.loss_fn(params, batch)
            self.sync()
            dt = time.perf_counter() - t0
            launches = dict(ops.LAUNCHES)          # ... and is read here
            peak = torch.cuda.max_memory_allocated() / 1e9
            loss = float(loss)
            print(f"forward + loss at B=1, S={LM_SEQ}: {dt:.3f} s, "
                  f"{LM_SEQ / dt:,.0f} tokens/s, peak device memory {peak:.2f} GB, "
                  f"loss {loss:.5f}; launches {launches}")
            self.check(launches["flash_attention"] == cfg.n_layers
                       and sum(launches.values()) == cfg.n_layers,
                       f"the forward launched the flash kernel once a layer "
                       f"({cfg.n_layers}) and no other kernel of the port")
            self.main_launches["flash_attention"] = launches["flash_attention"]
            self.check(bool(self.np.isfinite(loss)), "the loss is finite")
            self.check(float(metrics["tokens"]) == LM_SEQ, f"{LM_SEQ} labels counted")
            # which CUDA kernel the bf16 launches ran, where the package
            # names one per dtype
            name = getattr(ops, "FLASH_KERNEL_NAMES", {}).get(cfg.dtype)

            def flash_kernels(ev):
                return sum(e.count for e in ev if name is not None and name in e.key)

            # complete: no fewer of the named kernel's launches than layers
            events = self._profile(lambda: model.loss_fn(params, batch), dt * 1e3,
                                   "forward", complete=lambda ev: bool(ev) and (
                                       name is None or flash_kernels(ev) >= cfg.n_layers))
            if name is not None and events:
                ran = flash_kernels(events)
                self.check(ran == cfg.n_layers,
                           f"the forward's profile shows {ran} launches of {name} "
                           f"({cfg.n_layers} expected: every flash launch of the bf16 "
                           "forward on the tensor-core kernel)")
        # the same weights down the JAX package's direct path, and both in fp32
        labels = torch.as_tensor(batch["labels"], device=self.dev)

        def forward(c):
            # the parameters lm_train leaves in self.lm (it frees and re-draws them)
            with torch.no_grad():
                logits = tfm.decoder_forward(self.lm[1], c, tokens, positions=positions)[0]
                return float(tfm.cross_entropy(logits, labels)[0]), logits[:, -1].clone()

        f32 = dataclasses.replace(cfg, dtype=torch.float32, param_dtype=torch.float32)
        runs, per_layer = {}, {}
        for name, c in (("flash bf16", cfg), ("flash fp32", f32)):
            with self.probed() as recs:
                runs[name] = forward(c)
            per_layer[name] = recs
        ops.reset_launches()
        for name, c in (("direct bf16", cfg), ("direct fp32", f32)):
            runs[name] = forward(dataclasses.replace(c, chunked_attn_min_len=LM_SEQ + 1))
        self.check(ops.LAUNCHES["flash_attention"] == 0,
                   "the direct-path forwards launched no flash kernel")
        for name, (l, g) in runs.items():
            print(f"  {name}: loss {l:.6f}")
            self.check(bool(self.np.isfinite(l) and torch.isfinite(g).all()),
                       f"{name}: loss and last-position logits are finite")
        for ok, what in self.forward_verdicts(runs, per_layer):
            self.check(ok, what)
        self.lm_runs, self.lm_layers, self.lm_forward = runs, per_layer, forward
        self.lm_eval_numbers = dict(s=dt, tokens_per_s=LM_SEQ / dt, peak_gb=peak)
        self.lm_eval_loss = loss
        # the same four forwards with every wq x WQ_SCALE: attention scores
        # whose tails pass the softcap of 50 (lm_faults needs them)
        with self.scaled_wq():
            wq_runs, wq_layers = {}, {}
            for name, c in (("flash bf16", cfg), ("flash fp32", f32)):
                with self.probed() as recs:
                    wq_runs[name] = forward(c)
                wq_layers[name] = recs
            ops.reset_launches()
            for name, c in (("direct bf16", cfg), ("direct fp32", f32)):
                wq_runs[name] = forward(dataclasses.replace(
                    c, chunked_attn_min_len=LM_SEQ + 1))
            self.check(ops.LAUNCHES["flash_attention"] == 0,
                       f"wq x {WQ_SCALE:g}: the direct-path forwards launched no flash kernel")
            scores = self.first_layer_scores(params, cfg, tokens, positions)
            self.depth_sweep(forward, cfg, f32, wq_runs)
        self.check(scores["max"] > cfg.attn_softcap,
                   f"wq x {WQ_SCALE:g}: the first layer's attention scores pass the softcap "
                   f"of {cfg.attn_softcap:g} before it: std {scores['std']:.2f}, max |s| "
                   f"{scores['max']:.1f}, share above 25 {scores['above']:.2e}")
        for name, (l, g) in wq_runs.items():
            print(f"  wq x {WQ_SCALE:g}, {name}: loss {l:.6f}")
            self.check(bool(self.np.isfinite(l) and torch.isfinite(g).all()),
                       f"wq x {WQ_SCALE:g}, {name}: loss and last-position logits are finite")
        for ok, what in self.scaled_verdicts(wq_runs, wq_layers):
            self.check(ok, what)
        self.lm_wq_runs, self.lm_wq_layers = wq_runs, wq_layers

    def probed(self):
        """A context in which each flash launch of a forward is held on its
        own inputs: the layer's q, k and v also go down the direct path and
        into the float64 attention, and the list it yields gets one record
        of distances a layer. A forward's last-position logits carry every
        layer's rounding through the layers after it; these do not."""
        import contextlib

        from repro_torch.models import layers

        real, recs = layers.multi_head_attention, []

        def probe(q, k, v, **kw):
            out = real(q, k, v, **kw)
            if kw.get("chunk") and k.shape[1] > kw["chunk"]:
                direct = real(q, k, v, **dict(kw, chunk=0))
                recs.append(self.layer_errors(out, direct, self.exact_attention(
                    q, k, v, **kw)))
                del direct
            return out

        @contextlib.contextmanager
        def ctx():
            layers.multi_head_attention = probe
            try:
                yield recs
            finally:
                layers.multi_head_attention = real

        return ctx()

    def exact_attention(self, q, k, v, *, causal, window, attn_softcap, scale, **_):
        """multi_head_attention's function of (B, S, H, hd) heads in float64."""
        from repro_torch.models import layers

        torch = self.torch
        b, s, h, hd = q.shape
        qd = q.double().transpose(1, 2)
        kd = layers._expand_kv(k, h).double().transpose(1, 2)
        vd = layers._expand_kv(v, h).double().transpose(1, 2)
        sc = (qd @ kd.transpose(-1, -2)).mul_(scale or hd ** -0.5)
        if attn_softcap > 0:
            sc.div_(attn_softcap).tanh_().mul_(attn_softcap)
        pos = torch.arange(s, device=q.device)
        mask = layers.attention_scores_mask(pos, pos, causal=causal, window=window)
        sc.masked_fill_(~mask, float("-inf"))
        return (torch.softmax(sc, dim=-1) @ vd).transpose(1, 2)

    def layer_errors(self, out, direct, exact) -> dict:
        """One layer's kernel output and direct-path output against the
        float64 attention of the same inputs. `need` is the least atol
        with which allclose(out, exact, rtol) holds, at the rtol of the
        kernel's dtype: one bf16 ulp, or FLASH_TOL's in fp32."""
        ek, ed = (out.double() - exact).abs(), (direct.double() - exact).abs()
        rtol = (FLASH_BF16_ULP_TOL if out.dtype == self.torch.bfloat16
                else FLASH_TOL["fp32"])["rtol"]
        return dict(kmax=float(ek.max()), kmean=float(ek.mean()), dmax=float(ed.max()),
                    dmean=float(ed.mean()), need=float((ek - rtol * exact.abs()).max()))

    def layer_verdicts(self, per_layer: dict, tag: str, bf16_tol: dict
                       ) -> list[tuple[bool, str]]:
        """Every layer's flash attention on its own inputs: within the
        kernel's tolerance of the float64 attention (fp32 3e-4; bf16
        `bf16_tol`, one ulp and the fp32 sums' error), and in bf16 no
        farther from it than NOISE_FACTOR times the direct path, which
        rounds the probabilities to bf16 before P V."""
        n_layers = self.lm[0].cfg.n_layers
        out = []
        for name, recs in per_layer.items():
            dtype = name.split()[-1]
            tol = bf16_tol if dtype == "bf16" else FLASH_TOL["fp32"]
            kmax = " ".join(f"{r['kmax']:.1e}" for r in recs)
            dmax = " ".join(f"{r['dmax']:.1e}" for r in recs)
            print(f"  {tag}{name}, each layer's attention on its own inputs, max abs "
                  f"err to float64: kernel [{kmax}]; direct path [{dmax}]")
            need = max((r["need"] for r in recs), default=float("inf"))
            out.append((len(recs) == n_layers and need <= tol["atol"],
                        f"{tag}{name}: each of {len(recs)} layers' flash attention within "
                        f"{tol} of the float64 attention of its own inputs (the atol it "
                        f"takes at that rtol: {need:.3e})"))
            if dtype == "bf16":
                far = [i for i, r in enumerate(recs)
                       if r["kmax"] > NOISE_FACTOR * r["dmax"]
                       or r["kmean"] > NOISE_FACTOR * r["dmean"]]
                out.append((len(recs) == n_layers and not far,
                            f"{tag}{name}: each layer's flash attention no farther from "
                            f"float64 than {NOISE_FACTOR}x the direct path's, in max and "
                            f"in mean (layers beyond it: {far})"))
        return out

    def depth_sweep(self, forward, cfg, f32, full: dict, depths=(1, 2, 4, 8, 16)):
        """With every wq x WQ_SCALE: the distance of the two attention
        paths' forwards at the first `depths` layers, and at all of them
        (`full`): how the layers carry a rounding difference on."""
        import dataclasses

        torch, params = self.torch, self.lm[1]
        layers, rows = params.layers, []
        try:
            for depth in depths:
                params.layers = torch.nn.ModuleList(list(layers)[:depth])
                r = {}
                for name, c in (("bf16", cfg), ("fp32", f32)):
                    r["flash " + name] = forward(c)
                    r["direct " + name] = forward(dataclasses.replace(
                        c, chunked_attn_min_len=LM_SEQ + 1))
                rows.append((depth, r))
        finally:
            params.layers = layers
        rows.append((cfg.n_layers, full))
        for depth, r in rows:
            (lf, _), (ld, _) = r["flash bf16"], r["direct bf16"]
            (lf32, gf32), (ld32, gd32) = r["flash fp32"], r["direct fp32"]
            print(f"  wq x {WQ_SCALE:g}, the first {depth:2d} layers: fp32 last-position "
                  f"logits, kernel path against direct path: max abs diff "
                  f"{float((gf32 - gd32).abs().max()):.3e} (logits max |x| "
                  f"{float(gd32.abs().max()):.2f}); fp32 loss |diff| {abs(lf32 - ld32):.2e}; "
                  f"bf16 loss |diff| {abs(lf - ld):.2e}, direct bf16 to fp32 "
                  f"{abs(ld - ld32):.2e}, kernel bf16 to fp32 {abs(lf - lf32):.2e}")

    def scaled_verdicts(self, runs: dict, per_layer: dict) -> list[tuple[bool, str]]:
        """The checks of the wq-scaled forwards: the fp32 loss of the kernel
        path against the direct path's at LM_FP32_LOSS_RTOL, the bf16
        last-position logits within the bf16 noise floor, the fp32 ones
        within LM_WQ_FP32_LOGITS_ATOL (a reading of depth_sweep), and every
        layer's attention on its own inputs (layer_verdicts). The bf16
        losses are printed, not held: the two paths' bf16 losses drift
        apart with depth as their fp32 logits do (depth_sweep prints it),
        and every layer's bf16 attention is held on its own inputs."""
        (lf, _), (ld, gd) = runs["flash bf16"], runs["direct bf16"]
        (lf32, gf32), (ld32, ref) = runs["flash fp32"], runs["direct fp32"]
        tag = f"wq x {WQ_SCALE:g}"
        print(f"  {tag}: bf16 loss {lf:.5f} against the direct path's {ld:.5f} "
              f"(|diff| {abs(lf - ld):.2e}; the fp32 loss {ld32:.5f})")
        return [
            (abs(lf32 - ld32) <= LM_FP32_LOSS_RTOL * abs(ld32),
             f"{tag}: fp32 loss {lf32:.6f} against the direct path's {ld32:.6f}: "
             f"|diff| {abs(lf32 - ld32):.2e} <= {LM_FP32_LOSS_RTOL} x |loss|"),
            self.noise_verdict(runs["flash bf16"][1], gd, ref,
                               f"{tag}: bf16 last-position logits, kernel path",
                               "the direct path"),
            (float((gf32 - ref).abs().max()) <= LM_WQ_FP32_LOGITS_ATOL,
             f"{tag}: fp32 last-position logits against the direct path: max abs diff "
             f"{float((gf32 - ref).abs().max()):.3e} <= {LM_WQ_FP32_LOGITS_ATOL}"),
        ] + self.layer_verdicts(per_layer, f"{tag}, ", WQ_BF16_LAYER_TOL)

    def scaled_wq(self):
        """Every layer's wq multiplied by WQ_SCALE in place, and divided back
        on exit: a power of two, so the bf16 weights come back bit for bit."""
        import contextlib

        params = self.lm[1]

        @contextlib.contextmanager
        def ctx():
            with self.torch.no_grad():
                for layer in params.layers:
                    layer.attn.wq.mul_(WQ_SCALE)
                try:
                    yield
                finally:
                    for layer in params.layers:
                        layer.attn.wq.div_(WQ_SCALE)

        return ctx()

    def first_layer_scores(self, params, cfg, tokens, positions) -> dict:
        """Statistics of the first layer's scaled q.k scores over the first
        1,024 positions of the batch, before the softcap: how far the cap
        bends them."""
        from repro_torch.models import layers as L
        from repro_torch.models import transformer as tfm

        torch, n = self.torch, 1024
        with torch.no_grad():
            lay, hd = params.layers[0], cfg.hd
            h = params.embed.to(cfg.dtype)[tokens[:, :n]]
            if cfg.embed_scale:
                h = h * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype)
            x = tfm.apply_norm(lay.ln_attn, h, cfg)
            q = (x @ lay.attn.wq.to(cfg.dtype)).reshape(1, n, cfg.n_heads, hd)
            k = (x @ lay.attn.wk.to(cfg.dtype)).reshape(1, n, cfg.n_kv_heads, hd)
            q = L.apply_rope(q, positions[:, :n], cfg.rope_theta).float()
            k = L.apply_rope(k, positions[:, :n], cfg.rope_theta).float()
            k = k.repeat_interleave(cfg.n_heads // cfg.n_kv_heads, dim=2)
            sc = torch.einsum("bqhd,bkhd->bhqk", q, k) * (cfg.attn_scale or hd ** -0.5)
        return dict(std=float(sc.std()), max=float(sc.abs().max()),
                    above=float((sc.abs() > 25).float().mean()))

    def forward_verdicts(self, runs: dict, per_layer: dict) -> list[tuple[bool, str]]:
        """lm_eval's checks of the kernel path's forwards (loss, last-position
        logits) against the direct path's, in bf16 and in fp32, and of each
        layer's attention on its own inputs."""
        (lf, gf), (ld, gd) = runs["flash bf16"], runs["direct bf16"]
        (lf32, gf32), (ld32, ref) = runs["flash fp32"], runs["direct fp32"]
        return [
            (abs(lf - ld) <= LM_LOSS_RTOL * abs(ld),
             f"bf16 loss {lf:.5f} against the direct path's {ld:.5f}: "
             f"|diff| {abs(lf - ld):.2e} <= {LM_LOSS_RTOL} x |loss|"),
            self.noise_verdict(gf, gd, ref, "bf16 last-position logits, kernel path",
                               "the direct path"),
            (abs(lf32 - ld32) <= LM_FP32_LOSS_RTOL * abs(ld32),
             f"fp32 loss {lf32:.6f} against the direct path's {ld32:.6f}"),
            self.verdict(gf32, ref, "fp32 last-position logits against the direct path",
                         LM_FP32_TOL)[:2],
        ] + self.layer_verdicts(per_layer, "", FLASH_BF16_ULP_TOL)

    def lm_serve(self):
        import dataclasses

        from repro_torch.launch import serve
        from repro_torch.models import DecoderModel

        torch, ops = self.torch, self.ops
        model, params = self.lm
        b, plen, max_new = LM_SERVE
        gen = torch.Generator(device=self.dev).manual_seed(1)
        prompts = torch.randint(0, model.cfg.vocab_size, (b, plen), generator=gen,
                                device=self.dev, dtype=torch.int32)
        serve.generate(model, params, prompts, max_new)      # warm-up
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()                    # the main path starts here
        toks, t_prefill, t_decode = serve.generate(model, params, prompts, max_new)
        launches = dict(ops.LAUNCHES)           # ... and is read here
        peak = torch.cuda.max_memory_allocated() / 1e9
        n_dec = b * (max_new - 1)
        print(f"serve {b} x {plen} prompts, {max_new - 1} decode steps: prefill "
              f"{t_prefill * 1e3:.1f} ms, decode {n_dec / t_decode:,.1f} tokens/s "
              f"({t_decode / (max_new - 1) * 1e3:.2f} ms a step), peak device memory "
              f"{peak:.2f} GB; launches {launches}")
        self.check(sum(launches.values()) == 0,
                   "prefill and decode take the direct path: no flash launch")
        self.check(tuple(toks.shape) == (b, max_new)
                   and bool(((toks >= 0) & (toks < model.cfg.vocab_size)).all()),
                   "generated token ids have the expected shape and range")
        out = model.prefill_fn(params, {"tokens": prompts}, headroom=8)
        cache, tok = out["cache"], toks[:, :1]
        self._profile(lambda: model.decode_fn(params, cache, {"tokens": tok}),
                      t_decode / (max_new - 1) * 1e3, "decode step")
        del out, cache
        # the cache invariant of tests/test_models.py, at full width
        f32 = DecoderModel(dataclasses.replace(model.cfg, dtype=torch.float32,
                                               param_dtype=torch.float32))
        self.lm_models = {"bf16": model, "fp32": f32}
        self.lm_full = {}
        res = {}
        for name, m in self.lm_models.items():
            self.lm_full[name] = m.prefill_fn(params, {"tokens": prompts})["logits"]
            res[name] = self.split_decode(m, prompts)
            self.check(bool(torch.isfinite(self.lm_full[name]).all()
                            and torch.isfinite(res[name]).all()),
                       f"{name} prefill and decode logits are finite")
        self.lm_prompts = prompts
        for ok, what in self.cache_verdicts(res):
            self.check(ok, what)
        ev = self.lm_eval_numbers
        print(f"summary LM: forward {ev['s']:.3f} s at S={LM_SEQ} "
              f"({ev['tokens_per_s']:,.0f} tokens/s, peak {ev['peak_gb']:.2f} GB); "
              f"prefill {t_prefill * 1e3:.1f} ms; decode {n_dec / t_decode:,.1f} tokens/s")

    def split_decode(self, m, prompts):
        """prefill(t[:-1]) + decode(t[-1]): the last position's logits."""
        params = self.lm[1]
        short = m.prefill_fn(params, {"tokens": prompts[:, :-1]})
        _, dec = m.decode_fn(params, short["cache"], {"tokens": prompts[:, -1:]})
        self.sync()
        return dec

    def cache_verdicts(self, dec: dict) -> list[tuple[bool, str]]:
        """The cache invariant of tests/test_models.py at full width: in fp32
        at its tolerance and at LM_FP32_TOL, and in bf16 within the noise
        floor that the full bf16 prefill shows against the fp32 one."""
        full16, full32 = self.lm_full["bf16"], self.lm_full["fp32"]
        what = "fp32 prefill(t) against prefill(t[:-1]) + decode(t[-1])"
        return [self.verdict(full32, dec["fp32"], what, CACHE_TOL)[:2],
                self.verdict(full32, dec["fp32"], what, LM_FP32_TOL)[:2],
                self.noise_verdict(dec["bf16"], full16, full32,
                                   "bf16 prefill(t[:-1]) + decode(t[-1])", "bf16 prefill(t)")]

    # ------------------------------------------------------------ LM training
    def lm_train(self):
        """gemma2-2b training on the card: the backward kernel alone, the
        two attention paths' gradients, the full-width train step and the
        Trainer. lm_eval's parameters are freed first (the step needs the
        room) and drawn again from the same seed at the end, for
        lm_faults."""
        import gc

        torch = self.torch
        model = self.lm[0]
        digest = self.params_digest(self.lm[1])
        self.lm = (model, None)
        gc.collect()
        torch.cuda.empty_cache()
        verdicts, err = self.bwd_verdicts()
        for ok, what in verdicts:
            self.check(ok, what)
        self.bwd_timing(err)
        self.train_grads(model.cfg)
        self.train_steps(model.cfg)
        self.trainer_reduced()
        gc.collect()
        torch.cuda.empty_cache()
        self.lm = (model, model.init(seed=0))
        self.check(self.params_digest(self.lm[1]) == digest,
                   "lm_eval's parameters drawn again from seed 0 are the ones lm_eval "
                   "ran (per-parameter float64 sums and sums of squares equal)")

    def params_digest(self, params) -> list:
        torch = self.torch
        with torch.no_grad():
            return [(float(p.double().sum()), float(p.double().square().sum()))
                    for p in params.parameters()]

    def bwd_inputs(self):
        """The backward check's cases: (tag, dtype name, q, k, v, dO, kw).
        q (8, S, 256), k and v (4, S, 256), dO of q's shape, all seeded."""
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(BWD_SEED)
        bh, bhk, d = 8, 4, 256

        def draw(s, dtype, q_scale=1.0):
            q = (q_scale * torch.randn(bh, s, d, generator=g, device=self.dev)).to(dtype)
            k, v = (torch.randn(bhk, s, d, generator=g, device=self.dev).to(dtype)
                    for _ in range(2))
            do = torch.randn(bh, s, d, generator=g, device=self.dev).to(dtype)
            return q, k, v, do

        cap = dict(causal=True, softcap=50.0)
        cases = []
        for tag, dtype, s, q_scale, window in (
                ("local", torch.bfloat16, LM_SEQ, 1.0, 4096),
                ("global", torch.bfloat16, LM_SEQ, 1.0, 0),
                (f"local, q x {PEAK_SCALE:g}", torch.bfloat16, LM_SEQ, PEAK_SCALE, 4096),
                ("global fp32", torch.float32, BWD_FP32_SEQ, 1.0, 0)):
            q, k, v, do = draw(s, dtype, q_scale)
            name = "bf16" if dtype == torch.bfloat16 else "fp32"
            cases.append((f"{tag} ({bh}, {s}, {d}) {name}, window {window}, softcap 50",
                          name, q, k, v, do, dict(cap, window=window)))
        return cases

    def bwd_exact(self, q, k, v, do, kw):
        """The float64 gradients, head by head: the plain forward's lse and
        output and the plain backward of each query head against its KV
        head, dK and dV summed over each group's heads in head order."""
        torch, ref = self.torch, self.ref
        rep = q.shape[0] // k.shape[0]
        dq = torch.zeros(q.shape, dtype=torch.float64, device=self.dev)
        dk, dv = dq.new_zeros(k.shape), dq.new_zeros(k.shape)
        for h in range(q.shape[0]):
            one = [t[i:i + 1].double() for t, i in ((q, h), (k, h // rep), (v, h // rep),
                                                    (do, h))]
            _, lse, o = ref.flash_attention_fwd_ref(*one[:3], **kw)
            gq, gk, gv = ref.flash_attention_bwd_ref(*one, lse, o, **kw)
            dq[h] = gq[0]
            dk[h // rep] += gk[0]
            dv[h // rep] += gv[0]
            del one, lse, o, gq, gk, gv
        return dq, dk, dv

    def bwd_verdicts(self) -> tuple[list[tuple[bool, str]], float]:
        """The backward kernel through FlashAttention (forward kernel with
        lse and the fp32 output, then flash_attention_bwd) against the
        float64 plain versions, head by head: each of dq, dk and dv of each
        head within one bf16 ulp of its largest magnitude (GRAD_ULP_FLOOR),
        at the training step's shapes, peaked scores and in fp32, and in
        bf16 at most BWD_MISROUNDED_SHARE of each gradient's elements more
        than half their own bf16 ulp from float64. Returns the verdicts and
        the largest error."""
        torch, ops = self.torch, self.ops
        out, largest = [], 0.0
        for tag, name, q, k, v, do, kw in self.bwd_inputs():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            ops.reset_launches()
            o = ops.flash_attention(*leaves, **kw)
            got = torch.autograd.grad(o, leaves, do)
            self.sync()
            n = ops.launches()
            out.append((n["flash_attention"] == 1 and n["flash_attention_bwd"] == 1,
                        f"flash_attention_bwd {tag}: one forward and one backward launch "
                        f"({n['flash_attention']}, {n['flash_attention_bwd']})"))
            want = self.bwd_exact(q, k, v, do, kw)
            for g, w, gname in zip(got, want, ("dq", "dk", "dv")):
                worst, err, share = self.grad_errors(g, w)
                if name == "bf16":
                    out.append((share <= BWD_MISROUNDED_SHARE,
                                f"flash_attention_bwd {tag}: {gname}'s elements not float64's "
                                f"value rounded to bf16 (more than half their own bf16 ulp "
                                f"from it): a share of {share:.2e} (at most "
                                f"{BWD_MISROUNDED_SHARE:g})"))
                out.append((worst <= 1.0,
                            f"flash_attention_bwd {tag}: {gname} of each head within one "
                            f"bf16 ulp of its largest magnitude (at least {GRAD_ULP_FLOOR:g}) "
                            f"of the float64 plain version: worst err / ulp {worst:.3f}, "
                            f"max abs err {err:.3e}"))
                largest = max(largest, err)
            del leaves, o, got, want
        return out, largest

    def grad_errors(self, g, w) -> tuple[float, float, float]:
        """A gradient g (H, S, D) against its float64 value w, head by head:
        the worst error over one bf16 ulp of its head's largest magnitude
        (at least GRAD_ULP_FLOOR), the largest error, and the share of
        elements more than half their own bf16 ulp from w."""
        torch = self.torch
        worst, largest, off = 0.0, 0.0, 0
        for h in range(g.shape[0]):
            top = float(w[h].abs().max())
            atol = max(2.0 ** (math.floor(math.log2(top)) - 7), GRAD_ULP_FLOOR)
            diff = (g[h].double() - w[h]).abs()
            largest = max(largest, float(diff.max()))
            worst = max(worst, float(diff.max()) / atol)
            # half of each element's own bf16 ulp (0 where float64 is 0)
            half_ulp = torch.exp2(torch.floor(torch.log2(w[h].abs())) - 8)
            off += int((diff > half_ulp).sum())
            del diff, half_ulp
        return worst, largest, off / g.numel()

    def bwd_timing(self, err: float):
        """The backward launch of each kind at the step's shapes, beside its
        bound, its achieved bf16 TFLOP/s (of the 11 passes the bound counts
        and of the 13 the kernels compute), its plain version, the backward
        of flex_attention (the library call of the same function) and, at
        softcap 0, the backward of scaled_dot_product_attention; the kernels
        line's row."""
        torch, ops, ref = self.torch, self.ops, self.ref
        bh, bhk, d = 8, 4, 256
        scale = d ** -0.5
        per = {}
        for window, kind in ((4096, "local"), (0, "global")):
            q = self.randn(bh, LM_SEQ, d).to(torch.bfloat16)
            k, v = (self.randn(bhk, LM_SEQ, d).to(torch.bfloat16) for _ in range(2))
            do = self.randn(bh, LM_SEQ, d).to(torch.bfloat16)
            pairs = bh * visible_pairs(LM_SEQ, window)
            n_bytes = (sum(t.numel() * t.element_size() for t in (q, k, v, do)) * 2
                       + q.numel() * 4 + bh * LM_SEQ * 4)
            tb = n_bytes / HBM_BYTES_PER_S * 1e3
            bms = max(tb, 11 * 2.0 * d * pairs / BF16_TENSOR_FLOPS * 1e3)
            b32 = max(tb, 5 * 2.0 * d * pairs / FP32_FLOPS * 1e3)
            res = {}
            for cap in (50.0, 0.0):
                kw = dict(causal=True, window=window, softcap=cap, scale=scale)
                _, lse, o32 = ops._flash_forward(q, k, v, True, window, cap, scale, keep=True)
                res[cap] = self.cuda_ms(lambda: ops.flash_attention_bwd(
                    q, k, v, do, lse, o32, **kw))
                if cap:
                    pms = self.cuda_ms(lambda: ref.flash_attention_bwd_ref(
                        q, k, v, do, lse, o32, **kw), reps=1)
                    grads = ops.flash_attention_bwd(q, k, v, do, lse, o32, **kw)
                del lse, o32
            # softcap 50: the backward of flex_attention
            flex, fkw = self.flex(window)
            fleaves = [t.detach()[None].requires_grad_() for t in (q, k, v)]
            fout = flex(*fleaves, scale=scale, **fkw)
            fgrads = torch.autograd.grad(fout, fleaves, do[None], retain_graph=True)
            worst = max(float((fg[0].float() - g.float()).abs().max() / g.float().abs().max())
                        for fg, g in zip(fgrads, grads))
            self.check(worst <= FLASH_TOL["bf16"]["rtol"],
                       f"flash_attention_bwd {kind} softcap 50: flex_attention's backward "
                       f"within {FLASH_TOL['bf16']['rtol']:g} of each gradient's "
                       f"largest magnitude of the kernel's: {worst:.2e}")
            # how close each comes to float64 (bwd_verdicts' two measures)
            want = self.bwd_exact(q, k, v, do, dict(causal=True, window=window, softcap=50.0))
            for who, gs in (("kernel", grads), ("flex_attention", [fg[0] for fg in fgrads])):
                errs = [self.grad_errors(g, w) for g, w in zip(gs, want)]
                print(f"    flash_attention_bwd {kind}: {who} against float64: dq, dk, dv "
                      f"worst err / ulp of the largest "
                      f"{', '.join(f'{e[0]:.3f}' for e in errs)}; misrounded shares "
                      f"{', '.join(f'{e[2]:.2e}' for e in errs)}")
            lib = self.cuda_ms(lambda: torch.autograd.grad(fout, fleaves, do[None],
                                                           retain_graph=True))
            del fleaves, fout, fgrads, grads, want
            mask = None
            if window:
                pos = torch.arange(LM_SEQ, device=self.dev)
                diff = pos[:, None] - pos[None, :]
                mask = (diff >= 0) & (diff < window)
            leaves = [t.detach()[None].requires_grad_() for t in (q, k, v)]
            out = torch.nn.functional.scaled_dot_product_attention(
                *leaves, attn_mask=mask, is_causal=mask is None, enable_gqa=True)
            lib0 = self.cuda_ms(lambda: torch.autograd.grad(out, leaves, do[None],
                                                            retain_graph=True))
            # achieved bf16 tensor rate: the 11 passes the bound counts, and the
            # 13 the two kernels compute (S and dP in each of them)
            rate = {n: n * 2.0 * d * pairs / (res[50.0] * 1e-3) / 1e12 for n in (11, 13)}
            print(f"    flash_attention_bwd {kind}: {res[50.0]:.3f} ms kernel, {pms:.3f} ms "
                  f"plain, bound {bms:.3f} ms (operations: 11 bf16 tensor passes a visible "
                  f"pair, S and dP, and dV, dQ and dK with P and dS split in three; kernel "
                  f"at {res[50.0] / bms:.1f}x); achieved {rate[11]:.1f} TFLOP/s of the "
                  f"11-pass work, {rate[13]:.1f} of the 13 passes computed, against "
                  f"{BF16_TENSOR_FLOPS / 1e12:.0f}; the same 5 products on the fp32 pipes "
                  f"{b32:.3f} ms (kernel at {res[50.0] / b32:.2f}x); flex_attention's "
                  f"backward {lib:.3f} ms; softcap 0: {res[0.0]:.3f} ms kernel, "
                  f"{lib0:.3f} ms scaled_dot_product_attention's backward")
            per[kind] = dict(ms=res[50.0], plain=pms, bound=bms, b32=b32, ms0=res[0.0],
                             lib0=lib0, lib=lib, tflops11=rate[11],
                             tflops13=rate[13])
            del q, k, v, do, leaves, out, mask
        n = 13

        def total(key):
            return n * (per["local"][key] + per["global"][key])

        self.add_row("flash_attention_bwd", "flash_attention_bwd.cu",
                     "src/repro/kernels/flash_attention.py:78",
                     status="redesigned: bf16 on the tensor cores (mma.sync, P and dS "
                            "split into three bf16 terms, cp.async tiles); fp32 SIMT",
                     max_abs_err=err, ms=total("ms"), plain_ms=total("plain"),
                     bound_ms=total("bound"), bound_by="operations",
                     library_ms=total("lib"),
                     library="the backward of torch.nn.attention.flex_attention under "
                             "torch.compile: score_mod 50 tanh(s / 50), a causal and window "
                             "block mask, enable_gqa",
                     shapes=f"one gemma2-2b train step's attention backward: 13 local "
                            f"(window 4096) + 13 global launches, q (8, {LM_SEQ}, 256), "
                            f"k/v (4, {LM_SEQ}, 256) bf16, causal, softcap 50; bound: 11 "
                            "bf16 tensor passes a visible pair",
                     replaces_note="the Pallas kernel has no backward: the JAX package "
                                   "differentiates its chunked scan, "
                                   "src/repro/models/layers.py:364",
                     bound_ms_fp32_pipes=total("b32"),
                     local_ms=per["local"]["ms"], global_ms=per["global"]["ms"],
                     tflops_11_passes={k: per[k]["tflops11"] for k in per},
                     tflops_13_passes={k: per[k]["tflops13"] for k in per},
                     softcap0_ms=total("ms0"), softcap0_library_ms=total("lib0"),
                     softcap0_library="scaled_dot_product_attention's backward, "
                                      "enable_gqa, the same causal and window mask")

    def grads_of(self, model, params, batch) -> tuple[float, dict]:
        """(loss, {name: gradient}) of one loss_fn and backward; the
        gradients are taken off the parameters."""
        for p in params.parameters():
            p.grad = None
        loss, _ = model.loss_fn(params, batch)
        loss.backward()
        grads = {n: p.grad for n, p in params.named_parameters()}
        for p in params.parameters():
            p.grad = None
        return float(loss.detach()), grads

    def train_grads(self, cfg):
        """The flash path's gradients against the direct path's, from the
        same parameters on the same batch (B = 1, S = 8,192), and both
        against the fp32 direct path's (the bf16 weights cast to fp32)."""
        import dataclasses

        from repro_torch.data.tokens import TokenStream
        from repro_torch.models import DecoderModel
        from repro_torch.optim.adamw import global_norm

        torch, ops = self.torch, self.ops
        model = DecoderModel(cfg)
        params = model.init(seed=0)
        batch = TokenStream(cfg, 1, LM_SEQ, seed=0)(0)
        direct = dataclasses.replace(cfg, chunked_attn_min_len=LM_SEQ + 1)
        runs = {}
        for name, c in (("flash bf16", cfg), ("direct bf16", direct),
                        ("direct fp32", dataclasses.replace(direct, dtype=torch.float32))):
            ops.reset_launches()
            t0 = time.perf_counter()
            loss, grads = self.grads_of(DecoderModel(c), params, batch)
            self.sync()
            n = ops.launches()
            runs[name] = (loss, grads, float(global_norm(grads)))
            print(f"  {name}: loss {loss:.6f}, grad norm {runs[name][2]:.6f}, "
                  f"{time.perf_counter() - t0:.2f} s, launches {n}")
            if name == "flash bf16":
                self.check(n["flash_attention"] == 2 * cfg.n_layers
                           and n["flash_attention_bwd"] == cfg.n_layers,
                           "flash bf16 loss and backward: 52 flash launches (forward and "
                           "recompute) and 26 backward launches")
            else:
                self.check(sum(n.values()) == 0, f"{name}: no launch of a kernel of the port")
        (lf, gf, nf), (ld, gd, nd), (l32, g32, n32) = runs.values()
        self.check(lf == self.lm_eval_loss,
                   f"the flash path's loss with grad, {lf:.6f}, is lm_eval's no-grad loss "
                   f"{self.lm_eval_loss:.6f} bit for bit")
        self.check(abs(lf - ld) <= LM_LOSS_RTOL * abs(ld),
                   f"loss with grad: flash {lf:.6f} against direct {ld:.6f}: |diff| "
                   f"{abs(lf - ld):.2e} <= {LM_LOSS_RTOL} x |loss|")
        self.check(abs(nf - nd) <= GRAD_NORM_RTOL * nd,
                   f"global gradient norm: flash {nf:.6f} against direct {nd:.6f}: |diff| "
                   f"{abs(nf - nd):.2e} <= {GRAD_NORM_RTOL} x norm (fp32 direct {n32:.6f})")
        worst_rel, worst_ratio, rows = 0.0, 0.0, []
        for name in gf:
            f, dd, r = (x[name].float() for x in (gf, gd, g32))
            ef, ed = float((f - r).norm()), float((dd - r).norm())
            rel = float((f - dd).norm()) / max(float(dd.norm()), 1e-30)
            ratio = ef / max(ed, 1e-30)
            rows.append((name, rel, ratio))
            worst_rel, worst_ratio = max(worst_rel, rel), max(worst_ratio, ratio)
        for name, rel, ratio in sorted(rows, key=lambda r: -r[1])[:6]:
            print(f"    {name}: |flash - direct| / |direct| {rel:.3e}; |flash - fp32| / "
                  f"|direct - fp32| {ratio:.3f}")
        ratios = sorted(r[2] for r in rows)
        print(f"  per-parameter |flash - fp32| / |direct - fp32| over {len(rows)} tensors: "
              f"median {ratios[len(ratios) // 2]:.3f}, max {ratios[-1]:.3f}")
        self.check(worst_rel <= LM_GRAD_RTOL,
                   f"each parameter's gradient, flash path against direct path: "
                   f"|flash - direct| / |direct| <= {LM_GRAD_RTOL} (worst {worst_rel:.3e})")
        self.check(worst_ratio <= GRAD_NOISE_FACTOR,
                   f"each parameter's gradient on the flash path no farther from the fp32 "
                   f"gradient than {GRAD_NOISE_FACTOR}x the direct bf16 path's (in the "
                   f"2-norm; worst {worst_ratio:.3f})")
        self.lm_grad_norm = nf
        del runs, gf, gd, g32, params

    def train_steps(self, cfg):
        """make_train_step at full width: one warm-up step, LM_TRAIN_STEPS
        timed (the main path), a profiled one and one at S = 4,096 (the
        train_4k shape's length, the direct path)."""
        import gc

        from repro_torch.data.tokens import TokenStream
        from repro_torch.launch.train import init_train_state, make_train_step
        from repro_torch.optim import AdamWConfig

        torch, ops = self.torch, self.ops
        opt = AdamWConfig()
        t0 = time.perf_counter()
        state = init_train_state(cfg, 0, opt)
        self.sync()
        n_params = sum(p.numel() for p in state.params.parameters())
        print(f"train state on the card: {n_params:,} parameters, bf16, and fp32 AdamW "
              f"moments in {time.perf_counter() - t0:.2f} s; "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
        step = make_train_step(cfg, opt)
        data = TokenStream(cfg, 1, LM_SEQ, seed=0)
        batches = [data(i) for i in range(LM_TRAIN_STEPS + 1)]
        torch.cuda.reset_peak_memory_stats()
        state, m = step(state, batches[0])                # warm-up
        first = (float(m["loss"]), float(m["grad_norm"]), float(m["lr"]))
        warm_peak = torch.cuda.max_memory_allocated() / 1e9
        self.check(first[0] == self.lm_eval_loss,
                   f"the first step's loss {first[0]:.6f} is lm_eval's no-grad loss on the "
                   f"same batch, {self.lm_eval_loss:.6f}, bit for bit")
        self.check(first[1] == self.lm_grad_norm,
                   f"the first step's grad_norm {first[1]:.6f} is the flash gradients' "
                   f"global norm {self.lm_grad_norm:.6f} bit for bit")
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()                      # the main path starts here
        times, losses = [], []
        for batch in batches[1:]:
            self.sync()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            times.append(time.perf_counter() - t0)
        launches = ops.launches()                 # ... and is read here
        peak = torch.cuda.max_memory_allocated() / 1e9
        self.path_launches["lm_train"] = launches
        self.main_launches["flash_attention_bwd"] = launches["flash_attention_bwd"]
        dt = sum(times) / len(times)
        per = {k: v / LM_TRAIN_STEPS for k, v in launches.items() if v}
        attn = 12.0 * cfg.hd * cfg.n_heads * (cfg.n_layers // 2) * (
            visible_pairs(LM_SEQ, cfg.sliding_window) + visible_pairs(LM_SEQ, 0))
        flops = 6.0 * n_params * LM_SEQ + attn
        share = flops / (dt * BF16_TENSOR_FLOPS)
        print(f"train step at B=1, S={LM_SEQ}, remat on: {dt:.3f} s a step "
              f"({', '.join(f'{t:.3f}' for t in times)}), {LM_SEQ / dt:,.0f} tokens/s, "
              f"peak device memory {peak:.2f} GB (warm-up step {warm_peak:.2f} GB), "
              f"model FLOPs {flops / 1e12:.1f} TFLOP a step (6 N tokens + attention "
              f"{attn / 1e12:.1f}), {share:.3f} of {BF16_TENSOR_FLOPS / 1e12:.0f} TFLOP/s; "
              f"launches a step {per}; losses {first[0]:.5f} then "
              f"{', '.join(f'{x:.5f}' for x in losses)}, lr {first[2]:.3g} first")
        self.check(launches["flash_attention"] == 2 * cfg.n_layers * LM_TRAIN_STEPS
                   and launches["flash_attention_bwd"] == cfg.n_layers * LM_TRAIN_STEPS
                   and sum(launches.values()) == 3 * cfg.n_layers * LM_TRAIN_STEPS,
                   f"each step launched the flash forward twice a layer (forward and "
                   f"recompute, {2 * cfg.n_layers}) and its backward once "
                   f"({cfg.n_layers}), and no other kernel of the port")
        self.check(all(self.np.isfinite(x) for x in losses + list(first)),
                   "every step's loss and grad_norm are finite")
        self.check(peak < 80.0, f"peak device memory {peak:.2f} GB is under 80 GB")
        self.lm_train_numbers = dict(s=dt, tokens_per_s=LM_SEQ / dt, peak_gb=peak,
                                     share=share)

        def kind(key):
            for part, name in (("flash_mma_kernel", "flash forward"),
                               ("flash_bwd_dkdv", "flash backward dk dv"),
                               ("flash_bwd_dq", "flash backward dq"),
                               ("flash_bwd_delta", "flash backward delta"),
                               ("simt_sgemm", "fp32 products (the head's backward)"),
                               ("nvjet", "bf16 products"), ("gemm", "other products"),
                               ("elementwise", "elementwise"), ("reduce", "reductions")):
                if part in key:
                    return name
            return "other"

        events = self._profile(lambda: step(state, batches[1]), dt * 1e3, "train step")
        if events:
            groups: dict[str, list] = {}
            for e in events:
                g = groups.setdefault(kind(e.key), [0.0, 0])
                g[0] += e.device_time_total / 1e3
                g[1] += e.count
            busy = sum(g[0] for g in groups.values())
            for name, (ms, count) in sorted(groups.items(), key=lambda x: -x[1][0]):
                print(f"  train step split: {name:36s} {ms:9.2f} ms  x{count:<6d} "
                      f"({ms / busy:.3f} of device busy)")
        short = TokenStream(cfg, 1, LM_TRAIN_SHORT, seed=0)(0)
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        self.sync()
        t0 = time.perf_counter()
        state, m = step(state, short)
        loss = float(m["loss"])
        dt4 = time.perf_counter() - t0
        n = ops.launches()
        print(f"train step at B=1, S={LM_TRAIN_SHORT} (train_4k's length, the direct "
              f"path): {dt4:.3f} s, loss {loss:.5f}, grad norm {float(m['grad_norm']):.4f}, "
              f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, launches {n}")
        self.check(bool(self.np.isfinite(loss)) and sum(n.values()) == 0,
                   f"the S = {LM_TRAIN_SHORT} step takes the direct path (no launch of a "
                   "kernel of the port) and its loss is finite")
        del state, step, m
        gc.collect()

    def trainer_reduced(self):
        """runtime.Trainer on the card at reduced gemma2-2b (S = 64: the flash
        kernels in every layer) with a failure injected at step 7: it
        recovers from the step-5 checkpoint, which restores the state saved
        there bit for bit, and reaches step 12."""
        from repro_torch.configs import get_config, reduced
        from repro_torch.data.tokens import TokenStream
        from repro_torch.launch.train import init_train_state, make_train_step
        from repro_torch.optim import AdamWConfig
        from repro_torch.runtime import Trainer, TrainerConfig
        from repro_torch.runtime.trainer import state_arrays

        np, ops = self.np, self.ops
        cfg = reduced(get_config("gemma2-2b"))
        opt = AdamWConfig(lr=1e-3)
        tr = Trainer(make_train_step(cfg, opt, total_steps=100),
                     init_train_state(cfg, 0, opt), TokenStream(cfg, 2, 64, seed=0),
                     TrainerConfig(ckpt_dir=str(Path(self.tmp.name) / "lm_ckpt"),
                                   ckpt_every=5, use_async_ckpt=False, fail_at_steps=(7,)))
        saved, restored = {}, []
        real_save, real_recover = tr._save, tr._recover

        def save():
            saved[tr.step] = state_arrays(tr.state)
            real_save()

        def recover():
            real_recover()
            live, disk = state_arrays(tr.state), tr.store.read_arrays(tr.step)
            same = (live.keys() == saved[tr.step].keys()
                    and all(np.array_equal(a, saved[tr.step][k])
                            and a.dtype == saved[tr.step][k].dtype
                            and np.array_equal(a, disk[f"['{k}']"]) for k, a in live.items()))
            restored.append((tr.step, same, len(live)))

        tr._save, tr._recover = save, recover
        ops.reset_launches()
        out = tr.run(12, log_every=100)
        n = ops.launches()
        print(f"Trainer at reduced gemma2-2b on the card: final step {out['final_step']}, "
              f"recoveries {out['recoveries']}, restores {restored}, loss "
              f"{out['loss_history'][0]:.4f} -> {out['loss_history'][-1]:.4f}, launches {n}")
        self.check(out["final_step"] == 12 and out["recoveries"] == 1
                   and [r[0] for r in restored] == [5],
                   "the Trainer recovered once, from the step-5 checkpoint, and reached "
                   "step 12")
        self.check(all(r[1] for r in restored),
                   f"the restored state equals the state saved at step 5 bit for bit, in "
                   f"memory and on disk ({restored[0][2] if restored else 0} arrays)")
        self.check(n["flash_attention_bwd"] > 0 and all(
            np.isfinite(x) for x in out["loss_history"]),
            "the reduced steps ran the backward kernel and every loss is finite")

    def lm_faults(self):
        """Faults planted in the LM path, one at a time, each run through the
        checks of lm_eval or lm_serve: at least one of them must fail. The
        plants patch the module attributes the model calls and are undone
        before the next; the flash plants act in the bf16 instantiation
        only, the one the forward launches, so that the fp32 checks cannot
        be what catches them."""
        from repro_torch.models import layers

        torch, ops = self.torch, self.ops
        real_flash, real_mha = ops.flash_attention, layers.multi_head_attention

        def flash_plant(change):
            def planted(q, k, v, **kw):
                if q.dtype == torch.bfloat16:
                    q, k, v, kw = change(q, k, v, dict(kw))
                return real_flash(q, k, v, **kw)
            return planted

        def softcap_dropped(q, k, v, kw):
            return q, k, v, dict(kw, softcap=0.0)

        def window_short(q, k, v, kw):
            return q, k, v, dict(kw, window=kw["window"] - 64 if kw["window"] else 0)

        def k_row_off(q, k, v, kw):
            return q, k.roll(1, dims=1), v, kw

        def decode_slot_off(q, k, v, **kw):
            # a decode step whose causal bound stops one slot short: it
            # does not see the key it just wrote
            if q.shape[1] == 1 and isinstance(kw.get("q_offset"), torch.Tensor):
                kw["q_offset"] = kw["q_offset"] - 1
            return real_mha(q, k, v, **kw)

        real_bwd = ops.flash_attention_bwd

        def bwd_plant(change):
            def planted(q, k, v, do, lse, o, **kw):
                if q.dtype == torch.bfloat16:
                    lse, kw = change(lse, dict(kw))
                return real_bwd(q, k, v, do, lse, o, **kw)
            return planted

        def lse_row_off(lse, kw):
            return lse.roll(1, dims=1), kw

        def bwd_softcap_dropped(lse, kw):
            return lse, dict(kw, softcap=0.0)

        build = self.build_mod
        real_library = build.library
        one_term = self.planted_one_term_library()

        def library_plant(lib):
            def planted(name):
                return lib if name == "flash_attention_bwd" else real_library(name)
            return planted

        plants = [("flash, bf16: softcap dropped", ops, "flash_attention",
                   flash_plant(softcap_dropped), "forward"),
                  ("flash, bf16: softcap dropped", ops, "flash_attention",
                   flash_plant(softcap_dropped), "forward, wq scaled"),
                  ("flash, bf16: window a tile (64 keys) short", ops, "flash_attention",
                   flash_plant(window_short), "forward"),
                  ("flash, bf16: K read a row off", ops, "flash_attention",
                   flash_plant(k_row_off), "forward"),
                  ("decode: the step misses its own slot", layers, "multi_head_attention",
                   decode_slot_off, "cache"),
                  ("backward, bf16: lse read a row off", ops, "flash_attention_bwd",
                   bwd_plant(lse_row_off), "backward"),
                  ("backward, bf16: softcap dropped", ops, "flash_attention_bwd",
                   bwd_plant(bwd_softcap_dropped), "backward"),
                  ("backward, bf16: P and dS in one bf16 term (x2, x3 dropped)", build,
                   "library", library_plant(one_term), "backward")]
        cfg = self.lm[0].cfg
        for name, mod, attr, fn, checks in plants:
            saved = getattr(mod, attr)
            setattr(mod, attr, fn)
            try:
                if checks == "forward":
                    with self.probed() as recs:
                        runs = dict(self.lm_runs, **{"flash bf16": self.lm_forward(cfg)})
                    verdicts = self.forward_verdicts(
                        runs, dict(self.lm_layers, **{"flash bf16": recs}))
                elif checks == "forward, wq scaled":
                    with self.scaled_wq(), self.probed() as recs:
                        planted = {"flash bf16": self.lm_forward(cfg)}
                    verdicts = self.scaled_verdicts(
                        dict(self.lm_wq_runs, **planted),
                        dict(self.lm_wq_layers, **{"flash bf16": recs}))
                elif checks == "backward":
                    verdicts = self.bwd_verdicts()[0]
                else:
                    dec = {n: self.split_decode(m, self.lm_prompts)
                           for n, m in self.lm_models.items()}
                    verdicts = self.cache_verdicts(dec)
            finally:
                setattr(mod, attr, saved)
            caught = [what for ok, what in verdicts if not ok]
            for ok, what in verdicts:
                print(f"    {name}: {'passes' if ok else 'FAILS'} {what}")
            self.check(bool(caught), f"planted fault '{name}' fails {len(caught)} of "
                       f"{len(verdicts)} {checks} checks")
        self.check(ops.flash_attention is real_flash and ops.flash_attention_bwd is real_bwd
                   and layers.multi_head_attention is real_mha
                   and build.library is real_library, "every plant undone")

    def planted_one_term_library(self):
        """flash_attention_bwd.cu with P and dS taken in one bf16 term: the
        MMAs of x2 and x3 dropped from add_product, built from the
        checkout's source text into build/planted/ and loaded as the real
        library is."""
        import ctypes

        build = self.build_mod
        source = build.CSRC / build.KERNELS["flash_attention_bwd"][0]
        text = source.read_text()
        for x in ("x2", "x3"):
            for half in ("acc[2 * dp], {}[kk], b[0], b[1]",
                         "acc[2 * dp + 1], {}[kk], b[2], b[3]"):
                line = f"      mma_bf16({half.format(x)});\n"
                if text.count(line) != 1:
                    raise RuntimeError(f"plant: '{line.strip()}' is not in {source.name} once")
                text = text.replace(line, "")
        out = build.BUILD_DIR.parent / "planted"
        out.mkdir(parents=True, exist_ok=True)
        (out / source.name).write_text(text)
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
                               str(out / "one_term.so"), str(out / source.name)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the one-term plant:\n{proc.stdout}{proc.stderr}")
        lib = ctypes.CDLL(str(out / "one_term.so"))
        for fn, argtypes in build.KERNELS["flash_attention_bwd"][1]:
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        return lib

def visible_pairs(s: int, window: int) -> int:
    """(query, key) pairs a causal sequence of s tokens attends, with a
    sliding window (0 = none): sum over q of min(q + 1, window)."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


if __name__ == "__main__":
    sys.exit(main())
