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
  2. lint     the port's lint, `python -m repro_torch.analysis`, in a
              subprocess on the tree the run started from (or --src): it
              must exit 0; then its cuda-spill rule over this run's ptxas
              output (a kernel built before the run is compiled again into
              a temporary directory for it), each kernel entry's registers,
              spill bytes and static shared memory printed; a spill not in
              .repro-torch-lint-baseline.json fails the run
  3. data     chembl_like(scale=1.0) with a 0.1 test split, and the
              balanced bucket plans of both sides (through GibbsSampler)
  4. kernels  each BPMF training kernel at K = 64 against its plain
              PyTorch version on the card at the run's shapes (the syrk
              kernels bit for bit; the solve on both half-sweeps' systems
              as a sweep builds them and as the prior hyperparameters give
              them, the same bits on two calls), timed beside its bound and one
              PyTorch call that computes the same function where there is
              one; gather_syrk_seg also through its launcher alone (the
              wrapper's host share), and each bucket the syrk kernels'
              narrow paths can stage down both paths, to show where the
              threshold lies
  5. ranks    the same kernels at K = 16, 24 and 32 (24 through the
              wrappers' padding), the solve timed at each
  6. topn     top-N at serving's shapes, bit for bit in one slab and in
              several, timed beside topk(u @ v.T); the CUDA kernels of one
              call counted in its profile
  7. train    GibbsSampler(engine="fused") for 8 sweeps (burn-in 4),
              retaining draws into a SampleStore, then 2 sweeps with
              engine="kernel"; the launch counts are asserted
  8. parity   one half-sweep per side for "fused" and "kernel", and a
              3-sweep "fused" chain, against the plain path under the same
              state and noise; then at the quickstart's shape and rank
              (chembl_like(0.01), k = 32, alpha 2.0) both half-sweeps and
              3-sweep chains of "fused" and "kernel" against "einsum"
  9. learning movielens_like(0.05), alpha=4.0: posterior-mean RMSE <= 0.545
 10. serve    PosteriorEnsemble.load -> TopNRecommender.recommend for 4,096
              users with seen-item exclusion, against the plain path, and
              where one batch's time goes (kernel on the card, host)
 11. foldin   cold-start fold-in of 4,096 ChEMBL users (their training
              ratings as new users) against the 4 retained draws, batches
              of 256 and 4,096, engines fused and kernel: every launch held
              against its plain version on its own inputs (syrk kernels
              bit for bit, the solve within 2e-3 and the same bits twice),
              the outputs against the plain path and each other, clones of
              the 64 best-constrained users against the trained ensemble,
              no plan-schema miss on a second batch of each profile; ms,
              launches and peak memory per batch, each kernel timed at the
              fold-in's shapes
 12. cotrain  the chain of phase train goes on for 12 sweeps in a trainer
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
 13. serve_faults faults planted in the fold-in (statistics a user off,
              the fused kernel given one draw's factors, noise in the
              posterior mean) and in the barrier (a commit after one
              shard): each must fail a check of phase 11 or 12
 13b. serve_devices the serving tier placed over devices, on the
              retained ensemble of phase 7, 4,096 users, top 10, seen
              items excluded: a 4-host, 2-replica tier over
              serving_host_devices(n_hosts=4) (all on cuda:0) bit for bit
              TopNRecommender, a top-N launch a shard a batch; a card + host
              tier, devices cuda:0, cpu, cuda:0, cpu (the cpu shards on the
              plain version), bit for bit the coordinator-side merge of
              each shard's candidates scored alone on its device, and bit
              for bit the all-card tier (tolerance 0: the plain version
              sums in the kernel's order); a mixed tier
              over (cuda:0, cpu) x 2, replicas 2, attached to a channel:
              two publishes commit, both owners of the cpu shard are killed
              and the shard is rebuilt on cuda:0 (stats() names it), then
              served bit for bit one host on the committed ensemble;
              RecommendFrontend(mesh=make_host_mesh()) bit for bit one host
 14. dist     the paper's distributed sampler at the ChEMBL shape: P = 4
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
 14b. dist_ranks  the same sampler with one shard a process: 4 ranks on
              cuda:0 on a gloo group (blocks staged through pinned host
              buffers), at phase dist's shape, state and noise; each
              rank's shard of one sweep a mode bit for bit the one-process
              P = 4 sampler's, the hyperparameters equal on every rank,
              every gather_syrk_seg launch of the ranks' ring and allgather
              sweeps bit for bit its plain version, a ring planted to
              forward to r - 1 must fail; sweep seconds a mode (median of
              3), rank 0's time blocked in the ring's waits, the
              exchange's hidden share, peak memory a rank; then one rank
              on an NCCL group, bit for bit the P = 1 sampler
 15. sgld     the minibatch SGLD samplers and the ALS baseline, which launch
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
 16. lm_kernels  the flash-attention kernel against its plain version at
              the gemma2-2b forward's shapes, (8, 8,192, 256) bf16 with 4
              KV heads, causal, softcap 50, window 4,096 and 0; at a
              ragged S = 8,000 and in fp32; bf16 within 3e-2 and within a
              bf16 ulp, also on peaked scores (q x 6), where the ulp limit
              must reject the plain versions of neighbouring functions (a
              dropped softcap, K a row off, a window a tile short) and
              the kernel lies within an ulp of float64; at q x 16 and
              softcap 0 within 3e-2 and no farther from float64 than the
              plain version; timed
              beside its bound (2 bf16 tensor passes a visible pair; the
              kernel's 4 beside it), the
              bound of P V on the fp32 pipes and flex_attention (compiled,
              softcap 50 by score_mod) and, at softcap 0,
              beside scaled_dot_product_attention; digests of an fp32 and a bf16
              output, to hold the kernels' bits against another commit's;
              then the flash pair at the other configs' shapes, (32, 8,192,
              64) over 32 KV heads, (24, 8,192, 64) over 8 and (48, 8,192,
              128) over 1, bf16, softcap 0, window 0: the forward against its
              plain version and float64, the backward against float64 head
              by head (lm_train's gates), each timed beside its bound, its
              plain version and scaled_dot_product_attention's forward or
              backward; and the backward alone at the cut train steps'
              shapes (zamba2-7b's (32, 8,192, 112) over 32 in bf16 and fp32,
              qwen2-vl-7b's (28, 8,192, 128) over 4 in bf16): against
              float64 head by head at lm_train's gates, the fp32 one also
              against its plain version, each timed beside its bound, its
              plain version and scaled_dot_product_attention's backward
 17. lm_eval  the full-width gemma2-2b forward (DecoderModel.loss_fn, seeded
              init) on one TokenStream batch, B = 1, S = 8,192: 26 flash
              launches and a finite loss; loss and last-position logits
              against the same forward down the direct attention path, in
              bf16 and in fp32, and each layer's flash attention on its own
              inputs against float64; again with every wq x 16, where the
              attention scores pass the softcap of 50, with the two paths'
              distance at 1 to 26 layers; the forward's profile shows its
              26 launches on the bf16 tensor-core kernel
 18. lm_serve launch.serve.generate: prefill of 4 x 2,048 prompts, then 31
              greedy decode steps, with no flash launch; the cache
              invariant prefill(t) == prefill(t[:-1]) + decode(t[-1]) in
              fp32 and in bf16
 19. lm_dense smollm-360m, stablelm-1.6b, granite-20b and
              granite-moe-3b-a800m at published widths, bf16, seeded init,
              gemma2-2b's parameters freed first: DecoderModel.loss_fn at
              B = 1, S = 8,192 (a flash launch a layer, a finite loss;
              seconds, tokens/s, peak memory; the MoE's aux); generate()
              with 4 x 2,048 prompts and 31 decode steps, and the cache
              invariant in fp32 and bf16 (the MoE at a capacity factor
              where nothing drops); the flash and direct paths' loss and
              last-position logits in bf16 and fp32 (granite-20b at 8
              layers); on the flash forward each layer norm against float64
              (stablelm, its norms' scales and biases drawn apart from the
              init's ones and zeros) and each MoE layer's dispatch buffer
              and output bit for bit against a plain version built apart
              from the port's sort (at the published capacity factor and at
              0.5, where replicas drop)
 20. lm_ssm   xlstm-350m and zamba2-7b at published widths, bf16, seeded
              init, gemma2-2b's parameters freed first: loss_fn at B = 1, S
              = 8,192 (no kernel launch for the xLSTM, whose mLSTM and sLSTM
              scans are plain PyTorch; one flash launch at D = 112 for each
              of zamba's 3 shared-block applications) with seconds, tokens/s,
              peak memory and the device's idle share (from a profile at S
              = 512); zamba2-7b's forward under the `opt` variant beside it;
              generate() with 4 x
              2,048 prompts and 31 decode steps and the cache invariant in
              fp32 and bf16; layer 0's chunked mLSTM / SSD scan on its own
              inputs against its sequential form in fp32 and float64; each
              of zamba's flash launches on its own inputs against the plain
              version and float64 head by head, each shared-block
              application recomputed from the one shared block to its bits,
              and the flash and direct paths' loss and last-position logits
              in bf16 and fp32; the flash forward alone at (32, 8,192, 112),
              bf16 and fp32 at S = 8,192, 8,191 and 100 against the plain
              version (and float64), timed beside its bound, its plain
              version and scaled_dot_product_attention; four planted faults
              (an fp32 flash build whose lanes cover 96 of 112 columns,
              compiled from the source text into build/planted/, a D = 112
              launch given the scale 1/sqrt(128), an mlstm_chunked without
              its inter-chunk stabilizer, shared-block applications with
              weights of their own), each of which must fail a check;
              then xlstm-350m's make_train_step at published width, B =
              1, S = 512: a warm-up and 1 timed step with remat (step
              seconds, tokens/s, peak memory) and one step without, whose
              peak the remat steps' must undercut by 10%, and a plant of
              the forward that ignored remat, which must fail that check;
              then zamba2-7b's make_train_step at full width and 54 of 81
              layers (two groups: the tied shared block applied twice), B =
              1, S = 8,192, remat on: the backward alone on each
              application's own flash inputs of the warm-up step against
              float64, 1 timed step (seconds, tokens/s, peak memory beside
              the modelled one, 2 forward and 2 backward launches) and the
              idle share of a profiled step at S = 512
 21. lm_mm    whisper-medium and qwen2-vl-7b at published widths, bf16,
              seeded init, gemma2-2b's parameters freed first: loss_fn at
              B = 1, S = 8,192 (whisper: 1,500 frames and 8,192 tokens, a
              causal self-attention and a non-causal cross-attention flash
              launch a decoder layer, 48; qwen2-vl: 1,024 patches and
              7,168 tokens, a launch a layer, 28) with seconds, tokens/s,
              peak memory and the device's idle share; the first and last
              layers' flash launches each on its own inputs against the
              plain version and float64 head by head (one bf16 ulp of the
              head's largest magnitude), the cross launch's ragged tail
              included; the flash and direct paths' loss and last-position
              logits at full depth in bf16 and fp32; generate() with 4
              prompts of 2,048 positions (whisper over its 1,500 frames,
              qwen2-vl 1,024 patches and 1,024 tokens) and 31 decode
              steps; the cache invariant on 512 tokens in fp32 and bf16,
              qwen2-vl on Qwen2-VL's own positions (patches at t = 0 on a
              32 x 32 grid, text from 32 on all three channels); the flash
              forward alone at the three new shapes, timed beside its
              bound, its plain version and scaled_dot_product_attention;
              two plants (whisper's cross launches fed K and V
              zero-padded to 1,536 keys, qwen2-vl decode positions from
              the cache's index), each of which must fail a check
 22. lm_train gemma2-2b training, lm_eval's parameters freed first: the
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
              make_train_step of stablelm-1.6b and granite-moe-3b-a800m at
              published widths (1 + 3 timed steps, remat on, B = 1, S =
              8,192), the MoE's first step reached again bit for bit from a
              fresh state; granite-20b's at 8 of 52 layers (1 + 3 steps,
              the measured peak beside the modelled one, the idle share);
              lm_eval's parameters drawn again from their seed
 23. lm_train_mm  whisper-medium's training at published widths (needs no
              other phase): the backward kernel at the cross-attention's
              (16, 8,192 x 1,500, 64), non-causal, on the first and last
              decoder layers' own inputs, each head's dq, dk and dv within
              one bf16 ulp of float64 and few elements more than half
              their own ulp off, two runs to the same bits; timed beside
              its bound, its plain version and the backward of
              scaled_dot_product_attention, also at the self-attention's
              (16, 8,192, 64); the full-width gradients of the flash path
              against the direct path and both against the fp32 direct
              path; make_train_step, B = 1, S = 8,192, remat on, 1 + 3
              timed steps (seconds, tokens/s, peak memory, 96 forward and
              48 backward launches a step) and a profiled one (the idle
              share); two builds of the backward planted in its ragged KV
              tile: the mask's k < S_k dropped alone (zero keys in P: the
              same bits) and with the tile loaded whole (what lies past
              S_k in P: the check must fail); then qwen2-vl-7b's
              make_train_step at 8 of 28 layers (1,024 patches, 7,168
              tokens; 1 + 3 steps, the measured peak beside the modelled
              one, the idle share)
 24. lm_faults   faults planted one at a time in the bf16 flash launches
              (window a tile short, K a row off, a dropped softcap, the
              last also under the wq x 16 forwards), in the decode step
              (it misses its own slot) and in the bf16 backward launches
              (lse read a row off, the softcap dropped, and a build of the
              kernel that takes P and dS in one bf16 term instead of
              three), in the fp32 backward (a build whose lanes cover 96
              of D = 112's columns: zamba2-7b's lm_kernels check on inputs
              of another seed must fail), in the MoE (a token's
              contributions added in descending expert order; a dropped
              replica written at its expert's last place) and in the layer
              norm (its bias dropped): each must fail one of the checks of
              phase 16, 17, 18, 19 or 20 (the MoE and norm checks at 4
              layers, as they hold each layer on its own input)
 25. dryrun   the dry-run and cost model (repro_torch/launch/dryrun.py,
              bpmf_dryrun.py, cost.py): (a) every cell of all_cells()
              (each config x its LM shapes, kimi-k2-1t-a32b's included) on
              the meta device at full size under the op-level cost counter,
              in DRYRUN_JOBS processes, one line a cell (parameters, peak
              GB, whether it fits one card, TFLOP, GB moved, the roofline's
              dominant term and bound), every cell ending ok (one that does
              not fit is a finding); meanwhile the host makes
              movielens_like(1.0) (138,493 x 27,278, 20 M ratings) and its
              grid plans at P = 4 (width "auto"); (b) three cells counted on
              the meta device at their exact shapes and run on the card:
              gemma2-2b's forward at B = 1, S = 8,192 (26 flash launches),
              stablelm-1.6b's train step at B = 1, S = 8,192 (the flash
              backward), and the ml20m ring sweep at K = 64 through
              gather_syrk_seg; each prints the measured device-busy time
              beside the modelled compute_s, memory_s and bound, and the
              modelled peak beside torch.cuda.max_memory_allocated; the busy
              time must be at least compute_s (at the bf16 peak, and with
              fp32 products at the fp32 pipes' rate), the modelled peak
              within DRYRUN_PEAK_RTOL of the measured one; the phase's host
              time against DRYRUN_BUDGET_S. (c), the model-FLOPs share, is
              phase 22's line: `models/api.py::model_flops_per_step`
 26. mesh     the LM on a device mesh (needs no other phase): (a) the
              flash pair with a query offset: gemma2-2b's local layer at
              S = 8,192 (softcap 50, window 4,096) and whisper-medium's
              cross-attention (8,192 x 1,500, non-causal), the queries cut
              into MESH_SHARDS shards at their offsets, each shard's
              forward and backward held to its plain version (the forward
              at the flash gates, the backward head by head against
              float64 within one bf16 ulp), the shards joined held to the
              whole launch (rows, lse and dQ bit for bit: the offsets are
              multiples of the query block; dK and dV summed at the
              backward's gate), each timed beside the whole launch;
              (b) gemma2-2b's full-width train step, B = 1, S = 8,192,
              remat on, on `make_host_mesh()` (a (1, 1) DeviceMesh over an
              NCCL group of one rank): params, moments and batch DTensors
              placed by `train_state_pspecs`, the step through the layers'
              regions and the flash pair; its loss and updated parameters
              bit for bit those of the same step without a mesh; (c) the
              reduced gemma2-2b trained on the card by the mesh-free
              Trainer, resumed onto the host mesh by a Trainer with
              `state_shardings` (`restore_resharded`), its next step bit
              for bit the live state's; (d) the mesh dry-run in a
              subprocess (the fake world and the NCCL group do not share a
              process), started first: kimi-k2-1t-a32b train_4k on
              2 x 16 x 16 with opt (the expert-parallel region), gemma2-2b
              train_4k and granite-moe-3b-a800m prefill_32k on 16 x 16,
              zamba2-7b long_500k on 2 x 16 x 16 (its K/V sequence over
              ("data", "model")) and whisper-medium decode_32k on 16 x 16,
              each ok with its per-device peak GB and whether it fits;
              (e) decode on the host mesh: xlstm-350m, zamba2-7b and
              whisper-medium (over its 1,500 frames) at full width, a
              prefill of MESH_DECODE_BATCH x MESH_DECODE_PROMPT tokens and
              MESH_DECODE_STEPS greedy steps with and without the mesh
              (the states and caches placed by `cache_pspecs`, each
              recurrent block a `state_region`), every step's logits and
              the final states and caches bit for bit the mesh-free ones,
              a step from zero states more than 1e-2 off, and each
              family's decode tokens/s on the mesh and off it (the median
              step after a warm-up step)
 27. report   one JSON line of kernels, the card line, and the last line
              {"ok": true, "device": {...}}

The main path is phases 7, 10, 17, 18 and 22, the serving tier's paths are
phases 11, 12 and 13b, the distributed sampler's phases 14 and 14b, the SGLD and ALS
path phase 15, the other LMs phase 19 and the dense train steps of 22,
the SSM and hybrid LMs phase 20, the audio and VLM LMs phase 21, the
train steps at a cut depth in phases 20, 22 and 23 and the train step on a
mesh phase 26 (b): the
launch counters are set to 0 just before each and read just after (the
kernels line's `launches`, `foldin_launches`, `cotrain_launches`,
`serve_devices_launches`,
`dist_launches`, `dist_ranks_launches` (the 4 ranks' sums), `sgld_launches`,
`lm_dense_launches`, `lm_ssm_launches`,
`lm_mm_launches`, `lm_train_launches`, `lm_train_dense_launches`,
`lm_train_mm_launches`, `mesh_launches` and the cut train steps'
`train_zamba2-7b_launches`, `train_granite-20b_launches` and
`train_qwen2-vl-7b_launches`, the SGLD ones all 0; lm_ssm's are the two
timed forwards', 3 flash launches in all; lm_mm's the two timed forwards',
48 + 28 flash launches; lm_train's are its 3 timed steps, lm_train_dense's
the 3 timed steps of each dense config, each cut train step's its timed
steps (zamba2-7b 1, the others 3); the xLSTM's train steps launch none and
are checked to).
foldin, cotrain and serve_devices need train, serve_faults needs foldin and
cotrain, dist,
dist_ranks and sgld need data, lm_mm needs none, lm_train needs lm_eval,
lm_train_mm needs none, lm_faults needs lm_eval, lm_serve and lm_train.
The `opt` variant (configs/variants.py) runs inside earlier phases:
granite-moe-3b-a800m's forward at B = 1 (bit for bit the global dispatch),
a prefill of 4 x 2,048 a group a prompt (lm_dense) and a train step from
a fresh state (bit for bit the base step, lm_train); zamba2-7b's forward
with its idle share (lm_ssm). So do the remat policies (lm_train:
stablelm-1.6b's step under "dots", a flash forward a layer where
"nothing" launches two; gemma2-2b's S = 4,096 step under "attn_probs"),
the row-level gather_syrk (kernels, bit for bit) and compressed_psum on
the card against the CPU (lm_train, bit for bit). Any failed check exits
non-zero before the last line. No BPMF phase was cut to make room for the
LM ones, and no earlier LM phase either; granite-20b's two attention paths
are compared at 8 of its 52 layers, and lm_faults holds the MoE and
layer-norm checks at 4 layers. zamba2-7b (54 of 81 layers), qwen2-vl-7b (8
of 28) and granite-20b (8 of 52) train at full width and those depths
(CUT_TRAIN_LAYERS), whose modelled peaks fit 80 GB with room; at full
depth none of the three fits one card.
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

# the card's published peaks, `repro_torch/launch/mesh.py`'s (NVIDIA H100
# SXM data sheet), and the flash pair's visible pairs
# (`repro_torch/kernels/ops.py::visible_pairs`): the bounds below; bound by
# main() once it has found the port (`bind_port`)
HBM_BYTES_PER_S = FP32_FLOPS = BF16_TENSOR_FLOPS = None
# the flash pair's bounds count the function's products, one bf16 tensor
# pass each over the visible (query, key) pairs (`ops.FLASH_FWD_PASSES`, 2:
# QK^T and P V forward; `ops.FLASH_BWD_PASSES`, 5: S, dV, dP, dQ and dK
# backward; bound by `bind_port`). The bf16 kernels split the fp32 P (and
# dS) into three exact bf16 terms, which makes 4 and 11 passes: printed
# beside the bound as bound_ms_split3, the kernels' own floor, not the
# function's
FLASH_FWD_PASSES = FLASH_BWD_PASSES = None
FLASH_FWD_SPLIT3_PASSES, FLASH_BWD_SPLIT3_PASSES = 4, 11
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
# the card + host tier of phase serve_devices: one shard a host, the cpu
# ones scored by the plain version
MIXED_DEVICES = ["cuda:0", "cpu", "cuda:0", "cpu"]
SAMPLE_FIELDS = ("u", "v", "hyper_u_mu", "hyper_u_lam", "hyper_v_mu", "hyper_v_lam",
                 "global_mean", "alpha")
# the distributed sampler (phase dist): P item shards, all on cuda:0
DIST_SHARDS = 4
DIST_RUNS = (("ring", "fused"), ("allgather", "fused"), ("async", "fused"), ("ring", "einsum"))
DIST_SWEEPS = 8                        # the chain the RMSE gates read
DIST_RMSE_ALLGATHER = 1e-3             # ring against allgather, examples/distributed_bpmf.py:43-44
DIST_RMSE_ASYNC = 0.05                 # async against ring, tests/test_distributed.py:164
DIST_RANK_SWEEPS = 3                   # timed sweeps a mode on the ranks (their median)
DIST_RANK_TIMEOUT_S = 180              # a rank left waiting at a collective raises
DIST_RANKS_BUDGET_S = 90.0             # the phase's time, printed against it
SGLD_BUDGETS = (4096, 65536)           # padded lanes a half-step: the reference's default, 16x
SGLD_TIMED = 20                        # steps timed, one by one, after SGLD_WARM
SGLD_WARM = 5
SGLD_DET_STEPS = 10                    # the two chains held bit for bit
SGLD_GATE = 0.05                       # tests/test_sgld.py::test_sgld_converges_and_tracks_gibbs
ALS_GATE = 0.02                        # tests/test_bpmf.py::test_bpmf_beats_or_matches_als
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
# The other dense configs and the MoE (phase lm_dense). Their attention
# takes no softcap and no window on any layer; one sequence's flash
# launches are (BH, S, D) = (32, 8,192, 64) for stablelm-1.6b (MHA, a group
# of 1), (24, 8,192, 64) for granite-moe-3b-a800m (a group of 3; smollm's
# 15 over 5 heads is the same group) and (48, 8,192, 128) for granite-20b
# (MQA, a group of 48). Phase lm_kernels holds and times the flash pair at
# these shapes.
DENSE_FLASH_SHAPES = (("D 64, group 1", 32, 32, 64), ("D 64, group 3", 24, 8, 64),
                      ("D 128, group 48", 48, 1, 128))
DENSE_MODELS = ("smollm-360m", "stablelm-1.6b", "granite-20b", "granite-moe-3b-a800m")
# granite-20b's direct path holds 48 x 8,192^2 fp32 scores a layer (12.9 GB,
# three such tensors at once) beside its 40.6 GB of bf16 weights: its two
# attention paths are compared at this depth, on weights drawn for it
DENSE_DIRECT_DEPTH = {"granite-20b": 8}
# the MoE's capacity checks also run at this capacity factor, where
# replicas are dropped for certain (cap = 820 places against 1,638 replicas
# an expert on average at S = 8,192)
MOE_TIGHT_CAPACITY = 0.5
# the depth at which lm_faults re-runs lm_dense's layer checks under its
# MoE and layer-norm plants (the checks hold each layer on its own inputs)
DENSE_FAULT_DEPTH = 4
# the dense configs trained at full depth in phase lm_train beside
# gemma2-2b; granite-20b trains there at a cut depth (its bf16 weights and
# AdamW's fp32 moments need 203 GB at 52 layers)
DENSE_TRAINED = ("stablelm-1.6b", "granite-moe-3b-a800m")
# The configs trained at full width and a cut depth on one card, each cut
# by dataclasses.replace(cfg, n_layers=...): B = 1, S = 8,192, remat on,
# one warm-up and CUT_TRAIN_STEPS[name] timed steps, the modelled peak of
# launch/dryrun.py::lower_cell beside the measured one
# (tests/test_torch_dryrun.py holds the modelled peaks under 72 GB).
# zamba2-7b's 54 layers are two groups of 27, so its tied shared block is
# applied twice and its gradient is a sum of two (phase lm_ssm);
# qwen2-vl-7b takes 1,024 patches and 7,168 tokens (phase lm_train_mm);
# granite-20b runs at the depth its other paths run at (DENSE_DIRECT_DEPTH,
# phase lm_train).
ZAMBA_TRAIN_LAYERS = 54                # of 81
QWEN_VL_TRAIN_LAYERS = 8               # of 28
GRANITE_TRAIN_LAYERS = 8               # of 52
CUT_TRAIN_LAYERS = {"zamba2-7b": ZAMBA_TRAIN_LAYERS, "qwen2-vl-7b": QWEN_VL_TRAIN_LAYERS,
                    "granite-20b": GRANITE_TRAIN_LAYERS}
# zamba2-7b's step is host-bound (the SSD scan's 64 chunks a layer, about
# 400,000 launches a step) at 18.7-22.6 s on an NVIDIA H100 80GB HBM3 at
# 700 W: three timed steps would take a minute of a script that runs near
# its limit, so it times one
CUT_TRAIN_STEPS = {"zamba2-7b": 1, "qwen2-vl-7b": LM_TRAIN_STEPS,
                   "granite-20b": LM_TRAIN_STEPS}
# The backward alone at the cut train steps' attention shapes (phase
# lm_kernels): zamba2-7b's shared block, (32, 8,192, 112) over 32 KV heads,
# in bf16 and fp32, and qwen2-vl-7b's (28, 8,192, 128) over 4 (a group of
# 7); causal, softcap 0, window 0, inputs and dO of BWD_SHAPE_SEED
BWD_SHAPES = (("zamba2-7b", 32, 32, 112, "bf16"), ("zamba2-7b", 32, 32, 112, "fp32"),
              ("qwen2-vl-7b", 28, 4, 128, "bf16"))
BWD_SHAPE_SEED = 33
# The fp32 backward against its fp32 plain version on the same lse and
# output: each gradient within this share of its value plus this share of
# its head's largest magnitude. Both sum 8,192 fp32 products a row in other
# orders, which moves a sum by about sqrt(8,192) fp32 ulps of its largest
# terms, 1e-5 of the largest magnitude.
BWD_FP32_PLAIN_TOL = 1e-4
# The SSM and hybrid families (phase lm_ssm): xlstm-350m launches none of
# the port's kernels (its mLSTM and sLSTM scans are plain PyTorch, as the JAX
# package's are lax.scans), zamba2-7b one flash launch an application of its
# shared attention block, (32, 8,192, 112) over 32 KV heads at B = 1
SSM_MODELS = ("xlstm-350m", "zamba2-7b")
SSM_WARM_SEQ = 1024                    # the xLSTM's warm-up forward: its sLSTM scan is per step
# the SSM and hybrid forwards whose device-busy share is read: the profiler
# takes about 0.2 ms of host time a kernel to read its trace back, and the
# xLSTM's 8,192-token forward is 622,047 kernels, zamba2-7b's 170,000 (30 s
# of lm_ssm; its forward under opt 192,494 kernels, 55 s); each of their
# steps and chunks costs the same at any S (512 for both, where the xLSTM's
# was read at 1,024 and zamba2-7b's at 8,192 before)
SSM_PROFILE_SEQ = 512
# the prompt tokens of lm_ssm's cache invariants and of its serving warm-up
SSM_SHORT = 512
ZAMBA_FLASH = (32, 32, 112)            # (BH, BHk, D) of one zamba2-7b sequence
SSM_RAGGED = (LM_SEQ - 1, 100)         # the D = 112 checks' ragged sequences
FLASH112_SEED = 112
# the chunked scans against their sequential forms (in fp32 and float64) on
# layer 0's own inputs, and the fp32 flash kernel at D = 112 against its
# plain version: the port's CPU tests' fp32 tolerance
SSM_TOL = dict(rtol=1e-4, atol=1e-4)
FLASH112_FP32_TOL = dict(rtol=1e-4, atol=1e-4)
# xlstm-350m's train step (phase lm_ssm): B = 1 at this S (its sLSTM is a
# per-step loop on the host: the forward alone took 5.3-11.4 s at 8,192),
# 1 + 1 steps with remat (1 + 2 before whisper's training needed the
# time), then one without; S = 2,048 until phase mesh needed the time
# (its steps took 80.1 s of lm_ssm there); the remat step's peak device
# memory must lie below the other's by at least this share, which the
# allocator's noise cannot make up and a forward that ignores remat cannot
# reach
XLSTM_TRAIN_SEQ = 512
XLSTM_TRAIN_STEPS = 1
REMAT_PEAK_MARGIN = 0.1
# The audio and VLM families (phase lm_mm). whisper-medium's decoder at S =
# 8,192 launches the flash kernel twice a layer: its causal self-attention,
# (16, 8,192, 64) over 16 KV heads, and its non-causal cross-attention over
# the encoder's 1,500 frames, (16, 8,192 x 1,500, 64), ragged against the
# kernel's 64-key tiles; its encoder none (1,500 frames are fewer than
# chunked_attn_min_len). qwen2-vl-7b's 1,024 patches and 7,168 tokens
# launch it once a layer, (28, 8,192, 128) over 4 KV heads (a group of 7).
MM_MODELS = ("whisper-medium", "qwen2-vl-7b")
MM_FLASH_SHAPES = (("whisper self-attention", 16, 16, LM_SEQ, LM_SEQ, 64, True),
                   ("whisper cross-attention", 16, 16, LM_SEQ, 1500, 64, False),
                   ("qwen2-vl attention", 28, 4, LM_SEQ, LM_SEQ, 128, True))
MM_ROW_KEYS = {"whisper self-attention": "whisper_self_shape",
               "whisper cross-attention": "whisper_cross_shape",
               "qwen2-vl attention": "qwen2_vl_shape"}
MM_FLASH_SEED = 64
MM_SHORT = 512                         # text tokens of lm_mm's cache invariant
MM_GRID = 32                           # qwen2-vl's 1,024 patches on a 32 x 32 (h, w) grid
MM_PAD_KEYS = 1536                     # the cross-attention plant's zero-padded keys
# whisper-medium's training (phase lm_train_mm): B = 1, S = 8,192 decoder
# tokens over its 1,500 frames, remat on. A step launches the flash forward
# 96 times (24 self- and 24 cross-attentions, each again in the recompute)
# and its backward 48 times, 24 of them at S_q != S_k. The backward alone
# is held at the cross-attention's shape on the first and last decoder
# layers' own inputs, against dO of this seed.
MM_BWD_SEED = 27
# keys past S_k that the ragged-keys plant's K and V buffers hold: the
# plant loads whole tiles from past S_k, so the memory there is real
MM_PLANT_PAD_KEYS = 64
# the fp32 flash kernel's column layout, and the one it had before D = 112
# (the 96-column plant of lm_ssm)
# phase dryrun: the meta sweep's processes (the card's host has 8 cores:
# the rest make ml20m and its plans meanwhile), the modelled peak's
# tolerance against the measured one, and the phase's budget of host time
DRYRUN_JOBS = 4
DRYRUN_PEAK_RTOL = 0.2
DRYRUN_BUDGET_S = 120.0
# phase mesh: the query shards of the flash pair's offset checks (a
# 16-wide "model" axis), whisper's encoder frames, and the dry-run's cells
# on the production meshes
MESH_SHARDS = 16
MESH_FRAMES = 1500
MESH_CELLS = (("kimi-k2-1t-a32b", "train_4k", "multi", "opt"),
              ("gemma2-2b", "train_4k", "single", "base"),
              ("granite-moe-3b-a800m", "prefill_32k", "single", "base"),
              ("zamba2-7b", "long_500k", "multi", "base"),
              ("whisper-medium", "decode_32k", "single", "base"))
MESH_BUDGET_S = 120.0
# phase mesh (e): decode on the host mesh against decode without it, at
# full width: the prompt's rows and length and the greedy steps
MESH_DECODE_ARCHS = ("xlstm-350m", "zamba2-7b", "whisper-medium")
MESH_DECODE_BATCH = 2
MESH_DECODE_PROMPT = 512
MESH_DECODE_STEPS = 8

FLASH_LAYOUT_NOW = """  constexpr int VEC = D >= 128 || D % 32 != 0 ? 4 : 1;
  constexpr int GROUPS = (D + 32 * VEC - 1) / (32 * VEC);
  constexpr int CPT = GROUPS * VEC;
  static_assert(D % 4 == 0 && GROUPS * 32 * VEC >= D && (GROUPS - 1) * 32 * VEC < D,
                "the lanes' columns cover D, and no group lies wholly past it");
  static_assert(VEC == 4 || D % 32 == 0, "one column a lane a group needs D % 32 == 0");
"""
FLASH_LAYOUT_96 = """  constexpr int VEC = D >= 128 ? 4 : 1;
  constexpr int CPT = D / 32;
  constexpr int GROUPS = CPT / VEC;
"""
# the same for the fp32 backward's kernels (csrc/flash_attention_bwd.cu,
# `Cols`), and the D / 32 columns a lane it had before D = 112 (lm_faults'
# plant)
BWD_LAYOUT_NOW = """  static constexpr int VEC = D >= 128 || D % 32 != 0 ? 4 : 1;
  static constexpr int GROUPS = (D + 32 * VEC - 1) / (32 * VEC);
  static constexpr int N = GROUPS * VEC;   // columns a lane
  static_assert(D % 4 == 0 && GROUPS * 32 * VEC >= D && (GROUPS - 1) * 32 * VEC < D,
                "the lanes' columns cover D, and no group lies wholly past it");
  static_assert(VEC == 4 || D % 32 == 0, "one column a lane a group needs D % 32 == 0");
"""
BWD_LAYOUT_96 = """  static constexpr int VEC = D >= 128 ? 4 : 1;
  static constexpr int N = D / 32;
  static constexpr int GROUPS = N / VEC;
"""


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


PHASES = ("build", "lint", "data", "kernels", "ranks", "topn", "train", "parity",
          "learning", "serve", "foldin", "cotrain", "serve_faults", "serve_devices", "dist",
          "dist_ranks", "sgld",
          "lm_kernels", "lm_eval", "lm_serve", "lm_dense", "lm_ssm", "lm_mm", "lm_train",
          "lm_train_mm", "lm_faults", "dryrun", "mesh")


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
    bind_port()
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
        from repro_torch.launch import profile

        self.torch, self.np = torch, np
        self.profile_mod = profile
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

    def cuda_ms(self, fn, reps: int = 5, warmup: bool = True) -> float:
        """Mean device time of fn over reps calls after one warm-up call
        (`repro_torch/launch/profile.py::cuda_ms`; a `--src` whose cuda_ms lacks
        warmup= still runs every warm call)."""
        if warmup:
            return self.profile_mod.cuda_ms(fn, reps)
        return self.profile_mod.cuda_ms(fn, reps, warmup=False)

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

    def lint(self):
        """The port's lint on the tree this run started from (the checkout,
        or --src's), in a subprocess as a user runs it: it must exit 0. Its
        cuda-spill rule reads this run's ptxas output of every kernel; a
        kernel built before the run is compiled again into a temporary
        directory for it. Each entry's registers, spills and static shared
        memory are printed."""
        build = self.build_mod
        src = build.CSRC.parents[1]
        root = src.parent
        logs = dict(build.ptxas_log)
        again = sorted(set(build.KERNELS) - set(logs))
        out_dir = Path(self.tmp.name) / "ptxas"
        out_dir.mkdir(exist_ok=True)
        procs = {name: subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"),
             str(build.CSRC / build.KERNELS[name][0])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for name in again}
        for name, proc in procs.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for {name}:\n{logs[name]}")
        if again:
            print(f"  compiled again for their ptxas output: {', '.join(again)}")
        from repro_torch.analysis import cuda as lint_cuda

        specs = []
        entries = {name: lint_cuda.ptxas_entries(log) for name, log in sorted(logs.items())}
        names = demangle([e.name for es in entries.values() for e in es], build._nvcc())
        for name, log in sorted(logs.items()):
            source = (build.CSRC / build.KERNELS[name][0]).relative_to(root).as_posix()
            (out_dir / f"{name}.log").write_text(log)
            specs += ["--ptxas", f"{source}={out_dir / f'{name}.log'}"]
            for e in entries[name]:
                print(f"  ptxas {source} {names[e.name]}: {e.registers} registers, "
                      f"spill {e.spill_stores} B stores / {e.spill_loads} B loads, "
                      f"{e.smem} B static smem, {e.stack} B stack")
        self.check(sum(map(len, entries.values())) > 0 and all(entries.values()),
                   f"ptxas reported the entries of all {len(logs)} kernel sources")
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", "--root", str(root),
             "--format", "json", *specs],
            capture_output=True, text=True, cwd=root,
            env=dict(os.environ, PYTHONPATH=str(src)))
        try:
            report = json.loads(out.stdout)
        except json.JSONDecodeError:
            report = {}
        for f in report.get("findings", []):
            print(f"  finding {f['path']}:{f['line']} {f['rule']} {f['scope']}: "
                  f"{f['message']}")
        print(f"  lint: {report.get('files_analyzed')} files and logs, "
              f"{report.get('baseline', {}).get('suppressed')} baselined, "
              f"{time.perf_counter() - t0:.2f} s")
        if out.returncode and not report:
            print(out.stdout[-2000:], out.stderr[-2000:])
        self.check(out.returncode == 0 and report.get("findings") == [],
                   f"python -m repro_torch.analysis exits 0 with no new finding "
                   f"(exit {out.returncode}, {report.get('summary')})")

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

    def row_level_gather_syrk(self, u, v):
        """ops.gather_syrk, every row its own segment, on the identity bucket
        of the ChEMBL plans with the most entries: one launch of
        gather_syrk_seg's identity path, bit for bit its plain version."""
        torch, ops, ref = self.torch, self.ops, self.ref
        side, b, cp = max(((side, b, cp) for side, b, cp in self._bucket_sides(u, v)
                           if b.identity_segments), key=lambda x: x[1].indices.numel())
        r, w = b.indices.shape
        before = ops.launches()["gather_syrk_seg"]
        pk, rk = ops.gather_syrk(b.indices, b.values, b.mask, cp)
        self.sync()
        n = ops.launches()["gather_syrk_seg"] - before
        pp, rp = ref.gather_syrk_seg_ref(b.indices, b.values, b.mask,
                                         torch.arange(r, dtype=torch.int32, device=self.dev),
                                         r, cp, identity_segments=True)
        ms = self.cuda_ms(lambda: ops.gather_syrk(b.indices, b.values, b.mask, cp), reps=20)
        self.check(n == 1 and tuple(pk.shape) == (r, K, K) and torch.equal(pk, pp)
                   and torch.equal(rk, rp),
                   f"gather_syrk (row level) on the {side} width-{w} bucket ({r} rows): one "
                   f"gather_syrk_seg launch ({n}), prec and rhs equal the plain version's bit "
                   f"for bit; {ms:.3f} ms")
        del pk, rk, pp, rp

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
        self.row_level_gather_syrk(u, v)
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
            err = lib.gather_syrk_seg_launch(  # repro-lint: disable=cuda-launch-guard (one card; the launcher alone is timed)
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
        err = self.build_mod.library("masked_syrk").masked_syrk_launch(  # repro-lint: disable=cuda-launch-guard (one card)
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
        self.check(launches["chol_solve_sample"] == 2 * n_sweeps + 2 * 2,
                   f"chol_solve_sample launched once per fused and kernel-engine "
                   f"half-sweep (2 x {n_sweeps} + 2 x 2)")
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
                 complete=bool, activities=("cpu", "cuda")) -> list:
        """Device time by kernel of one call of fn under torch.profiler
        (`repro_torch/launch/profile.py::profile_call`: a warm-up step, the
        recorded call inside idle margins, a trace that `complete` rejects
        taken again up to twice), printed with the idle share against
        `wall`, the call's unprofiled time in ms. Returns the trace's device
        events, one per kernel name, each with its launch count (none where
        the trace holds no device time)."""
        def retry(events):
            print(f"profiled {what}: the trace holds {sum(e.count for e in events)} "
                  "kernels, cut by the profiler; profiling again")

        events = self.profile_mod.profile_call(fn, complete=complete,
                                               activities=activities, trace=trace,
                                               on_retry=retry).events
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

    # ------------------------------------------------------------ tier over devices
    def serve_devices(self):
        """Phase 13b (the module docstring): the serving tier's hosts placed
        over devices, the cross-device candidate gather on the card + host
        tier, failover onto a surviving host's device, and the frontend on
        the host mesh. The path's launches are every tier and frontend call
        below; the references come after they are read."""
        np, torch, ops = self.np, self.torch, self.ops
        from repro_torch.launch.mesh import (
            close_host_group,
            make_host_mesh,
            serving_host_devices,
        )
        from repro_torch.serve import (
            ClusterCoordinator,
            PosteriorEnsemble,
            PublicationChannel,
            RecommendFrontend,
            TopNRecommender,
        )

        t_phase = time.perf_counter()
        users = np.sort(np.random.default_rng(0).choice(self.sampler.m, N_USERS_SERVED,
                                                        replace=False))
        ens = PosteriorEnsemble.load(self.store_dir)

        def drive(call):
            """call() and the kernels it launched, the card drained after."""
            before = ops.launches()
            out = call()
            self.sync()
            after = ops.launches()
            return out, {k: after[k] - before[k] for k in after}

        def serve(rec):
            return drive(lambda: rec.recommend(users, TOPK, seen=self.seen))

        ops.reset_launches()                    # the path starts here
        card = ClusterCoordinator(ens, devices=serving_host_devices(n_hosts=4), replicas=2)
        (cv, ci), n_card = serve(card)
        mixed = ClusterCoordinator(ens, devices=MIXED_DEVICES)
        (mv, mi), n_mixed = serve(mixed)
        ch = PublicationChannel(window=ens.n_samples)
        for d in ens.samples:   # the retained window: the tier starts at its epoch
            ch.publish(d.step, {k: getattr(d, k) for k in SAMPLE_FIELDS})
        fo = ClusterCoordinator(ens, devices=["cuda:0", "cpu"] * 2, replicas=2, channel=ch)
        base = ens.samples[-1]
        try:
            rng = np.random.default_rng(7)
            committed = []
            for i in (1, 2):            # two fresh draws near the last one
                d = {k: getattr(base, k) for k in SAMPLE_FIELDS}
                for key in ("u", "v"):
                    d[key] = d[key] + np.float32(0.01) * rng.standard_normal(
                        np.shape(d[key]), dtype=np.float32)
                ch.publish(base.step + i, d)
                committed.append(fo.wait_epoch(base.step + i, timeout=120))
            (bv, bi), n_before = serve(fo)
            for h in (1, 3):                    # both owners of shard 1, on the cpu
                fo.health.kill(h)
            (av, ai), n_after = serve(fo)
            stats = fo.stats()
        finally:
            fo.close()
            ch.close()
        try:
            fe = RecommendFrontend(self.store_dir, seen=self.train, mesh=make_host_mesh(),
                                   max_batch=N_USERS_SERVED)
            for u in users:
                fe.submit(int(u), topk=TOPK)
            res, n_fe = drive(fe.flush)
        finally:
            close_host_group()
        self.sync()
        launches = ops.launches()               # ... and is read here
        self.path_launches["serve_devices"] = launches
        print(f"the tier over devices: launches {launches}; per batch: all-card "
              f"{n_card['topn_scores']}, card + host {n_mixed['topn_scores']}, mixed "
              f"replicated {n_before['topn_scores']} then {n_after['topn_scores']} after "
              f"the failover, frontend {n_fe['topn_scores']}")

        sv, si = TopNRecommender(ens).recommend(users, TOPK, seen=self.seen)
        self.check(card.n_shards == 2 and [str(h.device) for h in card.hosts] == ["cuda:0"] * 4
                   and np.array_equal(ci, si) and np.array_equal(cv, sv),
                   f"all-card tier, 4 hosts on {[str(d) for d in card.devices]}, replicas 2: "
                   f"top-N of {len(users):,} users bit for bit TopNRecommender's")
        self.check(n_card["topn_scores"] == card.n_shards and sum(n_card.values()) == card.n_shards,
                   f"all-card tier: {n_card['topn_scores']} top-N launches a batch, one a shard")
        self.check([str(h.device) for h in mixed.hosts] == MIXED_DEVICES
                   and [str(h.live.v_shard.device) for h in mixed.hosts] == MIXED_DEVICES
                   and n_mixed["topn_scores"] == 2 and sum(n_mixed.values()) == 2,
                   f"card + host tier: hosts and their V' shards on {MIXED_DEVICES}, "
                   f"{n_mixed['topn_scores']} top-N launches a batch (the cuda:0 shards; the "
                   "cpu shards run the plain version)")
        gv, gi = self.merged_alone(ens, users, MIXED_DEVICES)
        self.check(np.array_equal(mi, gi) and np.array_equal(mv, gv),
                   "card + host tier: bit for bit the merge on cuda:0 of each shard's "
                   "candidates scored alone on its own device")
        self.check(np.array_equal(mi, ci) and np.array_equal(mv, cv),
                   "card + host tier: bit for bit the all-card tier (tolerance 0: the plain "
                   "version sums in the kernel's order)")
        epoch = base.step + 2
        rebuilt = stats["hosts"].get(4, {})
        fv_ref, fi_ref = TopNRecommender(fo.ensemble).recommend(users, TOPK, seen=self.seen)
        self.check(all(committed) and fo.epoch == epoch and fo.commits == 2,
                   f"mixed tier over (cuda:0, cpu) x 2, replicas 2: both publishes committed "
                   f"(epoch {fo.epoch}, {fo.commits} commits)")
        self.check(stats["reassignments"] == 1 and rebuilt.get("shard") == 1
                   and rebuilt.get("device") == "cuda:0" and n_after["topn_scores"] == 2
                   and n_before["topn_scores"] == 1,
                   f"both owners of shard 1 (cpu) killed: the shard is rebuilt as host "
                   f"{4 if rebuilt else None} on {rebuilt.get('device')} (a surviving "
                   f"host's device; stats names it), {n_after['topn_scores']} top-N "
                   "launches a batch after, 1 before")
        self.check(fo.ensemble.epoch == epoch and np.array_equal(ai, fi_ref)
                   and np.array_equal(av, fv_ref),
                   "after the failover the mixed tier serves bit for bit TopNRecommender on "
                   "the committed ensemble")
        self.check(np.array_equal(bi, fi_ref) and np.array_equal(bv, fv_ref),
                   "before the failover (shard 1 on the cpu), bit for bit the same")
        res = sorted(res, key=lambda r: r.ticket)
        rec = fe._recommender
        self.check(type(rec) is TopNRecommender and [str(h.device) for h in rec.hosts]
                   == ["cuda:0"] and n_fe["topn_scores"] == 1
                   and np.array_equal(np.stack([r.items for r in res]), si)
                   and np.array_equal(np.stack([r.scores for r in res]), sv),
                   "RecommendFrontend(mesh=make_host_mesh()): one shard on cuda:0, one top-N "
                   f"launch for a batch of {len(users):,}, bit for bit TopNRecommender's")
        took = time.perf_counter() - t_phase
        print(f"serve_devices: {took:.1f} s on {card_line()}")

    def merged_alone(self, ens, users, devices):
        """The tier's result built apart from it: each shard of
        len(devices) scored alone by ops.topn_scores on its device from the
        ensemble's scoring matrices, the candidates merged on cuda:0, the
        global mean added and each user's seen items dropped as
        ClusterCoordinator._serve does."""
        np, torch, ops = self.np, self.torch, self.ops
        from repro_torch.serve.cluster import _merge_topk, shard_bounds

        fetch = 1 << (TOPK + self.seen.max_degree - 1).bit_length()
        fetch = min(fetch, ens.n_items)
        u_flat, v_flat = ens.scoring_matrices()
        rows = u_flat[torch.as_tensor(users, dtype=torch.int64, device=u_flat.device)]
        bounds = shard_bounds(ens.n_items, len(devices))
        vals, idx = [], []
        for s, dev in enumerate(devices):
            lo, hi = int(bounds[s]), int(bounds[s + 1])
            v, i = ops.topn_scores(rows.to(dev), v_flat[lo:hi].to(dev).contiguous(),
                                   min(fetch, hi - lo))
            vals.append(v.to(self.dev))
            idx.append((i + lo).to(self.dev))
        mv, mi = _merge_topk(torch.cat(vals, 1), torch.cat(idx, 1), fetch)
        mv = mv.cpu().numpy() + np.float32(ens.global_mean)
        mi = mi.cpu().numpy().astype(np.int32)
        out_v = np.full((len(users), TOPK), -np.inf, np.float32)
        out_i = np.full((len(users), TOPK), -1, np.int32)
        for r, u in enumerate(users):
            keep = ~np.isin(mi[r], self.seen[int(u)])
            kv, ki = mv[r][keep][:TOPK], mi[r][keep][:TOPK]
            out_v[r, : len(kv)] = kv
            out_i[r, : len(ki)] = ki
        return out_v, out_i

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
        the initial state's blocks, each timed beside its plain version (one
        call, no warm-up) and its bound (outside the counted run)."""
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
                # one cold call: the 40 plain launches take 24 s a pass
                pms = self.cuda_ms(lambda: ref.gather_syrk_seg_ref(*args), reps=1,
                                   warmup=False)
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
    def dist_ranks(self):
        """The distributed sampler with one item shard a process: P = 4
        ranks, all on cuda:0, on a gloo group (a card's blocks staged
        through pinned host buffers; NCCL takes one rank a card), at phase
        dist's shape, state and noise (init(seed=0), then draw_noise()).
        Each rank runs one fused sweep of each mode, every gather_syrk_seg
        launch of its ring and allgather sweeps held bit for bit against
        the plain version on its inputs; each rank's shard must equal the
        one-process P = 4 sampler's bit for bit and every rank's
        hyperparameters each other's. A ring planted to forward to r - 1
        must fail; then DIST_RANK_SWEEPS timed sweeps a mode (rank 0's time
        blocked in the ring's waits, the exchange's hidden share, peak
        memory a rank). Last, one rank on an NCCL group, bit for bit the
        one-process P = 1 sampler in each mode."""
        import torch.multiprocessing as mp

        torch, np = self.torch, self.np
        from repro_torch.core.distributed import DIST_MODES, DistributedBPMF

        t_phase = time.perf_counter()
        card = card_line()
        d = Path(self.tmp.name) / "dist_ranks"
        d.mkdir()
        np.savez(d / "data.npz", **{f"{name}_{f}": getattr(r, f)
                                    for name, r in (("train", self.train), ("test", self.test))
                                    for f in ("rows", "cols", "vals")},
                 shape=np.asarray(self.train.shape))
        # the one-process references: P = 4 and P = 1 shards on the card
        refs = {}
        for world in (DIST_SHARDS, 1):
            s0 = noise = None
            for mode in DIST_MODES:
                one = DistributedBPMF(self.train, self.test, devices=[self.dev] * world, k=K,
                                      alpha=1.5, width="auto", mode=mode, engine="fused")
                if s0 is None:
                    s0 = one.init(seed=0)
                    noise = one.draw_noise()
                refs[world, mode] = _dist_record(one.sweep(s0, noise))
                del one
            del s0, noise
            torch.cuda.empty_cache()
        print(f"  one-process references (P = {DIST_SHARDS} and P = 1, each mode) in "
              f"{time.perf_counter() - t_phase:.1f} s")

        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        runs = {}
        for backend, world in (("gloo", DIST_SHARDS), ("nccl", 1)):
            t0 = time.perf_counter()
            mp.spawn(dist_rank, args=(dict(dir=str(d), backend=backend, world=world),),
                     nprocs=world)
            runs[backend] = [json.loads((d / f"{backend}_rank{r}.json").read_text())
                             for r in range(world)]
            print(f"  {world} {backend} rank(s) spawned, run and joined in "
                  f"{time.perf_counter() - t0:.1f} s (set-up "
                  f"{[round(r['setup_s'], 2) for r in runs[backend]]} s a rank)")

        ranks = runs["gloo"]
        per_rank = {"ring": 2 * DIST_SHARDS, "allgather": 2, "async": 2 * DIST_SHARDS}
        want = sum(per_rank.values())
        counts = [r["launches"] for r in ranks]
        print(f"dist_ranks path launches a rank (one ring, one allgather, one async sweep) "
              f"{counts}")
        self.check(all(c["gather_syrk_seg"] == want
                       and sum(c.values()) == c["gather_syrk_seg"] for c in counts),
                   f"each of the {DIST_SHARDS} ranks launched gather_syrk_seg {want} times "
                   f"({per_rank}) and no other kernel")
        self.path_launches["dist_ranks"] = {
            name: sum(c[name] for c in counts) for name in counts[0]}
        checked = [c for r in ranks for c in r["checked"]]
        self.check(len(checked) == DIST_SHARDS * (per_rank["ring"] + per_rank["allgather"])
                   and all(same for same, _ in checked),
                   f"every gather_syrk_seg launch of the ranks' ring and allgather sweeps "
                   f"({len(checked)}) equals its plain version on its inputs bit for bit "
                   f"(max abs err {max((e for _, e in checked), default=0.0):.3e})")
        for mode in DIST_MODES:
            ref = refs[DIST_SHARDS, mode]
            same = all(r["sweep"][mode][name] == ref[name][r["rank"]]
                       for r in ranks for name in ("u", "v", "v_eval") if name in ref)
            self.check(same, f"{mode}: each rank's shard of one sweep equals the one-process "
                             f"P = {DIST_SHARDS} sweep's bit for bit (u, v"
                             f"{', v_eval' if mode == 'async' else ''})")
            hyper = {json.dumps(r["sweep"][mode]["hyper"]) for r in ranks}
            self.check(len(hyper) == 1 and json.loads(hyper.pop()) == ref["hyper"],
                       f"{mode}: every rank's hyperparameters equal each other's and the "
                       "one-process sampler's bit for bit")
        self.check(all(r["sweep"]["async"]["v"] == r["sweep"]["ring"]["v"] for r in ranks),
                   "on the ranks, async's fresh v equals ring's bit for bit")
        v_gather = torch.cat([torch.from_numpy(np.load(d / f"gloo_rank{r}_v_allgather.npy"))
                              for r in range(DIST_SHARDS)])
        planted = torch.cat([torch.from_numpy(np.load(d / f"gloo_rank{r}_v_plant.npy"))
                             for r in range(DIST_SHARDS)])
        ok, text, _ = self.verdict(planted, v_gather, "ranks' ring v against their allgather v")
        print(f"    planted fault 'the ranks' ring forwards to r - 1': "
              f"{'passes' if ok else 'FAILS'} {text}")
        self.check(not ok and all(r["shift_restored"] for r in ranks),
                   "planted fault 'the ranks' ring forwards to r - 1' fails the ring against "
                   "allgather, and is undone")

        numbers = {}
        for mode in DIST_MODES:
            t = [r["timing"][mode] for r in ranks]
            lead = t[0]
            hidden = (1.0 - lead["wait_s"] / lead["pair_s"]) if lead["pairs"] else float("nan")
            numbers[mode] = dict(s=lead["median"], rank_s=[x["median"] for x in t],
                                 wait_s=lead["wait_s"], pair_s=lead["pair_s"],
                                 pairs=lead["pairs"], hidden_share=hidden,
                                 peak_gb=[x["peak_gb"] for x in t])
            exch = (f"rank 0 blocked {lead['wait_s']:.4f} s in the ring's waits of "
                    f"{lead['pair_s']:.4f} s of {lead['pairs']} isend/irecv pairs, hidden "
                    f"share {hidden:.3f}" if lead["pairs"] else "no ring (all-gathers)")
            print(f"  dist_ranks {mode:9s}: {DIST_SHARDS} gloo ranks on one card, sweep "
                  f"seconds {[round(x, 4) for x in lead['times']]} (rank 0), median "
                  f"{lead['median']:.4f} s (ranks' medians "
                  f"{[round(x['median'], 4) for x in t]}); {exch} over {DIST_RANK_SWEEPS} "
                  f"sweeps; peak device memory a rank {[round(x['peak_gb'], 2) for x in t]} "
                  f"GB; card {card}")
        if "dist" in self.phases:
            print(f"  beside phase dist's one-process fused sweeps (4 shards on the card): "
                  f"{ {m: round(self.dist_numbers[m, 'fused']['s'], 4) for m in DIST_MODES} } s")
        self.dist_rank_numbers = numbers

        nccl = runs["nccl"][0]
        for mode in DIST_MODES:
            ref = refs[1, mode]
            same = all(nccl["sweep"][mode][name] == ref[name][0]
                       for name in ("u", "v", "v_eval") if name in ref)
            self.check(same and nccl["sweep"][mode]["hyper"] == ref["hyper"],
                       f"{mode}: one rank on an NCCL group equals the one-process P = 1 "
                       "sweep bit for bit")
        self.check(nccl["launches"]["gather_syrk_seg"] == 6,
                   "the NCCL rank launched gather_syrk_seg 2 times a sweep of each mode")
        print("  two NCCL ranks need two cards (NCCL takes one rank a card): "
              "ROADMAP.md item 7")
        print(f"  dist_ranks took {time.perf_counter() - t_phase:.1f} s "
              f"(budget about {DIST_RANKS_BUDGET_S:.0f} s)")

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
        (4, S, 256), the query heads of one KV head side by side; the pair
        at the other configs' shapes (`dense_flash_shape`) and the backward
        at the cut train steps' (`bwd_shape_row`)."""
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
            # The bound: QK^T and P V, one bf16 tensor pass each over the
            # visible pairs. Beside it: the kernel's four passes (P stays
            # fp32, split into three bf16 terms that sum to it exactly,
            # csrc/flash_attention.cu), the bound before the tensor-core
            # kernel, with P V on the fp32 pipes, and both products at the
            # fp32 peak.
            qk_flops = pv_flops = 2.0 * d * bh * visible_pairs(LM_SEQ, window)
            tb = n_bytes / HBM_BYTES_PER_S * 1e3
            to = FLASH_FWD_PASSES * qk_flops / BF16_TENSOR_FLOPS * 1e3
            bms, by = (tb, "bytes") if tb >= to else (to, "operations")
            b3 = max(tb, FLASH_FWD_SPLIT3_PASSES * qk_flops / BF16_TENSOR_FLOPS * 1e3)
            b_pv32 = max(tb, (qk_flops / BF16_TENSOR_FLOPS + pv_flops / FP32_FLOPS) * 1e3)
            b32 = max(tb, (qk_flops + pv_flops) / FP32_FLOPS * 1e3)
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
                  f"bound {bms:.3f} ms ({by}: 2 bf16 tensor passes a visible pair, "
                  f"QK^T and P V; kernel at {ms / bms:.2f}x); the kernel's 4 passes, "
                  f"QK^T and the 3-term P V, {b3:.3f} ms (kernel at {ms / b3:.2f}x); with "
                  f"P V on the fp32 pipes {b_pv32:.3f} ms; all at the fp32 peak "
                  f"{b32:.3f} ms; flex_attention {lms:.3f} ms; softcap 0: "
                  f"{ms0:.3f} ms kernel, {lms0:.3f} ms scaled_dot_product_attention (agree "
                  f"to {err0:.2e})")
            per[kind] = dict(err=err, ms=ms, plain=pms, bound=bms, b3=b3, b_pv32=b_pv32,
                             b32=b32, by=by, ms0=ms0, lib0=lms0, lib=lms)
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
        self.dense_flash = {tag: self.dense_flash_shape(tag, bh, bhk, d)
                            for tag, bh, bhk, d in DENSE_FLASH_SHAPES}
        self.bwd_shapes = {f"{tag} {name}": self.bwd_shape_row(tag, bh, bhk, d, name)
                           for tag, bh, bhk, d, name in BWD_SHAPES}
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
                            "256) bf16, causal, softcap 50; bound: 2 bf16 tensor passes "
                            "a visible pair (QK^T and P V)",
                     bound_ms_split3=total("b3"),
                     bound_ms_pv_fp32_pipes=total("b_pv32"),
                     bound_note="bound_ms_split3: the kernel's 4 passes, P V with the "
                                "fp32 P split into three exact bf16 terms; "
                                "bound_ms_pv_fp32_pipes: QK^T at the bf16 tensor peak, "
                                "P V at the fp32 peak, as before the tensor-core kernel",
                     bound_ms_all_fp32_peak=total("b32"),
                     softcap0_ms=total("ms0"),
                     softcap0_library_ms=total("lib0"),
                     softcap0_library="scaled_dot_product_attention, enable_gqa, "
                                            "the same causal and window mask",
                     dense_shapes=self.dense_rows("fwd"))

    def dense_flash_shape(self, tag, bh, bhk, d) -> dict:
        """The flash pair at one of the other configs' shapes, (bh, 8,192, d)
        queries over bhk KV heads, bf16, causal, softcap 0, window 0: the
        forward against its plain version (3e-2 and one bf16 ulp) and
        float64 (the kernel no farther than an ulp or the plain version),
        the backward through FlashAttention against float64 head by head
        (lm_train's gates: one bf16 ulp of each head's largest magnitude,
        BWD_MISROUNDED_SHARE), each timed beside its bound, its plain
        version and scaled_dot_product_attention (enable_gqa, is_causal)."""
        torch, ops, ref = self.torch, self.ops, self.ref
        g = torch.Generator(device=self.dev).manual_seed(bh * 1000 + d)
        q, k, v, do = (torch.randn(n, LM_SEQ, d, generator=g, device=self.dev).to(torch.bfloat16)
                       for n in (bh, bhk, bhk, bh))
        kw = dict(causal=True, window=0, softcap=0.0)
        name = f"{tag} ({bh}, {LM_SEQ}, {d}) over {bhk} KV heads, softcap 0, window 0"
        got = ops.flash_attention(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        self.sync()
        err = self.close(got.float(), want.float(), f"flash_attention {name}", FLASH_TOL["bf16"])
        self.close(got.float(), want.float(), f"flash_attention {name}, within a bf16 ulp",
                   FLASH_BF16_ULP_TOL)
        rtol = FLASH_BF16_ULP_TOL["rtol"]
        need = {"kernel": 0.0, "plain": 0.0}
        for h0 in range(0, bh, 8):        # float64, 8 query heads at a time
            exact = self.exact_heads(q, k, v, h0, min(h0 + 8, bh))
            for who, out in (("kernel", got), ("plain", want)):
                need[who] = max(need[who], float(((out[h0:h0 + 8].double() - exact).abs()
                                                  - rtol * exact.abs()).max()))
            del exact
        self.check(need["kernel"] <= max(FLASH_BF16_ULP_TOL["atol"], need["plain"]),
                   f"flash_attention {name} against float64: the kernel takes an atol of "
                   f"{need['kernel']:.3e} beside the one-ulp rtol, the plain version "
                   f"{need['plain']:.3e} (limit: {FLASH_BF16_ULP_TOL['atol']:g} or the plain "
                   "version's)")
        del got, want
        # the backward, through FlashAttention: one launch of each kernel
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        ops.reset_launches()
        o = ops.flash_attention(*leaves, **kw)
        grads = torch.autograd.grad(o, leaves, do)
        self.sync()
        n = ops.launches()
        self.check(n["flash_attention"] == 1 and n["flash_attention_bwd"] == 1,
                   f"flash_attention_bwd {name}: one forward and one backward launch "
                   f"({n['flash_attention']}, {n['flash_attention_bwd']})")
        exact = self.bwd_exact(q, k, v, do, kw)
        bwd_err, worst_all = 0.0, 0.0
        for gr, w, gname in zip(grads, exact, ("dq", "dk", "dv")):
            worst, e, share = self.grad_errors(gr, w)
            self.check(share <= BWD_MISROUNDED_SHARE,
                       f"flash_attention_bwd {name}: {gname}'s elements more than half "
                       f"their own bf16 ulp from float64: a share of {share:.2e} (at most "
                       f"{BWD_MISROUNDED_SHARE:g})")
            self.check(worst <= 1.0,
                       f"flash_attention_bwd {name}: {gname} of each head within one bf16 "
                       f"ulp of its largest magnitude (at least {GRAD_ULP_FLOOR:g}) of the "
                       f"float64 plain version: worst err / ulp {worst:.3f}, max abs err "
                       f"{e:.3e}")
            bwd_err, worst_all = max(bwd_err, e), max(worst_all, worst)
        del leaves, o, grads, exact
        # times
        pairs = bh * visible_pairs(LM_SEQ, 0)
        tb = sum(t.numel() * t.element_size() for t in (q, k, v, q)) / HBM_BYTES_PER_S * 1e3
        to = FLASH_FWD_PASSES * 2.0 * d * pairs / BF16_TENSOR_FLOPS * 1e3
        fwd = dict(shape=name, max_abs_err=err, bound_ms=max(tb, to),
                   bound_by="bytes" if tb >= to else "operations",
                   bound_ms_split3=max(tb, FLASH_FWD_SPLIT3_PASSES * 2.0 * d * pairs
                                       / BF16_TENSOR_FLOPS * 1e3),
                   ms=self.cuda_ms(lambda: ops.flash_attention(q, k, v, **kw)),
                   plain_ms=self.cuda_ms(lambda: ref.flash_attention_ref(q, k, v, **kw),
                                         reps=1))

        def sdpa(*t):
            return torch.nn.functional.scaled_dot_product_attention(
                *(x[None] for x in t), is_causal=True, enable_gqa=True)[0]

        self.close(sdpa(q, k, v).float(), ops.flash_attention(q, k, v, **kw).float(),
                   f"flash_attention {name}: scaled_dot_product_attention against the "
                   "kernel", FLASH_TOL["bf16"])
        fwd["library_ms"] = self.cuda_ms(lambda: sdpa(q, k, v))
        _, lse, o32 = ops._flash_forward(q, k, v, True, 0, 0.0, d ** -0.5, keep=True)
        bw = dict(kw, scale=d ** -0.5)
        tb = ((sum(t.numel() * t.element_size() for t in (q, k, v, do)) * 2
               + q.numel() * 4 + bh * LM_SEQ * 4) / HBM_BYTES_PER_S * 1e3)
        bwd = dict(shape=name, max_abs_err=bwd_err, worst_ulp=worst_all,
                   bound_ms=max(tb, FLASH_BWD_PASSES * 2.0 * d * pairs / BF16_TENSOR_FLOPS
                                * 1e3),
                   bound_by="operations",
                   bound_ms_split3=max(tb, FLASH_BWD_SPLIT3_PASSES * 2.0 * d * pairs
                                       / BF16_TENSOR_FLOPS * 1e3),
                   ms=self.cuda_ms(lambda: ops.flash_attention_bwd(q, k, v, do, lse, o32, **bw)),
                   plain_ms=self.cuda_ms(lambda: self.plain_bwd_by_heads(q, k, v, do, lse, o32,
                                                                         bw), reps=1))
        del lse, o32
        leaves = [t.detach()[None].requires_grad_() for t in (q, k, v)]
        out = torch.nn.functional.scaled_dot_product_attention(*leaves, is_causal=True,
                                                               enable_gqa=True)
        bwd["library_ms"] = self.cuda_ms(lambda: torch.autograd.grad(
            out, leaves, do[None], retain_graph=True))
        del leaves, out
        for kind, r in (("flash_attention", fwd), ("flash_attention_bwd", bwd)):
            print(f"    {kind} {name}: {r['ms']:.3f} ms kernel, {r['plain_ms']:.3f} ms plain, "
                  f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}; kernel at "
                  f"{r['ms'] / r['bound_ms']:.2f}x; split3 {r['bound_ms_split3']:.3f} ms), "
                  f"scaled_dot_product_attention {r['library_ms']:.3f} ms")
        return dict(fwd=fwd, bwd=bwd)

    def bwd_shape_verdicts(self, tag, bh, bhk, d, name, seed) -> tuple[list, tuple]:
        """The backward at (bh, 8,192, d) over bhk KV heads in `name` (bf16
        or fp32), causal, softcap 0, window 0, on inputs and dO of `seed`:
        `recorded_bwd_verdicts`, and in fp32 each gradient within
        BWD_FP32_PLAIN_TOL of the plain version on the kernel's own lse and
        output (columns 96 on, those a lane's D / 32 columns would miss at
        D = 112, also on their own). Returns the verdicts and (q, k, v, do,
        the largest error against float64)."""
        torch, ops = self.torch, self.ops
        dtype = torch.bfloat16 if name == "bf16" else torch.float32
        g = torch.Generator(device=self.dev).manual_seed(seed)
        q, k, v, do = (torch.randn(n, LM_SEQ, d, generator=g, device=self.dev).to(dtype)
                       for n in (bh, bhk, bhk, bh))
        kw = dict(causal=True, window=0, softcap=0.0, scale=d ** -0.5)
        tag = f"{tag} {name}, inputs of seed {seed}"
        out, err = self.recorded_bwd_verdicts(tag, q, k, v, kw, do=do)
        if name == "fp32":
            fo, lse, _ = ops._flash_forward(q, k, v, True, 0, 0.0, kw["scale"], keep=True)
            got = ops.flash_attention_bwd(q, k, v, do, lse, fo, **kw)
            plain = self.plain_bwd_by_heads(q, k, v, do, lse, fo, kw)
            cols = ((0, "every column"),) + (((96, "columns 96 on"),) if d % 32 else ())
            for gr, p, gname in zip(got, plain, ("dq", "dk", "dv")):
                top = p.abs().flatten(1).amax(dim=1)[:, None, None]
                for c0, what in cols:
                    ratio = float(((gr - p).abs()[..., c0:] / (
                        BWD_FP32_PLAIN_TOL * (p.abs()[..., c0:] + top))).max())
                    out.append((ratio <= 1.0,
                                f"flash_attention_bwd {tag}: {gname} against the plain "
                                f"version, {what}: |err| / ({BWD_FP32_PLAIN_TOL:g} (|plain| + "
                                f"the head's largest)) at most {ratio:.3f}"))
            del fo, lse, got, plain
        return out, (q, k, v, do, err)

    def bwd_shape_row(self, tag, bh, bhk, d, name) -> dict:
        """`bwd_shape_verdicts` on inputs of BWD_SHAPE_SEED, checked, then
        the backward launch alone on them (`bwd_row`): the kernels line's
        record."""
        verdicts, (q, k, v, do, err) = self.bwd_shape_verdicts(tag, bh, bhk, d, name,
                                                               BWD_SHAPE_SEED)
        for ok, what in verdicts:
            self.check(ok, what)
        return self.bwd_row(tag, q, k, v, dict(causal=True, window=0, softcap=0.0,
                                               scale=d ** -0.5), err, do=do)

    def plain_bwd_by_heads(self, q, k, v, do, lse, o, kw):
        """The plain backward taken 8 query heads at a time (the whole
        (48, 8,192, 8,192) fp32 intermediates would not fit); dK and dV
        summed over the chunks of a KV head's group in head order."""
        torch, ref = self.torch, self.ref
        bh, bhk = q.shape[0], k.shape[0]
        rep = bh // bhk
        dq = torch.empty_like(q)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros_like(dk)
        # whole groups a chunk, or 8 heads of one group where a group is larger
        step = 8 if rep % 8 == 0 else rep * max(1, 8 // rep)
        for h0 in range(0, bh, step):
            h1 = min(h0 + step, bh)
            kv0, kv1 = h0 // rep, (h1 - 1) // rep + 1
            gq, gk, gv = ref.flash_attention_bwd_ref(q[h0:h1], k[kv0:kv1], v[kv0:kv1],
                                                     do[h0:h1], lse[h0:h1], o[h0:h1], **kw)
            dq[h0:h1] = gq
            dk[kv0:kv1] += gk.float()
            dv[kv0:kv1] += gv.float()
        return dq, dk.to(k.dtype), dv.to(v.dtype)

    def exact_heads(self, q, k, v, h0: int, h1: int, causal: bool = True):
        """Attention (no window, no softcap) of query heads h0..h1-1 of
        (BH, S_q, D) q over their KV heads h // (BH / BHk) of (BHk, S_k, D),
        causal or not, in float64."""
        torch = self.torch
        rep, d = q.shape[0] // k.shape[0], q.shape[2]
        idx = torch.arange(h0, h1, device=q.device) // rep
        sc = (q[h0:h1].double() @ k[idx].double().transpose(-1, -2)).mul_(d ** -0.5)
        if causal:
            qp = torch.arange(q.shape[1], device=q.device)
            kp = torch.arange(k.shape[1], device=q.device)
            sc.masked_fill_(qp[:, None] < kp[None, :], float("-inf"))
        return torch.softmax(sc, dim=-1) @ v[idx].double()

    def dense_rows(self, kind: str) -> dict:
        """The kernels line's record of the flash pair at the other configs'
        shapes (phase lm_kernels), by shape."""
        return {tag: dict(r[kind]) for tag, r in self.dense_flash.items()}

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
        return self.path_verdicts(runs) + self.layer_verdicts(per_layer, "",
                                                              FLASH_BF16_ULP_TOL)

    def path_verdicts(self, runs: dict) -> list[tuple[bool, str]]:
        """The kernel path's loss and last-position logits against the direct
        path's: in bf16 the loss at LM_LOSS_RTOL and the logits within the
        noise floor, in fp32 at LM_FP32_LOSS_RTOL and LM_FP32_TOL."""
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
        ]

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

    # ------------------------------------------------------------ other LMs
    def lm_dense(self):
        """smollm-360m, stablelm-1.6b, granite-20b and granite-moe-3b-a800m at
        their published widths, bf16, weights from seed 0 (stablelm's layer
        norms' scales and biases drawn apart, `perturb_norms`), one at a
        time after gemma2-2b's parameters are freed: loss_fn at B = 1, S =
        8,192 (the main path: a flash launch a layer), the MoE's capacity
        and the layer norm held layer by layer, generate() and the cache
        invariant, and the two attention paths' forwards."""
        import gc

        torch = self.torch
        if getattr(self, "lm", (None, None))[1] is not None:
            self.lm_digest = self.params_digest(self.lm[1])
            self.lm = (self.lm[0], None)
        gc.collect()
        torch.cuda.empty_cache()
        total: dict[str, int] = {}
        self.dense_numbers = {}
        for name in DENSE_MODELS:
            print(f"  -- {name}", flush=True)
            launches = self.dense_model(name)
            for key, n in launches.items():
                total[key] = total.get(key, 0) + n
            gc.collect()
            torch.cuda.empty_cache()
        self.path_launches["lm_dense"] = total
        for name, r in self.dense_numbers.items():
            print(f"summary {name}: forward {r['s']:.3f} s at S={LM_SEQ} "
                  f"({r['tokens_per_s']:,.0f} tokens/s, peak {r['peak_gb']:.2f} GB); prefill "
                  f"{r['prefill_ms']:.1f} ms; decode {r['decode_tokens_per_s']:,.1f} tokens/s")

    def dense_model(self, name: str) -> dict:
        """One config of lm_dense; returns the launches of its timed loss_fn."""
        import dataclasses

        from repro_torch.configs import get_config
        from repro_torch.data.tokens import TokenStream
        from repro_torch.models import DecoderModel

        torch, ops = self.torch, self.ops
        cfg = get_config(name)
        model = DecoderModel(cfg)
        t0 = time.perf_counter()
        params = model.init(seed=0)
        self.perturb_norms(params, cfg)
        self.sync()
        n_params = sum(p.numel() for p in params.parameters())
        print(f"{name} init on the card: {n_params:,} parameters in "
              f"{time.perf_counter() - t0:.2f} s, "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
        batch = TokenStream(cfg, 1, LM_SEQ, seed=0)(0)
        with torch.no_grad():
            model.loss_fn(params, batch)               # warm-up
            self.sync()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()                       # the main path starts here
            t0 = time.perf_counter()
            loss, metrics = model.loss_fn(params, batch)
            self.sync()
            dt = time.perf_counter() - t0
            launches = ops.launches()                  # ... and is read here
        peak = torch.cuda.max_memory_allocated() / 1e9
        loss, aux = float(loss), float(metrics["aux"])
        print(f"{name} forward + loss at B=1, S={LM_SEQ}: {dt:.3f} s, {LM_SEQ / dt:,.0f} "
              f"tokens/s, peak device memory {peak:.2f} GB, loss {loss:.5f} (ce "
              f"{float(metrics['ce']):.5f}, aux {aux:.5f}); launches {launches}")
        self.check(launches["flash_attention"] == cfg.n_layers
                   and sum(launches.values()) == cfg.n_layers,
                   f"{name}: the forward launched the flash kernel once a layer "
                   f"({cfg.n_layers}) and no other kernel of the port")
        self.check(bool(self.np.isfinite(loss)), f"{name}: the loss is finite")
        self.check((aux > 0) == cfg.is_moe and self.np.isfinite(aux),
                   f"{name}: the MoE aux loss is {'positive' if cfg.is_moe else '0'} and "
                   f"finite ({aux:.5f})")
        numbers = dict(s=dt, tokens_per_s=LM_SEQ / dt, peak_gb=peak, loss=loss, aux=aux,
                       params=n_params)
        with torch.no_grad():
            events = self._profile(lambda: model.loss_fn(params, batch), dt * 1e3,
                                   f"{name} forward")
        self.print_split(events, f"{name} forward")
        numbers.update(self.dense_serve(name, model, params))
        if cfg.is_moe:
            numbers.update(self.moe_opt(cfg, params, batch, loss, aux, dt))
        # the two attention paths, at a cut depth where the direct one
        # would not fit beside the weights
        depth = DENSE_DIRECT_DEPTH.get(name)
        if depth:
            del params
            self.sync()
            cfg = dataclasses.replace(cfg, n_layers=depth)
            params = DecoderModel(cfg).init(seed=0)
            self.perturb_norms(params, cfg)
            print(f"{name}: the attention paths compared at {depth} of 52 layers, on "
                  "weights drawn for that depth")
        runs, drops = self.dense_runs(name, cfg, params, batch)
        for ok, what in self.path_verdicts(runs):
            self.check(ok, f"{name}: {what}")
        numbers.update(drops)
        if cfg.is_moe:
            tight = dataclasses.replace(cfg, capacity_factor=MOE_TIGHT_CAPACITY)
            verdicts, dropped = self.moe_verdicts(tight, params, batch)
            for ok, what in verdicts:
                self.check(ok, what)
            self.check(dropped > 0, f"{name} at capacity factor {MOE_TIGHT_CAPACITY:g}: "
                                    f"{dropped:,} replicas dropped (some must be)")
            numbers["dropped_tight"] = dropped
        self.dense_numbers[name] = numbers
        del params
        return launches

    def moe_opt(self, cfg, params, batch, loss, aux, dt) -> dict:
        """The MoE under the `opt` variant (configs/variants.py: the grouped
        dispatch, each sequence its own group; bf16 probabilities, which the
        flash path never forms): its forward at B = 1, S = 8,192, one
        sequence and so one group, gives the base forward's loss and aux
        bit for bit, timed beside it; a prefill of 4 x 2,048 routes each
        prompt in its own group (a quarter of the global capacity), timed
        beside the base prefill, its logits finite."""
        from repro_torch.configs import apply_variant
        from repro_torch.models import DecoderModel

        torch, ops = self.torch, self.ops
        ocfg = apply_variant(cfg, "opt")
        model = DecoderModel(ocfg)
        base_model = DecoderModel(cfg)
        with torch.no_grad():
            model.loss_fn(params, batch)                   # warm-up
            ops.reset_launches()
            self.sync()
            t0 = time.perf_counter()
            oloss, om = model.loss_fn(params, batch)
            self.sync()
            odt = time.perf_counter() - t0
            n = ops.launches()
            oloss, oaux = float(oloss), float(om["aux"])
            self.check(oloss == loss and oaux == aux and n["flash_attention"] == cfg.n_layers,
                       f"{cfg.name} under opt at B = 1 (one dispatch group): loss {oloss:.6f} "
                       f"and aux {oaux:.6f} are the global dispatch's {loss:.6f}, {aux:.6f} "
                       f"bit for bit; {n['flash_attention']} flash launches")
            b, plen, _ = LM_SERVE
            gen = torch.Generator(device=self.dev).manual_seed(1)
            prompts = torch.randint(0, cfg.vocab_size, (b, plen), generator=gen,
                                    device=self.dev, dtype=torch.int32)
            times, logits = {}, {}
            for tag, m in (("base", base_model), ("opt", model)):
                m.prefill_fn(params, {"tokens": prompts})
                self.sync()
                t0 = time.perf_counter()
                logits[tag] = m.prefill_fn(params, {"tokens": prompts})["logits"]
                self.sync()
                times[tag] = time.perf_counter() - t0
            diff = float((logits["opt"] - logits["base"]).abs().max())
            self.check(bool(torch.isfinite(logits["opt"]).all()),
                       f"{cfg.name} under opt: the prefill of {b} x {plen} (a dispatch group a "
                       f"prompt) gives finite logits, {diff:.3e} from the global dispatch's")
        print(f"  {cfg.name} under opt: forward {odt:.3f} s at B=1, S={LM_SEQ} (base "
              f"{dt:.3f} s); prefill {b} x {plen} {times['opt'] * 1e3:.1f} ms, a group a "
              f"prompt (base, one group: {times['base'] * 1e3:.1f} ms)")
        del logits
        return dict(opt_s=odt, opt_prefill_ms=times["opt"] * 1e3,
                    base_prefill_ms=times["base"] * 1e3)

    def perturb_norms(self, params, cfg):
        """A layer norm's scale 1 + N(0, 0.1) and bias N(0, 0.1), drawn from
        seed 2, where the init gives ones and zeros: a norm that drops its
        bias then computes another function."""
        from repro_torch.models.transformer import LayerNorm

        if cfg.norm_type != "layer":
            return
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(2)
        with torch.no_grad():
            for mod in params.modules():
                if isinstance(mod, LayerNorm):
                    mod.scale.add_(0.1 * torch.randn(mod.scale.shape, generator=g,
                                                     device=self.dev).to(mod.scale.dtype))
                    mod.bias.copy_(0.1 * torch.randn(mod.bias.shape, generator=g,
                                                     device=self.dev))

    def dense_runs(self, name, cfg, params, batch):
        """The four forwards (flash and direct, bf16 and fp32) of one config,
        the flash bf16 one with its layer checks: the layer norm on its own
        inputs against float64 and the MoE's capacity bit for bit
        (`moe_verdicts`)."""
        import dataclasses

        from repro_torch.models import transformer as tfm

        torch, ops = self.torch, self.ops
        tokens = torch.as_tensor(batch["tokens"], device=self.dev)
        labels = torch.as_tensor(batch["labels"], device=self.dev)
        positions = torch.arange(LM_SEQ, dtype=torch.int32, device=self.dev)[None]

        def forward(c):
            with torch.no_grad():
                logits = tfm.decoder_forward(params, c, tokens, positions=positions)[0]
                return float(tfm.cross_entropy(logits, labels)[0]), logits[:, -1].clone()

        f32 = dataclasses.replace(cfg, dtype=torch.float32, param_dtype=torch.float32)
        runs, out = {}, {}
        with self.norm_probe() as norms, self.moe_probe() as moes:
            runs["flash bf16"] = forward(cfg)
        for ok, what in self.norm_verdicts(norms, cfg, name):
            self.check(ok, what)
        if cfg.is_moe:
            for ok, what in self.moe_layer_verdicts(moes, cfg, name):
                self.check(ok, what)
            out["dropped"] = sum(r["dropped"] for r in moes)
        runs["flash fp32"] = forward(f32)
        ops.reset_launches()
        for tag, c in (("direct bf16", cfg), ("direct fp32", f32)):
            runs[tag] = forward(dataclasses.replace(c, chunked_attn_min_len=LM_SEQ + 1))
        self.check(ops.LAUNCHES["flash_attention"] == 0,
                   f"{name}: the direct-path forwards launched no flash kernel")
        for tag, (l, g) in runs.items():
            print(f"  {name} {tag}: loss {l:.6f}")
            self.check(bool(self.np.isfinite(l) and torch.isfinite(g).all()),
                       f"{name} {tag}: loss and last-position logits are finite")
        return runs, out

    def norm_probe(self):
        """A context in which every layer_norm call of the model is held on
        its own inputs: the list it yields gets, per call, the least atol
        with which the output lies within one rounding to the output's
        dtype (rtol 2^-8 in bf16, 1e-6 in fp32) of the float64 layer norm
        of the same input, scale and bias."""
        import contextlib

        from repro_torch.models import transformer as tfm

        torch, recs = self.torch, []
        inner = tfm.layer_norm

        def probe(x, scale, bias, eps):
            out = inner(x, scale, bias, eps)
            xd = x.double()
            mu = xd.mean(-1, keepdim=True)
            y = (xd - mu) * torch.rsqrt(((xd - mu) ** 2).mean(-1, keepdim=True) + eps)
            exact = y * scale.double() + bias.double()
            rtol = 2.0 ** -8 if out.dtype == torch.bfloat16 else 1e-6
            recs.append(float(((out.double() - exact).abs() - rtol * exact.abs()).max()))
            return out

        @contextlib.contextmanager
        def ctx():
            tfm.layer_norm = probe
            try:
                yield recs
            finally:
                tfm.layer_norm = inner

        return ctx()

    def norm_verdicts(self, recs, cfg, name) -> list[tuple[bool, str]]:
        if cfg.norm_type != "layer":
            return []
        n = 2 * cfg.n_layers + 1
        need = max(recs, default=float("inf"))
        return [(len(recs) == n and need <= 1e-5,
                 f"{name}: each of {len(recs)} layer norms ({n} expected) within one bf16 "
                 f"rounding (rtol 2^-8, atol 1e-5) of the float64 layer norm of its own "
                 f"input, scale and bias (the atol it takes: {need:.3e})")]

    def moe_probe(self):
        """A context in which every moe_block call is held on its own input
        against `moe_reference`: the dispatch buffer and the combined output
        bit for bit, and the replicas dropped at the capacity."""
        import contextlib

        from repro_torch.models import layers

        recs, seen = [], {}
        inner = {n: getattr(layers, n) for n in ("moe_route", "moe_experts", "moe_combine")}

        def route(params, xf, cfg, groups=1):
            seen.update(params=params, xf=xf)
            return inner["moe_route"](params, xf, cfg, groups)

        def experts(params, buf, cfg):
            seen["buf"] = buf
            y = inner["moe_experts"](params, buf, cfg)
            seen["y"] = y
            return y

        def combine(y, r, cfg):
            out = inner["moe_combine"](y, r, cfg)
            recs.append(self.moe_reference(seen["params"], seen["xf"], seen["buf"], y, out,
                                           cfg))
            seen.clear()
            return out

        @contextlib.contextmanager
        def ctx():
            layers.moe_route, layers.moe_experts, layers.moe_combine = route, experts, combine
            try:
                yield recs
            finally:
                for n, fn in inner.items():
                    setattr(layers, n, fn)

        return ctx()

    def moe_reference(self, params, xf, buf, y, out, cfg) -> dict:
        """The capacity-bounded top-k MoE's plain version, built apart from
        the port's sort and search: the router's fp32 softmax and its top
        k (a stable descending sort), weights over max(sum, 1e-9), each token's rank among
        an expert's tokens by a cumulative sum of one-hot choices (kept if
        below the capacity), the buffer filled by those ranks, and each
        token's kept contributions y[e, rank] w added in the activation
        dtype from zero in ascending expert order. Against it: the port's
        buffer and output, bit for bit."""
        torch = self.torch
        t, d = xf.shape
        e, k = cfg.n_experts, cfg.n_experts_active
        cap = max(int(math.ceil(t * k / e * cfg.capacity_factor)), 1)
        probs = torch.softmax(xf.float() @ params.router, dim=-1)
        # lax.top_k's order: the lower index first among equal values
        top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
        top_w, top_e = top_w[:, :k], top_e[:, :k]
        top_w = top_w / top_w.sum(dim=-1, keepdim=True).clamp(min=1e-9)
        top_e, order = torch.sort(top_e, dim=-1)
        top_w = top_w.gather(1, order)
        chosen = torch.zeros((t, e), dtype=torch.int64, device=xf.device)
        chosen.scatter_(1, top_e, 1)
        rank = (chosen.cumsum(0) - 1).gather(1, top_e)             # (t, k)
        kept = rank < cap
        ref_buf = torch.zeros_like(buf)
        tok = torch.arange(t, device=xf.device)[:, None].expand(t, k)
        ref_buf[top_e[kept], rank[kept]] = xf[tok[kept]]
        ref_out = torch.zeros((t, d), dtype=out.dtype, device=out.device)
        for j in range(k):
            c = y[top_e[:, j], rank[:, j].clamp(max=cap - 1)] * top_w[:, j:j + 1].to(y.dtype)
            ref_out = ref_out + torch.where(kept[:, j:j + 1], c, torch.zeros_like(c))
        return dict(buf=bool(torch.equal(buf, ref_buf)), out=bool(torch.equal(out, ref_out)),
                    dropped=int((~kept).sum()), cap=cap,
                    out_err=float((out.float() - ref_out.float()).abs().max()))

    def moe_layer_verdicts(self, recs, cfg, tag) -> list[tuple[bool, str]]:
        bad = [i for i, r in enumerate(recs) if not (r["buf"] and r["out"])]
        drops = [r["dropped"] for r in recs]
        worst = max((r["out_err"] for r in recs), default=float("inf"))
        print(f"  {tag}: replicas dropped at capacity {recs[0]['cap'] if recs else '-'} "
              f"(capacity factor {cfg.capacity_factor:g}), layer by layer: {drops}")
        return [(len(recs) == cfg.n_layers and not bad,
                 f"{tag}: each of {len(recs)} MoE layers' dispatch buffer and output bit "
                 f"for bit the plain version's on its own input (layers off: {bad}; "
                 f"largest output difference {worst:.3e})")]

    def moe_verdicts(self, cfg, params, batch) -> tuple[list[tuple[bool, str]], int]:
        """The MoE layer checks on a flash bf16 forward under cfg (its
        capacity factor): verdicts and the replicas dropped."""
        from repro_torch.models import transformer as tfm

        torch = self.torch
        tokens = torch.as_tensor(batch["tokens"], device=self.dev)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32, device=self.dev)[None]
        with torch.no_grad(), self.moe_probe() as recs:
            tfm.decoder_forward(params, cfg, tokens, positions=positions)
        tag = f"{cfg.name} at capacity factor {cfg.capacity_factor:g}"
        return self.moe_layer_verdicts(recs, cfg, tag), sum(r["dropped"] for r in recs)

    def dense_serve(self, name, model, params, prefix: int | None = None) -> dict:
        """launch.serve.generate (prefill of 4 x 2,048, 31 decode steps: no
        flash launch) and the cache invariant prefill(t) == prefill(t[:-1])
        + decode(t[-1]) in fp32 and bf16. The warm-up is the same
        generate() and the invariant is held on the whole prompts; with
        `prefix`, the warm-up generates 2 tokens from the prompts' first
        `prefix` tokens and the invariant is held on them. The MoE's
        invariant is held at capacity factor E / k, where the capacity is
        the batch's tokens and no replica is dropped: at the published 1.25
        a decode step of 4 tokens has a capacity of 1 an expert, so its
        drops differ from prefill's by design (its distance is printed)."""
        import dataclasses

        from repro_torch.launch import serve
        from repro_torch.models import build_model

        torch, ops = self.torch, self.ops
        cfg = model.cfg
        b, plen, max_new = LM_SERVE
        gen = torch.Generator(device=self.dev).manual_seed(1)
        prompts = torch.randint(0, cfg.vocab_size, (b, plen), generator=gen, device=self.dev,
                                dtype=torch.int32)
        if prefix:                                                # warm-up
            serve.generate(model, params, prompts[:, :prefix], 2)
        else:
            serve.generate(model, params, prompts, max_new)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        toks, t_prefill, t_decode = serve.generate(model, params, prompts, max_new)
        launches = ops.launches()
        peak = torch.cuda.max_memory_allocated() / 1e9
        n_dec = b * (max_new - 1)
        print(f"{name} serve {b} x {plen} prompts, {max_new - 1} decode steps: prefill "
              f"{t_prefill * 1e3:.1f} ms, decode {n_dec / t_decode:,.1f} tokens/s "
              f"({t_decode / (max_new - 1) * 1e3:.2f} ms a step), peak device memory "
              f"{peak:.2f} GB")
        self.check(sum(launches.values()) == 0 and tuple(toks.shape) == (b, max_new)
                   and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
                   f"{name}: prefill and decode launch no kernel of the port; the "
                   "generated ids have the expected shape and range")
        base = cfg
        if cfg.is_moe:
            base = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.n_experts_active)
            full = model.prefill_fn(params, {"tokens": prompts})["logits"]
            short = model.prefill_fn(params, {"tokens": prompts[:, :-1]})
            _, dec = model.decode_fn(params, short["cache"], {"tokens": prompts[:, -1:]})
            print(f"  {name} at the published capacity factor {cfg.capacity_factor:g}: "
                  f"bf16 prefill(t) against prefill(t[:-1]) + decode(t[-1]): max abs diff "
                  f"{float((full - dec).abs().max()):.3e} (printed, not held)")
            del full, short, dec
        full, dec = {}, {}
        prompts = prompts[:, :prefix]
        for tag, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            m = build_model(dataclasses.replace(base, dtype=dt, param_dtype=dt))
            full[tag] = m.prefill_fn(params, {"tokens": prompts})["logits"]
            short = m.prefill_fn(params, {"tokens": prompts[:, :-1]})
            _, dec[tag] = m.decode_fn(params, short["cache"], {"tokens": prompts[:, -1:]})
            del short
            self.check(bool(torch.isfinite(full[tag]).all() and torch.isfinite(dec[tag]).all()),
                       f"{name}: {tag} prefill and decode logits are finite")
        what = f"{name}: fp32 prefill(t) against prefill(t[:-1]) + decode(t[-1])"
        for ok, text in (self.verdict(full["fp32"], dec["fp32"], what, CACHE_TOL)[:2],
                         self.verdict(full["fp32"], dec["fp32"], what, LM_FP32_TOL)[:2],
                         self.noise_verdict(dec["bf16"], full["bf16"], full["fp32"],
                                            f"{name}: bf16 prefill(t[:-1]) + decode(t[-1])",
                                            "bf16 prefill(t)")):
            self.check(ok, text)
        return dict(prefill_ms=t_prefill * 1e3, decode_tokens_per_s=n_dec / t_decode,
                    decode_ms=t_decode / (max_new - 1) * 1e3, serve_peak_gb=peak)

    # ------------------------------------------------------------ SSM and hybrid
    def lm_ssm(self):
        """xlstm-350m and zamba2-7b at their published widths, bf16, weights
        from seed 0, one after the other (gemma2-2b's parameters freed
        first, as lm_dense frees them): loss_fn at B = 1, S = 8,192 (the
        main path: no kernel launch for the xLSTM, one flash launch an
        application of zamba's shared block) with its device-busy share,
        generate() and the cache invariant, layer 0's chunked scan against
        its sequential form and float64, and for zamba its flash launches
        and shared-block applications each on its own inputs and the two
        attention paths; then the flash forward alone at zamba's shape and
        four planted faults; last the xLSTM's train steps and zamba2-7b's at
        ZAMBA_TRAIN_LAYERS layers (`cut_train`), its full-depth weights
        freed first."""
        import gc

        from repro_torch.models import zamba

        torch = self.torch
        print(f"card: {card_line()}")
        # the plants replace these; the checks call the true ones
        self.true_shared_block = zamba.shared_block
        if getattr(self, "lm", (None, None))[1] is not None:
            self.lm_digest = self.params_digest(self.lm[1])
            self.lm = (self.lm[0], None)
        gc.collect()
        torch.cuda.empty_cache()
        self.ssm_numbers, self.ssm_kept, total = {}, {}, {}
        for name in SSM_MODELS:
            print(f"  -- {name}", flush=True)
            for key, n in self.ssm_model(name).items():
                total[key] = total.get(key, 0) + n
        self.path_launches["lm_ssm"] = total
        lap = self.lap("lm_ssm")
        # the plant's nvcc runs beside the flash checks, after every timed
        # forward and serving run (they are host-bound)
        planted = self.planted_library("flash_attention", [(FLASH_LAYOUT_NOW, FLASH_LAYOUT_96)],
                                       "flash_96_columns", wait=False)
        try:
            row = self.flash_d112()
            if "flash_attention" in self.rows:
                self.rows["flash_attention"]["zamba2_shape"] = row
            lap("the flash forward at D = 112")
            self.ssm_faults(planted)
            lap("the plants")
        finally:
            planted.stop()
        self.ssm_kept = None
        gc.collect()
        torch.cuda.empty_cache()
        xt = self.xlstm_train()
        lap("xlstm-350m's train steps")
        gc.collect()
        torch.cuda.empty_cache()
        self.cut_train("zamba2-7b")
        lap("zamba2-7b's train steps")
        gc.collect()
        torch.cuda.empty_cache()
        for name, r in self.ssm_numbers.items():
            print(f"summary {name}: forward {r['s']:.3f} s at S={LM_SEQ} "
                  f"({r['tokens_per_s']:,.0f} tokens/s, peak {r['peak_gb']:.2f} GB, idle "
                  f"share {r['idle']:.3f} at S={r['profiled_seq']}); prefill {r['prefill_ms']:.1f} "
                  f"ms; decode {r['decode_tokens_per_s']:,.1f} tokens/s")
        print(f"summary xlstm-350m train step at B=1, S={XLSTM_TRAIN_SEQ}: {xt['s']:.3f} s "
              f"({xt['tokens_per_s']:,.0f} tokens/s), peak {xt['peak_gb']:.2f} GB with remat, "
              f"{xt['plain_peak_gb']:.2f} GB without ({xt['plain_s']:.3f} s)")
        print(f"summary flash (32, {LM_SEQ}, 112): {row['ms']:.3f} ms kernel, bound "
              f"{row['bound_ms']:.3f} ms (the kernel's 4 passes {row['bound_ms_split3']:.3f} "
              f"ms), plain {row['plain_ms']:.3f} ms, "
              f"scaled_dot_product_attention {row['library_ms']:.3f} ms")

    def ssm_model(self, name: str) -> dict:
        """One config of lm_ssm; returns the launches of its timed loss_fn."""
        from repro_torch.configs import get_config
        from repro_torch.data.tokens import TokenStream
        from repro_torch.models import build_model

        torch, ops = self.torch, self.ops
        cfg = get_config(name)
        hybrid = cfg.family == "hybrid"
        n_flash = cfg.n_layers // cfg.attn_every if hybrid else 0
        model = build_model(cfg)
        lap = self.lap(name)
        t0 = time.perf_counter()
        params = model.init(seed=0)
        self.sync()
        n_params = sum(p.numel() for p in params.parameters())
        print(f"{name} init on the card: {n_params:,} parameters in "
              f"{time.perf_counter() - t0:.2f} s, "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
        batch = TokenStream(cfg, 1, LM_SEQ, seed=0)(0)
        with torch.no_grad():
            # warm-up: cuBLAS plans, the allocator, the flash launch; the
            # xLSTM's at a shorter sequence (its sLSTM scan takes seconds)
            model.loss_fn(params, batch if hybrid else TokenStream(cfg, 1, SSM_WARM_SEQ,
                                                                   seed=0)(0))
            self.sync()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()                       # the main path starts here
            t0 = time.perf_counter()
            loss, metrics = model.loss_fn(params, batch)
            self.sync()
            dt = time.perf_counter() - t0
            launches = ops.launches()                  # ... and is read here
        peak = torch.cuda.max_memory_allocated() / 1e9
        loss = float(loss)
        print(f"{name} forward + loss at B=1, S={LM_SEQ}: {dt:.3f} s, {LM_SEQ / dt:,.0f} "
              f"tokens/s, peak device memory {peak:.2f} GB, loss {loss:.5f}; launches "
              f"{launches}")
        what = (f"the flash kernel once an application of the shared block ({n_flash})"
                if hybrid else "none of the port's kernels")
        self.check(launches["flash_attention"] == n_flash and sum(launches.values()) == n_flash,
                   f"{name}: the forward launched {what}: {launches}")
        self.check(bool(self.np.isfinite(loss)) and float(metrics["tokens"]) == LM_SEQ,
                   f"{name}: the loss is finite ({loss:.5f}), {LM_SEQ} labels counted")
        lap("the timed forward and its warm-up")
        # the device-busy share at a shorter sequence (SSM_PROFILE_SEQ; each
        # step and chunk of the scans costs the same at any S)
        seq = SSM_PROFILE_SEQ
        short = TokenStream(cfg, 1, seq, seed=0)(0)
        wall = self.short_wall(model, params, short)
        # CUDA activity alone: the host's events would swamp a forward of
        # hundreds of thousands of launches
        with torch.no_grad():
            events = self._profile(lambda: model.loss_fn(params, short), wall * 1e3,
                                   f"{name} forward at S={seq}", activities=("cuda",))
        self.check(bool(events), f"{name}: the profiled forward at S={seq} holds device "
                   "time (its idle share is measured)")
        busy = sum(e.device_time_total for e in events) / 1e3
        idle = max(0.0, 1 - busy / (wall * 1e3))
        self.print_split(events, f"{name} forward at S={seq}")
        lap("the profiled forward")
        numbers = dict(s=dt, tokens_per_s=LM_SEQ / dt, peak_gb=peak, loss=loss,
                       params=n_params, busy_ms=busy, idle=idle, profiled_seq=seq)
        if hybrid:
            numbers.update(self.zamba_opt(cfg, params, batch, loss, dt, n_flash))
            lap("the forward under opt")
        numbers.update(self.dense_serve(name, model, params, prefix=SSM_SHORT))
        lap("serving and the cache invariant")
        # layer 0's scan on its own full-width inputs
        rec = self.layer0_scan(cfg, params, batch)
        for ok, text in self.scan_verdicts(cfg, rec):
            self.check(ok, text)
        lap("layer 0's scan")
        kept = dict(cfg=cfg, params=params, batch=batch, scan=rec)
        if hybrid:
            for ok, text in self.zamba_probe_verdicts(cfg, params, batch):
                self.check(ok, text)
            lap("the flash launches and shared-block applications on their inputs")
            for ok, text in self.path_verdicts(self.zamba_runs(cfg, params, batch)):
                self.check(ok, f"{name}: {text}")
            lap("the two attention paths")
        self.ssm_numbers[name] = numbers
        self.ssm_kept[name] = kept
        return launches

    def short_wall(self, model, params, short) -> float:
        """Seconds of one no-grad loss_fn on the short batch, the wall a
        profile of it is read against."""
        torch = self.torch
        with torch.no_grad():
            self.sync()
            t0 = time.perf_counter()
            model.loss_fn(params, short)
            self.sync()
            return time.perf_counter() - t0

    def zamba_opt(self, cfg, params, batch, loss, dt, n_flash) -> dict:
        """zamba2-7b's forward at B = 1, S = 8,192 under the `opt` variant
        (the SSD scan at chunk 64 with its decay folded into B and C; bf16
        probabilities, which its flash launches never form): seconds beside
        the base forward's, its loss beside the base loss, and the device's
        idle share at SSM_PROFILE_SEQ, as the base forward's."""
        from repro_torch.configs import apply_variant
        from repro_torch.data.tokens import TokenStream
        from repro_torch.models import build_model

        torch, ops = self.torch, self.ops
        model = build_model(apply_variant(cfg, "opt"))
        with torch.no_grad():
            model.loss_fn(params, batch)       # warm-up, as the base forward's
            ops.reset_launches()
            self.sync()
            t0 = time.perf_counter()
            oloss, _ = model.loss_fn(params, batch)
            self.sync()
            odt = time.perf_counter() - t0
            n = ops.launches()
        short = TokenStream(cfg, 1, SSM_PROFILE_SEQ, seed=0)(0)
        wall = self.short_wall(model, params, short)
        with torch.no_grad():
            events = self._profile(lambda: model.loss_fn(params, short), wall * 1e3,
                                   f"{cfg.name} forward under opt at S={SSM_PROFILE_SEQ}",
                                   activities=("cuda",))
        oloss = float(oloss)
        busy = sum(e.device_time_total for e in events) / 1e3
        idle = max(0.0, 1 - busy / (wall * 1e3))
        self.print_split(events, f"{cfg.name} forward under opt at S={SSM_PROFILE_SEQ}")
        self.check(bool(events) and n["flash_attention"] == n_flash
                   and bool(self.np.isfinite(oloss)),
                   f"{cfg.name} under opt (ssm_chunk 64, ssd_fold_decay): {n_flash} flash "
                   f"launches, a finite loss {oloss:.5f} (base {loss:.5f}, |diff| "
                   f"{abs(oloss - loss):.2e}), the profile holds device time")
        print(f"summary {cfg.name} under opt: forward {odt:.3f} s at S={LM_SEQ} (base "
              f"{dt:.3f} s), idle share {idle:.3f} at S={SSM_PROFILE_SEQ} (busy {busy:.1f} ms "
              f"of {wall * 1e3:.1f})")
        return dict(opt_s=odt, opt_idle=idle, opt_busy_ms=busy, opt_loss=oloss)

    def xlstm_train(self) -> dict:
        """xlstm-350m's make_train_step at its published width, bf16, seed 0,
        B = 1, S = XLSTM_TRAIN_SEQ: a warm-up step and XLSTM_TRAIN_STEPS timed
        steps with remat (each mLSTM block recomputed in the backward), then
        one step without: seconds, tokens/s and each step's peak device
        memory. The remat steps' peak must lie REMAT_PEAK_MARGIN below the
        other's, and a plant of the forward that ignored remat must fail
        that check. No kernel of the port runs in it."""
        import dataclasses

        from repro_torch.configs import get_config
        from repro_torch.data.tokens import TokenStream
        from repro_torch.launch import train
        from repro_torch.models import ssm
        from repro_torch.optim import AdamWConfig

        torch, ops = self.torch, self.ops
        cfg = get_config("xlstm-350m")
        opt = AdamWConfig()
        state = [train.init_train_state(cfg, 0, opt)]
        data = TokenStream(cfg, 1, XLSTM_TRAIN_SEQ, seed=0)
        steps = {remat: train.make_train_step(dataclasses.replace(cfg, remat=remat), opt,
                                              total_steps=100) for remat in (True, False)}

        def run(remat: bool, i: int) -> tuple[dict, float, float]:
            self.sync()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state[0], metrics = steps[remat](state[0], data(i))
            self.sync()
            return metrics, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 1e9

        run(True, 0)                                   # warm-up
        ops.reset_launches()
        timed = [run(True, 1 + i) for i in range(XLSTM_TRAIN_STEPS)]
        launches = ops.launches()
        plain = run(False, 1 + XLSTM_TRAIN_STEPS)
        for tag, (m, dt, peak) in [(f"remat step {i + 1}", r) for i, r in enumerate(timed)] + [
                ("step without remat", plain)]:
            print(f"xlstm-350m train {tag} at B=1, S={XLSTM_TRAIN_SEQ}: {dt:.3f} s, "
                  f"{XLSTM_TRAIN_SEQ / dt:,.0f} tokens/s, peak device memory {peak:.3f} GB, "
                  f"loss {float(m['loss']):.5f}, grad norm {float(m['grad_norm']):.4f}")
            self.check(bool(self.np.isfinite(float(m["loss"]))
                            and self.np.isfinite(float(m["grad_norm"]))),
                       f"xlstm-350m train {tag}: loss and gradient norm are finite")
        self.check(sum(launches.values()) == 0,
                   f"xlstm-350m's train steps launched no kernel of the port: {launches}")
        peak_remat, peak_plain = max(r[2] for r in timed), plain[2]

        def lower(peak: float, what: str) -> tuple[bool, str]:
            return (peak <= (1 - REMAT_PEAK_MARGIN) * peak_plain,
                    f"xlstm-350m: the {what} step's peak device memory {peak:.3f} GB lies "
                    f"{REMAT_PEAK_MARGIN:.0%} or more below the step without remat's "
                    f"{peak_plain:.3f} GB")

        self.check(*lower(peak_remat, "remat"))
        # the plant: the forward as it was before it read cfg.remat
        planted = self.planted_function(ssm, "xlstm_forward",
                                        "remat = not decode and remat_on(cfg)", "remat = False")
        real = ssm.xlstm_forward
        ssm.xlstm_forward = planted
        try:
            _, _, peak_planted = run(True, 2 + XLSTM_TRAIN_STEPS)
        finally:
            ssm.xlstm_forward = real
        ok, text = lower(peak_planted, "planted (remat not read) remat")
        print(f"    xlstm_forward with remat not read: {'passes' if ok else 'FAILS'} {text}")
        self.check(not ok, "planted fault 'xlstm_forward with remat not read' fails the peak "
                   "memory check")
        dt = sum(r[1] for r in timed) / len(timed)
        state[0] = None
        return dict(s=dt, tokens_per_s=XLSTM_TRAIN_SEQ / dt, peak_gb=peak_remat,
                    plain_s=plain[1], plain_peak_gb=peak_plain, planted_peak_gb=peak_planted)

    @staticmethod
    def lap(what: str):
        """A function printing the seconds since its last call (or since
        this one), with `what` and the step it names."""
        last = [time.perf_counter()]

        def lap(step: str):
            now = time.perf_counter()
            print(f"  ({what}: {step} {now - last[0]:.1f} s)", flush=True)
            last[0] = now
        return lap

    def layer0_scan(self, cfg, params, batch) -> tuple:
        """The inputs of layer 0's chunked scan, as the bf16 forward gives
        them: (function name, args, kwargs) of its mlstm_chunked (xLSTM) or
        ssd_chunked (Mamba2) call."""
        from repro_torch.models import mamba, ssm

        torch = self.torch
        mod, fn = (mamba, "ssd_chunked") if cfg.family == "hybrid" else (ssm, "mlstm_chunked")
        real, recs = getattr(mod, fn), []

        def record(*a, **kw):
            recs.append((a, kw))
            return real(*a, **kw)

        tokens = torch.as_tensor(batch["tokens"], device=self.dev)
        setattr(mod, fn, record)
        try:
            with torch.no_grad():
                h = params.embed.to(cfg.dtype)[tokens]
                if cfg.family == "hybrid":
                    mamba.mamba2_block(params.mamba[0][0], h, cfg, None)
                else:
                    ssm.mlstm_block(params.mlstm[0][0], h, cfg, None)
        finally:
            setattr(mod, fn, real)
        return (fn,) + recs[0]

    def scan_verdicts(self, cfg, rec) -> list[tuple[bool, str]]:
        """Layer 0's chunked scan (`ssm.mlstm_chunked` or
        `mamba.ssd_chunked`, as the module holds it) on its recorded inputs,
        against the sequential form (`mlstm_sequential`, or `ssd_step` a
        position at a time) in fp32 and against the same in float64: output
        and final state at SSM_TOL."""
        from repro_torch.models import mamba, ssm

        torch = self.torch
        fn, args, kw = rec
        name = cfg.name
        with torch.no_grad():
            if fn == "mlstm_chunked":
                def seq(a):
                    return ssm.mlstm_sequential(*a[:5], ssm.MLSTMState(*a[5]))
                got = ssm.mlstm_chunked(*args[:5], ssm.MLSTMState(*args[5]), **kw)
                wide = tuple(t.double() for t in args[:5]) + (
                    tuple(t.double() for t in args[5]),)
                states = ("c", "n", "m")
            else:
                def seq(a):
                    x, dt, aa, b, c, st = a
                    ys = []
                    for t in range(x.shape[1]):
                        y, st = mamba.ssd_step(x[:, t], dt[:, t], aa, b[:, t], c[:, t], st)
                        ys.append(y)
                    return torch.stack(ys, dim=1), (st,)
                got = mamba.ssd_chunked(*args, **kw)
                got = (got[0], (got[1],))
                wide = tuple(t.double() for t in args)
                states = ("h",)
            ref32 = seq(args)
            ref64 = seq(wide)
            self.sync()
        out = []
        for tag, want in (("its sequential form in fp32", ref32), ("float64", ref64)):
            ok, text, _ = self.verdict(got[0], want[0], f"{name} layer 0: {fn}'s output "
                                       f"against {tag}", SSM_TOL)
            out.append((ok, text))
            for s, a, b in zip(states, got[1], want[1]):
                ok, text, _ = self.verdict(a, b, f"{name} layer 0: {fn}'s final state {s} "
                                           f"against {tag}", SSM_TOL)
                out.append((ok, text))
        print(f"  {name} layer 0: the sequential form's output against float64: max abs "
              f"err {self.max_err(ref32[0], ref64[0]):.3e} (inputs {tuple(args[0].shape)})")
        return out

    def zamba_probe_verdicts(self, cfg, params, batch) -> list[tuple[bool, str]]:
        """A bf16 zamba forward whose flash launches and shared-block
        applications are each held on their own inputs: each launch against
        the plain version (3e-2 and one bf16 ulp) and against float64 head by
        head (within one bf16 ulp of the head's largest magnitude); each
        application recomputed from the model's one shared block on its
        recorded input, to the same bits."""
        from repro_torch.models import zamba

        torch, ops = self.torch, self.ops
        n_groups = zamba.zamba_groups(cfg)[0]
        tokens = torch.as_tensor(batch["tokens"], device=self.dev)
        s = tokens.shape[1]
        n_flash = n_groups if s >= cfg.chunked_attn_min_len else 0
        positions = torch.arange(s, dtype=torch.int32, device=self.dev)[None]
        real_flash, real_shared = ops.flash_attention, zamba.shared_block
        flash, shared = [], []

        def flash_probe(q, k, v, **kw):
            out = real_flash(q, k, v, **kw)
            flash.append((q, k, v, kw, out))
            return out

        def shared_probe(p, h, c, **kw):
            out = real_shared(p, h, c, **kw)
            shared.append((p, h, kw, out[0]))
            return out

        ops.flash_attention, zamba.shared_block = flash_probe, shared_probe
        try:
            with torch.no_grad():
                zamba.zamba_forward(params, cfg, tokens, positions=positions)
        finally:
            ops.flash_attention, zamba.shared_block = real_flash, real_shared
        self.sync()
        out = [(len(flash) == n_flash and len(shared) == n_groups,
                f"zamba2-7b at S={s}: {len(flash)} flash launches and {len(shared)} "
                f"shared-block applications recorded ({n_flash} and {n_groups})")]
        for i, (q, k, v, kw, got) in enumerate(flash):
            tag = f"zamba2-7b flash launch {i} {tuple(q.shape)} over {k.shape[0]} KV heads"
            out.extend(self.launch_verdicts(tag, q, k, v, kw, got))
        for i, (p, h, kw, got) in enumerate(shared):
            with torch.no_grad():
                again = self.true_shared_block(params.shared, h, cfg, **kw)[0]
            same = p is params.shared and torch.equal(again, got)
            out.append((same, f"zamba2-7b shared-block application {i}: the model's one "
                        f"shared block recomputed on its input gives its bits (max abs diff "
                        f"{float((again.float() - got.float()).abs().max()):.3e})"))
        del flash, shared
        return out

    def zamba_runs(self, cfg, params, batch) -> dict:
        """zamba's forward down the flash and the direct attention paths, in
        bf16 and fp32 (the bf16 weights cast per use): (loss, last-position
        logits) each."""
        import dataclasses

        from repro_torch.models import transformer as tfm
        from repro_torch.models import zamba

        torch, ops = self.torch, self.ops
        tokens = torch.as_tensor(batch["tokens"], device=self.dev)
        labels = torch.as_tensor(batch["labels"], device=self.dev)
        positions = torch.arange(LM_SEQ, dtype=torch.int32, device=self.dev)[None]

        def forward(c):
            with torch.no_grad():
                logits = zamba.zamba_forward(params, c, tokens, positions=positions)[0]
                return float(tfm.cross_entropy(logits, labels)[0]), logits[:, -1].clone()

        f32 = dataclasses.replace(cfg, dtype=torch.float32, param_dtype=torch.float32)
        runs = {"flash bf16": forward(cfg), "flash fp32": forward(f32)}
        ops.reset_launches()
        for tag, c in (("direct bf16", cfg), ("direct fp32", f32)):
            runs[tag] = forward(dataclasses.replace(c, chunked_attn_min_len=LM_SEQ + 1))
        self.check(ops.launches()["flash_attention"] == 0,
                   "zamba2-7b: the direct-path forwards launched no flash kernel")
        for tag, (l, g) in runs.items():
            print(f"  zamba2-7b {tag}: loss {l:.6f}")
            self.check(bool(self.np.isfinite(l) and torch.isfinite(g).all()),
                       f"zamba2-7b {tag}: loss and last-position logits are finite")
        return runs

    def flash_d112(self) -> dict:
        """The flash forward alone at zamba2-7b's shape, (32, 8,192, 112) over
        32 KV heads, causal, softcap 0, window 0: held in bf16 and fp32 at S
        = 8,192 and ragged (`flash112_verdicts`), timed beside its bound (2
        bf16 tensor passes a visible pair; the kernel's 4 beside it), its
        plain version and scaled_dot_product_attention. Returns the kernels
        line's record."""
        torch, ops, ref = self.torch, self.ops, self.ref
        bh, bhk, d = ZAMBA_FLASH
        for ok, text in self.flash112_verdicts(FLASH112_SEED, ("bf16", "fp32")):
            self.check(ok, text)
        g = torch.Generator(device=self.dev).manual_seed(FLASH112_SEED)
        q, k, v = (torch.randn(n, LM_SEQ, d, generator=g, device=self.dev).to(torch.bfloat16)
                   for n in (bh, bhk, bhk))
        kw = dict(causal=True, window=0, softcap=0.0)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q[None], k[None], v[None], is_causal=True, enable_gqa=True)[0]

        err = self.close(sdpa().float(), ops.flash_attention(q, k, v, **kw).float(),
                         f"flash_attention (32, {LM_SEQ}, 112): scaled_dot_product_attention "
                         "against the kernel", FLASH_TOL["bf16"])
        pairs = bh * visible_pairs(LM_SEQ, 0)
        tb = sum(t.numel() * t.element_size() for t in (q, k, v, q)) / HBM_BYTES_PER_S * 1e3
        to = FLASH_FWD_PASSES * 2.0 * d * pairs / BF16_TENSOR_FLOPS * 1e3
        row = dict(shape=f"zamba2-7b's shared attention ({bh}, {LM_SEQ}, {d}) over {bhk} KV "
                         "heads, bf16, causal, softcap 0, window 0",
                   max_abs_err=self.max_err(ops.flash_attention(q, k, v, **kw).float(),
                                            ref.flash_attention_ref(q, k, v, **kw).float()),
                   ms=self.cuda_ms(lambda: ops.flash_attention(q, k, v, **kw)),
                   plain_ms=self.cuda_ms(lambda: ref.flash_attention_ref(q, k, v, **kw),
                                         reps=1),
                   bound_ms=max(tb, to), bound_by="bytes" if tb >= to else "operations",
                   bound_ms_split3=max(tb, FLASH_FWD_SPLIT3_PASSES * 2.0 * d * pairs
                                       / BF16_TENSOR_FLOPS * 1e3),
                   library_ms=self.cuda_ms(sdpa), library="scaled_dot_product_attention, "
                   "is_causal", library_max_abs_err=err)
        print(f"    flash_attention (32, {LM_SEQ}, 112): {row['ms']:.3f} ms kernel, "
              f"{row['plain_ms']:.3f} ms plain, bound {row['bound_ms']:.3f} ms "
              f"({row['bound_by']}: 2 bf16 tensor passes a visible pair; kernel at "
              f"{row['ms'] / row['bound_ms']:.2f}x), the kernel's 4 passes "
              f"{row['bound_ms_split3']:.3f} ms (kernel at "
              f"{row['ms'] / row['bound_ms_split3']:.2f}x), scaled_dot_product_attention "
              f"{row['library_ms']:.3f} ms")
        return row

    def flash112_verdicts(self, seed: int, dtypes) -> list[tuple[bool, str]]:
        """The flash forward at D = 112 against its plain version on inputs
        of `seed`, (32, S, 112) over 32 KV heads at S = 8,192, 8,191 and 100:
        fp32 at FLASH112_FP32_TOL, bf16 at 3e-2 and one bf16 ulp, and at S =
        8,192 against float64 head by head (the kernel within an ulp, or no
        farther than the plain version)."""
        torch, ops, ref = self.torch, self.ops, self.ref
        bh, bhk, d = ZAMBA_FLASH
        kw = dict(causal=True, window=0, softcap=0.0)
        g = torch.Generator(device=self.dev).manual_seed(seed)
        out = []
        for s in (LM_SEQ,) + SSM_RAGGED:
            base = [torch.randn(n, s, d, generator=g, device=self.dev) for n in (bh, bhk, bhk)]
            for name in dtypes:
                dtype = torch.bfloat16 if name == "bf16" else torch.float32
                q, k, v = (t.to(dtype) for t in base)
                got = ops.flash_attention(q, k, v, **kw).float()
                want = ref.flash_attention_ref(q, k, v, **kw).float()
                self.sync()
                tag = f"flash_attention ({bh}, {s}, {d}) {name}, inputs of seed {seed}"
                if name == "fp32":
                    out.append(self.verdict(got, want, tag, FLASH112_FP32_TOL)[:2])
                    out.append(self.verdict(got[..., 96:], want[..., 96:], f"{tag}, columns "
                                            "96-111", FLASH112_FP32_TOL)[:2])
                    continue
                out.append(self.verdict(got, want, tag, FLASH_TOL["bf16"])[:2])
                out.append(self.verdict(got, want, f"{tag}, within a bf16 ulp",
                                        FLASH_BF16_ULP_TOL)[:2])
                if s == LM_SEQ:
                    rtol = FLASH_BF16_ULP_TOL["rtol"]
                    need = {"kernel": 0.0, "plain": 0.0}
                    for h0 in range(0, bh, 8):
                        exact = self.exact_heads(q, k, v, h0, min(h0 + 8, bh))
                        for who, o in (("kernel", got), ("plain", want)):
                            need[who] = max(need[who], float(
                                ((o[h0:h0 + 8].double() - exact).abs()
                                 - rtol * exact.abs()).max()))
                        del exact
                    out.append((need["kernel"] <= max(FLASH_BF16_ULP_TOL["atol"], need["plain"]),
                                f"{tag} against float64: the kernel takes an atol of "
                                f"{need['kernel']:.3e} beside the one-ulp rtol, the plain version "
                                f"{need['plain']:.3e}"))
                del got, want
        return out

    def planted_function(self, module, name: str, old: str, new: str):
        """module.name compiled again from its source text with `old` (which
        must appear once) replaced by `new`, in the module's namespace."""
        import inspect

        src = inspect.getsource(getattr(module, name))
        if src.count(old) != 1:
            raise RuntimeError(f"plant: '{old}' is not in {module.__name__}.{name} once")
        ns = dict(vars(module))
        exec(compile(src.replace(old, new), f"<planted {module.__name__}.{name}>", "exec"), ns)
        return ns[name]

    def ssm_faults(self, planted_build):
        """lm_ssm's plants, one at a time; each must fail a check of the
        phase: the fp32 flash kernel built with lanes over 96 of 112
        columns, a D = 112 launch given the scale 1/sqrt(128), an
        mlstm_chunked without the inter-chunk stabilizer, and a zamba
        forward whose shared-block applications each draw their own
        weights."""
        from repro_torch.data.tokens import TokenStream
        from repro_torch.models import ssm, zamba

        torch, ops, build = self.torch, self.ops, self.build_mod
        xl, zb = self.ssm_kept["xlstm-350m"], self.ssm_kept["zamba2-7b"]
        cfg = zb["cfg"]
        n_groups = zamba.zamba_groups(cfg)[0]
        real_library, real_flash = build.library, ops.flash_attention
        real_chunked, real_shared = ssm.mlstm_chunked, zamba.shared_block
        lib96 = planted_build()

        def library_96(name):
            return lib96 if name == "flash_attention" else real_library(name)

        def scale_128(q, k, v, **kw):
            if q.shape[-1] == 112:
                kw = dict(kw, scale=128 ** -0.5)
            return real_flash(q, k, v, **kw)

        no_stabilizer = self.planted_function(
            ssm, "mlstm_chunked", "inter_scale = torch.exp(inter_b - m_new)",
            "inter_scale = torch.ones_like(inter_b)")
        # the shared-block plant's forward: a sequence that takes the direct
        # attention path (the plant is in the block's weights, not its kernel)
        short = TokenStream(cfg, 1, SSM_SHORT, seed=0)(0)
        gens = [torch.Generator(device=self.dev).manual_seed(100 + i) for i in range(n_groups)]
        own = [zamba.SharedBlock(cfg, generator=g, device=self.dev) for g in gens]
        applied = [0]

        def own_weights(p, h, c, **kw):
            applied[0] += 1
            return real_shared(own[(applied[0] - 1) % n_groups], h, c, **kw)

        plants = [
            ("flash fp32 at D = 112: lanes over 96 of 112 columns (CPT = D / 32)", build,
             "library", library_96,
             lambda: self.flash112_verdicts(FLASH112_SEED + 1, ("fp32",))),
            ("flash at D = 112 given the scale 1/sqrt(128)", ops, "flash_attention", scale_128,
             lambda: self.zamba_probe_verdicts(cfg, zb["params"], zb["batch"])),
            ("mlstm_chunked without the inter-chunk stabilizer (inter_scale = 1)", ssm,
             "mlstm_chunked", no_stabilizer,
             lambda: self.scan_verdicts(xl["cfg"], xl["scan"])),
            ("zamba's shared-block applications each with weights of their own", zamba,
             "shared_block", own_weights,
             lambda: self.zamba_probe_verdicts(cfg, zb["params"], short)),
        ]
        for name, mod, attr, fn, checks in plants:
            saved = getattr(mod, attr)
            setattr(mod, attr, fn)
            try:
                verdicts = checks()
            finally:
                setattr(mod, attr, saved)
            caught = [what for ok, what in verdicts if not ok]
            for ok, what in verdicts:
                print(f"    {name}: {'passes' if ok else 'FAILS'} {what}")
            self.check(bool(caught), f"planted fault '{name}' fails {len(caught)} of "
                       f"{len(verdicts)} checks")
        # the inputs of the first plant, through the real kernel: the checks hold
        verdicts = self.flash112_verdicts(FLASH112_SEED + 1, ("fp32",))
        self.check(all(ok for ok, _ in verdicts),
                   f"the 96-column plant's checks pass with no plant "
                   f"({sum(ok for ok, _ in verdicts)} of {len(verdicts)})")
        self.check(build.library is real_library and ops.flash_attention is real_flash
                   and ssm.mlstm_chunked is real_chunked and zamba.shared_block is real_shared,
                   "every plant undone")
        del own

    # ------------------------------------------------------------ audio and VLM
    def lm_mm(self):
        """whisper-medium and qwen2-vl-7b at their published widths, bf16,
        weights from seed 0, one after the other (gemma2-2b's parameters
        freed first, as lm_dense frees them): loss_fn at B = 1, S = 8,192
        (the main path: whisper's decoder launches the flash kernel twice a
        layer, causal self-attention and non-causal cross-attention over
        1,500 frames; qwen2-vl once a layer over 1,024 patches and 7,168
        tokens) with its device-busy share, the first and last layers'
        flash launches each on its own inputs, the two attention paths,
        generate() and the cache invariant on Qwen2-VL's own positions,
        one planted fault a model; then the flash forward alone at the
        three new shapes."""
        import gc

        torch = self.torch
        print(f"card: {card_line()}")
        if getattr(self, "lm", (None, None))[1] is not None:
            self.lm_digest = self.params_digest(self.lm[1])
            self.lm = (self.lm[0], None)
        gc.collect()
        torch.cuda.empty_cache()
        self.mm_numbers, total = {}, {}
        for name in MM_MODELS:
            print(f"  -- {name}", flush=True)
            for key, n in self.mm_model(name).items():
                total[key] = total.get(key, 0) + n
            gc.collect()
            torch.cuda.empty_cache()
        self.path_launches["lm_mm"] = total
        lap = self.lap("lm_mm")
        rows = {tag: self.mm_flash_row(tag, *shape) for tag, *shape in MM_FLASH_SHAPES}
        if "flash_attention" in self.rows:
            for tag, row in rows.items():
                self.rows["flash_attention"][MM_ROW_KEYS[tag]] = row
        lap("the flash forward at the three shapes")
        for name, r in self.mm_numbers.items():
            print(f"summary {name}: forward {r['s']:.3f} s at S={LM_SEQ} "
                  f"({r['tokens_per_s']:,.0f} tokens/s, peak {r['peak_gb']:.2f} GB, idle "
                  f"share {r['idle']:.3f}); prefill {r['prefill_ms']:.1f} ms; decode "
                  f"{r['decode_tokens_per_s']:,.1f} tokens/s")
        for tag, row in rows.items():
            print(f"summary flash {tag} {row['dims']}: {row['ms']:.3f} ms kernel, bound "
                  f"{row['bound_ms']:.3f} ms (the kernel's 4 passes {row['bound_ms_split3']:.3f} "
                  f"ms), plain {row['plain_ms']:.3f} ms, scaled_dot_product_attention "
                  f"{row['library_ms']:.3f} ms")

    def mm_model(self, name: str) -> dict:
        """One config of lm_mm; returns the launches of its timed loss_fn."""
        from repro_torch.configs import get_config
        from repro_torch.data.tokens import TokenStream
        from repro_torch.models import build_model

        torch, ops = self.torch, self.ops
        cfg = get_config(name)
        audio = cfg.family == "audio"
        n_flash = (2 if audio else 1) * cfg.n_layers
        model = build_model(cfg)
        lap = self.lap(name)
        t0 = time.perf_counter()
        params = model.init(seed=0)
        self.sync()
        n_params = sum(p.numel() for p in params.parameters())
        print(f"{name} init on the card: {n_params:,} parameters in "
              f"{time.perf_counter() - t0:.2f} s, "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
        n_text = LM_SEQ if audio else LM_SEQ - cfg.n_patches
        batch = TokenStream(cfg, 1, n_text, seed=0)(0)
        with torch.no_grad():
            model.loss_fn(params, batch)               # warm-up
            self.sync()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()                       # the main path starts here
            t0 = time.perf_counter()
            loss, metrics = model.loss_fn(params, batch)
            self.sync()
            dt = time.perf_counter() - t0
            launches = ops.launches()                  # ... and is read here
        peak = torch.cuda.max_memory_allocated() / 1e9
        loss = float(loss)
        what = ("a causal self-attention and a non-causal cross-attention a decoder layer"
                if audio else "one a layer")
        inputs = (f"{cfg.encoder_seq:,} frames, {n_text:,} tokens" if audio else
                  f"{cfg.n_patches:,} patches, {n_text:,} tokens")
        print(f"{name} forward + loss at B=1, S={LM_SEQ} ({inputs}): {dt:.3f} s, "
              f"{LM_SEQ / dt:,.0f} tokens/s, peak device memory {peak:.2f} GB, loss "
              f"{loss:.5f}; launches {launches}")
        self.check(launches["flash_attention"] == n_flash and sum(launches.values()) == n_flash,
                   f"{name}: the forward launched the flash kernel {n_flash} times ({what}) "
                   f"and no other kernel of the port: {launches}")
        self.check(bool(self.np.isfinite(loss)) and float(metrics["tokens"]) == n_text,
                   f"{name}: the loss is finite ({loss:.5f}), {n_text} labels counted")
        lap("the timed forward and its warm-up")
        with torch.no_grad():
            events = self._profile(lambda: model.loss_fn(params, batch), dt * 1e3,
                                   f"{name} forward at S={LM_SEQ}", activities=("cuda",))
        self.check(bool(events), f"{name}: the profiled forward holds device time (its idle "
                   "share is measured)")
        busy = sum(e.device_time_total for e in events) / 1e3
        idle = max(0.0, 1 - busy / (dt * 1e3))
        self.print_split(events, f"{name} forward at S={LM_SEQ}")
        lap("the profiled forward")
        numbers = dict(s=dt, tokens_per_s=LM_SEQ / dt, peak_gb=peak, loss=loss,
                       params=n_params, busy_ms=busy, idle=idle)
        wanted = ((0, 1, n_flash - 2, n_flash - 1) if audio else (0, n_flash - 1))
        for ok, text in self.mm_probe_verdicts(cfg, model, params, batch, wanted):
            self.check(ok, text)
        lap("the first and last layers' flash launches on their inputs")
        for ok, text in self.path_verdicts(self.mm_runs(model, params, batch)):
            self.check(ok, f"{name}: {text}")
        lap("the two attention paths")
        numbers.update(self.mm_serve(name, model, params))
        lap("serving")
        for ok, text in self.mm_cache_verdicts(model, params):
            self.check(ok, text)
        lap("the cache invariant")
        self.mm_fault(model, params, batch, wanted)
        lap("the plant")
        self.mm_numbers[name] = numbers
        return launches

    def launch_verdicts(self, tag, q, k, v, kw, got) -> list[tuple[bool, str]]:
        """One bf16 flash launch on its own inputs: against the plain version
        (3e-2 and one bf16 ulp) and against float64 head by head, within one
        bf16 ulp of the head's largest magnitude."""
        torch, ref = self.torch, self.ref
        with torch.no_grad():
            want = ref.flash_attention_ref(q, k, v, **kw).float()
        out = [self.verdict(got.float(), want, f"{tag} against the plain version",
                            FLASH_TOL["bf16"])[:2],
               self.verdict(got.float(), want, f"{tag} within a bf16 ulp of the plain version",
                            FLASH_BF16_ULP_TOL)[:2]]
        del want
        assert kw["window"] == 0 and kw["softcap"] == 0.0
        worst, err = 0.0, 0.0
        for h0 in range(0, q.shape[0], 8):
            h1 = min(h0 + 8, q.shape[0])
            exact = self.exact_heads(q, k, v, h0, h1, kw["causal"])
            e = (got[h0:h1].double() - exact).abs().flatten(1).amax(dim=1)
            top = exact.abs().flatten(1).amax(dim=1)
            ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
            worst, err = max(worst, float((e / ulp).max())), max(err, float(e.max()))
            del exact
        out.append((worst <= 1.0, f"{tag} against float64 head by head: worst err / (one "
                    f"bf16 ulp of the head's largest magnitude) {worst:.3f}, max abs err "
                    f"{err:.3e}"))
        return out

    def mm_probe_verdicts(self, cfg, model, params, batch, wanted) -> list[tuple[bool, str]]:
        """A bf16 forward whose flash launches numbered `wanted` (in launch
        order: whisper's layer i launches self-attention 2i and
        cross-attention 2i + 1) are each held on their own inputs
        (`launch_verdicts`)."""
        torch, ops = self.torch, self.ops
        real, recs, count = ops.flash_attention, [], [0]

        def probe(q, k, v, **kw):
            out = real(q, k, v, **kw)
            if count[0] in wanted:
                recs.append((count[0], q, k, v, kw, out))
            count[0] += 1
            return out

        ops.flash_attention = probe
        try:
            with torch.no_grad():
                model.loss_fn(params, batch)
        finally:
            ops.flash_attention = real
        self.sync()
        out = [(len(recs) == len(wanted), f"{cfg.name}: flash launches {wanted} recorded "
                f"({[r[0] for r in recs]} of {count[0]})")]
        per_layer = 2 if cfg.family == "audio" else 1
        for i, q, k, v, kw, got in recs:
            kind = ("" if per_layer == 1 else
                    " self-attention" if i % 2 == 0 else " cross-attention")
            tag = (f"{cfg.name} layer {i // per_layer}{kind} flash launch {tuple(q.shape)} over "
                   f"{tuple(k.shape)}, {'causal' if kw['causal'] else 'non-causal'}")
            out.extend(self.launch_verdicts(tag, q, k, v, kw, got))
        del recs
        return out

    def mm_runs(self, model, params, batch) -> dict:
        """The forward down the flash and the direct attention paths at full
        depth, in bf16 and fp32 (the bf16 weights cast per use): (loss,
        last-position logits) each. The loss is loss_fn's (the head in
        chunks); the logits are the last position's row of the head."""
        import dataclasses

        from repro_torch.models import build_model
        from repro_torch.models import transformer as tfm

        torch, ops = self.torch, self.ops
        cfg = model.cfg

        def forward(c):
            m = build_model(c)
            with torch.no_grad():
                if c.family == "audio":
                    enc = tfm.encoder_forward(params, c, m._ids(batch["frames"]))
                    h, _ = tfm.encdec_hidden(params, c, m._ids(batch["tokens"]), enc)
                else:
                    embeds, positions, tokens = m._embeds_and_positions(params, batch)
                    h, _, _ = tfm.decoder_hidden(params, c, tokens, positions=positions,
                                                 embeds=embeds)
                loss, _ = tfm.head_loss(params, c, h, m._ids(batch["labels"]))
                last = tfm.matmul_f32(h[:, -1:], tfm.head_weight(params, c).t())[:, 0]
                return float(loss), last

        f32 = dataclasses.replace(cfg, dtype=torch.float32, param_dtype=torch.float32)
        runs = {"flash bf16": forward(cfg), "flash fp32": forward(f32)}
        ops.reset_launches()
        for tag, c in (("direct bf16", cfg), ("direct fp32", f32)):
            runs[tag] = forward(dataclasses.replace(c, chunked_attn_min_len=LM_SEQ + 1))
        self.check(ops.launches()["flash_attention"] == 0,
                   f"{cfg.name}: the direct-path forwards launched no flash kernel")
        for tag, (l, g) in runs.items():
            print(f"  {cfg.name} {tag}: loss {l:.6f}")
            self.check(bool(self.np.isfinite(l) and torch.isfinite(g).all()),
                       f"{cfg.name} {tag}: loss and last-position logits are finite")
        return runs

    def mm_inputs(self, cfg, b: int, n_text: int, *, grid: bool, seed: int = 1):
        """(prompts (b, n_text), the stubs' prefill inputs): whisper's frames;
        qwen2-vl's patch embeddings and positions, 0 .. S - 1 on every
        channel (the launcher's) or, with `grid`, Qwen2-VL's own: the
        patches at t = 0 on a MM_GRID x MM_GRID (h, w) grid and the text
        from MM_GRID on all three channels."""
        from repro_torch.launch import serve

        torch = self.torch
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        prompts = torch.randint(0, cfg.vocab_size, (b, n_text), generator=gen,
                                device=self.dev, dtype=torch.int32)
        inputs = serve.stub_inputs(cfg, b, n_text, gen)
        if grid and cfg.family == "vlm":
            idx = torch.arange(cfg.n_patches, device=self.dev)
            patches = torch.stack([torch.zeros_like(idx), idx // MM_GRID, idx % MM_GRID])
            text = (MM_GRID + torch.arange(n_text, device=self.dev)).expand(3, n_text)
            inputs["positions"] = torch.cat([patches, text], dim=1).to(torch.int32).expand(
                b, 3, cfg.n_patches + n_text)
        return prompts, inputs

    def mm_serve(self, name, model, params) -> dict:
        """launch.serve.generate: prefill of 4 prompts of 2,048 positions
        (whisper's 2,048 tokens over its 1,500 frames; qwen2-vl's 1,024
        patches and 1,024 tokens), then 31 greedy decode steps; no flash
        launch."""
        from repro_torch.launch import serve

        torch, ops = self.torch, self.ops
        cfg = model.cfg
        b, plen, max_new = LM_SERVE
        n_text = plen if cfg.family == "audio" else plen - cfg.n_patches
        prompts, inputs = self.mm_inputs(cfg, b, n_text, grid=False)
        serve.generate(model, params, prompts, max_new, inputs=inputs)     # warm-up
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        toks, t_prefill, t_decode = serve.generate(model, params, prompts, max_new,
                                                   inputs=inputs)
        launches = ops.launches()
        peak = torch.cuda.max_memory_allocated() / 1e9
        n_dec = b * (max_new - 1)
        print(f"{name} serve {b} x {plen} positions ({n_text} tokens), {max_new - 1} decode "
              f"steps: prefill {t_prefill * 1e3:.1f} ms, decode {n_dec / t_decode:,.1f} "
              f"tokens/s ({t_decode / (max_new - 1) * 1e3:.2f} ms a step), peak device "
              f"memory {peak:.2f} GB")
        self.check(sum(launches.values()) == 0 and tuple(toks.shape) == (b, max_new)
                   and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
                   f"{name}: prefill and decode launch no kernel of the port; the generated "
                   "ids have the expected shape and range")
        return dict(prefill_ms=t_prefill * 1e3, decode_tokens_per_s=n_dec / t_decode,
                    decode_ms=t_decode / (max_new - 1) * 1e3, serve_peak_gb=peak)

    def mm_invariant(self, model, params) -> tuple[dict, dict]:
        """prefill(t) and prefill(t[:-1]) + decode(t[-1]) on MM_SHORT tokens
        of 4 prompts (whisper over its frames; qwen2-vl after its patches,
        on Qwen2-VL's grid positions, the decode step at the batch's
        position MM_GRID + MM_SHORT - 1), in bf16 and fp32: ({dtype: full
        logits}, {dtype: decode logits})."""
        import dataclasses

        from repro_torch.models import build_model

        torch = self.torch
        cfg = model.cfg
        b = LM_SERVE[0]
        prompts, inputs = self.mm_inputs(cfg, b, MM_SHORT, grid=True)
        short_inputs = dict(inputs)
        step = {"tokens": prompts[:, -1:]}
        if "positions" in inputs:
            short_inputs["positions"] = inputs["positions"][:, :, :-1]
            step["positions"] = inputs["positions"][:, :, -1:]
        full, dec = {}, {}
        for tag, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            m = build_model(dataclasses.replace(cfg, dtype=dt, param_dtype=dt))
            full[tag] = m.prefill_fn(params, {"tokens": prompts, **inputs})["logits"]
            short = m.prefill_fn(params, {"tokens": prompts[:, :-1], **short_inputs})
            _, dec[tag] = m.decode_fn(params, short["cache"], step)
            del short
        return full, dec

    def mm_cache_verdicts(self, model, params) -> list[tuple[bool, str]]:
        """The cache invariant (`mm_invariant`): fp32 at CACHE_TOL and
        LM_FP32_TOL, bf16 within the noise floor of the bf16 prefill."""
        name = model.cfg.name
        full, dec = self.mm_invariant(model, params)
        out = [(bool(self.torch.isfinite(full[t]).all() and self.torch.isfinite(dec[t]).all()),
                f"{name}: {t} prefill and decode logits are finite") for t in full]
        what = f"{name}: fp32 prefill(t) against prefill(t[:-1]) + decode(t[-1])"
        out += [self.verdict(full["fp32"], dec["fp32"], what, CACHE_TOL)[:2],
                self.verdict(full["fp32"], dec["fp32"], what, LM_FP32_TOL)[:2],
                self.noise_verdict(dec["bf16"], full["bf16"], full["fp32"],
                                   f"{name}: bf16 prefill(t[:-1]) + decode(t[-1])",
                                   "bf16 prefill(t)")]
        return out

    def mm_fault(self, model, params, batch, wanted):
        """lm_mm's plant for this model, which must fail a check: whisper's
        cross launches fed K and V zero-padded to MM_PAD_KEYS keys (the
        reference's chunked fault), held by the per-launch checks; qwen2-vl
        decode steps whose M-RoPE positions are the cache's index, held by
        the cache invariant."""
        from repro_torch.models import api

        ops = self.ops
        cfg = model.cfg
        if cfg.family == "audio":
            real = ops.flash_attention
            F = self.torch.nn.functional

            def padded(q, k, v, **kw):
                if not kw["causal"]:
                    k, v = (F.pad(t, (0, 0, 0, MM_PAD_KEYS - t.shape[1])) for t in (k, v))
                return real(q, k, v, **kw)

            plant = ("whisper's cross launches given K and V zero-padded to "
                     f"{MM_PAD_KEYS} keys", ops, "flash_attention", padded,
                     lambda: self.mm_probe_verdicts(cfg, model, params, batch, wanted))
        else:
            real = api.DecoderModel.decode_fn

            def index_positions(self_, params_, cache, step):
                pos = cache["pos"][0].to(self.torch.int32).expand(step["tokens"].shape[0], 3, 1)
                return real(self_, params_, cache, dict(step, positions=pos))

            plant = ("qwen2-vl decode positions taken from the cache's index", api.DecoderModel,
                     "decode_fn", index_positions,
                     lambda: self.mm_cache_verdicts(model, params))
        what, owner, attr, fn, checks = plant
        saved = getattr(owner, attr)
        setattr(owner, attr, fn)
        try:
            verdicts = checks()
        finally:
            setattr(owner, attr, saved)
        caught = [text for ok, text in verdicts if not ok]
        for ok, text in verdicts:
            print(f"    {what}: {'passes' if ok else 'FAILS'} {text}")
        self.check(bool(caught), f"planted fault '{what}' fails {len(caught)} of "
                   f"{len(verdicts)} checks")
        self.check(getattr(owner, attr) is saved, "the plant undone")

    def mm_flash_row(self, tag, bh, bhk, sq, sk, d, causal) -> dict:
        """The flash forward alone at one of lm_mm's shapes, bf16, softcap 0,
        window 0, on inputs of MM_FLASH_SEED: against its plain version and
        scaled_dot_product_attention (is_causal as the shape is, GQA by
        enable_gqa), timed beside its bound (2 bf16 tensor passes a visible
        pair; the kernel's 4 beside it), its plain version and SDPA."""
        torch, ops, ref = self.torch, self.ops, self.ref
        g = torch.Generator(device=self.dev).manual_seed(MM_FLASH_SEED + bh + d)
        q = torch.randn(bh, sq, d, generator=g, device=self.dev).to(torch.bfloat16)
        k, v = (torch.randn(bhk, sk, d, generator=g, device=self.dev).to(torch.bfloat16)
                for _ in range(2))
        kw = dict(causal=causal, window=0, softcap=0.0)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q[None], k[None], v[None], is_causal=causal, enable_gqa=True)[0]

        dims = f"({bh}, {sq}{'' if sq == sk else f' x {sk}'}, {d}) over {bhk} KV heads"
        got = ops.flash_attention(q, k, v, **kw).float()
        want = ref.flash_attention_ref(q, k, v, **kw).float()
        err = self.close(got, want, f"flash_attention {tag} {dims} against its plain version",
                         FLASH_TOL["bf16"])
        self.close(got, want, f"flash_attention {tag} {dims} within a bf16 ulp of its plain "
                   "version", FLASH_BF16_ULP_TOL)
        lib_err = self.close(sdpa().float(), got, f"flash_attention {tag} {dims}: "
                             "scaled_dot_product_attention against the kernel",
                             FLASH_TOL["bf16"])
        del got, want
        pairs = bh * (visible_pairs(sq, 0) if causal else sq * sk)
        tb = sum(t.numel() * t.element_size() for t in (q, k, v, q)) / HBM_BYTES_PER_S * 1e3
        to = FLASH_FWD_PASSES * 2.0 * d * pairs / BF16_TENSOR_FLOPS * 1e3
        row = dict(shape=f"{tag} {dims}, bf16, {'causal' if causal else 'non-causal'}, "
                         "softcap 0, window 0", dims=dims, max_abs_err=err,
                   ms=self.cuda_ms(lambda: ops.flash_attention(q, k, v, **kw)),
                   plain_ms=self.cuda_ms(lambda: ref.flash_attention_ref(q, k, v, **kw),
                                         reps=1),
                   bound_ms=max(tb, to), bound_by="bytes" if tb >= to else "operations",
                   bound_ms_split3=max(tb, FLASH_FWD_SPLIT3_PASSES * 2.0 * d * pairs
                                       / BF16_TENSOR_FLOPS * 1e3),
                   library_ms=self.cuda_ms(sdpa),
                   library=f"scaled_dot_product_attention, is_causal={causal}, enable_gqa",
                   library_max_abs_err=lib_err)
        print(f"    flash_attention {tag} {dims}: {row['ms']:.3f} ms kernel, "
              f"{row['plain_ms']:.3f} ms plain, bound {row['bound_ms']:.3f} ms "
              f"({row['bound_by']}: 2 bf16 tensor passes a visible pair; kernel at "
              f"{row['ms'] / row['bound_ms']:.2f}x), the kernel's 4 passes "
              f"{row['bound_ms_split3']:.3f} ms (kernel at "
              f"{row['ms'] / row['bound_ms_split3']:.2f}x), scaled_dot_product_attention "
              f"{row['library_ms']:.3f} ms")
        return row

    # ------------------------------------------------------------ LM training
    def lm_train(self):
        """gemma2-2b training on the card: the backward kernel alone, the
        two attention paths' gradients, the full-width train step and the
        Trainer; then DENSE_TRAINED's steps and granite-20b's at
        GRANITE_TRAIN_LAYERS layers (`cut_train`). lm_eval's parameters are
        freed first (the steps need the room) and drawn again from the same
        seed at the end, for lm_faults."""
        import gc

        torch = self.torch
        model = self.lm[0]
        # lm_dense frees them first and keeps their digest
        digest = self.lm_digest if self.lm[1] is None else self.params_digest(self.lm[1])
        self.lm = (model, None)
        gc.collect()
        torch.cuda.empty_cache()
        verdicts, err = self.bwd_verdicts()
        for ok, what in verdicts:
            self.check(ok, what)
        self.bwd_timing(err)
        self.compress_check()
        self.train_grads(model.cfg)
        self.train_steps(model.cfg)
        self.trainer_reduced()
        gc.collect()
        torch.cuda.empty_cache()
        launches: dict[str, int] = {}
        for name in DENSE_TRAINED:
            for key, n in self.dense_train_steps(name).items():
                launches[key] = launches.get(key, 0) + n
            gc.collect()
            torch.cuda.empty_cache()
        self.path_launches["lm_train_dense"] = launches
        self.cut_train("granite-20b")
        gc.collect()
        torch.cuda.empty_cache()
        self.lm = (model, model.init(seed=0))
        self.check(self.params_digest(self.lm[1]) == digest,
                   "lm_eval's parameters drawn again from seed 0 are the ones lm_eval "
                   "ran (per-parameter float64 sums and sums of squares equal)")

    # ------------------------------------------------------------ whisper training
    def lm_train_mm(self):
        """whisper-medium's training at its published widths (needs no other
        phase): the backward kernel at the cross-attention's shape, (16,
        8,192 x 1,500, 64) non-causal, on the first and last decoder
        layers' own inputs against float64 head by head, twice to the same
        bits, timed beside its bound, its plain version and
        scaled_dot_product_attention's backward (and at the self-attention's
        (16, 8,192, 64)); the flash path's full-width gradients against the
        direct path's and both against the fp32 direct path's;
        make_train_step, 1 + LM_TRAIN_STEPS timed steps (seconds, tokens/s,
        peak memory, launches a step, the idle share of a profiled step);
        then two builds of the backward planted in its ragged KV tile; last
        qwen2-vl-7b's steps at QWEN_VL_TRAIN_LAYERS layers (`cut_train`)."""
        import gc

        from repro_torch.configs import get_config
        from repro_torch.data.tokens import TokenStream
        from repro_torch.launch.train import init_train_state, make_train_step
        from repro_torch.optim import AdamWConfig

        torch, ops = self.torch, self.ops
        print(f"card: {card_line()}")
        lap = self.lap("lm_train_mm")
        # the plants compile while the real kernel is checked: the mask's
        # k < S_k dropped alone, and with it the ragged tile loaded whole
        mask_edit = ("bool vis = qpos < Sq && kpos < Sk;", "bool vis = qpos < Sq;")
        whole = [(f"{src} + (size_t)k0 * D, min(DQ_BK, Sk - k0), DQ_BK);",
                  f"{src} + (size_t)k0 * D, DQ_BK, DQ_BK);") for src in ("kb", "vb")]
        whole += [(f"{src} + (size_t)k1 * D,\n                                 "
                   "min(DQ_BK, Sk - k1), DQ_BK);",
                   f"{src} + (size_t)k1 * D,\n                                 DQ_BK, DQ_BK);")
                  for src in ("kb", "vb")]
        plants = {"mask_only": self.planted_library("flash_attention_bwd", [mask_edit],
                                                    "ragged_mask_only", wait=False),
                  "ragged_keys": self.planted_library("flash_attention_bwd",
                                                      [mask_edit] + whole,
                                                      "ragged_keys_in_p", wait=False)}
        try:
            cfg = get_config("whisper-medium")
            opt = AdamWConfig()
            t0 = time.perf_counter()
            state = init_train_state(cfg, 0, opt)
            self.sync()
            n_params = sum(p.numel() for p in state.params.parameters())
            print(f"whisper-medium train state on the card: {n_params:,} parameters, bf16, "
                  f"and fp32 AdamW moments in {time.perf_counter() - t0:.2f} s; "
                  f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
            data = TokenStream(cfg, 1, LM_SEQ, seed=0)
            batches = [data(i) for i in range(LM_TRAIN_STEPS + 1)]
            cross = self.mm_cross_inputs(cfg, state.params, batches[0])
            lap("init and the recorded cross-attention inputs")
            err = 0.0
            for tag, (q, k, v, kw) in cross.items():
                verdicts, e = self.recorded_bwd_verdicts(f"whisper {tag}", q, k, v, kw)
                for ok, what in verdicts:
                    self.check(ok, what)
                err = max(err, e)
            lap("the backward on the first and last layers' inputs")
            q, k, v, kw = cross["layer 0"]
            rows = {"whisper cross-attention": self.bwd_row(
                        "whisper cross-attention", q, k, v, kw, err)}
            qs = self.randn(16, LM_SEQ, 64).to(torch.bfloat16)
            ks, vs = (self.randn(16, LM_SEQ, 64).to(torch.bfloat16) for _ in range(2))
            rows["whisper self-attention"] = self.bwd_row(
                "whisper self-attention", qs, ks, vs, dict(kw, causal=True), None)
            del qs, ks, vs
            if "flash_attention_bwd" in self.rows:
                for tag, row in rows.items():
                    self.rows["flash_attention_bwd"][MM_ROW_KEYS[tag]] = row
            lap("the backward timed at whisper's two shapes")
            self.mm_train_grads(cfg, state.params, batches[0])
            lap("the two attention paths' gradients")
            self.mm_train_steps(cfg, state, make_train_step(cfg, opt), batches)
            del state
            gc.collect()
            torch.cuda.empty_cache()
            lap("the train steps")
            for ok, what in self.mm_bwd_plants(plants, cross["layer 0"]):
                self.check(ok, what)
            lap("the plants")
        finally:
            for load in plants.values():
                load.stop()
        del cross
        gc.collect()
        torch.cuda.empty_cache()
        self.cut_train("qwen2-vl-7b")
        lap("qwen2-vl-7b's train steps")
        gc.collect()
        torch.cuda.empty_cache()

    def mm_cross_inputs(self, cfg, params, batch) -> dict:
        """The first and last decoder layers' cross-attention flash launches
        of a no-grad forward, on their own inputs: {tag: (q, k, v, kw)}.
        Whisper's decoder layer i launches self-attention 2i, then
        cross-attention 2i + 1."""
        from repro_torch.models import build_model

        torch, ops = self.torch, self.ops
        wanted = {1: "layer 0", 2 * cfg.n_layers - 1: f"layer {cfg.n_layers - 1}"}
        real, recs, count = ops.flash_attention, {}, [0]

        def probe(q, k, v, **kw):
            if count[0] in wanted:
                recs[wanted[count[0]]] = (q, k, v, kw)
            count[0] += 1
            return real(q, k, v, **kw)

        ops.flash_attention = probe
        try:
            with torch.no_grad():
                build_model(cfg).loss_fn(params, batch)
        finally:
            ops.flash_attention = real
        self.check(len(recs) == 2 and count[0] == 2 * cfg.n_layers and all(
            tuple(q.shape) == (16, LM_SEQ, 64) and tuple(k.shape) == (16, cfg.encoder_seq, 64)
            and not kw["causal"] for q, k, v, kw in recs.values()),
            f"whisper-medium: the first and last cross-attention launches recorded, "
            f"(16, {LM_SEQ}, 64) over (16, {cfg.encoder_seq}, 64), non-causal "
            f"({sorted(recs)} of {count[0]} launches)")
        return recs

    def recorded_bwd_verdicts(self, tag, q, k, v, kw, do=None
                              ) -> tuple[list[tuple[bool, str]], float]:
        """The backward through FlashAttention on one launch's inputs (`tag`
        names them: whisper's cross-attention at S_q != S_k, an application
        of zamba's shared block, seeded inputs at a train step's shape), dO
        given or of MM_BWD_SEED: one forward and one backward launch; dq, dk
        and dv of each head within one bf16 ulp of its largest magnitude of
        float64 (`bwd_exact`) and, in bf16, at most BWD_MISROUNDED_SHARE of
        their elements more than half their own bf16 ulp from it; a second
        backward gives the same bits. Returns the verdicts and the largest
        error."""
        torch, ops = self.torch, self.ops
        if do is None:
            g = torch.Generator(device=self.dev).manual_seed(MM_BWD_SEED)
            do = torch.randn(q.shape, generator=g, device=self.dev).to(q.dtype)
        sk = "" if k.shape[1] == q.shape[1] else f" x {k.shape[1]}"
        dims = (f"({q.shape[0]}, {q.shape[1]}{sk}, {q.shape[2]}) over {k.shape[0]} KV heads, "
                f"{'causal' if kw['causal'] else 'non-causal'}")
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        ops.reset_launches()
        o = ops.flash_attention(*leaves, **kw)
        got = torch.autograd.grad(o, leaves, do, retain_graph=True)
        self.sync()
        n = ops.launches()
        again = torch.autograd.grad(o, leaves, do)
        out = [(n["flash_attention"] == 1 and n["flash_attention_bwd"] == 1,
                f"flash_attention_bwd {tag} {dims}: one forward and one backward "
                f"launch ({n['flash_attention']}, {n['flash_attention_bwd']})"),
               (all(torch.equal(a, b) for a, b in zip(got, again)),
                f"flash_attention_bwd {tag} {dims}: two backward launches give the "
                "same bits")]
        want = self.bwd_exact(q, k, v, do, kw)
        largest = 0.0
        for gr, w, gname in zip(got, want, ("dq", "dk", "dv")):
            worst, err, share = self.grad_errors(gr, w)
            if q.dtype == torch.bfloat16:
                out.append((share <= BWD_MISROUNDED_SHARE,
                            f"flash_attention_bwd {tag} {dims}: {gname}'s elements more "
                            f"than half their own bf16 ulp from float64: a share of "
                            f"{share:.2e} (at most {BWD_MISROUNDED_SHARE:g})"))
            out.append((worst <= 1.0,
                        f"flash_attention_bwd {tag} {dims}: {gname} of each head "
                        f"within one bf16 ulp of its largest magnitude (at least "
                        f"{GRAD_ULP_FLOOR:g}) of float64: worst err / ulp {worst:.3f}, max "
                        f"abs err {err:.3e}"))
            largest = max(largest, err)
        del leaves, o, got, again, want
        return out, largest

    def bwd_row(self, tag, q, k, v, kw, err, do=None) -> dict:
        """The backward launch alone (its forward's lse and output from the
        kernel), dO given or of MM_BWD_SEED + 1: timed beside its bound (5
        passes a visible pair at the peak of q's dtype: the bf16 tensor
        cores' or the fp32 pipes'), its plain version (8 query heads at a
        time) and the backward of scaled_dot_product_attention (enable_gqa,
        is_causal as the shape is); err, where given, is the float64
        check's. Returns the kernels line's record."""
        torch, ops = self.torch, self.ops
        bh, sq, d = q.shape
        bhk, sk, _ = k.shape
        causal, name = kw["causal"], "bf16" if q.dtype == torch.bfloat16 else "fp32"
        if do is None:
            g = torch.Generator(device=self.dev).manual_seed(MM_BWD_SEED + 1)
            do = torch.randn(q.shape, generator=g, device=self.dev).to(q.dtype)
        out, lse, o32 = ops._flash_forward(q, k, v, causal, kw["window"], kw["softcap"],
                                           kw["scale"], keep=True)
        o = o32 if o32.numel() else out
        bkw = dict(causal=causal, window=kw["window"], softcap=kw["softcap"],
                   scale=kw["scale"])
        ms = self.cuda_ms(lambda: ops.flash_attention_bwd(q, k, v, do, lse, o, **bkw))
        pms = self.cuda_ms(lambda: self.plain_bwd_by_heads(q, k, v, do, lse, o, bkw), reps=1)
        grads = ops.flash_attention_bwd(q, k, v, do, lse, o, **bkw)
        leaves = [t.detach()[None].requires_grad_() for t in (q, k, v)]
        out = torch.nn.functional.scaled_dot_product_attention(
            *leaves, is_causal=causal, scale=kw["scale"], enable_gqa=True)
        lgrads = torch.autograd.grad(out, leaves, do[None], retain_graph=True)
        lib_err = max(float((a[0].float() - b.float()).abs().max() / b.float().abs().max())
                      for a, b in zip(lgrads, grads))
        lib = self.cuda_ms(lambda: torch.autograd.grad(out, leaves, do[None],
                                                       retain_graph=True))
        pairs = bh * (visible_pairs(sq, 0) if causal else sq * sk)
        n_bytes = (sum(t.numel() * t.element_size() for t in (q, k, v, do)) * 2
                   + o.numel() * 4 + lse.numel() * 4)
        tb = n_bytes / HBM_BYTES_PER_S * 1e3
        peak = BF16_TENSOR_FLOPS if name == "bf16" else FP32_FLOPS
        to = FLASH_BWD_PASSES * 2.0 * d * pairs / peak * 1e3
        dims = f"({bh}, {sq}{'' if sq == sk else f' x {sk}'}, {d}) over {bhk} KV heads"
        row = dict(shape=f"{tag} {dims}, {name}, {'causal' if causal else 'non-causal'}, "
                         "softcap 0, window 0", dims=dims, max_abs_err=err, ms=ms,
                   plain_ms=pms, bound_ms=max(tb, to),
                   bound_by="bytes" if tb >= to else "operations", library_ms=lib,
                   library=f"the backward of scaled_dot_product_attention, is_causal={causal}",
                   library_rel_err=lib_err)
        split3 = ""
        if name == "bf16":
            row["bound_ms_split3"] = max(tb, FLASH_BWD_SPLIT3_PASSES * 2.0 * d * pairs
                                         / BF16_TENSOR_FLOPS * 1e3)
            split3 = f", the kernels' 11 passes {row['bound_ms_split3']:.3f} ms"
        print(f"    flash_attention_bwd {tag} {dims} {name}: {ms:.3f} ms kernel, {pms:.3f} ms "
              f"plain, bound {row['bound_ms']:.3f} ms ({row['bound_by']}: 5 passes a visible "
              f"pair at the {name} peak; kernel at {ms / row['bound_ms']:.1f}x){split3}, "
              f"scaled_dot_product_attention's backward {lib:.3f} ms (within {lib_err:.2e} "
              "of each gradient's largest magnitude of the kernel's)")
        self.check(lib_err <= FLASH_TOL["bf16"]["rtol"],
                   f"flash_attention_bwd {tag} {dims} {name}: scaled_dot_product_attention's "
                   f"backward within {FLASH_TOL['bf16']['rtol']:g} of each gradient's largest "
                   f"magnitude of the kernel's: {lib_err:.2e}")
        del lse, o32, o, grads, leaves, out, lgrads, do
        return row

    def mm_train_grads(self, cfg, params, batch):
        """whisper-medium's full-width gradients (B = 1, S = 8,192 over 1,500
        frames): the flash path (48 forward launches and 24 recomputed, 48
        backward) against the direct path (chunked_attn_min_len above S:
        no launch), and both against the fp32 direct path, with lm_train's
        limits: the losses within LM_LOSS_RTOL, the global norms within
        GRAD_NORM_RTOL, each parameter within LM_GRAD_RTOL in the 2-norm
        and no farther from fp32 than GRAD_NOISE_FACTOR times the direct
        bf16 path."""
        import dataclasses

        from repro_torch.models import build_model
        from repro_torch.optim.adamw import global_norm

        torch, ops = self.torch, self.ops
        direct = dataclasses.replace(cfg, chunked_attn_min_len=LM_SEQ + 1)
        runs = {}
        for name, c in (("flash bf16", cfg), ("direct bf16", direct),
                        ("direct fp32", dataclasses.replace(direct, dtype=torch.float32))):
            ops.reset_launches()
            t0 = time.perf_counter()
            loss, grads = self.grads_of(build_model(c), params, batch)
            self.sync()
            n = ops.launches()
            runs[name] = (loss, grads, float(global_norm(grads)))
            print(f"  whisper-medium {name}: loss {loss:.6f}, grad norm {runs[name][2]:.6f}, "
                  f"{time.perf_counter() - t0:.2f} s, launches {n}")
            if name == "flash bf16":
                self.check(n["flash_attention"] == 4 * cfg.n_layers
                           and n["flash_attention_bwd"] == 2 * cfg.n_layers
                           and sum(n.values()) == 6 * cfg.n_layers,
                           f"whisper-medium flash bf16 loss and backward: {4 * cfg.n_layers} "
                           f"flash launches (forward and recompute) and {2 * cfg.n_layers} "
                           f"backward launches: {n}")
            else:
                self.check(sum(n.values()) == 0,
                           f"whisper-medium {name}: no launch of a kernel of the port")
        (lf, gf, nf), (ld, gd, nd), (l32, g32, n32) = runs.values()
        self.check(abs(lf - ld) <= LM_LOSS_RTOL * abs(ld),
                   f"whisper-medium loss with grad: flash {lf:.6f} against direct {ld:.6f}: "
                   f"|diff| {abs(lf - ld):.2e} <= {LM_LOSS_RTOL} x |loss|")
        self.check(abs(nf - nd) <= GRAD_NORM_RTOL * nd,
                   f"whisper-medium global gradient norm: flash {nf:.6f} against direct "
                   f"{nd:.6f}: |diff| {abs(nf - nd):.2e} <= {GRAD_NORM_RTOL} x norm (fp32 "
                   f"direct {n32:.6f})")
        rows = []
        for name in gf:
            f, dd, r = (x[name].float() for x in (gf, gd, g32))
            ed = float((dd - r).norm())
            rel = float((f - dd).norm()) / max(float(dd.norm()), 1e-30)
            ratio = float((f - r).norm()) / max(ed, 1e-30)
            # a gradient the bf16 direct path gives exactly (to fp32's bits)
            # has no noise floor to be held to; it is held by rel alone
            rows.append((name, rel, ratio if ed > 0 else 0.0))
        for name, rel, ratio in sorted(rows, key=lambda r: -r[1])[:6]:
            print(f"    {name}: |flash - direct| / |direct| {rel:.3e}; |flash - fp32| / "
                  f"|direct - fp32| {ratio:.3f}")
        ratios = sorted(r[2] for r in rows)
        # The key biases' gradients are 0 in exact arithmetic (a key bias
        # adds q . bk to every score of a row, which the softmax cancels):
        # each path's is its own rounding noise, 1.5-1.6 times the other's
        # apart on an H100, so the relative limit has no signal there.
        # They are held by the noise ratio below, as every parameter is.
        worst_rel = max(r[1] for r in rows if not r[0].endswith(".bk"))
        worst_ratio = ratios[-1]
        print(f"  whisper-medium per-parameter |flash - fp32| / |direct - fp32| over "
              f"{len(rows)} tensors: median {ratios[len(ratios) // 2]:.3f}, max {worst_ratio:.3f}")
        self.check(worst_rel <= LM_GRAD_RTOL,
                   f"whisper-medium: each parameter's gradient but the key biases' (0 in "
                   f"exact arithmetic), flash path against direct path: |flash - direct| / "
                   f"|direct| <= {LM_GRAD_RTOL} (worst {worst_rel:.3e})")
        self.check(worst_ratio <= GRAD_NOISE_FACTOR,
                   f"whisper-medium: each parameter's gradient on the flash path no farther "
                   f"from the fp32 gradient than {GRAD_NOISE_FACTOR}x the direct bf16 path's "
                   f"(in the 2-norm; worst {worst_ratio:.3f})")
        self.mm_grad_norm = nf
        del runs, gf, gd, g32

    def mm_train_steps(self, cfg, state, step, batches):
        """make_train_step of whisper-medium: one warm-up step (its
        grad_norm the flash gradients' norm bit for bit), LM_TRAIN_STEPS
        timed (the path: launches counted from just before to just after),
        and a profiled one for the device's idle share."""
        torch, ops = self.torch, self.ops
        torch.cuda.reset_peak_memory_stats()
        state, m = step(state, batches[0])                # warm-up
        first = (float(m["loss"]), float(m["grad_norm"]))
        self.check(first[1] == self.mm_grad_norm,
                   f"whisper-medium: the first step's grad_norm {first[1]:.6f} is the flash "
                   f"gradients' global norm {self.mm_grad_norm:.6f} bit for bit")
        state, m, times, losses, launches, peak = self.timed_steps(step, state, batches[1:])
        self.path_launches["lm_train_mm"] = launches
        dt = sum(times) / len(times)
        per = {k: v / LM_TRAIN_STEPS for k, v in launches.items() if v}
        n = cfg.n_layers
        print(f"whisper-medium train step at B=1, S={LM_SEQ} over {cfg.encoder_seq} frames, "
              f"remat on: {dt:.3f} s a step ({', '.join(f'{t:.3f}' for t in times)}), "
              f"{LM_SEQ / dt:,.0f} tokens/s, peak device memory {peak:.2f} GB; launches a "
              f"step {per}; losses {first[0]:.5f} then {', '.join(f'{x:.5f}' for x in losses)}")
        self.check(launches["flash_attention"] == 4 * n * LM_TRAIN_STEPS
                   and launches["flash_attention_bwd"] == 2 * n * LM_TRAIN_STEPS
                   and sum(launches.values()) == 6 * n * LM_TRAIN_STEPS,
                   f"whisper-medium: each step launched the flash forward {4 * n} times (a "
                   f"self- and a cross-attention a layer, each again in the recompute) and its "
                   f"backward {2 * n} times ({n} at S_q != S_k), and no other kernel of the "
                   f"port: {per}")
        self.check(all(self.np.isfinite(x) for x in losses + list(first)),
                   "whisper-medium: every step's loss and grad_norm are finite")
        self.check(peak < 80.0, f"whisper-medium: peak device memory {peak:.2f} GB is under "
                   "80 GB")
        events = self._profile(lambda: step(state, batches[1]), dt * 1e3,
                               "whisper-medium train step", activities=("cuda",))
        self.check(bool(events), "whisper-medium: the profiled train step holds device time "
                   "(its idle share is measured)")
        busy = sum(e.device_time_total for e in events) / 1e3
        idle = max(0.0, 1 - busy / (dt * 1e3))
        self.print_split(events, "whisper-medium train step")
        print(f"summary whisper-medium train step: {dt:.3f} s at B=1, S={LM_SEQ} "
              f"({LM_SEQ / dt:,.0f} tokens/s, peak {peak:.2f} GB, idle share {idle:.3f}); "
              f"launches a step {per}")
        self.mm_train_numbers = dict(s=dt, tokens_per_s=LM_SEQ / dt, peak_gb=peak,
                                     idle=idle, launches_a_step=per)

    def mm_bwd_plants(self, plants, inputs) -> list[tuple[bool, str]]:
        """Two builds of the backward planted in the ragged KV tile of S_k =
        1,500 (23 x 64 + 28 keys), each through the cross-attention check
        (`recorded_bwd_verdicts`) on layer 0's inputs, with K and V in buffers
        that hold MM_PLANT_PAD_KEYS real rows past S_k. The mask's k < S_k
        dropped alone lets the tile's zero-filled keys into P: they add
        dS 0 = 0 to dQ, and their own dK and dV rows are never written, so
        its gradients are the kernel's bit for bit. With the tile's keys
        also loaded whole (what lies past S_k enters P) the check must
        fail."""
        torch, ops = self.torch, self.ops
        build = self.build_mod
        q, k, v, kw = inputs
        pad = MM_PLANT_PAD_KEYS * k.shape[-1]

        def padded(t):
            buf = torch.randn(t.numel() + pad, generator=self.gen, device=self.dev).to(t.dtype)
            buf[:t.numel()] = t.reshape(-1)
            return buf[:t.numel()].view(t.shape)

        kp, vp = padded(k), padded(v)
        real_library = build.library
        g = torch.Generator(device=self.dev).manual_seed(MM_BWD_SEED)
        do = torch.randn(q.shape, generator=g, device=self.dev).to(q.dtype)

        def grads():
            leaves = [t.detach().requires_grad_() for t in (q, kp, vp)]
            return torch.autograd.grad(ops.flash_attention(*leaves, **kw), leaves, do)

        want = grads()
        out = []
        for name, load in plants.items():
            lib = load()
            build.library = lambda n, _lib=lib: _lib if n == "flash_attention_bwd" \
                else real_library(n)
            try:
                if name == "mask_only":
                    got = grads()
                    same = all(torch.equal(a, b) for a, b in zip(got, want))
                    out.append((same, "plant 'the backward's mask without k < S_k': the "
                                "ragged tile's zero keys in P change no bit of dq, dk, dv"))
                    del got
                else:
                    verdicts, _ = self.recorded_bwd_verdicts("whisper layer 0, planted", q, kp,
                                                             vp, kw)
                    caught = [what for ok, what in verdicts if not ok]
                    for ok, what in verdicts:
                        print(f"    ragged keys in P: {'passes' if ok else 'FAILS'} {what}")
                    out.append((bool(caught), f"planted fault 'the ragged tile's keys past "
                                f"S_k in P (mask without k < S_k, the tile loaded whole)' "
                                f"fails {len(caught)} of {len(verdicts)} backward checks"))
            finally:
                build.library = real_library
        out.append((build.library is real_library, "lm_train_mm's plants undone"))
        del kp, vp, want, do
        return out

    def state_digest(self, state) -> list[tuple[int, int]]:
        """Each parameter's and moment's bits as integers, summed plainly and
        weighted by position (exact int64 sums on the card): equal lists
        mean equal bits, up to a collision of both sums."""
        torch = self.torch
        out = []
        tensors = (list(state.params.parameters()) + list(state.opt.m.values())
                   + list(state.opt.v.values()))
        with torch.no_grad():
            for t in tensors:
                bits = t.detach().reshape(-1).view(
                    torch.int16 if t.element_size() == 2 else torch.int32).long()
                w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
                out.append((int(bits.sum()), int((bits * w).sum())))
                del bits, w
        return out

    def dense_train_steps(self, name: str) -> dict:
        """make_train_step of one of DENSE_TRAINED at its published widths,
        remat on, B = 1, S = 8,192: a warm-up step and LM_TRAIN_STEPS timed
        (seconds, tokens/s, peak memory, launches a step); for the MoE, the
        state after the warm-up step is reached again from a fresh state of
        the same seed, bit for bit (no atomics in its forward or backward).
        Returns the timed steps' launches."""
        from repro_torch.configs import apply_variant, get_config
        from repro_torch.data.tokens import TokenStream
        from repro_torch.launch.train import init_train_state, make_train_step
        from repro_torch.optim import AdamWConfig

        torch, ops = self.torch, self.ops
        cfg = get_config(name)
        opt = AdamWConfig()
        t0 = time.perf_counter()
        state = init_train_state(cfg, 0, opt)
        self.sync()
        n_params = sum(p.numel() for p in state.params.parameters())
        print(f"{name} train state on the card: {n_params:,} parameters in "
              f"{time.perf_counter() - t0:.2f} s; {torch.cuda.memory_allocated() / 1e9:.2f} GB "
              "allocated")
        step = make_train_step(cfg, opt)
        data = TokenStream(cfg, 1, LM_SEQ, seed=0)
        batches = [data(i) for i in range(LM_TRAIN_STEPS + 1)]
        torch.cuda.reset_peak_memory_stats()
        state, m = step(state, batches[0])                # warm-up
        first = (float(m["loss"]), float(m["grad_norm"]))
        digest = self.state_digest(state) if cfg.is_moe else None
        state, m, times, losses, launches, peak = self.timed_steps(step, state, batches[1:])
        dt = sum(times) / len(times)
        per = {k: v / LM_TRAIN_STEPS for k, v in launches.items() if v}
        print(f"{name} train step at B=1, S={LM_SEQ}, remat on: {dt:.3f} s a step "
              f"({', '.join(f'{t:.3f}' for t in times)}), {LM_SEQ / dt:,.0f} tokens/s, peak "
              f"device memory {peak:.2f} GB; launches a step {per}; losses {first[0]:.5f} "
              f"then {', '.join(f'{x:.5f}' for x in losses)}")
        self.check(launches["flash_attention"] == 2 * cfg.n_layers * LM_TRAIN_STEPS
                   and launches["flash_attention_bwd"] == cfg.n_layers * LM_TRAIN_STEPS
                   and sum(launches.values()) == 3 * cfg.n_layers * LM_TRAIN_STEPS,
                   f"{name}: each step launched the flash forward twice a layer "
                   f"({2 * cfg.n_layers}) and its backward once ({cfg.n_layers}), and no "
                   "other kernel of the port")
        self.check(all(self.np.isfinite(x) for x in losses + list(first)),
                   f"{name}: every step's loss and grad_norm are finite")
        self.check(peak < 80.0, f"{name}: peak device memory {peak:.2f} GB is under 80 GB")
        self.dense_train_numbers = getattr(self, "dense_train_numbers", {})
        self.dense_train_numbers[name] = dict(s=dt, tokens_per_s=LM_SEQ / dt, peak_gb=peak,
                                              launches_a_step=per)
        events = self._profile(lambda: step(state, batches[1]), dt * 1e3,
                               f"{name} train step")
        self.print_split(events, f"{name} train step")
        if not cfg.is_moe:
            self.dense_train_numbers[name].update(self.dots_steps(cfg, opt, state, batches,
                                                                  dt, peak))
        if cfg.is_moe:
            del state, m
            self.sync()
            # under `opt` (the grouped dispatch: at B = 1 one group, the
            # global dispatch's sort and capacity) from a fresh state
            again = init_train_state(cfg, 0, opt)
            again, m = make_train_step(apply_variant(cfg, "opt"), opt)(again, batches[0])
            same = (float(m["loss"]), float(m["grad_norm"])) == first
            self.check(same and self.state_digest(again) == digest,
                       f"{name}: one step under opt (the grouped dispatch, one group at B = 1) "
                       f"from a fresh state of seed 0 reaches the base warm-up step's loss, "
                       f"grad_norm, parameters and AdamW moments bit for bit (loss "
                       f"{float(m['loss']):.6f} against {first[0]:.6f})")
            del again
        return launches

    def cut_train(self, name: str) -> dict:
        """make_train_step of `name` at its published widths and
        CUT_TRAIN_LAYERS[name] layers, bf16, seed 0, remat on, B = 1, S =
        8,192 (qwen2-vl-7b: 1,024 patches and 7,168 tokens with
        TokenStream's positions, as lm_mm's forward): a warm-up step and
        CUT_TRAIN_STEPS[name] timed (the path: launches counted from just
        before to just after), seconds, tokens/s, the measured peak beside
        launch/dryrun.py::lower_cell's modelled one, and the device's idle
        share from a profiled step. A decoder layer runs under the
        checkpoint, so a step launches the flash forward twice a layer and
        its backward once. zamba's shared block stays outside the remat, as
        in the JAX package (only the Mamba2 blocks are recomputed), so a
        step launches the flash forward once an application and its
        backward once. For zamba the warm-up step's flash inputs of each
        application are held through the backward alone
        (`recorded_bwd_verdicts`), and the idle share is read at
        SSM_PROFILE_SEQ, as its forward's: the 8,192-token step runs some
        400,000 kernels, minutes of trace to read back. Returns the timed
        steps' launches."""
        import dataclasses

        from repro_torch.configs import get_config
        from repro_torch.data.tokens import TokenStream
        from repro_torch.launch import dryrun
        from repro_torch.launch.train import init_train_state, make_train_step
        from repro_torch.models import zamba
        from repro_torch.models.api import ShapeSpec
        from repro_torch.optim import AdamWConfig

        torch, ops = self.torch, self.ops
        full = get_config(name)
        cfg = dataclasses.replace(full, n_layers=CUT_TRAIN_LAYERS[name])
        cut = f"{cfg.n_layers} of {full.n_layers} layers"
        hybrid = cfg.family == "hybrid"
        lap = self.lap(f"{name} train")
        modelled = dryrun.lower_cell(cfg, ShapeSpec("train", LM_SEQ, 1, "train"))[0]
        modelled = modelled.peak_bytes / 1e9
        opt = AdamWConfig()
        t0 = time.perf_counter()
        state = init_train_state(cfg, 0, opt)
        self.sync()
        n_params = sum(p.numel() for p in state.params.parameters())
        print(f"{name} at {cut}: train state on the card, {n_params:,} parameters in "
              f"{time.perf_counter() - t0:.2f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB "
              f"allocated; modelled peak of the step {modelled:.2f} GB (lower_cell)")
        n_text = LM_SEQ - cfg.n_patches if cfg.family == "vlm" else LM_SEQ
        data = TokenStream(cfg, 1, n_text, seed=0)
        n_steps = CUT_TRAIN_STEPS[name]
        batches = [data(i) for i in range(n_steps + 1)]
        step = make_train_step(cfg, opt)
        if hybrid:
            n_fwd = n_bwd = zamba.zamba_groups(cfg)[0]
            what = ("the flash forward once an application of the shared block (not "
                    "recomputed) and its backward once")
        else:
            n_fwd, n_bwd = 2 * cfg.n_layers, cfg.n_layers
            what = ("the flash forward twice a layer (forward and recompute) and its "
                    "backward once")
        real, recs = ops.flash_attention, []

        def record(q, k, v, **kw):
            recs.append(tuple(x.detach().clone() for x in (q, k, v)) + (kw,))
            return real(q, k, v, **kw)

        if hybrid:
            ops.flash_attention = record
        try:
            state, m = step(state, batches[0])            # warm-up
        finally:
            ops.flash_attention = real
        first = (float(m["loss"]), float(m["grad_norm"]))
        lap("lower_cell, init and the warm-up step")
        if hybrid:
            qs, ks = ((n, LM_SEQ, cfg.hd) for n in (cfg.n_heads, cfg.n_kv_heads))
            self.check(len(recs) == n_fwd and all(tuple(r[0].shape) == qs
                                                  and tuple(r[1].shape) == ks for r in recs),
                       f"{name}: the warm-up step's {n_fwd} flash launches recorded, q {qs}, "
                       f"k and v {ks} ({len(recs)})")
            for i in range(len(recs)):
                verdicts, _ = self.recorded_bwd_verdicts(
                    f"{name} application {i + 1} of the shared block", *recs[i])
                for ok, text in verdicts:
                    self.check(ok, text)
            recs.clear()
            lap("the backward on each application's inputs")
        state, m, times, losses, launches, peak = self.timed_steps(step, state, batches[1:])
        self.path_launches[f"train_{name}"] = launches
        dt = sum(times) / len(times)
        per = {k: v / n_steps for k, v in launches.items() if v}
        print(f"{name} train step at {cut}, B=1, S={LM_SEQ}, remat on: {dt:.3f} s a step "
              f"({', '.join(f'{x:.3f}' for x in times)}), {LM_SEQ / dt:,.0f} tokens/s, peak "
              f"device memory {peak:.2f} GB (modelled {modelled:.2f} GB, measured / modelled "
              f"{peak / modelled:.3f}); launches a step {per}; losses {first[0]:.5f} then "
              f"{', '.join(f'{x:.5f}' for x in losses)}")
        self.check(launches["flash_attention"] == n_fwd * n_steps
                   and launches["flash_attention_bwd"] == n_bwd * n_steps
                   and sum(launches.values()) == (n_fwd + n_bwd) * n_steps,
                   f"{name} at {cut}: each step launched {what} ({n_fwd} and {n_bwd}), and "
                   f"no other kernel of the port: {per}")
        self.check(all(self.np.isfinite(x) for x in losses + list(first)),
                   f"{name} at {cut}: every step's loss and grad_norm are finite")
        self.check(peak < 80.0, f"{name} at {cut}: peak device memory {peak:.2f} GB is under "
                   f"80 GB (modelled {modelled:.2f} GB)")
        lap("the timed steps")
        pbatch, pseq, wall = batches[1], LM_SEQ, dt
        if hybrid:
            pseq = SSM_PROFILE_SEQ
            pbatch = TokenStream(cfg, 1, pseq, seed=0)(0)
            state, _ = step(state, pbatch)        # the shorter step's warm-up
            self.sync()
            t0 = time.perf_counter()
            state, _ = step(state, pbatch)
            self.sync()
            wall = time.perf_counter() - t0
        events = self._profile(lambda: step(state, pbatch), wall * 1e3,
                               f"{name} train step at S={pseq}", activities=("cuda",))
        self.check(bool(events), f"{name}: the profiled train step holds device time (its "
                   "idle share is measured)")
        busy = sum(e.device_time_total for e in events) / 1e3
        idle = max(0.0, 1 - busy / (wall * 1e3))
        self.print_split(events, f"{name} train step at S={pseq}")
        lap("the profiled step")
        print(f"summary {name} train step at {cut}, B=1, S={LM_SEQ}: {dt:.3f} s "
              f"({LM_SEQ / dt:,.0f} tokens/s), peak {peak:.2f} GB (modelled {modelled:.2f} GB), "
              f"idle share {idle:.3f} at S={pseq}; launches a step {per}")
        self.cut_train_numbers = getattr(self, "cut_train_numbers", {})
        self.cut_train_numbers[name] = dict(layers=cfg.n_layers, s=dt,
                                            tokens_per_s=LM_SEQ / dt, peak_gb=peak,
                                            modelled_gb=modelled, idle=idle,
                                            profiled_seq=pseq, launches_a_step=per)
        del state, step, m
        return launches

    def timed_steps(self, step, state, batches):
        """A train step's path: `step` over `batches`, the state carried,
        each step timed on the host clock to a synchronize; the launch
        counts set to 0 just before and read just after, the peak device
        memory reset before. Returns (state, the last metrics, seconds and
        losses a step, launches, peak GB)."""
        torch, ops = self.torch, self.ops
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()                      # the path starts here
        times, losses = [], []
        for batch in batches:
            self.sync()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            times.append(time.perf_counter() - t0)
        launches = ops.launches()                 # ... and is read here
        return state, m, times, losses, launches, torch.cuda.max_memory_allocated() / 1e9

    def dots_steps(self, cfg, opt, state, batches, dt, peak) -> dict:
        """Two steps of make_train_step under remat policy "dots" (each
        product's output and the flash forward's kept for the backward):
        the second timed, with its peak memory and launches, beside the
        "nothing" steps' (dt, peak): its backward recomputes no flash
        forward, so a step launches it once a layer."""
        import dataclasses

        from repro_torch.launch.train import make_train_step

        torch, ops = self.torch, self.ops
        step = make_train_step(dataclasses.replace(cfg, remat_policy="dots"), opt)
        state, _ = step(state, batches[1])
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        self.sync()
        t0 = time.perf_counter()
        state, m = step(state, batches[2])
        ddt = time.perf_counter() - t0
        n = ops.launches()
        dpeak = torch.cuda.max_memory_allocated() / 1e9
        print(f"{cfg.name} train step under remat_policy \"dots\": {ddt:.3f} s ({LM_SEQ / ddt:,.0f} "
              f"tokens/s), peak {dpeak:.2f} GB, launches {dict((k, v) for k, v in n.items() if v)}"
              f" (\"nothing\": {dt:.3f} s, peak {peak:.2f} GB)")
        self.check(n["flash_attention"] == cfg.n_layers
                   and n["flash_attention_bwd"] == cfg.n_layers
                   and bool(self.np.isfinite(float(m["loss"]))),
                   f"{cfg.name} under \"dots\": a step launches the flash forward once a layer "
                   f"({n['flash_attention']}, \"nothing\" twice) and its backward once "
                   f"({n['flash_attention_bwd']}); the loss is finite")
        return dict(dots_s=ddt, dots_peak_gb=dpeak, dots_launches=n)

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
        bound (5 bf16 tensor passes; the kernels' 11 beside it), its achieved
        bf16 TFLOP/s (of the 11 passes of the split products and of the 13
        the kernels compute), its plain version, the backward
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
            bms = max(tb, FLASH_BWD_PASSES * 2.0 * d * pairs / BF16_TENSOR_FLOPS * 1e3)
            b3 = max(tb, FLASH_BWD_SPLIT3_PASSES * 2.0 * d * pairs / BF16_TENSOR_FLOPS * 1e3)
            b32 = max(tb, FLASH_BWD_PASSES * 2.0 * d * pairs / FP32_FLOPS * 1e3)
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
            # achieved bf16 tensor rate: the 11 passes of the split products,
            # and the 13 the two kernels compute (S and dP in each of them)
            rate = {n: n * 2.0 * d * pairs / (res[50.0] * 1e-3) / 1e12 for n in (11, 13)}
            print(f"    flash_attention_bwd {kind}: {res[50.0]:.3f} ms kernel, {pms:.3f} ms "
                  f"plain, bound {bms:.3f} ms (operations: 5 bf16 tensor passes a visible "
                  f"pair, S, dP, dV, dQ and dK; kernel at {res[50.0] / bms:.1f}x); the "
                  f"kernels' 11 passes, with P and dS split in three, {b3:.3f} ms (kernel "
                  f"at {res[50.0] / b3:.1f}x); achieved {rate[11]:.1f} TFLOP/s of the "
                  f"11-pass work, {rate[13]:.1f} of the 13 passes computed, against "
                  f"{BF16_TENSOR_FLOPS / 1e12:.0f}; the same 5 products on the fp32 pipes "
                  f"{b32:.3f} ms (kernel at {res[50.0] / b32:.2f}x); flex_attention's "
                  f"backward {lib:.3f} ms; softcap 0: {res[0.0]:.3f} ms kernel, "
                  f"{lib0:.3f} ms scaled_dot_product_attention's backward")
            per[kind] = dict(ms=res[50.0], plain=pms, bound=bms, b3=b3, b32=b32, ms0=res[0.0],
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
                            f"k/v (4, {LM_SEQ}, 256) bf16, causal, softcap 50; bound: 5 "
                            "bf16 tensor passes a visible pair",
                     replaces_note="the Pallas kernel has no backward: the JAX package "
                                   "differentiates its chunked scan, "
                                   "src/repro/models/layers.py:364",
                     bound_ms_split3=total("b3"),
                     bound_ms_fp32_pipes=total("b32"),
                     local_ms=per["local"]["ms"], global_ms=per["global"]["ms"],
                     tflops_11_passes={k: per[k]["tflops11"] for k in per},
                     tflops_13_passes={k: per[k]["tflops13"] for k in per},
                     softcap0_ms=total("ms0"), softcap0_library_ms=total("lib0"),
                     softcap0_library="scaled_dot_product_attention's backward, "
                                      "enable_gqa, the same causal and window mask",
                     dense_shapes=self.dense_rows("bwd") if hasattr(self, "dense_flash")
                     else {}, cut_train_shapes=getattr(self, "bwd_shapes", {}))

    def compress_check(self):
        """optim.compressed_psum over 4 shards' gradient trees on the card,
        two rounds carrying the error, against the same on the CPU: the
        sums and residuals equal bit for bit."""
        from repro_torch.optim import compress_init, compressed_psum

        torch = self.torch
        shapes = {"w": (2048, 1024), "b": (1024,), "e": (50_000, 64)}
        g = torch.Generator().manual_seed(5)
        rounds = [[{n: torch.randn(shp, generator=g) * (1e-3 if n == "b" else 1.0)
                    for n, shp in shapes.items()} for _ in range(4)] for _ in range(2)]
        out = {}
        for where in ("cuda", "cpu"):
            zero = {n: torch.zeros(shp, device=where) for n, shp in shapes.items()}
            states = [compress_init(zero) for _ in range(4)]
            sums = []
            for trees in rounds:
                s, states = compressed_psum([{n: t.to(where) for n, t in tr.items()}
                                             for tr in trees], states)
                sums.append(s[0])
            out[where] = (sums, states)
        same = all(torch.equal(a[n].cpu(), b[n]) for a, b in zip(out["cuda"][0], out["cpu"][0])
                   for n in shapes)
        same &= all(torch.equal(a.error[n].cpu(), b.error[n])
                    for a, b in zip(out["cuda"][1], out["cpu"][1]) for n in shapes)
        self.check(same, "compressed_psum over 4 shards, two rounds with error feedback: the "
                   "card's sums and residuals equal the CPU's bit for bit")

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
        train_4k shape's length, the direct path), under remat policies
        "nothing" and "attn_probs"."""
        import dataclasses
        import gc

        from repro_torch.data.tokens import TokenStream
        from repro_torch.launch.train import init_train_state, make_train_step
        from repro_torch.models.api import ShapeSpec, model_flops_per_step
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
        state, m, times, losses, launches, peak = self.timed_steps(step, state, batches[1:])
        self.path_launches["lm_train"] = launches
        self.main_launches["flash_attention_bwd"] = launches["flash_attention_bwd"]
        dt = sum(times) / len(times)
        per = {k: v / LM_TRAIN_STEPS for k, v in launches.items() if v}
        # the model FLOPs of a step: the JAX package's definition,
        # models/api.py::model_flops_per_step (6 N_active tokens), and beside
        # it the same with attention's scores and P V (the function's 6 D
        # products a visible pair a head: 2 forward, 4 backward)
        model_flops = model_flops_per_step(cfg, ShapeSpec("lm_train", LM_SEQ, 1, "train"))
        attn = 12.0 * cfg.hd * cfg.n_heads * (cfg.n_layers // 2) * (
            visible_pairs(LM_SEQ, cfg.sliding_window) + visible_pairs(LM_SEQ, 0))
        share = model_flops / (dt * BF16_TENSOR_FLOPS)
        share_attn = (model_flops + attn) / (dt * BF16_TENSOR_FLOPS)
        print(f"train step at B=1, S={LM_SEQ}, remat on: {dt:.3f} s a step "
              f"({', '.join(f'{t:.3f}' for t in times)}), {LM_SEQ / dt:,.0f} tokens/s, "
              f"peak device memory {peak:.2f} GB (warm-up step {warm_peak:.2f} GB), "
              f"model FLOPs share of {BF16_TENSOR_FLOPS / 1e12:.0f} TFLOP/s: {share:.3f} by "
              f"model_flops_per_step (the JAX definition, 6 N_active tokens = "
              f"{model_flops / 1e12:.1f} TFLOP a step), {share_attn:.3f} with attention "
              f"({(model_flops + attn) / 1e12:.1f} TFLOP, attention {attn / 1e12:.1f}); "
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
                                     share=share, share_attn=share_attn)

        events = self._profile(lambda: step(state, batches[1]), dt * 1e3, "train step")
        self.print_split(events, "train step")
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
        peak4 = torch.cuda.max_memory_allocated() / 1e9
        # remat policy "attn_probs": each layer keeps its bf16 probabilities
        # (8 x 4,096^2 x 2 bytes = 268 MB) for the backward
        probs_step = make_train_step(dataclasses.replace(cfg, remat_policy="attn_probs"), opt)
        torch.cuda.reset_peak_memory_stats()
        self.sync()
        t0 = time.perf_counter()
        state, m = probs_step(state, short)
        dtp = time.perf_counter() - t0
        peakp = torch.cuda.max_memory_allocated() / 1e9
        kept = cfg.n_layers * cfg.n_heads * LM_TRAIN_SHORT ** 2 * 2 / 1e9
        print(f"train step at B=1, S={LM_TRAIN_SHORT} under remat_policy \"attn_probs\": "
              f"{dtp:.3f} s, peak {peakp:.2f} GB (\"nothing\": {dt4:.3f} s, peak "
              f"{peak4:.2f} GB; the probabilities kept come to {kept:.2f} GB)")
        self.check(bool(self.np.isfinite(float(m["loss"]))) and peakp > peak4,
                   f"the S = {LM_TRAIN_SHORT} step under \"attn_probs\" keeps more than "
                   f"\"nothing\" ({peakp:.2f} GB against {peak4:.2f} GB peak) and its loss is "
                   "finite")
        self.lm_train_numbers.update(short_s=dt4, short_peak_gb=peak4, attn_probs_s=dtp,
                                     attn_probs_peak_gb=peakp)
        del state, step, probs_step, m
        gc.collect()

    @staticmethod
    def split_kind(key: str) -> str:
        """The kind of a CUDA kernel, by its name in a profile."""
        for part, name in (("flash_mma_kernel", "flash forward"),
                           ("flash_bwd_dkdv", "flash backward dk dv"),
                           ("flash_bwd_dq", "flash backward dq"),
                           ("flash_bwd_delta", "flash backward delta"),
                           ("simt_sgemm", "fp32 products (the head's backward)"),
                           ("nvjet", "bf16 products"), ("gemm", "other products"),
                           ("elementwise", "elementwise"), ("reduce", "reductions"),
                           ("adix", "sorts"), ("ort", "sorts"), ("index", "index passes"),
                           ("gather", "index passes"), ("catter", "index passes")):
            if part in key:
                return name
        return "other"

    def print_split(self, events, what: str) -> dict:
        """A profile's device time by kernel kind, printed as `what split:`
        lines; returns {kind: (ms, launches)}."""
        groups: dict[str, list] = {}
        for e in events:
            g = groups.setdefault(self.split_kind(e.key), [0.0, 0])
            g[0] += e.device_time_total / 1e3
            g[1] += e.count
        busy = sum(g[0] for g in groups.values())
        for name, (ms, count) in sorted(groups.items(), key=lambda x: -x[1][0]):
            print(f"  {what} split: {name:36s} {ms:9.2f} ms  x{count:<6d} "
                  f"({ms / busy:.3f} of device busy)")
        return {name: tuple(g) for name, g in groups.items()}

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

    # ------------------------------------------------------------ the mesh
    def mesh(self):
        """Phase mesh (the module docstring): the flash pair with a query
        offset, gemma2-2b's train step on the host mesh, elastic restore
        onto it, the recurrent and audio families' decode on it, and the
        mesh dry-run in a subprocess."""
        import logging

        import repro_torch

        t_phase = time.perf_counter()
        # DTensor warns at each redistribution over two mesh axes at once
        logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
        env = dict(os.environ, PYTHONPATH=str(Path(repro_torch.__file__).parents[1]),
                   OMP_NUM_THREADS="1")
        proc = subprocess.Popen(
            [sys.executable, "-c", MESH_DRYRUN_SCRIPT, json.dumps(MESH_CELLS)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            self.mesh_flash_offsets()
            self.mesh_train_step()
            self.mesh_restore()
            self.mesh_decode()
            out, err = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            from repro_torch.launch.mesh import close_host_group

            close_host_group()
        recs = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
        print(f"(d) the mesh dry-run in a subprocess (a fake world of 256 or 512 ranks on the "
              f"meta device; counts of the last rank, modelled, not measured):")
        for rec in recs:
            print("  " + rec["line"])
        if proc.returncode or len(recs) != len(MESH_CELLS):
            print(err[-4000:])
        self.check(proc.returncode == 0 and len(recs) == len(MESH_CELLS)
                   and all(r["ok"] for r in recs),
                   f"the {len(MESH_CELLS)} mesh dry-run cells end ok")
        for rec in recs:
            if rec["ok"]:
                print(f"  {rec['arch']} {rec['shape']} {rec['variant']} on {rec['mesh']}: "
                      f"per-device peak {rec['peak_bytes'] / 1e9:.2f} GB, fits 80 GB: "
                      f"{rec['fits']}; {rec['flops'] / 1e12:.2f} TFLOP and "
                      f"{rec['collective_total_bytes'] / 1e9:.2f} GB of collectives a device "
                      f"{rec['collective_counts']}, useful flops ratio "
                      f"{rec['useful_flops_ratio']:.3f}")
        took = time.perf_counter() - t_phase
        self.check(took <= MESH_BUDGET_S,
                   f"phase mesh took {took:.1f} s of host time (at most {MESH_BUDGET_S:g})")

    def mesh_flash_offsets(self):
        """(a) The flash pair over MESH_SHARDS query shards at their offsets
        against the plain versions and against the whole launch."""
        torch, ops, ref = self.torch, self.ops, self.ref
        g = torch.Generator(device=self.dev).manual_seed(MESH_SHARDS)
        cases = (("gemma2-2b local layer", 8, 4, LM_SEQ, LM_SEQ, 256,
                  dict(causal=True, window=4096, softcap=50.0)),
                 ("whisper-medium cross-attention", 16, 16, LM_SEQ, MESH_FRAMES, 64,
                  dict(causal=False, window=0, softcap=0.0)))
        for tag, bh, bhk, sq, sk, d, kw in cases:
            q = torch.randn(bh, sq, d, generator=g, device=self.dev).to(torch.bfloat16)
            k, v = (torch.randn(bhk, sk, d, generator=g, device=self.dev).to(torch.bfloat16)
                    for _ in range(2))
            do = torch.randn(q.shape, generator=g, device=self.dev).to(torch.bfloat16)

            def grads(qq, off):
                leaves = [t.detach().requires_grad_() for t in (qq, k, v)]
                o = ops.flash_attention(*leaves, q_offset=off, **kw)
                lo = off
                return (o,) + torch.autograd.grad(o, leaves, do[:, lo:lo + qq.shape[1]])

            whole = grads(q, 0)
            n = sq // MESH_SHARDS
            outs, dqs, dk, dv, worst, fwd_err = [], [], 0.0, 0.0, 0.0, 0.0
            for i in range(MESH_SHARDS):
                part = q[:, i * n:(i + 1) * n].contiguous()
                o, gq, gk, gv = grads(part, i * n)
                want = ref.flash_attention_ref(part, k, v, q_offset=i * n, **kw)
                ok, _, e = self.verdict(o.float(), want.float(), "", FLASH_TOL["bf16"])
                ok2, _, _ = self.verdict(o.float(), want.float(), "", FLASH_BF16_ULP_TOL)
                fwd_err = max(fwd_err, e)
                self.check(ok and ok2, f"flash forward, {tag}, shard {i} at offset {i * n}: "
                           f"within {FLASH_TOL['bf16']} and {FLASH_BF16_ULP_TOL} of its plain "
                           f"version (max abs err {e:.3e})")
                exact = self.bwd_exact(part, k, v, do[:, i * n:(i + 1) * n].contiguous(),
                                       dict(kw, q_offset=i * n))
                for gr, w in zip((gq, gk, gv), exact):
                    worst = max(worst, self.grad_errors(gr, w)[0])
                del exact
                outs.append(o.detach())
                dqs.append(gq)
                dk, dv = dk + gk.double(), dv + gv.double()
            self.check(worst <= 1.0, f"flash backward, {tag}: every shard's dq, dk and dv "
                       f"within one bf16 ulp of each head's largest magnitude of float64 at "
                       f"its offset (worst err / ulp {worst:.3f})")
            self.check(torch.equal(torch.cat(outs, 1), whole[0].detach())
                       and torch.equal(torch.cat(dqs, 1), whole[1]),
                       f"{tag}: the {MESH_SHARDS} shards' rows and dQ joined are the whole "
                       f"launch's bit for bit (offsets of {n} rows, a multiple of the query "
                       f"blocks)")
            joined = max(self.grad_errors(s_.to(torch.bfloat16), w.double())[0]
                         for s_, w in ((dk, whole[2]), (dv, whole[3])))
            self.check(joined <= 1.0, f"{tag}: dK and dV summed over the shards within one "
                       f"bf16 ulp of the whole launch's (worst err / ulp {joined:.3f})")
            fwd = [self.cuda_ms(lambda: ops.flash_attention(q, k, v, **kw))]
            fwd.append(sum(self.cuda_ms(lambda i=i: ops.flash_attention(
                q[:, i * n:(i + 1) * n], k, v, q_offset=i * n, **kw), reps=3)
                for i in range(MESH_SHARDS)))
            last = self.cuda_ms(lambda: ops.flash_attention(
                q[:, sq - n:], k, v, q_offset=sq - n, **kw), reps=3)
            print(f"(a) {tag} ({bh}, {sq} x {sk}, {d}): forward {fwd[0]:.3f} ms whole, "
                  f"{fwd[1]:.3f} ms over {MESH_SHARDS} shards at their offsets, the last "
                  f"shard (the busiest rank's) {last:.3f} ms; forward max abs err to plain "
                  f"{fwd_err:.3e}")
            key = "flash_attention_offset_ms"
            if "flash_attention" in self.rows:
                self.rows["flash_attention"].setdefault(key, {})[tag] = dict(
                    whole_ms=fwd[0], shards_ms=fwd[1], last_shard_ms=last, shards=MESH_SHARDS)
            del q, k, v, do, whole, outs, dqs, dk, dv

    def mesh_train_step(self):
        """(b) gemma2-2b's full-width train step on the host mesh against
        the same step without one, bit for bit."""
        import gc

        from repro_torch.configs import get_config
        from repro_torch.data.tokens import TokenStream
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.launch.train import init_train_state, make_train_step, shard_batch, \
            shard_state
        from repro_torch.models.api import ShapeSpec, input_pspecs
        from repro_torch.optim import AdamWConfig

        torch, ops = self.torch, self.ops
        cfg = get_config("gemma2-2b")
        opt = AdamWConfig()
        step = make_train_step(cfg, opt)
        batch = TokenStream(cfg, 1, LM_SEQ, seed=0)(0)
        state = init_train_state(cfg, 0, opt)
        state, m = step(state, batch)
        want_loss = float(m["loss"])
        want = {n: p.detach().clone() for n, p in state.params.named_parameters()}
        del state, m
        gc.collect()
        torch.cuda.empty_cache()
        mesh = make_host_mesh()
        print(f"(b) the host mesh: {mesh} over an NCCL group of "
              f"{torch.distributed.get_world_size()} rank")
        state = shard_state(cfg, init_train_state(cfg, 0, opt), mesh)
        dbatch = shard_batch({k: torch.as_tensor(v, device=self.dev) for k, v in batch.items()},
                             input_pspecs(cfg, ShapeSpec("mesh", LM_SEQ, 1, "train"), mesh),
                             mesh)
        torch.cuda.reset_peak_memory_stats()
        self.sync()
        t0 = time.perf_counter()
        ops.reset_launches()                      # the mesh path starts here
        state, m = step(state, dbatch)
        launches = ops.launches()                 # ... and is read here
        self.sync()
        dt = time.perf_counter() - t0
        self.path_launches["mesh"] = launches
        loss = float(m["loss"].full_tensor())
        same = all(torch.equal(p.full_tensor(), want[n])
                   for n, p in state.params.named_parameters())
        kinds = {type(p).__name__ for p in state.params.parameters()} | {
            type(t).__name__ for t in state.opt.m.values()}
        print(f"(b) gemma2-2b's train step on the host mesh, B=1, S={LM_SEQ}, remat on: "
              f"{dt:.3f} s, peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
              f"loss {loss:.6f} (without a mesh {want_loss:.6f}), launches {launches}; "
              f"state tensors {sorted(kinds)}")
        self.check(kinds == {"DTensor"}, "the mesh step's parameters and moments are DTensors")
        self.check(loss == want_loss and same,
                   "the step on the host mesh gives the mesh-free step's loss and updated "
                   "parameters bit for bit")
        self.check(launches["flash_attention"] == 2 * cfg.n_layers
                   and launches["flash_attention_bwd"] == cfg.n_layers,
                   f"the mesh step launched the flash forward twice a layer and its backward "
                   f"once ({launches['flash_attention']}, {launches['flash_attention_bwd']})")
        del state, m, want
        gc.collect()
        torch.cuda.empty_cache()

    def mesh_restore(self):
        """(c) A checkpoint of the mesh-free Trainer resumed onto the host
        mesh by a Trainer with state_shardings: its next step is the live
        state's bit for bit."""
        from repro_torch.configs import get_config, reduced
        from repro_torch.data.tokens import TokenStream
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.launch.train import init_train_state, make_train_step, state_shardings
        from repro_torch.models.api import ShapeSpec, input_pspecs
        from repro_torch.optim import AdamWConfig
        from repro_torch.runtime import Trainer, TrainerConfig

        torch = self.torch
        cfg = reduced(get_config("gemma2-2b"))
        opt = AdamWConfig(lr=1e-3)
        step = make_train_step(cfg, opt, total_steps=100)
        data = TokenStream(cfg, 2, 256, seed=0)
        root = str(Path(self.tmp.name) / "mesh_ckpt")
        live = Trainer(step, init_train_state(cfg, 0, opt), data,
                       TrainerConfig(ckpt_dir=root, ckpt_every=3, use_async_ckpt=False))
        live.run(3, log_every=100)                # checkpoints at 0 and 3
        live.state, m_live = step(live.state, {k: torch.as_tensor(v, device=self.dev)
                                               for k, v in data(3).items()})
        mesh = make_host_mesh()
        sh = state_shardings(cfg, init_train_state(cfg, 0, opt, device="meta"), mesh,
                             input_pspecs(cfg, ShapeSpec("mesh", 256, 2, "train"), mesh))
        resumed = Trainer(step, init_train_state(cfg, 0, opt, device="meta"), data,
                          TrainerConfig(ckpt_dir=root, ckpt_every=100, use_async_ckpt=False),
                          state_shardings=sh)
        at = resumed.step
        out = resumed.run(1, log_every=100)
        same = all(torch.equal(p.full_tensor(), q) for p, q in zip(
            resumed.state.params.parameters(), live.state.params.parameters()))
        print(f"(c) the reduced gemma2-2b Trainer's step-{at} checkpoint restored onto "
              f"{mesh}: next loss {out['loss_history'][0]:.6f}, the live state's "
              f"{float(m_live['loss']):.6f}")
        self.check(at == 3 and out["loss_history"][0] == float(m_live["loss"]) and same,
                   "the state restored onto the host mesh (restore_resharded) takes the live "
                   "state's next step bit for bit: its loss and parameters")

    def mesh_decode(self):
        """(e) Decode on the host mesh at full width against decode without
        it, bit for bit, for the xLSTM, Zamba2 and whisper."""
        import gc
        import statistics

        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.launch.train import shard_module, shardings_of
        from repro_torch.models import api
        from repro_torch.models.layers import active_mesh, distribute

        torch = self.torch
        mesh = make_host_mesh()
        b, s, n = MESH_DECODE_BATCH, MESH_DECODE_PROMPT, MESH_DECODE_STEPS

        def whole(t):
            return t.full_tensor() if hasattr(t, "full_tensor") else t

        def leaves(tree):
            if isinstance(tree, dict):
                return [x for k in sorted(tree) for x in leaves(tree[k])]
            if isinstance(tree, (tuple, list)):
                return [x for v in tree for x in leaves(v)]
            return [whole(tree)]

        def bits(t):
            return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

        for arch in MESH_DECODE_ARCHS:
            cfg = get_config(arch)
            model = api.build_model(cfg)
            params = model.init(0)
            g = torch.Generator(device=self.dev).manual_seed(MESH_DECODE_STEPS)
            batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                                             device=self.dev, dtype=torch.int32)}
            if cfg.family == "audio":
                batch["frames"] = torch.randn(b, cfg.encoder_seq, cfg.d_model, generator=g,
                                              device=self.dev)

            def run(placed):
                """Prefill, then n greedy steps, the inputs through `placed`:
                (logits, cache, the median seconds of a step after the
                first, which warms the path up)."""
                out = model.prefill_fn(params, placed(batch, "prefill"))
                logits, cache = [whole(out["logits"])], out["cache"]
                secs = []
                for _ in range(n):
                    self.sync()
                    t0 = time.perf_counter()
                    nxt = logits[-1].argmax(-1, keepdim=True).to(torch.int32)
                    cache, lg = model.decode_fn(params, cache, placed({"tokens": nxt}, "decode"))
                    logits.append(whole(lg))
                    self.sync()
                    secs.append(time.perf_counter() - t0)
                return logits, cache, statistics.median(secs[1:])

            with torch.no_grad():
                free, free_cache, free_s = run(lambda x, kind: x)
                free_cache = [t.clone() for t in leaves(free_cache)]
                shard_module(params, shardings_of(api.param_pspecs(cfg, params, mesh), mesh),
                             mesh)
                with active_mesh(mesh):
                    def placed(x, kind):
                        ips = api.input_pspecs(cfg, api.ShapeSpec("mesh", s, b, kind), mesh)
                        return {k: distribute(v, ips[k]) for k, v in x.items()}

                    got, cache, mesh_s = run(placed)
                    zeros = model.init_cache(b, s + 64)
                    first = placed({"tokens": free[0].argmax(-1, keepdim=True).to(torch.int32)},
                                   "decode")
                    zero = whole(model.decode_fn(params, zeros, first)[1])
            same = all(torch.equal(x, y) for x, y in zip(got, free))
            same_cache = len(leaves(cache)) == len(free_cache) and all(
                torch.equal(bits(x), bits(y)) for x, y in zip(leaves(cache), free_cache))
            off = float((zero.float() - free[1].float()).abs().max())
            print(f"(e) {arch} decode on the host mesh, B = {b}, a {s}-token prefill "
                  f"{'over ' + str(cfg.encoder_seq) + ' frames ' if cfg.family == 'audio' else ''}"
                  f"and {n} greedy steps: {b / mesh_s:.2f} tokens/s on the mesh, "
                  f"{b / free_s:.2f} off it (the median step after a warm-up one); a step "
                  f"from zero states is {off:.3e} off")
            self.check(same and same_cache,
                       f"{arch}: the prefill's and the {n} steps' logits on the host mesh and "
                       f"the final states and caches ({len(free_cache)} leaves) are the "
                       f"mesh-free ones bit for bit")
            self.check(off > 1e-2, f"{arch}: a step on the mesh from zero states differs "
                       f"from the step after the prefill ({off:.3e} > 1e-2): the step reads "
                       f"its states")
            del params, free, free_cache, got, cache, zeros, zero
            gc.collect()
            torch.cuda.empty_cache()

    def dryrun(self):
        """Phase dryrun (the module docstring): the meta sweep of every
        cell, then three cells counted on the meta device and run on the
        card."""
        import dataclasses

        from repro_torch.configs import REGISTRY, reduced
        from repro_torch.launch import bpmf_dryrun, dryrun
        from repro_torch.models.api import ShapeSpec

        t_phase = time.perf_counter()
        cells = dryrun.all_cells()
        out, (sampler, info) = dryrun.sweep(
            cells, jobs=DRYRUN_JOBS, save=False,
            meanwhile=lambda: bpmf_dryrun.real_sampler("ml20m", "ring", DIST_SHARDS, K, "fused"))
        recs = {(r["arch"], r["shape"]): r for r in out}
        sweep_s = time.perf_counter() - t_phase
        print(f"(a) the meta sweep: {len(recs)} cells in {sweep_s:.1f} s of host "
              f"({DRYRUN_JOBS} processes; the longest cell "
              f"{max(r['total_s'] for r in recs.values()):.1f} s); meanwhile ml20m "
              f"{info['m']:,} x {info['n']:,}, {info['nnz']:,} ratings in "
              f"{info['data_s']:.1f} s and its grid plans (P = {DIST_SHARDS}: widths "
              f"{info['width_u']} and {info['width_v']}, {info['rows_u']:,} and "
              f"{info['rows_v']:,} rows a block) in {info['plan_s']:.1f} s")
        for cell in cells:
            print("  " + dryrun.summary_line(recs[cell]))
        bad = [c for c in cells if not recs[c]["ok"]]
        for c in bad:
            print(recs[c]["traceback"])
        self.check(not bad and len(recs) == len(cells),
                   f"every cell of all_cells() ({len(cells)}, kimi-k2-1t-a32b's included) "
                   f"ends ok on the meta device{'; failed: ' + str(bad) if bad else ''}")
        self.check(all(not r["launches"] for r in recs.values()),
                   "the meta sweep launched no kernel of the port")
        # the loops the counter cuts (`cost.steps`) against the same loops
        # run whole, on this torch, at a small size
        for arch, chunk in (("xlstm-350m", None), ("zamba2-7b", 32)):
            cfg = dataclasses.replace(reduced(REGISTRY[arch]), remat=True,
                                      ssm_chunk=chunk or REGISTRY[arch].ssm_chunk)
            cut, full = dryrun.cut_and_full(cfg, ShapeSpec("train", 256, 1, "train"))
            reps = cut.pop("repeated_ops")
            full.pop("repeated_ops")
            self.check(cut == full and reps > 0,
                       f"reduced {arch}'s train step at S = 256, remat on: the cut loops "
                       f"({reps:,} op calls counted as repeats) count what the full loops "
                       f"count: {cut} against {full}")
        over = [f"{a} {s}" for (a, s), r in sorted(recs.items())
                if r["ok"] and not r["fits_one_card"]]
        print(f"  does not fit one 80 GB card (a finding): {len(over)} of {len(cells)} "
              f"cells: {', '.join(over)}")

        self.dryrun_lm("gemma2-2b", "forward")
        self.dryrun_lm("stablelm-1.6b", "train")
        self.dryrun_bpmf(sampler, info)
        del sampler
        total = time.perf_counter() - t_phase
        print(f"phase dryrun: {total:.1f} s of host (budget {DRYRUN_BUDGET_S:.0f} s)")
        self.check(total <= DRYRUN_BUDGET_S,
                   f"phase dryrun took {total:.1f} s, within {DRYRUN_BUDGET_S:.0f} s")

    def dryrun_compare(self, what: str, rec: dict, busy_ms: float, measured_peak: int,
                       max_alloc: int) -> None:
        """A measured cell beside its count on the meta device: the busy
        time against compute_s, the modelled peak against the measured."""
        r = rec["roofline"]
        model_peak = rec["memory"]["peak_bytes"]
        print(f"  {what}: measured {busy_ms:.2f} ms device busy; modelled compute_s "
              f"{r['compute_s'] * 1e3:.3f} ms (all products at the bf16 peak; "
              f"{rec['compute_s_by_pipe'] * 1e3:.3f} ms with fp32 products on the fp32 "
              f"pipes), memory_s {r['memory_s'] * 1e3:.3f} ms, step_lower_bound_s "
              f"{r['step_lower_bound_s'] * 1e3:.3f} ms ({r['dominant']}); "
              f"{rec['flops'] / 1e12:.3f} TFLOP, {rec['hbm_bytes'] / 1e9:.2f} GB moved; "
              f"peak modelled {model_peak / 1e9:.3f} GB, measured {measured_peak / 1e9:.3f} "
              f"GB (torch.cuda.max_memory_allocated {max_alloc / 1e9:.3f} GB, less what "
              f"was allocated before the call and is not the cell's)")
        self.check(busy_ms / 1e3 >= r["compute_s"] and busy_ms / 1e3 >= rec["compute_s_by_pipe"],
                   f"{what}: the measured busy time ({busy_ms:.2f} ms) is at least the "
                   f"modelled compute_s ({r['compute_s'] * 1e3:.3f} ms; by pipe "
                   f"{rec['compute_s_by_pipe'] * 1e3:.3f} ms)")
        gap = abs(model_peak - measured_peak) / measured_peak
        self.check(gap <= DRYRUN_PEAK_RTOL,
                   f"{what}: the modelled peak is within {DRYRUN_PEAK_RTOL:.0%} of the "
                   f"measured one ({gap:.3f})")

    def dryrun_lm(self, arch: str, kind: str) -> None:
        """One LM cell at B = 1, S = LM_SEQ: counted on the meta device, then
        run on the card once to warm up, once timed (launches, peak) and
        once profiled."""
        import gc

        from repro_torch.configs import get_config
        from repro_torch.data.tokens import TokenStream
        from repro_torch.launch import dryrun
        from repro_torch.launch.train import adamw_config, init_train_state, make_train_step
        from repro_torch.models import build_model
        from repro_torch.models.api import ShapeSpec

        torch, ops = self.torch, self.ops
        cfg = get_config(arch)
        shape = ShapeSpec(f"{kind}_{LM_SEQ}", LM_SEQ, 1, kind)
        t0 = time.perf_counter()
        counter, out_bytes = dryrun.lower_cell(cfg, shape)
        rec = dryrun.cell_record(cfg, shape, counter, out_bytes)
        meta_s = time.perf_counter() - t0
        batch = TokenStream(cfg, 1, LM_SEQ, seed=0)(0)
        gc.collect()
        torch.cuda.empty_cache()
        if kind == "train":
            state = init_train_state(cfg, 0, adamw_config(cfg))
            step = make_train_step(cfg, adamw_config(cfg))
            args = dryrun.tensors_of(state)

            def call():
                return step(state, batch)
        else:
            model = build_model(cfg)
            params = model.init(seed=0)
            args = dryrun.tensors_of(params)

            def call():
                with torch.no_grad():
                    return model.loss_fn(params, batch)
        call()                                    # warm-up
        self.sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        call()
        self.sync()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in ops.launches().items() if v}
        max_alloc = torch.cuda.max_memory_allocated()
        measured = max_alloc - base + dryrun.storage_bytes(args)
        events = self._profile(call, wall * 1e3, f"{arch} {kind}")
        busy = sum(e.device_time_total for e in events) / 1e3
        print(f"(b) {arch} {kind} at B=1, S={LM_SEQ}: {wall:.3f} s on the card, launches "
              f"{launches}; the meta pass {meta_s:.1f} s ({rec['ops']:,} ops, "
              f"{rec['repeated_ops']:,} of them repeats of a loop's iteration); model "
              f"FLOPs {rec['model_flops'] / 1e12:.2f} TFLOP, {rec['useful_flops_ratio']:.3f} "
              f"of the counted")
        want = ({"flash_attention": 2 * cfg.n_layers, "flash_attention_bwd": cfg.n_layers}
                if kind == "train" else {"flash_attention": cfg.n_layers})
        self.check(launches == want, f"{arch} {kind}: the kernels launched {launches} "
                   f"(want {want})")
        if events:
            self.dryrun_compare(f"{arch} {kind}", rec, busy, measured, max_alloc)
        else:
            self.check(False, f"{arch} {kind}: the profile holds device time")
        del call, args
        gc.collect()
        torch.cuda.empty_cache()

    def dryrun_bpmf(self, sampler, info: dict) -> None:
        """The ml20m ring sweep at K = 64 over P = 4 shards on the card
        (`bpmf_dryrun.measure`: counted at the real plans' shapes, a warm-up
        sweep, a timed one, a profiled one)."""
        from repro_torch.launch import bpmf_dryrun

        rec = bpmf_dryrun.measure("ml20m", "ring", DIST_SHARDS, K, "fused",
                                  sampler=sampler, info=info)
        print(f"(b) ml20m ring sweep, K = {K}, P = {DIST_SHARDS} on the card, engine fused: "
              f"{rec['sweep_s']:.4f} s, launches {rec['launches']}, the meta pass "
              f"{rec['meta_s']:.1f} s; model FLOPs {rec['model_flops'] / 1e12:.3f} TFLOP, "
              f"{rec['useful_flops_ratio']:.3f} of the counted; exchange "
              f"{rec['exchange_bytes'] / 1e9:.3f} GB")
        self.check(rec["launches"].get("gather_syrk_seg", 0) == 2 * DIST_SHARDS ** 2
                   and set(rec["launches"]) == {"gather_syrk_seg"},
                   f"the ml20m ring sweep launched gather_syrk_seg {2 * DIST_SHARDS ** 2} "
                   f"times (a block a shard a step, both phases) and no other kernel: "
                   f"{rec['launches']}")
        self.dryrun_compare("ml20m ring sweep", rec, rec["busy_ms"], rec["measured_peak_bytes"],
                            rec["max_memory_allocated"])

    def lm_faults(self):
        """Faults planted in the LM path, one at a time, each run through the
        checks of lm_eval or lm_serve: at least one of them must fail. The
        plants patch the module attributes the model calls and are undone
        before the next; the flash plants act in the bf16 instantiation
        only, the one the forward launches, so that the fp32 checks cannot
        be what catches them, but for the fp32 backward's column layout at
        D = 112, which zamba2-7b's fp32 backward check must catch."""
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
        # the fp32 backward with the column layout it had before D = 112
        # (D / 32 columns a lane: columns 96-111 never summed or written),
        # compiled while the plants below run
        cols96 = self.planted_library("flash_attention_bwd", [(BWD_LAYOUT_NOW, BWD_LAYOUT_96)],
                                      "bwd_96_columns", wait=False)
        # P and dS taken in one bf16 term: the MMAs of x2 and x3 dropped
        # from add_product
        try:
            one_term = self.planted_library(
                "flash_attention_bwd",
                [(f"      mma_bf16({half.format(x)});\n", "") for x in ("x2", "x3")
                 for half in ("acc[2 * dp], {}[kk], b[0], b[1]",
                              "acc[2 * dp + 1], {}[kk], b[2], b[3]")],
                "one_term")
            lib96 = cols96()
        finally:
            cols96.stop()

        def library_plant(lib):
            def planted(name):
                return lib if name == "flash_attention_bwd" else real_library(name)
            return planted

        from repro_torch.models import transformer as tfm

        real_combine, real_route, real_ln = layers.moe_combine, layers.moe_route, tfm.layer_norm
        for what in ("moe", "norm"):              # the checks hold at this depth
            verdicts = self.dense_fault_verdicts(what)
            self.check(all(ok for ok, _ in verdicts),
                       f"lm_dense's {what} checks pass at {DENSE_FAULT_DEPTH} layers with no "
                       f"plant ({sum(ok for ok, _ in verdicts)} of {len(verdicts)})")
        plants = self.dense_plants() + [
                  ("flash, bf16: softcap dropped", ops, "flash_attention",
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
                   "library", library_plant(one_term), "backward"),
                  ("backward, fp32 at D = 112: lanes over 96 of 112 columns (D / 32 a lane)",
                   build, "library", library_plant(lib96), "backward d112")]
        # zamba2-7b's fp32 backward check on inputs of another seed than
        # lm_kernels' (whose right outputs may still lie in the memory the
        # plant's outputs take)
        d112 = BWD_SHAPES[1]
        assert d112[3:] == (112, "fp32")
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
                elif checks == "backward d112":
                    verdicts = self.bwd_shape_verdicts(*d112, BWD_SHAPE_SEED + 1)[0]
                elif checks in ("moe", "norm"):
                    verdicts = self.dense_fault_verdicts(checks)
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
        verdicts = self.bwd_shape_verdicts(*d112, BWD_SHAPE_SEED + 1)[0]
        self.check(all(ok for ok, _ in verdicts),
                   f"the D = 112 column plant's checks pass with no plant "
                   f"({sum(ok for ok, _ in verdicts)} of {len(verdicts)})")
        self.check(ops.flash_attention is real_flash and ops.flash_attention_bwd is real_bwd
                   and layers.multi_head_attention is real_mha
                   and build.library is real_library and layers.moe_combine is real_combine
                   and layers.moe_route is real_route and tfm.layer_norm is real_ln,
                   "every plant undone")
        self.fault_models = None

    def dense_plants(self) -> list[tuple]:
        """lm_faults' plants in the MoE and the layer norm, each caught by
        `dense_fault_verdicts`: (name, module, attribute, function, checks)."""
        from repro_torch.models import layers
        from repro_torch.models import transformer as tfm

        torch = self.torch
        real_combine, real_route, real_ln = layers.moe_combine, layers.moe_route, tfm.layer_norm

        def descending_combine(y, r, cfg):
            # a token's contributions added in descending expert order
            t, k = r.top_e.shape
            flip = torch.arange(k - 1, -1, -1, device=y.device)
            perm = (torch.arange(t, device=y.device)[:, None] * k + flip).reshape(-1)
            return real_combine(y, r._replace(top_e=r.top_e[:, flip], top_w=r.top_w[:, flip],
                                              rep_slot=r.rep_slot[perm],
                                              rep_keep=r.rep_keep[perm]), cfg)

        def last_writer_route(params, xf, cfg, groups=1):
            # a full expert's last place holds its last replica, dropped or
            # not, as an unmasked scatter would leave it (one dispatch group)
            r = real_route(params, xf, cfg, groups)
            flat = r.top_e.reshape(-1)
            last = torch.full_like(r.counts, -1).scatter_reduce_(
                0, flat, torch.arange(flat.numel(), device=flat.device), "amax")
            over = torch.nonzero(r.counts > r.cap).flatten()
            slot_rep = r.slot_rep.clone()
            slot_rep[over * r.cap + r.cap - 1] = last[over]
            return r._replace(slot_rep=slot_rep)

        def norm_without_bias(x, scale, bias, eps):
            return real_ln(x, scale, torch.zeros_like(bias), eps)

        return [("MoE: a token's contributions added in descending expert order", layers,
                 "moe_combine", descending_combine, "moe"),
                ("MoE: a dropped replica written at its expert's last live place", layers,
                 "moe_route", last_writer_route, "moe"),
                ("layer norm without its bias", tfm, "layer_norm", norm_without_bias, "norm")]

    def dense_fault_verdicts(self, what: str) -> list[tuple[bool, str]]:
        """lm_dense's layer checks at DENSE_FAULT_DEPTH layers, on weights
        drawn for that depth from seed 0 (made once): "moe", granite-moe's
        capacity checks at its published and its tight capacity factor;
        "norm", stablelm's layer norms on their own inputs."""
        import dataclasses

        from repro_torch.configs import get_config
        from repro_torch.data.tokens import TokenStream
        from repro_torch.models import DecoderModel
        from repro_torch.models import transformer as tfm

        torch = self.torch
        if getattr(self, "fault_models", None) is None:
            self.fault_models = {}
            for key, name in (("moe", "granite-moe-3b-a800m"), ("norm", "stablelm-1.6b")):
                cfg = dataclasses.replace(get_config(name), n_layers=DENSE_FAULT_DEPTH)
                params = DecoderModel(cfg).init(seed=0)
                self.perturb_norms(params, cfg)
                self.fault_models[key] = (cfg, params, TokenStream(cfg, 1, LM_SEQ, seed=0)(0))
        cfg, params, batch = self.fault_models[what]
        if what == "moe":
            tight = dataclasses.replace(cfg, capacity_factor=MOE_TIGHT_CAPACITY)
            return self.moe_verdicts(cfg, params, batch)[0] + self.moe_verdicts(
                tight, params, batch)[0]
        tokens = torch.as_tensor(batch["tokens"], device=self.dev)
        positions = torch.arange(LM_SEQ, dtype=torch.int32, device=self.dev)[None]
        with torch.no_grad(), self.norm_probe() as recs:
            tfm.decoder_forward(params, cfg, tokens, positions=positions)
        return self.norm_verdicts(recs, cfg, cfg.name)

    def planted_library(self, kernel: str, edits, name: str, *, wait: bool = True):
        """The library of `kernel` built from the checkout's source text with
        each (old, new) of `edits` applied (each old must appear once) into
        build/planted/<name>.so and loaded as the real library is. With
        wait=False nvcc runs in the background and a function is returned
        that waits for it and loads the library; its `stop()` ends that
        nvcc if it still runs."""
        import ctypes

        build = self.build_mod
        source = build.CSRC / build.KERNELS[kernel][0]
        text = source.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"plant {name}: '{old.strip()[:70]}' is not in "
                                   f"{source.name} once")
            text = text.replace(old, new)
        out = build.BUILD_DIR.parent / "planted"
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{name}.cu").write_text(text)
        lib_path = out / f"{name}.so"
        proc = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
                                 str(lib_path), str(out / f"{name}.cu")],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

        def load():
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for the plant {name}:\n{log}")
            lib = ctypes.CDLL(str(lib_path))
            for fn, argtypes in build.KERNELS[kernel][1]:
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            return lib

        def stop():
            proc.kill()                # nothing, once it has ended
            proc.wait()

        load.stop = stop
        return load() if wait else load


MESH_DRYRUN_SCRIPT = """
import json, sys
from repro_torch.launch import dryrun
for arch, shape, mesh, variant in json.loads(sys.argv[1]):
    rec = dryrun.run_cell(arch, shape, variant, save=False, mesh=mesh)
    rec.pop("traceback", None) if rec["ok"] else None
    print(json.dumps({k: rec.get(k) for k in (
        "arch", "shape", "variant", "mesh", "n_devices", "ok", "error", "fits", "flops",
        "collective_total_bytes", "collective_counts", "useful_flops_ratio", "total_s")}
        | {"peak_bytes": rec.get("memory", {}).get("peak_bytes"),
           "line": dryrun.summary_line(rec)}), flush=True)
"""


def _digest(t) -> str:
    """sha256 of a tensor's bytes: equal digests, equal bits."""
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def _dist_record(state) -> dict:
    """A DistState's digests: each shard's u, v (and v_eval) in the state's
    order, and the hyperparameters."""
    rec = {name: [_digest(x) for x in getattr(state, name)]
           for name in ("u", "v", "v_eval") if getattr(state, name) is not None}
    rec["hyper"] = [_digest(getattr(getattr(state, side), f))
                    for side in ("hyper_u", "hyper_v") for f in ("mu", "lam")]
    return rec


def _fingerprint(t, chunk: int = 1 << 24) -> tuple[int, int]:
    """Two int64 sums (wrapping) of a tensor's 32-bit words, plain and
    weighted by position: equal bits give equal fingerprints in any
    order; on the card, without a copy of the tensor to the host."""
    import torch

    words = t.detach().contiguous().view(torch.int32).reshape(-1)
    plain = weighted = 0
    for i in range(0, words.numel(), chunk):
        w = words[i:i + chunk].to(torch.int64)
        pos = torch.arange(i, i + w.numel(), device=w.device, dtype=torch.int64) % 65521 + 1
        plain += int(w.sum())
        weighted += int((w * pos).sum())
    return plain % (1 << 64), weighted % (1 << 64)


def _max_abs_err(a, b, rows: int = 4096) -> float:
    """max |a - b| in float64, a block of rows at a time."""
    return max((float((a[i:i + rows].double() - b[i:i + rows].double()).abs().max())
                for i in range(0, a.shape[0], rows)), default=0.0)


def dist_rank(rank: int, cfg: dict) -> None:
    """One rank of phase dist_ranks, started by torch.multiprocessing.spawn:
    opens the `cfg["backend"]` group of `cfg["world"]` ranks on cuda:0,
    runs `_dist_rank_run` on a 1-D "items" mesh and writes its record to
    cfg["dir"]. A rank that raises ends the spawn, which stops the others."""
    import datetime

    import torch
    import torch.distributed as dist

    out = Path(cfg["dir"])
    torch.cuda.set_device(0)
    dist.init_process_group(cfg["backend"], init_method=f"file://{out / ('pg_' + cfg['backend'])}",
                            rank=rank, world_size=cfg["world"],
                            timeout=datetime.timedelta(seconds=DIST_RANK_TIMEOUT_S))
    try:
        res = _dist_rank_run(rank, cfg, out)
    finally:
        dist.destroy_process_group()
    (out / f"{cfg['backend']}_rank{rank}.json").write_text(json.dumps(res))


def _dist_rank_run(rank: int, cfg: dict, out: Path) -> dict:
    import statistics

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import exchange
    from repro_torch.core.distributed import DIST_MODES, DistributedBPMF
    from repro_torch.data import SparseRatings
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import make_item_mesh

    t0 = time.perf_counter()
    mesh = make_item_mesh(device="cuda")
    a = np.load(out / "data.npz")
    shape = tuple(int(x) for x in a["shape"])
    train, test = (SparseRatings(a[f"{n}_rows"], a[f"{n}_cols"], a[f"{n}_vals"], shape)
                   for n in ("train", "test"))
    samplers = {mode: DistributedBPMF(train, test, mesh=mesh, k=K, alpha=1.5, width="auto",
                                      mode=mode, engine="fused") for mode in DIST_MODES}
    ring = samplers["ring"]
    s0 = ring.init(seed=0)
    noise = ring.draw_noise()
    res = {"rank": rank, "setup_s": time.perf_counter() - t0}
    # the ring's checks, its plant and the timing need several ranks: one
    # rank (the NCCL run) sends nothing, so it runs the sweeps alone
    full = cfg["world"] > 1

    # the path: one sweep of each mode; each launch of ring and allgather is
    # recorded (its counterpart block, which the ring overwrites, cloned;
    # the fingerprint of its output) and held against the plain version
    # after the sweeps, one rank at a time (the plain version's float64
    # rows take several GB a rank)
    real, recorded = ops.gather_syrk_seg, []

    def recording(*args, **kw):
        got = real(*args, **kw)
        recorded.append((args[:5] + (args[5].clone(),), kw, [_fingerprint(x) for x in got]))
        return got

    torch.cuda.synchronize()
    dist.barrier()
    ops.reset_launches()
    ops.gather_syrk_seg = recording if full else real
    try:
        first = {mode: samplers[mode].sweep(s0, noise) for mode in ("ring", "allgather")}
    finally:
        ops.gather_syrk_seg = real
    first["async"] = samplers["async"].sweep(s0, noise)
    torch.cuda.synchronize()
    res["launches"] = ops.launches()
    checked = []
    for turn in range(cfg["world"]):
        dist.barrier()
        if rank != turn:
            continue
        for args, kw, prints in recorded:
            again = real(*args, **kw)          # the same bits as the recorded launch's
            want = ref.gather_syrk_seg_ref(*args)
            same = ([_fingerprint(x) for x in again] == prints
                    and torch.equal(again[0], want[0]) and torch.equal(again[1], want[1]))
            err = 0.0 if same else max(_max_abs_err(again[0], want[0]),
                                       _max_abs_err(again[1], want[1]))
            checked.append((same, err))
            del again, want
        torch.cuda.empty_cache()
    dist.barrier()
    del recorded
    res["checked"] = checked
    res["sweep"] = {mode: {k: v[0] if isinstance(v, list) and k != "hyper" else v
                           for k, v in _dist_record(st).items()}
                    for mode, st in first.items()}
    if not full:
        return res
    np.save(out / f"{cfg['backend']}_rank{rank}_v_allgather.npy", first["allgather"].v[0].cpu())

    # the plant: every rank's ring forwards to r - 1 (and receives from r + 1)
    exchange.RankRing.shift = -1
    try:
        planted = ring.sweep(s0, noise)
    finally:
        exchange.RankRing.shift = 1
    np.save(out / f"{cfg['backend']}_rank{rank}_v_plant.npy", planted.v[0].cpu())
    res["shift_restored"] = exchange.RankRing.shift == 1

    # sweep seconds, the ring's waits and pairs, peak memory
    res["timing"] = {}
    for mode in DIST_MODES:
        d, st = samplers[mode], first[mode]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before, times = dict(d.exchange.times), []
        for _ in range(DIST_RANK_SWEEPS):
            dist.barrier()
            t1 = time.perf_counter()
            st = d.sweep(st)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        after = d.exchange.times
        res["timing"][mode] = dict(
            times=times, median=statistics.median(times),
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            **{key: after[key] - before[key] for key in ("pairs", "pair_s", "wait_s")})
    return res


def visible_pairs(s: int, window: int) -> int:
    """(query, key) pairs a causal sequence of s tokens attends, with a
    sliding window (0 = none): sum over q of min(q + 1, window)."""
    from repro_torch.kernels.ops import visible_pairs as pairs

    return pairs(s, window=window)


def bind_port() -> None:
    """The card's roofline constants (`launch/mesh.py`) and the flash
    pair's passes (`kernels/ops.py`) from the port."""
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh

    global HBM_BYTES_PER_S, FP32_FLOPS, BF16_TENSOR_FLOPS, FLASH_FWD_PASSES, FLASH_BWD_PASSES
    HBM_BYTES_PER_S, FP32_FLOPS, BF16_TENSOR_FLOPS = (
        mesh.HBM_BYTES_PER_S, mesh.FP32_FLOPS, mesh.BF16_TENSOR_FLOPS)
    FLASH_FWD_PASSES, FLASH_BWD_PASSES = ops.FLASH_FWD_PASSES, ops.FLASH_BWD_PASSES


if __name__ == "__main__":
    sys.exit(main())
