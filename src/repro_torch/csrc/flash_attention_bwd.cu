// The backward of csrc/flash_attention.cu: the gradients of causal,
// sliding-window, soft-capped attention with GQA.
//
// The Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_pallas) has no backward: the JAX package differentiates
// its chunked jnp scan (repro/models/layers.py, _chunked_attention), in
// fp32 from end to end. This kernel computes that gradient from the
// forward's per-row log-sum-exp (lse) and its fp32 output o, over
// (BH, S, D) with BHk dividing BH (P and dS are never rounded):
//
//   s'  = softcap(scale q k^T), t = tanh(s / softcap)     as the forward
//   P   = exp(s' - lse), 0 where masked
//   dV  = P^T dO          dP = dO V^T          D = rowsum(dO o)
//   dS  = scale P (dP - D) (1 - t^2)           (1 - t^2 only with a softcap)
//   dQ  = dS K            dK = dS^T Q
//
// with dK and dV summed over each KV head's query heads in head order,
// the order of kernels/ref.py::flash_attention_bwd_ref. D comes from the
// fp32 o, not from the output rounded to bf16: a bf16 o would put a 2^-9
// relative error into D, which dS amplifies wherever dP is close to D.
//
// Three kernels, one launch, no atomics: every output element is written
// once by one block, in a fixed order, so two runs give the same bits.
// Both grids put the head on x and issue the longest tiles of every head
// first, so the causal imbalance does not leave a tail.
//   delta  D = rowsum(dO o), one warp a row (both dtypes).
//   dq     one block a (query tile, query head): a loop over the KV tiles
//          the tile can see recomputes S and dP and adds dS K.
//   dkdv   one block a (KV tile, KV head): a loop over the group's query
//          heads, in order, and over the query tiles that can see the KV
//          tile recomputes S and dP and adds P^T dO and dS^T Q.
// fp32 runs dq and dkdv on the fp32 pipes (SIMT, flash_bwd_dq_kernel and
// flash_bwd_dkdv_kernel): 32-row tiles staged as fp32 in shared memory, a
// warp scoring its 4 rows against one key a lane, a lane owning D / 32
// accumulator columns. bf16 runs them on the tensor cores (namespace mma,
// flash_bwd_dq_mma_kernel and flash_bwd_dkdv_mma_kernel), below.
//
// Bound on an H100 at the gemma2-2b training step's shapes, q (8, 8,192,
// 256) and k, v (4, 8,192, 256) bf16: operations. The bytes are 235 MB
// (q, k, v, dO, o, lse read once; dq, dk, dv written once), 0.07 ms at
// 3.35 TB/s. Each visible pair takes 5 products of 2 D flops: S, dP, dV,
// dQ and dK. On bf16 tensor cores S and dP take the bf16 q, k, v and dO as
// they are (one pass each) and dV, dQ and dK take the fp32 P and dS split
// into three exact bf16 terms (three passes each): 11 passes. That is 1.51
// TFLOP for a global layer (S (S + 1) / 2 pairs a head) and 1.13 TFLOP for
// a local one (window 4,096, 25.17 M pairs a head): 1.53 and 1.15 ms at
// 989 TFLOP/s, 34.8 ms for a step's 26 launches. The same 5 products on
// the fp32 pipes at 67 TFLOP/s take about 234 ms a step.
//
// bf16 design. The SIMT kernel that came first spent 1.08 s of a 2.34 s
// train step here (31x its bound), for four reasons; what this one does
// about each:
//   1. Every product ran as fmaf on the fp32 pipes. Now all five run on
//      mma.sync.m16n8k16 (bf16 in, fp32 accumulators; mma_bf16.cuh, shared
//      with the forward). S and dP are one MMA pass each; dV, dQ and dK
//      take P and dS from the score accumulators, split into three exact
//      bf16 terms as A operands (split3: exact for |x| in 2^-100 .. 2^60,
//      which covers the signed dS too), three MMAs a fragment. The products
//      are exact in fp32, so the sums differ from the SIMT ones only in
//      order.
//   2. Tiles were copied synchronously, 32 rows at a time, behind a
//      __syncthreads each. Now the streamed tiles are double-buffered by
//      16-byte cp.async (lse and D by 4-byte ones): the next tile's copies
//      fly while the block multiplies this one, and a tile costs one wait
//      and two barriers.
//   3. S and dP are recomputed in both kernels: 13 passes where the bound
//      counts 11. That stays. One kernel would need atomics on dQ, or a dQ
//      partial for every KV tile (about 1 GB a head at S = 8,192).
//   4. Shared memory held one block an SM at D = 256. So do the registers
//      now (a warp's 16 x D fp32 accumulator is 128 registers a lane at
//      D = 256): 8 warps an SM, whose MMAs, ldmatrix loads and softcap
//      arithmetic have to overlap within the warp.
// dq: a block of 8 warps owns 128 query rows of one head, 16 a warp, and
// loops over 32-key tiles. S = Q K^T and dP = dO V^T land in accumulator
// fragments, become dS in registers, and feed dQ += dS K as the A operand
// with K through ldmatrix.trans, as the forward feeds P into P V. Q and dO
// stay in shared memory, the row's lse and D in registers. Shared memory:
// Q, dO (128 rows each) and two stages of K and V (32 rows each), each row
// D + 8 bf16 (the 16 bytes keep ldmatrix off repeated banks): 384 x 528
// bytes = 198 KB at D = 256.
// dkdv: dK and dV of the same 16 keys in one warp would take 256
// registers, over the limit of 255. So a block of 64 keys has 4 warp
// pairs of 16 keys each: warp p computes S^T = K Q^T, P^T and dV += P^T dO;
// warp p + 4 computes dP^T = V dO^T and, from P (1 - t^2) scale that warp
// p hands it through shared memory under a named barrier of the pair
// (bar.arrive, bar.sync), dS^T and dK += dS^T Q. The transposed scores'
// accumulators are already the A operands; Q and dO come in through
// ldmatrix.trans, and lse and D are read a column at a time from shared
// memory. Both warps of a pair make one score product and three split
// products a tile. Shared memory: K and V (64 rows), two stages of Q and
// dO (32 rows each), 4 x 2 KB of P (1 - t^2) scale and two stages of lse
// and D: 256 x 528 + 8,192 + 512 bytes = 140.5 KB at D = 256. ptxas: 246
// (dkdv) and 247 (dq) registers at D = 256, no spill.
// The products of a tile feed the running gradient as the MMA's C operand.
// The forward sums each tile in fresh accumulators instead, because over
// 8,192 keys the tensor cores' additions left peaked outputs more than a
// bf16 ulp off; here the gate is each gradient within one bf16 ulp of its
// head's largest magnitude, and on an H100 the running sums stay within
// 0.508 ulp of float64 at the training step's shapes, q x 6 included
// (fresh sums: 0.500, at 255 registers with a spill and 2-3% slower).
//
// Next for the bf16 kernels: wgmma (a warpgroup's 64-row products with B
// from shared memory, at the card's full tensor rate) and TMA copies on
// mbarriers in place of cp.async.
//
// Masking. The query tiles a KV tile visits, and the KV tiles a query tile
// visits, are the band the causal mask and the window leave; a warp (pair)
// skips a tile none of its rows can see, and inside a tile every pair is
// masked on its own (causal, window, ragged tail), so a masked pair has
// P = 0 and adds nothing. Rows and keys past S are staged as zeros and
// never written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 32;              // query rows a tile
constexpr int BKV = 32;             // keys a tile: one a lane in the score products
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = 4;              // rows a warp: query rows, or key rows in dkdv
constexpr int PAD = 4;              // floats after each D-wide row in shared memory
constexpr int TLD = 36;             // the row stride of the 32-wide P and dS tiles
static_assert(BQ == WARPS * RPW && BKV == WARPS * RPW, "a warp owns 4 rows of a tile");
static_assert(BKV == 32, "one key a lane");

using bf16 = __nv_bfloat16;

// four elements of dO as fp32, for the delta kernel (both dtypes); the
// SIMT dq and dkdv kernels below take fp32 only
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
};

template <>
struct Elem<bf16> {
  static __device__ __forceinline__ float4 load4(const bf16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
};

// rows x D of src (row-major, D apart) into dst (D + PAD apart); rows at
// or past `valid` are zero
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int valid, int rows) {
  constexpr int C4 = D / 4;
  for (int e = threadIdx.x; e < rows * C4; e += THREADS) {
    const int r = e / C4, c = (e % C4) * 4;
    const float4 x = r < valid ? *reinterpret_cast<const float4*>(src + (size_t)r * D + c)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * (D + PAD) + c) = x;
  }
}

// s[r] = Q[row0 + r] . K[lane] and dp[r] = dO[row0 + r] . V[lane] for the
// warp's 4 query rows against key `lane` of the tile
template <int D>
__device__ __forceinline__ void scores(const float* qs, const float* dos, const float* ks,
                                       const float* vs, int row0, int lane,
                                       float (&s)[RPW], float (&dp)[RPW]) {
  constexpr int LD = D + PAD;
#pragma unroll
  for (int r = 0; r < RPW; ++r) s[r] = dp[r] = 0.f;
  const float* krow = ks + lane * LD;
  const float* vrow = vs + lane * LD;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 kk = *reinterpret_cast<const float4*>(krow + d);
    const float4 vv = *reinterpret_cast<const float4*>(vrow + d);
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float4 qq = *reinterpret_cast<const float4*>(qs + (row0 + r) * LD + d);
      const float4 oo = *reinterpret_cast<const float4*>(dos + (row0 + r) * LD + d);
      s[r] = fmaf(qq.x, kk.x, s[r]);
      s[r] = fmaf(qq.y, kk.y, s[r]);
      s[r] = fmaf(qq.z, kk.z, s[r]);
      s[r] = fmaf(qq.w, kk.w, s[r]);
      dp[r] = fmaf(oo.x, vv.x, dp[r]);
      dp[r] = fmaf(oo.y, vv.y, dp[r]);
      dp[r] = fmaf(oo.z, vv.z, dp[r]);
      dp[r] = fmaf(oo.w, vv.w, dp[r]);
    }
  }
}

struct Mask {
  int S, causal, window;
  float softcap, scale;

  // P of one pair from its raw score s and the row's lse, 0 where masked,
  // and the factor (1 - t^2) that dS takes from the softcap (1 without one)
  __device__ __forceinline__ float prob(float s, int qpos, int kpos, float lse,
                                        float& fac) const {
    bool vis = qpos < S && kpos < S;
    if (causal) vis = vis && qpos >= kpos;
    if (window > 0) vis = vis && qpos - kpos < window;
    float x = s * scale, t = 0.f;
    if (softcap > 0.f) {
      t = tanhf(x / softcap);
      x = t * softcap;
    }
    fac = 1.f - t * t;
    return vis ? expf(x - lse) : 0.f;
  }

  // P and dS of one pair from its raw score s and dP, the row's lse and D
  __device__ __forceinline__ void grads(float s, float dp, int qpos, int kpos,
                                        float lse, float delta, float& p,
                                        float& ds) const {
    float fac;
    p = prob(s, qpos, kpos, lse, fac);
    ds = p * (dp - delta);
    if (softcap > 0.f) ds *= fac;
    ds *= scale;
  }
};

// acc[r][.] += a[r] * row[lane's columns] for the warp's 4 rows
template <int D>
__device__ __forceinline__ void add_row(float (&acc)[RPW][D / 32], const float (&a)[RPW],
                                        const float* row, int lane) {
  constexpr int VEC = D >= 128 ? 4 : 1;
  constexpr int GROUPS = D / 32 / VEC;
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    if constexpr (VEC == 4) {
      const float4 x = *reinterpret_cast<const float4*>(row + g * 128 + lane * 4);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        acc[r][g * 4 + 0] = fmaf(a[r], x.x, acc[r][g * 4 + 0]);
        acc[r][g * 4 + 1] = fmaf(a[r], x.y, acc[r][g * 4 + 1]);
        acc[r][g * 4 + 2] = fmaf(a[r], x.z, acc[r][g * 4 + 2]);
        acc[r][g * 4 + 3] = fmaf(a[r], x.w, acc[r][g * 4 + 3]);
      }
    } else {
      const float x = row[g * 32 + lane];
#pragma unroll
      for (int r = 0; r < RPW; ++r) acc[r][g] = fmaf(a[r], x, acc[r][g]);
    }
  }
}

// the warp's 4 rows of acc into out (row-major, D apart), rows row0 + r
// below S
template <int D>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[RPW][D / 32],
                                           int row0, int S, int lane) {
  constexpr int VEC = D >= 128 ? 4 : 1;
  constexpr int GROUPS = D / 32 / VEC;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    if (row0 + r >= S) continue;
    float* orow = out + (size_t)(row0 + r) * D;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        orow[g * 32 * VEC + lane * VEC + e] = acc[r][g * VEC + e];
    }
  }
}

template <int D>
constexpr int dq_smem_bytes() {
  return ((2 * BQ + 2 * BKV) * (D + PAD) + BKV * TLD + 2 * BQ) * 4;
}

template <int D>
constexpr int dkdv_smem_bytes() {
  return ((2 * BQ + 2 * BKV) * (D + PAD) + 2 * BQ * TLD + 2 * BQ) * 4;
}

// D = rowsum(dO o) of every row, one warp a row
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_delta_kernel(
    const float* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
    int rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= rows) return;
  float acc = 0.f;
  for (int c = lane * 4; c < D; c += 128) {
    const float4 a = *reinterpret_cast<const float4*>(o + (size_t)row * D + c);
    const float4 b = Elem<T>::load4(dout + (size_t)row * D + c);
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    acc = fmaf(a.w, b.w, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int S, int rep, Mask mask) {
  constexpr int LD = D + PAD;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // BQ x LD
  float* dos = qs + BQ * LD;        // BQ x LD
  float* ks = dos + BQ * LD;        // BKV x LD
  float* vs = ks + BKV * LD;        // BKV x LD
  float* dst = vs + BKV * LD;       // BKV x TLD: dS^T, dst[key][row]
  float* ls = dst + BKV * TLD;      // BQ: lse
  float* dl = ls + BQ;              // BQ: D

  const int nq = (S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.y) * BQ;   // longest rows first
  const int h = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * RPW;
  const int valid = min(BQ, S - q0);
  const size_t qoff = (size_t)h * S + q0;
  const float* kb = k + (size_t)(h / rep) * S * D;
  const float* vb = v + (size_t)(h / rep) * S * D;

  load_tile<D>(qs, q + qoff * D, valid, BQ);
  load_tile<D>(dos, dout + qoff * D, valid, BQ);
  if (threadIdx.x < BQ) {
    const int i = threadIdx.x;
    ls[i] = i < valid ? lse[qoff + i] : 0.f;
    dl[i] = i < valid ? delta[qoff + i] : 0.f;
  }

  // the KV tiles some row of this tile can see
  const int q_last = q0 + valid - 1;
  int kt_end = (S + BKV - 1) / BKV;
  if (mask.causal) kt_end = min(kt_end, q_last / BKV + 1);
  int kt_begin = 0;
  if (mask.window > 0 && q0 - mask.window + 1 > 0) kt_begin = (q0 - mask.window + 1) / BKV;

  float acc[RPW][D / 32];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int c = 0; c < D / 32; ++c) acc[r][c] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();                // every warp is done with the last tile
    load_tile<D>(ks, kb + (size_t)k0 * D, min(BKV, S - k0), BKV);
    load_tile<D>(vs, vb + (size_t)k0 * D, min(BKV, S - k0), BKV);
    __syncthreads();

    float s[RPW], dp[RPW], ds[RPW];
    scores<D>(qs, dos, ks, vs, row0, lane, s, dp);
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      float p;
      mask.grads(s[r], dp[r], q0 + row0 + r, k0 + lane, ls[row0 + r], dl[row0 + r], p,
                 ds[r]);
    }
    *reinterpret_cast<float4*>(dst + lane * TLD + row0) = make_float4(ds[0], ds[1], ds[2], ds[3]);
    __syncthreads();

    // dQ += dS K over the tile's keys
#pragma unroll 2
    for (int c = 0; c < BKV; ++c) {
      const float4 d4 = *reinterpret_cast<const float4*>(dst + c * TLD + row0);
      const float a[RPW] = {d4.x, d4.y, d4.z, d4.w};
      add_row<D>(acc, a, ks + c * LD, lane);
    }
  }
  store_rows<D>(dq + qoff * D, acc, row0, valid, lane);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int S,
    int rep, Mask mask) {
  constexpr int LD = D + PAD;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                 // BKV x LD
  float* vs = ks + BKV * LD;        // BKV x LD
  float* qs = vs + BKV * LD;        // BQ x LD
  float* dos = qs + BQ * LD;        // BQ x LD
  float* ps = dos + BQ * LD;        // BQ x TLD: P[row][key]
  float* dss = ps + BQ * TLD;       // BQ x TLD: dS[row][key]
  float* ls = dss + BQ * TLD;       // BQ: lse
  float* dl = ls + BQ;              // BQ: D

  const int k0 = blockIdx.y * BKV;  // the first tiles see the most rows
  const int hk = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * RPW;      // the warp's query rows, then its key rows
  const int kvalid = min(BKV, S - k0);
  const size_t koff = (size_t)hk * S + k0;

  load_tile<D>(ks, k + koff * D, kvalid, BKV);
  load_tile<D>(vs, v + koff * D, kvalid, BKV);

  // the query tiles that see some key of this tile
  const int k_last = k0 + kvalid - 1;
  const int q_begin = mask.causal ? k0 : 0;
  const int q_end = mask.window > 0 ? min(S, k_last + mask.window) : S;
  const int qt_begin = q_begin / BQ, qt_end = (q_end + BQ - 1) / BQ;

  float acc_k[RPW][D / 32], acc_v[RPW][D / 32];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int c = 0; c < D / 32; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;

  for (int h = hk * rep; h < (hk + 1) * rep; ++h) {   // the group's heads, in order
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      const int valid = min(BQ, S - q0);
      const size_t qoff = (size_t)h * S + q0;
      __syncthreads();              // every warp is done with the last tile
      load_tile<D>(qs, q + qoff * D, valid, BQ);
      load_tile<D>(dos, dout + qoff * D, valid, BQ);
      if (threadIdx.x < BQ) {
        const int i = threadIdx.x;
        ls[i] = i < valid ? lse[qoff + i] : 0.f;
        dl[i] = i < valid ? delta[qoff + i] : 0.f;
      }
      __syncthreads();

      float s[RPW], dp[RPW];
      scores<D>(qs, dos, ks, vs, row0, lane, s, dp);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        float p, ds;
        mask.grads(s[r], dp[r], q0 + row0 + r, k0 + lane, ls[row0 + r], dl[row0 + r], p,
                   ds);
        ps[(row0 + r) * TLD + lane] = p;
        dss[(row0 + r) * TLD + lane] = ds;
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q over the tile's query rows, for the
      // warp's key rows row0 .. row0 + 3
#pragma unroll 2
      for (int c = 0; c < BQ; ++c) {
        const float4 p4 = *reinterpret_cast<const float4*>(ps + c * TLD + row0);
        const float4 d4 = *reinterpret_cast<const float4*>(dss + c * TLD + row0);
        const float a[RPW] = {p4.x, p4.y, p4.z, p4.w};
        const float b[RPW] = {d4.x, d4.y, d4.z, d4.w};
        add_row<D>(acc_v, a, dos + c * LD, lane);
        add_row<D>(acc_k, b, qs + c * LD, lane);
      }
    }
  }
  store_rows<D>(dk + koff * D, acc_k, row0, kvalid, lane);
  store_rows<D>(dv + koff * D, acc_v, row0, kvalid, lane);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq, void* dk, void* dv, int BH, int rep, int S, Mask mask,
           cudaStream_t stream) {
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* dop = static_cast<const float*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  constexpr int dq_bytes = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<D><<<dim3(BH, (S + BQ - 1) / BQ), THREADS, dq_bytes, stream>>>(
      qp, kp, vp, dop, lp, dl, static_cast<float*>(dq), S, rep, mask);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr int kv_bytes = dkdv_smem_bytes<D>();
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kv_bytes);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<D><<<dim3(BH / rep, (S + BKV - 1) / BKV), THREADS, kv_bytes,
                             stream>>>(qp, kp, vp, dop, lp, dl, static_cast<float*>(dk),
                                       static_cast<float*>(dv), S, rep, mask);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ bf16: tensor cores
namespace mma {

using namespace tc;   // cp.async, ldmatrix, mma.sync, split3 (mma_bf16.cuh)

constexpr int PAD = 8;              // bf16 after each shared-memory row (16 bytes)
constexpr int DQ_BQ = 128;          // dq: query rows a block, 16 a warp
constexpr int DQ_BK = 32;           // dq: keys a KV tile
constexpr int KV_BK = 64;           // dkdv: keys a block, 16 a warp pair
constexpr int KV_BQ = 32;           // dkdv: query rows a tile
constexpr int PAIRS = WARPS / 2;
constexpr int NT = 4;               // n-tiles (8 wide) of a warp's 16 x 32 score tile
constexpr int KG = 2;               // 16-deep k steps of the same tile as an A operand
static_assert(DQ_BQ == WARPS * 16 && KV_BK == PAIRS * 16, "16 rows a warp (pair)");
static_assert(DQ_BK == 8 * NT && KV_BQ == 8 * NT && NT == 2 * KG, "32-wide score tiles");

template <int D>
constexpr int dq_smem_bytes() {
  return (2 * DQ_BQ + 4 * DQ_BK) * (D + PAD) * 2;   // Q, dO, 2 stages of K and of V
}

template <int D>
constexpr int dkdv_smem_bytes() {
  return (2 * KV_BK + 4 * KV_BQ) * (D + PAD) * 2    // K, V, 2 stages of Q and of dO
         + PAIRS * 16 * KV_BQ * 4                   // P (1 - t^2) scale, a tile a pair
         + 2 * 2 * KV_BQ * 4;                       // 2 stages of lse and of D
}

// 4 bytes from src into shared memory, or 4 zero bytes where !in
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 4 : 0));
}

// a named barrier of one warp pair: the producer arrives, the consumer waits
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 64;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" :: "r"(id) : "memory");
}

// The A operand of the first 16 rows, columns c0 .. c0 + 15, of a
// row-major tile ld apart
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* t, int ld, int c0,
                                       int lane) {
  ldsm_x4(a, t + (lane & 15) * ld + c0 + (lane >> 4) * 8);
}

// The B operands of two n-tiles, n rows n0 .. n0 + 15 by k columns c0 ..
// c0 + 15 of a tile stored n-major (K for Q K^T): b[0..1] the first, b[2..3]
// the second
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* t, int ld, int n0,
                                       int c0, int lane) {
  ldsm_x4(b, t + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + c0 + ((lane >> 3) & 1) * 8);
}

// The same from a tile stored k-major (V for P V): k rows k0 .. k0 + 15,
// n columns n0 .. n0 + 15, through ldmatrix.trans
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4], const bf16* t, int ld, int k0,
                                             int n0, int lane) {
  ldsm_x4_trans(b, t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8);
}

// s = A B^T for a warp's 16 rows of a (row-major, ld apart) against the 32
// rows of b, over D
template <int D>
__device__ __forceinline__ void scores(float (&s)[NT][4], const bf16* a, const bf16* b,
                                       int ld, int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    uint32_t af[4];
    load_a(af, a, ld, kd * 16, lane);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];
      load_b(bf, b, ld, np * 16, kd * 16, lane);
      mma_bf16(s[2 * np], af, bf[0], bf[1]);
      mma_bf16(s[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x D) += X Y for a warp's 16 x 32 fp32 X in accumulator fragments,
// split into three exact bf16 terms, and Y the 32 x D tile y (row-major,
// ld apart); the MMAs add into acc itself (the head comment says why)
template <int D>
__device__ __forceinline__ void add_product(float (&acc)[D / 8][4], const float (&x)[NT][4],
                                            const bf16* y, int ld, int lane) {
  uint32_t x1[KG][4], x2[KG][4], x3[KG][4];
#pragma unroll
  for (int kk = 0; kk < KG; ++kk) {
    split3(x[2 * kk][0], x[2 * kk][1], x1[kk][0], x2[kk][0], x3[kk][0]);
    split3(x[2 * kk][2], x[2 * kk][3], x1[kk][1], x2[kk][1], x3[kk][1]);
    split3(x[2 * kk + 1][0], x[2 * kk + 1][1], x1[kk][2], x2[kk][2], x3[kk][2]);
    split3(x[2 * kk + 1][2], x[2 * kk + 1][3], x1[kk][3], x2[kk][3], x3[kk][3]);
  }
#pragma unroll
  for (int dp = 0; dp < D / 16; ++dp) {
#pragma unroll
    for (int kk = 0; kk < KG; ++kk) {
      uint32_t b[4];
      load_b_trans(b, y, ld, kk * 16, dp * 16, lane);
      mma_bf16(acc[2 * dp], x3[kk], b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], x3[kk], b[2], b[3]);
      mma_bf16(acc[2 * dp], x2[kk], b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], x2[kk], b[2], b[3]);
      mma_bf16(acc[2 * dp], x1[kk], b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], x1[kk], b[2], b[3]);
    }
  }
}

// rows row0 + g and row0 + g + 8 (those below S) of a warp's 16 x D
// accumulator into out (row-major, D apart), rounded to bf16
template <int D>
__device__ __forceinline__ void store_acc(bf16* out, const float (&acc)[D / 8][4], int row0,
                                          int S, int lane) {
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + r * 8;
    if (row >= S) continue;
    bf16* orow = out + (size_t)row * D + tig * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int S, int rep, Mask mask) {
  constexpr int LD = D + PAD;
  extern __shared__ __align__(16) bf16 smem_bf16[];
  bf16* qs = smem_bf16;             // DQ_BQ x LD
  bf16* dos = qs + DQ_BQ * LD;      // DQ_BQ x LD
  bf16* ks = dos + DQ_BQ * LD;      // 2 stages of DQ_BK x LD
  bf16* vs = ks + 2 * DQ_BK * LD;   // 2 stages of DQ_BK x LD

  const int h = blockIdx.x;
  const int nq = (S + DQ_BQ - 1) / DQ_BQ;
  const int q0 = (nq - 1 - (int)blockIdx.y) * DQ_BQ;   // longest rows first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int qw = q0 + warp * 16;    // the warp's first row
  const int valid = min(DQ_BQ, S - q0);
  const size_t qoff = (size_t)h * S + q0;
  const bf16* kb = k + (size_t)(h / rep) * S * D;
  const bf16* vb = v + (size_t)(h / rep) * S * D;

  // the KV tiles some row of this block can see
  int kt_end = (S + DQ_BK - 1) / DQ_BK;
  if (mask.causal) kt_end = min(kt_end, (q0 + valid - 1) / DQ_BK + 1);
  int kt_begin = 0;
  if (mask.window > 0 && q0 - mask.window + 1 > 0) kt_begin = (q0 - mask.window + 1) / DQ_BK;

  load_rows<D, PAD, THREADS>(qs, q + qoff * D, valid, DQ_BQ);
  load_rows<D, PAD, THREADS>(dos, dout + qoff * D, valid, DQ_BQ);
  if (kt_begin < kt_end) {
    const int k0 = kt_begin * DQ_BK;
    load_rows<D, PAD, THREADS>(ks, kb + (size_t)k0 * D, min(DQ_BK, S - k0), DQ_BK);
    load_rows<D, PAD, THREADS>(vs, vb + (size_t)k0 * D, min(DQ_BK, S - k0), DQ_BK);
  }
  cp_async_commit();

  // lse and D of the lane's two rows: qw + g (fragment entries 0, 1) and
  // qw + g + 8 (2, 3)
  float rl[2], rd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qw + g + r * 8;
    rl[r] = qpos < S ? lse[(size_t)h * S + qpos] : 0.f;
    rd[r] = qpos < S ? delta[(size_t)h * S + qpos] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = kt_begin, st = 0; kt < kt_end; ++kt, st ^= 1) {
    if (kt + 1 < kt_end) {          // the next tile's copies fly meanwhile
      const int k1 = (kt + 1) * DQ_BK;
      load_rows<D, PAD, THREADS>(ks + (st ^ 1) * DQ_BK * LD, kb + (size_t)k1 * D,
                                 min(DQ_BK, S - k1), DQ_BK);
      load_rows<D, PAD, THREADS>(vs + (st ^ 1) * DQ_BK * LD, vb + (size_t)k1 * D,
                                 min(DQ_BK, S - k1), DQ_BK);
    }
    cp_async_commit();
    cp_async_wait_one();            // this tile has landed
    __syncthreads();

    const int k0 = kt * DQ_BK;
    const bf16* kt_s = ks + st * DQ_BK * LD;
    const bf16* vt_s = vs + st * DQ_BK * LD;
    // whether any row of the warp sees a key of the tile
    const bool seen = qw < S && !(mask.causal && k0 > qw + 15) &&
                      !(mask.window > 0 && qw - (k0 + DQ_BK - 1) >= mask.window);
    if (seen) {
      float s[NT][4], dp[NT][4];
      scores<D>(s, qs + warp * 16 * LD, kt_s, LD, lane);      // S = Q K^T
      scores<D>(dp, dos + warp * 16 * LD, vt_s, LD, lane);    // dP = dO V^T
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float p;
          mask.grads(s[n][c], dp[n][c], qw + g + (c >> 1) * 8, k0 + n * 8 + tig * 2 + (c & 1),
                     rl[c >> 1], rd[c >> 1], p, s[n][c]);   // dS in S's place
        }
      }
      add_product<D>(acc, s, kt_s, LD, lane);                 // dQ += dS K
    }
    __syncthreads();                // every warp is done with this stage
  }
  cp_async_wait_all();              // no copy outlives the block (no tile ran)
  store_acc<D>(dq + (size_t)h * S * D, acc, qw, S, lane);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkdv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int S,
    int rep, Mask mask) {
  constexpr int LD = D + PAD;
  extern __shared__ __align__(16) bf16 smem_bf16[];
  bf16* ks = smem_bf16;             // KV_BK x LD
  bf16* vs = ks + KV_BK * LD;       // KV_BK x LD
  bf16* qs = vs + KV_BK * LD;       // 2 stages of KV_BQ x LD
  bf16* dos = qs + 2 * KV_BQ * LD;  // 2 stages of KV_BQ x LD
  float* pfs = reinterpret_cast<float*>(dos + 2 * KV_BQ * LD);   // a pair's 16 x KV_BQ
  float* ls = pfs + PAIRS * 16 * KV_BQ;                           // 2 stages of lse
  float* dl = ls + 2 * KV_BQ;                                     // 2 stages of D

  const int k0 = blockIdx.y * KV_BK;  // the first tiles see the most rows
  const int hk = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  // warp pair p owns keys kw .. kw + 15: warp p computes S^T, P and dV,
  // warp p + PAIRS dP^T, dS and dK
  const int pair = warp % PAIRS, role = warp / PAIRS;
  const int kw = k0 + pair * 16;
  const int kvalid = min(KV_BK, S - k0);
  const size_t koff = (size_t)hk * S + k0;

  load_rows<D, PAD, THREADS>(ks, k + koff * D, kvalid, KV_BK);
  load_rows<D, PAD, THREADS>(vs, v + koff * D, kvalid, KV_BK);

  // the query tiles that see some key of this block, for each of the
  // group's heads in order: tile `it` is head hk rep + it / nqt
  const int q_begin = mask.causal ? k0 : 0;
  const int q_end = mask.window > 0 ? min(S, k0 + kvalid - 1 + mask.window) : S;
  const int qt_begin = q_begin / KV_BQ;
  const int nqt = (q_end + KV_BQ - 1) / KV_BQ - qt_begin;
  const int tiles = rep * nqt;

  auto stage = [&](int it, int st) {  // tile it's Q, dO, lse and D into stage st
    const int q0 = (qt_begin + it % nqt) * KV_BQ;
    const int valid = min(KV_BQ, S - q0);
    const size_t qoff = (size_t)(hk * rep + it / nqt) * S + q0;
    load_rows<D, PAD, THREADS>(qs + st * KV_BQ * LD, q + qoff * D, valid, KV_BQ);
    load_rows<D, PAD, THREADS>(dos + st * KV_BQ * LD, dout + qoff * D, valid, KV_BQ);
    if (threadIdx.x < 2 * KV_BQ) {
      const int i = threadIdx.x % KV_BQ;
      const bool in = i < valid, d = threadIdx.x >= KV_BQ;
      cp_async4((d ? dl : ls) + st * KV_BQ + i, (d ? delta : lse) + qoff + (in ? i : 0), in);
    }
  };
  if (tiles > 0) stage(0, 0);
  cp_async_commit();

  // the A operand of the scores: K for S^T = K Q^T, V for dP^T = V dO^T
  const bf16* arows = (role ? vs : ks) + pair * 16 * LD;
  // the pair's P (1 - t^2) scale in fragment order: entry (n, c) of lane l
  // at (4 n + c) 32 + l, so each lane reads what it would hold
  float* pf = pfs + pair * 16 * KV_BQ;

  float acc[D / 8][4];              // dV (role 0) or dK (role 1), rows kw + g and kw + g + 8
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0, st = 0; it < tiles; ++it, st ^= 1) {
    if (it + 1 < tiles) stage(it + 1, st ^ 1);   // the next tile's copies fly meanwhile
    cp_async_commit();
    cp_async_wait_one();            // this tile (and K and V) have landed
    __syncthreads();

    const int q0 = (qt_begin + it % nqt) * KV_BQ;
    const bf16* qt_s = qs + st * KV_BQ * LD;
    const bf16* dot_s = dos + st * KV_BQ * LD;
    // whether some query of the tile sees a key of the pair: the same in
    // both warps of the pair, so both take the named barrier or neither
    const bool seen = kw < S && !(mask.causal && q0 + KV_BQ - 1 < kw) &&
                      !(mask.window > 0 && q0 - (kw + 15) >= mask.window);
    if (seen) {
      // entry (n, c): key kw + g + (c >> 1) 8, query q0 + n 8 + 2 tig + (c & 1)
      float s[NT][4];
      scores<D>(s, arows, role ? dot_s : qt_s, LD, lane);
      if (role == 0) {              // S^T -> P^T, and P (1 - t^2) scale for dS
        const float* lt = ls + st * KV_BQ;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int qi = n * 8 + tig * 2 + (c & 1);
            float fac;
            const float p = mask.prob(s[n][c], q0 + qi, kw + g + (c >> 1) * 8, lt[qi], fac);
            pf[(n * 4 + c) * 32 + lane] = p * fac * mask.scale;
            s[n][c] = p;
          }
        }
        bar_arrive(1 + pair);
      } else {                      // dP^T -> dS^T = P (1 - t^2) scale (dP - D)
        const float* dt = dl + st * KV_BQ;
        bar_sync(1 + pair);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            s[n][c] = pf[(n * 4 + c) * 32 + lane] * (s[n][c] - dt[n * 8 + tig * 2 + (c & 1)]);
        }
      }
      add_product<D>(acc, s, role ? qt_s : dot_s, LD, lane);   // dV += P^T dO, dK += dS^T Q
    }
    __syncthreads();                // every warp is done with this stage
  }
  cp_async_wait_all();              // no copy outlives the block (no tile ran)
  store_acc<D>((role ? dk : dv) + (size_t)hk * S * D, acc, kw, S, lane);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq, void* dk, void* dv, int BH, int rep, int S, Mask mask,
           cudaStream_t stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  constexpr int dq_bytes = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_mma_kernel<D><<<dim3(BH, (S + DQ_BQ - 1) / DQ_BQ), THREADS, dq_bytes,
                               stream>>>(qp, kp, vp, dop, lp, dl, static_cast<bf16*>(dq), S,
                                         rep, mask);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr int kv_bytes = dkdv_smem_bytes<D>();
  err = cudaFuncSetAttribute(flash_bwd_dkdv_mma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kv_bytes);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_mma_kernel<D><<<dim3(BH / rep, (S + KV_BK - 1) / KV_BK), THREADS, kv_bytes,
                                 stream>>>(qp, kp, vp, dop, lp, dl, static_cast<bf16*>(dk),
                                           static_cast<bf16*>(dv), S, rep, mask);
  return (int)cudaGetLastError();
}

}  // namespace mma

template <int D>
int launch_d(const void* q, const void* k, const void* v, const void* o, const void* dout,
             const void* lse, void* delta, void* dq, void* dk, void* dv, int BH, int rep,
             int S, int bf16_, Mask mask, cudaStream_t stream) {
  const int rows = BH * S;
  const float* op = static_cast<const float*>(o);
  float* dl = static_cast<float*>(delta);
  if (bf16_)
    flash_bwd_delta_kernel<bf16, D><<<(rows + WARPS - 1) / WARPS, THREADS, 0, stream>>>(
        op, static_cast<const bf16*>(dout), dl, rows);
  else
    flash_bwd_delta_kernel<float, D><<<(rows + WARPS - 1) / WARPS, THREADS, 0, stream>>>(
        op, static_cast<const float*>(dout), dl, rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return bf16_ ? mma::launch<D>(q, k, v, dout, lse, delta, dq, dk, dv, BH, rep, S, mask,
                                stream)
               : launch<D>(q, k, v, dout, lse, delta, dq, dk, dv, BH, rep, S, mask, stream);
}

}  // namespace

// q, dout, dq (BH, S, D), k, v, dk, dv (BHk, S, D), all contiguous, of one
// dtype: bf16 when `bf16` is 1, else fp32; o (BH, S, D) fp32, the
// forward's output before rounding; lse (BH, S) fp32, the forward's
// per-row log-sum-exp; delta (BH, S) fp32 scratch. BH must be a multiple
// of BHk and D one of 32, 64, 128, 256. Three kernels on `stream`, in
// order: delta, dq, dk and dv. Returns the CUDA error code of the first
// launch that fails, else of the last.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout,
                                          const void* lse, void* delta, void* dq,
                                          void* dk, void* dv, int BH, int BHk, int S,
                                          int D, int bf16, int causal, int window,
                                          float softcap, float scale, void* stream) {
  if (BH <= 0 || BHk <= 0 || BH % BHk != 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rep = BH / BHk;
  const Mask mask{S, causal, window, softcap, scale};
  switch (D) {
    case 32: return launch_d<32>(q, k, v, o, dout, lse, delta, dq, dk, dv, BH, rep, S, bf16, mask, st);
    case 64: return launch_d<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, BH, rep, S, bf16, mask, st);
    case 128: return launch_d<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, BH, rep, S, bf16, mask, st);
    case 256: return launch_d<256>(q, k, v, o, dout, lse, delta, dq, dk, dv, BH, rep, S, bf16, mask, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
