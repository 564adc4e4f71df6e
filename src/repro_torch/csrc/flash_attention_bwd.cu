// The backward of csrc/flash_attention.cu: the gradients of causal,
// sliding-window, soft-capped attention with GQA.
//
// The Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_pallas) has no backward: the JAX package differentiates
// its chunked jnp scan (repro/models/layers.py, _chunked_attention), in
// fp32 from end to end. This kernel computes that gradient from the
// forward's per-row log-sum-exp (lse) and its fp32 output o, over
// (BH, S, D) with BHk dividing BH, in fp32 (P and dS are never rounded):
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
//   delta  D = rowsum(dO o), one warp a row.
//   dq     one block a (32-row query tile, query head): a loop over the KV
//          tiles the tile can see recomputes S and dP and adds dS K into
//          a 32 x D accumulator in registers.
//   dkdv   one block a (32-key KV tile, KV head): a loop over the group's
//          query heads, in order, and over the query tiles that can see
//          the KV tile recomputes S and dP and adds P^T dO and dS^T Q into
//          two 32 x D accumulators in registers (64 KB across the block at
//          D = 256, 64 registers a thread).
// S and dP are recomputed in both the dq and the dkdv kernels: 7 products
// a visible pair where the function needs 5. Every product runs on the
// fp32 pipes (SIMT): tiles staged as fp32 in shared memory, a warp scores
// its 4 rows against one key a lane (Q and dO rows read as broadcasts),
// and in the accumulating products a warp owns 4 rows and a lane D / 32
// columns (4 adjacent ones in each 128-wide group when D >= 128, float4
// reads of Q, dO and K rows).
//
// Bound on an H100 at the gemma2-2b training step's shapes, q (8, 8,192,
// 256) and k, v (4, 8,192, 256) bf16: operations. The bytes are 235 MB
// (q, k, v, dO, o, lse read once; dq, dk, dv written once), 0.07 ms at
// 3.35 TB/s. Each visible pair takes 5 products of 2 D flops: S, dP, dV,
// dQ and dK. On bf16 tensor cores S and dP take the bf16 q, k, v and dO as
// they are (one pass each) and dV, dQ and dK take the fp32 P and dS split
// into three exact bf16 terms, as the forward splits P (three passes
// each): 11 passes. That is 1.51 TFLOP for a global layer (S (S + 1) / 2
// pairs a head) and 1.13 TFLOP for a local one (window 4,096, 25.17 M
// pairs a head): 1.53 and 1.15 ms at 989 TFLOP/s, 34.8 ms for a step's 26
// launches. The same 5 products on the fp32 pipes at 67 TFLOP/s take
// about 234 ms a step. This first version runs on the fp32 pipes and
// recomputes S and dP, and shared memory holds one block an SM at D = 256.
// Next: mma.sync or wgmma with the three-way split, K and V (or Q and dO)
// tiles by TMA, and a layout that computes S and dP once.
//
// Masking. The query tiles a KV tile visits, and the KV tiles a query tile
// visits, are the band the causal mask and the window leave; inside a
// tile every pair is masked on its own (causal, window, ragged tail), so
// a masked pair has P = 0 and adds nothing. Rows and keys past S are
// staged as zeros and never written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ float to(float x) { return x; }
};

template <>
struct Elem<bf16> {
  static __device__ __forceinline__ float4 load4(const bf16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ bf16 to(float x) { return __float2bfloat16_rn(x); }
};

// rows x D of src (row-major, D apart) into dst (D + PAD apart) as fp32;
// rows at or past `valid` are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int valid, int rows) {
  constexpr int C4 = D / 4;
  for (int e = threadIdx.x; e < rows * C4; e += THREADS) {
    const int r = e / C4, c = (e % C4) * 4;
    const float4 x = r < valid ? Elem<T>::load4(src + (size_t)r * D + c)
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

  // P and dS of one pair from its raw score s and dP, the row's lse and D
  __device__ __forceinline__ void grads(float s, float dp, int qpos, int kpos,
                                        float lse, float delta, float& p,
                                        float& ds) const {
    bool vis = qpos < S && kpos < S;
    if (causal) vis = vis && qpos >= kpos;
    if (window > 0) vis = vis && qpos - kpos < window;
    float x = s * scale, t = 0.f;
    if (softcap > 0.f) {
      t = tanhf(x / softcap);
      x = t * softcap;
    }
    p = vis ? expf(x - lse) : 0.f;
    ds = p * (dp - delta);
    if (softcap > 0.f) ds *= 1.f - t * t;
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
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[RPW][D / 32], int row0,
                                           int S, int lane) {
  constexpr int VEC = D >= 128 ? 4 : 1;
  constexpr int GROUPS = D / 32 / VEC;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    if (row0 + r >= S) continue;
    T* orow = out + (size_t)(row0 + r) * D;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        orow[g * 32 * VEC + lane * VEC + e] = Elem<T>::to(acc[r][g * VEC + e]);
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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int S, int rep, Mask mask) {
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
  const T* kb = k + (size_t)(h / rep) * S * D;
  const T* vb = v + (size_t)(h / rep) * S * D;

  load_tile<T, D>(qs, q + qoff * D, valid, BQ);
  load_tile<T, D>(dos, dout + qoff * D, valid, BQ);
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
    load_tile<T, D>(ks, kb + (size_t)k0 * D, min(BKV, S - k0), BKV);
    load_tile<T, D>(vs, vb + (size_t)k0 * D, min(BKV, S - k0), BKV);
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
  store_rows<T, D>(dq + qoff * D, acc, row0, valid, lane);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int S,
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

  load_tile<T, D>(ks, k + koff * D, kvalid, BKV);
  load_tile<T, D>(vs, v + koff * D, kvalid, BKV);

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
      load_tile<T, D>(qs, q + qoff * D, valid, BQ);
      load_tile<T, D>(dos, dout + qoff * D, valid, BQ);
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
  store_rows<T, D>(dk + koff * D, acc_k, row0, kvalid, lane);
  store_rows<T, D>(dv + koff * D, acc_v, row0, kvalid, lane);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const void* lse, void* delta, void* dq, void* dk, void* dv, int BH, int rep,
           int S, Mask mask, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const float* lp = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const int rows = BH * S;
  flash_bwd_delta_kernel<T, D><<<(rows + WARPS - 1) / WARPS, THREADS, 0, stream>>>(
      static_cast<const float*>(o), dop, dl, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr int dq_bytes = dq_smem_bytes<D>();
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<T, D><<<dim3(BH, (S + BQ - 1) / BQ), THREADS, dq_bytes, stream>>>(
      qp, kp, vp, dop, lp, dl, static_cast<T*>(dq), S, rep, mask);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr int kv_bytes = dkdv_smem_bytes<D>();
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kv_bytes);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<T, D><<<dim3(BH / rep, (S + BKV - 1) / BKV), THREADS, kv_bytes,
                                stream>>>(qp, kp, vp, dop, lp, dl, static_cast<T*>(dk),
                                          static_cast<T*>(dv), S, rep, mask);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, const void* o, const void* dout,
             const void* lse, void* delta, void* dq, void* dk, void* dv, int BH, int rep,
             int S, int bf16_, Mask mask, cudaStream_t stream) {
  return bf16_ ? launch<bf16, D>(q, k, v, o, dout, lse, delta, dq, dk, dv, BH, rep, S,
                                 mask, stream)
               : launch<float, D>(q, k, v, o, dout, lse, delta, dq, dk, dv, BH, rep, S,
                                  mask, stream);
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
