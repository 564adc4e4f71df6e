// Causal, sliding-window, soft-capped attention with an online softmax.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_pallas, body _flash_kernel). Over (BH, S, D):
//
//   s   = (q . k) * scale                      fp32
//   s   = tanh(s / softcap) * softcap          if softcap > 0
//   s   = masked where k > q (causal), q - k >= window (window > 0) or
//         k >= Sk (a ragged tail)
//   out = softmax(s) v                         fp32, rounded to q's dtype
//
// with the running (max, denominator, accumulator) of each query row kept
// in fp32, as the TPU kernel keeps them in VMEM scratch. P stays fp32: it
// is never rounded to bf16.
//
// GQA: both kernels map query row block bh to KV row block bh / (BH /
// BHk), so k and v come in with their own head count and are never
// repeated in device memory (the caller does not run _expand_kv).
//
// Two kernels, by dtype, behind the one launcher:
//
//   fp32  flash_kernel: both products on the fp32 pipes (SIMT). One block
//         of 8 warps a 64-row query tile; 32-key tiles staged as fp32 in
//         shared memory; each warp scores its 8 rows with one key a lane,
//         writes its P rows to shared memory and adds P V into an 8 x D
//         accumulator in registers.
//   bf16  flash_mma_kernel: both products on the tensor cores, with
//         mma.sync.m16n8k16 (bf16 inputs, fp32 accumulators).
//
// The bf16 kernel's premise: an fp32 P goes through bf16 tensor cores
// exactly. Split each p into p1 = bf16(p), p2 = bf16(p - p1) and
// p3 = bf16(p - p1 - p2). Each difference is exact in fp32, and p3 takes
// what is left, so p1 + p2 + p3 == p for every p down to about 2^-100 (a
// p in [0, 1] has 24 significant bits and each term takes 8); below that
// the lost part is under 2^-120 of the row's largest p, which is 1. A bf16
// times a bf16 is exact in fp32, so P V taken as three bf16 MMAs into fp32
// accumulators adds the same exact products that the fp32 pipes add: only
// the order of the sums differs. Two terms would leave 2^-16 of p
// (tests/test_torch_kernels.py checks all three facts). QK^T takes the
// bf16 q and k as they are.
//
// Bound on an H100 at the gemma2-2b forward's shapes, (BH = 8, S = 8,192,
// D = 256) bf16 with 4 KV heads: operations. The bytes are 101 MB (q, k,
// v read once, o written once), 0.030 ms at 3.35 TB/s. Each bf16 tensor
// pass over the visible pairs takes 2 D flops a pair: 137 GFLOP for a
// global layer (S (S + 1) / 2 pairs a head), 103 GFLOP for a local one
// (window 4,096), 0.139 and 0.104 ms at 989 TFLOP/s. The bf16 kernel makes
// four such passes, one for QK^T and three for the exact P V: 0.556 ms a
// global and 0.416 ms a local launch. With P V on the fp32 pipes at 67
// TFLOP/s instead, as the fp32 kernel runs it, the bound is 2.190 and
// 1.643 ms; chip_smoke.py prints both.
//
// bf16 design. One block of 8 warps owns one (128-row query tile, head)
// pair, and the KV axis is a loop inside the block: nothing is carried
// between blocks, there are no atomics and no second pass, and the grid
// issues the longest query tiles of every head first, so the causal
// imbalance does not leave a tail. Q (128 rows) and two stages of K and V
// (64 keys each) sit in shared memory as bf16, each row padded by 16
// bytes so that ldmatrix reads no bank twice: 198 KB at D = 256. The next
// K and V tiles are copied by 16-byte cp.async while the block works on
// this one. Each warp owns 16 query rows:
//   - S = Q K^T, a 16 x 64 tile in mma accumulator fragments, with Q and
//     K fragments from shared memory by ldmatrix;
//   - scale, accurate tanhf for the softcap (the one-ulp checks see
//     tanh.approx), and the causal, window and ragged-tail mask only on
//     tiles that cross an edge;
//   - the online softmax on the fragments: a row's max and sum over the
//     4 lanes of a quad that hold it, 2 shuffles;
//   - P reused in registers as the A operand, split into (p3, p2, p1),
//     three MMAs for each V fragment, V from ldmatrix.trans;
//   - a tile's P V summed in fresh accumulators and added to O by one
//     fp32 fused multiply-add that also rescales O. The tensor cores' own
//     additions do not round as fp32 adds do: fed the running O over
//     8,192 keys, they left peaked outputs more than a bf16 ulp from the
//     plain version's (chip_smoke.py's q x 6 cases on an H100);
//   - O in 16 x D fp32 registers (128 a lane at D = 256), rounded to bf16
//     once at the end. At D = 256 the kernel runs at 255 registers with a
//     192-byte spill; holding the tile's split P (48 registers) for the
//     fresh sums costs about 14% of the time on an H100.
// KV tiles wholly outside the causal and window bounds of the block are
// skipped, and a warp skips a tile none of its rows can see.
//
// Next for this kernel: wgmma (a warpgroup's 64-row products with B from
// shared memory, at the card's full tensor rate), TMA copies on mbarriers
// in place of cp.async, and warp specialisation (a producer warp that
// keeps the copies in flight beside consumer warpgroups).
//
// For the backward (csrc/flash_attention_bwd.cu) both kernels also write,
// when given the pointers, each row's log-sum-exp m + log(l) and, for bf16,
// the fp32 quotients the output rounds. That is a second instantiation of
// each kernel (KEEP), so the launch without them compiles, and computes,
// as before they existed.
//
// Masking. A masked score is -inf and the row maximum starts at -inf. A
// row whose scores so far are all masked keeps p = 0 and l = 0, so a tile
// that is wholly masked for one row (the window's lower edge) adds
// nothing to it, whatever order the tiles come in. A row that sees no key
// at all (only possible without causality, with Sq > Sk and a window)
// comes out 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;              // query rows a block
constexpr int BK = 32;              // keys a KV tile: one a lane
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = BQ / WARPS;     // query rows a warp
constexpr int PAD = 4;              // floats after each Q and K row in shared memory
static_assert(RPW == 8, "a warp's P rows are written and read as two float4");

template <typename T>
struct Four;

template <>
struct Four<float> {
  static __device__ __forceinline__ float4 load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ float to(float x) { return x; }
};

// rows x D elements of src (row-major, D apart) into dst (ld apart) as
// fp32; rows at or past `valid` are zero, so a ragged tail holds finite
// values.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int valid, int rows) {
  constexpr int C4 = D / 4;
  for (int e = threadIdx.x; e < rows * C4; e += THREADS) {
    const int r = e / C4, c = (e % C4) * 4;
    const float4 x = r < valid ? Four<T>::load(src + (size_t)r * D + c)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * ld + c) = x;
  }
}

template <int D>
constexpr int smem_bytes() {
  return (BQ * (D + PAD) + BK * (D + PAD) + BK * D + WARPS * BK * RPW) * 4;
}

template <typename T, int D, bool KEEP>
__global__ void __launch_bounds__(THREADS, 1) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int rep,
    int causal, int window, float softcap, float scale) {
  constexpr int LD = D + PAD;
  // a lane owns D / 32 accumulator columns: four adjacent ones in each
  // 128-wide group when D >= 128 (float4 reads of V), else one in each
  // 32-wide group
  constexpr int VEC = D >= 128 ? 4 : 1;
  constexpr int CPT = D / 32;
  constexpr int GROUPS = CPT / VEC;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // BQ x LD
  float* ks = qs + BQ * LD;           // BK x LD
  float* vs = ks + BK * LD;           // BK x D
  float* ps = vs + BK * D;            // per warp: BK x RPW, p[key][row]

  const int nq = (Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;   // longest rows first
  const int bh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * RPW;
  float* pw = ps + warp * BK * RPW;
  const T* kb = k + (size_t)(bh / rep) * Sk * D;
  const T* vb = v + (size_t)(bh / rep) * Sk * D;

  load_tile<T, D>(qs, LD, q + ((size_t)bh * Sq + q0) * D, min(BQ, Sq - q0), BQ);

  // the KV tiles some row of this block can see
  const int q_last = min(q0 + BQ, Sq) - 1;
  int kt_end = (Sk + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, q_last / BK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;

  float m[RPW], l[RPW], acc[RPW][CPT];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    const int valid = min(BK, Sk - k0);
    __syncthreads();                  // every warp is done with the last tile
    load_tile<T, D>(ks, LD, kb + (size_t)k0 * D, valid, BK);
    load_tile<T, D>(vs, D, vb + (size_t)k0 * D, valid, BK);
    __syncthreads();

    // scores of the warp's rows against key k0 + lane
    float s[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i] = 0.f;
    const float* krow = ks + lane * LD;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float4 qq = *reinterpret_cast<const float4*>(qs + (row0 + i) * LD + d);
        s[i] = fmaf(qq.x, kk.x, s[i]);
        s[i] = fmaf(qq.y, kk.y, s[i]);
        s[i] = fmaf(qq.z, kk.z, s[i]);
        s[i] = fmaf(qq.w, kk.w, s[i]);
      }
    }

    // scale, cap, mask, and the online softmax update of each row
    const int kpos = k0 + lane;
    float p[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int qpos = q0 + row0 + i;
      float x = s[i] * scale;
      if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
      bool seen = kpos < Sk;
      if (causal) seen = seen && qpos >= kpos;
      if (window > 0) seen = seen && qpos - kpos < window;
      x = seen ? x : -INFINITY;
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      p[i] = expf(x - m_use);                   // 0 where masked
      const float corr = expf(m[i] - m_use);    // 0 while the row saw nothing
      float sum = p[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
    }
    *reinterpret_cast<float4*>(pw + lane * RPW) = make_float4(p[0], p[1], p[2], p[3]);
    *reinterpret_cast<float4*>(pw + lane * RPW + 4) = make_float4(p[4], p[5], p[6], p[7]);
    __syncwarp();

    // acc += P V over the tile's keys
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      const float4 p0 = *reinterpret_cast<const float4*>(pw + j * RPW);
      const float4 p1 = *reinterpret_cast<const float4*>(pw + j * RPW + 4);
      const float pr[RPW] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      const float* vrow = vs + j * D;
#pragma unroll
      for (int g = 0; g < GROUPS; ++g) {
        if constexpr (VEC == 4) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + g * 128 + lane * 4);
#pragma unroll
          for (int i = 0; i < RPW; ++i) {
            acc[i][g * 4 + 0] = fmaf(pr[i], vv.x, acc[i][g * 4 + 0]);
            acc[i][g * 4 + 1] = fmaf(pr[i], vv.y, acc[i][g * 4 + 1]);
            acc[i][g * 4 + 2] = fmaf(pr[i], vv.z, acc[i][g * 4 + 2]);
            acc[i][g * 4 + 3] = fmaf(pr[i], vv.w, acc[i][g * 4 + 3]);
          }
        } else {
          const float vv = vrow[g * 32 + lane];
#pragma unroll
          for (int i = 0; i < RPW; ++i) acc[i][g] = fmaf(pr[i], vv, acc[i][g]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int qpos = q0 + row0 + i;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    if (KEEP && lane == 0) lse[(size_t)bh * Sq + qpos] = m[i] + logf(l[i]);
    T* orow = o + ((size_t)bh * Sq + qpos) * D;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int col = g * 32 * VEC + lane * VEC + e;
        orow[col] = Four<T>::to(acc[i][g * VEC + e] / denom);
      }
    }
  }
}

template <typename T, int D, bool KEEP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int BH, int rep, int Sq, int Sk, int causal, int window,
           float softcap, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D, KEEP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, BH);
  flash_kernel<T, D, KEEP><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Sk, rep, causal,
      window, softcap, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ bf16: tensor cores
namespace mma {

using bf16 = __nv_bfloat16;

constexpr int BQ = 128;             // query rows a block: 16 a warp
constexpr int BK = 64;              // keys a KV tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;              // bf16 after each shared-memory row (16 bytes)
constexpr int NS = BK / 8;          // n-tiles of a warp's S
constexpr int KG = BK / 16;         // 16-key steps of a tile

template <int D>
constexpr int smem_bytes() {
  return (BQ + 4 * BK) * (D + PAD) * 2;   // Q, then 2 stages of K and 2 of V
}

using namespace tc;   // cp.async, ldmatrix, mma.sync, split3 (mma_bf16.cuh)

template <int D, bool KEEP>
__global__ void __launch_bounds__(THREADS, 1) flash_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ o32,
    float* __restrict__ lse, int Sq, int Sk, int rep, int causal, int window,
    float softcap, float scale) {
  constexpr int LD = D + PAD;
  constexpr int NO = D / 8;         // n-tiles of a warp's O
  extern __shared__ __align__(16) bf16 smem_bf16[];
  bf16* qs = smem_bf16;             // BQ x LD
  bf16* ks = qs + BQ * LD;          // 2 stages of BK x LD
  bf16* vs = ks + 2 * BK * LD;      // 2 stages of BK x LD

  const int bh = blockIdx.x;
  const int nq = (Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.y) * BQ;   // longest rows first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;          // fragment row, column pair
  const int qw = q0 + warp * 16;                    // the warp's first row
  const bf16* kb = k + (size_t)(bh / rep) * Sk * D;
  const bf16* vb = v + (size_t)(bh / rep) * Sk * D;

  // the KV tiles some row of this block can see
  const int q_last = min(q0 + BQ, Sq) - 1;
  int kt_end = (Sk + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, q_last / BK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;

  load_rows<D, PAD, THREADS>(qs, q + ((size_t)bh * Sq + q0) * D, min(BQ, Sq - q0), BQ);
  if (kt_begin < kt_end) {
    const int k0 = kt_begin * BK;
    load_rows<D, PAD, THREADS>(ks, kb + (size_t)k0 * D, min(BK, Sk - k0), BK);
    load_rows<D, PAD, THREADS>(vs, vb + (size_t)k0 * D, min(BK, Sk - k0), BK);
  }
  cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // the lane's two rows: qw + g (fragment entries 0, 1) and qw + g + 8 (2, 3)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int kt = kt_begin, st = 0; kt < kt_end; ++kt, st ^= 1) {
    if (kt + 1 < kt_end) {          // the next tile's copies fly meanwhile
      const int k1 = (kt + 1) * BK;
      load_rows<D, PAD, THREADS>(ks + (st ^ 1) * BK * LD, kb + (size_t)k1 * D,
                                 min(BK, Sk - k1), BK);
      load_rows<D, PAD, THREADS>(vs + (st ^ 1) * BK * LD, vb + (size_t)k1 * D,
                                 min(BK, Sk - k1), BK);
    }
    cp_async_commit();
    cp_async_wait_one();            // this tile has landed
    __syncthreads();

    const int k0 = kt * BK;
    const bf16* kt_s = ks + st * BK * LD;
    const bf16* vt_s = vs + st * BK * LD;
    // whether any row of the warp sees a key of the tile, and whether
    // some pair of the tile is masked
    const bool seen = qw < Sq && !(causal && k0 > qw + 15) &&
                      !(window > 0 && qw - (k0 + BK - 1) >= window);
    const bool edge = (causal && k0 + BK - 1 > qw) ||
                      (window > 0 && qw + 15 - k0 >= window) || k0 + BK > Sk;
    if (seen) {
      // S = Q K^T
      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        uint32_t a[4];
        ldsm_x4(a, qs + (warp * 16 + (lane & 15)) * LD + kd * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t b[4];
          ldsm_x4(b, kt_s + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kd * 16 +
                         ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], a, b[0], b[1]);
          mma_bf16(s[2 * np + 1], a, b[2], b[3]);
        }
      }

      // scale, cap, mask
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float x = s[n][c] * scale;
          if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
          if (edge) {
            const int qpos = qw + g + (c >> 1) * 8;
            const int kpos = k0 + n * 8 + tig * 2 + (c & 1);
            bool vis = kpos < Sk;
            if (causal) vis = vis && qpos >= kpos;
            if (window > 0) vis = vis && qpos - kpos < window;
            x = vis ? x : -INFINITY;
          }
          s[n][c] = x;
        }
      }

      // the online softmax update of the lane's two rows
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
      }
      float m_use[2], corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        m_use[r] = m_new == -INFINITY ? 0.f : m_new;
        corr[r] = expf(m[r] - m_use[r]);   // 0 while the row saw nothing
        m[r] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[n][c] = expf(s[n][c] - m_use[c >> 1]);   // 0 where masked
          sum[c >> 1] += s[n][c];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * corr[r] + sum[r];
      }

      // O = O corr + P V, P split into three bf16 terms; the tile's P V is
      // summed in fresh accumulators, which O takes by a fused multiply-add
      uint32_t p1[KG][4], p2[KG][4], p3[KG][4];
#pragma unroll
      for (int kk = 0; kk < KG; ++kk) {
        split3(s[2 * kk][0], s[2 * kk][1], p1[kk][0], p2[kk][0], p3[kk][0]);
        split3(s[2 * kk][2], s[2 * kk][3], p1[kk][1], p2[kk][1], p3[kk][1]);
        split3(s[2 * kk + 1][0], s[2 * kk + 1][1], p1[kk][2], p2[kk][2], p3[kk][2]);
        split3(s[2 * kk + 1][2], s[2 * kk + 1][3], p1[kk][3], p2[kk][3], p3[kk][3]);
      }
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < KG; ++kk) {
          uint32_t b[4];
          ldsm_x4_trans(b, vt_s + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                               dp * 16 + (lane >> 4) * 8);
          mma_bf16(t0, p3[kk], b[0], b[1]);
          mma_bf16(t1, p3[kk], b[2], b[3]);
          mma_bf16(t0, p2[kk], b[0], b[1]);
          mma_bf16(t1, p2[kk], b[2], b[3]);
          mma_bf16(t0, p1[kk], b[0], b[1]);
          mma_bf16(t1, p1[kk], b[2], b[3]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[2 * dp][c] = fmaf(acc[2 * dp][c], corr[c >> 1], t0[c]);
          acc[2 * dp + 1][c] = fmaf(acc[2 * dp + 1][c], corr[c >> 1], t1[c]);
        }
      }
    }
    __syncthreads();                // every warp is done with this stage
  }
  cp_async_wait_all();              // no copy outlives the block (no tile ran)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qw + g + r * 8;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    bf16* orow = o + ((size_t)bh * Sq + qpos) * D + tig * 2;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * r] / denom, acc[n][2 * r + 1] / denom);
    if (KEEP) {                     // the same quotients, before the rounding
      float* frow = o32 + ((size_t)bh * Sq + qpos) * D + tig * 2;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<float2*>(frow + n * 8) =
            make_float2(acc[n][2 * r] / denom, acc[n][2 * r + 1] / denom);
    }
    if (KEEP && tig == 0) lse[(size_t)bh * Sq + qpos] = m[r] + logf(l[r]);
  }
}

template <int D, bool KEEP>
int launch(const void* q, const void* k, const void* v, void* o, float* o32,
           float* lse, int BH, int rep, int Sq, int Sk, int causal, int window,
           float softcap, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<D, KEEP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (Sq + BQ - 1) / BQ);
  flash_mma_kernel<D, KEEP><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), o32, lse, Sq, Sk, rep,
      causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace mma

template <int D, bool KEEP>
int launch_k(const void* q, const void* k, const void* v, void* o, float* o32,
             float* lse, int BH, int rep, int Sq, int Sk, int bf16, int causal,
             int window, float softcap, float scale, cudaStream_t stream) {
  return bf16 ? mma::launch<D, KEEP>(q, k, v, o, o32, lse, BH, rep, Sq, Sk, causal,
                                     window, softcap, scale, stream)
              : launch<float, D, KEEP>(q, k, v, o, lse, BH, rep, Sq, Sk, causal,
                                       window, softcap, scale, stream);
}

// KEEP (lse, and o32 for bf16, given) is a separate instantiation, so the
// forward without them compiles as it did before they existed
template <int D>
int launch_d(const void* q, const void* k, const void* v, void* o, float* o32,
             float* lse, int BH, int rep, int Sq, int Sk, int bf16, int causal,
             int window, float softcap, float scale, cudaStream_t stream) {
  return lse != nullptr
             ? launch_k<D, true>(q, k, v, o, o32, lse, BH, rep, Sq, Sk, bf16, causal,
                                 window, softcap, scale, stream)
             : launch_k<D, false>(q, k, v, o, o32, lse, BH, rep, Sq, Sk, bf16, causal,
                                  window, softcap, scale, stream);
}

}  // namespace

// q (BH, Sq, D), k and v (BHk, Sk, D), o (BH, Sq, D), all contiguous, of
// one dtype: bf16 when `bf16` is 1 (the tensor-core kernel), else fp32
// (the SIMT kernel). BH must be a multiple of BHk and D one of 32, 64,
// 128, 256. For the backward, lse (BH, Sq) fp32 takes each row's
// log-sum-exp m + log(l), and o32 (BH, Sq, D), bf16 only, the fp32
// quotients that o rounds (an fp32 o is its own); null pointers write
// neither and leave the arithmetic as it is. Returns the CUDA error code
// of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* o32,
                                      void* lse, int BH, int BHk, int Sq,
                                      int Sk, int D, int bf16, int causal,
                                      int window, float softcap, float scale,
                                      void* stream) {
  if (BH <= 0 || BHk <= 0 || BH % BHk != 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  // o32 comes with lse for bf16 and never for fp32 (its o is fp32)
  if ((o32 != nullptr) != (lse != nullptr && bf16)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rep = BH / BHk;
  float* f = static_cast<float*>(o32);
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 32: return launch_d<32>(q, k, v, o, f, l, BH, rep, Sq, Sk, bf16, causal, window, softcap, scale, s);
    case 64: return launch_d<64>(q, k, v, o, f, l, BH, rep, Sq, Sk, bf16, causal, window, softcap, scale, s);
    case 128: return launch_d<128>(q, k, v, o, f, l, BH, rep, Sq, Sk, bf16, causal, window, softcap, scale, s);
    case 256: return launch_d<256>(q, k, v, o, f, l, BH, rep, Sq, Sk, bf16, causal, window, softcap, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
