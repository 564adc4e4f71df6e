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
// in fp32, as the TPU kernel keeps them in VMEM scratch. q, k and v are
// bf16 or fp32 and are widened to fp32 as they land in shared memory; the
// products and P stay fp32 (P is never rounded to bf16).
//
// GQA: the kernel maps query row block bh to KV row block bh / (BH / BHk),
// so k and v come in with their own head count and are never repeated in
// device memory (the caller does not run _expand_kv).
//
// Bound on an H100 at the gemma2-2b forward's shapes, (BH = 8, S = 8,192,
// D = 256) bf16 with 4 KV heads: operations. The bytes are 101 MB (q, k,
// v read once, o written once), 0.030 ms at 3.35 TB/s. QK^T and PV take
// 2 D flops each for every visible pair: 137 GFLOP each for a global
// layer (S (S + 1) / 2 pairs a head), 103 GFLOP each for a local one
// (window 4,096). QK^T multiplies bf16 inputs, whose products are exact
// in fp32, so the card may run it on its tensor cores at 989 TFLOP/s with
// an fp32 accumulator; PV multiplies the fp32 P, which stays fp32, on the
// fp32 pipes at 67 TFLOP/s. That is 0.139 + 2.051 = 2.190 ms for a global
// layer and 0.104 + 1.539 = 1.643 ms for a local one (both products at
// the fp32 peak: 4.10 and 3.08 ms; both at the bf16 tensor peak: 0.278
// and 0.208 ms). This kernel runs both products on the fp32 pipes and
// takes 5.7x and 5.9x those bounds (chip_smoke.py on an NVIDIA H100 80GB
// HBM3 at 700 W).
//
// Design. The TPU grid walked the KV axis in order and carried the running
// statistics across grid steps. Here one block owns one (query tile,
// head) pair and the KV axis is a loop inside the block: nothing is
// carried between blocks, there are no atomics and no second pass. A
// block of 8 warps holds a 64-row Q tile in shared memory; each KV tile of
// 32 keys (one key a lane) is staged in shared memory, each warp scores
// its 8 rows against it, updates their running max and denominator with
// warp shuffles, writes its P rows to a private slice of shared memory and
// adds P V into the 8 x D accumulator it keeps in registers. Against the
// operation bound the design does two things: it skips every KV tile that
// lies wholly outside the causal and window bounds of the block's rows (a
// local layer visits 4,096 + 64 keys a row, not 8,192), and it issues the
// longest query tiles first so the causal imbalance does not leave a tail.
// The products run on the fp32 pipes, not the tensor cores: that is the
// lever a later kernel pulls.
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

template <>
struct Four<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load(const __nv_bfloat16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ __nv_bfloat16 to(float x) { return __float2bfloat16(x); }
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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Sq, int Sk, int rep, int causal, int window,
    float softcap, float scale) {
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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int rep, int Sq, int Sk, int causal, int window, float softcap,
           float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, BH);
  flash_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, rep, causal,
      window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int BH,
             int rep, int Sq, int Sk, int D, int causal, int window,
             float softcap, float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, BH, rep, Sq, Sk, causal, window, softcap, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, BH, rep, Sq, Sk, causal, window, softcap, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, BH, rep, Sq, Sk, causal, window, softcap, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, BH, rep, Sq, Sk, causal, window, softcap, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (BH, Sq, D), k and v (BHk, Sk, D), o (BH, Sq, D), all contiguous, of
// one dtype: bf16 when `bf16` is 1, else fp32. BH must be a multiple of
// BHk and D one of 32, 64, 128, 256. Returns the CUDA error code of the
// launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int BH, int BHk,
                                      int Sq, int Sk, int D, int bf16,
                                      int causal, int window, float softcap,
                                      float scale, void* stream) {
  if (BH <= 0 || BHk <= 0 || BH % BHk != 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rep = BH / BHk;
  return bf16 ? launch_d<__nv_bfloat16>(q, k, v, o, BH, rep, Sq, Sk, D, causal,
                                        window, softcap, scale, s)
              : launch_d<float>(q, k, v, o, BH, rep, Sq, Sk, D, causal, window,
                                softcap, scale, s);
}
