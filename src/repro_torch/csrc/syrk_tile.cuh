// Shared pieces of the two syrk kernels (gather_syrk_seg.cu, masked_syrk.cu).
//
// One block of 256 threads computes one bucket row's K x K precision sum
// and K-vector rhs, for K in KERNEL_RANKS (16, 32, 64). Thread t owns the
// T x T tile (ti, tj) = (t / 16, t % 16) of the K x K sum, T = K / 16;
// threads t < K own rhs[t]. The row's W vectors are staged CHUNK at a time
// in shared memory. The wrappers pad any other rank up to the next one
// with zero columns: they add exact zeros to every sum, so the kept block
// is the same bits.
//
// The sums are kept in fp64. The product of two fp32 values is exact in
// fp64 and a sum of a few thousand such terms loses nothing an fp32 result
// can show, so each statistic leaves the kernel as the fp32 rounding of its
// (all but) exact value, whatever order the terms came in: never further
// from a float64 evaluation than an fp32 sum, and the same bits on every
// run. The inputs and the outputs stay IEEE fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr int THREADS = 256;
constexpr int CHUNK = 32;

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// T consecutive floats of shared memory, in one vector load where T allows.
template <int T>
__device__ __forceinline__ void load_tile(const float* p, float (&x)[T]) {
  if constexpr (T == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  } else if constexpr (T == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x; x[1] = a.y;
  } else {
    x[0] = p[0];
  }
}

// Adds sum_w (g_w m_w) g_w^T and sum_w (g_w m_w) rv_w over the first n
// staged vectors g[w * K .. w * K + K) to (acc, racc). g_w m_w is rounded to
// fp32 first, as the plain version masks the gathered block before the
// products.
template <int K>
__device__ __forceinline__ void accumulate_chunk(
    const float* __restrict__ g, const float* __restrict__ m,
    const float* __restrict__ rv, int n, double (&acc)[K / 16][K / 16],
    double& racc) {
  constexpr int T = K / 16;
  const int t = threadIdx.x, ti = t >> 4, tj = t & 15;
  for (int w = 0; w < n; ++w) {
    const float mw = m[w];
    float a[T], b[T];
    load_tile<T>(g + w * K + ti * T, a);
    load_tile<T>(g + w * K + tj * T, b);
    double am[T], bb[T];
#pragma unroll
    for (int i = 0; i < T; ++i) {
      am[i] = a[i] * mw;
      bb[i] = b[i];
    }
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int j = 0; j < T; ++j) acc[i][j] = fma(am[i], bb[j], acc[i][j]);
  }
  if (t < K) {
    for (int w = 0; w < n; ++w)
      racc = fma((double)(g[w * K + t] * m[w]), (double)rv[w], racc);
  }
}

// Writes the row's statistics, rounded to OutT (float for a result,
// double for a row partial that a segment sum still has to add up).
template <int K, typename OutT>
__device__ __forceinline__ void store_row(OutT* __restrict__ prec,
                                          OutT* __restrict__ rhs,
                                          const double (&acc)[K / 16][K / 16],
                                          double racc) {
  constexpr int T = K / 16;
  const int t = threadIdx.x, ti = t >> 4, tj = t & 15;
#pragma unroll
  for (int i = 0; i < T; ++i) {
    OutT* p = prec + (ti * T + i) * K + tj * T;
    if constexpr (sizeof(OutT) == 4 && T == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else if constexpr (sizeof(OutT) == 4 && T == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(acc[i][0], acc[i][1]);
    } else if constexpr (sizeof(OutT) == 8 && T >= 2) {
#pragma unroll
      for (int j = 0; j < T; j += 2)
        reinterpret_cast<double2*>(p)[j / 2] = make_double2(acc[i][j], acc[i][j + 1]);
    } else {
#pragma unroll
      for (int j = 0; j < T; ++j) p[j] = (OutT)acc[i][j];
    }
  }
  if (t < K) rhs[t] = (OutT)racc;
}

}  // namespace repro
