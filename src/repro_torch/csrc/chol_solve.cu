// Batched Cholesky factor + solve + sample, for engine="kernel".
//
// Replaces the Pallas TPU kernel repro/kernels/chol_solve.py
// (chol_solve_sample_pallas). Per K x K system (K in 16, 32, 64):
//
//   Lambda = L L^T   (column Cholesky, diagonal clamped at 1e-20)
//   L y = b,  then  L^T x = y + z      so  x = Lambda^-1 b + L^-T z
//
// which draws one factor from N(Lambda^-1 b, Lambda^-1) with no inverse
// formed. A system that is not positive definite is not an error: the
// clamp keeps the arithmetic going, as in the reference kernel.
//
// Bound on an H100: bytes. A Cholesky needs only the lower triangle of a
// system's precision (at K = 64, 9 KiB in whole 32-byte sectors), with
// 8 K B of rhs and noise, and writes 4 K B; its ~K^3 / 3 + 2 K^2 flops at
// 67 TFLOP/s fp32 take about half the 3.35 TB/s time of those bytes.
//
// Design. One warp per system, the matrix held in registers: lane l keeps
// rows l + 32 i for i < ceil(K / 32) (arrays of K floats, indexed only by
// unrolled constants so they stay in registers); at K = 16 lanes 16-31
// hold nothing. The matrix arrives through shared memory so the global
// read is coalesced. The factorisation is right-looking: after column j is
// scaled, it is published in shared memory and every lane updates its
// rows with it. The forward solve runs by columns (each lane updates its
// own right-hand side entries); the back solve by rows of L^T, with a
// fixed-order warp reduction, so the result is the same bits on every run.
// The batch is rounded up to the reference's tile (16, or 8 below 16
// systems); the systems past its end are identity systems made in
// registers, not copied. K is a template parameter instantiated for 16, 32
// and 64. The wrapper pads another rank with an identity block,
// [[P, 0], [0, I]], and zeros in rhs and z: the kept block's Cholesky and
// its two solves then do the same arithmetic, and the padded entries come
// out 0 (a zero-padded precision would be singular).
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 2;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

template <int K>
__global__ void __launch_bounds__(WARPS * 32) chol_solve_kernel(
    const float* __restrict__ prec, const float* __restrict__ rhs,
    const float* __restrict__ z, float* __restrict__ out, int B, int Bp) {
  constexpr int RL = (K + 31) / 32;  // rows a lane keeps
  __shared__ float tile[WARPS][K * (K + 1)];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= Bp) return;  // only warp-level synchronisation below
  float* sm = tile[warp];
  int row[RL];
  bool mine[RL];
#pragma unroll
  for (int i = 0; i < RL; ++i) {
    row[i] = lane + 32 * i;
    mine[i] = row[i] < K;
  }
  float a[RL][K];
  float bv[RL], zv[RL];
  if (b < B) {
    const float4* A = reinterpret_cast<const float4*>(prec + (size_t)b * K * K);
    for (int q = lane; q < K * K / 4; q += 32) {
      const float4 x = __ldg(A + q);
      float* d = sm + ((4 * q) / K) * (K + 1) + (4 * q) % K;
      d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < RL; ++i) {
#pragma unroll
      for (int k = 0; k < K; ++k) a[i][k] = mine[i] ? sm[row[i] * (K + 1) + k] : 0.f;
      bv[i] = mine[i] ? rhs[(size_t)b * K + row[i]] : 0.f;
      zv[i] = mine[i] ? z[(size_t)b * K + row[i]] : 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < RL; ++i) {
#pragma unroll
      for (int k = 0; k < K; ++k) a[i][k] = k == row[i] ? 1.f : 0.f;
      bv[i] = zv[i] = 0.f;
    }
  }
  __syncwarp();
  float* col = sm;  // the tile is free once the rows are in registers

  // Cholesky: after step j, a[i][j] = L[row[i]][j]
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float ajj = __shfl_sync(FULL, a[j >> 5][j], j & 31);
    const float d = sqrtf(fmaxf(ajj, 1e-20f));
    float l[RL];
#pragma unroll
    for (int i = 0; i < RL; ++i) {
      l[i] = row[i] >= j ? a[i][j] / d : 0.f;
      a[i][j] = l[i];
    }
    if (j + 1 < K) {
#pragma unroll
      for (int i = 0; i < RL; ++i)
        if (mine[i]) col[row[i]] = l[i];
      __syncwarp();
#pragma unroll
      for (int k = j + 1; k < K; ++k) {
        const float lk = col[k];
#pragma unroll
        for (int i = 0; i < RL; ++i) a[i][k] = fmaf(-l[i], lk, a[i][k]);
      }
      __syncwarp();
    }
  }

  // forward: L y = b, by columns
  float y[RL];
#pragma unroll
  for (int i = 0; i < RL; ++i) y[i] = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float ljj = __shfl_sync(FULL, a[j >> 5][j], j & 31);
    const float bj = __shfl_sync(FULL, bv[j >> 5], j & 31);
    const float yj = bj / ljj;
#pragma unroll
    for (int i = 0; i < RL; ++i) {
      if (row[i] == j) y[i] = yj;
      bv[i] = fmaf(-a[i][j], yj, bv[i]);
    }
  }

  // back: L^T x = y + z, by rows of L^T (columns of L)
  float c[RL], x[RL];
#pragma unroll
  for (int i = 0; i < RL; ++i) {
    c[i] = y[i] + zv[i];
    x[i] = 0.f;
  }
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    float p = a[0][j] * x[0];
#pragma unroll
    for (int i = 1; i < RL; ++i) p += a[i][j] * x[i];
    const float s = warp_sum(p);
    const float ljj = __shfl_sync(FULL, a[j >> 5][j], j & 31);
    const float cj = __shfl_sync(FULL, c[j >> 5], j & 31);
    const float xj = (cj - s) / ljj;
#pragma unroll
    for (int i = 0; i < RL; ++i)
      if (row[i] == j) x[i] = xj;
  }
#pragma unroll
  for (int i = 0; i < RL; ++i)
    if (mine[i]) out[(size_t)b * K + row[i]] = x[i];
}

template <int K>
int launch(const float* prec, const float* rhs, const float* z, float* out,
           int B, int Bp, cudaStream_t st) {
  const int blocks = (Bp + WARPS - 1) / WARPS;
  chol_solve_kernel<K><<<blocks, WARPS * 32, 0, st>>>(prec, rhs, z, out, B, Bp);
  return (int)cudaGetLastError();
}

}  // namespace

// prec (B, K, K), rhs and z (B, K) -> out (Bp, K), K in 16, 32, 64
// (cudaErrorInvalidValue for another); systems B .. Bp-1 are identity
// systems. Returns the CUDA error code of the launch.
extern "C" int chol_solve_sample_launch(const float* prec, const float* rhs,
                                        const float* z, float* out, int B,
                                        int Bp, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 16: return launch<16>(prec, rhs, z, out, B, Bp, st);
    case 32: return launch<32>(prec, rhs, z, out, B, Bp, st);
    case 64: return launch<64>(prec, rhs, z, out, B, Bp, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
