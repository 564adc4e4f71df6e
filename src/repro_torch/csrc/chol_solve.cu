// Batched Cholesky factor + solve + sample, for engine="kernel".
//
// Replaces the Pallas TPU kernel repro/kernels/chol_solve.py
// (chol_solve_sample_pallas). Per K x K system (K = 64):
//
//   Lambda = L L^T   (column Cholesky, diagonal clamped at 1e-20)
//   L y = b,  then  L^T x = y + z      so  x = Lambda^-1 b + L^-T z
//
// which draws one factor from N(Lambda^-1 b, Lambda^-1) with no inverse
// formed. A system that is not positive definite is not an error: the
// clamp keeps the arithmetic going, as in the reference kernel.
//
// Bound on an H100: bytes. A Cholesky needs only the lower triangle of a
// system's precision, 9 KiB in whole 32-byte sectors, with 512 B of rhs
// and noise, and writes 256 B; its ~K^3 / 3 + 2 K^2 flops at 67 TFLOP/s
// fp32 take about half the 3.35 TB/s time of those bytes.
//
// Design. One warp per system, the matrix held in registers: lane l keeps
// rows l and l + 32 (two arrays of K floats, indexed only by unrolled
// constants so they stay in registers). The matrix arrives through shared
// memory so the global read is coalesced. The factorisation is
// right-looking: after column j is scaled, it is published in shared
// memory and every lane updates its two rows with it. The forward solve
// runs by columns (each lane updates its own right-hand side entries);
// the back solve by rows of L^T, with a fixed-order warp reduction, so the
// result is the same bits on every run. The batch is rounded up to the
// reference's tile (16, or 8 below 16 systems); the systems past its end
// are identity systems made in registers, not copied.
#include <cuda_runtime.h>

namespace {

constexpr int K = 64;
constexpr int WARPS = 2;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__global__ void __launch_bounds__(WARPS * 32) chol_solve_kernel(
    const float* __restrict__ prec, const float* __restrict__ rhs,
    const float* __restrict__ z, float* __restrict__ out, int B, int Bp) {
  __shared__ float tile[WARPS][K * (K + 1)];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= Bp) return;  // only warp-level synchronisation below
  float* sm = tile[warp];
  const int r0 = lane, r1 = lane + 32;
  float a0[K], a1[K];
  float b0 = 0.f, b1 = 0.f, z0 = 0.f, z1 = 0.f;
  if (b < B) {
    const float4* A = reinterpret_cast<const float4*>(prec + (size_t)b * K * K);
    for (int q = lane; q < K * K / 4; q += 32) {
      const float4 x = __ldg(A + q);
      float* d = sm + ((4 * q) / K) * (K + 1) + (4 * q) % K;
      d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      a0[k] = sm[r0 * (K + 1) + k];
      a1[k] = sm[r1 * (K + 1) + k];
    }
    b0 = rhs[(size_t)b * K + r0];
    b1 = rhs[(size_t)b * K + r1];
    z0 = z[(size_t)b * K + r0];
    z1 = z[(size_t)b * K + r1];
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      a0[k] = k == r0 ? 1.f : 0.f;
      a1[k] = k == r1 ? 1.f : 0.f;
    }
  }
  __syncwarp();
  float* col = sm;  // the tile is free once the rows are in registers

  // Cholesky: after step j, a0[j] = L[r0][j] and a1[j] = L[r1][j]
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float ajj = __shfl_sync(FULL, j < 32 ? a0[j] : a1[j], j & 31);
    const float d = sqrtf(fmaxf(ajj, 1e-20f));
    const float l0 = r0 >= j ? a0[j] / d : 0.f;
    const float l1 = r1 >= j ? a1[j] / d : 0.f;
    a0[j] = l0;
    a1[j] = l1;
    if (j + 1 < K) {
      col[r0] = l0;
      col[r1] = l1;
      __syncwarp();
#pragma unroll
      for (int k = j + 1; k < K; ++k) {
        const float lk = col[k];
        a0[k] = fmaf(-l0, lk, a0[k]);
        a1[k] = fmaf(-l1, lk, a1[k]);
      }
      __syncwarp();
    }
  }

  // forward: L y = b, by columns
  float y0 = 0.f, y1 = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float ljj = __shfl_sync(FULL, j < 32 ? a0[j] : a1[j], j & 31);
    const float bj = __shfl_sync(FULL, j < 32 ? b0 : b1, j & 31);
    const float yj = bj / ljj;
    if (r0 == j) y0 = yj;
    if (r1 == j) y1 = yj;
    b0 = fmaf(-a0[j], yj, b0);
    b1 = fmaf(-a1[j], yj, b1);
  }

  // back: L^T x = y + z, by rows of L^T (columns of L)
  const float c0 = y0 + z0, c1 = y1 + z1;
  float x0 = 0.f, x1 = 0.f;
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    const float s = warp_sum(a0[j] * x0 + a1[j] * x1);
    const float ljj = __shfl_sync(FULL, j < 32 ? a0[j] : a1[j], j & 31);
    const float cj = __shfl_sync(FULL, j < 32 ? c0 : c1, j & 31);
    const float xj = (cj - s) / ljj;
    if (r0 == j) x0 = xj;
    if (r1 == j) x1 = xj;
  }
  out[(size_t)b * K + r0] = x0;
  out[(size_t)b * K + r1] = x1;
}

}  // namespace

// prec (B, K, K), rhs and z (B, K) -> out (Bp, K); systems B .. Bp-1 are
// identity systems. Returns the CUDA error code of the launch.
extern "C" int chol_solve_sample_launch(const float* prec, const float* rhs,
                                        const float* z, float* out, int B,
                                        int Bp, void* stream) {
  const int blocks = (Bp + WARPS - 1) / WARPS;
  chol_solve_kernel<<<blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      prec, rhs, z, out, B, Bp);
  return (int)cudaGetLastError();
}
