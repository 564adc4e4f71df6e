// Masked batched syrk over a pre-gathered block, for engine="kernel".
//
// Replaces the Pallas TPU kernel repro/kernels/bpmf_syrk.py
// (masked_syrk_pallas). Per row r of a pre-gathered, pre-masked block:
//
//   prec_r = sum_w vm[r,w] vm[r,w]^T      (K x K, K = 64)
//   rhs_r  = sum_w rv[r,w] vm[r,w]
//
// Bound on an H100: bytes. Each row reads W * (K + 1) * 4 B of vm and rv
// and writes 16 KiB of prec; the K (K + 1) + 2 K flops of the symmetric
// product per vector at 67 TFLOP/s fp32 take less time than its 260 B at
// 3.35 TB/s, so every bucket is bound by bytes.
//
// Design. The TPU grid walked W tiles in order and accumulated into the
// output block in place. Here one block owns one row and loops over W
// inside the block, CHUNK vectors at a time in shared memory, so nothing
// is accumulated across blocks and the row's sums leave in one write. The
// sums are kept in fp64 (syrk_tile.cuh).
#include "syrk_tile.cuh"

namespace {

using repro::CHUNK;
using repro::K;
using repro::THREADS;

__global__ void __launch_bounds__(THREADS) masked_syrk_kernel(
    const float* __restrict__ vm, const float* __restrict__ rv,
    float* __restrict__ prec, float* __restrict__ rhs, int R, int W) {
  const int r = blockIdx.x, t = threadIdx.x;
  __shared__ __align__(16) float g[CHUNK * K];
  __shared__ float m[CHUNK], rvs[CHUNK];
  double acc[4][4] = {};
  double racc = 0.0;
  const float* block = vm + (size_t)r * W * K;
  for (int w0 = 0; w0 < W; w0 += CHUNK) {
    const int n = min(CHUNK, W - w0);
    if (t < CHUNK) {
      m[t] = t < n ? 1.f : 0.f;
      rvs[t] = t < n ? rv[(size_t)r * W + w0 + t] : 0.f;
    }
    for (int e = t; e < n * (K / 4); e += THREADS) {
      const int w = e / (K / 4), q = e % (K / 4);
      *reinterpret_cast<float4*>(g + w * K + q * 4) =
          repro::load4(block + (size_t)(w0 + w) * K + q * 4);
    }
    __syncthreads();
    repro::accumulate_chunk(g, m, rvs, n, acc, racc);
    __syncthreads();
  }
  repro::store_row<float>(prec + (size_t)r * K * K, rhs + (size_t)r * K, acc, racc);
}

}  // namespace

// vm (R, W, K), rv (R, W) -> prec (R, K, K), rhs (R, K). Returns the CUDA
// error code of the launch.
extern "C" int masked_syrk_launch(const float* vm, const float* rv,
                                  float* prec, float* rhs, int R, int W,
                                  void* stream) {
  masked_syrk_kernel<<<R, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      vm, rv, prec, rhs, R, W);
  return (int)cudaGetLastError();
}
