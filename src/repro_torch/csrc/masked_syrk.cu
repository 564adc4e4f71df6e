// Masked batched syrk over a pre-gathered block, for engine="kernel".
//
// Replaces the Pallas TPU kernel repro/kernels/bpmf_syrk.py
// (masked_syrk_pallas). Per row r of a pre-gathered, pre-masked block:
//
//   prec_r = sum_w vm[r,w] vm[r,w]^T      (K x K, K in 16, 32, 64)
//   rhs_r  = sum_w rv[r,w] vm[r,w]
//
// Bound on an H100: a row reads W (K + 1) 4 B of vm and rv, writes
// (K + 1) K 4 B of prec and rhs, and does W (K (K + 1) + 2 K) flops at
// 67 TFLOP/s fp32. Per vector the flops outweigh its bytes at 3.35 TB/s
// (at K = 64, 8,320 flops against 260 B), but the K x K write outweighs
// both in narrow rows; over the ChEMBL plans' buckets the sweep is bound by
// bytes (chip_smoke.py computes both, bucket by bucket).
//
// Design. The TPU grid walked W tiles in order and accumulated into the
// output block in place. Here one block owns one row and loops over W
// inside the block, CHUNK vectors at a time in shared memory, so nothing
// is accumulated across blocks and the row's sums leave in one write. The
// sums are kept in fp64 (syrk_tile.cuh).
#include "syrk_tile.cuh"

namespace {

using repro::CHUNK;
using repro::THREADS;

template <int K>
__global__ void __launch_bounds__(THREADS) masked_syrk_kernel(
    const float* __restrict__ vm, const float* __restrict__ rv,
    float* __restrict__ prec, float* __restrict__ rhs, int R, int W) {
  const int r = blockIdx.x, t = threadIdx.x;
  __shared__ __align__(16) float g[CHUNK * K];
  __shared__ float m[CHUNK], rvs[CHUNK];
  double acc[K / 16][K / 16] = {};
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
    repro::accumulate_chunk<K>(g, m, rvs, n, acc, racc);
    __syncthreads();
  }
  repro::store_row<K, float>(prec + (size_t)r * K * K, rhs + (size_t)r * K, acc, racc);
}

template <int K>
int launch(const float* vm, const float* rv, float* prec, float* rhs, int R,
           int W, cudaStream_t st) {
  masked_syrk_kernel<K><<<R, THREADS, 0, st>>>(vm, rv, prec, rhs, R, W);
  return (int)cudaGetLastError();
}

}  // namespace

// vm (R, W, K), rv (R, W) -> prec (R, K, K), rhs (R, K), K in 16, 32, 64.
// Returns the CUDA error code of the launch (cudaErrorInvalidValue for
// another K).
extern "C" int masked_syrk_launch(const float* vm, const float* rv,
                                  float* prec, float* rhs, int R, int W,
                                  int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 16: return launch<16>(vm, rv, prec, rhs, R, W, st);
    case 32: return launch<32>(vm, rv, prec, rhs, R, W, st);
    case 64: return launch<64>(vm, rv, prec, rhs, R, W, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
