// Masked batched syrk over a pre-gathered block, for engine="kernel".
//
// Replaces the Pallas TPU kernel repro/kernels/bpmf_syrk.py
// (masked_syrk_pallas). Per row r of a pre-gathered, pre-masked block:
//
//   prec_r = sum_w vm[r,w] vm[r,w]^T      (K x K, K in 16, 32, 64)
//   rhs_r  = sum_w rv[r,w] vm[r,w]
//
// Every entry is the fp32 rounding of an fp64 sum, taken in w order, of
// exact products (syrk_tile.cuh): the same bits as ref.masked_syrk_ref.
//
// Bound on an H100: a row reads W (K + 1) 4 B of vm and rv, writes
// (K + 1) K 4 B of prec and rhs, and does W (K (K + 1) + 2 K) flops at
// 67 TFLOP/s fp32. At K = 64 the K x K write (16.6 KB a row) outweighs
// what a narrow row reads (260 B a vector), and over the ChEMBL plans'
// buckets the sweep is bound by bytes, most of them written (chip_smoke.py
// computes the bound bucket by bucket). The fp64 sums cost W K^2 fused
// multiply-adds a row (every entry of the matrix, not its triangle), on
// the fp64 pipes at half the fp32 rate.
//
// Two paths, by the bucket's width W: rows up to the launcher's
// `narrow_max_w` (ops.SYRK_NARROW_MAX_W, 8; at most STAGE_FLOATS / K) take
// the narrow path. On an H100 it is the faster of the two on the ChEMBL
// buckets of width 1, 2, 4 and 8 (by 16-20%) and a few percent the slower
// from width 15 up (chip_smoke.py times both paths on every bucket up to
// 64 wide).
//
// Narrow rows (most of them: ChEMBL users have about 2 ratings). One row
// a block would leave the card with hundreds of thousands of short block
// lifetimes, each waiting on one load before its store. Here a persistent
// grid (enough blocks to fill every SM) walks groups of rows: a group is
// as many consecutive rows as fit STAGE_FLOATS staged floats, and since
// the block is (R, W, K) contiguous, one contiguous copy. Each block
// stages its next group with 16-byte cp.async while it writes the current
// one (double-buffered). The output is output-stationary: the block's
// threads walk the group's outputs in 4 x 4 tiles of each row's K x K
// matrix, each summed over its row's W vectors in fp64, in w order, just
// before its 16-byte stores (syrk_tile.cuh::stream_group, which the fused
// kernel's narrow path shares).
//
// Wide rows keep one block a row: 256 threads, each a (K/16)^2 tile of
// the sum in fp64, the row's vectors staged CHUNK at a time
// (syrk_tile.cuh::accumulate_chunk, which gather_syrk_seg's row blocks
// share), the row's sums leaving in one write.
//
// Both paths take R and W as they are: the wrapper pads nothing but the
// rank, and the last group or chunk is cut short where the rows or
// vectors end.
#include <cuda_runtime.h>

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
  __shared__ float rvs[CHUNK];
  double acc[K / 16][K / 16] = {};
  double racc = 0.0;
  const float* block = vm + (size_t)r * W * K;
  for (int w0 = 0; w0 < W; w0 += CHUNK) {
    const int n = min(CHUNK, W - w0);
    if (t < n) rvs[t] = rv[(size_t)r * W + w0 + t];
    for (int e = t; e < n * (K / 4); e += THREADS) {
      const int w = e / (K / 4), q = e % (K / 4);
      *reinterpret_cast<float4*>(g + w * K + q * 4) =
          repro::load4(block + (size_t)(w0 + w) * K + q * 4);
    }
    __syncthreads();
    repro::accumulate_chunk<K, false>(g, nullptr, rvs, n, acc, racc);
    __syncthreads();
  }
  repro::store_row<K, float>(prec + (size_t)r * K * K, rhs + (size_t)r * K, acc, racc);
}

// ------------------------------------------------------------ narrow rows

// floats of vectors a group stages (16 KB): 64 vectors at K = 64
constexpr int STAGE_FLOATS = 4096;

template <int K>
struct Stage {
  static constexpr int vectors = STAGE_FLOATS / K;
  static constexpr int floats = vectors * (K + 1);   // the vectors, then rv
};

// rows [r0, r0 + rows) of the block into one stage: rows * W vectors of
// vm and as many rv values, each a contiguous run in device memory
template <int K>
__device__ __forceinline__ void stage_group(float* stage, const float* vm,
                                            const float* rv, int r0, int rows,
                                            int W) {
  const size_t first = (size_t)r0 * W;
  const int n = rows * W;
  const float* src = vm + first * K;
  for (int e = threadIdx.x; e < n * (K / 4); e += THREADS)
    repro::cp_async16(stage + e * 4, src + (size_t)e * 4);
  float* rvs = stage + Stage<K>::vectors * K;
  for (int e = threadIdx.x; e < n; e += THREADS) repro::cp_async4(rvs + e, rv + first + e);
}

template <int K>
__global__ void __launch_bounds__(THREADS) masked_syrk_narrow_kernel(
    const float* __restrict__ vm, const float* __restrict__ rv,
    float* __restrict__ prec, float* __restrict__ rhs, int R, int W,
    int group) {
  extern __shared__ __align__(16) float smem[];
  const int n_groups = (R + group - 1) / group;
  int grp = blockIdx.x;
  if (grp >= n_groups) return;
  stage_group<K>(smem, vm, rv, grp * group, min(group, R - grp * group), W);
  repro::cp_async_commit();
  for (int it = 0; grp < n_groups; grp += gridDim.x, ++it) {
    const float* cur = smem + (it & 1) * Stage<K>::floats;
    const int next = grp + gridDim.x;
    if (next < n_groups)
      stage_group<K>(smem + ((it + 1) & 1) * Stage<K>::floats, vm, rv,
                     next * group, min(group, R - next * group), W);
    repro::cp_async_commit();
    repro::cp_async_wait_one();            // this group's copies have landed
    __syncthreads();
    const int r0 = grp * group;
    const float* rvs = cur + Stage<K>::vectors * K;
    repro::stream_group<K, false>(cur, rvs, rvs, min(group, R - r0), W,
                                  prec + (size_t)r0 * K * K, rhs + (size_t)r0 * K);
    __syncthreads();                       // before the next prefetch reuses it
  }
}

template <int K>
int launch_narrow(const float* vm, const float* rv, float* prec, float* rhs,
                  int R, int W, cudaStream_t st) {
  constexpr int bytes = 2 * Stage<K>::floats * 4;
  static int blocks = 0;                   // resident blocks on the whole card
  if (blocks == 0) {
    const int err = repro::resident_blocks(masked_syrk_narrow_kernel<K>, THREADS,
                                           bytes, &blocks);
    if (err != 0) return err;
  }
  const int group = Stage<K>::vectors / max(W, 1);
  const int n_groups = (R + group - 1) / group;
  masked_syrk_narrow_kernel<K><<<min(n_groups, blocks), THREADS, bytes, st>>>(
      vm, rv, prec, rhs, R, W, group);
  return (int)cudaGetLastError();
}

template <int K>
int launch(const float* vm, const float* rv, float* prec, float* rhs, int R,
           int W, int narrow_max_w, cudaStream_t st) {
  if (W <= min(narrow_max_w, Stage<K>::vectors))
    return launch_narrow<K>(vm, rv, prec, rhs, R, W, st);
  masked_syrk_kernel<K><<<R, THREADS, 0, st>>>(vm, rv, prec, rhs, R, W);
  return (int)cudaGetLastError();
}

}  // namespace

// vm (R, W, K), rv (R, W) -> prec (R, K, K), rhs (R, K), K in 16, 32, 64,
// all contiguous, vm 16-byte aligned. Rows of width W <= narrow_max_w (and
// at most 4,096 / K) take the narrow path, wider ones one block a row.
// Returns the CUDA error code of the launch (cudaErrorInvalidValue for
// another K or an empty block).
extern "C" int masked_syrk_launch(const float* vm, const float* rv,
                                  float* prec, float* rhs, int R, int W,
                                  int K, int narrow_max_w, void* stream) {
  if (R <= 0 || W < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 16: return launch<16>(vm, rv, prec, rhs, R, W, narrow_max_w, st);
    case 32: return launch<32>(vm, rv, prec, rhs, R, W, narrow_max_w, st);
    case 64: return launch<64>(vm, rv, prec, rhs, R, W, narrow_max_w, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
