// Fused gather -> masked syrk -> segment reduce for the BPMF sweep.
//
// Replaces the Pallas TPU kernel repro/kernels/bpmf_gather_syrk.py
// (gather_syrk_seg_pallas). Per bucket row r with counterpart ids idx[r, :]:
//
//   prec_r = sum_w (m[r,w] V[idx[r,w]]) V[idx[r,w]]^T     (K x K)
//   rhs_r  = sum_w (m[r,w] V[idx[r,w]]) (val[r,w] m[r,w])
//
// then rows are summed into their segments (an item split across rows of
// the widest bucket), with an optional leading stack of S draws of V and
// V in fp32 or bf16 (the sums are kept in fp64 either way, syrk_tile.cuh).
// K is a template parameter, instantiated for 16, 32 and 64; the wrapper
// pads another rank with zero columns, once per half-sweep in the sampler.
//
// Bound on an H100: bytes for a whole sweep. A narrow bucket writes 16 KiB
// of fp32 per row at K = 64 (one 64 x 64 matrix) and reads up to W * 256 B of
// gathered rows (each distinct row once), so it is bound by bytes at
// 3.35 TB/s; where rows repeat, as in the widest item bucket, the
// K (K + 1) + 2 K flops per rating of the symmetric product at 67 TFLOP/s
// fp32 (no tensor cores: the sweep stays IEEE fp32) take longer than the
// bytes. Over the ChEMBL plans' 16 buckets the bytes dominate.
//
// Design. The TPU kernel walks rows in a sequential grid and accumulates
// each block's one-hot-reduced partials into the output range in place.
// Hopper runs blocks in parallel and in no order, so:
//   * pass 1: one block per (row, draw) gathers the row's vectors into
//     shared memory CHUNK at a time and computes the row's statistics. The
//     longest walk of any block is one row of W <= 512 vectors, never a
//     segment: the widest bucket's items span many rows (about 9 rows and
//     4,800 ratings an item in the ChEMBL profile), and a block that walked
//     a whole item there would leave most of the card idle.
//   * identity buckets (every row its own segment) write pass 1 straight
//     into the output, in one pass. The bucket whose items span several
//     rows writes fp64 row partials to scratch, and
//   * pass 2 sums each segment's rows in row order, from segment offsets
//     the host took from the plan. A segment's K x K sum is split over
//     K * K / THREADS blocks, one entry a thread.
// No atomics: the result is the same bits on every run, which the ring
// and allgather exchange modes rely on.
#include "syrk_tile.cuh"

namespace {

using repro::CHUNK;
using repro::THREADS;

template <int K, typename T, typename OutT>
__global__ void __launch_bounds__(THREADS) gather_syrk_rows_kernel(
    const int* __restrict__ idx, const float* __restrict__ val,
    const float* __restrict__ msk, const T* __restrict__ v,
    OutT* __restrict__ prec_rows, OutT* __restrict__ rhs_rows,
    int R, int W, long long N) {
  const int r = blockIdx.x, s = blockIdx.y, t = threadIdx.x;
  const T* vs = v + (size_t)s * N * K;
  __shared__ __align__(16) float g[CHUNK * K];
  __shared__ float m[CHUNK], rv[CHUNK];
  __shared__ long long j[CHUNK];
  double acc[K / 16][K / 16] = {};
  double racc = 0.0;
  const size_t row = (size_t)r * W;
  for (int w0 = 0; w0 < W; w0 += CHUNK) {
    const int n = min(CHUNK, W - w0);
    if (t < CHUNK) {
      const bool in = t < n;
      const float mm = in ? msk[row + w0 + t] : 0.f;
      m[t] = mm;
      rv[t] = in ? val[row + w0 + t] * mm : 0.f;
      // out-of-range ids are clamped, as an XLA gather clamps them
      const long long id = in ? (long long)idx[row + w0 + t] : 0;
      j[t] = min(max(id, 0LL), N - 1);
    }
    __syncthreads();
    for (int e = t; e < n * (K / 4); e += THREADS) {
      const int w = e / (K / 4), q = e % (K / 4);
      *reinterpret_cast<float4*>(g + w * K + q * 4) = repro::load4(vs + j[w] * K + q * 4);
    }
    __syncthreads();
    repro::accumulate_chunk<K>(g, m, rv, n, acc, racc);
    __syncthreads();
  }
  const size_t out = (size_t)s * R + r;
  repro::store_row<K, OutT>(prec_rows + out * K * K, rhs_rows + out * K, acc, racc);
}

// Pass 2: prec[s, p] = sum of prec_rows[s, seg_ptr[p] .. seg_ptr[p+1]) in
// row order. blockIdx.y picks THREADS of the K x K entries.
template <int K>
__global__ void __launch_bounds__(THREADS) segment_reduce_kernel(
    const double* __restrict__ prec_rows, const double* __restrict__ rhs_rows,
    const int* __restrict__ seg_ptr, float* __restrict__ prec,
    float* __restrict__ rhs, int R, int P) {
  const int p = blockIdx.x, q = blockIdx.y, s = blockIdx.z, t = threadIdx.x;
  const int r0 = seg_ptr[p], r1 = seg_ptr[p + 1];
  const size_t base = (size_t)s * R;
  const int e = q * THREADS + t;
  const bool do_rhs = q == 0 && t < K;
  double tot = 0.0, rtot = 0.0;
  for (int r = r0; r < r1; ++r) {
    tot += prec_rows[(base + r) * K * K + e];
    if (do_rhs) rtot += rhs_rows[(base + r) * K + t];
  }
  const size_t o = (size_t)s * P + p;
  prec[o * K * K + e] = (float)tot;
  if (do_rhs) rhs[o * K + t] = (float)rtot;
}

template <int K, typename T>
int launch(const int* idx, const float* val, const float* msk, const T* v,
           void* rows_prec, void* rows_rhs, const int* seg_ptr, float* prec,
           float* rhs, int R, int W, long long N, int S, int P, cudaStream_t st) {
  const dim3 grid(R, S);
  if (seg_ptr == nullptr) {
    gather_syrk_rows_kernel<K, T, float><<<grid, THREADS, 0, st>>>(
        idx, val, msk, v, prec, rhs, R, W, N);
    return (int)cudaGetLastError();
  }
  gather_syrk_rows_kernel<K, T, double><<<grid, THREADS, 0, st>>>(
      idx, val, msk, v, static_cast<double*>(rows_prec),
      static_cast<double*>(rows_rhs), R, W, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  segment_reduce_kernel<K><<<dim3(P, K * K / THREADS, S), THREADS, 0, st>>>(
      static_cast<const double*>(rows_prec), static_cast<const double*>(rows_rhs),
      seg_ptr, prec, rhs, R, P);
  return (int)cudaGetLastError();
}

template <int K>
int launch_rank(const int* idx, const float* val, const float* msk,
                const void* v, int v_bf16, void* rows_prec, void* rows_rhs,
                const int* seg_ptr, float* prec, float* rhs, int R, int W,
                long long N, int S, int P, cudaStream_t st) {
  if (v_bf16)
    return launch<K>(idx, val, msk, static_cast<const __nv_bfloat16*>(v), rows_prec,
                     rows_rhs, seg_ptr, prec, rhs, R, W, N, S, P, st);
  return launch<K>(idx, val, msk, static_cast<const float*>(v), rows_prec,
                   rows_rhs, seg_ptr, prec, rhs, R, W, N, S, P, st);
}

}  // namespace

// idx, val, msk: (R, W); v: (S, N, K) fp32, or bf16 when v_bf16 != 0, with
// K in 16, 32, 64 (cudaErrorInvalidValue for another).
// With seg_ptr == nullptr (an identity bucket) prec, rhs are (S, R, K, K),
// (S, R, K) and rows_prec, rows_rhs are unused. Otherwise seg_ptr (P + 1)
// holds the segment offsets, rows_prec, rows_rhs are fp64 scratch of
// (S, R, K, K), (S, R, K), and prec, rhs (S, P, K, K), (S, P, K) receive the
// segment sums. Returns the CUDA error code of the launches.
extern "C" int gather_syrk_seg_launch(
    const int* idx, const float* val, const float* msk, const void* v,
    int v_bf16, void* rows_prec, void* rows_rhs, const int* seg_ptr,
    float* prec, float* rhs, int R, int W, long long N, int S, int P,
    int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 16: return launch_rank<16>(idx, val, msk, v, v_bf16, rows_prec, rows_rhs,
                                    seg_ptr, prec, rhs, R, W, N, S, P, st);
    case 32: return launch_rank<32>(idx, val, msk, v, v_bf16, rows_prec, rows_rhs,
                                    seg_ptr, prec, rhs, R, W, N, S, P, st);
    case 64: return launch_rank<64>(idx, val, msk, v, v_bf16, rows_prec, rows_rhs,
                                    seg_ptr, prec, rhs, R, W, N, S, P, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
