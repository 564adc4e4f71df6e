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
// V in fp32 or bf16 (the sums are kept in fp64 either way, syrk_tile.cuh:
// rows over w in order, segments over rows in order, one rounding, the
// plain version's bits). K is a template parameter, instantiated for 16,
// 32 and 64; the wrapper pads another rank with zero columns, once per
// half-sweep in the sampler, and pads nothing else: R and W are taken as
// they are.
//
// Bound on an H100: bytes for a whole sweep. A narrow bucket writes 16 KiB
// of fp32 per row at K = 64 (one 64 x 64 matrix) and reads up to W * 256 B of
// gathered rows (each distinct row once), so it is bound by bytes at
// 3.35 TB/s; where rows repeat, as in the widest item bucket, the
// K (K + 1) + 2 K flops per rating of the symmetric product at 67 TFLOP/s
// fp32 (no tensor cores: the sweep stays IEEE fp32) take longer than the
// bytes. Over the ChEMBL plans' 16 buckets the bytes dominate. The fp64
// sums cost K^2 fused multiply-adds a rating on the fp64 pipes, at half
// the fp32 rate, which is what the widest item bucket's time rests on.
//
// Design. The TPU kernel walks rows in a sequential grid and accumulates
// each block's one-hot-reduced partials into the output range in place.
// Hopper runs blocks in parallel and in no order, so there are three paths:
//   * narrow identity buckets (every row its own segment, rows up to the
//     launcher's narrow_max_w = ops.SYRK_NARROW_MAX_W wide: ChEMBL's user
//     buckets of width 1-8, 360,000 rows). One block a row would spend the
//     sweep in block lifetimes, each waiting on one gather before its
//     16 KiB store. A persistent grid walks groups of rows (as many as fit
//     4,096 / K vectors, and each draw of a stack in turn): each block
//     stages its next group's mask, values and gathered V rows with
//     cp.async (16-byte pieces from
//     gathered addresses, 4-byte ones for the mask and values) while it
//     streams the current group's outputs, a thread a 4 x 4 tile of one
//     row's sum (syrk_tile.cuh::stream_group, shared with masked_syrk's
//     narrow path);
//   * wider identity buckets: one block a (row, draw), 256 threads each a
//     (K/16)^2 tile of the row's sum (syrk_tile.cuh::accumulate_chunk,
//     shared with masked_syrk's wide rows), the row's vectors gathered
//     CHUNK at a time by cp.async; the row's statistics go straight to
//     the output;
//   * the bucket whose items span several rows (ChEMBL's widest item
//     bucket: 1,481 rows, 159 items, one of them 284 rows): the same row
//     blocks write fp64 row partials to scratch, and a second pass sums
//     each segment's rows in row order, from segment offsets the host took
//     from the plan, a segment's K x K sum split over K * K / THREADS
//     blocks, one entry a thread. Splitting by rows keeps the largest
//     item's 145,000 vectors spread over the card; a block a segment
//     would leave that item on one SM.
// No atomics: the result is the same bits on every run, which the ring
// and allgather exchange modes rely on. Out-of-range ids are clamped, as
// an XLA gather clamps them.
//
// The "into" store (gather_syrk_seg_into_launch, one draw of V): the
// single-card sweep's posterior systems straight from the kernel. Where
// the plain store writes segment p's fp32 sums (S, s), it writes, at item
// item_ids[p] of the caller's (n_items, kt, kt) and (n_items, kt) buffers,
//
//   prec_all[item] = __fadd_rn(lam, __fmul_rn(alpha, S))
//   rhs_all[item]  = __fadd_rn(prior_rhs, __fmul_rn(alpha, s))
//
// entry by entry inside the true rank kt (V may be padded to the kernel's
// K): two roundings, no fused multiply-add, the bits of
// `prec_all[ids] += alpha * prec` on buffers that hold the prior. The
// plan partitions the items, so each system is written once, by the
// kernel, and nothing else passes over the buffers: at ChEMBL's 489,275
// systems of K = 64 the stores are 8.0 GB a sweep (plus lam and
// prior_rhs, read from cache; the caller copies the prior into the
// items no bucket covers). The epilogue is the stores' template
// parameter (syrk_tile.cuh), so the plain instantiations, which the
// distributed sampler, fold-in and the stacked draws take, compile to the
// plain store alone. The fp64 row partials of multi-row segments stay;
// segment_reduce_kernel's final write takes the epilogue.
#include "syrk_tile.cuh"

namespace {

using repro::CHUNK;
using repro::NoInto;
using repro::THREADS;

// The "into" epilogue: a segment's sums stored as its item's posterior
// system, inside the true rank kt. kFull (kt == K, the sweep's case): the
// plain store's vector widths, every entry inside; otherwise entry by
// entry, those inside kt. Two instantiations, not a branch in one: the
// narrow kernel's with both paths spilled at its 80 registers.
template <bool kFull>
struct IntoSystems {
  static constexpr bool enabled = true;
  float* prec_all;             // (n_items, kt, kt)
  float* rhs_all;              // (n_items, kt)
  const long long* item_ids;   // (P,): segment -> item
  const float* lam;            // (kt, kt)
  const float* prior_rhs;      // (kt,)
  float alpha;
  int kt;

  __device__ __forceinline__ float system(float prior, double s) const {
    return __fadd_rn(prior, __fmul_rn(alpha, (float)s));
  }

  // rows i0 .. i0 + R - 1 and columns j0 .. j0 + C - 1 of segment p's sum
  template <int K, int R, int C>
  __device__ __forceinline__ void tile(int p, int i0, int j0,
                                       const double (&acc)[R][C]) const {
    if constexpr (kFull) {
      float* out = prec_all + (size_t)item_ids[p] * (K * K);
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const int o = (i0 + u) * K + j0;
        if constexpr (C == 4) {
          const float4 l = __ldg(reinterpret_cast<const float4*>(lam + o));
          *reinterpret_cast<float4*>(out + o) =
              make_float4(system(l.x, acc[u][0]), system(l.y, acc[u][1]),
                          system(l.z, acc[u][2]), system(l.w, acc[u][3]));
        } else if constexpr (C == 2) {
          const float2 l = __ldg(reinterpret_cast<const float2*>(lam + o));
          *reinterpret_cast<float2*>(out + o) =
              make_float2(system(l.x, acc[u][0]), system(l.y, acc[u][1]));
        } else {
#pragma unroll
          for (int c = 0; c < C; ++c) out[o + c] = system(__ldg(lam + o + c), acc[u][c]);
        }
      }
    } else {
      float* out = prec_all + (size_t)item_ids[p] * kt * kt;
#pragma unroll
      for (int u = 0; u < R; ++u)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int i = i0 + u, j = j0 + c;
          if (i < kt && j < kt) out[i * kt + j] = system(__ldg(lam + i * kt + j), acc[u][c]);
        }
    }
  }

  // entry (i, j) of segment p's sum
  __device__ __forceinline__ void entry(int p, int i, int j, double s) const {
    if (kFull || (i < kt && j < kt))
      prec_all[((size_t)item_ids[p] * kt + i) * kt + j] = system(__ldg(lam + i * kt + j), s);
  }

  // rhs entries j0 .. j0 + C - 1 of segment p
  template <int K, int C>
  __device__ __forceinline__ void rhs(int p, int j0, const double (&acc)[C]) const {
    if constexpr (kFull && C == 4) {
      float* out = rhs_all + (size_t)item_ids[p] * K;
      const float4 l = __ldg(reinterpret_cast<const float4*>(prior_rhs + j0));
      *reinterpret_cast<float4*>(out + j0) =
          make_float4(system(l.x, acc[0]), system(l.y, acc[1]),
                      system(l.z, acc[2]), system(l.w, acc[3]));
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) rhs_entry(p, j0 + c, acc[c]);
    }
  }

  __device__ __forceinline__ void rhs_entry(int p, int j, double s) const {
    if (kFull || j < kt) rhs_all[(size_t)item_ids[p] * kt + j] = system(__ldg(prior_rhs + j), s);
  }
};

// 16-byte pieces of one vector of K values of T, and values a piece
template <int K, typename T>
struct Pieces {
  static constexpr int per_vector = K * (int)sizeof(T) / 16;
  static constexpr int values = 16 / (int)sizeof(T);
};

__device__ __forceinline__ long long clamp_id(int id, long long N) {
  return min(max((long long)id, 0LL), N - 1);
}

// n vectors V[idx[first + w]] (w < n) into x, and their mask and values,
// by a block of NTH threads
template <int K, typename T, int NTH>
__device__ __forceinline__ void gather_async(T* x, float* m, float* c,
                                             const int* idx, const float* val,
                                             const float* msk, const T* vs,
                                             long long N, size_t first, int n) {
  using Pc = Pieces<K, T>;
  for (int e = threadIdx.x; e < n * Pc::per_vector; e += NTH) {
    const int w = e / Pc::per_vector, q = e - w * Pc::per_vector;
    const long long id = clamp_id(idx[first + w], N);
    repro::cp_async16(x + w * K + q * Pc::values, vs + id * K + q * Pc::values);
  }
  for (int e = threadIdx.x; e < n; e += NTH) {
    repro::cp_async4(m + e, msk + first + e);
    repro::cp_async4(c + e, val + first + e);
  }
}

// ------------------------------------------------------------ narrow rows

// one stage of a narrow group: 4,096 / K vectors, then their mask and values
template <int K, typename T>
struct Stage {
  static constexpr int vectors = 4096 / K;
  static constexpr int vector_bytes = vectors * K * (int)sizeof(T);
  static constexpr int bytes = vector_bytes + 2 * vectors * 4;
};

template <int K, typename T>
__device__ __forceinline__ void stage_unit(unsigned char* stage, const int* idx,
                                           const float* val, const float* msk,
                                           const T* v, int R, int W, long long N,
                                           int group, int n_groups, int unit) {
  using St = Stage<K, T>;
  const int s = unit / n_groups, r0 = (unit - s * n_groups) * group;
  float* m = reinterpret_cast<float*>(stage + St::vector_bytes);
  gather_async<K, T, THREADS>(reinterpret_cast<T*>(stage), m, m + St::vectors, idx, val,
                     msk, v + (size_t)s * N * K, N, (size_t)r0 * W,
                     min(group, R - r0) * W);
}

template <int K, typename T, typename Into>
__global__ void __launch_bounds__(THREADS) gather_syrk_narrow_kernel(
    const int* __restrict__ idx, const float* __restrict__ val,
    const float* __restrict__ msk, const T* __restrict__ v,
    float* __restrict__ prec, float* __restrict__ rhs, int R, int W,
    long long N, int S, int group, Into into) {
  using St = Stage<K, T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_groups = (R + group - 1) / group, units = n_groups * S;
  int unit = blockIdx.x;
  if (unit >= units) return;
  stage_unit<K, T>(smem, idx, val, msk, v, R, W, N, group, n_groups, unit);
  repro::cp_async_commit();
  for (int it = 0; unit < units; unit += gridDim.x, ++it) {
    const int next = unit + gridDim.x;
    if (next < units)
      stage_unit<K, T>(smem + ((it + 1) & 1) * St::bytes, idx, val, msk, v, R, W,
                       N, group, n_groups, next);
    repro::cp_async_commit();
    repro::cp_async_wait_one();            // this unit's copies have landed
    __syncthreads();
    const unsigned char* cur = smem + (it & 1) * St::bytes;
    const float* m = reinterpret_cast<const float*>(cur + St::vector_bytes);
    const int s = unit / n_groups, r0 = (unit - s * n_groups) * group;
    const size_t out = (size_t)s * R + r0;
    repro::stream_group<K, true>(reinterpret_cast<const T*>(cur), m, m + St::vectors,
                                 min(group, R - r0), W, prec + out * K * K,
                                 rhs + out * K, into, r0);
    __syncthreads();                       // before the next prefetch reuses it
  }
}

template <int K, typename T, typename Into>
int launch_narrow(const int* idx, const float* val, const float* msk,
                  const T* v, float* prec, float* rhs, int R, int W,
                  long long N, int S, const Into& into, cudaStream_t st) {
  constexpr int bytes = 2 * Stage<K, T>::bytes;
  static int blocks = 0;                   // resident blocks on the whole card
  if (blocks == 0) {
    const int err = repro::resident_blocks(gather_syrk_narrow_kernel<K, T, Into>,
                                           THREADS, bytes, &blocks);
    if (err != 0) return err;
  }
  const int group = Stage<K, T>::vectors / max(W, 1);
  const long long units = (long long)((R + group - 1) / group) * S;
  const int grid = units < blocks ? (int)units : blocks;
  gather_syrk_narrow_kernel<K, T, Into><<<grid, THREADS, bytes, st>>>(
      idx, val, msk, v, prec, rhs, R, W, N, S, group, into);
  return (int)cudaGetLastError();
}

// -------------------------------------------------------------- a row a block

// A row a block (syrk_tile.cuh::accumulate_chunk, store_row, shared with
// masked_syrk's wide rows), each chunk of CHUNK vectors gathered with its
// mask and values by cp.async. Double-buffering the chunks took 100
// registers a thread at K = 64 and was slower than the parent's single
// buffer on the widest item bucket (PERF.md §6).
template <int K, typename T, typename OutT, typename Into>
__global__ void __launch_bounds__(THREADS) gather_syrk_rows_kernel(
    const int* __restrict__ idx, const float* __restrict__ val,
    const float* __restrict__ msk, const T* __restrict__ v,
    OutT* __restrict__ prec_rows, OutT* __restrict__ rhs_rows,
    int R, int W, long long N, Into into) {
  const int r = blockIdx.x, s = blockIdx.y;
  const T* vs = v + (size_t)s * N * K;
  __shared__ __align__(16) unsigned char land[CHUNK * K * sizeof(T)];
  __shared__ float m[CHUNK], c[CHUNK];
  T* g = reinterpret_cast<T*>(land);
  double acc[K / 16][K / 16] = {};
  double racc = 0.0;
  const size_t row = (size_t)r * W;
  for (int w0 = 0; w0 < W; w0 += CHUNK) {
    const int n = min(CHUNK, W - w0);
    gather_async<K, T, THREADS>(g, m, c, idx, val, msk, vs, N, row + w0, n);
    repro::cp_async_commit();
    repro::cp_async_wait_all();
    __syncthreads();
    repro::accumulate_chunk<K, true>(g, m, c, n, acc, racc);
    __syncthreads();                       // before the next chunk lands
  }
  const size_t out = (size_t)s * R + r;
  repro::store_row<K, OutT>(prec_rows + out * K * K, rhs_rows + out * K, acc, racc,
                            into, r);
}

// Pass 2: prec[s, p] = sum of prec_rows[s, seg_ptr[p] .. seg_ptr[p+1]) in
// row order (with an Into epilogue, segment p's system). blockIdx.y picks
// THREADS of the K x K entries.
template <int K, typename Into>
__global__ void __launch_bounds__(THREADS) segment_reduce_kernel(
    const double* __restrict__ prec_rows, const double* __restrict__ rhs_rows,
    const int* __restrict__ seg_ptr, float* __restrict__ prec,
    float* __restrict__ rhs, int R, int P, Into into) {
  const int p = blockIdx.x, q = blockIdx.y, s = blockIdx.z, t = threadIdx.x;
  const int r0 = seg_ptr[p], r1 = seg_ptr[p + 1];
  const size_t base = (size_t)s * R;
  const int e = q * THREADS + t;
  const bool do_rhs = q == 0 && t < K;
  double tot = 0.0, rtot = 0.0;
#pragma unroll 4
  for (int r = r0; r < r1; ++r) {
    tot += prec_rows[(base + r) * K * K + e];
    if (do_rhs) rtot += rhs_rows[(base + r) * K + t];
  }
  if constexpr (Into::enabled) {
    into.entry(p, e / K, e % K, tot);
    if (do_rhs) into.rhs_entry(p, t, rtot);
    return;
  }
  const size_t o = (size_t)s * P + p;
  prec[o * K * K + e] = (float)tot;
  if (do_rhs) rhs[o * K + t] = (float)rtot;
}

template <int K, typename T, typename Into>
int launch(const int* idx, const float* val, const float* msk, const T* v,
           void* rows_prec, void* rows_rhs, const int* seg_ptr, float* prec,
           float* rhs, int R, int W, long long N, int S, int P,
           int narrow_max_w, const Into& into, cudaStream_t st) {
  if (seg_ptr == nullptr && W <= min(narrow_max_w, Stage<K, T>::vectors))
    return launch_narrow<K, T>(idx, val, msk, v, prec, rhs, R, W, N, S, into, st);
  const dim3 grid(R, S);
  if (seg_ptr == nullptr) {
    gather_syrk_rows_kernel<K, T, float, Into><<<grid, THREADS, 0, st>>>(
        idx, val, msk, v, prec, rhs, R, W, N, into);
    return (int)cudaGetLastError();
  }
  gather_syrk_rows_kernel<K, T, double, NoInto><<<grid, THREADS, 0, st>>>(
      idx, val, msk, v, static_cast<double*>(rows_prec),
      static_cast<double*>(rows_rhs), R, W, N, NoInto{});
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  segment_reduce_kernel<K, Into><<<dim3(P, K * K / THREADS, S), THREADS, 0, st>>>(
      static_cast<const double*>(rows_prec), static_cast<const double*>(rows_rhs),
      seg_ptr, prec, rhs, R, P, into);
  return (int)cudaGetLastError();
}

template <int K, typename Into>
int launch_rank(const int* idx, const float* val, const float* msk,
                const void* v, int v_bf16, void* rows_prec, void* rows_rhs,
                const int* seg_ptr, float* prec, float* rhs, int R, int W,
                long long N, int S, int P, int narrow_max_w, const Into& into,
                cudaStream_t st) {
  if (v_bf16)
    return launch<K>(idx, val, msk, static_cast<const __nv_bfloat16*>(v), rows_prec,
                     rows_rhs, seg_ptr, prec, rhs, R, W, N, S, P, narrow_max_w, into, st);
  return launch<K>(idx, val, msk, static_cast<const float*>(v), rows_prec,
                   rows_rhs, seg_ptr, prec, rhs, R, W, N, S, P, narrow_max_w, into, st);
}

template <typename Into>
int launch_any(const int* idx, const float* val, const float* msk, const void* v,
               int v_bf16, void* rows_prec, void* rows_rhs, const int* seg_ptr,
               float* prec, float* rhs, int R, int W, long long N, int S, int P,
               int K, int narrow_max_w, const Into& into, void* stream) {
  if (R <= 0 || W < 0 || N <= 0 || S <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 16: return launch_rank<16>(idx, val, msk, v, v_bf16, rows_prec, rows_rhs,
                                    seg_ptr, prec, rhs, R, W, N, S, P, narrow_max_w,
                                    into, st);
    case 32: return launch_rank<32>(idx, val, msk, v, v_bf16, rows_prec, rows_rhs,
                                    seg_ptr, prec, rhs, R, W, N, S, P, narrow_max_w,
                                    into, st);
    case 64: return launch_rank<64>(idx, val, msk, v, v_bf16, rows_prec, rows_rhs,
                                    seg_ptr, prec, rhs, R, W, N, S, P, narrow_max_w,
                                    into, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// idx, val, msk: (R, W), contiguous; v: (S, N, K) fp32, or bf16 when
// v_bf16 != 0, contiguous and 16-byte aligned, with K in 16, 32, 64.
// With seg_ptr == nullptr (an identity bucket) prec, rhs are (S, R, K, K),
// (S, R, K) and rows_prec, rows_rhs are unused; rows up to narrow_max_w
// wide (and at most 4,096 / K) take the narrow path. Otherwise seg_ptr
// (P + 1) holds the segment offsets, rows_prec, rows_rhs are fp64 scratch
// of (S, R, K, K), (S, R, K), and prec, rhs (S, P, K, K), (S, P, K)
// receive the segment sums. Returns the CUDA error code of the launches
// (cudaErrorInvalidValue for another K or an empty bucket).
extern "C" int gather_syrk_seg_launch(
    const int* idx, const float* val, const float* msk, const void* v,
    int v_bf16, void* rows_prec, void* rows_rhs, const int* seg_ptr,
    float* prec, float* rhs, int R, int W, long long N, int S, int P,
    int K, int narrow_max_w, void* stream) {
  return launch_any(idx, val, msk, v, v_bf16, rows_prec, rows_rhs, seg_ptr, prec, rhs,
                    R, W, N, S, P, K, narrow_max_w, NoInto{}, stream);
}

// The "into" store for one draw of V (S = 1): the arguments of
// gather_syrk_seg_launch but prec and rhs, then the systems. prec_all,
// rhs_all: (n_items, kt, kt) and (n_items, kt) fp32, contiguous, 16-byte
// aligned, 1 <= kt <= K; item_ids (P,) int64, one item a segment, no item
// twice; lam (kt, kt) and prior_rhs (kt,) fp32, contiguous, 16-byte
// aligned. Segment p's system is written at item_ids[p]; nothing else of
// prec_all and rhs_all is touched.
extern "C" int gather_syrk_seg_into_launch(
    const int* idx, const float* val, const float* msk, const void* v,
    int v_bf16, void* rows_prec, void* rows_rhs, const int* seg_ptr,
    float* prec_all, float* rhs_all, const long long* item_ids, const float* lam,
    const float* prior_rhs, float alpha, int kt, int R, int W, long long N, int P,
    int K, int narrow_max_w, void* stream) {
  if (kt < 1 || kt > K) return (int)cudaErrorInvalidValue;
  if (kt == K)
    return launch_any(idx, val, msk, v, v_bf16, rows_prec, rows_rhs, seg_ptr, nullptr,
                      nullptr, R, W, N, 1, P, K, narrow_max_w,
                      IntoSystems<true>{prec_all, rhs_all, item_ids, lam, prior_rhs, alpha, kt},
                      stream);
  return launch_any(idx, val, msk, v, v_bf16, rows_prec, rows_rhs, seg_ptr, nullptr,
                    nullptr, R, W, N, 1, P, K, narrow_max_w,
                    IntoSystems<false>{prec_all, rhs_all, item_ids, lam, prior_rhs, alpha, kt},
                    stream);
}
