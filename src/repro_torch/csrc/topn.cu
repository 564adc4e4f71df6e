// Top-k of U V^T for BPMF serving: a tiled fp32 scoring pass, then a
// selection by threshold.
//
// Replaces the Pallas TPU kernel repro/kernels/bpmf_topn.py
// (topn_scores_pallas): for each user row u_b (D = S * K wide, the
// ensemble's scoring rows) the k best items of u_b . v_i over the
// catalogue, descending, ties to the lowest item index, as jax.lax.top_k
// orders them. The (B, N) score matrix never reaches device memory whole:
// the catalogue is scored in slabs of at most S items, whose (B, S) scores
// fit a scratch buffer that the wrapper bounds whatever N is.
//
// Arithmetic. Each score is summed over d in order with one rounded
// multiply and one rounded add a term (__fmul_rn, __fadd_rn: no FMA), the
// plain version's order in kernels/ref.py, so values and indices equal it
// bit for bit. The sum starts at +0.0, and under round-to-nearest adding
// anything to +0.0 or cancelling to zero gives +0.0, so no score is ever
// -0.0: the keys below never have to order -0.0 against +0.0, which the
// plain version's sort holds equal. A NaN score is keyed above +inf, where
// torch.sort puts NaN, ties among NaNs to the lowest index.
//
// Bound on an H100: operations. 2 B N D flops of fp32 (no tensor cores:
// the gate is IEEE fp32, no TF32) at 67 TFLOP/s, against (B + N) D * 4
// bytes read and B k * 8 written at 3.35 TB/s. Mul-then-add issues two
// instructions a term where an FMA issues one, so this function cannot
// run faster than twice that bound at the fp32 issue rate.
//
// Design.
//   * topn_score_kernel: a block owns 128 users x 128 items of a slab and
//     each thread an 8 x 8 micro-tile (rows ty*4 + {0..3} and 64 + ty*4 +
//     {0..3}, columns likewise from tx). Slices of 16 d of U and V rows are
//     copied row-major into a double-buffered staging area with 16-byte
//     cp.async (D a multiple of 4: the wrapper pads it with zero columns
//     where it is not), the next slice in flight while the current one is
//     transposed once into [d][user] and [d][item] tiles and multiplied:
//     per d a thread loads four float4 and issues 128 fp32 instructions.
//     Users, items and d past the ends are copied in as zeros: a zero
//     column adds +0.0 to a sum that is never -0.0, which leaves its bits
//     unchanged. The tile's scores go to the slab's scratch in float4
//     stores.
//   * topn_select_kernel: one block a user row. Each (score, index) pair is
//     one 64-bit key: order-preserving float bits above, the complemented
//     index below, so keys are unique and "key descending" is "score
//     descending, lowest index first". The candidates are the row's running
//     best from earlier slabs (earlier items) and the slab's items, whose
//     scores the block first copies to shared memory (the wrapper sizes
//     slabs so that they fit beside the k keys). A
//     radix select over the key bits, 8 at a time from the top, in a
//     256-bin shared-memory histogram, finds the shortest prefix whose bin
//     holds exactly the keys still wanted; the keys at or above it are
//     exactly the k best. They are compacted in any order; on the last
//     slab they are sorted once (bitonic: strides below 128 in registers,
//     four keys a lane, with warp shuffles; longer ones in shared memory)
//     and written out, on an earlier slab they become the running best.
//     Pad items are never candidates.
// A call launches 2 kernels a slab; at the ChEMBL shape one slab holds the
// catalogue.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;  // users of a scoring tile
constexpr int BN = 128;  // items of a scoring tile
constexpr int BK = 16;   // depth of one staged slice
constexpr int SCORE_THREADS = 256;
constexpr int SELECT_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
static_assert(SELECT_THREADS == 256, "one histogram bin a thread");
// dynamic shared memory of a selection block: the k keys and the slab's
// scores of its row (at the ChEMBL shape 8 + 23 KB); kernels/ops.py sizes
// slabs to it (TOPN_SELECT_SMEM)
constexpr size_t MAX_SELECT_SMEM = 160 * 1024;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool in) {
  // a source size of 0 fills the 16 bytes with zeros and reads nothing
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared memory of a scoring block: the staging area (two slices of U and
// V rows, row-major) and the transposed slice being multiplied.
struct ScoreSmem {
  float us[2][BM][BK];
  float vs[2][BN][BK];
  float a[BK][BM];
  float b[BK][BN];
};

// scores[b, i] = u_b . v_(n0 + i) for the slab's items; u (B, D), v (N, D)
// row-major with D % 4 == 0; row stride of scores S. grid (items / BN,
// users / BM); dynamic shared memory sizeof(ScoreSmem).
__global__ void __launch_bounds__(SCORE_THREADS, 2) topn_score_kernel(
    const float* __restrict__ u, const float* __restrict__ v,
    float* __restrict__ scores, int B, int N, int D, int n0, int S) {
  extern __shared__ __align__(16) unsigned char score_smem[];
  ScoreSmem& sm = *reinterpret_cast<ScoreSmem*>(score_smem);
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int b0 = blockIdx.y * BM, i0 = n0 + blockIdx.x * BN;
  constexpr int QUADS = BK / 4;  // float4 of a row in a slice

  // a slice is 128 rows x QUADS float4 of each operand, the quads of a row
  // on neighbouring threads
  auto stage = [&](int buf, int d0) {
#pragma unroll
    for (int h = 0; h < BM * QUADS / SCORE_THREADS; ++h) {
      const int e = t + h * SCORE_THREADS, r = e / QUADS, q = e % QUADS;
      const int d = d0 + 4 * q;
      const bool ub = b0 + r < B && d < D, vb = i0 + r < N && d < D;
      cp_async16(&sm.us[buf][r][4 * q], u + (ub ? (size_t)(b0 + r) * D + d : 0), ub);
      cp_async16(&sm.vs[buf][r][4 * q], v + (vb ? (size_t)(i0 + r) * D + d : 0), vb);
    }
    cp_async_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = (D + BK - 1) / BK;
  const int lr = t & (BM - 1), lh = t >> 7;  // transpose: row, half of the slice
  stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      stage((kt + 1) & 1, (kt + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the slice has landed; the last products are done
    const int buf = kt & 1;
#pragma unroll
    for (int q = 0; q < QUADS / 2; ++q) {
      const int d = (BK / 2) * lh + 4 * q;
      const float4 x = *reinterpret_cast<const float4*>(&sm.us[buf][lr][d]);
      const float4 y = *reinterpret_cast<const float4*>(&sm.vs[buf][lr][d]);
      sm.a[d][lr] = x.x; sm.a[d + 1][lr] = x.y; sm.a[d + 2][lr] = x.z; sm.a[d + 3][lr] = x.w;
      sm.b[d][lr] = y.x; sm.b[d + 1][lr] = y.y; sm.b[d + 2][lr] = y.z; sm.b[d + 3][lr] = y.w;
    }
    __syncthreads();
#pragma unroll
    for (int d = 0; d < BK; ++d) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sm.a[d][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sm.a[d][64 + ty * 4]);
      const float4 c0 = *reinterpret_cast<const float4*>(&sm.b[d][tx * 4]);
      const float4 c1 = *reinterpret_cast<const float4*>(&sm.b[d][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(a[i], c[j]));
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = b0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= B) continue;
    float* out = scores + (size_t)r * S + blockIdx.x * BN;
    *reinterpret_cast<float4*>(out + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(out + 64 + tx * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

__device__ __forceinline__ unsigned long long make_key(float s, int item) {
  const unsigned bits = __float_as_uint(s);
  unsigned ord = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  if (s != s) ord = 0xffffffffu;  // NaN above +inf, as torch.sort orders it
  return ((unsigned long long)ord << 32) | (unsigned long long)(~(unsigned)item);
}

__device__ __forceinline__ float key_value(unsigned long long key) {
  const unsigned ord = (unsigned)(key >> 32);
  return __uint_as_float((ord & 0x80000000u) ? (ord & 0x7fffffffu) : ~ord);
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return (int)(~(unsigned)(key & 0xffffffffull));
}

__device__ __forceinline__ unsigned long long kmax(unsigned long long a,
                                                   unsigned long long b) {
  return a > b ? a : b;
}

__device__ __forceinline__ unsigned long long kmin(unsigned long long a,
                                                   unsigned long long b) {
  return a < b ? a : b;
}

// The bitonic stages of one `size` with strides from min(size / 2, 64)
// down to 1, on the 128 keys a warp holds in registers: x[q] at position
// base + lane + 32 q (base a multiple of 128). A pair's lower position
// keeps the larger key where the run of `size` sorts descending. Strides
// 64 and 32 pair a lane's own keys; shorter ones pair lanes.
__device__ __forceinline__ void warp_size_stages(unsigned long long (&x)[4],
                                                 int base, int size, int lane) {
  const int p = base + lane;
  bool desc[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) desc[q] = ((p + 32 * q) & size) == 0;
  auto cas = [](unsigned long long& lo, unsigned long long& hi, bool down) {
    if (down ? lo < hi : lo > hi) {
      const unsigned long long tmp = lo;
      lo = hi;
      hi = tmp;
    }
  };
  if (size >= 128) {
    cas(x[0], x[2], desc[0]);
    cas(x[1], x[3], desc[1]);
  }
  if (size >= 64) {
    cas(x[0], x[1], desc[0]);
    cas(x[2], x[3], desc[2]);
  }
  for (int stride = (size >> 1) < 16 ? size >> 1 : 16; stride > 0; stride >>= 1) {
    const bool lower = (lane & stride) == 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned long long y = __shfl_xor_sync(FULL, x[q], stride);
      x[q] = (lower == desc[q]) ? kmax(x[q], y) : kmin(x[q], y);
    }
  }
}

// The register stages of sizes size_lo .. size_hi on every 128-key run.
__device__ __forceinline__ void warp_stages(unsigned long long* keys, int L,
                                            int size_lo, int size_hi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = warp * 128; c < L; c += SELECT_THREADS * 4) {
    unsigned long long x[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) x[q] = keys[c + lane + 32 * q];
    for (int size = size_lo; size <= size_hi; size <<= 1)
      warp_size_stages(x, c, size, lane);
#pragma unroll
    for (int q = 0; q < 4; ++q) keys[c + lane + 32 * q] = x[q];
  }
}

// Sorts L keys (L a power of two) descending, in place.
__device__ void bitonic_sort_desc(unsigned long long* keys, int L) {
  const int half = L >> 1;
  auto smem_stage = [&](int size, int stride) {
    for (int q = threadIdx.x; q < half; q += SELECT_THREADS) {
      const int i = 2 * stride * (q / stride) + (q % stride), j = i + stride;
      const unsigned long long a = keys[i], c = keys[j];
      if ((i & size) == 0 ? a < c : a > c) {
        keys[i] = c;
        keys[j] = a;
      }
    }
    __syncthreads();
  };
  if (L < 128) {
    for (int size = 2; size <= L; size <<= 1)
      for (int stride = size >> 1; stride > 0; stride >>= 1) smem_stage(size, stride);
    return;
  }
  warp_stages(keys, L, 2, 128);  // every run of 128 sorted
  __syncthreads();
  for (int size = 256; size <= L; size <<= 1) {
    for (int stride = size >> 1; stride >= 128; stride >>= 1) smem_stage(size, stride);
    warp_stages(keys, L, size, size);
    __syncthreads();
  }
}

// One block a user row b. Candidates: best[b, 0 .. c_in) (the running best
// of the items before n0) and the slab's items n0 .. n0 + m - 1, scored in
// scores[b, 0 .. m). The k best candidates go to best[b] or, on the last
// slab, sorted to vals[b], idx[b]. Dynamic shared memory: kp keys (kp a
// power of two >= k), then the row's m scores.
__global__ void __launch_bounds__(SELECT_THREADS) topn_select_kernel(
    const float* __restrict__ scores, int S, int n0, int m,
    unsigned long long* __restrict__ best, int c_in, int k, int kp,
    int last, float* __restrict__ vals, int* __restrict__ idx) {
  extern __shared__ unsigned long long out[];
  __shared__ int hist[256];
  __shared__ int sel_digit, sel_rem, sel_cnt, n_out;
  const int b = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned long long* rb = best + (size_t)b * k;
  const int total = c_in + m;
  // the row's scores, read from the scratch once for every pass below
  float* row = reinterpret_cast<float*>(out + kp);
  for (int i = t; i < m; i += SELECT_THREADS) row[i] = scores[(size_t)b * S + i];
  __syncthreads();
  auto key_at = [&](int i) -> unsigned long long {
    return i < c_in ? rb[i] : make_key(row[i - c_in], n0 + i - c_in);
  };

  // the shortest key prefix whose bin holds exactly the keys still wanted;
  // with no more candidates than k, every key is taken (empty prefix)
  unsigned long long prefix = 0ull, mask = 0ull;
  if (total > k) {
    int rem = k;
    for (int shift = 56; shift >= 0; shift -= 8) {
      hist[t] = 0;  // SELECT_THREADS == 256 bins
      __syncthreads();
      for (int i = t; i < total; i += SELECT_THREADS) {
        const unsigned long long key = key_at(i);
        if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 0xffull], 1);
      }
      __syncthreads();
      if (warp == 0) {
        // lane l holds bins 255 - 8l down to 248 - 8l: a scan over lanes
        // walks the bins from the top
        int h[8], sum = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          h[j] = hist[255 - 8 * lane - j];
          sum += h[j];
        }
        int inc = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(FULL, inc, o);
          if (lane >= o) inc += y;
        }
        const int first = __ffs(__ballot_sync(FULL, inc >= rem)) - 1;
        if (lane == first) {
          int cum = inc - sum;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (cum + h[j] >= rem) {
              sel_digit = 255 - 8 * lane - j;
              sel_rem = rem - cum;
              sel_cnt = h[j];
              break;
            }
            cum += h[j];
          }
        }
      }
      __syncthreads();
      rem = sel_rem;
      prefix |= (unsigned long long)sel_digit << shift;
      mask |= 0xffull << shift;
      if (sel_cnt == rem) break;  // the whole bin is wanted: uniform
      __syncthreads();            // sel_* are read before they change
    }
  }

  // compact the keys at or above the prefix: exactly min(k, total) of them
  if (t == 0) n_out = 0;
  __syncthreads();
  for (int base = 0; base < total; base += SELECT_THREADS) {
    const int i = base + t;
    unsigned long long key = 0ull;
    bool take = false;
    if (i < total) {
      key = key_at(i);
      take = (key & mask) >= prefix;
    }
    const unsigned ball = __ballot_sync(FULL, take);
    int pos = 0;
    if (lane == 0 && ball) pos = atomicAdd(&n_out, __popc(ball));
    pos = __shfl_sync(FULL, pos, 0) + __popc(ball & ((1u << lane) - 1u));
    if (take) out[pos] = key;
  }
  __syncthreads();
  const int cnt = n_out;
  if (!last) {
    for (int e = t; e < cnt; e += SELECT_THREADS) rb[e] = out[e];
    return;
  }
  for (int e = cnt + t; e < kp; e += SELECT_THREADS) out[e] = 0ull;  // below any key
  __syncthreads();
  bitonic_sort_desc(out, kp);
  for (int r = t; r < k; r += SELECT_THREADS) {
    vals[(size_t)b * k + r] = key_value(out[r]);
    idx[(size_t)b * k + r] = key_index(out[r]);
  }
}

}  // namespace

// u (B, D), v (N, D) row-major fp32 with D % 4 == 0. scores: (B, slab)
// fp32 scratch, slab a multiple of 128 whose scores fit a selection block
// beside the keys; best: (B, k) 64-bit scratch, read and written only when
// n > slab. vals (B, k) f32, idx (B, k) i32.
// Launches 2 kernels a slab of the catalogue's N items. Returns the CUDA
// error code of the first launch that failed, or 0.
extern "C" int topn_scores_launch(const float* u, const float* v,
                                  float* scores, void* best, float* vals,
                                  int* idx, int B, int N, int D, int k,
                                  int slab, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 4 || slab % BN || k < 1 || k > N || B < 1)
    return (int)cudaErrorInvalidValue;
  int kp = 1;
  while (kp < k) kp <<= 1;
  const int first = N < slab ? N : slab;  // the widest slab's items
  const size_t smem = (size_t)kp * sizeof(unsigned long long) + (size_t)first * sizeof(float);
  if (smem > MAX_SELECT_SMEM) return (int)cudaErrorInvalidValue;
  // The limit is the most any call takes, not this call's: the attribute
  // belongs to the kernel, not the call, and the serving tier calls from
  // several threads, so a smaller call's limit set between another's
  // setting and launch made that launch fail (cudaErrorInvalidValue).
  cudaError_t err = cudaFuncSetAttribute(
      topn_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)MAX_SELECT_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(topn_score_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizeof(ScoreSmem));
  if (err != cudaSuccess) return (int)err;
  auto* bk = static_cast<unsigned long long*>(best);
  for (int n0 = 0; n0 < N; n0 += slab) {
    const int m = N - n0 < slab ? N - n0 : slab;
    const dim3 grid((m + BN - 1) / BN, (B + BM - 1) / BM);
    topn_score_kernel<<<grid, SCORE_THREADS, sizeof(ScoreSmem), st>>>(
        u, v, scores, B, N, D, n0, slab);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int c_in = n0 < k ? n0 : k;
    const int last = n0 + m >= N;
    topn_select_kernel<<<B, SELECT_THREADS, smem, st>>>(
        scores, slab, n0, m, bk, c_in, k, kp, last, vals, idx);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}
