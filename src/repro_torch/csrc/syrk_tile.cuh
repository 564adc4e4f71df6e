// Shared pieces of the two syrk kernels (gather_syrk_seg.cu, masked_syrk.cu).
//
// Both compute, for a bucket row's W vectors g_w with mask m_w and value
// c_w, prec = sum_w (g_w m_w) g_w^T (K x K) and rhs = sum_w (g_w m_w)
// (c_w m_w) (K), for K in KERNEL_RANKS (16, 32, 64). masked_syrk's block
// is pre-gathered and pre-masked: it has no mask and c_w is its rv. The
// wrappers pad any other rank up to the next one with zero columns: they
// add exact zeros to every sum, so the kept block is the same bits.
//
// The sums are kept in fp64. The product of two fp32 values is exact in
// fp64 and a sum of a few thousand such terms loses nothing an fp32 result
// can show, so each statistic leaves the kernel as the fp32 rounding of its
// (all but) exact value: never further from a float64 evaluation than an
// fp32 sum, and the same bits on every run. Every sum is taken in w order,
// as the plain versions take it (kernels/ref.py::_syrk_in_order), so
// kernel and plain version agree to the bit. The inputs and the outputs
// stay IEEE fp32; g_w m_w and c_w m_w are rounded to fp32 first, as the
// plain version masks before the products.
//
// Shared by both kernels: cp.async staging; rows streamed by a persistent
// grid (narrow rows: a group of rows' vectors staged at once, the block's
// threads walking the group's outputs in 4 x 4 tiles of each row's K x K
// sum and float4s of its rhs, each summed over its row's W vectors just
// before its four 16-byte stores: stream_group); and a row a block (wide
// rows: 256 threads, thread t owning the (K/16) x (K/16) tile
// (t / 16, t % 16) of the row's sum and threads t < K rhs[t], the row's
// vectors staged CHUNK at a time: accumulate_chunk, store_row). The
// kernels differ only in how they stage: masked_syrk copies a contiguous
// block, gather_syrk_seg gathers rows of V by their ids.
//
// Both stores take an epilogue type, Into: NoInto (the default) writes
// each sum, rounded, to its own slot of the output, as every caller but
// one wants; gather_syrk_seg.cu's IntoSystems writes the posterior system
// the sum belongs to instead. NoInto's code is the store's own.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr int THREADS = 256;
constexpr int CHUNK = 32;

// the plain store: no epilogue
struct NoInto {
  static constexpr bool enabled = false;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 bf16x4(uint2 raw) {
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// four consecutive staged values of shared memory, widened to fp32 (exact
// from bf16)
__device__ __forceinline__ float4 smem4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 smem4(const __nv_bfloat16* p) {
  return bf16x4(*reinterpret_cast<const uint2*>(p));
}

// T consecutive staged values of shared memory, widened to fp32, in one
// vector load where T allows.
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

template <int T>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* p, float (&x)[T]) {
  if constexpr (T == 4) {
    const float4 a = smem4(p);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  } else if constexpr (T == 2) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    x[0] = a.x; x[1] = a.y;
  } else {
    x[0] = __bfloat162float(*p);
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------- cp.async

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// all but the most recent group of copies have landed
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// every copy has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ------------------------------------------------------------ a row a block

// Adds sum_w (g_w m_w) g_w^T and sum_w (g_w m_w) (c_w m_w) over the first
// n staged vectors g[w * K .. w * K + K) (fp32, or bf16 widened exactly)
// to (acc, racc); without kMask the masks are 1 and m is not read.
template <int K, bool kMask, typename T>
__device__ __forceinline__ void accumulate_chunk(
    const T* __restrict__ g, const float* __restrict__ m,
    const float* __restrict__ c, int n, double (&acc)[K / 16][K / 16],
    double& racc) {
  constexpr int RT = K / 16;
  const int t = threadIdx.x, ti = t >> 4, tj = t & 15;
  for (int w = 0; w < n; ++w) {
    float a[RT], b[RT];
    load_tile<RT>(g + w * K + ti * RT, a);
    load_tile<RT>(g + w * K + tj * RT, b);
    if constexpr (kMask) {
      const float mw = m[w];
#pragma unroll
      for (int i = 0; i < RT; ++i) a[i] *= mw;
    }
    double am[RT], bb[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      am[i] = a[i];
      bb[i] = b[i];
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j) acc[i][j] = fma(am[i], bb[j], acc[i][j]);
  }
  if (t < K) {
    for (int w = 0; w < n; ++w) {
      float x = to_float(g[w * K + t]), cw = c[w];
      if constexpr (kMask) {
        x *= m[w];
        cw *= m[w];
      }
      racc = fma((double)x, (double)cw, racc);
    }
  }
}

// Writes the row's statistics, rounded to OutT (float for a result,
// double for a row partial that a segment sum still has to add up); with
// an Into epilogue (float only), segment seg's system instead.
template <int K, typename OutT, typename Into = NoInto>
__device__ __forceinline__ void store_row(OutT* __restrict__ prec,
                                          OutT* __restrict__ rhs,
                                          const double (&acc)[K / 16][K / 16],
                                          double racc, const Into& into = Into{},
                                          int seg = 0) {
  constexpr int N = K / 16;
  const int t = threadIdx.x, ti = t >> 4, tj = t & 15;
  if constexpr (Into::enabled) {
    static_assert(sizeof(OutT) == 4, "the into store writes fp32 systems");
    into.template tile<K>(seg, ti * N, tj * N, acc);
    if (t < K) into.rhs_entry(seg, t, racc);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      OutT* p = prec + (ti * N + i) * K + tj * N;
      if constexpr (sizeof(OutT) == 4 && N == 4) {
        *reinterpret_cast<float4*>(p) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else if constexpr (sizeof(OutT) == 4 && N == 2) {
        *reinterpret_cast<float2*>(p) = make_float2(acc[i][0], acc[i][1]);
      } else if constexpr (sizeof(OutT) == 8 && N >= 2) {
#pragma unroll
        for (int j = 0; j < N; j += 2)
          reinterpret_cast<double2*>(p)[j / 2] = make_double2(acc[i][j], acc[i][j + 1]);
      } else {
#pragma unroll
        for (int j = 0; j < N; ++j) p[j] = (OutT)acc[i][j];
      }
    }
    if (t < K) rhs[t] = (OutT)racc;
  }
}

// ------------------------------------------------------------ streamed rows

// The statistics of `rows` staged rows of W vectors each, row r's vector w
// at x + (r W + w) K, its mask at m[r W + w] (none when !kMask: 1) and
// value at c[r W + w]; prec and rhs point at the first row's outputs. The
// block's threads walk the outputs: C * C 4 x 4 tiles of each row's matrix
// (consecutive threads on consecutive tiles, so each of a tile's four
// 16-byte row stores is, across a warp, two 256-byte runs), then C float4s
// of its rhs, C = K / 4. Each tile is summed over the row's W vectors in
// fp64, in w order, just before its store: 16 fused multiply-adds for two
// 16-byte shared-memory reads. No row's K x K sum sits in registers. With
// an Into epilogue, row r's sums go to the system of segment first + r.
template <int K, bool kMask, typename T, typename Into = NoInto>
__device__ __forceinline__ void stream_group(const T* x, const float* m,
                                             const float* c, int rows, int W,
                                             float* prec, float* rhs,
                                             const Into& into = Into{}, int first = 0) {
  constexpr int C = K / 4;
  constexpr int UNITS = C * C + C;
  for (int e = threadIdx.x; e < rows * UNITS; e += THREADS) {
    const int row = e / UNITS, f = e - row * UNITS;
    const T* xr = x + (size_t)row * W * K;
    const float* mr = m + row * W;
    const float* cr = c + row * W;
    if (f < C * C) {
      // prec[4i .. 4i + 3][4j .. 4j + 3] = sum_w (x_w m_w)[4i ..] x_w[4j ..]^T
      const int i = f / C, j = f % C;
      double acc[4][4] = {};
      for (int w = 0; w < W; ++w) {
        float4 a = smem4(xr + w * K + i * 4);
        const float4 b = smem4(xr + w * K + j * 4);
        if constexpr (kMask) {
          const float mw = mr[w];
          a = make_float4(a.x * mw, a.y * mw, a.z * mw, a.w * mw);
        }
        const double ad[4] = {a.x, a.y, a.z, a.w}, bd[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = fma(ad[u], bd[v], acc[u][v]);
      }
      if constexpr (Into::enabled) {
        into.template tile<K>(first + row, i * 4, j * 4, acc);
        continue;
      }
      float* p = prec + ((size_t)row * K + i * 4) * K + j * 4;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        *reinterpret_cast<float4*>(p + u * K) =
            make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
    } else {
      // rhs[4j .. 4j + 3] = sum_w (x_w m_w)[4j ..] (c_w m_w)
      const int j = f - C * C;
      double acc[4] = {};
      for (int w = 0; w < W; ++w) {
        float4 b = smem4(xr + w * K + j * 4);
        float cw = cr[w];
        if constexpr (kMask) {
          const float mw = mr[w];
          b = make_float4(b.x * mw, b.y * mw, b.z * mw, b.w * mw);
          cw *= mw;
        }
        const double cd = cw;
        acc[0] = fma((double)b.x, cd, acc[0]);
        acc[1] = fma((double)b.y, cd, acc[1]);
        acc[2] = fma((double)b.z, cd, acc[2]);
        acc[3] = fma((double)b.w, cd, acc[3]);
      }
      if constexpr (Into::enabled) {
        into.template rhs<K>(first + row, j * 4, acc);
        continue;
      }
      *reinterpret_cast<float4*>(rhs + (size_t)row * K + j * 4) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
  }
}

// Resident blocks of `kernel` on the whole card at `threads` threads and
// `smem` bytes of dynamic shared memory: a persistent grid's size.
template <typename Kernel>
__host__ int resident_blocks(Kernel kernel, int threads, int smem, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  *blocks = sms * per_sm;
  return (int)err;
}

}  // namespace repro
