// Streaming top-k of U V^T for BPMF serving.
//
// Replaces the Pallas TPU kernel repro/kernels/bpmf_topn.py
// (topn_scores_pallas): for each user row u_b (D = S * K wide, the
// ensemble's scoring rows) the k best items of u_b . v_i over the
// catalogue, without the (B, N) score matrix ever reaching device memory.
// Items at index >= n_valid (padding) score -inf. Ties go to the lowest
// item index, as jax.lax.top_k orders them.
//
// Bound on an H100: operations. 2 B N D flops of fp32 (no tensor cores:
// the scores are IEEE fp32, summed in order over D with one rounded
// multiply and one rounded add per term, exactly as the plain version in
// kernels/ref.py, so the two agree bit for bit) at 67 TFLOP/s, against
// (B + N) D * 4 bytes read at 3.35 TB/s.
//
// Design. The TPU kernel walked item tiles in a sequential grid and merged
// each tile into the output block in place. Here one block owns BU user
// rows and walks the item tiles in a loop. Each (score, index) pair is one
// 64-bit key: order-preserving float bits above, the complemented index
// below, so a descending sort of keys is "score descending, lowest index
// first" and never depends on the order of equal scores. Per user the
// block keeps a buffer of 2 * TN keys in shared memory: the running best
// KP (a power of two >= k) at the front, the fresh tile of TN items at the
// back. A tile is sorted into the buffer (bitonic, descending) only when
// one of its keys beats some user's current k-th key, so after the first
// tiles most are skipped. The k best keys leave at the end.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ unsigned long long make_key(float s, int item) {
  const unsigned bits = __float_as_uint(s);
  const unsigned ord = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  return ((unsigned long long)ord << 32) | (unsigned long long)(~(unsigned)item);
}

__device__ __forceinline__ float key_value(unsigned long long key) {
  const unsigned ord = (unsigned)(key >> 32);
  return __uint_as_float((ord & 0x80000000u) ? (ord & 0x7fffffffu) : ~ord);
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return (int)(~(unsigned)(key & 0xffffffffull));
}

// Sorts BU buffers of L keys (L a power of two) descending, in place.
template <int BU>
__device__ void bitonic_sort_desc(unsigned long long* keys, int L) {
  const int half = L >> 1;
  for (int size = 2; size <= L; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < BU * half; p += THREADS) {
        const int bb = p / half, q = p % half;
        const int i = 2 * stride * (q / stride) + (q % stride), j = i + stride;
        unsigned long long* kk = keys + (size_t)bb * L;
        const unsigned long long a = kk[i], c = kk[j];
        const bool desc = (i & size) == 0;
        if (desc ? (a < c) : (a > c)) {
          kk[i] = c;
          kk[j] = a;
        }
      }
      __syncthreads();
    }
  }
}

template <int BU>
__global__ void __launch_bounds__(THREADS) topn_kernel(
    const float* __restrict__ u, const float* __restrict__ v,
    float* __restrict__ vals, int* __restrict__ idx, int Bp, int Np,
    int n_valid, int D, int k, int TN) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = 2 * TN, DS = D + 4;  // DS: padded row stride of the users
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  float* us = reinterpret_cast<float*>(keys + (size_t)BU * L);
  const int t = threadIdx.x, b0 = blockIdx.x * BU;

  for (int e = t; e < BU * D; e += THREADS) {
    const int bb = e / D, d = e % D;
    us[bb * DS + d] = b0 + bb < Bp ? u[(size_t)(b0 + bb) * D + d] : 0.f;
  }
  for (int e = t; e < BU * L; e += THREADS) keys[e] = 0ull;  // below any item
  __syncthreads();

  for (int n0 = 0; n0 < Np; n0 += TN) {
    int found = 0;
    for (int p = t; p < TN * BU; p += THREADS) {
      const int i = p / BU, bb = p % BU, item = n0 + i;
      unsigned long long key = 0ull;
      if (item < Np) {
        float s = -INFINITY;
        if (item < n_valid) {
          const float* vr = v + (size_t)item * D;
          const float* ur = us + bb * DS;
          float acc = 0.f;
          for (int d = 0; d < D; d += 4) {
            const float4 x = __ldg(reinterpret_cast<const float4*>(vr + d));
            const float4 y = *reinterpret_cast<const float4*>(ur + d);
            acc = __fadd_rn(acc, __fmul_rn(y.x, x.x));
            acc = __fadd_rn(acc, __fmul_rn(y.y, x.y));
            acc = __fadd_rn(acc, __fmul_rn(y.z, x.z));
            acc = __fadd_rn(acc, __fmul_rn(y.w, x.w));
          }
          s = acc;
        }
        key = make_key(s, item);
      }
      unsigned long long* kk = keys + (size_t)bb * L;
      kk[TN + i] = key;
      found |= key > kk[k - 1];
    }
    if (__syncthreads_or(found)) bitonic_sort_desc<BU>(keys, L);
  }

  for (int e = t; e < BU * k; e += THREADS) {
    const int bb = e / k, r = e % k;
    if (b0 + bb < Bp) {
      const unsigned long long key = keys[(size_t)bb * L + r];
      vals[(size_t)(b0 + bb) * k + r] = key_value(key);
      idx[(size_t)(b0 + bb) * k + r] = key_index(key);
    }
  }
}

template <int BU>
int launch(const float* u, const float* v, float* vals, int* idx, int Bp,
           int Np, int n_valid, int D, int k, int TN, cudaStream_t st) {
  const size_t smem = (size_t)BU * 2 * TN * sizeof(unsigned long long) +
                      (size_t)BU * (D + 4) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      topn_kernel<BU>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (Bp + BU - 1) / BU;
  topn_kernel<BU><<<blocks, THREADS, smem, st>>>(u, v, vals, idx, Bp, Np,
                                                 n_valid, D, k, TN);
  return (int)cudaGetLastError();
}

}  // namespace

// u (Bp, D), v (Np, D) with D % 4 == 0 -> vals (Bp, k) f32, idx (Bp, k)
// i32. TN is the item tile (a power of two >= 256 and >= k); users_per_block
// is 4 or 1 (1 leaves room for the largest k). Returns the CUDA error code.
extern "C" int topn_scores_launch(const float* u, const float* v, float* vals,
                                  int* idx, int Bp, int Np, int n_valid, int D,
                                  int k, int TN, int users_per_block,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (users_per_block == 4)
    return launch<4>(u, v, vals, idx, Bp, Np, n_valid, D, k, TN, st);
  return launch<1>(u, v, vals, idx, Bp, Np, n_valid, D, k, TN, st);
}
