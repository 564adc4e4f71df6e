// Batched Cholesky factor + solve + sample: the posterior solve of the
// engines "kernel" and "fused".
//
// Replaces the Pallas TPU kernel repro/kernels/chol_solve.py
// (chol_solve_sample_pallas). Per K x K system (K in 16, 32, 64):
//
//   Lambda = L L^T   (column Cholesky, diagonal clamped at 1e-20)
//   L y = b,  then  L^T x = y + z      so  x = Lambda^-1 b + L^-T z
//
// which draws one factor from N(Lambda^-1 b, Lambda^-1) with no inverse
// formed. A system that is not positive definite is not an error, and the
// caller picks what it gives (`nan_indefinite`):
//   0 ("clamp", engine "kernel"): the clamp keeps the arithmetic going, as
//     in the reference kernel (column j is scaled by 1 / sqrt(max(a_jj,
//     1e-20)), and the solves divide by the scaled diagonal, whatever its
//     sign);
//   1 ("nan", engine "fused"): a system with a pivot that is not > 0 (NaN
//     included) writes a row of NaN, as a Cholesky that fails gives in the
//     substitution solve the fused engine had (jnp.linalg.cholesky's NaN).
//     The owner of each diagonal tile flags its system in shared memory as
//     it factors the tile; the back solve's store reads the flag. The
//     arithmetic is the clamp's either way, and no pass is added.
//
// Bound on an H100: bytes. A Cholesky needs only the lower triangle of a
// system's precision (at K = 64, 9 KiB in whole 32-byte sectors), with
// 8 K B of rhs and noise, and writes 4 K B; its ~K^3 / 3 + 2 K^2 flops at
// 67 TFLOP/s fp32 take about half the 3.35 TB/s time of those bytes.
//
// What the design is for. The factorisation is a chain of K dependent
// column steps (a square root, a scaling, an update), so a system's own
// latency is long and the card is kept busy only by many systems in
// flight at once; the arithmetic should be the useful K^3 / 6 multiply-
// adds, not a multiple of it.
//
// Design: a thread a 4 x 4 tile, blocked right-looking over 4-column
// steps. A system's lower triangle is T (T + 1) / 2 tiles (T = K / 4; 136
// at K = 64), each held in 16 registers by one thread, plus T "rhs
// threads" that hold b as the matrix's extra row K: the forward solve
// L y = b is then the Cholesky of [[A, .], [b^T, .]], whose last row is
// y^T, and costs no steps of its own. Threads are ordered column by
// column (a column's tiles, then its rhs thread), so the warps whose
// columns are done stop issuing (a block's systems are interleaved thread
// by thread, so this holds for all of them at once). The owner of the diagonal tile (J, J)
// factors it as soon as its last update is in (a 4 x 4 column Cholesky,
// one reciprocal square root a column, 1 / L_jj beside it) and publishes
// L_JJ with both scales in shared memory. Step J (T steps):
//   A. the threads of column J turn their own tile into L's, X = A L_JJ^-T,
//      row by row, multiplying by the column's scale (1 / L_jj for the rhs
//      row, as the reference divides its solves by L_jj), and publish the
//      panel L[:, 4J .. 4J + 3] transposed, their tile of L, and y.
//   B. every tile right of column J takes the rank-4 update A -= L_i L_j^T
//      from the panel (two 16-byte shared-memory reads and 16 fused
//      multiply-adds a column); the owner of tile (J + 1, J + 1) then
//      factors it.
// Only tiles of the lower triangle are read, updated or stored; a
// diagonal tile is updated whole (its 6 entries above the diagonal are
// computed and never used, 6 of each diagonal tile's 16). Each thread
// loads its own tile from device memory with four 16-byte loads straight
// into registers: the lower triangle's rows in whole 16-byte pieces, no
// shared-memory staging, which would add a copy and a barrier and move no
// fewer bytes. The back solve L^T x = y + z runs on L in shared memory by
// columns of L^T (rows of L, contiguous), one warp (16 lanes at K = 16) a
// system, lanes keeping rows: each step is one shuffle of x_j and one
// fused multiply-add a row, with 1 / L_jj taken once a column; there is
// no warp reduction, and the block's other warps have ended.
//
// Occupancy: a system is 152 threads at K = 64 (one a block, 160 with the
// tail), at most 48 registers a thread and 19 KB of shared memory, so 8
// blocks, 40 warps, fit an SM. K = 32 runs 5 systems a block (at most 56
// registers: 35 warps), K = 16 eight (48: 40 warps). The batch is taken as it is: a block's systems
// past its end compute on zeros and store nothing. No atomics and a fixed
// order: the same bits on every run.
//
// K is a template parameter instantiated for 16, 32 and 64. The wrapper
// pads another rank with an identity block, [[P, 0], [0, I]], and zeros
// in rhs and z: the kept block's Cholesky and its two solves then do the
// same arithmetic, and the padded entries come out 0 (a zero-padded
// precision would be singular).
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

template <int K>
struct Layout {
  static constexpr int T = K / 4;                     // tiles a side
  static constexpr int TPS = T * (T + 1) / 2 + T;     // threads a system: tiles + rhs row
  static constexpr int G = K == 64 ? 1 : (K == 32 ? 5 : 8);  // systems a block
  static constexpr int THREADS = (G * TPS + 31) / 32 * 32;
  static constexpr int GW = K < 32 ? K : 32;          // lanes of a back-solve group
  static constexpr int RL = K / GW;                   // rows a lane keeps there
  // blocks an SM should hold: at most 48 registers a thread at each K
  static constexpr int MIN_BLOCKS = K == 64 ? 8 : (K == 32 ? 5 : 10);
  static_assert(THREADS / GW >= G, "a back-solve group for every system");
};

// One system's shared memory. Rows are 16-byte aligned (K + 4 floats).
template <int K>
struct __align__(16) Shared {
  float diag[16];           // the next diagonal tile's factor L_JJ, row-major
  float panel[4][K + 4];    // panel[q][i] = L[i][4J + q]; [q][K]: y_(4J + q)
  float l[K][K + 4];        // L, lower triangle (the back solve's L^T by rows)
  float c[K];               // z, then y + z
  float rs[K];              // 1 / sqrt(max(a_jj, 1e-20)): column j's scale
  float inv[K];             // 1 / L_jj: the solves' scale
  int bad;                  // a pivot that was not > 0
  float pad[3];             // neighbouring systems' words 4 banks apart
};

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// The owner of diagonal tile (J, J), once its updates are in: the tile's
// column Cholesky in place (d[p][q] = L[4J + p][4J + q] for p >= q, 0
// above), published with its columns' two scales; a pivot that is not > 0
// sets the system's flag.
template <int K>
__device__ __forceinline__ void factor_diag(float (&d)[4][4], Shared<K>& sm, int J) {
  float rs[4], inv[4];
  bool bad = false;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    bad |= !(d[q][q] > 0.f);
    rs[q] = rsqrtf(fmaxf(d[q][q], 1e-20f));
#pragma unroll
    for (int p = q; p < 4; ++p) d[p][q] *= rs[q];
    inv[q] = __fdividef(1.f, d[q][q]);
#pragma unroll
    for (int p = q + 1; p < 4; ++p)
#pragma unroll
      for (int c = q + 1; c <= p; ++c) d[p][c] = fmaf(-d[p][q], d[c][q], d[p][c]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int q = r + 1; q < 4; ++q) d[r][q] = 0.f;
    store4(sm.diag + 4 * r, d[r][0], d[r][1], d[r][2], d[r][3]);
  }
  store4(sm.rs + 4 * J, rs[0], rs[1], rs[2], rs[3]);
  store4(sm.inv + 4 * J, inv[0], inv[1], inv[2], inv[3]);
  if (bad) sm.bad = 1;
}

template <int K>
__global__ void __launch_bounds__(Layout<K>::THREADS, Layout<K>::MIN_BLOCKS)
chol_solve_kernel(const float* __restrict__ prec, const float* __restrict__ rhs,
                  const float* __restrict__ z, float* __restrict__ out, int B,
                  int nan_indefinite) {
  using L = Layout<K>;
  constexpr int T = L::T;
  __shared__ Shared<K> smem[L::G];
  const int t = threadIdx.x;
  // thread t is position u of system g: a block's G systems interleaved,
  // so that one column's threads of all of them are consecutive
  const int g = t % L::G, u = t / L::G;
  const bool live = u < L::TPS;              // the block's tail threads idle
  const long long sys = (long long)blockIdx.x * L::G + g;
  const bool valid = live && sys < B;
  Shared<K>& sm = smem[g];

  // (ti, tj): column-major over the lower tiles, each column's rhs thread
  // (ti = T) after its tiles; tj = -1 for the idle tail
  int tj = 0, ti = 0;
  if (live) {
    int first = 0;
#pragma unroll 1
    while (u >= first + T + 1 - tj) {
      first += T + 1 - tj;
      ++tj;
    }
    ti = tj + (u - first);
  } else {
    tj = ti = -1;
  }
  const bool is_rhs = ti == T;

  float a[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) a[r][q] = 0.f;
  if (valid && !is_rhs) {
    const float* p = prec + sys * K * K + (size_t)(4 * ti) * K + 4 * tj;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p + r * K));
      a[r][0] = x.x; a[r][1] = x.y; a[r][2] = x.z; a[r][3] = x.w;
    }
  } else if (valid) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(rhs + sys * K + 4 * tj));
    const float4 y = __ldg(reinterpret_cast<const float4*>(z + sys * K + 4 * tj));
    a[0][0] = x.x; a[0][1] = x.y; a[0][2] = x.z; a[0][3] = x.w;
    store4(sm.c + 4 * tj, y.x, y.y, y.z, y.w);
  } else if (is_rhs) {
    store4(sm.c + 4 * tj, 0.f, 0.f, 0.f, 0.f);
  }
  if (ti == 0 && tj == 0) {
    sm.bad = 0;
    factor_diag<K>(a, sm, 0);
  }
  if (is_rhs && tj == 0) {  // the panel's rows K+1 .. K+3 stay 0
#pragma unroll
    for (int q = 0; q < 4; ++q) store4(sm.panel[q] + K, 0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

#pragma unroll 1
  for (int J = 0; J < T; ++J) {
    if (tj == J) {
      // A. own tile: row by row, x L_JJ^T = a, scaled by column (the rhs
      // row: L_JJ y = b); the diagonal tile is L_JJ already
      float d[4][4], m[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(sm.diag + 4 * r);
        d[r][0] = x.x; d[r][1] = x.y; d[r][2] = x.z; d[r][3] = x.w;
      }
      {
        const float4 x = *reinterpret_cast<const float4*>((is_rhs ? sm.inv : sm.rs) + 4 * J);
        m[0] = x.x; m[1] = x.y; m[2] = x.z; m[3] = x.w;
      }
      if (ti != J) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float s = a[r][q];
#pragma unroll
            for (int c = 0; c < q; ++c) s = fmaf(-a[r][c], d[q][c], s);
            a[r][q] = s * m[q];
          }
      }
      if (is_rhs) {
        float4 c = *reinterpret_cast<float4*>(sm.c + 4 * J);
        store4(sm.c + 4 * J, c.x + a[0][0], c.y + a[0][1], c.z + a[0][2], c.w + a[0][3]);
#pragma unroll
        for (int q = 0; q < 4; ++q) sm.panel[q][K] = a[0][q];
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          store4(sm.panel[q] + 4 * ti, a[0][q], a[1][q], a[2][q], a[3][q]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          store4(sm.l[4 * ti + r] + 4 * J, a[r][0], a[r][1], a[r][2], a[r][3]);
      }
    }
    __syncthreads();
    if (tj > J) {
      // B. the rank-4 update of every tile right of column J
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 li = *reinterpret_cast<const float4*>(sm.panel[q] + 4 * ti);
        const float4 lj = *reinterpret_cast<const float4*>(sm.panel[q] + 4 * tj);
        const float x[4] = {li.x, li.y, li.z, li.w}, y[4] = {lj.x, lj.y, lj.z, lj.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) a[r][c] = fmaf(-x[r], y[c], a[r][c]);
      }
      if (ti == J + 1 && tj == J + 1) factor_diag<K>(a, sm, J + 1);
    }
    __syncthreads();
  }

  // L^T x = y + z by columns of L^T: x_j = c_j / L_jj, then c_i -= L_ji x_j
  // for i < j. Lane `lane` of group `grp` keeps rows lane + GW i.
  constexpr int GW = L::GW, RL = L::RL;
  const int grp = t / GW, lane = t % GW;
  if ((t / 32) * (32 / GW) >= L::G) return;  // a warp with no system to solve
  const long long gsys = (long long)blockIdx.x * L::G + grp;
  const Shared<K>& sb = smem[grp < L::G ? grp : 0];
  float cv[RL], iv[RL], x[RL];
#pragma unroll
  for (int i = 0; i < RL; ++i) {
    cv[i] = sb.c[lane + GW * i];
    iv[i] = sb.inv[lane + GW * i];
    x[i] = 0.f;
  }
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    const float xj = __shfl_sync(FULL, cv[j / GW] * iv[j / GW], j % GW, GW);
    if (lane == j % GW) x[j / GW] = xj;
#pragma unroll
    for (int i = 0; i < RL; ++i)
      if (GW * i < j) cv[i] = fmaf(-sb.l[j][lane + GW * i], xj, cv[i]);
  }
  if (grp < L::G && gsys < B) {
    const bool nan_row = nan_indefinite && sb.bad;
#pragma unroll
    for (int i = 0; i < RL; ++i)
      out[gsys * K + lane + GW * i] = nan_row ? __int_as_float(0x7fc00000) : x[i];
  }
}

template <int K>
int launch(const float* prec, const float* rhs, const float* z, float* out,
           int B, int nan_indefinite, cudaStream_t st) {
  using L = Layout<K>;
  const int blocks = (B + L::G - 1) / L::G;
  chol_solve_kernel<K><<<blocks, L::THREADS, 0, st>>>(prec, rhs, z, out, B,
                                                      nan_indefinite);
  return (int)cudaGetLastError();
}

}  // namespace

// prec (B, K, K), rhs and z (B, K) -> out (B, K), K in 16, 32, 64, all
// contiguous and 16-byte aligned (cudaErrorInvalidValue for another K or
// an empty batch); nan_indefinite 1 writes NaN rows for the systems that
// are not positive definite, 0 keeps the clamp's values. Returns the CUDA
// error code of the launch.
extern "C" int chol_solve_sample_launch(const float* prec, const float* rhs,
                                        const float* z, float* out, int B,
                                        int K, int nan_indefinite, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 16: return launch<16>(prec, rhs, z, out, B, nan_indefinite, st);
    case 32: return launch<32>(prec, rhs, z, out, B, nan_indefinite, st);
    case 64: return launch<64>(prec, rhs, z, out, B, nan_indefinite, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
