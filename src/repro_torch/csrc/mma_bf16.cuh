// Tensor-core primitives shared by the bf16 flash kernels
// (flash_attention.cu's flash_mma_kernel and flash_attention_bwd.cu's dq
// and dkdv kernels): 16-byte cp.async tile copies (load_rows), ldmatrix
// fragment loads (plain and transposed), mma.sync.m16n8k16 with bf16
// inputs and fp32 accumulators, and the exact split of an fp32 value into
// three bf16 terms.
//
// The split's premise: x1 = bf16(x), x2 = bf16(x - x1), x3 = bf16(x - x1 -
// x2). Each difference is exact in fp32 and x3 takes what is left, so
// x1 + x2 + x3 == x for every fp32 x of magnitude 2^-100 to 2^60, of
// either sign (24 significant bits, 8 in each term; the last term's bits
// stay above bf16's subnormals). A bf16 times a bf16 is exact in fp32, so
// a product whose A operand is an fp32 matrix split this way, taken as
// three bf16 MMAs into fp32 accumulators, adds the same exact products
// that the fp32 pipes would add: only the order of the sums differs. Two
// terms would leave 2^-16 of x (tests/test_torch_kernels.py checks these
// facts for the forward's P and the backward's dS).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src into shared memory, or 16 zero bytes where !in
__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a b for one m16n8k16 tile: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// (x, y) = h1 + h2 + h3 exactly, three bf16 pairs (x in the low halves):
// each remainder is exact in fp32 and the last term holds what is left
__device__ __forceinline__ void split3(float x, float y, uint32_t& h1,
                                       uint32_t& h2, uint32_t& h3) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x, y);
  const float2 af = __bfloat1622float2(a);
  const float rx = x - af.x, ry = y - af.y;
  const __nv_bfloat162 b = __floats2bfloat162_rn(rx, ry);
  const float2 bf = __bfloat1622float2(b);
  h1 = bits(a);
  h2 = bits(b);
  h3 = bits(__floats2bfloat162_rn(rx - bf.x, ry - bf.y));
}

// rows x D of src (row-major, D apart) into dst (D + PAD apart) by a
// block of THREADS threads; rows at or past `valid` are zero, so a ragged
// tail holds finite values
template <int D, int PAD, int THREADS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int valid, int rows) {
  constexpr int C = D / 8;          // 16-byte pieces a row
  for (int e = threadIdx.x; e < rows * C; e += THREADS) {
    const int r = e / C, c = (e % C) * 8;
    const bool in = r < valid;
    cp_async16(dst + r * (D + PAD) + c, in ? src + (size_t)r * D + c : src, in);
  }
}

}  // namespace tc
