// mma.sync / ldmatrix / cp.async helpers of the port's bf16 attention
// kernels (K1/K2 forward, K3/K4 backward), in the fragment layouts of
// mma.sync.m16n8k16 with f32 accumulators:
//   A (16x16, row): a0 (row g, cols 2t4..+1), a1 (row g+8, same cols),
//                   a2 (row g, cols 8+2t4..+1), a3 (row g+8, 8+2t4..+1);
//   B (16x8, col):  b0 (k rows 2t4..+1, col g), b1 (k rows 8+2t4..+1);
//   C (16x8):       c0, c1 (row g, cols 2t4..+1), c2, c3 (row g+8),
// with g = lane / 4 and t4 = lane % 4.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 zero-fills (rows past the edge)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16x16 bf16, row) . b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [0, rows) of a [rows, D] tile (row stride LD elements) from global rows
// `stride` elements apart, by cp.async; rows past `valid` are zero-filled
template <int D, int LD, int NTH>
__device__ __forceinline__ void async_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           size_t stride, int valid,
                                           int rows) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < rows * CH; i += NTH) {
    const int r = i / CH;
    const int c = (i - r * CH) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * LD + c, ok ? src + (size_t)r * stride + c : src,
               ok ? 16 : 0);
  }
}

}  // namespace
