// The parts of the port's attention kernels at head dims above 256 (the
// forward's flash_fwd_wide_kernel, the backward's flash_bwd_dq_wide_kernel
// and flash_bwd_dkdv_wide_kernel). The head dim D is a run-time argument, a
// multiple of 8 (16-byte rows of bf16), with no upper limit: a block of 128
// threads owns 32 rows (queries in K1-K3, keys in K4) and one chunk of 64
// output columns, and walks the other side's tiles of 64 rows. A tile's
// scores (q.k, and dO.v in the backward) sum over every column chunk of D,
// each chunk staged in shared memory as f32; the softmax or P from the LSE
// follows, and the block updates only its own 64 output columns, so the
// scores are recomputed once for each of the D / 64 column chunks. The
// column chunks are walked so that the block's own chunk comes last: the
// backward's updates read it from the tiles the scores just used.
//
// Thread t of a block owns rows 4 (t / 16) .. 4 (t / 16) + 3 and columns
// t % 16 + 16 j (j < 4) of every 32 x 64 tile, of the scores and of the
// output chunk alike, so a row's max and sum combine over 16 lanes of one
// warp by shuffles. CUDA-core FMAs in f32 from shared memory; bf16 values
// are widened on load.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int WD_NT = 128;  // threads a block
constexpr int WD_R = 32;    // rows a block owns
constexpr int WD_C = 64;    // rows of the other side's tiles
constexpr int WD_DC = 64;   // output columns a block, and a score chunk's
constexpr int WD_LD = WD_DC + 1;  // staggers banks for row-wise reads
constexpr int WD_MULTIPLE = 8;    // D is a multiple of this

// the block's rows and columns of thread t: rows wd_row(t) + i (i < 4),
// columns wd_col(t) + 16 j (j < 4)
__device__ __forceinline__ int wd_row(int t) { return (t >> 4) * 4; }
__device__ __forceinline__ int wd_col(int t) { return t & 15; }

// 8 elements from p (16 bytes of bf16, 32 of f32) as f32; a bf16 is the
// high half of its f32, so each widens by a shift of the loaded words
__device__ __forceinline__ void wd_load8(const __nv_bfloat16* p,
                                         float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void wd_load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// columns [c0, c0 + 64) of ROWS global rows `stride` elements apart into
// dst [ROWS][ld] as f32; rows past `valid` and columns past D are zeros
template <int ROWS, typename T>
__device__ __forceinline__ void wd_load(float* dst, int ld, const T* src,
                                        size_t stride, int valid, int c0,
                                        int D) {
  for (int i = threadIdx.x; i < ROWS * (WD_DC / 8); i += WD_NT) {
    const int r = i / (WD_DC / 8);
    const int c = (i % (WD_DC / 8)) * 8;
    float x[8];
    if (r < valid && c0 + c < D) {
      wd_load8(src + (size_t)r * stride + c0 + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[r * ld + c + e] = x[e];
  }
}

// s[i][j] += A[row i] . B[col j] over one 64-column chunk: A [32][WD_LD]
// (the block's rows), B [64][WD_LD] (the other side's)
__device__ __forceinline__ void wd_dot(float (&s)[4][4], const float* A,
                                       const float* B) {
  const float* a = A + wd_row(threadIdx.x) * WD_LD;
  const float* b = B + wd_col(threadIdx.x) * WD_LD;
#pragma unroll 4
  for (int d = 0; d < WD_DC; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[i * WD_LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[16 * j * WD_LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
  }
}

// acc[i][j] += sum_c P[row i][c] M[c][col j] over the 64 rows c of M
// [64][ldm] (the other side's tile, its output columns); P [32][WD_LD]
__device__ __forceinline__ void wd_update(float (&acc)[4][4], const float* P,
                                          const float* M, int ldm) {
  const float* p = P + wd_row(threadIdx.x) * WD_LD;
  const float* m = M + wd_col(threadIdx.x);
#pragma unroll 4
  for (int c = 0; c < WD_C; ++c) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = p[i * WD_LD + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = m[c * ldm + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// max and sum over the 16 lanes that share a row
__device__ __forceinline__ float wd_row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float wd_row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// store the block's output chunk: acc[i][j] * mul[i] at row r0 + row i,
// columns c0 + col j (< D), rows < valid, `stride` elements apart
template <typename T>
__device__ __forceinline__ void wd_store(T* dst, size_t stride, int valid,
                                         int c0, int D,
                                         const float (&acc)[4][4],
                                         const float (&mul)[4]) {
  const int r = wd_row(threadIdx.x);
  const int c = c0 + wd_col(threadIdx.x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (r + i < valid && c + 16 * j < D)
        dst[(size_t)(r + i) * stride + c + 16 * j] =
            from_f32<T>(acc[i][j] * mul[i]);
  }
}

// the number of 64-column chunks of D
__host__ __device__ __forceinline__ int wd_chunks(int D) {
  return (D + WD_DC - 1) / WD_DC;
}

}  // namespace
