// The parts of the port's attention kernels at head dims 16 and 32 (the
// forward's flash_fwd_small_kernel, the backward's flash_bwd_dq_small_kernel
// and flash_bwd_dkdv_small_kernel): a block owns 64 rows, 16 to each of 4
// consumer warps, and a fifth warp loads 128-row stages by TMA into a ring.
// A whole row is one TMA box (32 bytes with the 32-byte swizzle at head dim
// 16, 64 bytes with the 64-byte swizzle at 32), read by ldmatrix; each warp
// keeps its own rows as mma.sync A fragments in registers for its whole
// walk.
#pragma once

#include <cstdint>

#include "mma.cuh"

namespace {

constexpr int SM_ROWS = 64;    // rows a block owns (queries in K1-K3, keys in K4)
constexpr int SM_CHUNK = 128;  // rows a ring stage
constexpr int SM_STAGES = 3;   // ring depth
constexpr int SM_NT = 160;     // 4 consumer warps (16 rows each) + producer

// 16-byte chunk c of row r of a tile written by TMA with whole rows as its
// box: 32-byte rows with the 32-byte swizzle (head dim 16), or 64-byte rows
// with the 64-byte one (32); each ldmatrix phase (8 rows, one chunk) then
// hits 32 distinct banks
template <int D>
__device__ __forceinline__ uint32_t sw_chunk(int r, int c) {
  static_assert(D == 16 || D == 32, "whole-row boxes of 32 or 64 bytes");
  if constexpr (D == 16)
    return r * 32 + ((c ^ ((r >> 2) & 1)) << 4);
  else
    return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

// the A fragments (16 rows from r0 of a swizzled tile, D columns: D / 16
// k-steps) a warp keeps in registers for its whole walk
template <int D>
__device__ __forceinline__ void load_rows_a(uint32_t (&a)[D / 16][4],
                                            uint32_t tile, int r0,
                                            int lane) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    ldsm_x4(a[ks], tile + sw_chunk<D>(r0 + (lane & 15), 2 * ks + (lane >> 4)));
}

// acc[8][4] (16 rows x 64 columns) = A (16 x D, fragments a) . B^T + c, B
// the 64 rows from r0 of a swizzled tile (n-tile n: rows r0 + 8n ..), c
// the sums n-tile n starts from (c_of(n), four f32)
template <int D, typename C>
__device__ __forceinline__ void mma_rows(float (&acc)[8][4],
                                         const uint32_t (&a)[D / 16][4],
                                         uint32_t tile, int r0, int lane,
                                         C c_of) {
  if constexpr (D == 16) {
    // one ldmatrix: b0, b1 of n-tile n, then of n + 1
#pragma unroll
    for (int n = 0; n < 8; n += 2) {
      uint32_t b[4];
      ldsm_x4(b, tile + sw_chunk<D>(r0 + n * 8 + (lane & 7) +
                                        ((lane >> 4) << 3),
                                    (lane >> 3) & 1));
      mma_bf16_c(acc[n], a[0], b[0], b[1], c_of(n));
      mma_bf16_c(acc[n + 1], a[0], b[2], b[3], c_of(n + 1));
    }
  } else {
    // one ldmatrix: b0, b1 of k-step 0, then of k-step 1
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      uint32_t b[4];
      ldsm_x4(b, tile + sw_chunk<D>(r0 + n * 8 + (lane & 7), lane >> 3));
      mma_bf16_c(acc[n], a[0], b[0], b[1], c_of(n));
      mma_bf16(acc[n], a[1], b[2], b[3]);
    }
  }
}

// acc[D / 8][4] (16 x D) += X (16 x 64, the C fragments x[8][4], rounded to
// bf16) . M, M the 64 rows from r0 of a swizzled tile (D columns)
template <int D>
__device__ __forceinline__ void mma_xm_rows(float (&acc)[D / 8][4],
                                            const float (&x)[8][4],
                                            uint32_t tile, int r0,
                                            int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t xf[4];  // the C fragments of n-tiles 2j, 2j+1 are the A of step j
    xf[0] = pack_bf16(x[2 * j][0], x[2 * j][1]);
    xf[1] = pack_bf16(x[2 * j][2], x[2 * j][3]);
    xf[2] = pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]);
    xf[3] = pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3]);
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t mf[4];  // b0, b1 of d-tile n, then of d-tile n + 1
      ldsm_x4_t(mf, tile + sw_chunk<D>(r0 + j * 16 + (lane & 7) +
                                           ((lane >> 3) & 1) * 8,
                                       n + (lane >> 4)));
      mma_bf16(acc[n], xf, mf[0], mf[1]);
      mma_bf16(acc[n + 1], xf, mf[2], mf[3]);
    }
  }
}

// the key chunks [lo, hi) the 64-row query tile at q0 walks (the band's:
// up to the diagonal when causal, from its lower edge under a window)
__host__ __device__ __forceinline__ void dq_small_band(int q0, int T_len,
                                                       int causal, int window,
                                                       int& lo, int& hi) {
  lo = 0;
  hi = (T_len + SM_CHUNK - 1) / SM_CHUNK;
  if (causal) {
    const int diag = (q0 + SM_ROWS - 1) / SM_CHUNK + 1;
    if (diag < hi) hi = diag;
    if (window > 0 && q0 - window + 1 > 0) lo = (q0 - window + 1) / SM_CHUNK;
    if (lo > hi) lo = hi;
  }
}

}  // namespace
