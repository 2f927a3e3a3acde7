// K1 and K2: flash attention forward (causal, full, or causal with a
// sliding window), for Hopper (sm_90a).
//
// Replaces ray_tpu/ops/flash_attention.py:_fwd_kernel_loop (K1, reached
// through _flash_fwd_loop) and _fwd_kernel_stream (K2, the sliding window,
// reached through _flash_fwd with window > 0): out = softmax(q k^T /
// sqrt(D)) v per query head, with the log-sum-exp of each row, q [B, S, H,
// D], k/v [B, T, KV, D], GQA through kv_head = h / (H / KV) with no K/V
// broadcast. Under a window W (causal only) key t is visible to query s iff
// 0 <= s - t < W; a query tile then starts at the K/V tile holding key
// q0 - W + 1, so tiles below the band are never loaded and the cost is
// O(S * W), which is what K2's clamped index map buys on the TPU. K2 is
// the WINDOW instantiation of the same kernels, so K1's code is unchanged.
//
// Bound on this card: causal attention does 2 * S^2 * D flops a head against
// 8 * S * D bytes of bf16 q/k/v/o, ~S/4 flops a byte, so prefill buckets up
// to ~1200 tokens are bound by bytes and longer ones by tensor-core
// operations. Either way the S x T scores must never reach device memory.
// One block of 4 warps owns a 64-row query tile (16 rows a warp) of one
// (batch, head) and streams 64-row K/V tiles up to the diagonal when causal
// (the tiles above it are never loaded).
//
// bf16 (the serving path), FlashAttention-2 style: the Q fragments, the
// scores, the probabilities and the f32 output accumulator all live in
// registers, in the layouts of mma.sync.m16n8k16 (the score accumulators
// are repacked in place as the A operand of p.v); K/V tiles reach shared
// memory through cp.async, double-buffered so the next tile loads while
// this one computes, and reach the tensor cores through ldmatrix (.trans
// for V). Rows are padded by 16 bytes so the 8 rows of an ldmatrix hit
// distinct banks. p is rounded to bf16 before p.v and l sums the f32 p, as
// the TPU kernel does. wgmma/TMA is later work.
//
// f32 (parity runs): exact f32 FMAs on the CUDA cores through shared-memory
// tiles, so the f32 path agrees with the plain version to rounding.
//
// The ragged edge (S or T not a multiple of 64) is masked: rows past T are
// zero-filled and scored -1e30, rows past S are not stored. A row whose
// keys in a tile are all masked (the band's first tile under a window)
// gets p = 0 there: the exponent is taken against 0 while the row's
// running max is still -1e30.

#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int BQ = 64;   // query rows a block
constexpr int BK = 64;   // key rows a tile
constexpr int NT = 128;  // 4 warps x 16 query rows

// ------------------------------------------------------------------ bf16 ---

template <int D, bool CAUSAL, bool WINDOW>
__global__ void __launch_bounds__(NT) flash_fwd_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int S, int T_len, int H, int KV, int window,
    float scale) {
  constexpr int LD = D + 8;  // padded row (elements): conflict-free ldmatrix
  constexpr int KS = D / 16;  // k-steps of Q.K^T
  constexpr int NS = BK / 8;  // 8-key n-tiles of the scores
  constexpr int ND = D / 8;   // 8-wide d-tiles of the output
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [BQ, LD]
  __nv_bfloat16* Ks = Qs + BQ * LD;   // [2][BK, LD]
  __nv_bfloat16* Vs = Ks + 2 * BK * LD;  // [2][BK, LD]

  // causal tiles near the end do the most work: schedule them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // row within the 8-row half of an mma tile
  const int t4 = lane & 3;   // column pair within an 8-column n-tile

  const size_t q_stride = (size_t)H * D;
  const size_t kv_stride = (size_t)KV * D;
  const __nv_bfloat16* qb = q + ((size_t)b * S * H + h) * D;
  const __nv_bfloat16* kb = k + ((size_t)b * T_len * KV + kvh) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * T_len * KV + kvh) * D;

  int n_k = (T_len + BK - 1) / BK;
  int kt_lo = 0;
  if (CAUSAL) {
    n_k = min(n_k, (q0 + BQ - 1) / BK + 1);  // up to the diagonal
    if (WINDOW) kt_lo = max(0, q0 - window + 1) / BK;  // band's start
  }

  async_rows<D, LD, NT>(Qs, qb + (size_t)q0 * q_stride, q_stride, S - q0, BQ);
  {
    const int k0 = kt_lo * BK;
    async_rows<D, LD, NT>(Ks, kb + (size_t)k0 * kv_stride, kv_stride, T_len - k0,
                      BK);
    async_rows<D, LD, NT>(Vs, vb + (size_t)k0 * kv_stride, kv_stride, T_len - k0,
                      BK);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this warp's 16 query rows as A fragments, one per 16-wide k-step
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldmatrix_x4(qf[ks], Qs + (warp * 16 + (lane & 15)) * LD + ks * 16 +
                            (lane >> 4) * 8);

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_a = -1e30f, m_b = -1e30f;  // rows g and g + 8 of the warp's tile
  float l_a = 0.f, l_b = 0.f;        // this thread's share of the row sums
  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;

  for (int kt = kt_lo; kt < n_k; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    const int k0 = kt * BK;
    if (kt + 1 < n_k) {
      // the other stage was released by the barrier ending iteration kt-1
      const int k1 = k0 + BK;
      async_rows<D, LD, NT>(Ks + (stage ^ 1) * BK * LD, kb + (size_t)k1 * kv_stride,
                        kv_stride, T_len - k1, BK);
      async_rows<D, LD, NT>(Vs + (stage ^ 1) * BK * LD, vb + (size_t)k1 * kv_stride,
                        kv_stride, T_len - k1, BK);
      cp_async_commit();
      cp_async_wait<1>();  // tile kt has landed, tile kt+1 may be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + stage * BK * LD;
    const __nv_bfloat16* Vt = Vs + stage * BK * LD;

    // scores: s[n] holds keys k0 + 8n + 2*t4 + {0,1} of rows g (0,1), g+8 (2,3)
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      if constexpr (KS % 2 == 0) {
#pragma unroll
        for (int ks = 0; ks < KS; ks += 2) {
          uint32_t kf[4];  // b0, b1 of k-step ks, then of ks + 1
          ldmatrix_x4(kf, Kt + (n * 8 + (lane & 7)) * LD + ks * 16 +
                              (lane >> 3) * 8);
          mma_bf16(s[n], qf[ks], kf[0], kf[1]);
          mma_bf16(s[n], qf[ks + 1], kf[2], kf[3]);
        }
      } else {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t kf[2];
          ldmatrix_x2(kf, Kt + (n * 8 + (lane & 7)) * LD + ks * 16 +
                              ((lane >> 3) & 1) * 8);
          mma_bf16(s[n], qf[ks], kf[0], kf[1]);
        }
      }
    }

    // mask (only tiles that cross the diagonal or the ragged edge), then the
    // online-softmax step; a row's 4 threads (same g) combine by shuffles
    const bool edge =
        k0 + BK > T_len || (CAUSAL && k0 + BK - 1 > q0 + warp * 16) ||
        (WINDOW && q0 + warp * 16 + 15 - k0 >= window);
    float mx_a = -1e30f, mx_b = -1e30f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (edge) {
          const int col = k0 + n * 8 + t4 * 2 + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          if (col >= T_len ||
              (CAUSAL && (col > row || (WINDOW && row - col >= window))))
            x = -1e30f;
        }
        s[n][e] = x;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a);
    const float mn_b = fmaxf(m_b, mx_b);
    const float al_a = expf(m_a - mn_a);
    const float al_b = expf(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    // under a window a row may have no visible key yet: exp against 0
    // gives its masked p = 0 (without one, key 0 is in every row's first
    // tile)
    const float e_a = WINDOW && mn_a <= -1e29f ? 0.f : mn_a;
    const float e_b = WINDOW && mn_b <= -1e29f ? 0.f : mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = expf(s[n][0] - e_a);
      s[n][1] = expf(s[n][1] - e_a);
      s[n][2] = expf(s[n][2] - e_b);
      s[n][3] = expf(s[n][3] - e_b);
      sum_a += s[n][0] + s[n][1];
      sum_b += s[n][2] + s[n][3];
    }
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= al_a;
      acc[n][1] *= al_a;
      acc[n][2] *= al_b;
      acc[n][3] *= al_b;
    }

    // acc += p . V; the score accumulators of n-tiles 2j, 2j+1 are exactly
    // the A fragment of the 16-key step j
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t pf[4];
      pf[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      pf[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      pf[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pf[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t vf[4];  // b0, b1 of d-tile n, then of d-tile n + 1
        ldmatrix_x4_trans(vf, Vt + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                       LD + n * 8 + (lane >> 4) * 8);
        mma_bf16(acc[n], pf, vf[0], vf[1]);
        mma_bf16(acc[n + 1], pf, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row_b : row_a;
    if (row >= S) continue;
    const float inv = half ? inv_b : inv_a;
    __nv_bfloat16* orow = o + (((size_t)b * S + row) * H + h) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(
          acc[n][half * 2] * inv, acc[n][half * 2 + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + t4 * 2) = pair;
    }
    if (t4 == 0) {
      const float l = half ? l_b : l_a;
      const float m = half ? m_b : m_a;
      lse[((size_t)b * H + h) * S + row] = m + logf(fmaxf(l, 1e-30f));
    }
  }
}

// ------------------------------------------------------------------- f32 ---

template <int D>
struct F32Tile {
  static constexpr int LD = D + 1;   // staggers banks for column-wise reads
  static constexpr int PLD = BK + 1;
  static constexpr int OLD = D;
  static constexpr size_t kBytes =
      sizeof(float) * ((size_t)(BQ + 2 * BK) * LD + (size_t)BQ * PLD +
                       (size_t)BQ * OLD + 3 * BQ);
};

template <int D, bool CAUSAL, bool WINDOW>
__global__ void __launch_bounds__(NT) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int S, int T_len, int H, int KV, int window,
    float scale) {
  using L = F32Tile<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [BQ, LD]
  float* Ks = Qs + BQ * L::LD;                 // [BK, LD]
  float* Vs = Ks + BK * L::LD;                 // [BK, LD]
  float* Ps = Vs + BK * L::LD;                 // [BQ, PLD] scores, then p
  float* Os = Ps + BQ * L::PLD;                // [BQ, OLD]
  float* m_sh = Os + BQ * L::OLD;              // [BQ]
  float* l_sh = m_sh + BQ;                     // [BQ]
  float* a_sh = l_sh + BQ;                     // [BQ]

  // causal tiles near the end do the most work: schedule them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0 = warp * 16;

  const size_t q_stride = (size_t)H * D;
  const size_t kv_stride = (size_t)KV * D;
  const float* qb = q + ((size_t)b * S * H + h) * D;
  const float* kb = k + ((size_t)b * T_len * KV + kvh) * D;
  const float* vb = v + ((size_t)b * T_len * KV + kvh) * D;

  auto load = [&](float* dst, const float* src, size_t stride, int valid) {
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D;
      const int c = i - r * D;
      dst[r * L::LD + c] = r < valid ? src[(size_t)r * stride + c] : 0.f;
    }
  };
  load(Qs, qb + (size_t)q0 * q_stride, q_stride, S - q0);
  for (int i = tid; i < BQ * L::OLD; i += NT) Os[i] = 0.f;
  for (int i = tid; i < BQ; i += NT) {
    m_sh[i] = -1e30f;
    l_sh[i] = 0.f;
  }

  int n_k = (T_len + BK - 1) / BK;
  int kt_lo = 0;
  if (CAUSAL) {
    n_k = min(n_k, (q0 + BQ - 1) / BK + 1);
    if (WINDOW) kt_lo = max(0, q0 - window + 1) / BK;
  }

  for (int kt = kt_lo; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K/V are no longer read
    load(Ks, kb + (size_t)k0 * kv_stride, kv_stride, T_len - k0);
    load(Vs, vb + (size_t)k0 * kv_stride, kv_stride, T_len - k0);
    __syncthreads();

    const float* Qw = Qs + r0 * L::LD;
    float* Pw = Ps + r0 * L::PLD;
    float* Ow = Os + r0 * L::OLD;
    // lane owns key columns lane and lane + 32 of the warp's 16 rows
    float s0[16], s1[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s0[i] = s1[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float k0v = Ks[lane * L::LD + d];
      const float k1v = Ks[(lane + 32) * L::LD + d];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float qv = Qw[i * L::LD + d];
        s0[i] = fmaf(qv, k0v, s0[i]);
        s1[i] = fmaf(qv, k1v, s1[i]);
      }
    }
    // mask, then the online-softmax step, one row at a time
    for (int i = 0; i < 16; ++i) {
      const int qpos = q0 + r0 + i;
      const int c0 = k0 + lane;
      const int c1 = c0 + 32;
      float x0 = s0[i] * scale;
      float x1 = s1[i] * scale;
      if (c0 >= T_len || (CAUSAL && (c0 > qpos ||
                                     (WINDOW && qpos - c0 >= window))))
        x0 = -1e30f;
      if (c1 >= T_len || (CAUSAL && (c1 > qpos ||
                                     (WINDOW && qpos - c1 >= window))))
        x1 = -1e30f;
      const float m_old = m_sh[r0 + i];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      // under a window a row may have no visible key yet: p = 0
      const float m_exp = WINDOW && m_new <= -1e29f ? 0.f : m_new;
      const float p0 = expf(x0 - m_exp);
      const float p1 = expf(x1 - m_exp);
      const float sum = warp_sum(p0 + p1);
      Pw[i * L::PLD + lane] = p0;
      Pw[i * L::PLD + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_sh[r0 + i] = alpha;
        l_sh[r0 + i] = l_sh[r0 + i] * alpha + sum;
        m_sh[r0 + i] = m_new;
      }
    }
    __syncwarp();
    for (int i = 0; i < 16; ++i) {
      const float alpha = a_sh[r0 + i];
      for (int d = lane; d < D; d += 32) {
        float a = Ow[i * L::OLD + d] * alpha;
        for (int j = 0; j < BK; ++j)
          a = fmaf(Pw[i * L::PLD + j], Vs[j * L::LD + d], a);
        Ow[i * L::OLD + d] = a;
      }
    }
  }
  __syncwarp();

  for (int i = 0; i < 16; ++i) {
    const int qpos = q0 + r0 + i;
    if (qpos >= S) break;
    const float l = fmaxf(l_sh[r0 + i], 1e-30f);
    float* orow = o + (((size_t)b * S + qpos) * H + h) * D;
    for (int d = lane; d < D; d += 32) orow[d] = Os[(r0 + i) * L::OLD + d] / l;
    if (lane == 0) lse[((size_t)b * H + h) * S + qpos] = m_sh[r0 + i] + logf(l);
  }
}

// --------------------------------------------------------------- launch ---

template <int D>
int launch_d(int dtype, int causal, int window, const void* q,
             const void* k, const void* v, void* o, void* lse, int B, int S,
             int T_len, int H, int KV, float scale, cudaStream_t st) {
  if (dtype == RT_BF16) {
    using T = __nv_bfloat16;
    const size_t smem = sizeof(T) * (size_t)(BQ + 4 * BK) * (D + 8);
    auto kernel = window > 0 ? flash_fwd_bf16_kernel<D, true, true>
                  : causal   ? flash_fwd_bf16_kernel<D, true, false>
                             : flash_fwd_bf16_kernel<D, false, false>;
    cudaError_t err = rt_set_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((S + BQ - 1) / BQ, H, B);
    kernel<<<grid, NT, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o),
        static_cast<float*>(lse), S, T_len, H, KV, window, scale);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == RT_F32) {
    const size_t smem = F32Tile<D>::kBytes;
    auto kernel = window > 0 ? flash_fwd_f32_kernel<D, true, true>
                  : causal   ? flash_fwd_f32_kernel<D, true, false>
                             : flash_fwd_f32_kernel<D, false, false>;
    cudaError_t err = rt_set_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((S + BQ - 1) / BQ, H, B);
    kernel<<<grid, NT, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o),
        static_cast<float*>(lse), S, T_len, H, KV, window, scale);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// window 0: no window (K1); window > 0 needs causal (K2)
extern "C" int flash_attention_fwd(int dtype, int causal, int window,
                                   const void* q, const void* k,
                                   const void* v, void* o, void* lse, int B,
                                   int S, int T_len, int H, int KV, int D,
                                   float scale, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (KV <= 0 || H % KV != 0 || T_len <= 0 || window < 0 ||
      (window > 0 && !causal))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_d<16>(dtype, causal, window, q, k, v, o, lse, B, S, T_len, H, KV, scale, st);
    case 32: return launch_d<32>(dtype, causal, window, q, k, v, o, lse, B, S, T_len, H, KV, scale, st);
    case 64: return launch_d<64>(dtype, causal, window, q, k, v, o, lse, B, S, T_len, H, KV, scale, st);
    case 128: return launch_d<128>(dtype, causal, window, q, k, v, o, lse, B, S, T_len, H, KV, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
