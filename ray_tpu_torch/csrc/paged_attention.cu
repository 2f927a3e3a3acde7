// K6: fused paged decode write-and-attend, and K5: read-only paged decode
// attention, for Hopper (sm_90a). One split kernel serves both, with a
// WRITE template parameter, the way K2 is K1's WINDOW instantiation, and a
// merge pass follows it.
//
// K6 replaces ray_tpu/ops/paged_attention.py:_kernel_inplace (reached
// through paged_decode_attention_inplace): for every decode slot, write the
// new token's k/v at position length-1 of the slot's tip page, then attend
// the slot's query heads over all of its cached tokens.
// K5 replaces ray_tpu/ops/paged_attention.py:_kernel (reached through
// paged_attention): the same attention with the write taken out. Every K/V
// row, the one at length-1 included, is read from the pool, and the pools
// are never written.
//
// Bound on this card: device-memory bytes. Each live slot reads its
// length * HD * 2 (K and V) values per kv head once and does 4 G flops per
// K/V pair, far below the 295 flops/byte where bf16 tensor cores would
// bound it. So the kernel must read every live K/V value once (and of the
// dead ones at most the rest of a slot's last 16-row group), with enough
// bytes in flight on every SM (3.35 TB/s x ~1 us of latency: ~25 KB an
// SM), and spend little on anything else.
//
// bf16 at head dims up to 256 that are a multiple of 8 (every preset and
// public shape but DeepSeek-V4-Flash's 512): paged_decode_ring_kernel, the reference's own page-by-page
// algorithm (grid (S, KV, maxP); [G, HD] . [HD, ps] scores, an online max
// and sum, acc += P V a page) in Hopper's terms:
//   * a split of pps pages a block: grid (splits, S, KV x head chunks),
//     the splits of a (slot, kv head) side by side. The host picks pps
//     from S, KV, the chunks and maxP alone (lengths live on the card):
//     the launch aims at ~16 blocks an SM if every slot were full, pps =
//     ceil(S KV chunks maxP / (16 x 132)), since a slot uses a fraction of
//     its maxP pages and the blocks past its length exit at once: 8 pages
//     at the 7b serving shape, 2 at the 1b preset's, one page a split
//     where S x KV is small (Gemma-2B's one kv head), where the old fixed
//     256 tokens left 8 blocks to a 2,048-token slot and 128 in all;
//   * pages copied asynchronously into a ring with full/empty mbarriers: a
//     producer warp reads the split's page-table row once and loads 16 keys
//     a stage by TMA through a 4-D tensor map of each pool (dims (HD, ps,
//     NP, KV): the page is a coordinate, so one map serves every page; the
//     maps are encoded once per pool and kept, not at each launch), in
//     boxes of 32 columns by 16 rows with the 64-byte swizzle, so ldmatrix
//     reads are free of bank conflicts (16- or 8-column boxes where 32 does
//     not divide HD; rows per copy cut to the page size's largest power-of-
//     two factor). Per-row cp.async.bulk copies into padded rows ran at
//     ~36 SM cycles a copy (550K of them at the 7b shape): the op rate,
//     not the bytes, held them to ~1.9 TB/s; cp.async from the producer
//     warp was slower still (PERF.md);
//   * one pass a stage: each of 4 consumer warps owns its own ring slots,
//     waits only on them and walks every 4th stage: S^T = K q^T by
//     mma.sync m16n8k16 (the 16 keys as M, up to 8 query heads as N, q's B
//     fragments held in registers), the online max and sum in registers
//     (a head's max over the stage combines over 8 lanes: 3 shuffles a
//     stage, not a tree a key), then O^T += V^T P^T with V read by
//     ldmatrix.trans and P^T made from the score accumulators by movmatrix.
//     P goes in as two bf16 terms (hi, lo) so the product keeps f32
//     precision (kernel_tolerance holds one bf16 ulp of o). A copy brings
//     whole box rows, so the rows past a slot's length in its last page are
//     masked (the scores to -inf, V's fragments to zero) on the last
//     stage's own path. No score array, no second sweep over V, no
//     block-wide barrier in the walk. G 1 takes the same path: the padded
//     products are free;
//   * the warps' states merge through shared memory at the block's end; a
//     slot whose pages fit one split gets its output there, the others
//     leave (max, sum, unnormalized o) in f32 for the merge pass, which
//     runs one thread an output (slot, query head, column) over the splits
//     in their order, 16 splits' loads in flight at once: deterministic,
//     no atomics on the output.
//
// f32 (parity runs): paged_decode_split_kernel at G 1, 2, 4, 8 and rows of
// a power of two of 16-byte chunks (every preset), else
// paged_decode_split_any_kernel (as bf16 at HD 100, and bf16 and f32 at
// every head dim above 256, where p . V walks the split's V rows once for
// each 1,024 columns in bf16 and 512 in f32): CUDA-core FMAs on
// 16-byte loads (or one element where HD is not a multiple of a vector),
// 256-token splits, the scores of a split in shared memory and an exact
// softmax there, HD / 4 lanes (or a power of two of lanes, with a lane
// stride) sharing a row. The any-shape kernel takes the same chunks of at
// most 8 query heads as the ring kernel; the fixed kernel stayed for f32,
// where the any-shape one ran the 7b and 1b shapes 25-65% slower.
//
// K6's new token: its k/v rows come from k_new/v_new (a separate input).
// In the ring kernel a bulk copy brings them beside the ring, and the
// consumer warp whose stage holds the new token lays them over the stale
// pool row that stage's copy brought; the merge pass, a later kernel,
// stores them into the pools, so no copy of this launch reads a row that a
// generic store wrote. In the f32 and any-shape kernels the one block
// whose split holds the tip page holds them in shared memory and writes
// them. Only that ONE row is written to each pool -- the TPU kernel
// flushed the whole tip page -- so page 0 (trash) and prefix-shared pages
// are never written. Slots of length 0 write nothing and output zeros
// (callers mask them).

#include <cmath>
#include <cstdint>
#include <mutex>
#include <unordered_map>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int K6_THREADS = 128;
constexpr int K6_WARPS = K6_THREADS / 32;

// 16-byte vectors of the element type
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};

// one 16-byte vector from p as f32; a bf16 is the high half of its f32,
// so each widens by a shift of the loaded words
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[Vec<T>::N]);
template <>
__device__ __forceinline__ void load_vec<float>(const float* p,
                                                float (&out)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16>(
    const __nv_bfloat16* p, float (&out)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Pass 1 in f32 at G in {1, 2, 4, 8} and rows of a power of two of 16-byte
// chunks (every preset): one block per (slot, kv head, split) of `tps`
// tokens. WRITE: K6 (the new token from k_new/v_new, written to the pools);
// else K5 (k_new and v_new unused, the pools only read).
template <typename T, int G, bool WRITE>
__global__ void __launch_bounds__(K6_THREADS) paged_decode_split_kernel(
    const T* __restrict__ q,         // [S, H, HD]
    const T* __restrict__ k_new,     // [S, KV, HD]
    const T* __restrict__ v_new,     // [S, KV, HD]
    T* k_pool,                       // [KV, NP, ps, HD], written if WRITE
    T* v_pool,                       // [KV, NP, ps, HD], written if WRITE
    const int* __restrict__ page_table,  // [S, maxP]
    const int* __restrict__ lengths,     // [S], including the new token
    float* __restrict__ part_o,      // [S, KV, n_split, G, HD] unnormalized
    float* __restrict__ part_ml,     // [S, KV, n_split, G, 2] (max, sum)
    int KV, int NP, int ps, int HD, int maxP, int pps, int n_split,
    float scale) {
  constexpr int VEC = Vec<T>::N;
  const int s = blockIdx.x;
  const int kv = blockIdx.y;
  const int split = blockIdx.z;
  const int length = lengths[s];
  const int n_pages = (length + ps - 1) / ps;
  const int p0 = split * pps;
  if (length <= 0 || p0 >= n_pages) return;
  const int tps = pps * ps;
  const int t0 = p0 * ps;
  const int n_tok = min(tps, length - t0);
  const int pos = length - 1;
  const bool has_tip = WRITE && pos >= t0 && pos < t0 + tps;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int H = KV * G;

  extern __shared__ float smem[];
  float* q_sh = smem;             // [G * HD]
  float* kn = q_sh + G * HD;      // [HD] new token's k (pool dtype, as f32)
  float* vn = kn + HD;            // [HD]
  float* sc = vn + HD;            // [G * tps] scores, then probabilities
  float* red = sc + G * tps;      // [TG * G * HD] partial p.v sums
  float* ml = red + (K6_THREADS / (HD / VEC)) * G * HD;  // [G * 2]

  const int* pt = page_table + (size_t)s * maxP;
  if (has_tip) {
    const size_t row =
        (((size_t)kv * NP + pt[pos / ps]) * ps + pos % ps) * HD;
    const T* kn_g = k_new + ((size_t)s * KV + kv) * HD;
    const T* vn_g = v_new + ((size_t)s * KV + kv) * HD;
    for (int d = tid; d < HD; d += K6_THREADS) {
      const T kx = kn_g[d];
      const T vx = vn_g[d];
      k_pool[row + d] = kx;
      v_pool[row + d] = vx;
      kn[d] = to_f32(kx);
      vn[d] = to_f32(vx);
    }
  }
  const T* qg = q + ((size_t)s * H + (size_t)kv * G) * HD;
  for (int e = tid; e < G * HD; e += K6_THREADS) q_sh[e] = to_f32(qg[e]);
  __syncthreads();

  const size_t head_base = (size_t)kv * NP * ps * HD;
  // scores: lpt lanes share one K row (VEC elements a lane)
  {
    const int lpt = HD / VEC;
    const int tpw = 32 / lpt;              // rows per warp instruction
    const int c = lane % lpt;
    const float* qc = q_sh + c * VEC;
    // the loop bound is uniform across the warp (the shuffles need every
    // lane); a lane group past the end computes zeros and stores nothing
#pragma unroll 4
    for (int ib = warp * tpw; ib < n_tok; ib += K6_WARPS * tpw) {
      const int i = ib + lane / lpt;
      const int t = t0 + i;
      float k[VEC];
      if (i >= n_tok) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) k[e] = 0.f;
      } else if (WRITE && t == pos) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) k[e] = kn[c * VEC + e];
      } else {
        load_vec<T>(k_pool + head_base + ((size_t)pt[t / ps] * ps + t % ps) *
                                             HD + c * VEC, k);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) part = fmaf(qc[g * HD + e], k[e], part);
        for (int o = lpt / 2; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        if (c == 0 && i < n_tok) sc[g * tps + i] = part * scale;
      }
    }
  }
  __syncthreads();

  // exact softmax over the split: one warp per query row
  for (int g = warp; g < G; g += K6_WARPS) {
    float mx = -1e30f;
    for (int i = lane; i < n_tok; i += 32) mx = fmaxf(mx, sc[g * tps + i]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int i = lane; i < n_tok; i += 32) {
      const float p = expf(sc[g * tps + i] - mx);
      sc[g * tps + i] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      ml[g * 2] = mx;
      ml[g * 2 + 1] = sum;
    }
  }
  __syncthreads();

  // p . V: a thread owns VEC columns of every query row and every TG-th token
  {
    const int dcs = HD / VEC;
    const int tg_n = K6_THREADS / dcs;
    const int tg = tid / dcs;
    const int dc = tid % dcs;
    float acc[G][VEC];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
#pragma unroll 4
    for (int i = tg; i < n_tok; i += tg_n) {
      const int t = t0 + i;
      float v[VEC];
      if (WRITE && t == pos) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[e] = vn[dc * VEC + e];
      } else {
        load_vec<T>(v_pool + head_base + ((size_t)pt[t / ps] * ps + t % ps) *
                                             HD + dc * VEC, v);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = sc[g * tps + i];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, v[e], acc[g][e]);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        red[(tg * G + g) * HD + dc * VEC + e] = acc[g][e];
    __syncthreads();
    const size_t part = ((size_t)s * KV + kv) * n_split + split;
    for (int e = tid; e < G * HD; e += K6_THREADS) {
      float a = 0.f;
      for (int j = 0; j < tg_n; ++j) a += red[j * G * HD + e];
      part_o[part * G * HD + e] = a;
    }
    for (int e = tid; e < G * 2; e += K6_THREADS)
      part_ml[part * G * 2 + e] = ml[e];
  }
}

template <typename T, int VW>
__device__ __forceinline__ void load_chunk(const T* p, float (&out)[VW]) {
  if constexpr (VW == Vec<T>::N) {
    load_vec<T>(p, out);
  } else {
#pragma unroll
    for (int i = 0; i < VW; ++i) out[i] = to_f32(p[i]);
  }
}

constexpr int GC_MAX = 8;  // query heads a block of the any-shape kernel

// Pass 1 for any G and any HD: one block per (slot, kv head x chunk of gcn
// query heads, split). VW: elements a lane loads at once (a 16-byte vector
// where HD is a multiple of one, else 1). Rows of more than MAXC * 128
// chunks (HD above 1,024 in bf16, 512 in f32, 256 with VW 1) take p . V in
// passes of that many chunks, each a walk over the split's V rows. (Without
// the minimum of one block an SM in its launch bounds, ptxas spilled 8-20
// bytes in two instances.)
template <typename T, int VW, bool WRITE>
__global__ void __launch_bounds__(K6_THREADS, 1) paged_decode_split_any_kernel(
    const T* __restrict__ q, const T* __restrict__ k_new,
    const T* __restrict__ v_new, T* k_pool, T* v_pool,
    const int* __restrict__ page_table, const int* __restrict__ lengths,
    float* __restrict__ part_o, float* __restrict__ part_ml, int KV, int G,
    int gcn, int n_chunks, int NP, int ps, int HD, int maxP, int pps,
    int n_split, float scale) {
  // chunks a thread owns in p . V: 2 only where a row has > 128 chunks
  constexpr int MAXC = (256 / VW + K6_THREADS - 1) / K6_THREADS;
  const int s = blockIdx.x;
  const int kv = blockIdx.y / n_chunks;
  const int g0 = (blockIdx.y % n_chunks) * gcn;  // the chunk's first head
  const int gc = min(gcn, G - g0);
  const int split = blockIdx.z;
  const int length = lengths[s];
  const int n_pages = (length + ps - 1) / ps;
  const int p0 = split * pps;
  if (length <= 0 || p0 >= n_pages || gc <= 0) return;
  const int tps = pps * ps;
  const int t0 = p0 * ps;
  const int n_tok = min(tps, length - t0);
  const int pos = length - 1;
  // only the first chunk writes the new row; every chunk reads it from kn/vn
  const bool has_tip = WRITE && pos >= t0 && pos < t0 + tps;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int H = KV * G;
  const int nch = HD / VW;  // chunks a row
  const int tg_n = nch <= K6_THREADS ? K6_THREADS / nch : 1;

  extern __shared__ float smem[];
  float* q_sh = smem;              // [gcn * HD]
  float* kn = q_sh + gcn * HD;     // [HD]
  float* vn = kn + HD;             // [HD]
  float* sc = vn + HD;             // [gcn * tps]
  float* red = sc + gcn * tps;     // [tg_n * gcn * HD]
  float* ml = red + tg_n * gcn * HD;  // [gcn * 2]

  const int* pt = page_table + (size_t)s * maxP;
  if (has_tip) {
    const size_t row =
        (((size_t)kv * NP + pt[pos / ps]) * ps + pos % ps) * HD;
    const T* kn_g = k_new + ((size_t)s * KV + kv) * HD;
    const T* vn_g = v_new + ((size_t)s * KV + kv) * HD;
    for (int d = tid; d < HD; d += K6_THREADS) {
      const T kx = kn_g[d];
      const T vx = vn_g[d];
      if (g0 == 0) {
        k_pool[row + d] = kx;
        v_pool[row + d] = vx;
      }
      kn[d] = to_f32(kx);
      vn[d] = to_f32(vx);
    }
  }
  const T* qg = q + ((size_t)s * H + (size_t)kv * G + g0) * HD;
  for (int e = tid; e < gc * HD; e += K6_THREADS) q_sh[e] = to_f32(qg[e]);
  __syncthreads();

  const size_t head_base = (size_t)kv * NP * ps * HD;
  auto row_of = [&](int t, const T* pool) {
    return pool + head_base + ((size_t)pt[t / ps] * ps + t % ps) * HD;
  };
  // scores: a row's chunks over lpt lanes (a power of two), lane stride lpt
  {
    int lpt = 1;
    while (lpt < nch && lpt < 32) lpt <<= 1;
    const int tpw = 32 / lpt;  // rows per warp pass
    const int c = lane % lpt;
    // the loop bound is uniform across the warp (the shuffles need every
    // lane); a lane group past the end computes zeros and stores nothing
    for (int ib = warp * tpw; ib < n_tok; ib += K6_WARPS * tpw) {
      const int i = ib + lane / lpt;
      const int t = t0 + i;
      float part[GC_MAX];
#pragma unroll
      for (int g = 0; g < GC_MAX; ++g) part[g] = 0.f;
      if (i < n_tok) {
        const bool tip = WRITE && t == pos;
        const T* krow = tip ? nullptr : row_of(t, k_pool);
        for (int cc = c; cc < nch; cc += lpt) {
          float k[VW];
          if (tip) {
#pragma unroll
            for (int e = 0; e < VW; ++e) k[e] = kn[cc * VW + e];
          } else {
            load_chunk<T, VW>(krow + cc * VW, k);
          }
#pragma unroll
          for (int g = 0; g < GC_MAX; ++g) {
            if (g < gc) {
#pragma unroll
              for (int e = 0; e < VW; ++e)
                part[g] = fmaf(q_sh[g * HD + cc * VW + e], k[e], part[g]);
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GC_MAX; ++g) {
        if (g < gc) {
          float x = part[g];
          for (int o = lpt / 2; o > 0; o >>= 1)
            x += __shfl_xor_sync(0xffffffffu, x, o);
          if (c == 0 && i < n_tok) sc[g * tps + i] = x * scale;
        }
      }
    }
  }
  __syncthreads();

  // exact softmax over the split: one warp per query row
  for (int g = warp; g < gc; g += K6_WARPS) {
    float mx = -1e30f;
    for (int i = lane; i < n_tok; i += 32) mx = fmaxf(mx, sc[g * tps + i]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int i = lane; i < n_tok; i += 32) {
      const float p = expf(sc[g * tps + i] - mx);
      sc[g * tps + i] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      ml[g * 2] = mx;
      ml[g * 2 + 1] = sum;
    }
  }
  __syncthreads();

  // p . V: in a pass from chunk cb, a thread owns chunk cb + dc (and
  // cb + dc + 128) of every query row and every tg_n-th token
  const int tg = nch <= K6_THREADS ? tid / nch : 0;
  const int dc = nch <= K6_THREADS ? tid % nch : tid;
  for (int cb = 0; cb < nch; cb += MAXC * K6_THREADS) {
    float acc[GC_MAX][MAXC * VW];
#pragma unroll
    for (int g = 0; g < GC_MAX; ++g)
#pragma unroll
      for (int e = 0; e < MAXC * VW; ++e) acc[g][e] = 0.f;
    if (tg < tg_n) {
      for (int i = tg; i < n_tok; i += tg_n) {
        const int t = t0 + i;
        const bool tip = WRITE && t == pos;
        const T* vrow = tip ? nullptr : row_of(t, v_pool);
#pragma unroll
        for (int j = 0; j < MAXC; ++j) {
          const int cc = cb + dc + j * K6_THREADS;
          if (cc >= nch) continue;
          float v[VW];
          if (tip) {
#pragma unroll
            for (int e = 0; e < VW; ++e) v[e] = vn[cc * VW + e];
          } else {
            load_chunk<T, VW>(vrow + cc * VW, v);
          }
#pragma unroll
          for (int g = 0; g < GC_MAX; ++g) {
            if (g < gc) {
              const float p = sc[g * tps + i];
#pragma unroll
              for (int e = 0; e < VW; ++e)
                acc[g][j * VW + e] = fmaf(p, v[e], acc[g][j * VW + e]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < MAXC; ++j) {
        const int cc = cb + dc + j * K6_THREADS;
        if (cc >= nch) continue;
#pragma unroll
        for (int g = 0; g < GC_MAX; ++g) {
          if (g < gc) {
#pragma unroll
            for (int e = 0; e < VW; ++e)
              red[(tg * gc + g) * HD + cc * VW + e] = acc[g][j * VW + e];
          }
        }
      }
    }
  }
  __syncthreads();
  {
    const size_t part = ((size_t)s * KV + kv) * n_split + split;
    for (int e = tid; e < gc * HD; e += K6_THREADS) {
      float a = 0.f;
      for (int j = 0; j < tg_n; ++j) a += red[j * gc * HD + e];
      part_o[(part * G + g0) * HD + e] = a;
    }
    for (int e = tid; e < gc * 2; e += K6_THREADS)
      part_ml[(part * G + g0) * 2 + e] = ml[e];
  }
}

// Pass 2: merge the splits of each slot into o, one thread an output
// (slot s = blockIdx.y; query head and column from blockIdx.x), the splits
// summed in their order. direct: the ring kernel wrote the output of every
// slot that uses one split itself, so those are skipped; length-0 slots
// get zeros. K6 on the ring kernel (k_new given): each kv head's first
// query head's threads also store the new k/v row into the pools, after
// the split pass has read them.
template <typename T>
__global__ void __launch_bounds__(K6_THREADS) paged_decode_merge_kernel(
    const float* __restrict__ part_o, const float* __restrict__ part_ml,
    const int* __restrict__ lengths, T* __restrict__ out,
    const T* __restrict__ k_new, const T* __restrict__ v_new, T* k_pool,
    T* v_pool, const int* __restrict__ page_table, int KV, int G, int HD,
    int NP, int ps, int maxP, int pps, int n_split, int direct) {
  const int s = blockIdx.y;
  const int e = blockIdx.x * K6_THREADS + threadIdx.x;
  const int H = KV * G;
  if (e >= H * HD) return;
  const int length = lengths[s];
  const int h = e / HD;
  const int d = e - h * HD;
  if (k_new != nullptr && length > 0 && h % G == 0) {
    const int pos = length - 1;
    const int kv = h / G;
    const size_t row =
        (((size_t)kv * NP + page_table[(size_t)s * maxP + pos / ps]) * ps +
         pos % ps) * HD + d;
    k_pool[row] = k_new[((size_t)s * KV + kv) * HD + d];
    v_pool[row] = v_new[((size_t)s * KV + kv) * HD + d];
  }
  const int used = length > 0 ? ((length + ps - 1) / ps + pps - 1) / pps : 0;
  if (direct && used == 1) return;
  const int g = h % G;
  const size_t base = ((size_t)s * KV + h / G) * n_split;
  // the splits in batches of MJ, each batch's loads in flight at once (a
  // one-page split leaves up to maxP of them, and a pass costs its round
  // trips, not its math); a batch's max rescales the sums before it
  constexpr int MJ = 16;
  float m = -1e30f, l = 0.f, a = 0.f;
  for (int j0 = 0; j0 < used; j0 += MJ) {
    float mj[MJ], lj[MJ], oj[MJ];
#pragma unroll
    for (int k = 0; k < MJ; ++k) {
      const size_t r = (base + j0 + k) * G + g;
      const bool in = j0 + k < used;
      mj[k] = in ? part_ml[r * 2] : -1e30f;
      lj[k] = in ? part_ml[r * 2 + 1] : 0.f;
      oj[k] = in ? part_o[r * HD + d] : 0.f;
    }
    float mn = m;
#pragma unroll
    for (int k = 0; k < MJ; ++k) mn = fmaxf(mn, mj[k]);
    const float wo = expf(m - mn);
    l *= wo;
    a *= wo;
    m = mn;
#pragma unroll
    for (int k = 0; k < MJ; ++k) {
      const float w = expf(mj[k] - m);
      l = fmaf(lj[k], w, l);
      a = fmaf(oj[k], w, a);
    }
  }
  out[((size_t)s * H + h) * HD + d] =
      from_f32<T>(used > 0 ? a / fmaxf(l, 1e-30f) : 0.f);
}

template <typename T>
cudaError_t launch_merge(const void* part_o, const void* part_ml,
                         const void* lengths, void* out, const void* k_new,
                         const void* v_new, const void* k_pool,
                         const void* v_pool, const void* page_table, int S,
                         int KV, int G, int HD, int NP, int ps, int maxP,
                         int pps, int n_split, int direct,
                         cudaStream_t stream) {
  const int per_slot = (KV * G * HD + K6_THREADS - 1) / K6_THREADS;
  paged_decode_merge_kernel<T><<<dim3(per_slot, S), K6_THREADS, 0, stream>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
      static_cast<const int*>(lengths), static_cast<T*>(out),
      static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      const_cast<T*>(static_cast<const T*>(k_pool)),
      const_cast<T*>(static_cast<const T*>(v_pool)),
      static_cast<const int*>(page_table), KV, G, HD, NP, ps, maxP, pps,
      n_split, direct);
  return cudaGetLastError();
}

// ------------------------------------------------- bf16: the ring kernel ---

constexpr int RG_NW = 4;                 // consumer warps
constexpr int RG_NT = 32 * (RG_NW + 1);  // and the producer warp
constexpr int RG_KEYS = 16;              // keys a stage: one m-tile
constexpr int RG_HEADS = 8;              // query heads a block: one n-tile
constexpr int RG_RING = 32768;           // bytes a block's ring holds at least
constexpr float RG_LN2 = 0.6931471805599453f;

// How a ring block lays out its shared memory at head dim HD and page size
// ps. A stage holds 16 keys' K rows, then their V rows, each as nb TMA
// boxes of bc columns (32 where 32 divides HD, else 16 or 8) by 16 rows,
// written br rows a copy (16, or the largest power of two that divides ps:
// a copy stays inside one page). Where bc >= 16 and br >= 8 a box row is
// swizzled (64-byte at bc 32: 16-byte chunk c of row r at c ^ (r / 2 % 4);
// 32-byte at 16: c ^ (r / 4 % 2)), so the 8 rows an ldmatrix phase reads
// hit 8 bank groups; 16-byte rows (bc 8) are conflict-free as they lie.
// Slots are 1024-byte aligned. The ring holds at least RG_RING bytes (more
// than the ~25 KB that 3.35 TB/s x ~1 us of latency keeps in flight on one
// SM) in 1-4 slots a consumer warp; then the new k/v row (K6), a full and
// an empty mbarrier a slot and one for the new row, the warps' (max, sum)
// of 8 heads and the split's page ids. ops/paged_attention.py computes the
// same sizes.
struct RingSmem {
  int bc, lc, br, nb, swz, xs, rb, tensor, slot, depth, nslot, fresh, bar,
      ml, pg;
  size_t bytes;
  __host__ __device__ RingSmem(int HD, int ps, int pps) {
    bc = HD % 32 == 0 ? 32 : HD % 16 == 0 ? 16 : 8;
    lc = bc == 32 ? 2 : bc == 16 ? 1 : 0;
    const int low = ps & -ps;
    br = low < RG_KEYS ? low : RG_KEYS;
    nb = HD / bc;
    swz = bc >= 16 && br >= 8;
    xs = 3 - lc;
    rb = 2 * bc;
    tensor = nb * RG_KEYS * rb;
    slot = (2 * tensor + 1023) / 1024 * 1024;
    depth = (RG_RING + RG_NW * slot - 1) / (RG_NW * slot);
    depth = depth < 1 ? 1 : depth > 4 ? 4 : depth;
    nslot = RG_NW * depth;
    fresh = nslot * slot;
    bar = fresh + 4 * HD;
    ml = bar + 8 * (2 * nslot + 1);
    pg = ml + 4 * RG_NW * RG_HEADS * 2;
    bytes = pg + 4 * ((pps + 3) / 4 * 4) + 1024;  // + the alignment
  }
  // shared-memory offset of 16-byte chunk ch of stage row r in a tensor
  __device__ __forceinline__ uint32_t at(int r, int ch) const {
    const int m = (1 << lc) - 1;
    const int x = swz ? (r >> xs) & m : 0;
    return (ch >> lc) * (RG_KEYS * rb) + r * rb + (((ch & m) ^ x) << 4);
  }
};

// One block per (slot, kv head x chunk of gcn <= 8 query heads, split of
// pps pages). Warp 4 (the producer) loads the split's K and V 16 keys a
// stage by TMA (tm_k, tm_v: 4-D maps of the pools, dims (HD, ps, NP, KV)),
// stage i into a slot of consumer warp i % 4, with full and empty
// mbarriers. Each consumer warp walks its own stages: S^T = K q^T by
// mma.sync (keys as M, the chunk's query heads as N, q's B fragments in
// registers for the whole walk), the online softmax in registers, then
// O^T += V^T P^T (V by ldmatrix.trans, P by movmatrix from the scores'
// accumulators), with no block-wide barrier. A copy brings whole box rows:
// the rows past the slot's length in its last page are masked, in scores
// and in V, on the last stage's own path. K6: the new k/v row comes by a
// bulk copy of k_new/v_new beside the ring and replaces the stale pool row
// in its stage once that stage has landed; the merge pass stores it into
// the pools. NKS: the 16-dim k-steps the instance holds (HD <= 16 NKS); BC:
// the boxes' columns (RingSmem::bc).
template <int NKS, int BC, bool WRITE>
__global__ void __launch_bounds__(RG_NT) paged_decode_ring_kernel(
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_new,
    const __nv_bfloat16* __restrict__ v_new,
    const int* __restrict__ page_table, const int* __restrict__ lengths,
    __nv_bfloat16* __restrict__ out, float* __restrict__ part_o,
    float* __restrict__ part_ml, int KV, int G, int gcn, int n_chunks,
    int ps, int HD, int maxP, int pps, int n_split, float scale_log2) {
  // the splits of a (slot, kv head, chunk) are neighbours in the grid, so
  // a long slot's splits start with the others' and the blocks past a
  // slot's length exit among live ones
  const int split = blockIdx.x;
  const int s = blockIdx.y;
  const int kv = blockIdx.z / n_chunks;
  const int g0 = (blockIdx.z % n_chunks) * gcn;
  const int gc = min(gcn, G - g0);
  const int length = lengths[s];
  const int n_pages = (length + ps - 1) / ps;
  const int p0 = split * pps;
  if (length <= 0 || p0 >= n_pages || gc <= 0) return;
  const int t0 = p0 * ps;
  const int n_tok = min(pps * ps, length - t0);
  const int n_st = (n_tok + RG_KEYS - 1) / RG_KEYS;
  const int tip = length - 1 - t0;  // the new token in the split (K6)
  const bool has_tip = WRITE && tip < n_tok;
  const RingSmem L(HD, ps, pps);

  extern __shared__ __align__(1024) unsigned char ring_raw[];
  const uint32_t raw = smem_u32(ring_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  unsigned char* ring_smem = ring_raw + (ring - raw);
  auto full = [&](int i) { return ring + L.bar + 8 * i; };
  auto empty = [&](int i) { return ring + L.bar + 8 * (L.nslot + i); };
  const uint32_t fresh_bar = ring + L.bar + 16 * L.nslot;
  float* ml = reinterpret_cast<float*>(ring_smem + L.ml);  // [RG_NW][8][2]
  int* pg = reinterpret_cast<int*>(ring_smem + L.pg);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < L.nslot; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), 1);  // the owning consumer warp's lane 0
    }
    mbar_init(fresh_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == RG_NW) {
    // ---- producer ----
    const int* pt = page_table + (size_t)s * maxP + p0;
    for (int j = lane; j < (n_tok + ps - 1) / ps; j += 32) pg[j] = pt[j];
    if (has_tip && lane == 0) {
      const size_t row = ((size_t)s * KV + kv) * HD;
      mbar_expect_tx(fresh_bar, 4 * HD);
      bulk_load(ring + L.fresh, k_new + row, 2 * HD, fresh_bar);
      bulk_load(ring + L.fresh + 2 * HD, v_new + row, 2 * HD, fresh_bar);
    }
    __syncwarp();
    for (int i = 0; i < n_st; ++i) {
      const int j = i / RG_NW;
      const int sl = (i % RG_NW) * L.depth + j % L.depth;
      if (j >= L.depth) mbar_wait(empty(sl), (j / L.depth - 1) & 1);
      // the row groups that hold a token of the split, each whole: rows
      // past the length in the slot's last page come too (masked)
      const int live = (min(RG_KEYS, n_tok - i * RG_KEYS) + L.br - 1) / L.br;
      const int n_ops = 2 * live * L.nb;
      if (lane == 0)
        mbar_expect_tx(full(sl), (uint32_t)n_ops * L.br * L.rb);
      __syncwarp();
      for (int op = lane; op < n_ops; op += 32) {
        const int b = op % L.nb;            // column box
        const int g = (op / L.nb) % live;   // row group
        const bool is_v = op >= live * L.nb;
        const int r0 = i * RG_KEYS + g * L.br;  // the group's first token
        tma_load_4d(ring + sl * L.slot + (is_v ? L.tensor : 0) +
                        b * RG_KEYS * L.rb + g * L.br * L.rb,
                    is_v ? &tm_v : &tm_k, full(sl), b * L.bc, r0 % ps,
                    pg[r0 / ps], kv);
      }
    }
    return;
  }

  // ---- consumers: warp w takes stages w, w + 4, ... ----
  const int g8 = lane >> 2;  // S^T: key g8 (+8); O^T: column g8 (+8) of a tile
  const int t4 = lane & 3;   // query heads 2 t4 and 2 t4 + 1 of the chunk
  const int nks = (HD + 15) / 16;
  const bool half = (HD & 15) != 0;  // the last k-step holds 8 dims
  // q as B fragments: head g0 + g8 (zeros past the chunk), dims 16 ks + 2 t4
  // (b0) and + 8 (b1)
  uint32_t qb[NKS][2];
  {
    const uint32_t* qh = reinterpret_cast<const uint32_t*>(
        q + ((size_t)s * KV * G + (size_t)kv * G + g0 + g8) * HD);
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      const bool on = ks < nks && g8 < gc;
      qb[ks][0] = on ? qh[8 * ks + t4] : 0u;
      qb[ks][1] = on && !(half && ks == nks - 1) ? qh[8 * ks + 4 + t4] : 0u;
    }
  }
  float acc[NKS][4];  // O^T: columns 16 mt + g8 (acc[mt][0..1]) and + 8
#pragma unroll
  for (int mt = 0; mt < NKS; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of heads 2t4, 2t4+1
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the sums
  // ldmatrix rows and chunks: K (non-transposed) row kr, chunk 2 ks + kc;
  // V (transposed) row vr, chunk 2 mt + vc. A box row holds CPB chunks, so
  // chunk 2 j + c (c < 2) lies in box 2 j / CPB at (2 j % CPB + c) ^ x(r):
  // a lane's base and its CPB / 2 swizzled offsets, the box an immediate
  constexpr int CPB = BC / 8;
  constexpr int RB = 2 * BC;
  constexpr int BOXB = RG_KEYS * RB;
  constexpr int NOFF = CPB > 1 ? CPB / 2 : 1;
  const int kr = lane & 15;
  const int vr = (lane & 7) + ((lane >> 4) << 3);
  const int kc = lane >> 4, vc = (lane >> 3) & 1;
  const int xk = L.swz ? (kr >> L.xs) & (CPB - 1) : 0;
  const int xv = L.swz ? (vr >> L.xs) & (CPB - 1) : 0;
  uint32_t koff[NOFF], voff[NOFF];
#pragma unroll
  for (int k = 0; k < NOFF; ++k) {
    koff[k] = kr * RB + ((CPB > 1 ? (2 * k) ^ kc ^ xk : kc * (BOXB / 16)) << 4);
    voff[k] = vr * RB + ((CPB > 1 ? (2 * k) ^ vc ^ xv : vc * (BOXB / 16)) << 4);
  }
  // chunk 2 j (+ c) of K or V: BC 8 has one chunk a box, in box 2 j + c
  auto kat = [&](int j) {
    return (CPB > 1 ? 2 * j / CPB : 2 * j) * BOXB + koff[j % NOFF];
  };
  auto vat = [&](int j) {
    return (CPB > 1 ? 2 * j / CPB : 2 * j) * BOXB + voff[j % NOFF];
  };

  // K6: the stage that holds the new token (in this warp's walk or none),
  // and where this lane's two 16-byte chunks of the new k/v row (K's HD / 8
  // chunks, then V's) go in it
  int tip_stage = -1;
  uint32_t pd0 = 0, pd1 = 0;
  if (has_tip && warp == tip / RG_KEYS % RG_NW) {
    tip_stage = tip / RG_KEYS;
    auto dst = [&](int x) {
      return (x < HD / 8 ? 0 : L.tensor) + L.at(tip % RG_KEYS, x % (HD / 8));
    };
    pd0 = dst(lane);
    pd1 = dst(lane + 32);
  }

  for (int i = warp, j = 0; i < n_st; i += RG_NW, ++j) {
    const int sl = warp * L.depth + j % L.depth;
    const uint32_t kt = ring + sl * L.slot;
    const uint32_t vt = kt + L.tensor;
    mbar_wait(full(sl), (j / L.depth) & 1);
    if (i == tip_stage) {
      // K6: the new k/v row over the stale pool row the copy brought
      mbar_wait(fresh_bar, 0);
      const unsigned char* fresh = ring_smem + L.fresh;
      if (lane < HD / 4)
        *reinterpret_cast<uint4*>(ring_smem + sl * L.slot + pd0) =
            *reinterpret_cast<const uint4*>(fresh + 16 * lane);
      if (lane + 32 < HD / 4)
        *reinterpret_cast<uint4*>(ring_smem + sl * L.slot + pd1) =
            *reinterpret_cast<const uint4*>(fresh + 16 * (lane + 32));
      fence_proxy_async();  // before a later copy into the slot
      __syncwarp();
    }
    // S^T = K q^T: keys g8 (c[0..1]) and g8 + 8 (c[2..3]), heads 2 t4 + {0, 1}
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      if (ks >= nks) break;
      uint32_t a[4];
      if (CPB == 1 && half && ks == nks - 1) {
        ldsm_x2(a[0], a[1], kt + 2 * ks * BOXB + kr * RB);
        a[2] = a[3] = 0u;
      } else {
        ldsm_x4(a, kt + kat(ks));
      }
      mma_bf16(c, a, qb[ks][0], qb[ks][1]);
    }
    // the last stage of a slot may hold fewer keys, and the rows after
    // them may hold anything: masked on their own path, the scores to
    // -inf and V's fragments to zero
    const int valid = n_tok - i * RG_KEYS;
    uint32_t vm01 = ~0u, vm23 = ~0u;
    if (valid < RG_KEYS) {
      if (g8 >= valid) c[0] = c[1] = -INFINITY;
      if (g8 + 8 >= valid) c[2] = c[3] = -INFINITY;
      vm01 = (2 * t4 < valid ? 0xffffu : 0u) |
             (2 * t4 + 1 < valid ? 0xffff0000u : 0u);
      vm23 = (2 * t4 + 8 < valid ? 0xffffu : 0u) |
             (2 * t4 + 9 < valid ? 0xffff0000u : 0u);
    }
    // the online softmax in log2 units: a head's max over the 16 keys
    // combines over the 8 lanes that share t4
    float mx0 = fmaxf(c[0], c[2]) * scale_log2;
    float mx1 = fmaxf(c[1], c[3]) * scale_log2;
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float al0 = ex2_approx(m0 - mn0);
    const float al1 = ex2_approx(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    const float p0 = ex2_approx(fmaf(c[0], scale_log2, -mn0));
    const float p1 = ex2_approx(fmaf(c[1], scale_log2, -mn1));
    const float p2 = ex2_approx(fmaf(c[2], scale_log2, -mn0));
    const float p3 = ex2_approx(fmaf(c[3], scale_log2, -mn1));
    l0 = fmaf(l0, al0, p0 + p2);
    l1 = fmaf(l1, al1, p1 + p3);
#pragma unroll
    for (int mt = 0; mt < NKS; ++mt) {
      acc[mt][0] *= al0;
      acc[mt][1] *= al1;
      acc[mt][2] *= al0;
      acc[mt][3] *= al1;
    }
    // P^T as the B fragments of O^T += V^T P^T: movmatrix turns the
    // accumulators' layout (key g8, heads 2 t4..) into B's (keys 2 t4..,
    // head g8). P goes as two bf16 terms, hi + lo, so the products keep
    // P's f32 precision (one bf16 rounding of P would move o by more than
    // kernel_tolerance's ulp).
    const uint32_t hi_a = pack_bf16(p0, p1), hi_b = pack_bf16(p2, p3);
    const float2 fa = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&hi_a));
    const float2 fb = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&hi_b));
    const uint32_t bh0 = movmatrix_t(hi_a), bh1 = movmatrix_t(hi_b);
    const uint32_t bl0 = movmatrix_t(pack_bf16(p0 - fa.x, p1 - fa.y));
    const uint32_t bl1 = movmatrix_t(pack_bf16(p2 - fb.x, p3 - fb.y));
#pragma unroll
    for (int mt = 0; mt < NKS; ++mt) {
      if (mt >= nks) break;
      uint32_t a[4];
      if (CPB == 1 && half && mt == nks - 1) {
        // columns 16 mt .. + 7 only: keys 0-7 (a0) and 8-15 (a2)
        ldsm_x2_t(a[0], a[2], vt + 2 * mt * BOXB + kr * RB);
        a[1] = a[3] = 0u;
      } else {
        ldsm_x4_t(a, vt + vat(mt));
      }
      a[0] &= vm01;
      a[1] &= vm01;
      a[2] &= vm23;
      a[3] &= vm23;
      mma_bf16(acc[mt], a, bh0, bh1);
      mma_bf16(acc[mt], a, bl0, bl1);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(sl));
  }
  // ---- the block's result: the four warps' states merged ----
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  named_bar_sync(1, 32 * RG_NW);  // every consumer has left the ring
  // the warps' outputs [RG_NW][8][HD], on the ring
  float* ow = reinterpret_cast<float*>(ring_smem);
  if (g8 == 0) {
    ml[(warp * RG_HEADS + 2 * t4) * 2] = m0;
    ml[(warp * RG_HEADS + 2 * t4) * 2 + 1] = l0;
    ml[(warp * RG_HEADS + 2 * t4 + 1) * 2] = m1;
    ml[(warp * RG_HEADS + 2 * t4 + 1) * 2 + 1] = l1;
  }
  float* o0 = ow + (size_t)(warp * RG_HEADS + 2 * t4) * HD;
  float* o1 = o0 + HD;
#pragma unroll
  for (int mt = 0; mt < NKS; ++mt) {
    if (mt >= nks) break;
    const int d = 16 * mt + g8;
    o0[d] = acc[mt][0];
    o1[d] = acc[mt][1];
    if (d + 8 < HD) {
      o0[d + 8] = acc[mt][2];
      o1[d + 8] = acc[mt][3];
    }
  }
  named_bar_sync(1, 32 * RG_NW);
  // a slot that uses one split gets its output here; otherwise the split's
  // (unnormalized o, max, sum) for the merge pass
  const bool direct = (n_pages + pps - 1) / pps == 1;
  const size_t part = ((size_t)s * KV + kv) * n_split + split;
  const int H = KV * G;
  for (int e = threadIdx.x; e < gc * HD; e += 32 * RG_NW) {
    const int g = e / HD;
    const int d = e - g * HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < RG_NW; ++w)
      mx = fmaxf(mx, ml[(w * RG_HEADS + g) * 2]);
    float sum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < RG_NW; ++w) {
      const float wt = ex2_approx(ml[(w * RG_HEADS + g) * 2] - mx);
      sum = fmaf(ml[(w * RG_HEADS + g) * 2 + 1], wt, sum);
      o = fmaf(ow[(w * RG_HEADS + g) * HD + d], wt, o);
    }
    if (direct) {
      out[((size_t)s * H + (size_t)kv * G + g0 + g) * HD + d] =
          __float2bfloat16(o / sum);
    } else {
      part_o[(part * G + g0 + g) * HD + d] = o;
      if (d == 0) {
        part_ml[(part * G + g0 + g) * 2] = mx * RG_LN2;  // natural log
        part_ml[(part * G + g0 + g) * 2 + 1] = sum;
      }
    }
  }
}

// The query-head chunks of a kv head: n_chunks of gcn <= 8 heads (as even
// as G allows). The ring and any-shape kernels take them on the grid's y
// axis.
inline void head_chunks(int G, int& n_chunks, int& gcn) {
  n_chunks = (G + GC_MAX - 1) / GC_MAX;
  gcn = (G + n_chunks - 1) / n_chunks;
}

// The tensor map of a pool [KV, NP, ps, HD] in the ring kernel's boxes,
// encoded once per (pool, shape) and kept: a decode step launches K6 on
// every layer's pools, and the maps do not change while a pool lives (one
// freed and another made at the same address with the same shape gets the
// same map). Returns a cudaError_t code.
int pool_map(CUtensorMap* map, const void* pool, int KV, int NP, int ps,
             int HD) {
  struct Entry {
    int KV, NP, ps, HD;
    CUtensorMap map;
  };
  static std::unordered_map<const void*, Entry> cache;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(pool);
  if (it == cache.end() || it->second.KV != KV || it->second.NP != NP ||
      it->second.ps != ps || it->second.HD != HD) {
    if (cache.size() >= 4096) cache.clear();  // pools freed long ago
    Entry e{KV, NP, ps, HD, {}};
    const RingSmem L(HD, ps, 1);
    const int rc = rt_pool_map(&e.map, pool, KV, NP, ps, HD, L.bc, L.br,
                               L.swz);
    if (rc != 0) return rc;
    it = cache.insert_or_assign(pool, e).first;
  }
  *map = it->second.map;
  return 0;
}

template <bool WRITE>
int launch_ring(int G, const void* q, const void* k_new, const void* v_new,
                const void* k_pool, const void* v_pool,
                const void* page_table, const void* lengths, void* out,
                void* part_o, void* part_ml, int S, int KV, int NP, int ps,
                int HD, int maxP, int pps, int n_split, float scale,
                cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  if (HD % 8 != 0 || HD > 256) return static_cast<int>(cudaErrorInvalidValue);
  int n_chunks, gcn;
  head_chunks(G, n_chunks, gcn);
  CUtensorMap tm_k, tm_v;
  int rc = pool_map(&tm_k, k_pool, KV, NP, ps, HD);
  if (rc == 0) rc = pool_map(&tm_v, v_pool, KV, NP, ps, HD);
  if (rc != 0) return rc;
  const size_t smem = RingSmem(HD, ps, pps).bytes;
  const dim3 grid(n_split, S, KV * n_chunks);
  auto run = [&](auto kernel) {
    cudaError_t err = rt_set_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, RG_NT, smem, stream>>>(
        tm_k, tm_v, static_cast<const bf16*>(q),
        static_cast<const bf16*>(k_new), static_cast<const bf16*>(v_new),
        static_cast<const int*>(page_table),
        static_cast<const int*>(lengths), static_cast<bf16*>(out),
        static_cast<float*>(part_o), static_cast<float*>(part_ml), KV, G,
        gcn, n_chunks, ps, HD, maxP, pps, n_split,
        scale * 1.4426950408889634f);
    return cudaGetLastError();
  };
  // the instances: 8 k-steps (HD <= 128) or 16, boxes of 32 columns where
  // 32 divides HD, else of 16 (HD 48, 80, ...) or 8 (HD 40, 56, ...: the
  // 16-step instance only). ptxas held the 4- and 6-step instances to
  // 64-72 registers and the 8-step one of 8-column boxes to 96, with 4-28
  // bytes of spills; HD 96 runs the 8-step one with two steps skipped
  const int bc = RingSmem(HD, ps, pps).bc;
  cudaError_t err;
  if (bc == 32)
    err = HD <= 128 ? run(paged_decode_ring_kernel<8, 32, WRITE>)
                    : run(paged_decode_ring_kernel<16, 32, WRITE>);
  else if (bc == 16)
    err = HD <= 128 ? run(paged_decode_ring_kernel<8, 16, WRITE>)
                    : run(paged_decode_ring_kernel<16, 16, WRITE>);
  else
    err = run(paged_decode_ring_kernel<16, 8, WRITE>);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_merge<bf16>(
      part_o, part_ml, lengths, out, WRITE ? k_new : nullptr, v_new, k_pool,
      v_pool, page_table, S, KV, G, HD, NP, ps, maxP, pps, n_split, 1,
      stream));
}

// The f32 kernel's geometry at G in {1, 2, 4, 8}: rows of HD / 4 16-byte
// chunks, a power of two <= 32 (HD 4-128)
inline bool fixed_shape(int G, int HD) {
  const int lpt = HD / 4;
  return (G == 1 || G == 2 || G == 4 || G == 8) && HD % 4 == 0 &&
         lpt > 0 && lpt <= 32 && 32 % lpt == 0;
}

template <int G, bool WRITE>
int launch_fixed(const void* q, const void* k_new, const void* v_new,
                 const void* k_pool, const void* v_pool,
                 const void* page_table, const void* lengths, void* out,
                 void* part_o, void* part_ml, int S, int KV, int NP, int ps,
                 int HD, int maxP, int pps, int n_split, float scale,
                 cudaStream_t stream) {
  const int lpt = HD / 4;
  const int tps = pps * ps;
  const int tg_n = K6_THREADS / lpt;
  const size_t smem = sizeof(float) * ((size_t)G * HD + 2 * HD +
                                       (size_t)G * tps +
                                       (size_t)tg_n * G * HD + 2 * G);
  auto kernel = paged_decode_split_kernel<float, G, WRITE>;
  cudaError_t err = rt_set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // K5 never writes through these: WRITE is false
  float* kp = const_cast<float*>(static_cast<const float*>(k_pool));
  float* vp = const_cast<float*>(static_cast<const float*>(v_pool));
  kernel<<<dim3(S, KV, n_split), K6_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_new),
      static_cast<const float*>(v_new), kp, vp,
      static_cast<const int*>(page_table), static_cast<const int*>(lengths),
      static_cast<float*>(part_o), static_cast<float*>(part_ml), KV, NP, ps,
      HD, maxP, pps, n_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_merge<float>(
      part_o, part_ml, lengths, out, nullptr, nullptr, k_pool, v_pool,
      page_table, S, KV, G, HD, NP, ps, maxP, pps, n_split, 0, stream));
}

// The any-shape kernel's geometry: the head chunks, tg_n token groups in
// p . V. The wrapper computes the same shared-memory size before it
// launches.
inline void any_geometry(int G, int HD, int VW, int& n_chunks, int& gcn,
                         int& tg_n) {
  head_chunks(G, n_chunks, gcn);
  const int nch = HD / VW;
  tg_n = nch <= K6_THREADS ? K6_THREADS / nch : 1;
}

template <typename T, int VW, bool WRITE>
int launch_any(int G, const void* q, const void* k_new, const void* v_new,
               const void* k_pool, const void* v_pool,
               const void* page_table, const void* lengths, void* out,
               void* part_o, void* part_ml, int S, int KV, int NP, int ps,
               int HD, int maxP, int pps, int n_split, float scale,
               cudaStream_t stream) {
  if (HD % VW != 0) return static_cast<int>(cudaErrorInvalidValue);
  int n_chunks, gcn, tg_n;
  any_geometry(G, HD, VW, n_chunks, gcn, tg_n);
  const int tps = pps * ps;
  const size_t smem =
      sizeof(float) * ((size_t)gcn * HD + 2 * HD + (size_t)gcn * tps +
                       (size_t)tg_n * gcn * HD + 2 * gcn);
  auto kernel = paged_decode_split_any_kernel<T, VW, WRITE>;
  cudaError_t err = rt_set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // K5 never writes through these: WRITE is false
  T* kp = const_cast<T*>(static_cast<const T*>(k_pool));
  T* vp = const_cast<T*>(static_cast<const T*>(v_pool));
  kernel<<<dim3(S, KV * n_chunks, n_split), K6_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), kp, vp,
      static_cast<const int*>(page_table), static_cast<const int*>(lengths),
      static_cast<float*>(part_o), static_cast<float*>(part_ml), KV, G, gcn,
      n_chunks, NP, ps, HD, maxP, pps, n_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_merge<T>(
      part_o, part_ml, lengths, out, nullptr, nullptr, k_pool, v_pool,
      page_table, S, KV, G, HD, NP, ps, maxP, pps, n_split, 0, stream));
}

// bf16 at head dims up to 256 that are a multiple of 8: the ring kernel;
// f32 at the fixed kernel's shapes: that kernel; any other (bf16 above 256
// among them): the any-shape kernel
template <bool WRITE>
int dispatch(int dtype, const void* q, const void* k_new, const void* v_new,
             const void* k_pool, const void* v_pool, const void* page_table,
             const void* lengths, void* out, void* part_o, void* part_ml,
             int S, int H, int KV, int NP, int ps, int HD, int maxP, int pps,
             int n_split, float scale, void* stream) {
  if (S == 0) return 0;
  if (KV <= 0 || H % KV != 0 || HD <= 0 || pps <= 0 ||
      n_split * pps < maxP)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / KV;
  using bf16 = __nv_bfloat16;
#define PAGED_ARGS                                                         \
  q, k_new, v_new, k_pool, v_pool, page_table, lengths, out, part_o,       \
      part_ml, S, KV, NP, ps, HD, maxP, pps, n_split, scale, st
  if (dtype == RT_BF16) {
    if (HD % 8 != 0) return launch_any<bf16, 1, WRITE>(G, PAGED_ARGS);
    return HD <= 256 ? launch_ring<WRITE>(G, PAGED_ARGS)
                     : launch_any<bf16, 8, WRITE>(G, PAGED_ARGS);
  }
  if (dtype != RT_F32) return static_cast<int>(cudaErrorInvalidValue);
  if (fixed_shape(G, HD)) {
    switch (G) {
      case 1:
        return launch_fixed<1, WRITE>(PAGED_ARGS);
      case 2:
        return launch_fixed<2, WRITE>(PAGED_ARGS);
      case 4:
        return launch_fixed<4, WRITE>(PAGED_ARGS);
      default:
        return launch_fixed<8, WRITE>(PAGED_ARGS);
    }
  }
  return HD % 4 == 0 ? launch_any<float, 4, WRITE>(G, PAGED_ARGS)
                     : launch_any<float, 1, WRITE>(G, PAGED_ARGS);
#undef PAGED_ARGS
}

}  // namespace

// part_o [S, KV, n_split, G, HD] and part_ml [S, KV, n_split, G, 2] are f32
// scratch from the caller; n_split * pps >= maxP.
extern "C" int paged_decode_attention_inplace(
    int dtype, const void* q, const void* k_new, const void* v_new,
    void* k_pool, void* v_pool, const void* page_table, const void* lengths,
    void* out, void* part_o, void* part_ml, int S, int H, int KV, int NP,
    int ps, int HD, int maxP, int pps, int n_split, float scale,
    void* stream) {
  return dispatch<true>(dtype, q, k_new, v_new, k_pool, v_pool, page_table,
                        lengths, out, part_o, part_ml, S, H, KV, NP, ps, HD,
                        maxP, pps, n_split, scale, stream);
}

// K5: as above without k_new/v_new; the pools are only read.
extern "C" int paged_attention(int dtype, const void* q, const void* k_pool,
                               const void* v_pool, const void* page_table,
                               const void* lengths, void* out, void* part_o,
                               void* part_ml, int S, int H, int KV, int NP,
                               int ps, int HD, int maxP, int pps, int n_split,
                               float scale, void* stream) {
  return dispatch<false>(dtype, q, nullptr, nullptr, k_pool, v_pool,
                         page_table, lengths, out, part_o, part_ml, S, H, KV,
                         NP, ps, HD, maxP, pps, n_split, scale, stream);
}
