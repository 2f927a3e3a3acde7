// K6: fused paged decode write-and-attend, and K5: read-only paged decode
// attention, for Hopper (sm_90a). One split-KV kernel serves both, with a
// WRITE template parameter, the way K2 is K1's WINDOW instantiation.
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
// length * HD * 2 (K and V) values per kv head once and does ~4 flops per
// value, far below the 295 flops/byte where bf16 tensor cores would bound
// it. So the design reads every live K/V value once, no dead one, and keeps
// enough loads in flight to cover the memory latency:
//   * split-KV: a slot's pages are cut into splits of ~256 tokens, one block
//     per (slot, kv head, split), so a 16-slot batch of ~1000-token contexts
//     runs thousands of blocks instead of one serial loop per (slot, head);
//   * 16-byte loads: HD / 8 lanes (bf16) share one K or V row, and several
//     rows move per warp instruction; the block walks only its own pages
//     through the slot's page-table row (no gathered copy);
//   * within a split the scores sit in shared memory, so the softmax is
//     exact there (one max, one sum); each split leaves (m, l, unnormalized
//     o) in f32, and a second small kernel merges the splits of a
//     (slot, kv head) with the usual rescaling -- the same online-softmax
//     algebra as the TPU kernels, in two levels;
//   * the G = H / KV query rows of a kv head share every K/V load.
//
// Those kernels are compiled for G in {1, 2, 4, 8} and for head dims whose
// 16-byte chunks split a warp evenly (HD / VEC a power of two <= 32): every
// preset's shape. Every other G and every HD <= 256 (Phi-3-mini's HD 96:
// 12 bf16 chunks; HD 256 in f32: 64 chunks; Llama-3.2-3B's G 3, Qwen2-7B's
// G 7) runs paged_decode_split_any_kernel, the same algorithm with G and HD
// as runtime values:
//   * G: a block takes a chunk of at most 8 query heads of one kv head,
//     with the chunks on the grid's y axis beside the kv heads; each chunk
//     reads its split's K/V once, and the merge pass (runtime G already)
//     reads the chunks' rows of part_o like any others;
//   * HD: a row's chunks of VW elements (16 bytes, or one element where HD
//     is not a multiple of a 16-byte vector) are spread over a power of two
//     of lanes with a lane stride (12 chunks over 16 lanes, 64 over 32), so
//     the shuffle tree still sums each row within its lane group; in p . V
//     a thread owns one chunk of a row (two where a row has more chunks
//     than the block has threads).
//
// K6's new token: its k/v rows come from k_new/v_new (a separate input) and
// are held in shared memory by the one block whose split holds the tip page;
// the pool is never re-read at that row (no read-after-write in a block).
// Only that ONE row is written to each pool -- the TPU kernel flushed the
// whole tip page -- so page 0 (trash) and prefix-shared pages are never
// written. In both kernels slots of length 0 write nothing and output zeros
// (callers mask them).

#include "common.cuh"

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

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[Vec<T>::N]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) out[i] = to_f32(e[i]);
}

// Pass 1: one block per (slot, kv head, split) of `tps` tokens. WRITE: K6
// (the new token from k_new/v_new, written to the pools); else K5 (k_new and
// v_new unused, the pools only read).
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

// Pass 1 for any G and HD <= 256: one block per (slot, kv head x chunk of
// gcn query heads, split). VW: elements a lane loads at once (a 16-byte
// vector where HD is a multiple of one, else 1).
template <typename T, int VW, bool WRITE>
__global__ void __launch_bounds__(K6_THREADS) paged_decode_split_any_kernel(
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

  // p . V: a thread owns chunk dc (and dc + 128) of every query row and
  // every tg_n-th token
  {
    const int tg = nch <= K6_THREADS ? tid / nch : 0;
    const int dc = nch <= K6_THREADS ? tid % nch : tid;
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
          const int cc = dc + j * K6_THREADS;
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
        const int cc = dc + j * K6_THREADS;
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
    __syncthreads();
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

// Pass 2: merge the splits of each (slot, kv head) into o.
template <typename T>
__global__ void __launch_bounds__(K6_THREADS) paged_decode_merge_kernel(
    const float* __restrict__ part_o, const float* __restrict__ part_ml,
    const int* __restrict__ lengths, T* __restrict__ out, int KV, int G,
    int HD, int ps, int pps, int n_split) {
  const int s = blockIdx.x;
  const int kv = blockIdx.y;
  const int H = KV * G;
  T* o = out + ((size_t)s * H + (size_t)kv * G) * HD;
  const int length = lengths[s];
  const int used = length > 0 ? ((length + ps - 1) / ps + pps - 1) / pps : 0;
  const size_t base = ((size_t)s * KV + kv) * n_split;
  for (int e = threadIdx.x; e < G * HD; e += K6_THREADS) {
    const int g = e / HD;
    float m = -1e30f;
    for (int j = 0; j < used; ++j)
      m = fmaxf(m, part_ml[((base + j) * G + g) * 2]);
    float l = 0.f, a = 0.f;
    for (int j = 0; j < used; ++j) {
      const float w = expf(part_ml[((base + j) * G + g) * 2] - m);
      l = fmaf(part_ml[((base + j) * G + g) * 2 + 1], w, l);
      a = fmaf(part_o[(base + j) * G * HD + e], w, a);
    }
    o[e] = from_f32<T>(used > 0 ? a / fmaxf(l, 1e-30f) : 0.f);
  }
}

template <typename T, int G, bool WRITE>
int launch(const void* q, const void* k_new, const void* v_new,
           const void* k_pool, const void* v_pool, const void* page_table,
           const void* lengths, void* out, void* part_o, void* part_ml, int S,
           int KV, int NP, int ps, int HD, int maxP, int pps, int n_split,
           float scale, cudaStream_t stream) {
  constexpr int VEC = Vec<T>::N;
  const int lpt = HD / VEC;
  if (HD % VEC != 0 || lpt > 32 || 32 % lpt != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tps = pps * ps;
  const int tg_n = K6_THREADS / lpt;
  const size_t smem = sizeof(float) * ((size_t)G * HD + 2 * HD +
                                       (size_t)G * tps +
                                       (size_t)tg_n * G * HD + 2 * G);
  cudaError_t err = rt_set_smem(paged_decode_split_kernel<T, G, WRITE>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // K5 never writes through these: WRITE is false
  T* kp = const_cast<T*>(static_cast<const T*>(k_pool));
  T* vp = const_cast<T*>(static_cast<const T*>(v_pool));
  paged_decode_split_kernel<T, G, WRITE>
      <<<dim3(S, KV, n_split), K6_THREADS, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k_new),
          static_cast<const T*>(v_new), kp, vp,
          static_cast<const int*>(page_table),
          static_cast<const int*>(lengths), static_cast<float*>(part_o),
          static_cast<float*>(part_ml), KV, NP, ps, HD, maxP, pps, n_split,
          scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_merge_kernel<T><<<dim3(S, KV), K6_THREADS, 0, stream>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
      static_cast<const int*>(lengths), static_cast<T*>(out), KV, G, HD, ps,
      pps, n_split);
  return static_cast<int>(cudaGetLastError());
}

// The any-shape kernel's geometry: chunks of gcn <= GC_MAX query heads (as
// even as G allows), tg_n token groups in p . V. The wrapper computes the
// same shared-memory size before it launches.
inline void any_geometry(int G, int HD, int VW, int& n_chunks, int& gcn,
                         int& tg_n) {
  n_chunks = (G + GC_MAX - 1) / GC_MAX;
  gcn = (G + n_chunks - 1) / n_chunks;
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
  if (HD % VW != 0 || HD > 256) return static_cast<int>(cudaErrorInvalidValue);
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
  paged_decode_merge_kernel<T><<<dim3(S, KV), K6_THREADS, 0, stream>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
      static_cast<const int*>(lengths), static_cast<T*>(out), KV, G, HD, ps,
      pps, n_split);
  return static_cast<int>(cudaGetLastError());
}

// The shapes the fixed-G kernel is compiled for: G in {1, 2, 4, 8} and a
// row of HD / VEC 16-byte chunks, a power of two <= 32.
template <typename T>
bool fixed_shape(int G, int HD) {
  constexpr int VEC = Vec<T>::N;
  const int lpt = HD / VEC;
  return (G == 1 || G == 2 || G == 4 || G == 8) && HD % VEC == 0 &&
         lpt > 0 && lpt <= 32 && 32 % lpt == 0;
}

template <typename T, bool WRITE>
int dispatch_g(int G, const void* q, const void* k_new, const void* v_new,
               const void* k_pool, const void* v_pool,
               const void* page_table, const void* lengths, void* out,
               void* part_o, void* part_ml, int S, int KV, int NP, int ps,
               int HD, int maxP, int pps, int n_split, float scale,
               cudaStream_t st) {
  if (!fixed_shape<T>(G, HD)) {
    if (HD % Vec<T>::N == 0)
      return launch_any<T, Vec<T>::N, WRITE>(
          G, q, k_new, v_new, k_pool, v_pool, page_table, lengths, out,
          part_o, part_ml, S, KV, NP, ps, HD, maxP, pps, n_split, scale, st);
    return launch_any<T, 1, WRITE>(G, q, k_new, v_new, k_pool, v_pool,
                                   page_table, lengths, out, part_o, part_ml,
                                   S, KV, NP, ps, HD, maxP, pps, n_split,
                                   scale, st);
  }
#define K6_CASE(GV)                                                          \
  case GV:                                                                   \
    return launch<T, GV, WRITE>(q, k_new, v_new, k_pool, v_pool, page_table, \
                                lengths, out, part_o, part_ml, S, KV, NP,    \
                                ps, HD, maxP, pps, n_split, scale, st);
  switch (G) {
    K6_CASE(1)
    K6_CASE(2)
    K6_CASE(4)
    K6_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K6_CASE
}

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
  if (dtype == RT_BF16)
    return dispatch_g<__nv_bfloat16, WRITE>(
        G, q, k_new, v_new, k_pool, v_pool, page_table, lengths, out, part_o,
        part_ml, S, KV, NP, ps, HD, maxP, pps, n_split, scale, st);
  if (dtype == RT_F32)
    return dispatch_g<float, WRITE>(G, q, k_new, v_new, k_pool, v_pool,
                                    page_table, lengths, out, part_o, part_ml,
                                    S, KV, NP, ps, HD, maxP, pps, n_split,
                                    scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
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
