// K3 and K4: flash attention backward (FlashAttention-2 split), for Hopper
// (sm_90a).
//
// Replaces ray_tpu/ops/flash_attention.py:_bwd_dq_kernel (K3) and
// _bwd_dkdv_kernel (K4), both launched by _flash_pallas_bwd. For
// q/dO/O [B, S, H, D], k/v [B, T, KV, D] and the forward's f32 log-sum-exp
// lse [B, H, S], with P = exp(q k^T scale - lse) and
// dS = P * (dO v^T - delta) * scale, delta = rowsum(O * dO):
//   K3: dq = dS k                  one block per (b, h, query tile);
//   K4: dk = dS^T q, dv = P^T dO   one block per (b, kv_head, key tile).
// The causal band (and a sliding window W: key t visible to query s iff
// 0 <= s - t < W) bounds both loops: K3 streams K/V tiles from the band's
// first tile to the diagonal, K4 streams query tiles from the diagonal to
// the band's last. Nothing uses atomics: each output element is summed by
// one thread in a fixed order, so the gradients are deterministic.
//
// Bound on this card: per (b, h), 4 S T D flops of recomputed products
// (q k^T and dO v^T) plus 4 S T D of gradient products, within the band;
// with K/V re-read per query tile and q/dO per key tile. At the 1b train
// shape (S = T = 1024, D = 128, causal) that is ~S/2 flops a byte of
// inputs, so the bound is the tensor cores'.
//
// delta: K3 forms it in-kernel from O and dO (f32) and also stores it
// ([B, H, S] f32); K4, launched after K3 on the same stream, reads it
// instead of re-reading O for every key tile.
//
// GQA in K4: the block loops over the `groups` query heads of its kv head
// and sums their contributions in f32 registers, so the per-head f32
// [B, H, T, D] buffers of the TPU wrapper (_flash_pallas_bwd:421-422) do
// not exist.
//
// Kernels, chosen explicitly by dtype and head dim in launch_dq and
// launch_dkdv:
//
// K3, bf16 at head dims 64, 80, 96, 128 and 256 (every card preset,
// H2O-Danube's and Phi-2's 80, Phi-3's 96, Gemma's 256),
// flash_bwd_dq_wgmma_kernel, on K1's parts (hopper.cuh):
// one block of 3 warpgroups a 128-row query tile. Warpgroup 0 is the
// producer (after setmaxnreg.dec): one thread loads the tile's Q and dO
// once by TMA (4-D tensor maps; a box past S or T is zero-filled inside
// its own batch) and the band's 64-key K/V tiles into rings with full and
// empty mbarriers (K freed after dS k, V after dO v^T). Tiles are TMA boxes
// of 64 columns with the 128-byte swizzle, at head dim 96 three boxes of
// 32 columns with the 64-byte swizzle, at 80 five of 16 columns with the
// 32-byte swizzle (TileCols). Warpgroups 1-2 are
// consumers (setmaxnreg.inc), 64 query rows each: they form delta from O
// and dO in device memory while the first tiles land; then per K/V tile S
// = Q K^T and dP = dO V^T by wgmma m64n64k16 with both operands in shared
// memory (K-major), P = exp2(S scale log2(e) - lse log2(e)) by one FMA and
// ex2.approx while dO V^T runs, dS = P (dP - delta) scale rounded to bf16
// in registers, and dQ += dS K by wgmma m64nDk16 with dS from registers
// and K as the MN-major operand, exactly as K1 treats P and V. 64-key tiles
// keep S, dP (32 f32 registers a thread each), dQ (D / 2) and the dS
// fragments (16) in registers without spills. At head dim 256 Q and dO
// take 128 KB, so K keeps a 2-stage ring and V one stage (V is free again
// early in a tile; one K stage too was 11% slower), 226 KB in all, and dQ
// is 128 registers: the consumers get 240, the producer 24. Only tiles
// that cross the diagonal, the band's lower edge or the ragged end are
// masked; a tile no row of a group sees is only waited for and freed.
// Blocks go heaviest query tile first, one (batch, head) after another,
// which keeps a head's K/V in L2; on this card a persistent form, a global
// heaviest-first order, a deeper ring, delta formed by the producer's
// spare warps and the next tile's products queued behind dQ += dS K were
// each slower (PERF.md). It runs at ~30-38% of the tensor cores'
// rate (PERF.md).
//
// K4, bf16 at head dims 64, 80, 96 and 128, flash_bwd_dkdv_wgmma_kernel: K3's
// design with the roles of queries and keys swapped. One block of 3
// warpgroups owns 128 keys of one (batch, kv head). The producer's thread
// 0 loads the block's K and V once by TMA (128-row boxes of the same 4-D
// maps) and streams the band's (query head of the group, 64-row query
// tile) pairs, a Q and a dO tile each, into a 2-stage ring (Q freed after
// dK += dS^T q, dO after dV += P^T dO); its warp 1 puts each tile's 64
// columns of lse (as -lse log2(e)) and delta beside them in shared memory
// (a full barrier of 32 arrivals a stage, freed with Q). Each consumer
// owns 64 keys and works in the key-row frame: S^T = K Q^T and dP^T = V
// dO^T by wgmma m64n64k16 with K/V as the K-major A and Q/dO as the
// K-major B; P^T = exp2(S^T scale log2(e) - lse log2(e)) by one FMA and
// ex2.approx; dV += P^T dO and dK += dS^T q with P^T and dS^T rounded to
// bf16 in registers and dO/q as the MN-major B, exactly as K3 treats K.
// dK and dV (2 x D / 2 f32 registers a thread) stay in registers across
// every query head of the group, so the consumers run at
// FlashAttention-3's 240 registers and the producer at 24. A query tile
// no key of a group sees (the block's diagonal tile for the second group,
// tiles past the window for the first) is only waited for and freed, in
// ring order. Each thread needs lse and delta at 16 query columns a tile:
// read from device memory on the consumers' chain, their latency doubled
// the kernel's time (PERF.md).
//
// K4 at head dim 256, the same kernel (dkdv_wide): dK and dV of 64 keys
// would be 256 f32 registers a thread, so a block owns 64 keys and gives
// each consumer one gradient of all of them. Consumer 0 computes S^T = K
// Q^T and P^T, passes P^T (f32) to consumer 1 through 16 KB of shared
// memory under two named barriers, and sums dV += P^T dO; consumer 1
// computes dP^T = V dO^T, dS^T from P^T, and sums dK += dS^T q: two
// products each a tile, 128 accumulators each, 210 KB of tiles. With one
// kv head and 64-key blocks Gemma-2B's grid is 128 blocks for 132 SMs,
// each walking 8 query heads, the first 16 query tiles deep: so while
// B KV ceil(T / 64) is short of two waves, the query heads of a kv head
// are split over the 2 or 4 blocks of a thread block cluster, and the
// blocks add their f32 sums in rank order through distributed shared
// memory (each block the columns it stores): deterministic, with no
// atomics and no partial sums in device memory. Four blocks ran 0.18 ms
// at Gemma-2B's shape, two 0.196, one 0.221 (PERF.md).
//
// K3 and K4, bf16 at head dims 16 and 32 (the tiny presets' heads, and
// every D of 17-32), flash_bwd_dq_small_kernel and
// flash_bwd_dkdv_small_kernel. At D <= 32 the products are cheap and every
// score still needs an exponential: at the SFU's 16 an SM a clock (1.98
// GHz) the B H S^2 / 2 of each pass take ~4.0 us at the tiny presets' B 8,
// H 4, S 1024, more than their bytes or products (not a hard floor: exp2
// can also run on the FMA pipes), and
// the grid (512 blocks in K3, 256 in K4) fits one wave, so a kernel takes
// as long as its heaviest block's serial chain (the mma.sync kernels these
// replaced: 16 and 32 iterations of ~3.3 us, held by two __syncthreads, a
// cp.async wait and, in K4, lse and delta loaded on the chain). So:
// - a block owns 64 rows (queries in K3, keys in K4; 16 a consumer warp)
//   and walks its band in 128-row stages (keys in K3; (query head, query
//   rows) pairs in K4), which a fifth warp loads by TMA into a 3-stage
//   ring with full and empty mbarriers: no block-wide barrier in the
//   walk. A whole row is one TMA box (32 or 64 bytes, with the 32- or
//   64-byte swizzle, so ldmatrix reads conflict-free); in K4 each stage's
//   lse and delta come as 1-D f32 boxes beside its Q and dO;
// - where the heaviest chain is long against the grid, the walk is split
//   over the 2-8 blocks of a thread block cluster, every n-th stage to
//   each (small_splits picks n from the chain and the grid), and the
//   blocks add their f32 sums in rank order through distributed shared
//   memory: deterministic, no atomics, no partial sums in device memory;
//   K3's rank 0 alone stores delta;
// - P = ex2.approx of one FMA (scale log2(e) folded in), masked only on
//   64-row steps that cross the diagonal, the window's edge or S/T, on a
//   code path of their own (if-converted, the mask took 130 of a step's
//   367 instructions); dP's sums start at -delta (mma.sync's C operand)
//   and the scale multiplies dq (dk) once after the walk, so a score
//   costs an FMA, an ex2 and a multiply beside the products; steps a
//   warp's rows do not see are skipped by that warp alone;
// - the products are mma.sync.m16n8k16, not wgmma: each warp keeps its
//   own rows' operands (q and dO in K3, k and v in K4) as A fragments in
//   registers for the whole walk, reads the streamed rows by ldmatrix,
//   and skips steps and releases stages alone, where wgmma would tie four
//   warps to one 64-row tile and add a warpgroup wait to each of the five
//   products of a step; at D 16 a step's products are 24 (K3) or 32 (K4)
//   mma.sync a warp against 1,024 exponentials, so they are not the chain.
//
// At head dim 80 (H2O-Danube-1.8B, Phi-2; every D of 65-80) both kernels
// take 80 = 5 x 16: five 16-column boxes with the 32-byte swizzle, so S
// and dP (S^T and dP^T in K4) are five m64n64k16 k-steps, one a box, and
// the gradient products wgmma m64n80k16 with dS/P from registers (dQ 40
// f32 registers a consumer thread, dK and dV 80), ~82 KB of tiles a block
// in either kernel. Head dim 96's three 32-column boxes over the
// 80-column tensor (TMA zero-filling columns 80-95, 1.2x the gradient
// products) ran the pair 1.3% slower (PERF.md). Other head dims <= 256
// are zero-padded to the next compiled one by the wrapper.
//
// f32 (parity runs): exact f32 FMAs on the CUDA cores through shared-memory
// tiles; P and dS stay f32. A lane owns output columns lane + 32 c (the
// ones past D at head dims 16 and 80 are neither read nor stored); at head
// dim 256 a warp takes 8 rows (queries in K3, keys in K4) instead of 16, so
// the tiles fit shared memory and the accumulators registers.
//
// Head dims above 256 (DeepSeek-V4-Flash's 512), both dtypes,
// flash_bwd_dq_wide_kernel and flash_bwd_dkdv_wide_kernel: the head dim is
// a run-time argument (a multiple of 8; the wrapper zero-pads the rest)
// and a block owns one 64-column chunk of dq (dk and dv), so no tile grows
// with it (wide_head.cuh). S and dP are recomputed once a column chunk, on
// the CUDA cores in f32: right first, far from the bound.
//
// The ragged edge (S or T not a multiple of 64) is masked: rows past the
// edge are zero-filled and get P = 0, and are not stored. Masked entries get
// P = 0 explicitly (never exp of -1e30 against an lse), so rows or keys
// with nothing visible in a tile contribute exactly 0.

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "small_head.cuh"
#include "wide_head.cuh"

namespace {

constexpr int BQ = 64;   // query rows a tile
constexpr int BK = 64;   // key rows a tile
constexpr int NT = 128;  // 4 warps x 16 rows

using bf16 = __nv_bfloat16;

// key `col` is visible to query `row`
template <bool CAUSAL>
__device__ __forceinline__ bool visible(int row, int col, int S, int T_len,
                                        int window) {
  bool keep = row < S && col < T_len;
  if (CAUSAL) keep = keep && col <= row && (window <= 0 || row - col < window);
  return keep;
}

// K/V tiles [kt_lo, kt_hi) a query tile of QROWS rows at q0 visits
template <bool CAUSAL, int QROWS = BQ>
__device__ __forceinline__ void key_tiles(int q0, int T_len, int window,
                                          int& kt_lo, int& kt_hi) {
  kt_lo = 0;
  kt_hi = (T_len + BK - 1) / BK;
  if (CAUSAL) {
    kt_hi = min(kt_hi, (q0 + QROWS - 1) / BK + 1);
    if (window > 0) kt_lo = max(0, q0 - window + 1) / BK;
  }
}

// query tiles [qt_lo, qt_hi) that see some key of the KROWS keys at k0
template <bool CAUSAL, int KROWS = BK>
__device__ __forceinline__ void query_tiles(int k0, int S, int window,
                                            int& qt_lo, int& qt_hi) {
  qt_lo = 0;
  qt_hi = (S + BQ - 1) / BQ;
  if (CAUSAL) {
    qt_lo = k0 / BQ;
    if (window > 0)
      qt_hi = min(qt_hi, (k0 + KROWS - 1 + window - 1) / BQ + 1);
  }
}

// ------------------------------------------ bf16 dQ, TMA + wgmma (K3) ---

constexpr int WG_BQ = 128;    // query rows a block: 64 per consumer group
constexpr int WG_BK = 64;     // key rows a K/V tile
constexpr int WG_NT = 384;    // producer group + 2 consumer groups
constexpr int WG_STAGES = 2;  // ring depth
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct DqSmem {
  using C = TileCols<D>;
  // ring depths: at head dim 256 Q and dO take 128 KB, so V keeps one
  // stage (it is free again after dO V^T, early in a tile)
  static constexpr int KST = WG_STAGES;
  static constexpr int VST = D == 256 ? 1 : WG_STAGES;
  static constexpr int BOX_Q = WG_BQ * C::RB;  // a box of Q or dO
  static constexpr int TILE_Q = BOX_Q * C::NB;
  static constexpr int BOX_K = WG_BK * C::RB;  // a box of K or V
  static constexpr int TILE_K = BOX_K * C::NB;
  static constexpr int Q = 0;
  static constexpr int G = TILE_Q;  // dO
  static constexpr int K = G + TILE_Q;
  static constexpr int V = K + KST * TILE_K;
  static constexpr int DELTA = V + VST * TILE_K;  // f32 [WG_BQ]
  static constexpr int BAR = DELTA + 4 * WG_BQ;
  // qg_full, then k_full and k_empty (one each a K stage), v_full and
  // v_empty (one each a V stage); + 1024 to align the tiles
  static constexpr size_t kBytes = BAR + 8 * (1 + 2 * KST + 2 * VST) + 1024;
  static_assert(kBytes <= 232448, "a block's shared memory");
  // setmaxnreg: dQ at head dim 256 is 128 f32 a consumer thread
  static constexpr int PRODUCER_REGS = D == 256 ? 24 : 40;
  static constexpr int CONSUMER_REGS = D == 256 ? 240 : 232;
};

// delta = rowsum(O * dO) in f32 of the 64 rows from `row0` of one (batch,
// head), by a warpgroup (this is thread t), TPR threads a row with CPT
// 16-byte chunks of O and of dO each; into dl[r] (r from 0) and, for
// rows < S, into delta (from lrow). TPR is the largest power of two up to
// 32 that divides a row's chunks (2 of head dim 80's 10), so every column
// enters the sum.
template <int D>
__device__ __forceinline__ void group_delta(
    const bf16* __restrict__ o, const bf16* __restrict__ g,
    float* __restrict__ delta, float* dl, size_t head, size_t q_stride,
    size_t lrow, int row0, int S, int t) {
  constexpr int CH = D / 8;  // chunks a row
  constexpr int TPR = CH % 32 == 0 ? 32 : CH % 16 == 0 ? 16 : CH % 8 == 0 ? 8
                      : CH % 4 == 0 ? 4 : CH % 2 == 0 ? 2 : 1;
  static_assert(CH % TPR == 0, "every chunk of a row is summed");
  constexpr int CPT = CH / TPR;
  constexpr int RPP = 128 / TPR;  // rows a pass
#pragma unroll
  for (int r0 = 0; r0 < 64; r0 += RPP) {
    const int r = r0 + t / TPR;
    const int row = row0 + r;
    float a = 0.f;
    if (row < S) {
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const size_t off =
            head + (size_t)row * q_stride + (t % TPR + cc * TPR) * 8;
        const uint4 ov = __ldg(reinterpret_cast<const uint4*>(o + off));
        const uint4 gv = __ldg(reinterpret_cast<const uint4*>(g + off));
        const __nv_bfloat162* op =
            reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* gp =
            reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 x = __bfloat1622float2(op[i]);
          const float2 y = __bfloat1622float2(gp[i]);
          a = fmaf(x.x, y.x, a);
          a = fmaf(x.y, y.y, a);
        }
      }
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      a += __shfl_xor_sync(0xffffffffu, a, off);
    if (t % TPR == 0) {
      dl[r] = a;
      if (row < S) delta[lrow + row] = a;
    }
  }
}

template <int D, bool CAUSAL, bool WINDOW>
__global__ void __launch_bounds__(WG_NT, 1) flash_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_g,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const bf16* __restrict__ o,
    const bf16* __restrict__ g, const float* __restrict__ lse,
    bf16* __restrict__ dq, float* __restrict__ delta, int S, int T_len,
    int H, int KV, int window, float scale) {
  using L = DqSmem<D>;
  using C = TileCols<D>;
  constexpr int KST = L::KST, VST = L::VST;
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  // the swizzle repeats every 1024 (128-byte), 512 (64-byte) or 256
  // (32-byte) bytes: align the tiles to it
  const uint32_t base = (smem_u32(smem_tiles) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::Q, sG = base + L::G;
  const uint32_t sK = base + L::K, sV = base + L::V;
  unsigned char* aligned = smem_tiles + (base - smem_u32(smem_tiles));
  float* dl_sh = reinterpret_cast<float*>(aligned + L::DELTA);
  const uint32_t qg_full = base + L::BAR;
  auto k_full = [&](int st) { return qg_full + 8 * (1 + st); };
  auto k_empty = [&](int st) { return qg_full + 8 * (1 + KST + st); };
  auto v_full = [&](int st) { return qg_full + 8 * (1 + 2 * KST + st); };
  auto v_empty = [&](int st) {
    return qg_full + 8 * (1 + 2 * KST + VST + st);
  };

  // causal tiles near the end do the most work: schedule them first, one
  // (batch, head) after another, so a head's K/V stay in L2 across its
  // query tiles
  const int q0 = (gridDim.x - 1 - blockIdx.x) * WG_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  // the K/V tiles of the band: up to the diagonal when causal, from the
  // band's first under a window (tiles above or below are never loaded)
  int n_k = (T_len + WG_BK - 1) / WG_BK;
  int kt_lo = 0;
  if (CAUSAL) {
    n_k = min(n_k, (q0 + WG_BQ - 1) / WG_BK + 1);
    if (WINDOW) kt_lo = max(0, q0 - window + 1) / WG_BK;
  }
  const int n_tiles = n_k - kt_lo;
  const size_t q_stride = (size_t)H * D;
  const size_t head = ((size_t)b * S * H + h) * D;
  const size_t lrow = ((size_t)b * H + h) * S;

  if (threadIdx.x == 0) {
    mbar_init(qg_full, 1);
    for (int st = 0; st < KST; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(k_empty(st), 8);  // one arrival per consumer warp
    }
    for (int st = 0; st < VST; ++st) {
      mbar_init(v_full(st), 1);
      mbar_init(v_empty(st), 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread loads Q and dO once, then keeps the K and
    // V rings full by TMA ----
    setmaxnreg_dec<L::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      const int kvh = h / (H / KV);
      mbar_expect_tx(qg_full, 2 * L::TILE_Q);
      for (int c = 0; c < C::NB; ++c) {
        tma_load_4d(sQ + c * L::BOX_Q, &tm_q, qg_full, c * C::BC, h, q0, b);
        tma_load_4d(sG + c * L::BOX_Q, &tm_g, qg_full, c * C::BC, h, q0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int sk = i % KST, sv = i % VST;
        const int k0 = (kt_lo + i) * WG_BK;
        const uint32_t kt = sK + sk * L::TILE_K, vt = sV + sv * L::TILE_K;
        // K is freed after dq += dS k, V after dP: each waits for its own
        if (i >= KST) mbar_wait(k_empty(sk), ((i / KST) - 1) & 1);
        mbar_expect_tx(k_full(sk), L::TILE_K);
        for (int c = 0; c < C::NB; ++c)
          tma_load_4d(kt + c * L::BOX_K, &tm_k, k_full(sk), c * C::BC, kvh,
                      k0, b);
        if (i >= VST) mbar_wait(v_empty(sv), ((i / VST) - 1) & 1);
        mbar_expect_tx(v_full(sv), L::TILE_K);
        for (int c = 0; c < C::NB; ++c)
          tma_load_4d(vt + c * L::BOX_K, &tm_v, v_full(sv), c * C::BC, kvh,
                      k0, b);
      }
    }
    return;
  }

  // ---- consumers: group cw owns query rows q0 + 64 cw .. + 63 ----
  setmaxnreg_inc<L::CONSUMER_REGS>();
  const int cw = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g8 = lane >> 2;  // accumulator rows g8 and g8 + 8 of the warp's 16
  const int t4 = lane & 3;   // column pair within an 8-column n-tile
  const int grow = q0 + cw * 64;  // the group's first row
  const int row0 = grow + warp * 16;
  const int row_a = row0 + g8;
  const int row_b = row_a + 8;
  // delta of the group's rows from device memory while the tiles land
  group_delta<D>(o, g, delta, dl_sh + cw * 64, head, q_stride, lrow, grow, S,
                 tid);
  named_bar_sync(1 + cw, 128);
  const float dl_a = dl_sh[cw * 64 + warp * 16 + g8];
  const float dl_b = dl_sh[cw * 64 + warp * 16 + g8 + 8];
  // P = exp(s scale - lse) = exp2(s scale log2(e) - lse log2(e))
  const float scale_log2 = scale * LOG2E;
  const float nl_a = row_a < S ? -lse[lrow + row_a] * LOG2E : 0.f;
  const float nl_b = row_b < S ? -lse[lrow + row_b] * LOG2E : 0.f;
  const uint32_t q_rows = sQ + cw * 64 * C::RB;  // this group's 64 rows
  const uint32_t g_rows = sG + cw * 64 * C::RB;
  auto release = [&](uint32_t bar) {  // this warp is done with a buffer
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  float acc[D / 2];  // f32 dq: d-tile j in acc[4j .. 4j+3]
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  // the tiles some row of this group sees are [i_lo, i_hi): those before
  // (below its band) and after (above its diagonal, or all of them for a
  // group wholly past S) are only waited for and released, in ring order
  int i_lo = 0, i_hi = grow < S ? n_tiles : 0;
  while (CAUSAL && i_hi > 0 && (kt_lo + i_hi - 1) * WG_BK > grow + 63) --i_hi;
  while (WINDOW && i_lo < i_hi &&
         grow - ((kt_lo + i_lo) * WG_BK + WG_BK - 1) >= window)
    ++i_lo;
  auto skip = [&](int i) {
    mbar_wait(k_full(i % KST), (i / KST) & 1);
    mbar_wait(v_full(i % VST), (i / VST) & 1);
    release(v_empty(i % VST));
    release(k_empty(i % KST));
  };

  mbar_wait(qg_full, 0);
  for (int i = 0; i < i_lo; ++i) skip(i);
  for (int i = i_lo; i < i_hi; ++i) {
    const int sk = i % KST, sv = i % VST;
    const int k0 = (kt_lo + i) * WG_BK;
    const uint32_t kt = sK + sk * L::TILE_K, vt = sV + sv * L::TILE_K;

    // s = q k^T and dp = dO v^T: key n-tile j of rows g8 (x[4j], x[4j+1])
    // and g8 + 8 (x[4j+2], x[4j+3]); two commit groups
    float s[32], dp[32];
    mbar_wait(k_full(sk), (i / KST) & 1);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_m64n64k16_ss(s, C::kmajor(q_rows + C::kstep(ks, L::BOX_Q)),
                         C::kmajor(kt + C::kstep(ks, L::BOX_K)), ks > 0);
    wgmma_commit();
    mbar_wait(v_full(sv), (i / VST) & 1);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_m64n64k16_ss(dp, C::kmajor(g_rows + C::kstep(ks, L::BOX_Q)),
                         C::kmajor(vt + C::kstep(ks, L::BOX_K)), ks > 0);
    wgmma_commit();

    // P from the saved lse while dO v^T runs: one FMA and one ex2 an
    // element; 0 where masked (only tiles that cross the diagonal, the
    // band's lower edge or the ragged end are masked)
    wgmma_wait<1>();
    fence_regs(s);
    const bool edge = k0 + WG_BK > T_len ||
                      (CAUSAL && k0 + WG_BK - 1 > row0) ||
                      (WINDOW && row0 + 15 - k0 >= window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2_approx(fmaf(s[4 * j + e], scale_log2,
                                  e < 2 ? nl_a : nl_b));
        if (edge) {
          const int col = k0 + j * 8 + t4 * 2 + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          if (col >= T_len ||
              (CAUSAL && (col > row || (WINDOW && row - col >= window))))
            p = 0.f;
        }
        s[4 * j + e] = p;
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
    release(v_empty(sv));

    // dS = P (dP - delta) scale, rounded to bf16 as the A fragments of
    // dS k: the n-tiles 2kk and 2kk+1 are exactly the 16-key step kk
    uint32_t df[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        x[e] = s[8 * kk + e] * (dp[8 * kk + e] - ((e & 2) ? dl_b : dl_a)) *
               scale;
      df[kk][0] = pack_bf16(x[0], x[1]);
      df[kk][1] = pack_bf16(x[2], x[3]);
      df[kk][2] = pack_bf16(x[4], x[5]);
      df[kk][3] = pack_bf16(x[6], x[7]);
    }

    // dq += dS k: K is MN-major here (d contiguous), so a 16-key step is
    // 16 rows of K and its boxes are LBO apart
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tb<D>(acc, df[kk], C::mnmajor(kt + kk * 16 * C::RB, L::BOX_K));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    release(k_empty(sk));
  }
  for (int i = max(i_hi, i_lo); i < n_tiles; ++i) skip(i);

  // epilogue: dq in bf16, rows < S (each element summed by this thread
  // alone, in the order of the tiles: deterministic)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row_b : row_a;
    if (row >= S) continue;
    bf16* out = dq + head + (size_t)row * q_stride;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + j * 8 + t4 * 2) =
          __floats2bfloat162_rn(acc[4 * j + half * 2],
                                acc[4 * j + half * 2 + 1]);
  }
}

template <int D>
int launch_dq_wgmma(int causal, int window, const void* q, const void* k,
                    const void* v, const void* o, const void* g,
                    const void* lse, void* dq, void* delta, int B, int S,
                    int T_len, int H, int KV, float scale, cudaStream_t st) {
  constexpr int BC = TileCols<D>::BC;
  CUtensorMap mq, mg, mk, mv;
  int rc = rt_bshd_map(&mq, q, B, S, H, D, WG_BQ, BC);
  if (rc == 0) rc = rt_bshd_map(&mg, g, B, S, H, D, WG_BQ, BC);
  if (rc == 0) rc = rt_bshd_map(&mk, k, B, T_len, KV, D, WG_BK, BC);
  if (rc == 0) rc = rt_bshd_map(&mv, v, B, T_len, KV, D, WG_BK, BC);
  if (rc != 0) return rc;
  const size_t smem = DqSmem<D>::kBytes;
  auto kernel = window > 0 ? flash_bwd_dq_wgmma_kernel<D, true, true>
                : causal   ? flash_bwd_dq_wgmma_kernel<D, true, false>
                           : flash_bwd_dq_wgmma_kernel<D, false, false>;
  cudaError_t err = rt_set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + WG_BQ - 1) / WG_BQ, H, B);
  kernel<<<grid, WG_NT, smem, st>>>(
      mq, mg, mk, mv, static_cast<const bf16*>(o),
      static_cast<const bf16*>(g), static_cast<const float*>(lse),
      static_cast<bf16*>(dq), static_cast<float*>(delta), S, T_len, H, KV,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------- bf16 dK/dV, TMA + wgmma (K4) ---

constexpr int WG4_BK = 128;  // keys a block: 64 per consumer group
constexpr int WG4_BQ = 64;   // query rows a Q/dO tile
constexpr int WIDE_BK = 64;  // keys a block at head dim 256

template <int D>
struct DkdvSmem {
  using C = TileCols<D>;
  static constexpr int BOX_K = WG4_BK * C::RB;  // a box of K or V
  static constexpr int TILE_K = BOX_K * C::NB;
  static constexpr int BOX_Q = WG4_BQ * C::RB;  // a box of Q or dO
  static constexpr int TILE_Q = BOX_Q * C::NB;
  static constexpr int K = 0;
  static constexpr int V = TILE_K;
  static constexpr int Q = V + TILE_K;
  static constexpr int G = Q + WG_STAGES * TILE_Q;  // dO
  // f32 [stage][-lse log2(e) of the tile's 64 query columns, then delta]
  static constexpr int COLS = G + WG_STAGES * TILE_Q;
  static constexpr int BAR = COLS + 4 * 2 * WG4_BQ * WG_STAGES;
  // kv_full, then q_full, g_full, q_empty, g_empty, c_full (one each a
  // stage); + 1024 to align the tiles
  static constexpr size_t kBytes = BAR + 8 * (1 + 5 * WG_STAGES) + 1024;
  static_assert(kBytes <= 232448, "a block's shared memory");
};

// Head dim 256: K, V and the Q/dO ring are tiles of 64 rows x 256 columns
// (four 64-column boxes); P^T passes from one consumer to the other in f32
// (a float4 of thread t's accumulator n-tile j at [j][t]); after the loop
// the Q/dO ring holds both consumers' f32 sums (128 threads x 128 each)
// for the cluster's blocks to add up.
struct DkdvWideSmem {
  static constexpr int BOX = WIDE_BK * 128;
  static constexpr int TILE = 4 * BOX;
  static constexpr int K = 0;
  static constexpr int V = TILE;
  static constexpr int Q = 2 * TILE;
  static constexpr int G = Q + WG_STAGES * TILE;  // dO
  static constexpr int PT = G + WG_STAGES * TILE;
  static constexpr int COLS = PT + 8 * 128 * 16;
  static constexpr int BAR = COLS + 4 * 2 * WG4_BQ * WG_STAGES;
  static constexpr size_t kBytes = BAR + 8 * (1 + 5 * WG_STAGES) + 1024;
  static constexpr int SUMS = Q;
  static constexpr int SUM_BYTES = 128 * 128 * 4;  // a consumer's
  static_assert(2 * SUM_BYTES <= 2 * WG_STAGES * TILE, "sums fit the ring");
  static_assert(kBytes <= 232448, "a block's shared memory");
};

// Barriers of both K4 layouts, from `bar`: kv_full, then q_full, g_full,
// q_empty, g_empty, c_full (one each a stage)
struct DkdvBars {
  uint32_t kv_full;
  __device__ __forceinline__ uint32_t q_full(int st) const {
    return kv_full + 8 * (1 + st);
  }
  __device__ __forceinline__ uint32_t g_full(int st) const {
    return kv_full + 8 * (1 + WG_STAGES + st);
  }
  __device__ __forceinline__ uint32_t q_empty(int st) const {
    return kv_full + 8 * (1 + 2 * WG_STAGES + st);
  }
  __device__ __forceinline__ uint32_t g_empty(int st) const {
    return kv_full + 8 * (1 + 3 * WG_STAGES + st);
  }
  __device__ __forceinline__ uint32_t c_full(int st) const {
    return kv_full + 8 * (1 + 4 * WG_STAGES + st);
  }
  __device__ __forceinline__ void init() const {
    mbar_init(kv_full, 1);
    for (int st = 0; st < WG_STAGES; ++st) {
      mbar_init(q_full(st), 1);
      mbar_init(g_full(st), 1);
      mbar_init(q_empty(st), 8);  // one arrival per consumer warp
      mbar_init(g_empty(st), 8);
      mbar_init(c_full(st), 32);  // one arrival per lane of producer warp 1
    }
    mbar_fence_init();
  }
};

// The producer group of K4: thread 0 loads the block's K and V once (NB
// boxes of `box_k` bytes each) and streams the (query head, query tile)
// pairs [0, n_tiles) of heads h_lo.. into the Q/dO ring; warp 1 puts each
// tile's lse and delta columns beside it.
template <int NB, int BC>
__device__ __forceinline__ void dkdv_produce(
    const CUtensorMap& tm_q, const CUtensorMap& tm_g, const CUtensorMap& tm_k,
    const CUtensorMap& tm_v, const float* __restrict__ lse,
    const float* __restrict__ delta, const DkdvBars& bars, uint32_t sK,
    uint32_t sV, uint32_t sQ, uint32_t sG, float* cols_sh, int box_k,
    int box_q, int k0, int kvh, int b, int h_lo, int qt_lo, int nq,
    int n_tiles, int S, int H) {
  if (threadIdx.x == 0) {
    mbar_expect_tx(bars.kv_full, 2 * NB * box_k);
    for (int c = 0; c < NB; ++c) {
      tma_load_4d(sK + c * box_k, &tm_k, bars.kv_full, c * BC, kvh, k0, b);
      tma_load_4d(sV + c * box_k, &tm_v, bars.kv_full, c * BC, kvh, k0, b);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % WG_STAGES;
      const uint32_t prev = ((i / WG_STAGES) - 1) & 1;
      const int h = h_lo + i / nq;
      const int q0 = (qt_lo + i % nq) * WG4_BQ;
      const uint32_t qt = sQ + st * NB * box_q, gt = sG + st * NB * box_q;
      // Q is freed after dk += dS^T q, dO after dv += P^T dO: each waits
      // for its own
      if (i >= WG_STAGES) mbar_wait(bars.q_empty(st), prev);
      mbar_expect_tx(bars.q_full(st), NB * box_q);
      for (int c = 0; c < NB; ++c)
        tma_load_4d(qt + c * box_q, &tm_q, bars.q_full(st), c * BC, h, q0, b);
      if (i >= WG_STAGES) mbar_wait(bars.g_empty(st), prev);
      mbar_expect_tx(bars.g_full(st), NB * box_q);
      for (int c = 0; c < NB; ++c)
        tma_load_4d(gt + c * box_q, &tm_g, bars.g_full(st), c * BC, h, q0, b);
    }
  } else if (threadIdx.x / 32 == 1) {
    // lane l: query columns 2l and 2l + 1 of each tile, 0 from S on; the
    // stage is free again once Q is (the consumers read it before dk)
    const int c = 2 * (threadIdx.x % 32);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % WG_STAGES;
      if (i >= WG_STAGES)
        mbar_wait(bars.q_empty(st), ((i / WG_STAGES) - 1) & 1);
      const size_t lrow = ((size_t)b * H + h_lo + i / nq) * S;
      const int col = (qt_lo + i % nq) * WG4_BQ + c;
      float* cs = cols_sh + st * 2 * WG4_BQ;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = col + e < S;
        cs[c + e] = in ? -lse[lrow + col + e] * LOG2E : 0.f;
        cs[WG4_BQ + c + e] = in ? delta[lrow + col + e] : 0.f;
      }
      mbar_arrive(bars.c_full(st));
    }
  }
}

// P^T = exp2(S^T scale log2(e) - lse log2(e)) in place in s (a consumer
// group's 64 keys x 64 query columns, query n-tile jj of keys g8 in
// s[4jj], s[4jj+1] and g8 + 8 in s[4jj+2], s[4jj+3]), with the tile's
// -lse log2(e) columns from `cs` (this thread's, from 2 t4); 0 where
// masked. Only tiles that cross the diagonal, the window's edge or S are
// masked; keys past T are zero-filled rows whose dk and dv are never
// stored.
template <bool CAUSAL, bool WINDOW>
__device__ __forceinline__ void dkdv_probs(float (&s)[32], const float* cs,
                                           float scale_log2, int q0,
                                           int key0, int key_a, int t4,
                                           int S, int window) {
  const bool edge = q0 + WG4_BQ > S || (CAUSAL && key0 + 15 > q0) ||
                    (WINDOW && q0 + WG4_BQ - 1 - key0 >= window);
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const float2 nl = *reinterpret_cast<const float2*>(cs + 8 * jj);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2_approx(
          fmaf(s[4 * jj + e], scale_log2, (e & 1) ? nl.y : nl.x));
      if (edge) {
        const int col = q0 + jj * 8 + t4 * 2 + (e & 1);
        const int ahead = col - key_a - (e < 2 ? 0 : 8);  // query - key
        if (col >= S ||
            (CAUSAL && (ahead < 0 || (WINDOW && ahead >= window))))
          p = 0.f;
      }
      s[4 * jj + e] = p;
    }
  }
}

// dS^T = P^T (dP^T - delta) scale for 16-query step kk, as the bf16 A
// fragment of dk += dS^T q; p holds P^T of the step's n-tiles 2kk, 2kk+1
// (8 values), dp all of dP^T, cs this thread's columns (delta from WG4_BQ)
__device__ __forceinline__ void dkdv_dsfrag(uint32_t (&df)[4],
                                            const float (&p)[8],
                                            const float (&dp)[32],
                                            const float* cs, int kk,
                                            float scale) {
  // delta of query columns 16kk + 2t4 + {0, 1} and 16kk + 8 + ...
  const float2 d0 = *reinterpret_cast<const float2*>(cs + WG4_BQ + 16 * kk);
  const float2 d1 =
      *reinterpret_cast<const float2*>(cs + WG4_BQ + 16 * kk + 8);
  const float dl[4] = {d0.x, d0.y, d1.x, d1.y};
  float x[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    x[e] = p[e] * (dp[8 * kk + e] - dl[((e >> 2) << 1) + (e & 1)]) * scale;
#pragma unroll
  for (int r = 0; r < 4; ++r) df[r] = pack_bf16(x[2 * r], x[2 * r + 1]);
}

// K4 at head dims 64, 80, 96 and 128: one block of 3 warpgroups owns 128 keys
// of one (batch, kv head); each consumer group 64 of them, keeping its dK
// and dV in registers across every query head of the group.
template <int D, bool CAUSAL, bool WINDOW>
__device__ __forceinline__ void dkdv_pair(
    const CUtensorMap& tm_q, const CUtensorMap& tm_g, const CUtensorMap& tm_k,
    const CUtensorMap& tm_v, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int S, int T_len, int H, int KV, int window,
    float scale) {
  using L = DkdvSmem<D>;
  using C = TileCols<D>;
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  // the swizzle repeats every 1024 (128-byte), 512 (64-byte) or 256
  // (32-byte) bytes: align the tiles to it
  const uint32_t base = (smem_u32(smem_tiles) + 1023u) & ~1023u;
  const uint32_t sK = base + L::K, sV = base + L::V;
  const uint32_t sQ = base + L::Q, sG = base + L::G;
  unsigned char* aligned = smem_tiles + (base - smem_u32(smem_tiles));
  float* cols_sh = reinterpret_cast<float*>(aligned + L::COLS);
  const DkdvBars bars{base + L::BAR};

  // under causal attention the first key blocks see the most query tiles:
  // block x is the x-th heaviest of its (batch, kv head), and the blocks go
  // one (batch, kv head) after another, so its Q/dO stay in L2
  const int k0 = blockIdx.x * WG4_BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int groups = H / KV;
  // the query tiles of the band: from the diagonal when causal, up to the
  // last one the block's last key sees under a window (tiles before or
  // after are never loaded)
  int qt_lo = 0, qt_hi = (S + WG4_BQ - 1) / WG4_BQ;
  if (CAUSAL) {
    qt_lo = k0 / WG4_BQ;
    if (WINDOW)
      qt_hi = min(qt_hi, (k0 + WG4_BK - 1 + window - 1) / WG4_BQ + 1);
  }
  const int nq = max(0, qt_hi - qt_lo);
  const int n_tiles = groups * nq;  // (query head of the group, query tile)

  if (threadIdx.x == 0) bars.init();
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    dkdv_produce<C::NB, C::BC>(tm_q, tm_g, tm_k, tm_v, lse, delta, bars, sK,
                               sV, sQ, sG, cols_sh, L::BOX_K, L::BOX_Q, k0,
                               kvh, b, kvh * groups, qt_lo, nq, n_tiles, S,
                               H);
    return;
  }

  // ---- consumers: group cw owns keys k0 + 64 cw .. + 63, in the key-row
  // frame: S^T = K Q^T, dP^T = V dO^T; two f32 accumulators (dK, dV)
  // need FlashAttention-3's 240 registers, not K3's 232 ----
  setmaxnreg_inc<240>();
  const int cw = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g8 = lane >> 2;  // accumulator rows g8 and g8 + 8 of the warp's 16
  const int t4 = lane & 3;   // column pair within an 8-column n-tile
  const int gk = k0 + cw * 64;  // the group's first key
  const int key0 = gk + warp * 16;
  const int key_a = key0 + g8;  // accumulator rows: keys key_a, key_a + 8
  const float scale_log2 = scale * LOG2E;
  const uint32_t k_rows = sK + cw * 64 * C::RB;  // this group's 64 keys
  const uint32_t v_rows = sV + cw * 64 * C::RB;
  auto release = [&](uint32_t bar) {  // this warp is done with a buffer
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  auto skip = [&](int i) {
    const int st = i % WG_STAGES;
    const uint32_t ph = (i / WG_STAGES) & 1;
    mbar_wait(bars.q_full(st), ph);
    mbar_wait(bars.g_full(st), ph);
    release(bars.g_empty(st));
    release(bars.q_empty(st));
  };

  // f32 dk and dv across every query head of the group: d-tile j in
  // x[4j .. 4j+3]
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  // the query tiles some key of this group sees are [j_lo, j_hi) of each
  // head's nq: those before (above its diagonal: the block's first tile
  // for the second group) and after (past its window, or all of them for
  // a group wholly past T) are only waited for and released, in ring order
  int j_lo = 0, j_hi = gk < T_len ? nq : 0;
  if (CAUSAL) j_lo = min(j_hi, gk / WG4_BQ - qt_lo);
  if (WINDOW)
    j_hi = max(j_lo, min(j_hi, (gk + 63 + window - 1) / WG4_BQ + 1 - qt_lo));

  mbar_wait(bars.kv_full, 0);
  for (int hg = 0; hg < groups; ++hg) {
    const int i0 = hg * nq;
    for (int j = 0; j < j_lo; ++j) skip(i0 + j);
    for (int j = j_lo; j < j_hi; ++j) {
      const int i = i0 + j;
      const int st = i % WG_STAGES;
      const uint32_t ph = (i / WG_STAGES) & 1;
      const int q0 = (qt_lo + j) * WG4_BQ;
      const uint32_t qt = sQ + st * L::TILE_Q, gt = sG + st * L::TILE_Q;

      // s^T = k q^T and dp^T = v dO^T: query n-tile jj of keys g8
      // (x[4jj], x[4jj+1]) and g8 + 8 (x[4jj+2], x[4jj+3]); two commit
      // groups
      float s[32], dp[32];
      mbar_wait(bars.q_full(st), ph);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_m64n64k16_ss(s, C::kmajor(k_rows + C::kstep(ks, L::BOX_K)),
                           C::kmajor(qt + C::kstep(ks, L::BOX_Q)), ks > 0);
      wgmma_commit();
      mbar_wait(bars.g_full(st), ph);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_m64n64k16_ss(dp, C::kmajor(v_rows + C::kstep(ks, L::BOX_K)),
                           C::kmajor(gt + C::kstep(ks, L::BOX_Q)), ks > 0);
      wgmma_commit();

      // P^T while dO v^T runs
      const float* cs = cols_sh + st * 2 * WG4_BQ + 2 * t4;
      mbar_wait(bars.c_full(st), ph);
      wgmma_wait<1>();
      fence_regs(s);
      dkdv_probs<CAUSAL, WINDOW>(s, cs, scale_log2, q0, key0, key_a, t4, S,
                                 window);
      wgmma_wait<0>();
      fence_regs(dp);

      // P^T (for dv) and dS^T (for dk), rounded to bf16 as A fragments:
      // the n-tiles 2kk and 2kk+1 are exactly the 16-query step kk
      uint32_t pf[4][4], df[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float p[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) p[e] = s[8 * kk + e];
        dkdv_dsfrag(df[kk], p, dp, cs, kk, scale);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pf[kk][r] = pack_bf16(p[2 * r], p[2 * r + 1]);
      }

      // dv += P^T dO and dk += dS^T q: dO and q are MN-major here (d
      // contiguous), so a 16-query step is 16 rows and their boxes are LBO
      // apart
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_tb<D>(dv_acc, pf[kk],
                       C::mnmajor(gt + kk * 16 * C::RB, L::BOX_Q));
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_tb<D>(dk_acc, df[kk],
                       C::mnmajor(qt + kk * 16 * C::RB, L::BOX_Q));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(dv_acc);
      release(bars.g_empty(st));
      wgmma_wait<0>();
      fence_regs(dk_acc);
      release(bars.q_empty(st));
    }
    for (int j = max(j_hi, j_lo); j < nq; ++j) skip(i0 + j);
  }

  // epilogue: dk and dv in bf16, keys < T (each element summed by this
  // thread alone, over the heads and tiles in order: deterministic)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = key_a + 8 * half;
    if (key >= T_len) continue;
    const size_t off = (((size_t)b * T_len + key) * KV + kvh) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + j * 8 + t4 * 2) =
          __floats2bfloat162_rn(dk_acc[4 * j + half * 2],
                                dk_acc[4 * j + half * 2 + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + j * 8 + t4 * 2) =
          __floats2bfloat162_rn(dv_acc[4 * j + half * 2],
                                dv_acc[4 * j + half * 2 + 1]);
    }
  }
}

// The partial sums of a cluster's blocks, added in rank order: each
// summing thread `tid` (0-127) put its float4s (n-tile n of thread t at
// [n][t]) at `sums`; block `split` of `n_split` adds float4s [split E /
// n_split, (split + 1) E / n_split) of every block and hands each sum to
// store(n, t, sum) (t == tid where E / n_split is a multiple of 128).
// Deterministic, with no atomics and no partial sums in device memory.
template <int E, typename Store>
__device__ __forceinline__ void cluster_add(uint32_t sums, int split,
                                            int n_split, int tid,
                                            Store store) {
  cluster_sync();  // every block's sums are in place
  for (int e = split * E / n_split + tid; e < (split + 1) * E / n_split;
       e += 128) {
    const uint32_t at = sums + e * 16;
    float4 sum = ld_cluster_f4(cluster_map(at, 0));
    for (int r = 1; r < n_split; ++r) {
      const float4 p = ld_cluster_f4(cluster_map(at, r));
      sum.x += p.x;
      sum.y += p.y;
      sum.z += p.z;
      sum.w += p.w;
    }
    store(e / 128, e % 128, sum);
  }
  cluster_sync();  // no block leaves while the others read its sums
}

// K4 at head dim 256: dK and dV of 64 keys would be 256 f32 a thread, so
// one block of 3 warpgroups owns 64 keys and gives each consumer one
// gradient. Consumer 0 computes S^T = K Q^T, P^T, hands P^T to consumer 1
// through shared memory (f32, a named-barrier handshake), and sums dV +=
// P^T dO; consumer 1 computes dP^T = V dO^T, dS^T from P^T, and sums dK +=
// dS^T q: two products each a tile, 128 f32 accumulators each. Where the
// grid is short of two waves, the query heads of a kv head are split over
// the n_split blocks of a thread block cluster, which then add their f32
// sums in rank order through distributed shared memory: deterministic,
// with no atomics and no partial sums in device memory.
template <bool CAUSAL, bool WINDOW>
__device__ __forceinline__ void dkdv_wide(
    const CUtensorMap& tm_q, const CUtensorMap& tm_g, const CUtensorMap& tm_k,
    const CUtensorMap& tm_v, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int S, int T_len, int H, int KV, int window,
    float scale, int n_split) {
  using L = DkdvWideSmem;
  constexpr int D = 256;
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  const uint32_t base = (smem_u32(smem_tiles) + 1023u) & ~1023u;
  const uint32_t sK = base + L::K, sV = base + L::V;
  const uint32_t sQ = base + L::Q, sG = base + L::G;
  unsigned char* aligned = smem_tiles + (base - smem_u32(smem_tiles));
  float* cols_sh = reinterpret_cast<float*>(aligned + L::COLS);
  float4* pt_sh = reinterpret_cast<float4*>(aligned + L::PT);
  const DkdvBars bars{base + L::BAR};

  // block x: key block x / n_split (heaviest first under causal
  // attention), query-head slice x % n_split (its rank in the cluster)
  const int split = blockIdx.x % n_split;
  const int k0 = blockIdx.x / n_split * WIDE_BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int groups = H / KV;
  const int h_lo = kvh * groups + split * groups / n_split;
  const int nh = kvh * groups + (split + 1) * groups / n_split - h_lo;
  int qt_lo = 0, qt_hi = (S + WG4_BQ - 1) / WG4_BQ;
  if (CAUSAL) {
    qt_lo = k0 / WG4_BQ;
    if (WINDOW)
      qt_hi = min(qt_hi, (k0 + WIDE_BK - 1 + window - 1) / WG4_BQ + 1);
  }
  // every tile of the band is seen by some key of the block: none is
  // skipped
  const int nq = max(0, qt_hi - qt_lo);
  const int n_tiles = nh * nq;

  if (threadIdx.x == 0) bars.init();
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    dkdv_produce<4, 64>(tm_q, tm_g, tm_k, tm_v, lse, delta, bars, sK, sV,
                        sQ, sG, cols_sh, L::BOX, L::BOX, k0, kvh, b, h_lo,
                        qt_lo, nq, n_tiles, S, H);
    __syncwarp();
    if (n_split > 1) {  // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int role = threadIdx.x / 128 - 1;  // 0: P^T and dV; 1: dS^T and dK
  const int tid = threadIdx.x % 128;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  const int key0 = k0 + warp * 16;
  const int key_a = key0 + g8;  // accumulator rows: keys key_a, key_a + 8
  const float scale_log2 = scale * LOG2E;
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // named barriers between the consumers: P^T of the tile is in pt_sh,
  // and consumer 1 has read it
  constexpr int PT_FULL = 1, PT_EMPTY = 2, RING_IDLE = 3;

  float acc[D / 2];  // f32 dv (role 0) or dk (role 1): d-tile j in 4j..
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(bars.kv_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % WG_STAGES;
    const uint32_t ph = (i / WG_STAGES) & 1;
    const int q0 = (qt_lo + i % nq) * WG4_BQ;
    const uint32_t qt = sQ + st * L::TILE, gt = sG + st * L::TILE;
    const float* cs = cols_sh + st * 2 * WG4_BQ + 2 * t4;
    float x[32];  // S^T (role 0) or dP^T (role 1), as in dkdv_pair
    uint32_t af[4][4];  // P^T or dS^T: bf16 A fragments, 16 queries each
    if (role == 0) {
      mbar_wait(bars.q_full(st), ph);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t off = (ks / 4) * L::BOX + (ks % 4) * 32;
        wgmma_m64n64k16_ss(x, sw128_desc(sK + off, 16, 1024),
                           sw128_desc(qt + off, 16, 1024), ks > 0);
      }
      wgmma_commit();
      mbar_wait(bars.c_full(st), ph);
      wgmma_wait<0>();
      fence_regs(x);
      dkdv_probs<CAUSAL, WINDOW>(x, cs, scale_log2, q0, key0, key_a, t4, S,
                                 window);
      release(bars.q_empty(st));  // K Q^T is done and lse read
      if (i > 0) named_bar_sync(PT_EMPTY, 256);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        pt_sh[j * 128 + tid] =
            make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
      named_bar_arrive(PT_FULL, 256);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          af[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
      // dv += P^T dO (dO MN-major)
      mbar_wait(bars.g_full(st), ph);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_tb<D>(acc, af[kk], sw128_desc(gt + kk * 2048, L::BOX, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      release(bars.g_empty(st));
    } else {
      mbar_wait(bars.g_full(st), ph);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t off = (ks / 4) * L::BOX + (ks % 4) * 32;
        wgmma_m64n64k16_ss(x, sw128_desc(sV + off, 16, 1024),
                           sw128_desc(gt + off, 16, 1024), ks > 0);
      }
      wgmma_commit();
      mbar_wait(bars.c_full(st), ph);
      wgmma_wait<0>();
      fence_regs(x);
      release(bars.g_empty(st));  // V dO^T is done
      named_bar_sync(PT_FULL, 256);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 p0 = pt_sh[2 * kk * 128 + tid];
        const float4 p1 = pt_sh[(2 * kk + 1) * 128 + tid];
        const float p[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
        dkdv_dsfrag(af[kk], p, x, cs, kk, scale);
      }
      if (i + 1 < n_tiles) named_bar_arrive(PT_EMPTY, 256);
      // dk += dS^T q (q MN-major)
      mbar_wait(bars.q_full(st), ph);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_tb<D>(acc, af[kk], sw128_desc(qt + kk * 2048, L::BOX, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      release(bars.q_empty(st));
    }
  }

  bf16* out = role == 0 ? dv : dk;
  auto store = [&](int j, float a0, float a1, float a2, float a3) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = key_a + 8 * half;
      if (key >= T_len) continue;
      const size_t off = (((size_t)b * T_len + key) * KV + kvh) * D;
      *reinterpret_cast<__nv_bfloat162*>(out + off + j * 8 + t4 * 2) =
          half ? __floats2bfloat162_rn(a2, a3) : __floats2bfloat162_rn(a0, a1);
    }
  };
  if (n_split == 1) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store(j, acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
    return;
  }
  // the cluster's sums: each consumer puts its accumulator over the ring
  // (idle once both consumers are past their last tile), and block r adds
  // d-tiles [32 r / n_split, 32 (r + 1) / n_split) of all of them in rank
  // order (n_split divides 32, so each thread sums its own fragments)
  named_bar_sync(RING_IDLE, 256);
  float4* mine_sh =
      reinterpret_cast<float4*>(aligned + L::SUMS + role * L::SUM_BYTES);
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    mine_sh[j * 128 + tid] =
        make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
  cluster_add<D / 8 * 128>(base + L::SUMS + role * L::SUM_BYTES, split,
                           n_split, tid, [&](int j, int, float4 sum) {
                             store(j, sum.x, sum.y, sum.z, sum.w);
                           });
}

template <int D, bool CAUSAL, bool WINDOW>
__global__ void __launch_bounds__(WG_NT, 1) flash_bwd_dkdv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_g,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int S, int T_len, int H, int KV, int window,
    float scale, int n_split) {
  if constexpr (D == 256)
    dkdv_wide<CAUSAL, WINDOW>(tm_q, tm_g, tm_k, tm_v, lse, delta, dk, dv, S,
                              T_len, H, KV, window, scale, n_split);
  else
    dkdv_pair<D, CAUSAL, WINDOW>(tm_q, tm_g, tm_k, tm_v, lse, delta, dk, dv,
                                 S, T_len, H, KV, window, scale);
}

// the card's SMs (an H100 SXM's 132 where the query fails)
inline int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  return sms;
}

// `kernel` on `grid` x n_split blocks of `threads`, in clusters of n_split
// along x; n_split is the kernel's last argument
template <typename Kernel, typename... Args>
int launch_split(Kernel kernel, dim3 grid, int threads, size_t smem,
                 cudaStream_t st, int n_split, Args... args) {
  grid.x *= n_split;
  if (n_split == 1) {
    kernel<<<grid, threads, smem, st>>>(args..., 1);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args..., n_split);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The query-head slices of K4 at head dim 256: 1, 2 or 4 (the blocks of a
// cluster), doubled while the grid of `blocks` is short of two waves of
// the card's SMs and the group has the heads to split.
inline int dkdv_wide_splits(int blocks, int groups) {
  const int sms = sm_count();
  int n = 1;
  while (n < 4 && 2 * n <= groups && blocks * n < 2 * sms) n *= 2;
  return n;
}

template <int D>
int launch_dkdv_wgmma(int causal, int window, const void* q, const void* k,
                      const void* v, const void* g, const void* lse,
                      const void* delta, void* dk, void* dv, int B, int S,
                      int T_len, int H, int KV, float scale,
                      cudaStream_t st) {
  if (S == 0) {  // no query sees any key: the gradients are 0
    const size_t bytes = sizeof(bf16) * (size_t)B * T_len * KV * D;
    cudaError_t err = cudaMemsetAsync(dk, 0, bytes, st);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, bytes, st);
    return static_cast<int>(err);
  }
  constexpr bool wide = D == 256;
  constexpr int BC = TileCols<D>::BC;
  const int bk = wide ? WIDE_BK : WG4_BK;
  CUtensorMap mq, mg, mk, mv;
  int rc = rt_bshd_map(&mq, q, B, S, H, D, WG4_BQ, BC);
  if (rc == 0) rc = rt_bshd_map(&mg, g, B, S, H, D, WG4_BQ, BC);
  if (rc == 0) rc = rt_bshd_map(&mk, k, B, T_len, KV, D, bk, BC);
  if (rc == 0) rc = rt_bshd_map(&mv, v, B, T_len, KV, D, bk, BC);
  if (rc != 0) return rc;
  size_t smem;
  if constexpr (wide)
    smem = DkdvWideSmem::kBytes;
  else
    smem = DkdvSmem<D>::kBytes;
  auto kernel = window > 0 ? flash_bwd_dkdv_wgmma_kernel<D, true, true>
                : causal   ? flash_bwd_dkdv_wgmma_kernel<D, true, false>
                           : flash_bwd_dkdv_wgmma_kernel<D, false, false>;
  cudaError_t err = rt_set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_kb = (T_len + bk - 1) / bk;
  const int n_split = wide ? dkdv_wide_splits(B * KV * n_kb, H / KV) : 1;
  return launch_split(kernel, dim3(n_kb, KV, B), WG_NT, smem, st, n_split,
                      mq, mg, mk, mv, static_cast<const float*>(lse),
                      static_cast<const float*>(delta),
                      static_cast<bf16*>(dk), static_cast<bf16*>(dv), S,
                      T_len, H, KV, window, scale);
}

// --------------------- bf16 dQ and dK/dV at head dims 16 and 32 (K3, K4) ---

// The blocks, the ring, the swizzled rows, the mma.sync helpers and K3's
// band (dq_small_band) are small_head.cuh's, shared with K1's small-head
// kernel.
constexpr int SM_MAX_SPLIT = 8;  // blocks of a cluster

// K4: the query chunks [lo, hi) some key of the block at k0 sees
__host__ __device__ __forceinline__ void dkdv_small_band(int k0, int S,
                                                         int causal,
                                                         int window, int& lo,
                                                         int& hi) {
  lo = 0;
  hi = (S + SM_CHUNK - 1) / SM_CHUNK;
  if (causal) {
    if (window > 0) {
      const int last = (k0 + SM_ROWS - 1 + window - 1) / SM_CHUNK + 1;
      if (last < hi) hi = last;
    }
    lo = k0 / SM_CHUNK;
    if (lo > hi) lo = hi;
  }
}

// Shared memory of both kernels, from a 1024-byte aligned base: the
// block's own 64 rows (q and dO in K3, k and v in K4), the ring (K3: a K
// and a V chunk a stage; K4: a Q and a dO chunk and their lse and delta),
// the f32 sums the cluster adds, the mbarriers
template <int D, bool DKDV>
struct SmallSmem {
  static constexpr int RB = 2 * D;                // bytes a row
  static constexpr int OWN = SM_ROWS * RB;        // 64 rows
  static constexpr int CHUNK = SM_CHUNK * RB;     // 128 rows
  static constexpr int COLS = 4 * SM_CHUNK;       // f32 lse (or delta)
  static constexpr int STAGE = 2 * CHUNK + (DKDV ? 2 * COLS : 0);
  static constexpr int A = 0;                     // q (K3) or k (K4)
  static constexpr int B = OWN;                   // dO (K3) or v (K4)
  static constexpr int RING = 2 * OWN;
  static constexpr int SUMS = RING + SM_STAGES * STAGE;
  // f32 [float4 index][consumer thread]: dq (K3), or dk then dv (K4)
  static constexpr int SUM_BYTES = (DKDV ? 2 : 1) * SM_ROWS * D * 4;
  static constexpr int BAR = SUMS + SUM_BYTES;
  // own_full, then full and empty (one each a stage); + 1024 to align
  static constexpr size_t kBytes = BAR + 8 * (1 + 2 * SM_STAGES) + 1024;
  static_assert(OWN % 1024 == 0 && STAGE % 1024 == 0, "swizzle atoms");
  static_assert(kBytes <= 232448, "a block's shared memory");
};

// K3 at head dims 16 and 32: block x / n_split owns a 64-row query tile of
// one (batch, head), heaviest first; its n_split blocks (a cluster) take
// every n_split-th 128-key chunk of the tile's band from x % n_split on.
// Warp 4's lane 0 loads q and dO once and the chunks' K and V into a ring
// by TMA; warps 0-3 own 16 query rows each, with q and dO as mma.sync A
// fragments in registers for the whole walk.
template <int D, bool CAUSAL, bool WINDOW>
__global__ void __launch_bounds__(SM_NT) flash_bwd_dq_small_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_g,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const bf16* __restrict__ o,
    const bf16* __restrict__ g, const float* __restrict__ lse,
    bf16* __restrict__ dq, float* __restrict__ delta, int S, int T_len,
    int H, int KV, int window, float scale, int n_split) {
  using L = SmallSmem<D, false>;
  constexpr int ST = SM_STAGES;
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  const uint32_t base = (smem_u32(smem_tiles) + 1023u) & ~1023u;
  unsigned char* aligned = smem_tiles + (base - smem_u32(smem_tiles));
  const uint32_t sQ = base + L::A, sG = base + L::B, ring = base + L::RING;
  const uint32_t own_full = base + L::BAR;
  auto full = [&](int st) { return own_full + 8 * (1 + st); };
  auto empty = [&](int st) { return own_full + 8 * (1 + ST + st); };

  const int split = blockIdx.x % n_split;
  const int n_qt = gridDim.x / n_split;
  const int q0 = (n_qt - 1 - blockIdx.x / n_split) * SM_ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  int c_lo, c_hi;
  dq_small_band(q0, T_len, CAUSAL, WINDOW ? window : 0, c_lo, c_hi);
  const int n_all = c_hi - c_lo;
  const int n_mine =
      n_all > split ? (n_all - split + n_split - 1) / n_split : 0;

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int st = 0; st < ST; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer ----
    if (threadIdx.x == 128) {
      const int kvh = h / (H / KV);
      mbar_expect_tx(own_full, 2 * L::OWN);
      tma_load_4d(sQ, &tm_q, own_full, 0, h, q0, b);
      tma_load_4d(sG, &tm_g, own_full, 0, h, q0, b);
      for (int i = 0; i < n_mine; ++i) {
        const int st = i % ST;
        const int k0 = (c_lo + split + i * n_split) * SM_CHUNK;
        const uint32_t kt = ring + st * L::STAGE;
        if (i >= ST) mbar_wait(empty(st), ((i / ST) - 1) & 1);
        mbar_expect_tx(full(st), 2 * L::CHUNK);
        tma_load_4d(kt, &tm_k, full(st), 0, kvh, k0, b);
        tma_load_4d(kt + L::CHUNK, &tm_v, full(st), 0, kvh, k0, b);
      }
    }
    __syncwarp();
    if (n_split > 1) {  // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // ---- consumers: warp w owns query rows q0 + 16 w .. + 15 ----
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g8 = lane >> 2;  // accumulator rows g8 and g8 + 8 of the warp's
  const int t4 = lane & 3;   // column pair within an 8-column n-tile
  const int row0 = q0 + warp * 16;
  const int row_a = row0 + g8;
  const int row_b = row_a + 8;
  const size_t q_stride = (size_t)H * D;
  const size_t head = ((size_t)b * S * H + h) * D;
  const size_t lrow = ((size_t)b * H + h) * S;

  // delta = rowsum(O * dO) in f32 from device memory while the tiles land:
  // lanes 2r and 2r + 1 share row r of the warp's 16; rank 0 stores it
  float dl_a, dl_b;
  {
    const int row = row0 + (lane >> 1);
    float a = 0.f;
    if (row < S) {
#pragma unroll
      for (int c = lane & 1; c < D / 8; c += 2) {
        const size_t off = head + (size_t)row * q_stride + c * 8;
        const uint4 ov = __ldg(reinterpret_cast<const uint4*>(o + off));
        const uint4 gv = __ldg(reinterpret_cast<const uint4*>(g + off));
        const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 x = __bfloat1622float2(op[i]);
          const float2 y = __bfloat1622float2(gp[i]);
          a = fmaf(x.x, y.x, a);
          a = fmaf(x.y, y.y, a);
        }
      }
    }
    a += __shfl_xor_sync(0xffffffffu, a, 1);
    if (split == 0 && (lane & 1) == 0 && row < S) delta[lrow + row] = a;
    dl_a = __shfl_sync(0xffffffffu, a, 2 * g8);
    dl_b = __shfl_sync(0xffffffffu, a, 2 * g8 + 16);
  }
  // P = exp(s scale - lse) = exp2(s scale log2(e) - lse log2(e))
  const float scale_log2 = scale * LOG2E;
  const float nl_a = row_a < S ? -lse[lrow + row_a] * LOG2E : 0.f;
  const float nl_b = row_b < S ? -lse[lrow + row_b] * LOG2E : 0.f;

  // the sums q k^T starts from (0), and dO v^T (-delta: dP - delta)
  const float z4[4] = {0.f, 0.f, 0.f, 0.f};
  const float nd[4] = {-dl_a, -dl_a, -dl_b, -dl_b};
  auto zero = [&](int) -> const float(&)[4] { return z4; };
  auto neg_dl = [&](int) -> const float(&)[4] { return nd; };

  uint32_t qf[D / 16][4], gf[D / 16][4];
  mbar_wait(own_full, 0);
  load_rows_a<D>(qf, sQ, warp * 16, lane);
  load_rows_a<D>(gf, sG, warp * 16, lane);

  float acc[D / 8][4];  // f32 dq: rows g8 (acc[n][0..1]) and g8 + 8
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const bool live = row0 < S;
  for (int i = 0; i < n_mine; ++i) {
    const int st = i % ST;
    const int kc = (c_lo + split + i * n_split) * SM_CHUNK;
    const uint32_t kt = ring + st * L::STAGE, vt = kt + L::CHUNK;
    mbar_wait(full(st), (i / ST) & 1);
#pragma unroll
    for (int sub = 0; sub < 2; ++sub) {
      const int k0 = kc + sub * 64;
      // 64 keys no row of the warp sees: past T, above its diagonal, or
      // below its window
      if (!live || k0 >= T_len || (CAUSAL && k0 > row0 + 15) ||
          (WINDOW && row0 - (k0 + 63) >= window))
        continue;
      float s[8][4], dp[8][4];
      mma_rows<D>(s, qf, kt, sub * 64, lane, zero);  // s = q k^T
      // dp = dO v^T - delta
      mma_rows<D>(dp, gf, vt, sub * 64, lane, neg_dl);
      // dS / scale = P (dP - delta), P = exp2(s scale log2(e) - lse
      // log2(e)); only keys that cross T, the diagonal or the window's
      // edge are masked, on their own code path
      const bool edge = k0 + 64 > T_len || (CAUSAL && k0 + 63 > row0) ||
                        (WINDOW && row0 + 15 - k0 >= window);
      auto probs = [&](auto masked) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = ex2_approx(
                fmaf(s[n][e], scale_log2, e < 2 ? nl_a : nl_b));
            if constexpr (decltype(masked)::value) {
              const int col = k0 + n * 8 + t4 * 2 + (e & 1);
              const int row = e < 2 ? row_a : row_b;
              if (col >= T_len ||
                  (CAUSAL && (col > row || (WINDOW && row - col >= window))))
                p = 0.f;
            }
            s[n][e] = p * dp[n][e];
          }
      };
      if (edge)
        probs(std::true_type{});
      else
        probs(std::false_type{});
      mma_xm_rows<D>(acc, s, kt, sub * 64, lane);  // dq += dS k / scale
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }

#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] *= scale;

  // epilogue: dq in bf16, rows < S
  auto store = [&](int n, int t, float4 x) {
    const int ra = q0 + (t >> 5) * 16 + ((t & 31) >> 2);
    const int col = n * 8 + (t & 3) * 2;
    if (ra < S)
      *reinterpret_cast<__nv_bfloat162*>(dq + head + (size_t)ra * q_stride +
                                         col) = __floats2bfloat162_rn(x.x, x.y);
    if (ra + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(
          dq + head + (size_t)(ra + 8) * q_stride + col) =
          __floats2bfloat162_rn(x.z, x.w);
  };
  if (n_split == 1) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store(n, threadIdx.x,
            make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]));
    return;
  }
  float4* mine = reinterpret_cast<float4*>(aligned + L::SUMS);
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    mine[n * 128 + threadIdx.x] =
        make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
  cluster_add<D / 8 * 128>(base + L::SUMS, split, n_split, threadIdx.x,
                           store);
}

// K4 at head dims 16 and 32: block x / n_split owns 64 keys of one (batch,
// kv head), heaviest first; its n_split blocks (a cluster) take every
// n_split-th (query head of the group, 128-row query chunk) pair of the
// band from x % n_split on. Warp 4's lane 0 loads k and v once and each
// pair's Q and dO chunks, with their 128 lse and delta, into a ring by TMA;
// warps 0-3 own 16 keys each, with k and v as mma.sync A fragments in
// registers for the whole walk, and dK, dV in f32 registers.
template <int D, bool CAUSAL, bool WINDOW>
__global__ void __launch_bounds__(SM_NT) flash_bwd_dkdv_small_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_g,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_lse,
    const __grid_constant__ CUtensorMap tm_delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int S, int T_len, int H, int KV, int window,
    float scale, int n_split) {
  using L = SmallSmem<D, true>;
  constexpr int ST = SM_STAGES;
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  const uint32_t base = (smem_u32(smem_tiles) + 1023u) & ~1023u;
  unsigned char* aligned = smem_tiles + (base - smem_u32(smem_tiles));
  const uint32_t sK = base + L::A, sV = base + L::B, ring = base + L::RING;
  const uint32_t own_full = base + L::BAR;
  auto full = [&](int st) { return own_full + 8 * (1 + st); };
  auto empty = [&](int st) { return own_full + 8 * (1 + ST + st); };

  const int split = blockIdx.x % n_split;
  const int k0 = blockIdx.x / n_split * SM_ROWS;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int groups = H / KV;
  int c_lo, c_hi;
  dkdv_small_band(k0, S, CAUSAL, WINDOW ? window : 0, c_lo, c_hi);
  const int nq = c_hi - c_lo;
  const int n_all = groups * nq;  // (query head of the group, query chunk)
  const int n_mine =
      n_all > split ? (n_all - split + n_split - 1) / n_split : 0;

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int st = 0; st < ST; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer ----
    if (threadIdx.x == 128) {
      mbar_expect_tx(own_full, 2 * L::OWN);
      tma_load_4d(sK, &tm_k, own_full, 0, kvh, k0, b);
      tma_load_4d(sV, &tm_v, own_full, 0, kvh, k0, b);
      for (int i = 0; i < n_mine; ++i) {
        const int st = i % ST;
        const int j = split + i * n_split;
        const int hh = kvh * groups + j / nq;
        const int q0 = (c_lo + j % nq) * SM_CHUNK;
        const int col = ((b * H + hh) * S) + q0;  // lse and delta
        const uint32_t qt = ring + st * L::STAGE;
        if (i >= ST) mbar_wait(empty(st), ((i / ST) - 1) & 1);
        mbar_expect_tx(full(st), L::STAGE);
        tma_load_4d(qt, &tm_q, full(st), 0, hh, q0, b);
        tma_load_4d(qt + L::CHUNK, &tm_g, full(st), 0, hh, q0, b);
        tma_load_1d(qt + 2 * L::CHUNK, &tm_lse, full(st), col);
        tma_load_1d(qt + 2 * L::CHUNK + L::COLS, &tm_delta, full(st), col);
      }
    }
    __syncwarp();
    if (n_split > 1) {  // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // ---- consumers: warp w owns keys k0 + 16 w .. + 15, in the key-row
  // frame: S^T = K Q^T, dP^T = V dO^T ----
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g8 = lane >> 2;  // accumulator rows: keys key_a, key_a + 8
  const int t4 = lane & 3;   // query column pair within an n-tile
  const int key0 = k0 + warp * 16;
  const int key_a = key0 + g8;
  const float scale_log2 = scale * LOG2E;

  const float z4[4] = {0.f, 0.f, 0.f, 0.f};
  auto zero = [&](int) -> const float(&)[4] { return z4; };

  uint32_t kf[D / 16][4], vf[D / 16][4];
  mbar_wait(own_full, 0);
  load_rows_a<D>(kf, sK, warp * 16, lane);
  load_rows_a<D>(vf, sV, warp * 16, lane);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const bool live = key0 < T_len;
  for (int i = 0; i < n_mine; ++i) {
    const int st = i % ST;
    const int j = split + i * n_split;
    const int qc = (c_lo + j % nq) * SM_CHUNK;
    const uint32_t qt = ring + st * L::STAGE, gt = qt + L::CHUNK;
    const float* cols = reinterpret_cast<const float*>(
        aligned + L::RING + st * L::STAGE + 2 * L::CHUNK);
    mbar_wait(full(st), (i / ST) & 1);
#pragma unroll
    for (int sub = 0; sub < 2; ++sub) {
      const int qs = qc + sub * 64;
      // 64 queries no key of the warp sees: past S, before its diagonal, or
      // past its window
      if (!live || qs >= S || (CAUSAL && qs + 63 < key0) ||
          (WINDOW && qs - (key0 + 15) >= window))
        continue;
      // s^T = k q^T: keys g8, g8 + 8 (rows), queries qs + 8n + 2 t4 + {0,
      // 1} (columns)
      const float* lse_c = cols + sub * 64 + t4 * 2;
      const float* dl_c = lse_c + SM_CHUNK;
      float p[8][4];
      mma_rows<D>(p, kf, qt, sub * 64, lane, zero);
      // P^T = exp2(s^T scale log2(e) - lse log2(e)); only queries that
      // cross S, the diagonal or the window's edge are masked, on their
      // own code path
      const bool edge = qs + 64 > S || (CAUSAL && key0 + 15 > qs) ||
                        (WINDOW && qs + 63 - key0 >= window);
      auto probs = [&](auto masked) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 l2 = *reinterpret_cast<const float2*>(lse_c + n * 8);
          const float nl[2] = {-l2.x * LOG2E, -l2.y * LOG2E};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = ex2_approx(fmaf(p[n][e], scale_log2, nl[e & 1]));
            if constexpr (decltype(masked)::value) {
              const int col = qs + n * 8 + t4 * 2 + (e & 1);
              const int ahead = col - key_a - (e < 2 ? 0 : 8);  // q - k
              if (col >= S ||
                  (CAUSAL && (ahead < 0 || (WINDOW && ahead >= window))))
                x = 0.f;
            }
            p[n][e] = x;
          }
        }
      };
      if (edge)
        probs(std::true_type{});
      else
        probs(std::false_type{});
      mma_xm_rows<D>(dv_acc, p, gt, sub * 64, lane);  // dv += P^T dO
      // dp^T = v dO^T - delta, each n-tile's sums started at its columns'
      // -delta; dS^T / scale = P^T (dP^T - delta)
      float ds[8][4], nd[4];
      mma_rows<D>(ds, vf, gt, sub * 64, lane,
                  [&](int n) -> const float(&)[4] {
                    const float2 d2 =
                        *reinterpret_cast<const float2*>(dl_c + n * 8);
                    nd[0] = nd[2] = -d2.x;
                    nd[1] = nd[3] = -d2.y;
                    return nd;
                  });
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[n][e] *= p[n][e];
      mma_xm_rows<D>(dk_acc, ds, qt, sub * 64, lane);  // dk += dS^T q / scale
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }

#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] *= scale;

  // epilogue: dk and dv in bf16, keys < T (float4 index n: dk's n-tile n,
  // then dv's n-tile n - D / 8)
  auto store = [&](int n, int t, float4 x) {
    const int key = k0 + (t >> 5) * 16 + ((t & 31) >> 2);
    bf16* out = n < D / 8 ? dk : dv;
    const int col = (n % (D / 8)) * 8 + (t & 3) * 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (key + 8 * half >= T_len) continue;
      const size_t off = (((size_t)b * T_len + key + 8 * half) * KV + kvh) * D;
      *reinterpret_cast<__nv_bfloat162*>(out + off + col) =
          half ? __floats2bfloat162_rn(x.z, x.w)
               : __floats2bfloat162_rn(x.x, x.y);
    }
  };
  if (n_split == 1) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      store(n, threadIdx.x, make_float4(dk_acc[n][0], dk_acc[n][1],
                                        dk_acc[n][2], dk_acc[n][3]));
      store(D / 8 + n, threadIdx.x,
            make_float4(dv_acc[n][0], dv_acc[n][1], dv_acc[n][2],
                        dv_acc[n][3]));
    }
    return;
  }
  float4* mine = reinterpret_cast<float4*>(aligned + L::SUMS);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    mine[n * 128 + threadIdx.x] =
        make_float4(dk_acc[n][0], dk_acc[n][1], dk_acc[n][2], dk_acc[n][3]);
    mine[(D / 8 + n) * 128 + threadIdx.x] =
        make_float4(dv_acc[n][0], dv_acc[n][1], dv_acc[n][2], dv_acc[n][3]);
  }
  cluster_add<2 * (D / 8) * 128>(base + L::SUMS, split, n_split,
                                 threadIdx.x, store);
}

// The blocks of a cluster at head dims 16 and 32: doubled (up to
// SM_MAX_SPLIT) while the heaviest block's chain of `chain` ring stages
// gives each block at least two and the grid of `blocks` is short of three
// blocks an SM. A split costs each block its own loads of q and dO (or k
// and v) and the cluster's sum: at the tiny presets' shape K3 ran 0.0233
// ms split in two, 0.0209 whole, and K4 0.0291 in two, 0.0297-0.0300 in
// four, 0.0305-0.0310 whole (PERF.md).
inline int small_splits(int blocks, int chain) {
  const int sms = sm_count();
  int n = 1;
  while (n < SM_MAX_SPLIT && 4 * n <= chain && blocks * n < 3 * sms) n *= 2;
  return n;
}

// the cluster sizes of K3 and K4 at a shape (the heaviest block's chain:
// its key chunks in K3, its (query head, query chunk) pairs in K4)
inline int dq_small_splits(int causal, int window, int B, int S, int T_len,
                           int H) {
  const int n_qt = (S + SM_ROWS - 1) / SM_ROWS;
  int chain = 0;
  for (int t = 0; t < n_qt; ++t) {
    int lo, hi;
    dq_small_band(t * SM_ROWS, T_len, causal, window, lo, hi);
    if (hi - lo > chain) chain = hi - lo;
  }
  return small_splits(n_qt * H * B, chain);
}
inline int dkdv_small_splits(int causal, int window, int B, int S, int T_len,
                             int H, int KV) {
  const int n_kb = (T_len + SM_ROWS - 1) / SM_ROWS;
  int chain = 0;
  for (int t = 0; t < n_kb; ++t) {
    int lo, hi;
    dkdv_small_band(t * SM_ROWS, S, causal, window, lo, hi);
    if ((H / KV) * (hi - lo) > chain) chain = (H / KV) * (hi - lo);
  }
  return small_splits(n_kb * KV * B, chain);
}

template <int D>
int launch_dq_small(int causal, int window, const void* q, const void* k,
                    const void* v, const void* o, const void* g,
                    const void* lse, void* dq, void* delta, int B, int S,
                    int T_len, int H, int KV, float scale, cudaStream_t st) {
  CUtensorMap mq, mg, mk, mv;
  int rc = rt_bshd_map(&mq, q, B, S, H, D, SM_ROWS, D);
  if (rc == 0) rc = rt_bshd_map(&mg, g, B, S, H, D, SM_ROWS, D);
  if (rc == 0) rc = rt_bshd_map(&mk, k, B, T_len, KV, D, SM_CHUNK, D);
  if (rc == 0) rc = rt_bshd_map(&mv, v, B, T_len, KV, D, SM_CHUNK, D);
  if (rc != 0) return rc;
  const size_t smem = SmallSmem<D, false>::kBytes;
  auto kernel = window > 0 ? flash_bwd_dq_small_kernel<D, true, true>
                : causal   ? flash_bwd_dq_small_kernel<D, true, false>
                           : flash_bwd_dq_small_kernel<D, false, false>;
  cudaError_t err = rt_set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (S + SM_ROWS - 1) / SM_ROWS;
  return launch_split(kernel, dim3(n_qt, H, B), SM_NT, smem, st,
                      dq_small_splits(causal, window, B, S, T_len, H), mq,
                      mg, mk, mv, static_cast<const bf16*>(o),
                      static_cast<const bf16*>(g),
                      static_cast<const float*>(lse), static_cast<bf16*>(dq),
                      static_cast<float*>(delta), S, T_len, H, KV, window,
                      scale);
}

template <int D>
int launch_dkdv_small(int causal, int window, const void* q, const void* k,
                      const void* v, const void* g, const void* lse,
                      const void* delta, void* dk, void* dv, int B, int S,
                      int T_len, int H, int KV, float scale,
                      cudaStream_t st) {
  if (S == 0) {  // no query sees any key: the gradients are 0
    const size_t bytes = sizeof(bf16) * (size_t)B * T_len * KV * D;
    cudaError_t err = cudaMemsetAsync(dk, 0, bytes, st);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, bytes, st);
    return static_cast<int>(err);
  }
  CUtensorMap mq, mg, mk, mv, ml, md;
  int rc = rt_bshd_map(&mq, q, B, S, H, D, SM_CHUNK, D);
  if (rc == 0) rc = rt_bshd_map(&mg, g, B, S, H, D, SM_CHUNK, D);
  if (rc == 0) rc = rt_bshd_map(&mk, k, B, T_len, KV, D, SM_ROWS, D);
  if (rc == 0) rc = rt_bshd_map(&mv, v, B, T_len, KV, D, SM_ROWS, D);
  // lse and delta as one row of B H S floats: a chunk past its row's S
  // reads the next row's (or zeros past the end), and those columns are
  // masked
  if (rc == 0) rc = rt_f32_map(&ml, lse, (size_t)B * H * S, SM_CHUNK);
  if (rc == 0) rc = rt_f32_map(&md, delta, (size_t)B * H * S, SM_CHUNK);
  if (rc != 0) return rc;
  const size_t smem = SmallSmem<D, true>::kBytes;
  auto kernel = window > 0 ? flash_bwd_dkdv_small_kernel<D, true, true>
                : causal   ? flash_bwd_dkdv_small_kernel<D, true, false>
                           : flash_bwd_dkdv_small_kernel<D, false, false>;
  cudaError_t err = rt_set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_kb = (T_len + SM_ROWS - 1) / SM_ROWS;
  return launch_split(kernel, dim3(n_kb, KV, B), SM_NT, smem, st,
                      dkdv_small_splits(causal, window, B, S, T_len, H, KV),
                      mq, mg, mk, mv, ml, md, static_cast<bf16*>(dk),
                      static_cast<bf16*>(dv), S, T_len, H, KV, window,
                      scale);
}

// ------------------------------------------------------------------- f32 ---

template <int D>
struct F32Bwd {
  // rows a warp owns (queries in K3, keys in K4): 8 at head dim 256, where
  // 16 would need 263 KB of shared memory and 256 accumulators in K4
  static constexpr int RW = D > 128 ? 8 : 16;
  static constexpr int R = 4 * RW;    // the block's rows
  static constexpr int DC = (D + 31) / 32;  // output columns a lane owns
  static constexpr int LD = D + 1;    // staggers banks for column-wise reads
  static constexpr int PLD = 64 + 1;
  static constexpr size_t kBytes =
      sizeof(float) * ((size_t)(2 * R + 2 * 64) * LD + (size_t)2 * R * PLD +
                       2 * 64);
};

// column lane + 32 c exists (always, where D is a multiple of 32)
template <int D>
__device__ __forceinline__ bool has_col(int lane, int c) {
  return D % 32 == 0 || lane + 32 * c < D;
}

// acc[i][c] += sum_j X[i][j] M[j][lane + 32 c] for the warp's RW rows of X
// (row stride PLD) and a [64, D] tile M (row stride LD): j outermost, so
// each M element is read once per warp and the unrolled body stays small
template <int D, int LD, int PLD, int RW>
__device__ __forceinline__ void accumulate_xm(
    float (&acc)[RW][(D + 31) / 32], const float* Xw, const float* M,
    int lane) {
  constexpr int DC = (D + 31) / 32;
  for (int j = 0; j < 64; ++j) {
    float m[DC];
#pragma unroll
    for (int c = 0; c < DC; ++c)
      m[c] = has_col<D>(lane, c) ? M[j * LD + lane + 32 * c] : 0.f;
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const float x = Xw[i * PLD + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(x, m[c], acc[i][c]);
    }
  }
}

// rows [0, rows) of a [rows, D] f32 tile (row stride LD) from global rows
// `stride` apart; rows past `valid` are zero-filled
template <int D, int LD>
__device__ __forceinline__ void load_f32(float* dst, const float* src,
                                         size_t stride, int valid,
                                         int rows = 64) {
  for (int i = threadIdx.x; i < rows * D; i += NT) {
    const int r = i / D;
    const int c = i - r * D;
    dst[r * LD + c] = r < valid ? src[(size_t)r * stride + c] : 0.f;
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NT) flash_bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ o,
    const float* __restrict__ g, const float* __restrict__ lse,
    float* __restrict__ dq, float* __restrict__ delta, int S, int T_len,
    int H, int KV, int window, float scale) {
  using L = F32Bwd<D>;
  constexpr int DC = L::DC;  // output columns a lane owns
  constexpr int RW = L::RW;  // query rows a warp owns
  constexpr int R = L::R;    // the block's
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [R, LD]
  float* Gs = Qs + R * L::LD;                  // [R, LD] dO
  float* Ks = Gs + R * L::LD;                  // [BK, LD]
  float* Vs = Ks + BK * L::LD;                 // [BK, LD]
  float* Ps = Vs + BK * L::LD;                 // [R, PLD] dS
  float* lse_sh = Ps + R * L::PLD;             // [R]
  float* dl_sh = lse_sh + R;                   // [R]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * R;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * RW;

  const size_t q_stride = (size_t)H * D;
  const size_t kv_stride = (size_t)KV * D;
  const size_t head = ((size_t)b * S * H + h) * D;
  const float* kb = k + ((size_t)b * T_len * KV + kvh) * D;
  const float* vb = v + ((size_t)b * T_len * KV + kvh) * D;

  load_f32<D, L::LD>(Qs, q + head + (size_t)q0 * q_stride, q_stride, S - q0,
                     R);
  load_f32<D, L::LD>(Gs, g + head + (size_t)q0 * q_stride, q_stride, S - q0,
                     R);
  __syncthreads();
  for (int i = 0; i < RW; ++i) {
    const int row = q0 + r0 + i;
    float a = 0.f;
    if (row < S) {
      const float* orow = o + head + (size_t)row * q_stride;
      for (int d = lane; d < D; d += 32) a += orow[d] * Gs[(r0 + i) * L::LD + d];
    }
    a = warp_sum(a);
    if (lane == 0) {
      const size_t li = ((size_t)b * H + h) * S + row;
      dl_sh[r0 + i] = a;
      lse_sh[r0 + i] = row < S ? lse[li] : 0.f;
      if (row < S) delta[li] = a;
    }
  }
  __syncwarp();  // a warp reads only its own rows of dl_sh / lse_sh

  int kt_lo, kt_hi;
  key_tiles<CAUSAL, R>(q0, T_len, window, kt_lo, kt_hi);
  float acc[RW][DC];
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K/V and dS are no longer read
    load_f32<D, L::LD>(Ks, kb + (size_t)k0 * kv_stride, kv_stride, T_len - k0);
    load_f32<D, L::LD>(Vs, vb + (size_t)k0 * kv_stride, kv_stride, T_len - k0);
    __syncthreads();

    // lane owns key columns lane and lane + 32 of the warp's RW rows
    float s0[RW], s1[RW], d0[RW], d1[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) s0[i] = s1[i] = d0[i] = d1[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float ka = Ks[lane * L::LD + d];
      const float kc = Ks[(lane + 32) * L::LD + d];
      const float va = Vs[lane * L::LD + d];
      const float vc = Vs[(lane + 32) * L::LD + d];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float qv = Qs[(r0 + i) * L::LD + d];
        const float gv = Gs[(r0 + i) * L::LD + d];
        s0[i] = fmaf(qv, ka, s0[i]);
        s1[i] = fmaf(qv, kc, s1[i]);
        d0[i] = fmaf(gv, va, d0[i]);
        d1[i] = fmaf(gv, vc, d1[i]);
      }
    }
    float* Pw = Ps + r0 * L::PLD;
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int row = q0 + r0 + i;
      const float m = lse_sh[r0 + i];
      const float dl = dl_sh[r0 + i];
      const int c0 = k0 + lane;
      const float p0 = visible<CAUSAL>(row, c0, S, T_len, window)
                           ? expf(s0[i] * scale - m) : 0.f;
      const float p1 = visible<CAUSAL>(row, c0 + 32, S, T_len, window)
                           ? expf(s1[i] * scale - m) : 0.f;
      Pw[i * L::PLD + lane] = p0 * (d0[i] - dl) * scale;
      Pw[i * L::PLD + lane + 32] = p1 * (d1[i] - dl) * scale;
    }
    __syncwarp();
    accumulate_xm<D, L::LD, L::PLD, RW>(acc, Pw, Ks, lane);  // dq += dS k
  }

  for (int i = 0; i < RW; ++i) {
    const int row = q0 + r0 + i;
    if (row >= S) break;
    float* out = dq + head + (size_t)row * q_stride;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      if (has_col<D>(lane, c)) out[lane + 32 * c] = acc[i][c];
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int S, int T_len, int H,
    int KV, int window, float scale) {
  using L = F32Bwd<D>;
  constexpr int DC = L::DC;
  constexpr int RW = L::RW;  // keys a warp owns
  constexpr int R = L::R;    // the block's
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);  // [R, LD]
  float* Vs = Ks + R * L::LD;                  // [R, LD]
  float* Qs = Vs + R * L::LD;                  // [BQ, LD]
  float* Gs = Qs + BQ * L::LD;                 // [BQ, LD] dO
  float* Ps = Gs + BQ * L::LD;                 // [R, PLD] P^T
  float* Ds = Ps + R * L::PLD;                 // [R, PLD] dS^T
  float* lse_sh = Ds + R * L::PLD;             // [BQ]
  float* dl_sh = lse_sh + BQ;                  // [BQ]

  const int k0 = blockIdx.x * R;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int groups = H / KV;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0 = warp * RW;  // the warp's RW keys

  const size_t q_stride = (size_t)H * D;
  const size_t kv_stride = (size_t)KV * D;
  const size_t kv_off = ((size_t)b * T_len * KV + kvh) * D;
  load_f32<D, L::LD>(Ks, k + kv_off + (size_t)k0 * kv_stride, kv_stride,
                     T_len - k0, R);
  load_f32<D, L::LD>(Vs, v + kv_off + (size_t)k0 * kv_stride, kv_stride,
                     T_len - k0, R);

  int qt_lo, qt_hi;
  query_tiles<CAUSAL, R>(k0, S, window, qt_lo, qt_hi);
  float dka[RW][DC], dva[RW][DC];
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dka[i][c] = dva[i][c] = 0.f;

  for (int gi = 0; gi < groups; ++gi) {
    const int hh = kvh * groups + gi;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * BQ;
      const size_t off = ((size_t)b * S * H + hh) * D + (size_t)q0 * q_stride;
      __syncthreads();  // the previous tile's q, dO and P are no longer read
      load_f32<D, L::LD>(Qs, q + off, q_stride, S - q0);
      load_f32<D, L::LD>(Gs, g + off, q_stride, S - q0);
      if (tid < BQ) {
        const int row = q0 + tid;
        const size_t li = ((size_t)b * H + hh) * S + row;
        lse_sh[tid] = row < S ? lse[li] : 0.f;
        dl_sh[tid] = row < S ? delta[li] : 0.f;
      }
      __syncthreads();

      // lane owns query columns lane and lane + 32 of the warp's RW keys
      float s0[RW], s1[RW], d0[RW], d1[RW];
#pragma unroll
      for (int i = 0; i < RW; ++i) s0[i] = s1[i] = d0[i] = d1[i] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float qa = Qs[lane * L::LD + d];
        const float qc = Qs[(lane + 32) * L::LD + d];
        const float ga = Gs[lane * L::LD + d];
        const float gc = Gs[(lane + 32) * L::LD + d];
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          const float kv = Ks[(r0 + i) * L::LD + d];
          const float vv = Vs[(r0 + i) * L::LD + d];
          s0[i] = fmaf(kv, qa, s0[i]);
          s1[i] = fmaf(kv, qc, s1[i]);
          d0[i] = fmaf(vv, ga, d0[i]);
          d1[i] = fmaf(vv, gc, d1[i]);
        }
      }
      float* Pw = Ps + r0 * L::PLD;
      float* Dw = Ds + r0 * L::PLD;
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const int key = k0 + r0 + i;
        const float p0 = visible<CAUSAL>(q0 + lane, key, S, T_len, window)
                             ? expf(s0[i] * scale - lse_sh[lane]) : 0.f;
        const float p1 =
            visible<CAUSAL>(q0 + lane + 32, key, S, T_len, window)
                ? expf(s1[i] * scale - lse_sh[lane + 32]) : 0.f;
        Pw[i * L::PLD + lane] = p0;
        Pw[i * L::PLD + lane + 32] = p1;
        Dw[i * L::PLD + lane] = p0 * (d0[i] - dl_sh[lane]) * scale;
        Dw[i * L::PLD + lane + 32] = p1 * (d1[i] - dl_sh[lane + 32]) * scale;
      }
      __syncwarp();
      accumulate_xm<D, L::LD, L::PLD, RW>(dva, Pw, Gs, lane);  // dv += P^T dO
      accumulate_xm<D, L::LD, L::PLD, RW>(dka, Dw, Qs, lane);  // dk += dS^T q
    }
  }

  for (int i = 0; i < RW; ++i) {
    const int key = k0 + r0 + i;
    if (key >= T_len) break;
    const size_t off = kv_off + (size_t)key * kv_stride;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      if (!has_col<D>(lane, c)) continue;
      dk[off + lane + 32 * c] = dka[i][c];
      dv[off + lane + 32 * c] = dva[i][c];
    }
  }
}

// ------------------------------------------- head dims above 256, wide ---

// K3 at a head dim D above 256 (a multiple of 8, no upper limit), both
// dtypes: one block per (32 query rows, 64-column chunk of dq, head,
// batch). delta = rowsum(o * dO) over all of D first (the blocks of
// column chunk 0 store it for K4); then for each K/V tile of 64 keys in
// the band, S = q k^T and dP = dO v^T sum over every column chunk
// (wide_head.cuh), P = exp(S scale - lse), dS = P (dP - delta) scale, and
// dq += dS k on the block's own 64 columns of k (its chunk is the last
// one staged). P and dS stay f32.
template <typename T, bool CAUSAL>
__global__ void __launch_bounds__(WD_NT) flash_bwd_dq_wide_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ o,
    const T* __restrict__ g, const float* __restrict__ lse,
    T* __restrict__ dq, float* __restrict__ delta, int S, int T_len, int H,
    int KV, int D, int window, float scale) {
  extern __shared__ __align__(16) float wsm[];
  float* Qs = wsm;                 // [32, WD_LD] a column chunk of q
  float* Gs = Qs + WD_R * WD_LD;   // [32, WD_LD] of dO
  float* Ks = Gs + WD_R * WD_LD;   // [64, WD_LD] of k
  float* Vs = Ks + WD_C * WD_LD;   // [64, WD_LD] of v
  float* Ps = Vs + WD_C * WD_LD;   // [32, WD_LD] dS
  float* row_sh = Ps + WD_R * WD_LD;  // [32] lse, then [32] delta

  const int nc = wd_chunks(D);
  const int chunk = blockIdx.x % nc;
  const int q0 = (gridDim.x / nc - 1 - blockIdx.x / nc) * WD_R;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int r0 = wd_row(tid);
  const int cc = wd_col(tid);

  const size_t q_stride = (size_t)H * D;
  const size_t kv_stride = (size_t)KV * D;
  const size_t head = (((size_t)b * S + q0) * H + h) * D;
  const T* kb = k + ((size_t)b * T_len * KV + kvh) * D;
  const T* vb = v + ((size_t)b * T_len * KV + kvh) * D;

  // delta over all of D: 4 lanes a row, 8 columns a load
  {
    const int r = tid >> 2;
    const int row = q0 + r;
    float a = 0.f;
    if (row < S) {
      const T* orow = o + head + (size_t)r * q_stride;
      const T* grow = g + head + (size_t)r * q_stride;
      for (int d = (tid & 3) * 8; d < D; d += 32) {
        float x[8], y[8];
        wd_load8(orow + d, x);
        wd_load8(grow + d, y);
#pragma unroll
        for (int e = 0; e < 8; ++e) a = fmaf(x[e], y[e], a);
      }
    }
    a += __shfl_xor_sync(0xffffffffu, a, 1);
    a += __shfl_xor_sync(0xffffffffu, a, 2);
    if ((tid & 3) == 0) {
      const size_t li = ((size_t)b * H + h) * S + row;
      row_sh[r] = row < S ? lse[li] : 0.f;
      row_sh[WD_R + r] = a;
      if (chunk == 0 && row < S) delta[li] = a;
    }
  }

  int kt_lo = 0;
  int kt_hi = (T_len + WD_C - 1) / WD_C;
  if (CAUSAL) {
    kt_hi = min(kt_hi, (q0 + WD_R - 1) / WD_C + 1);
    if (window > 0) kt_lo = max(0, q0 - window + 1) / WD_C;
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * WD_C;
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int t = 0; t < nc; ++t) {
      const int c0 = ((chunk + 1 + t) % nc) * WD_DC;
      __syncthreads();  // the previous chunk (and tile's dS) is not read
      wd_load<WD_R>(Qs, WD_LD, q + head, q_stride, S - q0, c0, D);
      wd_load<WD_R>(Gs, WD_LD, g + head, q_stride, S - q0, c0, D);
      wd_load<WD_C>(Ks, WD_LD, kb + (size_t)k0 * kv_stride, kv_stride,
                    T_len - k0, c0, D);
      wd_load<WD_C>(Vs, WD_LD, vb + (size_t)k0 * kv_stride, kv_stride,
                    T_len - k0, c0, D);
      __syncthreads();
      wd_dot(s, Qs, Ks);
      wd_dot(dp, Gs, Vs);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + r0 + i;
      const float m = row_sh[r0 + i];
      const float dl = row_sh[WD_R + r0 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = visible<CAUSAL>(row, k0 + cc + 16 * j, S, T_len,
                                        window)
                            ? expf(s[i][j] * scale - m) : 0.f;
        Ps[(r0 + i) * WD_LD + cc + 16 * j] = p * (dp[i][j] - dl) * scale;
      }
    }
    __syncthreads();  // dS complete
    wd_update(acc, Ps, Ks, WD_LD);  // dq += dS k, the block's columns
  }

  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  wd_store(dq + head, q_stride, S - q0, chunk * WD_DC, D, acc, one);
}

// K4 at a head dim D above 256, both dtypes: one block per (32 keys,
// 64-column chunk of dk and dv, kv head, batch). For every query head of
// the kv head (the GQA groups summed in the block, no atomics) and every
// query tile of 64 rows that sees the block's keys: S^T = k q^T and dP^T =
// v dO^T over every column chunk, P^T from the LSE, dS^T = P^T (dP^T -
// delta) scale, then dv += P^T dO and dk += dS^T q on the block's own 64
// columns (its chunk is the last one staged).
template <typename T, bool CAUSAL>
__global__ void __launch_bounds__(WD_NT) flash_bwd_dkdv_wide_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int S, int T_len, int H, int KV,
    int D, int window, float scale) {
  extern __shared__ __align__(16) float wsm[];
  float* Ks = wsm;                 // [32, WD_LD] a column chunk of k
  float* Vs = Ks + WD_R * WD_LD;   // [32, WD_LD] of v
  float* Qs = Vs + WD_R * WD_LD;   // [64, WD_LD] of q
  float* Gs = Qs + WD_C * WD_LD;   // [64, WD_LD] of dO
  float* Ps = Gs + WD_C * WD_LD;   // [32, WD_LD] P^T
  float* Ds = Ps + WD_R * WD_LD;   // [32, WD_LD] dS^T
  float* lse_sh = Ds + WD_R * WD_LD;  // [64]
  float* dl_sh = lse_sh + WD_C;       // [64]

  const int nc = wd_chunks(D);
  const int chunk = blockIdx.x % nc;
  const int k0 = (blockIdx.x / nc) * WD_R;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int groups = H / KV;
  const int tid = threadIdx.x;
  const int r0 = wd_row(tid);
  const int cc = wd_col(tid);

  const size_t q_stride = (size_t)H * D;
  const size_t kv_stride = (size_t)KV * D;
  const size_t kv_off = (((size_t)b * T_len + k0) * KV + kvh) * D;

  int qt_lo = 0;
  int qt_hi = (S + WD_C - 1) / WD_C;
  if (CAUSAL) {
    qt_lo = k0 / WD_C;
    if (window > 0)
      qt_hi = min(qt_hi, (k0 + WD_R - 1 + window - 1) / WD_C + 1);
  }
  float dka[4][4], dva[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int gi = 0; gi < groups; ++gi) {
    const int hh = kvh * groups + gi;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * WD_C;
      const size_t off = (((size_t)b * S + q0) * H + hh) * D;
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
      for (int t = 0; t < nc; ++t) {
        const int c0 = ((chunk + 1 + t) % nc) * WD_DC;
        __syncthreads();  // the previous chunk (and tile's P, dS) is not read
        wd_load<WD_R>(Ks, WD_LD, k + kv_off, kv_stride, T_len - k0, c0, D);
        wd_load<WD_R>(Vs, WD_LD, v + kv_off, kv_stride, T_len - k0, c0, D);
        wd_load<WD_C>(Qs, WD_LD, q + off, q_stride, S - q0, c0, D);
        wd_load<WD_C>(Gs, WD_LD, g + off, q_stride, S - q0, c0, D);
        if (t == 0 && tid < WD_C) {
          const int row = q0 + tid;
          const size_t li = ((size_t)b * H + hh) * S + row;
          lse_sh[tid] = row < S ? lse[li] : 0.f;
          dl_sh[tid] = row < S ? delta[li] : 0.f;
        }
        __syncthreads();
        wd_dot(s, Ks, Qs);
        wd_dot(dp, Vs, Gs);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + r0 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = cc + 16 * j;
          const float p = visible<CAUSAL>(q0 + c, key, S, T_len, window)
                              ? expf(s[i][j] * scale - lse_sh[c]) : 0.f;
          Ps[(r0 + i) * WD_LD + c] = p;
          Ds[(r0 + i) * WD_LD + c] = p * (dp[i][j] - dl_sh[c]) * scale;
        }
      }
      __syncthreads();  // P^T and dS^T complete
      wd_update(dva, Ps, Gs, WD_LD);  // dv += P^T dO
      wd_update(dka, Ds, Qs, WD_LD);  // dk += dS^T q
    }
  }

  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  wd_store(dk + kv_off, kv_stride, T_len - k0, chunk * WD_DC, D, dka, one);
  wd_store(dv + kv_off, kv_stride, T_len - k0, chunk * WD_DC, D, dva, one);
}

// the grid's x extent of a wide launch over `rows` rows (queries in K3,
// keys in K4); 0 where it exceeds the grid's limit
inline unsigned wide_grid_x(int rows, int D) {
  const long long n = (long long)((rows + WD_R - 1) / WD_R) * wd_chunks(D);
  return n > 0x7fffffffLL ? 0u : static_cast<unsigned>(n);
}

template <typename T>
int launch_dq_wide(int causal, int window, const void* q, const void* k,
                   const void* v, const void* o, const void* g,
                   const void* lse, void* dq, void* delta, int B, int S,
                   int T_len, int H, int KV, int D, float scale,
                   cudaStream_t st) {
  const unsigned nx = wide_grid_x(S, D);
  if (D % WD_MULTIPLE != 0 || nx == 0 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * ((size_t)(3 * WD_R + 2 * WD_C) * WD_LD + 2 * WD_R);
  auto kernel = causal ? flash_bwd_dq_wide_kernel<T, true>
                       : flash_bwd_dq_wide_kernel<T, false>;
  cudaError_t err = rt_set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(nx, H, B), WD_NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(g), static_cast<const float*>(lse),
      static_cast<T*>(dq), static_cast<float*>(delta), S, T_len, H, KV, D,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dkdv_wide(int causal, int window, const void* q, const void* k,
                     const void* v, const void* g, const void* lse,
                     const void* delta, void* dk, void* dv, int B, int S,
                     int T_len, int H, int KV, int D, float scale,
                     cudaStream_t st) {
  const unsigned nx = wide_grid_x(T_len, D);
  if (D % WD_MULTIPLE != 0 || nx == 0 || KV > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * ((size_t)(4 * WD_R + 2 * WD_C) * WD_LD + 2 * WD_C);
  auto kernel = causal ? flash_bwd_dkdv_wide_kernel<T, true>
                       : flash_bwd_dkdv_wide_kernel<T, false>;
  cudaError_t err = rt_set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(nx, KV, B), WD_NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), S, T_len, H, KV, D, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------------- launch ---

template <int D>
int launch_dq(int dtype, int causal, int window, const void* q, const void* k,
              const void* v, const void* o, const void* g, const void* lse,
              void* dq, void* delta, int B, int S, int T_len, int H, int KV,
              float scale, cudaStream_t st) {
  if (dtype == RT_BF16) {
    // head dims 16 and 32 run only the small-head kernel, the others only
    // the TMA/wgmma one
    if constexpr (D == 16 || D == 32)
      return launch_dq_small<D>(causal, window, q, k, v, o, g, lse, dq,
                                delta, B, S, T_len, H, KV, scale, st);
    else
      return launch_dq_wgmma<D>(causal, window, q, k, v, o, g, lse, dq,
                                delta, B, S, T_len, H, KV, scale, st);
  }
  if (dtype == RT_F32) {
    const size_t smem = F32Bwd<D>::kBytes;
    auto kernel = causal ? flash_bwd_dq_f32_kernel<D, true>
                         : flash_bwd_dq_f32_kernel<D, false>;
    cudaError_t err = rt_set_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    constexpr int R = F32Bwd<D>::R;
    kernel<<<dim3((S + R - 1) / R, H, B), NT, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(o),
        static_cast<const float*>(g), static_cast<const float*>(lse),
        static_cast<float*>(dq), static_cast<float*>(delta), S, T_len, H, KV,
        window, scale);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch_dkdv(int dtype, int causal, int window, const void* q,
                const void* k, const void* v, const void* g, const void* lse,
                const void* delta, void* dk, void* dv, int B, int S,
                int T_len, int H, int KV, float scale, cudaStream_t st) {
  if (dtype == RT_BF16) {
    // as in launch_dq
    if constexpr (D == 16 || D == 32)
      return launch_dkdv_small<D>(causal, window, q, k, v, g, lse, delta,
                                  dk, dv, B, S, T_len, H, KV, scale, st);
    else
      return launch_dkdv_wgmma<D>(causal, window, q, k, v, g, lse, delta,
                                  dk, dv, B, S, T_len, H, KV, scale, st);
  }
  if (dtype == RT_F32) {
    const size_t smem = F32Bwd<D>::kBytes;
    auto kernel = causal ? flash_bwd_dkdv_f32_kernel<D, true>
                         : flash_bwd_dkdv_f32_kernel<D, false>;
    cudaError_t err = rt_set_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    constexpr int R = F32Bwd<D>::R;
    kernel<<<dim3((T_len + R - 1) / R, KV, B), NT, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(g),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dk), static_cast<float*>(dv), S, T_len, H, KV,
        window, scale);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

bool bad_args(int causal, int window, int H, int KV, int T_len) {
  return KV <= 0 || H % KV != 0 || T_len <= 0 || window < 0 ||
         (window > 0 && !causal);
}

}  // namespace

// K3: dq [B, S, H, D] in the input type, and delta = rowsum(o * g) f32
// [B, H, S] for K4. window 0: no window; window > 0 needs causal.
extern "C" int flash_attention_bwd_dq(
    int dtype, int causal, int window, const void* q, const void* k,
    const void* v, const void* o, const void* g, const void* lse, void* dq,
    void* delta, int B, int S, int T_len, int H, int KV, int D, float scale,
    void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (bad_args(causal, window, H, KV, T_len))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dq<16>(dtype, causal, window, q, k, v, o, g, lse, dq, delta, B, S, T_len, H, KV, scale, st);
    case 32: return launch_dq<32>(dtype, causal, window, q, k, v, o, g, lse, dq, delta, B, S, T_len, H, KV, scale, st);
    case 64: return launch_dq<64>(dtype, causal, window, q, k, v, o, g, lse, dq, delta, B, S, T_len, H, KV, scale, st);
    case 80: return launch_dq<80>(dtype, causal, window, q, k, v, o, g, lse, dq, delta, B, S, T_len, H, KV, scale, st);
    case 96: return launch_dq<96>(dtype, causal, window, q, k, v, o, g, lse, dq, delta, B, S, T_len, H, KV, scale, st);
    case 128: return launch_dq<128>(dtype, causal, window, q, k, v, o, g, lse, dq, delta, B, S, T_len, H, KV, scale, st);
    case 256: return launch_dq<256>(dtype, causal, window, q, k, v, o, g, lse, dq, delta, B, S, T_len, H, KV, scale, st);
  }
  if (D <= 256) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == RT_BF16)
    return launch_dq_wide<bf16>(causal, window, q, k, v, o, g, lse, dq,
                                delta, B, S, T_len, H, KV, D, scale, st);
  if (dtype == RT_F32)
    return launch_dq_wide<float>(causal, window, q, k, v, o, g, lse, dq,
                                 delta, B, S, T_len, H, KV, D, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The cluster size (blocks) bf16 K3 (dkdv 0) or K4 (dkdv 1) launch with at
// kernel head dims 16 and 32 for a shape, as their launchers pick it.
extern "C" int flash_attention_bwd_small_splits(int dkdv, int causal,
                                                int window, int B, int S,
                                                int T_len, int H, int KV) {
  if (B <= 0 || S <= 0 || H <= 0 || bad_args(causal, window, H, KV, T_len))
    return 0;
  return dkdv ? dkdv_small_splits(causal, window, B, S, T_len, H, KV)
              : dq_small_splits(causal, window, B, S, T_len, H);
}

// K4: dk, dv [B, T, KV, D] in the input type, from K3's delta.
extern "C" int flash_attention_bwd_dkdv(
    int dtype, int causal, int window, const void* q, const void* k,
    const void* v, const void* g, const void* lse, const void* delta,
    void* dk, void* dv, int B, int S, int T_len, int H, int KV, int D,
    float scale, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (bad_args(causal, window, H, KV, T_len))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dkdv<16>(dtype, causal, window, q, k, v, g, lse, delta, dk, dv, B, S, T_len, H, KV, scale, st);
    case 32: return launch_dkdv<32>(dtype, causal, window, q, k, v, g, lse, delta, dk, dv, B, S, T_len, H, KV, scale, st);
    case 64: return launch_dkdv<64>(dtype, causal, window, q, k, v, g, lse, delta, dk, dv, B, S, T_len, H, KV, scale, st);
    case 80: return launch_dkdv<80>(dtype, causal, window, q, k, v, g, lse, delta, dk, dv, B, S, T_len, H, KV, scale, st);
    case 96: return launch_dkdv<96>(dtype, causal, window, q, k, v, g, lse, delta, dk, dv, B, S, T_len, H, KV, scale, st);
    case 128: return launch_dkdv<128>(dtype, causal, window, q, k, v, g, lse, delta, dk, dv, B, S, T_len, H, KV, scale, st);
    case 256: return launch_dkdv<256>(dtype, causal, window, q, k, v, g, lse, delta, dk, dv, B, S, T_len, H, KV, scale, st);
  }
  if (D <= 256) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == RT_BF16)
    return launch_dkdv_wide<bf16>(causal, window, q, k, v, g, lse, delta,
                                  dk, dv, B, S, T_len, H, KV, D, scale, st);
  if (dtype == RT_F32)
    return launch_dkdv_wide<float>(causal, window, q, k, v, g, lse, delta,
                                   dk, dv, B, S, T_len, H, KV, D, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
