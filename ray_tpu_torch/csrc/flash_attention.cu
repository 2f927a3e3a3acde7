// K1 and K2: flash attention forward (causal, full, or causal with a
// sliding window), for Hopper (sm_90a).
//
// Replaces ray_tpu/ops/flash_attention.py:_fwd_kernel_loop (K1, reached
// through _flash_fwd_loop) and _fwd_kernel_stream (K2, the sliding window,
// reached through _flash_fwd with window > 0): out = softmax(q k^T /
// sqrt(D)) v per query head, with the natural-log log-sum-exp of each row,
// q [B, S, H, D], k/v [B, T, KV, D], GQA through kv_head = h / (H / KV) with
// no K/V broadcast. Causal attention is aligned at position 0 (key t is
// visible to query s iff t <= s, also when T > S). Under a window W (causal
// only) also s - t < W; a query tile then starts at the K/V tile holding
// key q0 - W + 1, so tiles below the band are never loaded and the cost is
// O(S * W), which is what K2's clamped index map buys on the TPU. K2 is the
// WINDOW instantiation of the same kernels.
//
// Bound on this card: causal attention does 2 * S^2 * D flops a head against
// 8 * S * D bytes of bf16 q/k/v/o, ~S/4 flops a byte, so prefill buckets up
// to ~1200 tokens are bound by bytes and longer ones by tensor-core
// operations. Either way the S x T scores must never reach device memory,
// and only wgmma reaches the tensor cores' full rate.
//
// Four kernels, chosen explicitly by dtype and head dim in launch_d (head
// dims 16, 32, 64, 80, 96, 128 and 256 are compiled; other head dims <=
// 256 are zero-padded to the next compiled one by the wrapper,
// ops/flash_attention.py) and, above 256, the wide kernel at any head dim
// that is a multiple of 8 (the wrapper zero-pads the rest):
//
// bf16, head dims 64, 80, 96, 128 and 256 (every card preset; H2O-Danube's
// and Phi-2's 80, Phi-3-mini's 96, Gemma-2B's 256), flash_fwd_wgmma_kernel:
// persistent, one block of 3 warpgroups an SM, each walking its share of
// the work tiles: 128 query rows of one (batch, head), against K/V tiles
// of 128 rows (64 at head dim 256), up to the diagonal when causal, from
// the band's first tile under a window (tiles above or below are never
// loaded). Work tiles go heaviest first inside groups of (batch, head)
// pairs whose K/V fit in L2, in a snake order over the blocks. Tiles are
// TMA boxes of 64 columns with the 128-byte swizzle, at head dim 96 three
// boxes of 32 columns with the 64-byte swizzle, at 80 five boxes of 16
// columns with the 32-byte swizzle (TileCols, hopper.cuh), which also give
// the k-step offsets, the descriptors and the epilogue's swizzled
// addresses. Warpgroup 0 is the producer: after setmaxnreg.dec one thread
// issues TMA loads (4-D tensor maps over (D, heads, seq, batch), so a box
// past S or T is zero-filled inside its own batch) of each tile's Q and of
// K/V into rings (FwdSmem), with "full" mbarriers (complete_tx byte
// counts) and "empty" ones the consumers arrive on (K and V apart, and Q,
// so the next tile's Q loads while this one ends). Warpgroups 1-2 are
// consumers (setmaxnreg.inc), 64 query rows each: S = Q K^T by wgmma
// m64n128k16 (or m64n64k16 on 64-key tiles) with both operands in shared
// memory, the online softmax in registers (one FMA and one ex2 an element
// in log2 units; the LSE written is natural-log), then O += P V by wgmma
// m64nDk16 with P from registers, rounded to bf16 as the TPU kernel rounds
// it, and V as an MN-major shared operand. The accumulators' rows are those
// of mma.sync (g and g+8 of each warp's 16), so a row's max and sum combine
// over its 4 lanes by shuffles. Only tiles that cross the diagonal, the
// band's lower edge or the ragged end are masked (waiting for and freeing
// a 64-key tile that no row of a consumer sees, instead of computing its
// p = 0, measured no faster and cost the 128-key kernels 6-10%). The
// epilogue writes O / l through stmatrix into an O buffer and stores it
// with TMA (rows past S are clipped) while the next tile starts; rows < S
// also get their LSE. At head dim 256 O is 128 f32 a consumer thread:
// 64-key tiles keep the scores at 32 (with 128 keys, scores and P beside O
// would not fit 232 registers), and Q and O's buffer (64 KB each) leave
// room for two K stages and one V stage (224 KB); O stored from registers,
// which would free 64 KB for a second V stage, took 14-35% longer
// (PERF.md). The consumers' CUDA-core work (the softmax), not the tensor
// cores, sets its pace at the 7b shape.
//
// bf16, head dims 16 and 32 (the tiny presets' 16; every D of 1-32),
// flash_fwd_small_kernel. At D <= 32 the products are nearly free while
// every score still costs an exponential, and at the tiny presets' shape
// (B 8, H 4, S 1024) the grid is about one wave, so the kernel takes as
// long as its heaviest block's serial chain. So it is built from the
// small-head backward's parts (small_head.cuh): a block of 160 threads
// owns 64 query rows of one (batch, head), the heaviest tiles of every
// head first; a fifth warp's lane 0 loads the block's q once and the
// band's K and V in 128-key stages by TMA into a 3-stage ring with full
// and empty mbarriers, with no block-wide barrier in the walk (a whole row
// is one box: 32 bytes with the 32-byte swizzle at 16, 64 with the
// 64-byte one at 32, so ldmatrix reads are conflict-free; rows past T are
// zero-filled inside their batch; no stage above the tile's diagonal or
// below its window is loaded). Each consumer warp keeps its 16 q rows as
// mma.sync A fragments in registers for the whole walk and takes a stage
// in two halves of 64 keys: S = q k^T by mma.sync.m16n8k16, the online
// softmax in registers (a row's max and sum combine over its 4 lanes by
// shuffles; p = ex2.approx of one FMA with scale log2(e) folded in), then
// O += P V with P's accumulators rounded to bf16 and repacked as A
// fragments, V read by ldmatrix.trans. Only halves that cross the
// diagonal, the window's lower edge or T are masked, on a code path of
// their own; a warp skips halves its rows do not see and frees stages
// alone. O / l is stored in bf16 from registers for rows < S, with the
// natural-log LSE.
//
// f32 (parity runs), flash_fwd_f32_kernel: exact f32 FMAs on the CUDA cores
// through shared-memory tiles, so the f32 path agrees with the plain
// version to rounding; 32-row query tiles at head dim 256, whose 64-row
// tiles would not fit shared memory.
//
// Head dims above 256 (DeepSeek-V4-Flash's 512), both dtypes,
// flash_fwd_wide_kernel: the head dim is a run-time argument and the
// block owns one 64-column chunk of the output, so no tile grows with it
// (wide_head.cuh). Its scores are recomputed once a column chunk, on the
// CUDA cores: right first, far from the bound; a TMA/wgmma design is later
// work.
//
// The ragged edge (S or T not a multiple of the tile) is masked: rows past
// T read as zeros and are scored -1e30, rows past S are not stored. A row
// whose keys in a tile are all masked (the band's first tile under a
// window) gets p = 0 there: the exponent is taken against 0 while the
// row's running max is still that of a masked score.

#include <climits>
#include <cstdint>
#include <numeric>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "small_head.cuh"
#include "wide_head.cuh"

namespace {

constexpr int BK = 64;   // key rows a tile (f32 kernels)
constexpr int NT = 128;  // 4 warps (f32 kernels)

// ------------------------------------------------- bf16, TMA + wgmma ---

constexpr int WG_BQ = 128;     // query rows a work tile: 64 per consumer group
constexpr int WG_NT = 384;     // producer group + 2 consumer groups
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// A head dim's tiles in shared memory: Q (128 rows), the epilogue's O
// buffer, and rings of K and V tiles of BK rows, each tile NB boxes of
// TileCols' columns. At head dim 256 O is 128 f32 a consumer thread, so
// the scores take 64-key tiles (32 f32 a thread; 128 keys would leave no
// room within the consumers' registers), and Q and O (64 KB each) leave
// room for two K stages and one V stage: V is read last in a tile, and O
// stored from registers instead took 14-35% longer (PERF.md). At head dim
// 80 a 128-row tile is five 16-column boxes of 4 KB, and the K and V rings
// take 3 stages (Q, O and the rings: 160 KB), which ran Danube's shape
// 0.1502-0.1510 ms against 0.1493-0.1574 with 2 (PERF.md).
template <int D>
struct FwdSmem {
  using C = TileCols<D>;
  static constexpr int BK = D == 256 ? 64 : 128;  // key rows a K/V tile
  static constexpr int KST = D == 80 ? 3 : 2;     // K ring depth
  static constexpr int VST = D == 256 ? 1 : KST;  // V ring depth
  static constexpr int BOX_Q = WG_BQ * C::RB;  // a box of Q or O
  static constexpr int TILE_Q = BOX_Q * C::NB;
  static constexpr int BOX_K = BK * C::RB;  // a box of K or V
  static constexpr int TILE_K = BOX_K * C::NB;
  static constexpr int Q = 0;
  static constexpr int O = TILE_Q;
  static constexpr int K = O + TILE_Q;
  static constexpr int V = K + KST * TILE_K;
  static constexpr int BAR = V + VST * TILE_K;
  // q_full, q_empty, then k_full and k_empty (one each a K stage), v_full
  // and v_empty (one each a V stage); + 1024 to align the tiles
  static constexpr size_t kBytes = BAR + 8 * (2 + 2 * KST + 2 * VST) + 1024;
  static_assert(kBytes <= 232448, "a block's shared memory");
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = 232;
};

// The work tiles (128 query rows of one batch and head) in the order the
// blocks take them. (Batch, head) pairs go in groups of `hbg` whose K/V
// fit in L2 together (a group's query tiles share them, so the K/V are
// read from device memory about once); inside a group the causal tiles
// near the end, which do the most work, go first, then the pairs. Block c
// takes tile r * G + c in even rounds r and r * G + G-1-c in odd ones (G
// blocks), so each block's sum of work evens out.
struct WorkTiles {
  int n_qt, H, HB, hbg, n;  // query tiles a head, heads, heads x batches,
                            // pairs a group, all tiles
  __device__ int at(int round, int c, int G) const {
    return round * G + ((round & 1) ? G - 1 - c : c);
  }
  __device__ void decode(int w, int& q0, int& h, int& b) const {
    const int group = w / (n_qt * hbg);  // every earlier group is full
    const int g0 = group * hbg;
    const int size = min(hbg, HB - g0);
    const int in = w - g0 * n_qt;
    const int hb = g0 + in % size;
    q0 = (n_qt - 1 - in / size) * WG_BQ;
    h = hb % H;
    b = hb / H;
  }
};

// s = q k^T for a consumer's 64 rows against BK keys, both operands
// K-major in shared memory
template <int D, int BK>
__device__ __forceinline__ void fwd_scores(float (&s)[BK / 2],
                                           uint32_t q_rows, uint32_t kt) {
  using C = TileCols<D>;
  using L = FwdSmem<D>;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint64_t a = C::kmajor(q_rows + C::kstep(ks, L::BOX_Q));
    const uint64_t b = C::kmajor(kt + C::kstep(ks, L::BOX_K));
    if constexpr (BK == 128)
      wgmma_m64n128k16_ss(s, a, b, ks > 0);
    else
      wgmma_m64n64k16_ss(s, a, b, ks > 0);
  }
}

template <int D, bool CAUSAL, bool WINDOW>
__global__ void __launch_bounds__(WG_NT, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_o, float* __restrict__ lse, int B,
    int S, int T_len, int H, int KV, int window, float scale_log2, int hbg) {
  using L = FwdSmem<D>;
  using C = TileCols<D>;
  constexpr int BK = L::BK, KST = L::KST, VST = L::VST;
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  // the swizzle repeats every 1024 (128-byte) or 512 (64-byte) bytes:
  // align the tiles to it
  const uint32_t base = (smem_u32(smem_tiles) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::Q, sO = base + L::O;
  const uint32_t sK = base + L::K, sV = base + L::V;
  const uint32_t q_full = base + L::BAR, q_empty = q_full + 8;
  auto k_full = [&](int st) { return q_full + 8 * (2 + st); };
  auto k_empty = [&](int st) { return q_full + 8 * (2 + KST + st); };
  auto v_full = [&](int st) { return q_full + 8 * (2 + 2 * KST + st); };
  auto v_empty = [&](int st) {
    return q_full + 8 * (2 + 2 * KST + VST + st);
  };

  const int n_qt = (S + WG_BQ - 1) / WG_BQ;
  const WorkTiles work{n_qt, H, H * B, hbg, n_qt * H * B};
  // the K/V tiles a query tile reads: up to the diagonal when causal, from
  // the band's first under a window (tiles above or below are never loaded)
  auto kv_range = [&](int q0, int& kt_lo, int& n_tiles) {
    int n_k = (T_len + BK - 1) / BK;
    kt_lo = 0;
    if (CAUSAL) {
      n_k = min(n_k, (q0 + WG_BQ - 1) / BK + 1);
      if (WINDOW) kt_lo = max(0, q0 - window + 1) / BK;
    }
    n_tiles = max(0, n_k - kt_lo);
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);  // one arrival per consumer warp
    for (int st = 0; st < KST; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(k_empty(st), 8);
    }
    for (int st = 0; st < VST; ++st) {
      mbar_init(v_full(st), 1);
      mbar_init(v_empty(st), 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread walks the block's work tiles and keeps Q
    // and the K/V rings full by TMA, running ahead into the next tile ----
    setmaxnreg_dec<L::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int it = 0;  // K/V tiles loaded so far: the rings' position
      for (int r = 0, n = 0;; ++r, ++n) {
        const int w = work.at(r, blockIdx.x, gridDim.x);
        if (w >= work.n) break;
        int q0, h, b, kt_lo, n_tiles;
        work.decode(w, q0, h, b);
        kv_range(q0, kt_lo, n_tiles);
        const int kvh = h / (H / KV);
        // the consumers are done with the previous tile's Q
        if (n > 0) mbar_wait(q_empty, (n - 1) & 1);
        mbar_expect_tx(q_full, L::TILE_Q);
        for (int c = 0; c < C::NB; ++c)
          tma_load_4d(sQ + c * L::BOX_Q, &tm_q, q_full, c * C::BC, h, q0, b);
        for (int i = 0; i < n_tiles; ++i, ++it) {
          const int sk = it % KST, sv = it % VST;
          const int k0 = (kt_lo + i) * BK;
          const uint32_t kt = sK + sk * L::TILE_K, vt = sV + sv * L::TILE_K;
          // K and V are released apart (K once q k^T is done): wait for
          // the consumers to free this stage's previous tile
          if (it >= KST) mbar_wait(k_empty(sk), ((it / KST) - 1) & 1);
          mbar_expect_tx(k_full(sk), L::TILE_K);
          for (int c = 0; c < C::NB; ++c)
            tma_load_4d(kt + c * L::BOX_K, &tm_k, k_full(sk), c * C::BC, kvh,
                        k0, b);
          if (it >= VST) mbar_wait(v_empty(sv), ((it / VST) - 1) & 1);
          mbar_expect_tx(v_full(sv), L::TILE_K);
          for (int c = 0; c < C::NB; ++c)
            tma_load_4d(vt + c * L::BOX_K, &tm_v, v_full(sv), c * C::BC, kvh,
                        k0, b);
        }
      }
    }
  } else {
    // ---- consumers: group cw owns query rows q0 + 64 cw .. + 63 of each
    // work tile ----
    setmaxnreg_inc<L::CONSUMER_REGS>();
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;  // accumulator rows g and g + 8 of the warp's 16
    const int t4 = lane & 3;  // column pair within an 8-column n-tile
    const uint32_t q_rows = sQ + cw * 64 * C::RB;  // this group's 64 rows
    const uint32_t o_rows = sO + cw * 64 * C::RB;
    auto release = [&](uint32_t bar) {  // this warp is done with a buffer
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    int it = 0;
    for (int r = 0, n = 0;; ++r, ++n) {
      const int w = work.at(r, blockIdx.x, gridDim.x);
      if (w >= work.n) break;
      int q0, h, b, kt_lo, n_tiles;
      work.decode(w, q0, h, b);
      kv_range(q0, kt_lo, n_tiles);
      const int grow = q0 + cw * 64;  // the group's first row
      const int row0 = grow + warp * 16;  // the warp's first row
      const int row_a = row0 + g;
      const int row_b = row_a + 8;

      float o[D / 2];  // f32 output accumulator: d-tile j in o[4j .. 4j+3]
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      float m_a = -1e30f, m_b = -1e30f;  // running max (log2 units)
      float l_a = 0.f, l_b = 0.f;        // this thread's share of row sums

      mbar_wait(q_full, n & 1);
      if (n_tiles == 0) release(q_empty);
      for (int i = 0; i < n_tiles; ++i, ++it) {
        const int sk = it % KST, sv = it % VST;
        const int k0 = (kt_lo + i) * BK;
        const uint32_t kt = sK + sk * L::TILE_K, vt = sV + sv * L::TILE_K;
        // s = q k^T: key n-tile j of rows g (s[4j], s[4j+1]) and g+8 (+2,
        // +3)
        float s[BK / 2];
        mbar_wait(k_full(sk), (it / KST) & 1);
        wgmma_fence();
        fwd_scores<D, BK>(s, q_rows, kt);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        release(k_empty(sk));
        if (i == n_tiles - 1) release(q_empty);

        // mask (only tiles that cross the diagonal, the band's lower edge
        // or the ragged end) the raw scores, then the online-softmax step in
        // log2 units: the max of the raw scores (the scale is positive),
        // then p = exp2(s * scale log2(e) - m) by one FMA
        const bool edge = k0 + BK > T_len ||
                          (CAUSAL && k0 + BK - 1 > row0) ||
                          (WINDOW && row0 + 15 - k0 >= window);
        float mx_a = -1e30f, mx_b = -1e30f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[4 * j + e];
            if (edge) {
              const int col = k0 + j * 8 + t4 * 2 + (e & 1);
              const int row = e < 2 ? row_a : row_b;
              if (col >= T_len ||
                  (CAUSAL && (col > row || (WINDOW && row - col >= window))))
                x = -1e30f;
            }
            s[4 * j + e] = x;
          }
          mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
          mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
          mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
        }
        const float mn_a = fmaxf(m_a, mx_a * scale_log2);
        const float mn_b = fmaxf(m_b, mx_b * scale_log2);
        const float al_a = ex2_approx(m_a - mn_a);
        const float al_b = ex2_approx(m_b - mn_b);
        m_a = mn_a;
        m_b = mn_b;
        // under a window a row may have no visible key yet: exp against 0
        // gives its masked p = 0 (without one, key 0 is in every row's
        // first tile); a masked score becomes -1e30 scale log2(e), and
        // scale log2(e) is below 0.1 from head dim 208 on
        const float masked = -1e29f * scale_log2;
        const float e_a = WINDOW && mn_a <= masked ? 0.f : mn_a;
        const float e_b = WINDOW && mn_b <= masked ? 0.f : mn_b;
        float sum_a = 0.f, sum_b = 0.f;
        // p, rounded to bf16, as the A fragments of p.v: the n-tiles 2kk
        // and 2kk+1 of the scores are exactly the 16-key step kk
        uint32_t pf[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          float p[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            p[e] = ex2_approx(
                fmaf(s[8 * kk + e], scale_log2, (e & 2) ? -e_b : -e_a));
          sum_a += p[0] + p[1] + p[4] + p[5];
          sum_b += p[2] + p[3] + p[6] + p[7];
          pf[kk][0] = pack_bf16(p[0], p[1]);
          pf[kk][1] = pack_bf16(p[2], p[3]);
          pf[kk][2] = pack_bf16(p[4], p[5]);
          pf[kk][3] = pack_bf16(p[6], p[7]);
        }
        l_a = l_a * al_a + sum_a;
        l_b = l_b * al_b + sum_b;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j] *= al_a;
          o[4 * j + 1] *= al_a;
          o[4 * j + 2] *= al_b;
          o[4 * j + 3] *= al_b;
        }

        // o += p v: V is MN-major (d contiguous), so a 16-key step is 16
        // rows of V and its boxes are LBO apart
        mbar_wait(v_full(sv), (it / VST) & 1);
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs_tb<D>(o, pf[kk],
                         C::mnmajor(vt + kk * 16 * C::RB, L::BOX_K));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        release(v_empty(sv));
      }

      // epilogue: o / l in bf16 into this group's rows of O's buffer (the
      // TMA box layout), then one TMA store, which clips rows past S; it
      // runs on while the next tile starts
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
        l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
      }
      const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
      const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
      if (tid == 0) tma_store_wait_read();  // the last store has read O
      named_bar_sync(1 + cw, 128);
      {
        const int mi = lane >> 3;  // the matrix whose row this lane addresses
        const int rr = warp * 16 + (mi & 1) * 8 + (lane & 7);
#pragma unroll
        for (int j = 0; j < D / 8; j += 2) {
          const int col = (j + (mi >> 1)) * 8;
          stmatrix_x4(o_rows + C::chunk(rr, col, L::BOX_Q),
                      pack_bf16(o[4 * j] * inv_a, o[4 * j + 1] * inv_a),
                      pack_bf16(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b),
                      pack_bf16(o[4 * j + 4] * inv_a, o[4 * j + 5] * inv_a),
                      pack_bf16(o[4 * j + 6] * inv_b, o[4 * j + 7] * inv_b));
        }
      }
      fence_proxy_async();
      named_bar_sync(1 + cw, 128);
      if (tid == 0) {
        for (int c = 0; c < C::NB; ++c)
          tma_store_4d(&tm_o, o_rows + c * L::BOX_Q, c * C::BC, h, grow, b);
        tma_store_commit();
      }
      if (t4 == 0) {
        float* lrow = lse + ((size_t)b * H + h) * S;
        if (row_a < S) lrow[row_a] = m_a * LN2 + logf(fmaxf(l_a, 1e-30f));
        if (row_b < S) lrow[row_b] = m_b * LN2 + logf(fmaxf(l_b, 1e-30f));
      }
    }
    if (tid == 0) tma_store_wait_read();  // O's buffer outlives the store
  }
}

template <int D>
int launch_wgmma(int causal, int window, const void* q, const void* k,
                 const void* v, void* o, void* lse, int B, int S, int T_len,
                 int H, int KV, float scale, cudaStream_t st) {
  using L = FwdSmem<D>;
  constexpr int BC = TileCols<D>::BC;
  CUtensorMap mq, mk, mv, mo;
  int rc = rt_bshd_map(&mq, q, B, S, H, D, WG_BQ, BC);
  if (rc == 0) rc = rt_bshd_map(&mk, k, B, T_len, KV, D, L::BK, BC);
  if (rc == 0) rc = rt_bshd_map(&mv, v, B, T_len, KV, D, L::BK, BC);
  if (rc == 0) rc = rt_bshd_map(&mo, o, B, S, H, D, 64, BC);
  if (rc != 0) return rc;
  const size_t smem = L::kBytes;
  auto kernel = window > 0 ? flash_fwd_wgmma_kernel<D, true, true>
                : causal   ? flash_fwd_wgmma_kernel<D, true, false>
                           : flash_fwd_wgmma_kernel<D, false, false>;
  cudaError_t err = rt_set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent: one block an SM, each walking its share of the work tiles
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (S + WG_BQ - 1) / WG_BQ;
  const long long tiles = (long long)n_qt * H * B;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  // (batch, head) pairs a group: K/V of at most 32 MB of the 50 MB L2,
  // rounded down to a multiple of m so that a group's tiles fill whole
  // rounds of the grid (the snake order then balances inside each group)
  const long long kv_bytes = 4ll * T_len * D;  // one kv head's K and V
  const long long kv_heads = (32ll << 20) / kv_bytes;
  const long long want = (kv_heads > 0 ? kv_heads : 1) * (H / KV);
  const long long m = grid / std::gcd(grid, n_qt);
  long long hbg = want / m * m;
  if (hbg < m) hbg = m;
  if (hbg > (long long)H * B) hbg = (long long)H * B;
  kernel<<<grid, WG_NT, smem, st>>>(mq, mk, mv, mo, static_cast<float*>(lse),
                                    B, S, T_len, H, KV, window, scale * LOG2E,
                                    static_cast<int>(hbg));
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------- bf16, head dims 16 and 32 ---

// Shared memory of flash_fwd_small_kernel, from a 1024-byte aligned base:
// the block's 64 q rows, the ring (a K and a V chunk of 128 rows a stage),
// the mbarriers
template <int D>
struct FwdSmallSmem {
  static constexpr int RB = 2 * D;             // bytes a row
  static constexpr int OWN = SM_ROWS * RB;     // q: 64 rows
  static constexpr int CHUNK = SM_CHUNK * RB;  // K or V: 128 rows
  static constexpr int STAGE = 2 * CHUNK;
  static constexpr int RING = OWN;
  static constexpr int BAR = RING + SM_STAGES * STAGE;
  // q_full, then full and empty (one each a stage); + 1024 to align
  static constexpr size_t kBytes = BAR + 8 * (1 + 2 * SM_STAGES) + 1024;
  static_assert(OWN % 1024 == 0 && STAGE % 1024 == 0, "swizzle atoms");
};

// Block (x, y) owns the 64-row query tile gridDim.y - 1 - y of (batch,
// head) x, so the heaviest causal tiles of every head go first. Warp 4's
// lane 0 loads q once and the band's 128-key chunks of K and V into the
// ring by TMA; warps 0-3 own 16 query rows each.
template <int D, bool CAUSAL, bool WINDOW>
__global__ void __launch_bounds__(SM_NT) flash_fwd_small_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int S, int T_len, int H, int KV, int window,
    float scale_log2) {
  using L = FwdSmallSmem<D>;
  constexpr int ST = SM_STAGES;
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  const uint32_t base = (smem_u32(smem_tiles) + 1023u) & ~1023u;
  const uint32_t sQ = base, ring = base + L::RING;
  const uint32_t q_full = base + L::BAR;
  auto full = [&](int st) { return q_full + 8 * (1 + st); };
  auto empty = [&](int st) { return q_full + 8 * (1 + ST + st); };

  const int q0 = (gridDim.y - 1 - blockIdx.y) * SM_ROWS;
  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  int c_lo, c_hi;
  dq_small_band(q0, T_len, CAUSAL, WINDOW ? window : 0, c_lo, c_hi);
  const int n_st = c_hi - c_lo;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
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
      mbar_expect_tx(q_full, L::OWN);
      tma_load_4d(sQ, &tm_q, q_full, 0, h, q0, b);
      for (int i = 0; i < n_st; ++i) {
        const int st = i % ST;
        const int k0 = (c_lo + i) * SM_CHUNK;
        const uint32_t kt = ring + st * L::STAGE;
        if (i >= ST) mbar_wait(empty(st), ((i / ST) - 1) & 1);
        mbar_expect_tx(full(st), L::STAGE);
        tma_load_4d(kt, &tm_k, full(st), 0, kvh, k0, b);
        tma_load_4d(kt + L::CHUNK, &tm_v, full(st), 0, kvh, k0, b);
      }
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
  const float z4[4] = {0.f, 0.f, 0.f, 0.f};
  auto zero = [&](int) -> const float(&)[4] { return z4; };

  uint32_t qf[D / 16][4];
  mbar_wait(q_full, 0);
  load_rows_a<D>(qf, sQ, warp * 16, lane);

  float acc[D / 8][4];  // f32 out: rows g8 (acc[n][0..1]) and g8 + 8
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_a = -1e30f, m_b = -1e30f;  // running max (log2 units)
  float l_a = 0.f, l_b = 0.f;        // this thread's share of the row sums
  // under a window a row may have no visible key yet: its running max is
  // then that of a masked score (-1e30 scale log2(e)), and its p are taken
  // against 0 (without one, key 0 is in every row's first half stage)
  const float masked = -1e29f * scale_log2;

  const bool live = row0 < S;
  for (int i = 0; i < n_st; ++i) {
    const int st = i % ST;
    const int kc = (c_lo + i) * SM_CHUNK;
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
      // s = q k^T: keys k0 + 8n + 2 t4 + {0, 1} of rows g8 (s[n][0..1])
      // and g8 + 8 (s[n][2..3])
      float s[8][4];
      mma_rows<D>(s, qf, kt, sub * 64, lane, zero);
      // the online-softmax step in log2 units: the max of the raw scores
      // (the scale is positive), then p = exp2(s scale log2(e) - m) by one
      // FMA; only keys that cross T, the diagonal or the window's edge are
      // masked, on their own code path
      const bool edge = k0 + 64 > T_len || (CAUSAL && k0 + 63 > row0) ||
                        (WINDOW && row0 + 15 - k0 >= window);
      auto step = [&](auto masking) {
        if constexpr (decltype(masking)::value) {
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = k0 + n * 8 + t4 * 2 + (e & 1);
              const int row = e < 2 ? row_a : row_b;
              if (col >= T_len ||
                  (CAUSAL && (col > row || (WINDOW && row - col >= window))))
                s[n][e] = -1e30f;
            }
        }
        float mx_a = -1e30f, mx_b = -1e30f;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
          mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
          mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
        }
        const float mn_a = fmaxf(m_a, mx_a * scale_log2);
        const float mn_b = fmaxf(m_b, mx_b * scale_log2);
        const float al_a = ex2_approx(m_a - mn_a);
        const float al_b = ex2_approx(m_b - mn_b);
        m_a = mn_a;
        m_b = mn_b;
        const float e_a = WINDOW && mn_a <= masked ? 0.f : mn_a;
        const float e_b = WINDOW && mn_b <= masked ? 0.f : mn_b;
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          s[n][0] = ex2_approx(fmaf(s[n][0], scale_log2, -e_a));
          s[n][1] = ex2_approx(fmaf(s[n][1], scale_log2, -e_a));
          s[n][2] = ex2_approx(fmaf(s[n][2], scale_log2, -e_b));
          s[n][3] = ex2_approx(fmaf(s[n][3], scale_log2, -e_b));
          sum_a += s[n][0] + s[n][1];
          sum_b += s[n][2] + s[n][3];
        }
        l_a = l_a * al_a + sum_a;
        l_b = l_b * al_b + sum_b;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[n][0] *= al_a;
          acc[n][1] *= al_a;
          acc[n][2] *= al_b;
          acc[n][3] *= al_b;
        }
      };
      if (edge)
        step(std::true_type{});
      else
        step(std::false_type{});
      mma_xm_rows<D>(acc, s, vt, sub * 64, lane);  // o += p v, p in bf16
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }

  // epilogue: o / l in bf16 and the natural-log LSE, rows < S
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const size_t head = ((size_t)b * S * H + h) * D;
  float* lrow = lse + ((size_t)b * H + h) * S;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row_b : row_a;
    if (row >= S) continue;
    const float l = fmaxf(half ? l_b : l_a, 1e-30f);
    const float inv = 1.f / l;
    __nv_bfloat16* orow = o + head + (size_t)row * H * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + t4 * 2) =
          __floats2bfloat162_rn(acc[n][2 * half] * inv,
                                acc[n][2 * half + 1] * inv);
    if (t4 == 0) lrow[row] = (half ? m_b : m_a) * LN2 + logf(l);
  }
}

template <int D>
int launch_small(int causal, int window, const void* q, const void* k,
                 const void* v, void* o, void* lse, int B, int S, int T_len,
                 int H, int KV, float scale, cudaStream_t st) {
  const int n_qt = (S + SM_ROWS - 1) / SM_ROWS;
  if (n_qt > 65535 || (long long)H * B > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);  // the grid's limits
  CUtensorMap mq, mk, mv;
  int rc = rt_bshd_map(&mq, q, B, S, H, D, SM_ROWS, D);
  if (rc == 0) rc = rt_bshd_map(&mk, k, B, T_len, KV, D, SM_CHUNK, D);
  if (rc == 0) rc = rt_bshd_map(&mv, v, B, T_len, KV, D, SM_CHUNK, D);
  if (rc != 0) return rc;
  const size_t smem = FwdSmallSmem<D>::kBytes;
  auto kernel = window > 0 ? flash_fwd_small_kernel<D, true, true>
                : causal   ? flash_fwd_small_kernel<D, true, false>
                           : flash_fwd_small_kernel<D, false, false>;
  cudaError_t err = rt_set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(H * B, n_qt), SM_NT, smem, st>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), S,
      T_len, H, KV, window, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------- f32 ---

// query rows a warp of the f32 kernels takes: 8 at head dim 256, where
// 64-row tiles would need 280 KB of shared memory
__host__ __device__ constexpr int f32_rows(int D) {
  return D > 128 ? 8 : 16;
}

template <int D>
struct F32Tile {
  static constexpr int RW = f32_rows(D);
  static constexpr int BQF = 4 * RW;  // query rows a block
  static constexpr int LD = D + 1;   // staggers banks for column-wise reads
  static constexpr int PLD = BK + 1;
  static constexpr int OLD = D;
  static constexpr size_t kBytes =
      sizeof(float) * ((size_t)(BQF + 2 * BK) * LD + (size_t)BQF * PLD +
                       (size_t)BQF * OLD + 3 * BQF);
};

template <int D, bool CAUSAL, bool WINDOW>
__global__ void __launch_bounds__(NT) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int S, int T_len, int H, int KV, int window,
    float scale) {
  using L = F32Tile<D>;
  constexpr int RW = L::RW;    // the warp's query rows
  constexpr int BQF = L::BQF;  // the block's
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [BQF, LD]
  float* Ks = Qs + BQF * L::LD;                // [BK, LD]
  float* Vs = Ks + BK * L::LD;                 // [BK, LD]
  float* Ps = Vs + BK * L::LD;                 // [BQF, PLD] scores, then p
  float* Os = Ps + BQF * L::PLD;               // [BQF, OLD]
  float* m_sh = Os + BQF * L::OLD;             // [BQF]
  float* l_sh = m_sh + BQF;                    // [BQF]
  float* a_sh = l_sh + BQF;                    // [BQF]

  // causal tiles near the end do the most work: schedule them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQF;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0 = warp * RW;

  const size_t q_stride = (size_t)H * D;
  const size_t kv_stride = (size_t)KV * D;
  const float* qb = q + ((size_t)b * S * H + h) * D;
  const float* kb = k + ((size_t)b * T_len * KV + kvh) * D;
  const float* vb = v + ((size_t)b * T_len * KV + kvh) * D;

  auto load = [&](float* dst, const float* src, size_t stride, int valid,
                  int rows) {
    for (int i = tid; i < rows * D; i += NT) {
      const int r = i / D;
      const int c = i - r * D;
      dst[r * L::LD + c] = r < valid ? src[(size_t)r * stride + c] : 0.f;
    }
  };
  load(Qs, qb + (size_t)q0 * q_stride, q_stride, S - q0, BQF);
  for (int i = tid; i < BQF * L::OLD; i += NT) Os[i] = 0.f;
  for (int i = tid; i < BQF; i += NT) {
    m_sh[i] = -1e30f;
    l_sh[i] = 0.f;
  }

  int n_k = (T_len + BK - 1) / BK;
  int kt_lo = 0;
  if (CAUSAL) {
    n_k = min(n_k, (q0 + BQF - 1) / BK + 1);
    if (WINDOW) kt_lo = max(0, q0 - window + 1) / BK;
  }

  for (int kt = kt_lo; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K/V are no longer read
    load(Ks, kb + (size_t)k0 * kv_stride, kv_stride, T_len - k0, BK);
    load(Vs, vb + (size_t)k0 * kv_stride, kv_stride, T_len - k0, BK);
    __syncthreads();

    const float* Qw = Qs + r0 * L::LD;
    float* Pw = Ps + r0 * L::PLD;
    float* Ow = Os + r0 * L::OLD;
    // lane owns key columns lane and lane + 32 of the warp's RW rows
    float s0[RW], s1[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) s0[i] = s1[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float k0v = Ks[lane * L::LD + d];
      const float k1v = Ks[(lane + 32) * L::LD + d];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float qv = Qw[i * L::LD + d];
        s0[i] = fmaf(qv, k0v, s0[i]);
        s1[i] = fmaf(qv, k1v, s1[i]);
      }
    }
    // mask, then the online-softmax step, one row at a time
    for (int i = 0; i < RW; ++i) {
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
    for (int i = 0; i < RW; ++i) {
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

  for (int i = 0; i < RW; ++i) {
    const int qpos = q0 + r0 + i;
    if (qpos >= S) break;
    const float l = fmaxf(l_sh[r0 + i], 1e-30f);
    float* orow = o + (((size_t)b * S + qpos) * H + h) * D;
    for (int d = lane; d < D; d += 32) orow[d] = Os[(r0 + i) * L::OLD + d] / l;
    if (lane == 0) lse[((size_t)b * H + h) * S + qpos] = m_sh[r0 + i] + logf(l);
  }
}

// ------------------------------------------- head dims above 256, wide ---

// K1/K2 at a head dim D above 256 (a multiple of 8, no upper limit), both
// dtypes: one block per (32 query rows, 64-column chunk of the output,
// head, batch). For each K/V tile of 64 keys in the band, the scores sum
// over every column chunk of q and k (wide_head.cuh), then the online
// softmax (in natural-log units; bf16 rounds p before p . V, as the TPU
// kernel and flash_fwd_wgmma_kernel do) and O += P V on the block's own 64
// columns of V. The block of column chunk 0 also stores the LSE. (Without
// the minimum of one block an SM in its launch bounds, ptxas held four of
// the six instances to 72-80 registers and spilled 24-36 bytes.)
template <typename T, bool CAUSAL, bool WINDOW>
__global__ void __launch_bounds__(WD_NT, 1) flash_fwd_wide_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    int S, int T_len, int H, int KV, int D, int window, float scale) {
  extern __shared__ __align__(16) float wsm[];
  float* Qs = wsm;                 // [32, WD_LD] a column chunk of q
  float* Ks = Qs + WD_R * WD_LD;   // [64, WD_LD] and of k
  float* Ps = Ks + WD_C * WD_LD;   // [32, WD_LD] p
  float* Vs = Ps + WD_R * WD_LD;   // [64, WD_DC] the block's columns of v

  const int nc = wd_chunks(D);
  const int chunk = blockIdx.x % nc;
  // causal tiles near the end do the most work: schedule them first
  const int q0 = (gridDim.x / nc - 1 - blockIdx.x / nc) * WD_R;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int r0 = wd_row(threadIdx.x);
  const int cc = wd_col(threadIdx.x);

  const size_t q_stride = (size_t)H * D;
  const size_t kv_stride = (size_t)KV * D;
  const T* qb = q + (((size_t)b * S + q0) * H + h) * D;
  const T* kb = k + ((size_t)b * T_len * KV + kvh) * D;
  const T* vb = v + ((size_t)b * T_len * KV + kvh) * D;

  int n_k = (T_len + WD_C - 1) / WD_C;
  int kt_lo = 0;
  if (CAUSAL) {
    n_k = min(n_k, (q0 + WD_R - 1) / WD_C + 1);
    if (WINDOW) kt_lo = max(0, q0 - window + 1) / WD_C;
  }
  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kt_lo; kt < n_k; ++kt) {
    const int k0 = kt * WD_C;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 1
    for (int t = 0; t < nc; ++t) {
      const int c0 = ((chunk + 1 + t) % nc) * WD_DC;
      __syncthreads();  // the previous chunk (and tile) is no longer read
      wd_load<WD_R>(Qs, WD_LD, qb, q_stride, S - q0, c0, D);
      wd_load<WD_C>(Ks, WD_LD, kb + (size_t)k0 * kv_stride, kv_stride,
                    T_len - k0, c0, D);
      if (t == 0)
        wd_load<WD_C>(Vs, WD_DC, vb + (size_t)k0 * kv_stride, kv_stride,
                      T_len - k0, chunk * WD_DC, D);
      __syncthreads();
      wd_dot(s, Qs, Ks);
    }
    // mask, then the online-softmax step; p to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + r0 + i;
      float x[4];
      float mx = -1e30f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + cc + 16 * j;
        const bool keep = kpos < T_len &&
                          (!CAUSAL || (kpos <= qpos &&
                                       (!WINDOW || qpos - kpos < window)));
        x[j] = keep ? s[i][j] * scale : -1e30f;
        mx = fmaxf(mx, x[j]);
      }
      const float m_new = fmaxf(m[i], wd_row_max(mx));
      // under a window a row may have no visible key yet: p = 0
      const float m_exp = WINDOW && m_new <= -1e29f ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(x[j] - m_exp);
        sum += p;
        Ps[(r0 + i) * WD_LD + cc + 16 * j] = to_f32(from_f32<T>(p));
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + wd_row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // p complete
    wd_update(acc, Ps, Vs, WD_DC);
  }

  // l >= 1 on a row with a visible key (its max contributes exp(0)), where
  // the approximate reciprocal is within 2 ulp
  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) inv[i] = __fdividef(1.f, fmaxf(l[i], 1e-30f));
  wd_store(o + (((size_t)b * S + q0) * H + h) * D, q_stride, S - q0,
           chunk * WD_DC, D, acc, inv);
  if (chunk == 0 && cc == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + r0 + i;
      if (qpos < S)
        lse[((size_t)b * H + h) * S + qpos] =
            m[i] + logf(fmaxf(l[i], 1e-30f));
    }
  }
}

template <typename T>
int launch_wide(int causal, int window, const void* q, const void* k,
                const void* v, void* o, void* lse, int B, int S, int T_len,
                int H, int KV, int D, float scale, cudaStream_t st) {
  if (D % WD_MULTIPLE != 0 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_x =
      (long long)((S + WD_R - 1) / WD_R) * wd_chunks(D);
  if (n_x > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * ((size_t)(2 * WD_R + WD_C) * WD_LD + WD_C * WD_DC);
  auto kernel = window > 0 ? flash_fwd_wide_kernel<T, true, true>
                : causal   ? flash_fwd_wide_kernel<T, true, false>
                           : flash_fwd_wide_kernel<T, false, false>;
  cudaError_t err = rt_set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(static_cast<unsigned>(n_x), H, B), WD_NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      S, T_len, H, KV, D, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------------- launch ---

template <int D>
int launch_d(int dtype, int causal, int window, const void* q,
             const void* k, const void* v, void* o, void* lse, int B, int S,
             int T_len, int H, int KV, float scale, cudaStream_t st) {
  if (dtype == RT_BF16) {
    // head dims 16 and 32 run only the small-head kernel, every other one
    // only the TMA/wgmma kernel
    if constexpr (D == 16 || D == 32)
      return launch_small<D>(causal, window, q, k, v, o, lse, B, S, T_len, H,
                             KV, scale, st);
    else
      return launch_wgmma<D>(causal, window, q, k, v, o, lse, B, S, T_len, H,
                             KV, scale, st);
  }
  if (dtype == RT_F32) {
    const size_t smem = F32Tile<D>::kBytes;
    auto kernel = window > 0 ? flash_fwd_f32_kernel<D, true, true>
                  : causal   ? flash_fwd_f32_kernel<D, true, false>
                             : flash_fwd_f32_kernel<D, false, false>;
    cudaError_t err = rt_set_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((S + F32Tile<D>::BQF - 1) / F32Tile<D>::BQF, H, B);
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
    case 80: return launch_d<80>(dtype, causal, window, q, k, v, o, lse, B, S, T_len, H, KV, scale, st);
    case 96: return launch_d<96>(dtype, causal, window, q, k, v, o, lse, B, S, T_len, H, KV, scale, st);
    case 128: return launch_d<128>(dtype, causal, window, q, k, v, o, lse, B, S, T_len, H, KV, scale, st);
    case 256: return launch_d<256>(dtype, causal, window, q, k, v, o, lse, B, S, T_len, H, KV, scale, st);
  }
  if (D <= 256) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == RT_BF16)
    return launch_wide<__nv_bfloat16>(causal, window, q, k, v, o, lse, B, S,
                                      T_len, H, KV, D, scale, st);
  if (dtype == RT_F32)
    return launch_wide<float>(causal, window, q, k, v, o, lse, B, S, T_len,
                              H, KV, D, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
