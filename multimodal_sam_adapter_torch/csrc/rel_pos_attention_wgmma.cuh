// The bfloat16 core of both attention kernels (K1 windowed, K2 global):
// softmax attention with SAM's decomposed rel-pos bias, on Hopper's wgmma
// tensor-core products fed by TMA, with warp specialisation.
//
// For one (window or image, head) pair and a query q at grid cell (qh, qw):
//
//   out[q] = sum_k softmax_k(scale q.k + q.Th[qh - kh + H - 1]
//                                       + q.Tw[qw - kw + W - 1]) v[k]
//
// with the key k at grid cell (kh, kw) and Th (2H - 1, D), Tw (2W - 1, D)
// the rel-pos tables resized to the grid (get_rel_pos's rows, ungathered).
// The bias uses the unscaled q and is accumulated in float32.
//
// Block (AttnShape): consumer warpgroups of 64 query rows each and a
// producer whose first thread issues every TMA load (the others exit). K2:
// two consumers and a producer warpgroup (384 threads), setmaxnreg moving
// the producer's registers to the consumers, one block per SM. K1: one
// consumer and a producer warp (160 threads), two blocks per SM, so that
// one block's loads overlap the other's products. A block owns 64 or 128
// consecutive queries of one (window or image, head).
//
// Loads (TMA, 3-D maps over the raw (nb, N, 3C) qkv projection): boxes of
// D columns at column offsets h D (q), C + h D (k), 2C + h D (v); rows
// past N are zero-filled by the TMA unit. Both tables come in whole (3-D
// maps, rows past 2G - 1 zero-filled), each as (hi, lo) bf16 parts with
// hi + lo the float32 table: a table resized to the grid (FMB's 127 rows
// to 99) is not a bf16 table, and its bf16 rounding alone moves the bias
// by |q| |dR| ~ 1e-2. A bf16 table that needs no resize comes as hi alone
// (its lo part is neither loaded nor multiplied).
// Every tile is swizzled at its row width and read by wgmma through
// descriptors (wgmma.cuh).
//
// Bias: the prologue computes q.T for every table row with the same
// tensor-core product as q.k (64 queries x TB table rows; q.lo added when
// the table has a lo part), then scatters each product to the key cell it
// serves: rel[q][kh] = (q.Th)[qh + H-1-kh]. The rows stay in shared
// memory, pre-multiplied by log2(e).
//
// Two layouts of the key loop:
//   - global (K2, kWindow = false): key tiles of two whole grid rows (2W
//     <= 128 keys, in a 128-row box), so every thread owns the same key
//     columns, hence the same kw, in every tile: its rel_w terms (2 rows x
//     32 columns) stay in registers for the whole loop, with -inf in the
//     columns past 2W. Per tile only rel_h changes: two values a row. A
//     2-stage ring of K/V tiles with full/empty mbarriers; online softmax.
//   - windowed (K1, kWindow = true): one tile holds the whole window (N =
//     ws^2 <= 208 keys, zero-padded to BK): K and V stay resident, the
//     softmax is a single pass over the 64 x BK scores in registers. The
//     bias joins q.k in the S product, so no score reads shared memory:
//     each thread packs its two rows' rel_h and rel_w terms (divided by
//     the scale, as bf16 hi + lo) as the A fragments of four k16 products
//     against 0/1 expansion tiles (B: key c's grid row / grid column,
//     loaded by TMA; slot 15 of the row tile marks the pad keys, and the A
//     rows hold the mask there).
//
// Products: S = Q K^T is wgmma m64nBKk16 with Q and K from shared memory
// (K-major); the float32 scores are scaled, biased and exponentiated in
// the accumulator layout, rounded to bf16 pairs in place as the A
// fragments of O += P V (wgmma with A from registers, FlashAttention-3's
// layout), V read MN-major through the descriptor's transpose bit.
#pragma once

#include <cstdint>

#include "wgmma.cuh"

namespace msa {

constexpr int kWgRows = 64;       // query rows per consumer warpgroup
constexpr int kGlobalKeys = 128;  // K2: keys per tile (two grid rows of <= 64)
constexpr int kGlobalTable = 128;  // K2: table rows (2 * 64 - 1, padded)
constexpr int kWindowTable = 32;   // K1: table rows (2 * 16 - 1, padded)

// Block shape of each layout.
//   K2: two consumer warpgroups and a producer warpgroup, one block per SM;
//       setmaxnreg moves the producer's registers to the consumers.
//   K1: one consumer warpgroup and a producer warp, two blocks per SM, so
//       that one block's loads overlap the other's products (a window's
//       work is too short to hide its own loads).
template <bool kWindow>
struct AttnShape {
  static constexpr int kConsumers = kWindow ? 1 : 2;
  static constexpr int kBlockQ = kWgRows * kConsumers;  // queries per block
  static constexpr int kThreads = 128 * kConsumers + (kWindow ? 32 : 128);
  static constexpr int kMinBlocks = kWindow ? 2 : 1;    // per SM
  static constexpr int kStages = kWindow ? 1 : 2;       // K/V ring
  static constexpr int kLdRel = kWindow ? 17 : 65;      // grid side + 1
};

// byte offsets in the block's shared memory (1024-aligned base)
template <int D, int BK, int TB, bool kWindow>
struct AttnSmem {
  using S = AttnShape<kWindow>;
  static constexpr int kRow = 2 * D;                          // bytes a row
  static constexpr int kQ = 0;                                // [BlockQ][D]
  static constexpr int kTh = kQ + align_1k(S::kBlockQ * kRow);  // [2][TB][D]
  static constexpr int kTw = kTh + align_1k(2 * TB * kRow);     // [2][TB][D]
  static constexpr int kTile = align_1k(BK * kRow);             // K or V
  static constexpr int kKV = kTw + align_1k(2 * TB * kRow);  // K, V a stage
  // K1: the 0/1 expansion tiles, bf16 [2][BK][16]
  static constexpr int kExpand = kKV + S::kStages * 2 * kTile;
  static constexpr int kRelH =  // float [BlockQ][LdRel]
      kExpand + (kWindow ? align_1k(2 * BK * 32) : 0);
  static constexpr int kRelW = kRelH + S::kBlockQ * S::kLdRel * 4;
  // barriers: q, full[stages], empty[stages]
  static constexpr int kBars = kRelW + S::kBlockQ * S::kLdRel * 4;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * S::kStages) + 1024;
};

struct AttnParams {
  __nv_bfloat16* out;  // (nb, N, C) heads-packed
  int n_tok, heads, grid_h, grid_w;
  int n_tiles;         // key tiles (K2: ceil(H / 2); K1: 1)
  int table_lo;        // bit 0 / 1: the h / w table has a lo part
  float scale_log2;    // scale * log2(e)
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// acc (64 x N) (+)= A (64 x D) B^T, A and B K-major tiles in shared memory
template <int D, int N>
__device__ __forceinline__ void product_qk(float (&acc)[N / 2],
                                           const void* a, const void* b,
                                           bool accumulate = false) {
  const uint64_t da = make_desc<D>(a);
  const uint64_t db = make_desc<D>(b);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < D / 16; ++k)  // a k16 step is 32 bytes: 2 units
    WgmmaSS<N>::run(acc, da + 2 * k, db + 2 * k, accumulate || k > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// rel[row][k] = log2(e) * acc[row][G - 1 + qpos(row) - k] for k < G: the
// table product of each row, moved from table rows to key cells
template <int TB, int LDREL>
__device__ __forceinline__ void scatter_rel(const float (&acc)[TB / 2],
                                            float* rel, const int (&row)[2],
                                            const int (&qpos)[2], int G,
                                            int t4) {
  constexpr float kLog2e = 1.4426950408889634f;
#pragma unroll
  for (int j = 0; j < TB / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = qpos[i] + G - 1 - (8 * j + 2 * t4 + e);
        if (k >= 0 && k < G) rel[row[i] * LDREL + k] = acc[4 * j + 2 * i + e] * kLog2e;
      }
}

// K1's masked keys: a bias (log2 units) whose exp2 is 0
constexpr float kMaskedLog2 = -10000.f;

// The A fragments, as (hi, lo) bf16 parts, of a 64 x 16 operand whose row
// r holds rel[r][k] / scale_log2 in slot k < G, `pad` in slot 15, 0 in the
// others: times the 0/1 expansion tiles it adds each key's bias term to
// q.k in the S accumulator (the whole sum is scaled by scale_log2 after).
// Fragment f holds row f & 1 of the thread's two and slots 2 t4 + 8 (f >>
// 1) + {0, 1} (wgmma's A layout, as FlashAttention-3 packs P).
template <int LDREL>
__device__ __forceinline__ void bias_fragments(const float* rel,
                                               const int (&row)[2], int t4,
                                               int G, float pad,
                                               float inv_scale,
                                               uint32_t (&a)[2][4]) {
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = 2 * t4 + 8 * (f >> 1) + e;
      v[e] = k < G ? rel[row[f & 1] * LDREL + k] * inv_scale
                   : (k == 15 ? pad : 0.f);
    }
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[0], v[1]);
    const float2 back = __bfloat1622float2(hi);
    a[0][f] = *reinterpret_cast<const uint32_t*>(&hi);
    a[1][f] = pack_bf16x2(v[0] - back.x, v[1] - back.y);
  }
}

template <int D, bool kWindow, int BK, int TB>
__global__ void __launch_bounds__(AttnShape<kWindow>::kThreads,
                                  AttnShape<kWindow>::kMinBlocks)
    rel_pos_attention_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                   const __grid_constant__ CUtensorMap kv_map,
                                   const __grid_constant__ CUtensorMap th_map,
                                   const __grid_constant__ CUtensorMap tw_map,
                                   const __grid_constant__ CUtensorMap ex_map,
                                   const AttnParams p) {
  using S = AttnShape<kWindow>;
  constexpr int STAGES = S::kStages;
  constexpr int LDREL = S::kLdRel;
  using L = AttnSmem<D, BK, TB, kWindow>;
  static_assert(BK % 16 == 0 && BK <= 256 && TB % 16 == 0, "tile shapes");

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L::kQ);
  __nv_bfloat16* ths = reinterpret_cast<__nv_bfloat16*>(smem + L::kTh);
  __nv_bfloat16* tws = reinterpret_cast<__nv_bfloat16*>(smem + L::kTw);
  float* relh = reinterpret_cast<float*>(smem + L::kRelH);
  __nv_bfloat16* exs = reinterpret_cast<__nv_bfloat16*>(smem + L::kExpand);
  float* relw = reinterpret_cast<float*>(smem + L::kRelW);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int bm = blockIdx.y;
  const int b = bm / p.heads;
  const int h = bm - b * p.heads;
  const int C = p.heads * D;
  const int q0 = blockIdx.x * S::kBlockQ;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * S::kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == S::kConsumers) {
    // ---------------- producer: one thread issues every load
    if constexpr (!kWindow) regs_release<24>();
    if (tid == 128 * S::kConsumers) {
      const int table_parts = 2 + (p.table_lo & 1) + (p.table_lo >> 1);
      mbar_expect_tx(bar_q, (S::kBlockQ + table_parts * TB) * L::kRow +
                                (kWindow ? 2 * BK * 32 : 0));
      tma_load_3d(qs, &q_map, bar_q, h * D, q0, b);
      tma_load_3d(ths, &th_map, bar_q, 0, 0, 0);
      tma_load_3d(tws, &tw_map, bar_q, 0, 0, 0);
      if constexpr (kWindow) tma_load_3d(exs, &ex_map, bar_q, 0, 0, 0);
      for (int t = 0; t < p.n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
        unsigned char* kt = smem + L::kKV + s * 2 * L::kTile;
        mbar_expect_tx(&full[s], 2 * BK * L::kRow);
        const int k0 = t * 2 * p.grid_w;  // K1: one tile, k0 = 0
        tma_load_3d(kt, &kv_map, &full[s], C + h * D, k0, b);
        tma_load_3d(kt + L::kTile, &kv_map, &full[s], 2 * C + h * D, k0, b);
      }
    }
  } else {
    // ---------------- consumers: 64 query rows each
    if constexpr (!kWindow) regs_claim<240>();
    const int ctid = tid & 127;
    const int warp = ctid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    // this thread's two rows (in the block) and their queries
    const int row[2] = {wg * kWgRows + warp * 16 + g,
                        wg * kWgRows + warp * 16 + g + 8};
    const int q[2] = {q0 + row[0], q0 + row[1]};
    const __nv_bfloat16* q_wg = qs + wg * kWgRows * D;

    mbar_wait(bar_q, 0);
    {
      // rows past N take the cell of query 0 (their output is not stored)
      const int qh[2] = {q[0] < p.n_tok ? q[0] / p.grid_w : 0,
                         q[1] < p.n_tok ? q[1] / p.grid_w : 0};
      const int qw[2] = {q[0] < p.n_tok ? q[0] - qh[0] * p.grid_w : 0,
                         q[1] < p.n_tok ? q[1] - qh[1] * p.grid_w : 0};
      float acc[TB / 2];
      product_qk<D, TB>(acc, q_wg, ths);
      if (p.table_lo & 1) product_qk<D, TB>(acc, q_wg, ths + TB * D, true);
      scatter_rel<TB, LDREL>(acc, relh, row, qh, p.grid_h, t4);
      product_qk<D, TB>(acc, q_wg, tws);
      if (p.table_lo & 2) product_qk<D, TB>(acc, q_wg, tws + TB * D, true);
      scatter_rel<TB, LDREL>(acc, relw, row, qw, p.grid_w, t4);
    }
    named_sync(1 + wg, 128);  // the warpgroup's bias rows are written

    // K1: the bias rows as A fragments against the expansion tiles (slot
    // 15 of the h rows masks the pad keys past N)
    uint32_t ah[2][4], aw[2][4];
    if constexpr (kWindow) {
      const float inv_scale = 1.f / p.scale_log2;
      bias_fragments<LDREL>(relh, row, t4, p.grid_h,
                            kMaskedLog2 * inv_scale, inv_scale, ah);
      bias_fragments<LDREL>(relw, row, t4, p.grid_w, 0.f, inv_scale, aw);
    }

    // this thread's key columns c = 8 j + 2 t4 + e (j < BK / 8, e < 2)
    float rw[kWindow ? 1 : BK / 8][2][2];  // K2: rel_w of each column, row
    uint32_t hi_mask = 0;                  // K2: bit 2j+e: column in row 2
    if constexpr (!kWindow) {
      const int two_rows = 2 * p.grid_w;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t4 + e;
          const int hi = c >= p.grid_w ? 1 : 0;
          const int kw = c - hi * p.grid_w;
          hi_mask |= uint32_t(hi) << (2 * j + e);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            rw[j][e][i] = c < two_rows ? relw[row[i] * LDREL + kw] : -INFINITY;
        }
    }

    // K1: o is written by its one tile's P V (scale_d = 0), so it is not
    // live across the S product (that spilled at K1's 168 registers)
    float o[D / 2];
    if constexpr (!kWindow) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    }
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};
    float s[BK / 2];
    uint32_t pf[BK / 16][4];

    for (int t = 0; t < p.n_tiles; ++t) {
      const int st = t % STAGES;
      const unsigned char* kt = smem + L::kKV + st * 2 * L::kTile;
      mbar_wait(&full[st], (t / STAGES) & 1);
      {
        // s = q.k (K1: + the bias / scale, through the expansion tiles)
        const uint64_t dq = make_desc<D>(q_wg);
        const uint64_t dk = make_desc<D>(kt);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < D / 16; ++k)  // a k16 step is 32 bytes: 2 units
          WgmmaSS<BK>::run(s, dq + 2 * k, dk + 2 * k, k > 0);
        if constexpr (kWindow) {
          const uint64_t dh = make_desc<16>(exs);
          const uint64_t dw = make_desc<16>(exs + BK * 16);
#pragma unroll
          for (int part = 0; part < 2; ++part) {
            WgmmaRS<BK, 0>::run(s, ah[part], dh, 1);
            WgmmaRS<BK, 0>::run(s, aw[part], dw, 1);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
      }

      // scale and bias in log2 units; the rows' maxima
      float mx[2] = {-INFINITY, -INFINITY};
      if constexpr (kWindow) {
#pragma unroll
        for (int x = 0; x < BK / 2; ++x) {
          s[x] *= p.scale_log2;
          mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], s[x]);
        }
      } else {
        const int kh0 = 2 * t;
        float lo[2], hi[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          lo[i] = relh[row[i] * LDREL + kh0];
          hi[i] = kh0 + 1 < p.grid_h ? relh[row[i] * LDREL + kh0 + 1]
                                     : -INFINITY;
        }
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool in_hi = (hi_mask >> (2 * j + e)) & 1u;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              float& v = s[4 * j + 2 * i + e];
              v = fmaf(v, p.scale_log2, (in_hi ? hi[i] : lo[i]) + rw[j][e][i]);
              mx[i] = fmaxf(mx[i], v);
            }
          }
      }
      // the 4 lanes of a row hold its columns between them; every tile
      // holds a valid key of every row, so the maxima are finite
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_run[i], mx[i]);
        corr[i] = fast_exp2(m_run[i] - m_new);
        m_run[i] = m_new;
        l_run[i] *= corr[i];
      }
      if constexpr (!kWindow) {
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j] *= corr[0];
          o[4 * j + 1] *= corr[0];
          o[4 * j + 2] *= corr[1];
          o[4 * j + 3] *= corr[1];
        }
      }
      // p = exp2(s - m) as bf16 pairs: columns [16 kk, 16 kk + 16) are the
      // A fragment of k-step kk
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float p0 = fast_exp2(s[4 * j] - m_run[0]);
        const float p1 = fast_exp2(s[4 * j + 1] - m_run[0]);
        const float p2 = fast_exp2(s[4 * j + 2] - m_run[1]);
        const float p3 = fast_exp2(s[4 * j + 3] - m_run[1]);
        l_run[0] += p0 + p1;
        l_run[1] += p2 + p3;
        pf[j >> 1][(j & 1) * 2] = pack_bf16x2(p0, p1);
        pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16x2(p2, p3);
      }
      // o += p v: V MN-major, a k16 step is 16 rows
      {
        const uint64_t dv = make_desc<D>(kt + L::kTile);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          WgmmaRS<D, 1>::run(o, pf[kk], dv + kk * ((16 * L::kRow) >> 4),
                             !kWindow || kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
      }
      mbar_arrive(&empty[st]);
    }

    // ---- normalise and store the heads-packed rows
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
      l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
      l_run[i] = 1.f / l_run[i];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (q[i] >= p.n_tok) continue;
      __nv_bfloat16* dst =
          p.out + ((size_t)b * p.n_tok + q[i]) * C + h * D + 2 * t4;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16x2(
            o[4 * j + 2 * i] * l_run[i], o[4 * j + 2 * i + 1] * l_run[i]);
    }
  }
}

// ---- host side: launch

// qkv (nb, N, 3C) bf16; th (th_parts, th_rows, D), tw (tw_parts, tw_rows,
// D) bf16 tables as (hi[, lo]) parts; K1: ex (2, BK, 16) bf16, the 0/1
// expansion tiles of the window (K2: unused); out (nb, N, C) bf16. Returns
// a cudaError_t as int.
template <int D, bool kWindow, int BK, int TB>
int launch_rel_pos_attention_wgmma(const void* qkv, const void* th,
                                   const void* tw, const void* ex, void* out,
                                   int nb, int heads, int grid_h, int grid_w,
                                   int th_rows, int tw_rows, int th_parts,
                                   int tw_parts, int n_tiles, float scale,
                                   cudaStream_t stream) {
  using S = AttnShape<kWindow>;
  constexpr int LDREL = S::kLdRel;
  using L = AttnSmem<D, BK, TB, kWindow>;
  const int n_tok = grid_h * grid_w;
  const int C = heads * D;
  // K1's expansion slots: kh or kw < 15, slot 15 the mask
  if (th_rows > TB || tw_rows > TB || th_parts < 1 || th_parts > 2 ||
      tw_parts < 1 || tw_parts > 2 || grid_h + 1 > LDREL ||
      grid_w + 1 > LDREL ||
      (kWindow ? n_tok > BK || grid_h > 15 || grid_w > 15 || ex == nullptr
               : 2 * grid_w > BK))
    return cudaErrorInvalidValue;
  CUtensorMap q_map, kv_map, th_map, tw_map, ex_map = {};
  const cuuint64_t qkv_dims[3] = {(cuuint64_t)3 * C, (cuuint64_t)n_tok,
                                  (cuuint64_t)nb};
  const cuuint64_t qkv_strides[2] = {(cuuint64_t)6 * C,
                                     (cuuint64_t)6 * C * n_tok};
  const cuuint32_t q_box[3] = {D, S::kBlockQ, 1};
  const cuuint32_t kv_box[3] = {D, BK, 1};
  const cuuint64_t th_dims[3] = {D, (cuuint64_t)th_rows,
                                 (cuuint64_t)th_parts};
  const cuuint64_t tw_dims[3] = {D, (cuuint64_t)tw_rows,
                                 (cuuint64_t)tw_parts};
  const cuuint64_t th_strides[2] = {2 * D, (cuuint64_t)2 * D * th_rows};
  const cuuint64_t tw_strides[2] = {2 * D, (cuuint64_t)2 * D * tw_rows};
  const cuuint32_t th_box[3] = {D, TB, (cuuint32_t)th_parts};
  const cuuint32_t tw_box[3] = {D, TB, (cuuint32_t)tw_parts};
  if (!encode_map<D>(&q_map, qkv, 3, qkv_dims, qkv_strides, q_box) ||
      !encode_map<D>(&kv_map, qkv, 3, qkv_dims, qkv_strides, kv_box) ||
      !encode_map<D>(&th_map, th, 3, th_dims, th_strides, th_box) ||
      !encode_map<D>(&tw_map, tw, 3, tw_dims, tw_strides, tw_box))
    return cudaErrorInvalidValue;
  if (kWindow) {
    const cuuint64_t ex_dims[3] = {16, (cuuint64_t)BK, 2};
    const cuuint64_t ex_strides[2] = {32, (cuuint64_t)32 * BK};
    const cuuint32_t ex_box[3] = {16, BK, 2};
    if (!encode_map<16>(&ex_map, ex, 3, ex_dims, ex_strides, ex_box))
      return cudaErrorInvalidValue;
  }

  auto kernel = rel_pos_attention_wgmma_kernel<D, kWindow, BK, TB>;
  static int granted[kMaxDevices] = {};
  const cudaError_t err = reserve_smem(kernel, L::kBytes, granted);
  if (err != cudaSuccess) return err;
  AttnParams p;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.n_tok = n_tok;
  p.heads = heads;
  p.grid_h = grid_h;
  p.grid_w = grid_w;
  p.n_tiles = n_tiles;
  p.table_lo = (th_parts == 2 ? 1 : 0) | (tw_parts == 2 ? 2 : 0);
  p.scale_log2 = scale * 1.4426950408889634f;
  const dim3 grid((n_tok + S::kBlockQ - 1) / S::kBlockQ, nb * heads);
  kernel<<<grid, S::kThreads, L::kBytes, stream>>>(q_map, kv_map, th_map,
                                                   tw_map, ex_map, p);
  return cudaGetLastError();
}

}  // namespace msa
