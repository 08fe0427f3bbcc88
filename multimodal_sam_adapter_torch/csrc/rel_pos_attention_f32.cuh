// The float32 core of both attention kernels (K1 windowed, K2 global):
// softmax attention with SAM's decomposed rel-pos bias on Hopper's .tf32
// wgmma products in 3xTF32, fed by TMA, with warp specialisation.
//
// For one (window or image, head) pair and a query q at grid cell (qh, qw):
//
//   out[q] = sum_k softmax_k(scale q.k + q.Th[qh - kh + H - 1]
//                                       + q.Tw[qw - kw + W - 1]) v[k]
//
// with the key k at grid cell (kh, kw), Th (2H - 1, D) and Tw (2W - 1, D)
// the float32 rel-pos tables resized to the grid, the bias from the
// unscaled q. K1 is the case of a ws x ws grid per window. float32 in and
// out, within 1e-4 + 1e-4 |out| of the plain float32 version (TF32 off).
//
// What bounds it: the products. 3xTF32 takes three TF32 products for each
// float32 one, so its ceiling is a third of the card's 495 TF32 TFLOP/s
// (K2 at 64^2 x 16 heads: 68.7 GFLOP, 0.14 ms at the TF32 rate, 0.42 ms
// in 3xTF32).
//
// 3xTF32: TF32 keeps 11 significant bits (~5e-4 an operand), far from the
// float32 tolerance, so each operand x is split into big = tf32(x) and
// small = tf32(x - big) (split_tf32) and a k8 step runs a_big b_small +
// a_small b_big, then + a_big b_big (a_small b_small, ~2^-22, is dropped).
//
// Block: 128 queries of one (window or image, head), two consumer
// warpgroups of 64 query rows and a producer warpgroup (setmaxnreg moves
// its registers to the consumers), one block per SM.
//   - producer: thread 0 issues every TMA load (3-D maps over the raw
//     (nb, N, 3C) qkv, rows past N zero-filled): Q once, then each tile's
//     K into its ready stage (a 2-stage ring, full / empty mbarriers) and
//     its V into the stage's raw slot, as soon as the consumers leave the
//     stage, so the load of tile t + 2 runs under their work on t + 1.
//     Warps 1-3 split each landed tile: K in place into its big half and
//     the small one (an elementwise pass over the swizzled tile), V into
//     V^T's halves, transposed: .tf32 wgmma has no transpose, and V
//     arrives MN-major (key rows, head dim contiguous), so the product's
//     B must be written K-major (head-dim rows of keys).
//   - consumers: S = Q K^T with A = Q from registers (each tile re-reads
//     the thread's fragment from the swizzled Q tile and splits it: kept
//     in registers it would spill beside O), B = K's halves; the online
//     softmax on exp2 in the accumulator layout; P split in registers as
//     the A fragments of O += P V, B = V^T's halves.
//   - P's fragments without shuffles: the f32 accumulator gives a thread
//     columns 2 t4 and 2 t4 + 1 of each n8 block, .tf32's k8 A fragment
//     wants columns t4 and t4 + 4. The sum over keys does not depend on
//     their order, so V^T holds each octet of keys in the order 0, 2, 4,
//     6, 1, 3, 5, 7: its k position t4 is key 2 t4, t4 + 4 is 2 t4 + 1.
//   - accumulation: the tensor cores add into their accumulator by
//     truncation, so over a long sum the error grows with its length
//     (K5's fc2: 1.3e-4 at K = 3072). Each tile's S and each tile's P V
//     start a fresh accumulator (24 k8 products at K = 64); P V is then
//     added into the float32 O on the CUDA cores (o = o corr + pv,
//     rounded to nearest).
// Key tiles (the TPU kernel's block_k = rows * W): R whole grid rows, R W
// <= 64 keys, in a 64-row box, so each of a thread's key columns c keeps
// its grid column kw = c % W in every tile: its rel_w terms stay in
// registers, -inf in the columns past R W (K2 at W = 50: 14 of 64; K1's
// 14x14 windows: R = 4, 56 of 64). The rel_h term of column c is row
// tR + c / W's: one value a row and tile when R = 1 (kOneRow, K2's
// grids wider than 32), a lookup a score otherwise; rows past H read -inf
// (the last tile of an H that R does not divide). Every tile holds a key
// of row tR, so the running maxima are finite.
// Bias: the prologue computes q.Th and q.Tw with float32 FMAs (warpgroup 0
// the H rel_h terms of each of the block's queries, warpgroup 1 the W
// rel_w terms), the tables read from global memory four rows at a time:
// 1.6% of the products' multiply-adds at 64^2, on the CUDA cores.
//
// Shared memory (F32Layout, D = 64; 1024-aligned, each tile in slabs of
// 32 floats a row with the 128-byte swizzle; D = 16: one slab of 16
// floats, the 64-byte swizzle): Q 32 KB, two raw V slots 32 KB, two ready
// stages of 64 KB (K big, K small, V^T big, V^T small), rel_h 33 KB;
// rel_w (33 KB) lives at the end of stage 1 until its rows are in
// registers (bar_rel holds tile 1's split, not its load): 226 KB of the
// 227 KB a block may take.
#pragma once

#include <cstdint>

#include "wgmma.cuh"

namespace msa {

// the plan (ops/attention.py: F32_* mirrors these)
constexpr int kF32BlockQ = 128;     // queries a block: 2 consumer warpgroups
constexpr int kF32TileKeys = 64;    // keys a tile: R grid rows, R W <= 64
constexpr int kF32MaxSide = 64;     // grid sides at most
constexpr int kF32RelLd = 65;       // floats a rel row: H <= 64, then -inf
constexpr int kF32Threads = 384;    // two consumer warpgroups, a producer
constexpr int kF32SplitThreads = 96;  // the producer's warps 1-3
constexpr int kF32SmemMax = 232448;  // shared memory a block may take

template <int D>
struct F32Layout {
  static constexpr int kSlabF = D < 32 ? D : 32;  // floats a slab row
  static constexpr int kRowB = 4 * kSlabF;        // its bytes: the swizzle
  static constexpr int kSwz = kRowB / 2;          // make_desc's width
  static constexpr int kTile = kF32TileKeys * D * 4;  // a K or V tile
  // byte offsets in the block's shared memory (1024-aligned base)
  static constexpr int kQ = 0;                            // [slab][128][]
  static constexpr int kRawV = kQ + kF32BlockQ * D * 4;   // V, 2 slots
  static constexpr int kStage0 = kRawV + 2 * kTile;       // 2 stages:
  static constexpr int kStage = 4 * kTile;  // K big, K small, V^T big, small
  static constexpr int kRel = kF32BlockQ * kF32RelLd * 4;
  static constexpr int kRelH = kStage0 + 2 * kStage;      // [128][LD]
  // rel_w at the end of stage 1 where it fits (D = 64: clear of K's big
  // half, which tile 1's load writes), else after rel_h
  static constexpr bool kAliasW = kStage - kTile >= kRel;
  static constexpr int kRelW =
      kAliasW ? kStage0 + 2 * kStage - kRel : kRelH + kRel;
  // barriers: q, loaded[2], full[2], empty[2], rel
  static constexpr int kBars = kRelH + kRel + (kAliasW ? 0 : kRel);
  static constexpr int kBytes = kBars + 8 * 8 + 1024;
  static_assert(kBytes <= kF32SmemMax, "shared memory");
};

struct AttnF32Params {
  float* out;         // (nb, N, C) heads-packed
  const float* th;    // (2H - 1, D)
  const float* tw;    // (2W - 1, D)
  int n_tok, heads, grid_h, grid_w;
  int rows_per_tile;  // R
  int n_tiles;        // ceil(H / R)
  float scale_log2;   // scale * log2(e)
};

// the swizzled 16-byte unit of row r (rows of kRowB bytes, TMA's 128- or
// 64-byte swizzle: the unit index XOR address bits 7-9 or 7-8)
template <int kRowB>
__device__ __forceinline__ int swizzle_unit(int unit, int r) {
  return unit ^ (kRowB == 128 ? (r & 7) : ((r >> 1) & 3));
}

// address of element x of row r in a tile of `rows` rows of D floats
// (slabs of kSlabF floats, each rows x kRowB bytes; V^T's rows of 64 keys
// are F32Layout<64>'s)
template <int D>
__device__ __forceinline__ const float* f32_at(const unsigned char* tile,
                                               int rows, int r, int x) {
  using L = F32Layout<D>;
  const int slab = x / L::kSlabF;
  const int xs = x - slab * L::kSlabF;
  return reinterpret_cast<const float*>(
      tile + slab * rows * L::kRowB + r * L::kRowB +
      (swizzle_unit<L::kRowB>(xs >> 2, r) << 4) + (xs & 3) * 4);
}

// descriptor of k8 step ks of a K-major operand of D-float rows, `rows`
// rows a slab
template <int D>
__device__ __forceinline__ uint64_t f32_desc(const unsigned char* tile,
                                             int rows, int ks) {
  using L = F32Layout<D>;
  constexpr int kSteps = L::kSlabF / 8;  // k8 steps a slab row
  return make_desc<L::kSwz>(tile + (ks / kSteps) * rows * L::kRowB) +
         2 * (ks % kSteps);
}

// d (64 x N) = A B^T in 3xTF32 over K = 8 KS: A's halves from registers,
// B's halves K-major in shared memory (descriptors of each k8 step)
template <int N, int KS, typename DescFn>
__device__ __forceinline__ void product_3xtf32(float (&d)[N / 2],
                                               const uint32_t (&big)[KS][4],
                                               const uint32_t (&small)[KS][4],
                                               DescFn desc) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint64_t db = desc(ks, 0);
    WgmmaTf32<N>::run(d, big[ks], desc(ks, 1), ks > 0);
    WgmmaTf32<N>::run(d, small[ks], db, 1);
    WgmmaTf32<N>::run(d, big[ks], db, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
}

// one thread: the K tile of keys k0.. of image b into its stage (the
// slot of K's big half) and the V tile into the raw slot, the head's
// columns kcol.. and vcol.. of qkv, a box a slab
template <int D>
__device__ __forceinline__ void load_kv(unsigned char* k_dst,
                                        unsigned char* v_dst,
                                        const CUtensorMap* map, uint64_t* bar,
                                        int k0, int kcol, int vcol, int b) {
  using L = F32Layout<D>;
  constexpr int kSlab = kF32TileKeys * L::kRowB;
  mbar_expect_tx(bar, 2 * L::kTile);
#pragma unroll
  for (int sl = 0; sl < D / L::kSlabF; ++sl) {
    tma_load_3d(k_dst + sl * kSlab, map, bar, kcol + sl * L::kSlabF, k0, b);
    tma_load_3d(v_dst + sl * kSlab, map, bar, vcol + sl * L::kSlabF, k0, b);
  }
}

// the producer's split threads (pt = 0..95): a tile's K, in its stage,
// split in place into its big half and the small one, and the raw V into
// V^T's halves
template <int D>
__device__ __forceinline__ void split_tile(const unsigned char* raw_v,
                                           unsigned char* stage, int pt) {
  using L = F32Layout<D>;
  constexpr int BK = kF32TileKeys;
  constexpr int kStep = kF32SplitThreads;
  // K: each 16-byte unit to the same offset of the big and small halves
  uint4* kb = reinterpret_cast<uint4*>(stage);
  uint4* ks = reinterpret_cast<uint4*>(stage + L::kTile);
#pragma unroll 2
  for (int i = pt; i < BK * D / 4; i += kStep) {
    const float4 v = *reinterpret_cast<const float4*>(kb + i);
    uint4 b, s;
    split_tf32(v.x, b.x, s.x);
    split_tf32(v.y, b.y, s.y);
    split_tf32(v.z, b.z, s.z);
    split_tf32(v.w, b.w, s.w);
    kb[i] = b;
    ks[i] = s;
  }
  // V^T: rows n of BK keys in two slabs of 32 (128-byte rows). Pair w
  // takes head-dim column n and the octet of keys 8a + c (c < 8) to
  // positions 8a + c / 2 (c even) and 8a + 4 + c / 2 (c odd): two 16-byte
  // units of row n. Key 8a + c's row is swizzled by c alone (row % 8 for
  // 128-byte rows, row / 2 % 4 for 64-byte ones), so its read offsets are
  // the pair's base plus constants.
  static_assert((D & (D - 1)) == 0, "D a power of two");
  unsigned char* vb = stage + 2 * L::kTile;
  unsigned char* vs = stage + 3 * L::kTile;
#pragma unroll 2
  for (int w = pt; w < 8 * D; w += kStep) {
    const int n = w & (D - 1);
    const int a = w / D;
    const int unit = (n % L::kSlabF) >> 2;
    const unsigned char* src = raw_v + (n / L::kSlabF) * BK * L::kRowB +
                               8 * a * L::kRowB + (n & 3) * 4;
    uint4 b[2], sm[2];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int swz = L::kRowB == 128 ? c : (c >> 1) & 3;
      const float v = *reinterpret_cast<const float*>(
          src + c * L::kRowB + ((unit ^ swz) << 4));
      uint32_t* bp = reinterpret_cast<uint32_t*>(&b[c & 1]);
      uint32_t* sp = reinterpret_cast<uint32_t*>(&sm[c & 1]);
      split_tf32(v, bp[c >> 1], sp[c >> 1]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int off = (a >> 2) * D * 128 + n * 128 +
                      (swizzle_unit<128>(2 * (a & 3) + hh, n) << 4);
      *reinterpret_cast<uint4*>(vb + off) = b[hh];
      *reinterpret_cast<uint4*>(vs + off) = sm[hh];
    }
  }
}

template <int D, bool kOneRow>
__global__ void __launch_bounds__(kF32Threads, 1)
    rel_pos_attention_f32_kernel(const __grid_constant__ CUtensorMap q_map,
                                 const __grid_constant__ CUtensorMap kv_map,
                                 const AttnF32Params p) {
  using L = F32Layout<D>;
  constexpr int BK = kF32TileKeys;
  constexpr int LD = kF32RelLd;
  constexpr float kLog2e = 1.4426950408889634f;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const unsigned char* qs = smem + L::kQ;
  unsigned char* raw_v = smem + L::kRawV;
  float* relh = reinterpret_cast<float*>(smem + L::kRelH);
  float* relw = reinterpret_cast<float*>(smem + L::kRelW);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* loaded = bar_q + 1;
  uint64_t* full = bar_q + 3;
  uint64_t* empty = bar_q + 5;
  uint64_t* bar_rel = bar_q + 7;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int bm = blockIdx.y;
  const int b = bm / p.heads;
  const int h = bm - b * p.heads;
  const int C = p.heads * D;
  const int q0 = blockIdx.x * kF32BlockQ;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&loaded[s], 1);
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init(bar_rel, 256);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------- producer: thread 0 issues the TMA loads, warps 1-3
    // split each tile
    regs_release<56>();
    const int pt = tid - 256;
    if (pt == 0) {
      mbar_expect_tx(bar_q, kF32BlockQ * D * 4);
#pragma unroll
      for (int sl = 0; sl < D / L::kSlabF; ++sl)
        tma_load_3d(smem + L::kQ + sl * kF32BlockQ * L::kRowB, &q_map, bar_q,
                    h * D + sl * L::kSlabF, q0, b);
      // tile t into stage t % 2 as soon as the consumers leave it (tile
      // t - 2 done; that tile's split had read the raw slot before)
      for (int t = 0; t < p.n_tiles; ++t) {
        const int st = t & 1;
        if (t >= 2) mbar_wait(&empty[st], ((t >> 1) - 1) & 1);
        load_kv<D>(smem + L::kStage0 + st * L::kStage,
                   raw_v + st * L::kTile, &kv_map, &loaded[st],
                   t * p.rows_per_tile * p.grid_w, C + h * D,
                   2 * C + h * D, b);
      }
    } else if (pt >= 32) {
      for (int t = 0; t < p.n_tiles; ++t) {
        const int st = t & 1;
        mbar_wait(&loaded[st], (t >> 1) & 1);
        if (t == 1) mbar_wait(bar_rel, 0);  // rel_w is out of stage 1
        split_tile<D>(raw_v + st * L::kTile,
                      smem + L::kStage0 + st * L::kStage, pt - 32);
        fence_proxy_async();  // the halves are wgmma operands
        named_sync(1, kF32SplitThreads);  // the stage is written
        if (pt == 32) mbar_arrive(&full[st]);
      }
    }
    return;
  }

  // ---------------- consumers: 64 query rows each
  regs_claim<224>();
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // this thread's two rows (in the block) and their queries
  const int row[2] = {wg * 64 + warp * 16 + g, wg * 64 + warp * 16 + g + 8};
  const int q[2] = {q0 + row[0], q0 + row[1]};
  // row[0]'s element t4 of Q's tile (its fragments add slab, row and unit)
  const unsigned char* q_frag = qs + row[0] * L::kRowB + t4 * 4;
  mbar_wait(bar_q, 0);

  // ---- prologue: rel_h (warpgroup 0) or rel_w (warpgroup 1) of query
  // row r, in log2 units: rel[r][k] = q.T[c - k + G - 1] for the query's
  // cell c; the k of lane r at step s is (c + s) mod G, so the lanes of a
  // warp read at most two table rows at once
  {
    const int r = tid & 127;
    const bool is_h = wg == 0;
    const int G = is_h ? p.grid_h : p.grid_w;
    const float* T = is_h ? p.th : p.tw;
    float* rel = (is_h ? relh : relw) + r * LD;
    const int qi = q0 + r;
    const int qh = qi / p.grid_w;
    const int c = qi >= p.n_tok ? 0 : is_h ? qh : qi - qh * p.grid_w;
    float qv[D];
#pragma unroll
    for (int x = 0; x < D; x += 4) {
      const float4 v =
          *reinterpret_cast<const float4*>(f32_at<D>(qs, kF32BlockQ, r, x));
      qv[x] = v.x;
      qv[x + 1] = v.y;
      qv[x + 2] = v.z;
      qv[x + 3] = v.w;
    }
    // four table rows at once: their loads (from L2) in flight together
    for (int s0 = 0; s0 < G; s0 += 4) {
      int k[4];
      const float4* tr[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int s = min(s0 + u, G - 1);  // past G: not stored
        k[u] = c + s < G ? c + s : c + s - G;
        tr[u] = reinterpret_cast<const float4*>(
            T + (size_t)(c - k[u] + G - 1) * D);
      }
      float acc[4][2] = {};
#pragma unroll
      for (int x = 0; x < D / 4; ++x)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 tv = __ldg(tr[u] + x);
          acc[u][0] = fmaf(qv[4 * x], tv.x, acc[u][0]);
          acc[u][1] = fmaf(qv[4 * x + 1], tv.y, acc[u][1]);
          acc[u][0] = fmaf(qv[4 * x + 2], tv.z, acc[u][0]);
          acc[u][1] = fmaf(qv[4 * x + 3], tv.w, acc[u][1]);
        }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (s0 + u < G) rel[k[u]] = (acc[u][0] + acc[u][1]) * kLog2e;
    }
    if (is_h)
      for (int k = G; k < LD; ++k) rel[k] = -INFINITY;
  }
  named_sync(2, 256);  // both warpgroups' rel rows are written

  // this thread's key columns c = 8 j + 2 t4 + e (j < BK / 8, e < 2): the
  // rel_w term of each (-inf past R W) and, unless kOneRow, its grid row
  // in the tile, c / W, one byte each
  const int rw_cols = p.rows_per_tile * p.grid_w;
  float rw[BK / 8][2][2];
  uint32_t krow[BK / 16] = {};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * t4 + e;
      const int kr = c / p.grid_w;
      const int kw = c - kr * p.grid_w;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        rw[j][e][i] = c < rw_cols ? relw[row[i] * LD + kw] : -INFINITY;
      if constexpr (!kOneRow) {
        const int x = 2 * j + e;
        krow[x >> 2] |= uint32_t(c < rw_cols ? kr : 0) << (8 * (x & 3));
      }
    }
  mbar_arrive(bar_rel);  // rel_w is in registers: stage 1 may be written

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int t = 0; t < p.n_tiles; ++t) {
    const int st = t & 1;
    const unsigned char* stage = smem + L::kStage0 + st * L::kStage;
    // Q's A fragments of each k8 step, split: rows g, g + 8 of the warp,
    // columns 8 ks + t4, + 4, i.e. unit 2 (ks % steps a slab) + e / 2 of
    // the rows, swizzled by g alone
    uint32_t qb[D / 8][4], qsm[D / 8][4];
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        constexpr int kSteps = L::kSlabF / 8;
        const int unit = 2 * (ks % kSteps) + (e >> 1);
        const int swz = L::kRowB == 128 ? g : (g >> 1) & 3;
        split_tf32(*reinterpret_cast<const float*>(
                       q_frag + (ks / kSteps) * kF32BlockQ * L::kRowB +
                       (e & 1) * 8 * L::kRowB + ((unit ^ swz) << 4)),
                   qb[ks][e], qsm[ks][e]);
      }
    mbar_wait(&full[st], (t >> 1) & 1);

    // s = q.k over the tile's keys: B = K's halves (big at +0, small at
    // +kTile)
    float s[BK / 2];
    product_3xtf32<BK, D / 8>(s, qb, qsm, [&](int ks, int small) {
      return f32_desc<D>(stage + small * L::kTile, BK, ks);
    });

    // scale and bias in log2 units; the rows' maxima
    float mx[2] = {-INFINITY, -INFINITY};
    if constexpr (kOneRow) {
      const float bh[2] = {relh[row[0] * LD + t], relh[row[1] * LD + t]};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float& v = s[4 * j + 2 * i + e];
            v = fmaf(v, p.scale_log2, bh[i] + rw[j][e][i]);
            mx[i] = fmaxf(mx[i], v);
          }
    } else {
      const int kh0 = t * p.rows_per_tile;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 2 * j + e;
          const int kh = min(kh0 + int((krow[x >> 2] >> (8 * (x & 3))) & 255u),
                             LD - 1);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float& v = s[4 * j + 2 * i + e];
            v = fmaf(v, p.scale_log2, relh[row[i] * LD + kh] + rw[j][e][i]);
            mx[i] = fmaxf(mx[i], v);
          }
        }
    }
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
    // p = exp2(s - m), split: n8 block j of S is the A fragment of k8 step
    // j of P V, its columns 2 t4 and 2 t4 + 1 at k positions t4 and t4 + 4
    // (V^T's key order), rows g and g + 8
    uint32_t pb[BK / 8][4], ps[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e & 1;  // fragment e: row i, column 2 t4 + (e >> 1)
        const float pe = fast_exp2(s[4 * j + 2 * i + (e >> 1)] - m_run[i]);
        l_run[i] += pe;
        split_tf32(pe, pb[j][e], ps[j][e]);
      }
    // pv = p v over the tile's keys, a fresh accumulator: B = V^T's halves
    float pv[D / 2];
    product_3xtf32<D, BK / 8>(pv, pb, ps, [&](int kk, int small) {
      return f32_desc<BK>(stage + (2 + small) * L::kTile, D, kk);
    });
    mbar_arrive(&empty[st]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        o[4 * j + x] = fmaf(o[4 * j + x], corr[x >> 1], pv[4 * j + x]);
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
    float* dst = p.out + ((size_t)b * p.n_tok + q[i]) * C + h * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(
          o[4 * j + 2 * i] * l_run[i], o[4 * j + 2 * i + 1] * l_run[i]);
  }
}

// ---- host side: launch

// qkv (nb, N, 3C) float32 over an H x W grid (N = H W, C = heads D); th
// (2H - 1, D), tw (2W - 1, D) float32 tables; out (nb, N, C) float32; key
// tiles of R grid rows, n_tiles of them (ops/attention.py:f32_key_tiles).
// Returns a cudaError_t as int.
template <int D, bool kOneRow>
int launch_rel_pos_attention_f32(const void* qkv, const void* th,
                                 const void* tw, void* out, int nb, int heads,
                                 int grid_h, int grid_w, int rows_per_tile,
                                 int n_tiles, float scale,
                                 cudaStream_t stream) {
  using L = F32Layout<D>;
  const int n_tok = grid_h * grid_w;
  const int C = heads * D;
  const int R = rows_per_tile;
  if (grid_h < 1 || grid_w < 1 || grid_h > kF32MaxSide ||
      grid_w > kF32MaxSide || R < 1 || R > grid_h ||
      R * grid_w > kF32TileKeys || (R == 1) != kOneRow ||
      n_tiles * R < grid_h || (n_tiles - 1) * R >= grid_h ||
      nb * heads > 65535)
    return cudaErrorInvalidValue;
  CUtensorMap q_map, kv_map;
  const cuuint64_t dims[3] = {(cuuint64_t)3 * C, (cuuint64_t)n_tok,
                              (cuuint64_t)nb};
  const cuuint64_t strides[2] = {(cuuint64_t)12 * C,
                                 (cuuint64_t)12 * C * n_tok};
  const cuuint32_t q_box[3] = {L::kSlabF, kF32BlockQ, 1};
  const cuuint32_t kv_box[3] = {L::kSlabF, kF32TileKeys, 1};
  const CUtensorMapSwizzle swz = L::kRowB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                                 : CU_TENSOR_MAP_SWIZZLE_64B;
  if (!encode_map(&q_map, qkv, 3, dims, strides, q_box, swz,
                  CU_TENSOR_MAP_DATA_TYPE_FLOAT32) ||
      !encode_map(&kv_map, qkv, 3, dims, strides, kv_box, swz,
                  CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
    return cudaErrorInvalidValue;

  auto kernel = rel_pos_attention_f32_kernel<D, kOneRow>;
  static int granted[kMaxDevices] = {};
  const cudaError_t err = reserve_smem(kernel, L::kBytes, granted);
  if (err != cudaSuccess) return err;
  AttnF32Params p;
  p.out = static_cast<float*>(out);
  p.th = static_cast<const float*>(th);
  p.tw = static_cast<const float*>(tw);
  p.n_tok = n_tok;
  p.heads = heads;
  p.grid_h = grid_h;
  p.grid_w = grid_w;
  p.rows_per_tile = R;
  p.n_tiles = n_tiles;
  p.scale_log2 = scale * 1.4426950408889634f;
  const dim3 grid((n_tok + kF32BlockQ - 1) / kF32BlockQ, nb * heads);
  kernel<<<grid, kF32Threads, L::kBytes, stream>>>(q_map, kv_map, p);
  return cudaGetLastError();
}

// Instantiates the float32 core for SAM ViT-B/L's head width 64 and the
// narrow test configurations' 16 and 32, one key row a tile (grids wider
// than 32) or several; any other width is refused.
inline int dispatch_rel_pos_attention_f32(const void* qkv, const void* th,
                                          const void* tw, void* out, int nb,
                                          int heads, int head_dim,
                                          int grid_h, int grid_w,
                                          int rows_per_tile, int n_tiles,
                                          float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MSA_F32_CASE(DIM)                                                    \
  if (head_dim == DIM)                                                       \
    return rows_per_tile == 1                                                \
               ? launch_rel_pos_attention_f32<DIM, true>(                    \
                     qkv, th, tw, out, nb, heads, grid_h, grid_w,            \
                     rows_per_tile, n_tiles, scale, s)                       \
               : launch_rel_pos_attention_f32<DIM, false>(                   \
                     qkv, th, tw, out, nb, heads, grid_h, grid_w,            \
                     rows_per_tile, n_tiles, scale, s);
  MSA_F32_CASE(16)
  MSA_F32_CASE(32)
  MSA_F32_CASE(64)
#undef MSA_F32_CASE
  return cudaErrorInvalidValue;
}

}  // namespace msa
