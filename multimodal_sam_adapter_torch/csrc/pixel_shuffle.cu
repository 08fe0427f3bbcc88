// The eval-mode f1 assembly of the backbone, fused:
//   f1 = BN_eval(depth_to_space(ConvTranspose2x2s2(c2)) + c1 + x1)
// as one GEMM with an epilogue. The 2x2 stride-2 transposed conv is one
// product c2 (pixels x C) @ W (C x 4*O); column n = o * 4 + dy * 2 + dx of
// the product is channel o of output pixel (2h + dy, 2w + dx). The
// epilogue adds c1 and x1 and applies the per-channel affine (the eval
// BatchNorm, with the transposed conv's bias folded into the shift) in
// float32, rounds once, and writes each phase straight to its interleaved
// output pixel: the depth-to-space never exists as a tensor.
//
// Replaces: multimodal_sam_adapter_tpu/ops/pixel_shuffle.py,
//   pixel_shuffle_up_bn (Pallas kernel _up_bn_kernel). Same arithmetic; the
//   TPU kernel walks one input row per grid step with the whole weight
//   resident, here persistent blocks walk tiles of one input row each.
//
// Layouts, as the backbone already holds them (no permute, no copy around
// the call): c2 is the adapter's token stream, pixel rows of C contiguous
// values (row stride C, batch stride given); W is torch's ConvTranspose2d
// weight (C, O, 2, 2), i.e. row-major C x 4*O; c1 and x1 are (B, O, 2H, 2W),
// each NCHW-like (W innermost) or channels-last (O innermost), every other
// stride a multiple of 16 bytes; out is (B, O, 2H, 2W) contiguous.
//
// What bounds it on an H100, at the flagship shape (B = 1, 128 x 128 c2
// pixels, C = O = 1024; the product 16384 x 1024 x 4096):
//   - operations: 137 GFLOP of bf16 products, 0.139 ms at 989 TFLOP/s;
//   - device bytes: c2 34 MB, W 8 MB, c1, x1 and f1 134 MB each (443 MB),
//     0.132 ms at 3.35 TB/s;
//   - L2 -> shared memory: a 128 x 128 tile reads its 128 x C rows of c2
//     once per column tile and its C x 128 slab of W once per row tile,
//     16384 C 2 * 32 + 4096 C 2 * 128 = 2.15 GB a call (the 64 x 128
//     mma.sync tile this replaces read 3.2 GB).
// The two bounds are nearly equal, so the design keeps the device bytes
// off the product's critical path (they stream by TMA while the tensor
// cores run) and keeps the L2 reads as low as the shared memory allows.
//
// Design (bf16), csrc/wgmma.cuh's building blocks as in K5's GEMMs:
//   - persistent: one block per SM (the plan's grid, ops/pixel_shuffle.py:
//     pixel_shuffle_plan) walks output tiles blockIdx.x, + gridDim.x, ...
//     in N-fastest order: the 132 tiles in flight cover ~4 row tiles, so
//     their c2 rows and all of W (8.4 MB) stay in the 50 MB L2 while c1,
//     x1 and f1 stream past;
//   - a tile is 128 pixels of ONE c2 image row (b, h, w0 .. w0 + 127) x 128
//     product columns (32 whole channels, 4 phases each), so its output is
//     one box of 256 output columns x 2 output rows x 32 channels. A row's
//     last tile is ragged (FMB's W = 100, `whole` mode's 228): TMA zero-fills
//     its loads past W and drops its stores past 2W;
//   - one producer thread issues TMA loads into a ring of 4 stages of 64 k:
//     A, a 128 x 64 box of c2 through a 4-D map (C, W, H, B) with the
//     128-byte swizzle (K-major); B, two 64 x 64 boxes of the weight as it
//     lies (MN-major: wgmma reads it with the transpose bit, no weight is
//     re-laid); two consumer warpgroups of 64 pixels run wgmma m64n128k16,
//     keeping one stage's products in flight;
//   - when a tile's k-loop is under way (after its 5th stage is issued, the
//     previous tile's epilogue being done), the producer also issues the
//     tile's c1 and x1 boxes, each in its own layout (NCHW: 64 columns x 2
//     rows x 32 channels, 128-byte swizzle; channels-last: 32 channels x 128
//     columns x 2 rows, 64-byte swizzle), so they land while the tensor
//     cores run;
//   - epilogue: each thread forms (acc + c1 + x1) * scale + shift for its
//     accumulator pairs (the two dx phases of one channel, one output row)
//     in float32 and writes bf16 pairs into a staging tile in f1's NCHW
//     box layout (128-byte swizzle); one thread per warpgroup stores it by
//     TMA and waits for the store to have read it only before the next
//     tile's epilogue, so tile i's store overlaps tile i+1's product.
//   Shared memory: ring 4 x 32 KB + c1, x1 and staging tiles 3 x 32 KB +
//   barriers and alignment 2 KB = 231,424 bytes (of 232,448).
//
// float32, for float32 parity, in 3xTF32 on .tf32 wgmma (K5's float32
// GEMMs, csrc/convnext_block.cu): each operand x is split into big =
// tf32(x) and small = tf32(x - big), and a k8 step runs a_big b_small +
// a_small b_big, then a_big b_big (a_small b_small, ~2^-22, is dropped).
// At the flagship that is 3 x 137 GFLOP, 0.833 ms at TF32's 494.7 TFLOP/s,
// against 889 MB of device bytes (c2 67 MB, W 17 MB, c1, x1 and f1 268 MB
// each), 0.265 ms: the product sets the pace.
//   - .tf32 has no transpose and W is MN-major, so a first launch
//     (pixel_shuffle_split_kernel) writes W's halves K-major into the
//     caller's scratch, w_split (2, 4O, C): 50 MB of traffic. Every row
//     tile reads all of it from L2, so L2 -> shared memory is 16384 C 4 *
//     32 (c2) + 4096 C 8 * 128 (w_split) = 6.4 GB a call, 3x bf16's;
//   - pixel_shuffle_tf32_kernel<C1_LAYOUT, X1_LAYOUT> takes bf16's tiles
//     (128 pixels of one c2 row x 128 product columns) and roles; a ring
//     of 4 stages of 32 k: A, a 128 x 32 float32 box of c2 through the
//     4-D map, split by each consumer thread in registers (wgmma takes A
//     from registers), and B's big and small halves, a 3-d box each from
//     w_split; each stage's 12 products go to a fresh accumulator that the
//     CUDA cores add to the float32 sum (one accumulator over K = C would
//     truncate at every add);
//   - tiles walk in groups of 16 row tiles, so the tiles in flight keep
//     ~16 MB of c2 and w_split hot in L2 (N fastest would span all of
//     w_split, 33.5 MB);
//   - a ring stage is 48 KB, so the 64 KB c1, x1 and staging boxes of
//     bf16 do not fit beside it: 8 stages before a tile's end the producer
//     prefetches the tile's c1 and x1 into L2 (TMA prefetch), and the
//     epilogue reads them from there and writes f1 from registers as
//     8-byte pairs (a warp's store is four runs of 64 bytes);
//   c1 and x1 NCHW or channels-last, every outer stride a multiple of 16
//   bytes, as in bf16. Shared memory: ring 4 x 48 KB + barriers and
//   alignment 2 KB = 198,656 bytes.
#include "common.cuh"
#include "wgmma.cuh"

namespace msa {

// ---------------------------------------------------------------- bf16

constexpr int kPsTileM = 128;   // pixels of one c2 row a tile
constexpr int kPsTileN = 128;   // product columns a tile: 32 channels x 4
constexpr int kPsTileO = kPsTileN / 4;
constexpr int kPsDepth = 64;    // reduction a stage: one 128-byte row
constexpr int kPsStages = 4;
constexpr int kPsThreads = 384;  // two consumer warpgroups and a producer

enum PsLayout : int { kNchw = 0, kChannelsLast = 1 };

// Byte offsets in the block's shared memory (1024-aligned base). A ring
// stage holds A (128 pixels x 64 k, K-major) and B (64 k x 128 columns:
// two MN-major slabs of 64 columns). The c1, x1 and staging tiles each
// hold a tile's output box, one 16 KB half per consumer warpgroup (its 64
// pixels: 128 output columns x 2 rows x 32 channels).
struct PsSmem {
  static constexpr int kA = kPsTileM * kPsDepth * 2;  // 16 KB
  static constexpr int kBSlab = kPsDepth * 64 * 2;    // 8 KB
  static constexpr int kStage = kA + 2 * kBSlab;      // 32 KB
  static constexpr int kBox = kPsTileM * kPsTileN * 2;  // 32 KB
  static constexpr int kHalf = kBox / 2;
  static constexpr int kC1 = kPsStages * kStage;
  static constexpr int kX1 = kC1 + kBox;
  static constexpr int kOut = kX1 + kBox;
  static constexpr int kBars = kOut + kBox;
  static constexpr int kBytes = kBars + 1024 + 1024;  // barriers, alignment
};
static_assert(PsSmem::kBytes <= 232448, "K6 tile overflows shared memory");

// Byte offset of output element (channel ch < 32, row dy < 2, column
// ox < 128) in a warpgroup's half of a c1, x1 or staging tile.
// NCHW: two TMA boxes of 64 columns x 2 rows x 32 channels (8 KB each),
// 128-byte rows (ch, dy), 16-byte unit u of row r at u ^ (r % 8).
__device__ __forceinline__ int ps_nchw_offset(int ch, int dy, int ox) {
  const int r = ch * 2 + dy;
  const int x = ox & 63;
  return (ox >> 6) * 8192 + r * 128 + (((x >> 3) ^ (r & 7)) << 4) +
         (x & 7) * 2;
}

// Channels-last: one TMA box of 32 channels x 128 columns x 2 rows, 64-byte
// rows (dy, ox), 16-byte unit u of row r at u ^ ((r / 2) % 4).
__device__ __forceinline__ int ps_cl_offset(int ch, int dy, int ox) {
  const int r = dy * 128 + ox;
  return r * 64 + (((ch >> 3) ^ ((r >> 1) & 3)) << 4) + (ch & 7) * 2;
}

// the two dx phases of (ch, dy) at column 2 m of a c1 or x1 half, as floats
template <int LAYOUT>
__device__ __forceinline__ float2 ps_load_pair(const unsigned char* half,
                                               int ch, int dy, int m) {
  if constexpr (LAYOUT == kNchw) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        half + ps_nchw_offset(ch, dy, 2 * m)));
  } else {
    return make_float2(
        __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
            half + ps_cl_offset(ch, dy, 2 * m))),
        __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
            half + ps_cl_offset(ch, dy, 2 * m + 1))));
  }
}

// The TMA loads of one tile's c1 or x1 box (output columns ox0 .., rows
// oy0, oy0 + 1, channels o0 ..), one half per consumer warpgroup.
template <int LAYOUT>
__device__ __forceinline__ void ps_load_box(unsigned char* dst,
                                            const CUtensorMap* map,
                                            uint64_t* bar, int ox0, int oy0,
                                            int o0, int b) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    unsigned char* d = dst + half * PsSmem::kHalf;
    const int ox = ox0 + half * 128;
    if constexpr (LAYOUT == kNchw) {
      tma_load_4d(d, map, bar, ox, oy0, o0, b);
      tma_load_4d(d + 8192, map, bar, ox + 64, oy0, o0, b);
    } else {
      tma_load_4d(d, map, bar, o0, ox, oy0, b);
    }
  }
}

struct PsParams {
  const float* scale;  // (O)
  const float* shift;  // (O)
  int B, H, W, C, O;
};

template <int C1_LAYOUT, int X1_LAYOUT>
__global__ void __launch_bounds__(kPsThreads, 1)
    pixel_shuffle_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                               const __grid_constant__ CUtensorMap b_map,
                               const __grid_constant__ CUtensorMap c1_map,
                               const __grid_constant__ CUtensorMap x1_map,
                               const __grid_constant__ CUtensorMap out_map,
                               const PsParams p) {
  using L = PsSmem;
  constexpr int STAGES = kPsStages;
  extern __shared__ __align__(1024) unsigned char ps_smem[];
  unsigned char* smem = ps_smem + ((1024 - (smem_u32(ps_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + STAGES;
  uint64_t* epi_full = empty + STAGES;  // c1 and x1 of the tile landed
  uint64_t* epi_empty = epi_full + 1;   // ... and were read

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int row_tiles = (p.W + kPsTileM - 1) / kPsTileM;  // per image row
  const int n_cols = 4 * p.O / kPsTileN;                  // column tiles
  const int n_tiles = p.B * p.H * row_tiles * n_cols;
  const int n_k = (p.C + kPsDepth - 1) / kPsDepth;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init(epi_full, 1);
    mbar_init(epi_empty, 256);
    mbar_init_fence();
  }
  __syncthreads();

  // tile -> (column tile, image b, c2 row h, first pixel w0), N fastest
  auto coords = [&](int tile, int& col, int& b, int& h, int& w0) {
    col = tile % n_cols;
    int r = tile / n_cols;
    w0 = (r % row_tiles) * kPsTileM;
    r /= row_tiles;
    h = r % p.H;
    b = r / p.H;
  };

  if (wg == 2) {
    // ---------------- producer: one thread issues every load; stage uses
    // are counted across tiles (it), so the ring runs on into the next
    // tile while the consumers store this one
    regs_release<24>();
    if (tid == 256) {
      const int t_epi = n_k - 1 < STAGES ? n_k - 1 : STAGES;
      int it = 0, lt = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++lt) {
        int col, b, h, w0;
        coords(tile, col, b, h, w0);
        const int n0 = col * kPsTileN;
        for (int t = 0; t < n_k; ++t, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
          unsigned char* st = smem + s * L::kStage;
          mbar_expect_tx(&full[s], L::kStage);
          tma_load_4d(st, &a_map, &full[s], t * kPsDepth, w0, h, b);
          tma_load_2d(st + L::kA, &b_map, &full[s], n0, t * kPsDepth);
          tma_load_2d(st + L::kA + L::kBSlab, &b_map, &full[s], n0 + 64,
                      t * kPsDepth);
          if (t == t_epi) {  // the previous tile's epilogue has read them
            if (lt > 0) mbar_wait(epi_empty, (lt - 1) & 1);
            mbar_expect_tx(epi_full, 2 * L::kBox);
            ps_load_box<C1_LAYOUT>(smem + L::kC1, &c1_map, epi_full, 2 * w0,
                                   2 * h, col * kPsTileO, b);
            ps_load_box<X1_LAYOUT>(smem + L::kX1, &x1_map, epi_full, 2 * w0,
                                   2 * h, col * kPsTileO, b);
          }
        }
      }
    }
    return;
  }

  // ---------------- consumers: 64 pixels each
  regs_claim<240>();
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int dy = t4 & 1;        // a thread's columns 8 j + 2 t4 + dx are
  const int ch_odd = t4 >> 1;   // channel 2 j + ch_odd, phase (dy, dx)
  const unsigned char* c1_s = smem + L::kC1 + wg * L::kHalf;
  const unsigned char* x1_s = smem + L::kX1 + wg * L::kHalf;
  unsigned char* out_s = smem + L::kOut + wg * L::kHalf;
  float acc[kPsTileN / 2];
  int it = 0, lt = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++lt) {
    int col, b, h, w0;
    coords(tile, col, b, h, w0);
    for (int t = 0; t < n_k; ++t, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const unsigned char* st = smem + s * L::kStage;
      const uint64_t da = make_desc<kPsDepth>(st + wg * 64 * kPsDepth * 2);
      const uint64_t db = make_desc_mn(st + L::kA, L::kBSlab);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kPsDepth / 16; ++k)  // a k16 step: A 32 bytes on,
        WgmmaSSTransB<kPsTileN>::run(          // B 16 rows (2048 bytes)
            acc, da + 2 * k, db + 128 * k, t > 0 || k > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      if (t > 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    wgmma_wait<0>();
    mbar_arrive(&empty[(it - 1) % STAGES]);
    fence_regs(acc);

    // ---------------- epilogue: thread rows 16 warp + g (+ 8) of the
    // warpgroup's 64 pixels; accumulator 4 j + 2 i + dx is channel 2 j +
    // ch_odd, phase (dy, dx) of pixel 16 warp + g + 8 i
    const int o0 = col * kPsTileO;
    mbar_wait(epi_full, lt & 1);
    if ((tid & 127) == 0) tma_store_wait_read<0>();  // the last tile's store
    named_sync(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < kPsTileN / 8; ++j) {
      const int ch = 2 * j + ch_odd;
      const float sc = __ldg(p.scale + o0 + ch);
      const float sh = __ldg(p.shift + o0 + ch);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = warp * 16 + g + 8 * i;
        const float2 c1v = ps_load_pair<C1_LAYOUT>(c1_s, ch, dy, m);
        const float2 x1v = ps_load_pair<X1_LAYOUT>(x1_s, ch, dy, m);
        const float v0 = (acc[4 * j + 2 * i] + c1v.x + x1v.x) * sc + sh;
        const float v1 = (acc[4 * j + 2 * i + 1] + c1v.y + x1v.y) * sc + sh;
        *reinterpret_cast<uint32_t*>(out_s + ps_nchw_offset(ch, dy, 2 * m)) =
            pack_bf16x2(v0, v1);
      }
    }
    mbar_arrive(epi_empty);  // this thread's c1 and x1 reads are done
    fence_proxy_async();
    named_sync(1 + wg, 128);
    if ((tid & 127) == 0) {  // TMA drops what lies past 2W
      const int ox = 2 * w0 + wg * 128;
      tma_store_4d(&out_map, out_s, ox, 2 * h, o0, b);
      tma_store_4d(&out_map, out_s + 8192, ox + 64, 2 * h, o0, b);
      tma_store_commit();
    }
  }
  if ((tid & 127) == 0) tma_store_wait_read<0>();
}

// a (B, O, OH, OW) map with element strides s (NCHW-like: s[3] == 1, or
// channels-last: s[1] == 1) as a TMA map with the box of its layout
inline bool encode_output_box(CUtensorMap* map, const void* base, int layout,
                              int B, int O, int OH, int OW,
                              const long long* s) {
  if (layout == kNchw) {
    const cuuint64_t dims[4] = {(cuuint64_t)OW, (cuuint64_t)OH,
                                (cuuint64_t)O, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)s[2] * 2, (cuuint64_t)s[1] * 2,
                                   (cuuint64_t)s[0] * 2};
    const cuuint32_t box[4] = {64, 2, kPsTileO, 1};
    return encode_map(map, base, 4, dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  }
  const cuuint64_t dims[4] = {(cuuint64_t)O, (cuuint64_t)OW, (cuuint64_t)OH,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s[3] * 2, (cuuint64_t)s[2] * 2,
                                 (cuuint64_t)s[0] * 2};
  const cuuint32_t box[4] = {kPsTileO, 128, 2, 1};
  return encode_map(map, base, 4, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_64B);
}

// true: element strides s of a (B, O, OH, OW) operand are of `layout` with
// every outer stride a multiple of 16 bytes (TMA's rule), `unit` values
// (8 bf16, 4 float32)
inline bool layout_ok(int layout, const long long* s, int unit) {
  if (layout == kNchw)
    return s[3] == 1 && s[2] % unit == 0 && s[1] % unit == 0 &&
           s[0] % unit == 0;
  if (layout == kChannelsLast)
    return s[1] == 1 && s[3] % unit == 0 && s[2] % unit == 0 &&
           s[0] % unit == 0;
  return false;
}

template <int C1_LAYOUT, int X1_LAYOUT>
cudaError_t launch_bf16(const CUtensorMap* maps, const PsParams& p, int grid,
                        cudaStream_t s) {
  auto kernel = pixel_shuffle_wgmma_kernel<C1_LAYOUT, X1_LAYOUT>;
  static int granted[kMaxDevices] = {};
  const cudaError_t err = reserve_smem(kernel, PsSmem::kBytes, granted);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kPsThreads, PsSmem::kBytes, s>>>(maps[0], maps[1], maps[2],
                                                  maps[3], maps[4], p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- float32

constexpr int kPsF32Depth = 32;   // reduction a stage: one 128-byte row
constexpr int kPsF32Stages = 4;
constexpr int kPsF32Group = 16;   // row tiles a group of the tile walk
constexpr int kPsF32Prefetch = 8;  // stages before a tile's end: c1, x1 to L2
constexpr int kPsF32EpiJ = 8;     // epilogue: j (2 channels) of a chunk

// Byte offsets in the block's shared memory (1024-aligned base). A ring
// stage holds A (128 pixels x 32 k, K-major) and B's big and small TF32
// halves (128 columns x 32 k each, K-major). No c1, x1 or staging tile:
// the epilogue reads c1 and x1 from L2 and writes f1 from registers.
//   ring 4 x 48 KB + barriers and alignment 2 KB = 198,656 bytes
struct PsF32Smem {
  static constexpr int kA = kPsTileM * kPsF32Depth * 4;  // 16 KB
  static constexpr int kB = kPsTileN * kPsF32Depth * 4;  // 16 KB a half
  static constexpr int kStage = kA + 2 * kB;             // 48 KB
  static constexpr int kBars = kPsF32Stages * kStage;
  static constexpr int kBytes = kBars + 1024 + 1024;  // barriers, alignment
};
static_assert(PsF32Smem::kBytes <= 232448,
              "K6 float32 tile overflows shared memory");

// The weight (C x 4O row-major: MN-major for B, which .tf32 wgmma cannot
// read) transposed to K-major and split into its TF32 halves, w_split
// (2, 4O, C) = [big, small]. A 32 x 32 tile a block, through shared
// memory, so that the reads (rows of W) and the writes (rows of w_split)
// are whole 128-byte lines.
constexpr int kPsSplitTile = 32;

__global__ void __launch_bounds__(256)
    pixel_shuffle_split_kernel(const float* __restrict__ wt,
                               float* __restrict__ ws, int C, int N) {
  __shared__ float t[kPsSplitTile][kPsSplitTile + 1];
  const int n0 = blockIdx.x * kPsSplitTile;
  const int k0 = blockIdx.y * kPsSplitTile;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  for (int r = ty; r < kPsSplitTile; r += 8) {
    const int k = k0 + r;
    t[r][tx] = k < C ? __ldg(wt + (size_t)k * N + n0 + tx) : 0.f;
  }
  __syncthreads();
  const int k = k0 + tx;
  if (k >= C) return;
  for (int r = ty; r < kPsSplitTile; r += 8) {
    uint32_t big, small;
    split_tf32(t[tx][r], big, small);
    const size_t i = (size_t)(n0 + r) * C + k;
    ws[i] = __uint_as_float(big);
    ws[(size_t)N * C + i] = __uint_as_float(small);
  }
}

struct PsF32Params {
  const float* c1;
  long long c1_s[4];  // element strides of (B, O, 2H, 2W)
  const float* x1;
  long long x1_s[4];
  const float* scale;  // (O)
  const float* shift;  // (O)
  float* out;          // (B, O, 2H, 2W) contiguous
  int B, H, W, C, O;
};

// c1 or x1 at the two dx phases of (b, o, oy, ox), ox even: NCHW, one
// 8-byte load; channels-last, two loads s[3] apart
template <int LAYOUT>
__device__ __forceinline__ float2 ps_f32_pair(const float* t,
                                              const long long* s, int b,
                                              int o, int oy, int ox) {
  const float* q = t + b * s[0] + o * s[1] + oy * s[2] + ox * s[3];
  if constexpr (LAYOUT == kNchw) {
    return __ldg(reinterpret_cast<const float2*>(q));
  } else {
    return make_float2(__ldg(q), __ldg(q + s[3]));
  }
}

// The L2 prefetch of one tile's c1 or x1 region (output columns ox0 ..
// ox0 + 255, rows oy0, oy0 + 1, channels o0 .. o0 + 31), in the boxes of
// `encode_prefetch_box`; boxes wholly past the row are skipped
template <int LAYOUT>
__device__ __forceinline__ void ps_prefetch(const CUtensorMap* map, int ox0,
                                            int oy0, int o0, int b, int OW) {
  constexpr int kStep = LAYOUT == kNchw ? 32 : 128;  // columns a box
#pragma unroll
  for (int x = 0; x < 2 * kPsTileM; x += kStep) {
    if (ox0 + x >= OW) break;
    if constexpr (LAYOUT == kNchw)
      tma_prefetch_4d(map, ox0 + x, oy0, o0, b);
    else
      tma_prefetch_4d(map, o0, ox0 + x, oy0, b);
  }
}

// float32: the bf16 kernel's tiles and roles, the product in 3xTF32 on
// .tf32 wgmma m64n128k8. A (c2) crosses memory once as float32: each
// consumer thread reads its fragment of the stage from the swizzled tile
// and splits it in registers; B's halves come split from w_split. A
// stage's 12 products go to a fresh accumulator, added into the tile's
// float32 sum on the CUDA cores (the tensor cores' own accumulation
// truncates, so one accumulator over K = C would err in proportion to C).
template <int C1_LAYOUT, int X1_LAYOUT>
__global__ void __launch_bounds__(kPsThreads, 1)
    pixel_shuffle_tf32_kernel(const __grid_constant__ CUtensorMap a_map,
                              const __grid_constant__ CUtensorMap b_map,
                              const __grid_constant__ CUtensorMap c1_map,
                              const __grid_constant__ CUtensorMap x1_map,
                              const __grid_constant__ PsF32Params p) {
  using L = PsF32Smem;
  constexpr int STAGES = kPsF32Stages;
  extern __shared__ __align__(1024) unsigned char ps32_smem[];
  unsigned char* smem =
      ps32_smem + ((1024 - (smem_u32(ps32_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int row_tiles = (p.W + kPsTileM - 1) / kPsTileM;  // per image row
  const int rows = p.B * p.H * row_tiles;                 // row tiles
  const int n_cols = 4 * p.O / kPsTileN;                  // column tiles
  const int n_tiles = rows * n_cols;
  const int n_k = (p.C + kPsF32Depth - 1) / kPsF32Depth;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // tile -> (column tile, image b, c2 row h, first pixel w0): groups of
  // kPsF32Group row tiles, rows fastest within a group, so that the 132
  // tiles in flight share ~16 row tiles of c2 (8 MB) and ~8 column slabs
  // of w_split (8 MB) in L2, where N fastest would keep all of w_split
  // (4 * 4O * C bytes, 33.5 MB at the flagship) in use
  auto coords = [&](int tile, int& col, int& b, int& h, int& w0) {
    const int g0 = tile / (kPsF32Group * n_cols) * kPsF32Group;
    const int in_group = min(kPsF32Group, rows - g0);
    const int local = tile - g0 * n_cols;
    int r = g0 + local % in_group;
    col = local / in_group;
    w0 = (r % row_tiles) * kPsTileM;
    r /= row_tiles;
    h = r % p.H;
    b = r / p.H;
  };

  if (wg == 2) {
    // ---------------- producer: one thread issues every load
    regs_release<24>();
    if (tid == 256) {
      const int t_pre = n_k > kPsF32Prefetch ? n_k - kPsF32Prefetch : 0;
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        int col, b, h, w0;
        coords(tile, col, b, h, w0);
        const int n0 = col * kPsTileN;
        for (int t = 0; t < n_k; ++t, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
          unsigned char* st = smem + s * L::kStage;
          mbar_expect_tx(&full[s], L::kStage);
          tma_load_4d(st, &a_map, &full[s], t * kPsF32Depth, w0, h, b);
          tma_load_3d(st + L::kA, &b_map, &full[s], t * kPsF32Depth, n0, 0);
          tma_load_3d(st + L::kA + L::kB, &b_map, &full[s], t * kPsF32Depth,
                      n0, 1);
          if (t == t_pre) {  // what the tile's epilogue reads, into L2
            ps_prefetch<C1_LAYOUT>(&c1_map, 2 * w0, 2 * h, col * kPsTileO, b,
                                   2 * p.W);
            ps_prefetch<X1_LAYOUT>(&x1_map, 2 * w0, 2 * h, col * kPsTileO, b,
                                   2 * p.W);
          }
        }
      }
    }
    return;
  }

  // ---------------- consumers: 64 pixels each
  regs_claim<240>();
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int dy = t4 & 1;        // a thread's columns 8 j + 2 t4 + dx are
  const int ch_odd = t4 >> 1;   // channel 2 j + ch_odd, phase (dy, dx)
  const int OH = 2 * p.H, OW = 2 * p.W;
  float acc[kPsTileN / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int col, b, h, w0;
    coords(tile, col, b, h, w0);
#pragma unroll
    for (int i = 0; i < kPsTileN / 2; ++i) acc[i] = 0.f;
    for (int t = 0; t < n_k; ++t, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const unsigned char* st = smem + s * L::kStage;
      // this thread's A fragment of each k8 step (pixels warp * 16 + g and
      // + 8 of the warpgroup's 64, k 8 ks + t4 and + 4) from the swizzled
      // tile (16-byte unit u of row r at u ^ (r % 8), r % 8 = g: a warp's
      // loads hit 32 banks), split into its TF32 halves
      const float* a_s = reinterpret_cast<const float*>(st) + wg * 64 * 32;
      uint32_t big[4][4], small[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = warp * 16 + g + 8 * (e & 1);
          const int u = 2 * ks + (e >> 1);
          split_tf32(a_s[r * 32 + ((u ^ g) << 2) + t4], big[ks][e],
                     small[ks][e]);
        }
      // descriptors: rows of 128 bytes, make_desc's 64 bf16 values
      const uint64_t db = make_desc<64>(st + L::kA);           // B big
      const uint64_t ds = make_desc<64>(st + L::kA + L::kB);   // B small
      float part[kPsTileN / 2];  // the stage's sum
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {  // a k8 step is 32 bytes
        WgmmaTf32<kPsTileN>::run(part, big[ks], ds + 2 * ks, ks > 0);
        WgmmaTf32<kPsTileN>::run(part, small[ks], db + 2 * ks, 1);
        WgmmaTf32<kPsTileN>::run(part, big[ks], db + 2 * ks, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();  // the stage's registers are rewritten next
      fence_regs(part);
      mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < kPsTileN / 2; ++i) acc[i] += part[i];
    }

    // ---------------- epilogue: thread rows 16 warp + g (+ 8) of the
    // warpgroup's 64 pixels; accumulator 4 j + 2 i + dx is channel 2 j +
    // ch_odd, phase (dy, dx) of pixel 16 warp + g + 8 i. c1 and x1 come
    // from L2 (the producer prefetched them), kPsF32EpiJ values of j at a
    // time, all of a chunk's loads in flight before its first store (an L2
    // read waits ~0.4 us here: one at a time, they cost the flagship 0.38
    // ms); f1 goes out as 8-byte pairs, a warp's store four runs of 64
    // bytes. Pixels past W are skipped.
    const int o0 = col * kPsTileO;
    const int oy = 2 * h + dy;
    const int wr = w0 + wg * 64 + warp * 16 + g;  // the thread's pixel, i = 0
#pragma unroll
    for (int j0 = 0; j0 < kPsTileN / 8; j0 += kPsF32EpiJ) {
      float2 c1v[kPsF32EpiJ][2], x1v[kPsF32EpiJ][2];
      float sc[kPsF32EpiJ], sh[kPsF32EpiJ];
#pragma unroll
      for (int jj = 0; jj < kPsF32EpiJ; ++jj) {
        const int o = o0 + 2 * (j0 + jj) + ch_odd;
        sc[jj] = __ldg(p.scale + o);
        sh[jj] = __ldg(p.shift + o);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int w = wr + 8 * i;
          c1v[jj][i] = x1v[jj][i] = make_float2(0.f, 0.f);
          if (w < p.W) {
            c1v[jj][i] = ps_f32_pair<C1_LAYOUT>(p.c1, p.c1_s, b, o, oy, 2 * w);
            x1v[jj][i] = ps_f32_pair<X1_LAYOUT>(p.x1, p.x1_s, b, o, oy, 2 * w);
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < kPsF32EpiJ; ++jj) {
        const int j = j0 + jj;
        const int o = o0 + 2 * j + ch_odd;
        float* orow = p.out + (((size_t)b * p.O + o) * OH + oy) * OW;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int w = wr + 8 * i;
          if (w >= p.W) continue;
          float2 v;
          v.x = (acc[4 * j + 2 * i] + c1v[jj][i].x + x1v[jj][i].x) * sc[jj] +
                sh[jj];
          v.y = (acc[4 * j + 2 * i + 1] + c1v[jj][i].y + x1v[jj][i].y) *
                    sc[jj] +
                sh[jj];
          *reinterpret_cast<float2*>(orow + 2 * w) = v;
        }
      }
    }
  }
}

// a float32 (B, O, OH, OW) operand's map for the L2 prefetch of a tile's
// region: NCHW, boxes of 32 columns x 2 rows x 32 channels; channels-last,
// 32 channels x 128 columns x 2 rows (128-byte inner rows either way)
inline bool encode_prefetch_box(CUtensorMap* map, const void* base,
                                int layout, int B, int O, int OH, int OW,
                                const long long* s) {
  if (layout == kNchw) {
    const cuuint64_t dims[4] = {(cuuint64_t)OW, (cuuint64_t)OH,
                                (cuuint64_t)O, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)s[2] * 4, (cuuint64_t)s[1] * 4,
                                   (cuuint64_t)s[0] * 4};
    const cuuint32_t box[4] = {32, 2, kPsTileO, 1};
    return encode_map(map, base, 4, dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_NONE,
                      CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  }
  const cuuint64_t dims[4] = {(cuuint64_t)O, (cuuint64_t)OW, (cuuint64_t)OH,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s[3] * 4, (cuuint64_t)s[2] * 4,
                                 (cuuint64_t)s[0] * 4};
  const cuuint32_t box[4] = {kPsTileO, 128, 2, 1};
  return encode_map(map, base, 4, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_NONE,
                    CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

template <int C1_LAYOUT, int X1_LAYOUT>
cudaError_t launch_f32(const CUtensorMap* maps, const PsF32Params& p,
                       int grid, cudaStream_t s) {
  auto kernel = pixel_shuffle_tf32_kernel<C1_LAYOUT, X1_LAYOUT>;
  static int granted[kMaxDevices] = {};
  const cudaError_t err = reserve_smem(kernel, PsF32Smem::kBytes, granted);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kPsThreads, PsF32Smem::kBytes, s>>>(maps[0], maps[1],
                                                     maps[2], maps[3], p);
  return cudaGetLastError();
}

}  // namespace msa

// c2: pixel rows of C values, image b at c2 + b * c2_bs; wt (C, O, 2, 2);
// c1, x1 (B, O, 2H, 2W) with element strides c1_s*, x1_s*; scale, shift (O)
// float32; out (B, O, 2H, 2W) contiguous; float32 also takes w_split
// (2, 4O, C) float32 scratch for the weight's TF32 halves. C % 8 == 0,
// O % 32 == 0. The plan (ops/pixel_shuffle.py:pixel_shuffle_plan) gives the
// tile, the grid, the layouts of c1 and x1 (0 NCHW-like, 1 channels-last)
// and the shared memory; a plan the kernels were not built for is refused.
// Returns the first error.
extern "C" int msa_pixel_shuffle_up_bn(
    const void* c2, long long c2_bs, const void* wt, const void* c1,
    long long c1_s0, long long c1_s1, long long c1_s2, long long c1_s3,
    const void* x1, long long x1_s0, long long x1_s1, long long x1_s2,
    long long x1_s3, const void* scale, const void* shift, void* out,
    void* w_split, int batch, int H, int W, int C, int O, int tile_m,
    int tile_n, int grid, int c1_layout, int x1_layout, int smem_bytes,
    int dtype, void* stream) {
  if (C % 8 || O % 32 || C <= 0 || O <= 0 || batch < 0 || H < 0 || W < 0)
    return cudaErrorInvalidValue;
  const long long c1_s[4] = {c1_s0, c1_s1, c1_s2, c1_s3};
  const long long x1_s[4] = {x1_s0, x1_s1, x1_s2, x1_s3};
  const long long M = (long long)batch * H * W;
  const long long tiles = (long long)batch * H *
                          ((W + msa::kPsTileM - 1) / msa::kPsTileM) *
                          (4 * O / msa::kPsTileN);
  if (tile_m != msa::kPsTileM || tile_n != msa::kPsTileN || grid < 0 ||
      grid > tiles || (tiles > 0 && grid == 0))
    return cudaErrorInvalidValue;
  const int OH = 2 * H, OW = 2 * W;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == msa::kBFloat16) {
    if (smem_bytes != msa::PsSmem::kBytes || c2_bs % 8 ||
        !msa::layout_ok(c1_layout, c1_s, 8) ||
        !msa::layout_ok(x1_layout, x1_s, 8))
      return cudaErrorInvalidValue;
    if (M == 0) return cudaSuccess;
    const long long out_s[4] = {(long long)O * OH * OW, (long long)OH * OW,
                                OW, 1};
    CUtensorMap maps[5];
    const cuuint64_t a_dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                                  (cuuint64_t)batch};
    const cuuint64_t a_strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                     (cuuint64_t)c2_bs * 2};
    const cuuint32_t a_box[4] = {msa::kPsDepth, msa::kPsTileM, 1, 1};
    const cuuint64_t b_dims[2] = {(cuuint64_t)4 * O, (cuuint64_t)C};
    const cuuint64_t b_strides[1] = {(cuuint64_t)4 * O * 2};
    const cuuint32_t b_box[2] = {64, msa::kPsDepth};
    if (!msa::encode_map(&maps[0], c2, 4, a_dims, a_strides, a_box,
                         CU_TENSOR_MAP_SWIZZLE_128B) ||
        !msa::encode_map(&maps[1], wt, 2, b_dims, b_strides, b_box,
                         CU_TENSOR_MAP_SWIZZLE_128B) ||
        !msa::encode_output_box(&maps[2], c1, c1_layout, batch, O, OH, OW,
                                c1_s) ||
        !msa::encode_output_box(&maps[3], x1, x1_layout, batch, O, OH, OW,
                                x1_s) ||
        !msa::encode_output_box(&maps[4], out, msa::kNchw, batch, O, OH, OW,
                                out_s))
      return cudaErrorInvalidValue;
    msa::PsParams p;
    p.scale = static_cast<const float*>(scale);
    p.shift = static_cast<const float*>(shift);
    p.B = batch, p.H = H, p.W = W, p.C = C, p.O = O;
    switch (c1_layout * 2 + x1_layout) {
      case 0: return msa::launch_bf16<msa::kNchw, msa::kNchw>(maps, p, grid, s);
      case 1:
        return msa::launch_bf16<msa::kNchw, msa::kChannelsLast>(maps, p, grid,
                                                                s);
      case 2:
        return msa::launch_bf16<msa::kChannelsLast, msa::kNchw>(maps, p, grid,
                                                                s);
      default:
        return msa::launch_bf16<msa::kChannelsLast, msa::kChannelsLast>(
            maps, p, grid, s);
    }
  }
  if (dtype != msa::kFloat32 || w_split == nullptr ||
      smem_bytes != msa::PsF32Smem::kBytes || c2_bs % 4 ||
      !msa::layout_ok(c1_layout, c1_s, 4) ||
      !msa::layout_ok(x1_layout, x1_s, 4))
    return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  const int N = 4 * O;
  CUtensorMap maps[4];
  const cuuint64_t a_dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                                (cuuint64_t)batch};
  const cuuint64_t a_strides[3] = {(cuuint64_t)C * 4, (cuuint64_t)W * C * 4,
                                   (cuuint64_t)c2_bs * 4};
  const cuuint32_t a_box[4] = {msa::kPsF32Depth, msa::kPsTileM, 1, 1};
  // w_split's halves, one 3-d box each: (C, 4O, 2), K innermost
  const cuuint64_t b_dims[3] = {(cuuint64_t)C, (cuuint64_t)N, 2};
  const cuuint64_t b_strides[2] = {(cuuint64_t)C * 4, (cuuint64_t)N * C * 4};
  const cuuint32_t b_box[3] = {msa::kPsF32Depth, msa::kPsTileN, 1};
  if (!msa::encode_map(&maps[0], c2, 4, a_dims, a_strides, a_box,
                       CU_TENSOR_MAP_SWIZZLE_128B,
                       CU_TENSOR_MAP_DATA_TYPE_FLOAT32) ||
      !msa::encode_map(&maps[1], w_split, 3, b_dims, b_strides, b_box,
                       CU_TENSOR_MAP_SWIZZLE_128B,
                       CU_TENSOR_MAP_DATA_TYPE_FLOAT32) ||
      !msa::encode_prefetch_box(&maps[2], c1, c1_layout, batch, O, OH, OW,
                                c1_s) ||
      !msa::encode_prefetch_box(&maps[3], x1, x1_layout, batch, O, OH, OW,
                                x1_s))
    return cudaErrorInvalidValue;
  msa::pixel_shuffle_split_kernel<<<
      dim3(N / msa::kPsSplitTile,
           (C + msa::kPsSplitTile - 1) / msa::kPsSplitTile),
      256, 0, s>>>(static_cast<const float*>(wt), static_cast<float*>(w_split),
                   C, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  msa::PsF32Params p;
  p.c1 = static_cast<const float*>(c1);
  p.x1 = static_cast<const float*>(x1);
  for (int i = 0; i < 4; ++i) p.c1_s[i] = c1_s[i], p.x1_s[i] = x1_s[i];
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.out = static_cast<float*>(out);
  p.B = batch, p.H = H, p.W = W, p.C = C, p.O = O;
  switch (c1_layout * 2 + x1_layout) {
    case 0: return msa::launch_f32<msa::kNchw, msa::kNchw>(maps, p, grid, s);
    case 1:
      return msa::launch_f32<msa::kNchw, msa::kChannelsLast>(maps, p, grid, s);
    case 2:
      return msa::launch_f32<msa::kChannelsLast, msa::kNchw>(maps, p, grid, s);
    default:
      return msa::launch_f32<msa::kChannelsLast, msa::kChannelsLast>(maps, p,
                                                                     grid, s);
  }
}
