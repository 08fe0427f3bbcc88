// One ConvNeXt block: depthwise 7x7 conv (zero padding) + bias ->
// LayerNorm over C (float32 statistics, eps) -> fc1 + bias -> exact (erf)
// GELU -> fc2 + bias -> layer scale gamma -> + shortcut. The 72 blocks of
// the twin ConvNeXt-small trunk (36 per branch) run it once each. With a
// null shortcut (delta-only mode, for training, where drop path acts on
// the delta before the add) the add is skipped and out is the delta.
//
// Replaces: multimodal_sam_adapter_tpu/ops/convnext_block.py,
//   convnext_block_fused_fwd (Pallas kernel _kernel). Same arithmetic and
//   rounding points (bf16: xn and h rounded to bf16, float32 accumulation,
//   one rounding of the output), one difference of contract: this returns
//   the block output (the shortcut added), where the TPU kernel returns the
//   pre-residual delta and leaves the add to XLA. The TPU kernel's seven
//   shifted copies of x (its W % 8 == 0 sublane alignment) and its
//   moments-by-matmul are Mosaic workarounds; here a tile reads its input
//   with a 3-pixel halo that is zero outside the image, so any H and W work.
//
// Layouts: x and out (B, H, W, C) contiguous (channels last), P = B H W
// pixel rows of C; dw (C, 1, 7, 7) and the Linear weights w1 (HID, C), w2
// (C, HID) as torch stores them. For each output column the reduction axis
// is contiguous (K-major), which is what wgmma's B operand takes, so no
// weight is transposed.
//
// What bounds it on an H100: the two products, 16 P C^2 FLOP (9.7 GFLOP at
// every stage of the flagship trunk, ~10 us at 989 TFLOP/s), and the
// bytes around them: x read, xn and h written and read back, out written.
//
// Why the bf16 block is unfused on this card. The TPU kernel fuses the
// whole block because its grid runs in order and VMEM holds an image's
// hidden map. On 132 SMs a fused block can only split pixels, and its
// float32 y accumulator (pixels x C) has to fit in registers: 32-pixel
// tiles above C = 192, each streaming all of w1 and w2 (16 C^2 bytes, 2.36
// MB at C = 384) from L2, 302 MB a call at 64^2 x 384 (5.6x the
// tensor-core bound by itself, 32 FLOP a weight byte); at 32^2 x 768 only
// 32 tiles. Unfused, the hidden map h (P x 4C, bf16) is 12.6 MB at 64^2 x
// 384 and 6.3 MB at 32^2 x 768, well inside the 50 MB L2, so writing and
// reading it back costs microseconds; at 256^2 x 96 (50 MB) and 128^2 x
// 192 (25 MB) it round-trips device memory (>= 49 and >= 25 us). Two GEMMs
// of 128-row tiles then give 96-1536 tiles a call, each weight byte feeds
// 128 rows, and the weights come by TMA.
//
// Design (bf16), three launches from one C entry (msa_convnext_block):
//   1. convnext_block_prologue_kernel<TH>: one block of 8 warps per TH x 8
//      pixel tile, TH chosen by the caller's plan (ops/convnext_block.py)
//      so that the grid holds >= 132 blocks where the map allows. Every
//      channel at once: the block stages the raw taps in shared memory; a
//      thread takes a channel pair and a block of <= 8 outputs of the tile,
//      loads all of their inputs into registers at once (x through L1) and
//      runs the 49 taps over them, into a float32 tile. One warp per
//      pixel then computes the LayerNorm (two passes, float32) and writes
//      the normalised row as bf16: xn (P, C). CUDA-core work whose bound
//      is its bytes; what holds it back is load latency and the threads
//      in flight. (Staging the halo 64 channels at a time, as the float32
//      kernel does, serialises one load round trip per slab: 55 us at 32^2
//      x 768 on an H100.)
//   2. convnext_block_fc_kernel<kFc1Gelu, 128>: h = bf16(gelu(xn w1^T +
//      b1)), (P, HID), erf by the TPU kernel's A&S formula (gelu_as).
//   3. convnext_block_fc_kernel<kFc2Residual, BN>: out = bf16(x + (h w2^T +
//      b2) gamma), BN from the plan (the narrowest width >= C up to 192;
//      above, 128 or 64 by the tile count).
//   The GEMM: one persistent block per SM walks 128 x BN output tiles. One
//   thread of a producer warpgroup (setmaxnreg gives its other registers to
//   the consumers) issues TMA loads of 128 x 64 A and BN x 64 B tiles,
//   both K-major with the 128-byte swizzle, into a ring of 3-7 stages with
//   a full and an empty mbarrier each, running on into the next tile while
//   the consumers store this one; two consumer warpgroups of 64 rows run
//   wgmma m64nBNk16 on the stages, keeping one stage's products in flight
//   while they wait for the next. Epilogues, float32 on the accumulator:
//   fc1 writes bf16 h into 128-byte-swizzled boxes that a TMA store takes
//   out; fc2 stages (acc + b2) gamma in padded shared memory and writes
//   whole rows of x + that with 16-byte stores. Ragged edges: TMA
//   zero-fills rows past P and N and the columns past K (C = 40 under a
//   64-wide box) on load and clips them on store; fc2's stores are masked.
// float32 runs on the CUDA cores in one fused kernel (4 x 4-pixel tiles,
// 16 hidden units a chunk, y accumulated in shared memory), for float32
// parity.
#include <type_traits>  // std::remove_pointer_t

#include "common.cuh"
#include "mma.cuh"  // cp.async
#include "wgmma.cuh"

namespace msa {

constexpr int kCbThreads = 256;  // 8 warps (prologue, float32 kernel)
constexpr int kCbDwCC = 64;      // channels per staged halo slab
constexpr int kCbF32HC = 16;     // hidden units per chunk (float32)
constexpr int kCbTileW = 8;      // prologue: pixel tile columns
// prologue: float32 dwconv outputs a tile keeps in shared memory (64 KiB),
// TH * 8 * C at most
constexpr int kCbTileValues = 16384;

struct CbArgs {
  const void* x;
  const void* dw;
  const void* dw_b;
  const void* ln_g;
  const void* ln_b;
  const void* w1;
  const void* b1;
  const void* w2;
  const void* b2;
  const void* gamma;
  const void* shortcut;  // null: out is the delta, no add
  void* out;
  int H, W, C, HID;
  float eps;
};

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// GELU with Abramowitz & Stegun 7.1.26 for erf (|error| <= 1.5e-7, the
// TPU kernel's own: convnext_block.py:_erf_approx), on the special-function
// unit's reciprocal and exp2: ~12 operations against erff's ~25.
__device__ __forceinline__ float gelu_as(float v) {
  const float z = v * 0.70710678118654752f;
  const float a = fabsf(z);
  float t;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(t)
      : "f"(fmaf(0.3275911f, a, 1.f)));
  const float poly =
      t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, 1.061405429f, -1.453152027f),
                               1.421413741f),
                       -0.284496736f),
               0.254829592f);
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;"
      : "=f"(e)
      : "f"(-a * a * 1.4426950408889634f));
  const float erf_a = fmaf(-poly, e, 1.f);
  return 0.5f * v * (1.f + copysignf(erf_a, z));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

__host__ __device__ inline int n_tiles(int batch, int H, int W, int TH,
                                       int TW) {
  return batch * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
}

// The block's spatial tile: image b, rows [h0, h0 + TH), cols [w0, w0 + TW).
struct Tile {
  int b, h0, w0;
};

template <int TH, int TW>
__device__ Tile block_tile(const CbArgs& a) {
  const int tw = (a.W + TW - 1) / TW;
  const int th = (a.H + TH - 1) / TH;
  int t = blockIdx.x;
  Tile r;
  r.b = t / (th * tw);
  t -= r.b * th * tw;
  r.h0 = (t / tw) * TH;
  r.w0 = (t - (t / tw) * tw) * TW;
  return r;
}

// Flat pixel index of tile row p (row-major in the tile), -1 outside the
// image.
template <int TW>
__device__ __forceinline__ int tile_pixel(const CbArgs& a, const Tile& tl,
                                          int p) {
  const int h = tl.h0 + p / TW;
  const int w = tl.w0 + p % TW;
  return h < a.H && w < a.W ? (tl.b * a.H + h) * a.W + w : -1;
}

template <typename T, int TH, int TW>
__host__ __device__ constexpr int halo_bytes() {
  return (TH + 6) * (TW + 6) * kCbDwCC * (int)sizeof(T);
}
constexpr int kCbTapBytes = 49 * kCbDwCC * 4;

// Depthwise 7x7 conv (zero padding) + bias of the tile into
// dst[p * ld + c] (float32, p = py * TW + px), 64 channels at a time from
// the staged halo (halo_bytes) and taps (kCbTapBytes). Starts and ends with
// other threads possibly reading dst's row data: the caller syncs after.
template <typename T, int TH, int TW>
__device__ void depthwise_tile(const CbArgs& a, const Tile& tl, float* dst,
                               int ld, T* halo, float* taps) {
  constexpr int HH = TH + 6;
  constexpr int HW = TW + 6;
  constexpr int VEC = 16 / sizeof(T);
  const T* x = static_cast<const T*>(a.x);
  const T* dw = static_cast<const T*>(a.dw);
  const T* dwb = static_cast<const T*>(a.dw_b);
  const int C = a.C;
  const int tid = threadIdx.x;
  for (int c0 = 0; c0 < C; c0 += kCbDwCC) {
    const int cc = min(kCbDwCC, C - c0);
    const int nv = cc / VEC;
    __syncthreads();  // the previous slab is consumed
    for (int i = tid; i < HH * HW * nv; i += kCbThreads) {
      const int pix = i / nv;
      const int v = i - pix * nv;
      const int hh = tl.h0 + pix / HW - 3;
      const int ww = tl.w0 + pix % HW - 3;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (hh >= 0 && hh < a.H && ww >= 0 && ww < a.W)
        val = *reinterpret_cast<const uint4*>(
            x + ((size_t)(tl.b * a.H + hh) * a.W + ww) * C + c0 + v * VEC);
      *reinterpret_cast<uint4*>(halo + pix * kCbDwCC + v * VEC) = val;
    }
    for (int i = tid; i < 49 * cc; i += kCbThreads) {
      const int c = i / 49;
      taps[(i - c * 49) * kCbDwCC + c] = to_float(dw[(size_t)c0 * 49 + i]);
    }
    __syncthreads();
    // one channel and one tile column per item: TH outputs
    for (int it = tid; it < TW * cc; it += kCbThreads) {
      const int px = it / cc;
      const int c = it - px * cc;
      float w[49];
#pragma unroll
      for (int k = 0; k < 49; ++k) w[k] = taps[k * kCbDwCC + c];
      const float bias = to_float(dwb[c0 + c]);
      float acc[TH];
#pragma unroll
      for (int py = 0; py < TH; ++py) acc[py] = bias;
#pragma unroll
      for (int r = 0; r < HH; ++r) {
#pragma unroll
        for (int dx = 0; dx < 7; ++dx) {
          const float v = to_float(halo[(r * HW + px + dx) * kCbDwCC + c]);
#pragma unroll
          for (int py = 0; py < TH; ++py) {
            const int dy = r - py;
            if (dy >= 0 && dy < 7) acc[py] += v * w[dy * 7 + dx];
          }
        }
      }
#pragma unroll
      for (int py = 0; py < TH; ++py)
        dst[(py * TW + px) * ld + c0 + c] = acc[py];
    }
  }
}

// LayerNorm over the C channels of each of the TP rows of src (float32, row
// stride lds), two passes in float32, one warp per row; row p's normalised
// values go to dst_row(p), a row of float32 or bf16 (none where it returns
// null). src and dst may be the same buffer: each lane rewrites only what
// it read.
template <typename T, typename RowFn>
__device__ void layernorm_tile(const CbArgs& a, int TP, const float* src,
                               int lds, RowFn dst_row) {
  using D = std::remove_pointer_t<decltype(dst_row(0))>;
  const T* g = static_cast<const T*>(a.ln_g);
  const T* bb = static_cast<const T*>(a.ln_b);
  const int C = a.C;
  const int lane = threadIdx.x & 31;
  for (int p = threadIdx.x >> 5; p < TP; p += kCbThreads / 32) {
    D* dst = dst_row(p);
    if (dst == nullptr) continue;
    const float* row = src + p * lds;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += row[c];
    const float mean = warp_sum(s) / C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = row[c] - mean;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / C + a.eps);
    for (int c = lane; c < C; c += 32)
      dst[c] = from_float<D>((row[c] - mean) * rstd * to_float(g[c]) +
                             to_float(bb[c]));
  }
}

// ---------------------------------------------------------------- bf16
__device__ __forceinline__ float2 load_bf16x2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// 1. the prologue: xn = LN(dwconv(x)), (P, C) bf16

// The outputs of one prologue item: SH rows x SW columns of a TH x 8 tile
// (for each of two channels), whose (SH + 6) x (SW + 6) inputs stay in
// registers, 70-80 of them.
template <int TH>
struct ProSub {
  static constexpr int SH = TH >= 4 ? 4 : TH;
  static constexpr int SW = TH >= 4 ? 2 : 4;
};

// Depthwise 7x7 conv (zero padding) + bias of a TH x 8 tile into dst[p * C
// + c] (float32, p = py * 8 + px), every channel at once. An item is one
// channel pair and one SH x SW block of the tile: it loads all of its
// inputs first (bf16 pairs through L1, a warp's 32 pairs one 128-byte
// line; all of them in flight at once), then runs the 49 taps over them,
// each tap pair read from shared memory in the raw (C, 49) layout (lane l
// reads words 49 l + k / 2: 32 banks, as 49 is odd).
template <int TH>
__device__ void depthwise_tile_bf16(const CbArgs& a, const Tile& tl,
                                    float* dst,
                                    const __nv_bfloat16* taps) {
  constexpr int SH = ProSub<TH>::SH, SW = ProSub<TH>::SW;
  constexpr int GW = kCbTileW / SW;        // item columns in the tile
  constexpr int ITEMS = (TH / SH) * GW;    // items of a channel pair
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const __nv_bfloat16* dwb = static_cast<const __nv_bfloat16*>(a.dw_b);
  const int C = a.C;
  const int pairs = C / 2;
  for (int it = threadIdx.x; it < pairs * ITEMS; it += kCbThreads) {
    const int grp = it / pairs;
    const int c = (it - grp * pairs) * 2;
    const int y0 = (grp / GW) * SH;  // the item's origin in the tile
    const int x0 = (grp % GW) * SW;
    uint32_t xv[SH + 6][SW + 6];     // bf16 pairs, zero outside the image
#pragma unroll
    for (int r = 0; r < SH + 6; ++r) {
      const int hh = tl.h0 + y0 + r - 3;
      const bool row_in = hh >= 0 && hh < a.H;
      const __nv_bfloat16* xrow =
          x + (ptrdiff_t)(tl.b * a.H + hh) * a.W * C + c;
#pragma unroll
      for (int cx = 0; cx < SW + 6; ++cx) {
        const int ww = tl.w0 + x0 + cx - 3;
        xv[r][cx] = row_in && ww >= 0 && ww < a.W
                        ? __ldg(reinterpret_cast<const unsigned int*>(
                              xrow + (ptrdiff_t)ww * C))
                        : 0u;
      }
    }
    const float2 bias = load_bf16x2(dwb + c);
    float acc[SH][SW][2];
#pragma unroll
    for (int py = 0; py < SH; ++py)
#pragma unroll
      for (int px = 0; px < SW; ++px) {
        acc[py][px][0] = bias.x;
        acc[py][px][1] = bias.y;
      }
    const __nv_bfloat16* t0 = taps + c * 49;
#pragma unroll
    for (int dy = 0; dy < 7; ++dy)
#pragma unroll
      for (int dx = 0; dx < 7; ++dx) {
        const float w0 = __bfloat162float(t0[dy * 7 + dx]);
        const float w1 = __bfloat162float(t0[49 + dy * 7 + dx]);
#pragma unroll
        for (int py = 0; py < SH; ++py)
#pragma unroll
          for (int px = 0; px < SW; ++px) {
            const uint32_t v = xv[py + dy][px + dx];  // channels c, c + 1
            acc[py][px][0] += __uint_as_float(v << 16) * w0;
            acc[py][px][1] += __uint_as_float(v & 0xffff0000u) * w1;
          }
      }
#pragma unroll
    for (int py = 0; py < SH; ++py)
#pragma unroll
      for (int px = 0; px < SW; ++px)
        *reinterpret_cast<float2*>(
            dst + ((y0 + py) * kCbTileW + x0 + px) * C + c) =
            make_float2(acc[py][px][0], acc[py][px][1]);
  }
}

template <int TH>
__global__ void __launch_bounds__(kCbThreads, 2)
    convnext_block_prologue_kernel(CbArgs a, __nv_bfloat16* xn) {
  using bf16 = __nv_bfloat16;
  constexpr int TP = TH * kCbTileW;
  extern __shared__ __align__(16) unsigned char pro_smem[];
  float* dwo = reinterpret_cast<float*>(pro_smem);  // [TP][C]
  bf16* taps = reinterpret_cast<bf16*>(pro_smem + TP * a.C * 4);  // [C][49]
  // the taps, as they lie in dw (C * 98 bytes, a multiple of 16), all in
  // flight at once
  for (int i = threadIdx.x; i < a.C * 49 / 8; i += kCbThreads)
    cp_async16(taps + 8 * i, static_cast<const bf16*>(a.dw) + 8 * i, true);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const Tile tl = block_tile<TH, kCbTileW>(a);
  depthwise_tile_bf16<TH>(a, tl, dwo, taps);
  __syncthreads();
  layernorm_tile<bf16>(a, TP, dwo, a.C, [&](int p) -> bf16* {
    const int P = tile_pixel<kCbTileW>(a, tl, p);
    return P < 0 ? nullptr : xn + (size_t)P * a.C;
  });
}

template <int TH>
cudaError_t launch_prologue(const CbArgs& a, int batch, __nv_bfloat16* xn,
                            cudaStream_t s) {
  auto kernel = convnext_block_prologue_kernel<TH>;
  const size_t smem = TH * kCbTileW * a.C * 4 + a.C * 49 * 2;
  static int granted[kMaxDevices] = {};
  const cudaError_t err = reserve_smem(kernel, smem, granted);
  if (err != cudaSuccess) return err;
  kernel<<<n_tiles(batch, a.H, a.W, TH, kCbTileW), kCbThreads, smem, s>>>(
      a, xn);
  return cudaGetLastError();
}

// 2-3. the GEMMs: out (M, N) = epilogue(A (M, K) B^T), B (N, K)

enum FcEpilogue : int {
  kFc1Gelu = 0,      // out = gelu(acc + bias)
  kFc2Residual = 1,  // out = x + (acc + bias) * gamma
};

constexpr int kFcRows = 128;     // output rows a block: two consumer warpgroups
constexpr int kFcDepth = 64;     // reduction a stage: one 128-byte swizzled row
constexpr int kFcThreads = 384;  // two consumer warpgroups and a producer

struct FcParams {
  const __nv_bfloat16* bias;   // (N)
  const __nv_bfloat16* x;      // fc2: the shortcut (M, N), or null
  const __nv_bfloat16* gamma;  // fc2: the layer scale (N)
  __nv_bfloat16* out;          // (M, N)
  int M, N, K;
};

// Each consumer warpgroup stages its 64 x BN output tile in shared memory.
// fc1: bf16 h in BN / 64 boxes of 64 x 64 with the 128-byte swizzle, which
// a TMA store writes out. fc2: (acc + b2) gamma in float32 (x is added
// before the one rounding), rows padded by 8 floats (a row stride of 8
// banks mod 32, so the accumulator layout's stores hit every bank once),
// written out as whole rows of x + staged with 16-byte stores.
//
// Byte offsets in the block's shared memory (1024-aligned base): the ring,
// the two staging tiles, the barriers. The ring takes what the staging
// tiles leave of ~220 KB: more stages in flight for narrow tiles, and one
// block per SM, which setmaxnreg's register budget assumes.
template <int EPI, int BN>
struct FcSmem {
  static constexpr int kA = kFcRows * kFcDepth * 2;  // 16 KB
  static constexpr int kB = BN * kFcDepth * 2;       // a multiple of 1 KB
  static constexpr int kStage = kA + kB;
  static constexpr int kLdOut = BN + 8;              // fc2's staging row
  static constexpr int kOut =                        // a warpgroup's
      EPI == kFc1Gelu ? 64 * BN * 2 : 64 * kLdOut * 4;
  static constexpr int kRing = (220 * 1024 - 2 * kOut) / kStage;
  static constexpr int kStages = kRing < 8 ? kRing : 8;
  static constexpr int kOuts = kStages * kStage;
  static constexpr int kBars = kOuts + 2 * kOut;  // full[stages], empty[stages]
  static constexpr int kBytes = kBars + 16 * kStages + 1024;
};

template <int EPI, int BN>
__global__ void __launch_bounds__(kFcThreads, 1)
    convnext_block_fc_kernel(const __grid_constant__ CUtensorMap a_map,
                             const __grid_constant__ CUtensorMap b_map,
                             const __grid_constant__ CUtensorMap c_map,
                             const FcParams p) {
  using L = FcSmem<EPI, BN>;
  constexpr int LDO = L::kLdOut;
  constexpr int STAGES = L::kStages;
  static_assert(BN % 32 == 0 && BN <= 256 && STAGES >= 2, "tile shapes");
  static_assert(EPI != kFc1Gelu || BN % 64 == 0, "fc1 stores 64-wide boxes");
  extern __shared__ __align__(1024) unsigned char fc_smem[];
  unsigned char* smem = fc_smem + ((1024 - (smem_u32(fc_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int n_cols = (p.N + BN - 1) / BN;  // column tiles of a row tile
  const int n_tiles = n_cols * ((p.M + kFcRows - 1) / kFcRows);
  const int n_k = (p.K + kFcDepth - 1) / kFcDepth;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // tiles blockIdx.x, + gridDim.x, ...: column tiles of one row tile are
  // neighbours, so the blocks running at once share their A rows; stage
  // uses are counted across tiles (it), so the ring runs on into the next
  // tile while the consumers store this one
  if (wg == 2) {
    // ---------------- producer: one thread issues every load
    regs_release<24>();
    if (tid == 256) {
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = (tile / n_cols) * kFcRows;
        const int n0 = (tile % n_cols) * BN;
        for (int t = 0; t < n_k; ++t, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
          unsigned char* st = smem + s * L::kStage;
          mbar_expect_tx(&full[s], L::kStage);
          tma_load_2d(st, &a_map, &full[s], t * kFcDepth, m0);
          tma_load_2d(st + L::kA, &b_map, &full[s], t * kFcDepth, n0);
        }
      }
    }
    return;
  }

  // ---------------- consumers: 64 rows each
  regs_claim<240>();
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  float acc[BN / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = (tile / n_cols) * kFcRows;
    const int n0 = (tile % n_cols) * BN;
    for (int t = 0; t < n_k; ++t, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const unsigned char* st = smem + s * L::kStage;
      const uint64_t da = make_desc<kFcDepth>(st + wg * 64 * kFcDepth * 2);
      const uint64_t db = make_desc<kFcDepth>(st + L::kA);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kFcDepth / 16; ++k)  // a k16 step is 32 bytes
        WgmmaSS<BN>::run(acc, da + 2 * k, db + 2 * k, t > 0 || k > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      if (t > 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    wgmma_wait<0>();
    mbar_arrive(&empty[(it - 1) % STAGES]);
    fence_regs(acc);

    if constexpr (EPI == kFc1Gelu) {
      // ---------------- fc1: gelu(acc + b1) as bf16 into the boxes
      // (16-byte unit u of row r at u ^ (r % 8): the accumulator layout's
      // stores hit 32 banks), then one TMA store a box, which clips rows
      // past M and columns past N
      unsigned char* box = smem + L::kOuts + wg * L::kOut;
      if ((tid & 127) == 0) tma_store_wait_read<0>();  // the last tile's
      named_sync(1 + wg, 128);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * t4;
        const float2 b =
            n < p.N ? load_bf16x2(p.bias + n) : make_float2(0.f, 0.f);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = warp * 16 + g + 8 * i;
          *reinterpret_cast<uint32_t*>(
              box + (j >> 3) * 8192 + r * 128 + (((j & 7) ^ (r & 7)) << 4) +
              4 * t4) = pack_bf16x2(gelu_as(acc[4 * j + 2 * i] + b.x),
                                    gelu_as(acc[4 * j + 2 * i + 1] + b.y));
        }
      }
      fence_proxy_async();
      named_sync(1 + wg, 128);
      if ((tid & 127) == 0) {
#pragma unroll
        for (int bx = 0; bx < BN / 64; ++bx)
          tma_store_2d(&c_map, box + bx * 8192, n0 + 64 * bx, m0 + wg * 64);
        tma_store_commit();
      }
    } else {
      // ---------------- fc2: (acc + b2) gamma, float32, to the staging
      // tile (thread rows 16 warp + g (+ 8), columns 8 j + 2 t4 (+ 1));
      // columns past N (N % 8 == 0: a pair is whole or out) stage anything
      float* out_s = reinterpret_cast<float*>(smem + L::kOuts + wg * L::kOut);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * t4;
        float2 b = make_float2(0.f, 0.f), gm = b;
        if (n < p.N) {
          b = load_bf16x2(p.bias + n);
          gm = load_bf16x2(p.gamma + n);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<float2*>(
              out_s + (warp * 16 + g + 8 * i) * LDO + 8 * j + 2 * t4) =
              make_float2((acc[4 * j + 2 * i] + b.x) * gm.x,
                          (acc[4 * j + 2 * i + 1] + b.y) * gm.y);
      }
      named_sync(1 + wg, 128);
      // whole rows, 8 columns (16 bytes of output) a thread: x + staged,
      // one rounding
      for (int q = tid & 127; q < 64 * (BN / 8); q += 128) {
        const int r = q / (BN / 8);
        const int col = (q - r * (BN / 8)) * 8;
        const int m = m0 + wg * 64 + r;
        const int n = n0 + col;
        if (m >= p.M || n >= p.N) continue;
        const float4 lo = *reinterpret_cast<const float4*>(out_s + r * LDO +
                                                           col);
        const float4 hi = *reinterpret_cast<const float4*>(out_s + r * LDO +
                                                           col + 4);
        const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        const uint4 xr =
            p.x != nullptr
                ? *reinterpret_cast<const uint4*>(p.x + (size_t)m * p.N + n)
                : make_uint4(0u, 0u, 0u, 0u);  // bf16 zeros: delta only
        const uint32_t xw[4] = {xr.x, xr.y, xr.z, xr.w};
        uint32_t o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 xf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&xw[e]));
          o[e] = pack_bf16x2(xf.x + v[2 * e], xf.y + v[2 * e + 1]);
        }
        *reinterpret_cast<uint4*>(p.out + (size_t)m * p.N + n) =
            make_uint4(o[0], o[1], o[2], o[3]);
      }
      named_sync(1 + wg, 128);  // the staging tile is free for the next tile
    }
  }
  if (EPI == kFc1Gelu && (tid & 127) == 0) tma_store_wait_read<0>();
}

// the K-major operand (rows, K) of a GEMM: boxes of 64 columns x box_rows
inline bool encode_operand(CUtensorMap* map, const void* base, int rows,
                           int K, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {kFcDepth, (cuuint32_t)box_rows};
  return encode_map<kFcDepth>(map, base, 2, dims, strides, box);
}

// the current device's SMs (queried once per device)
inline cudaError_t device_sms(int* sms) {
  static int known[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (known[dev] == 0)
    err = cudaDeviceGetAttribute(&known[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
  *sms = known[dev];
  return err;
}

// one persistent block per SM (or per tile, if fewer)
template <int EPI, int BN>
cudaError_t launch_fc(const CUtensorMap& a_map, const CUtensorMap& b_map,
                      const CUtensorMap& c_map, const FcParams& p,
                      cudaStream_t s) {
  auto kernel = convnext_block_fc_kernel<EPI, BN>;
  static int granted[kMaxDevices] = {};
  cudaError_t err = reserve_smem(kernel, FcSmem<EPI, BN>::kBytes, granted);
  int sms = 0;
  if (err == cudaSuccess) err = device_sms(&sms);
  if (err != cudaSuccess) return err;
  const int tiles = ((p.N + BN - 1) / BN) * ((p.M + kFcRows - 1) / kFcRows);
  kernel<<<tiles < sms ? tiles : sms, kFcThreads, FcSmem<EPI, BN>::kBytes, s>>>(
      a_map, b_map, c_map, p);
  return cudaGetLastError();
}

// the tile widths the plan may ask for (ops/convnext_block.py)
constexpr int kFc1Width = 128;

inline bool fc2_width_ok(int bn) {
  return bn == 64 || bn == 96 || bn == 128 || bn == 192;
}

cudaError_t launch_fc2(int bn, const CUtensorMap& a_map,
                       const CUtensorMap& b_map, const FcParams& p,
                       cudaStream_t s) {
  switch (bn) {
    case 64: return launch_fc<kFc2Residual, 64>(a_map, b_map, a_map, p, s);
    case 96: return launch_fc<kFc2Residual, 96>(a_map, b_map, a_map, p, s);
    case 128: return launch_fc<kFc2Residual, 128>(a_map, b_map, a_map, p, s);
    case 192: return launch_fc<kFc2Residual, 192>(a_map, b_map, a_map, p, s);
  }
  return cudaErrorInvalidValue;
}

cudaError_t launch_prologue_rows(int tile_h, const CbArgs& a, int batch,
                                 __nv_bfloat16* xn, cudaStream_t s) {
  switch (tile_h) {
    case 1: return launch_prologue<1>(a, batch, xn, s);
    case 2: return launch_prologue<2>(a, batch, xn, s);
    case 4: return launch_prologue<4>(a, batch, xn, s);
    case 8: return launch_prologue<8>(a, batch, xn, s);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- float32
constexpr int kF32TH = 4, kF32TW = 4, kF32TP = kF32TH * kF32TW;
constexpr int kF32MaxC = 768;  // the shared-memory tiles below

inline size_t cb_f32_smem(int C) {
  const int TP = kF32TP, HC = kCbF32HC;
  const size_t w1s = sizeof(float) * HC * (C + 1);
  const size_t pro = halo_bytes<float, kF32TH, kF32TW>() + kCbTapBytes;
  return sizeof(float) * ((size_t)TP * (C + 1) + (size_t)TP * C +
                          (size_t)C * (HC + 1) + (size_t)TP * (HC + 1)) +
         (w1s > pro ? w1s : pro) + 16;  // + the halo's alignment
}

__global__ void __launch_bounds__(kCbThreads)
    convnext_block_f32_kernel(CbArgs a) {
  constexpr int TP = kF32TP;
  constexpr int HC = kCbF32HC;
  const int C = a.C;
  const int HID = a.HID;
  const int LDX = C + 1;
  extern __shared__ __align__(16) float fsmem[];
  float* xs = fsmem;               // [TP][C + 1] dwconv, then normalised
  float* ys = xs + TP * LDX;       // [TP][C] fc2 accumulator
  float* w2s = ys + TP * C;        // [C][HC + 1]
  float* hs = w2s + C * (HC + 1);  // [TP][HC + 1]
  // [HC][C + 1], 16-byte aligned; before it, the prologue's halo and taps
  float* w1s = fsmem + round_up(TP * LDX + TP * C + C * (HC + 1) +
                                    TP * (HC + 1), 4);
  float* halo = w1s;
  float* taps = halo + halo_bytes<float, kF32TH, kF32TW>() / 4;

  const float* w1 = static_cast<const float*>(a.w1);
  const float* w2 = static_cast<const float*>(a.w2);
  const float* b1 = static_cast<const float*>(a.b1);
  const int tid = threadIdx.x;
  const Tile tl = block_tile<kF32TH, kF32TW>(a);

  depthwise_tile<float, kF32TH, kF32TW>(a, tl, xs, LDX, halo, taps);
  __syncthreads();
  layernorm_tile<float>(a, TP, xs, LDX, [&](int p) { return xs + p * LDX; });
  for (int i = tid; i < TP * C; i += kCbThreads) ys[i] = 0.f;

  for (int h0 = 0; h0 < HID; h0 += HC) {
    __syncthreads();  // the previous chunk's tiles (or the halo) consumed
    for (int i = tid; i < HC * C; i += kCbThreads) {
      const int j = i / C;
      const int k = i - j * C;
      w1s[j * LDX + k] = h0 + j < HID ? w1[(size_t)(h0 + j) * C + k] : 0.f;
    }
    for (int i = tid; i < C * HC; i += kCbThreads) {
      const int n = i / HC;
      const int j = i - n * HC;
      w2s[n * (HC + 1) + j] = h0 + j < HID ? w2[(size_t)n * HID + h0 + j] : 0.f;
    }
    __syncthreads();
    {  // h = gelu(xn @ w1[chunk]^T + b1): one (pixel, hidden) per thread
      const int p = tid / HC;
      const int j = tid - p * HC;
      const float* xr = xs + p * LDX;
      const float* wr = w1s + j * LDX;
      float acc = 0.f;
      for (int k = 0; k < C; ++k) acc += xr[k] * wr[k];
      hs[p * (HC + 1) + j] =
          h0 + j < HID ? gelu_erf(acc + b1[h0 + j]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < TP * C; i += kCbThreads) {
      const int p = i / C;
      const int n = i - p * C;
      const float* hr = hs + p * (HC + 1);
      const float* wr = w2s + n * (HC + 1);
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < HC; ++j) acc += hr[j] * wr[j];
      ys[i] += acc;
    }
  }
  __syncthreads();
  const float* b2 = static_cast<const float*>(a.b2);
  const float* gm = static_cast<const float*>(a.gamma);
  const float* res = static_cast<const float*>(a.shortcut);
  float* out = static_cast<float*>(a.out);
  for (int i = tid; i < TP * C; i += kCbThreads) {
    const int P = tile_pixel<kF32TW>(a, tl, i / C);
    if (P < 0) continue;
    const int n = i % C;
    const size_t o = (size_t)P * C + n;
    const float delta = (ys[i] + b2[n]) * gm[n];
    out[o] = res != nullptr ? res[o] + delta : delta;
  }
}

}  // namespace msa

// x, out (B, H, W, C); dw (C, 1, 7, 7); dw_b, ln_g, ln_b, b2, gamma (C);
// w1 (HID, C); b1 (HID); w2 (C, HID); all of one dtype. out = shortcut +
// block(x), shortcut x itself at inference; a null shortcut gives the delta
// block(x) alone (training: drop path comes between). C and HID multiples
// of 8.
// bf16: xn (B*H*W, C) and h (B*H*W, HID) are scratch; tile_h (1, 2, 4 or
// 8; tile_h * 8 * C <= 16384), fc1_bn (128) and fc2_bn (64, 96, 128 or 192)
// are the plan (ops/convnext_block.py:convnext_block_plan). Encodes the
// four tensor maps and launches the prologue, fc1 and fc2 on `stream`;
// returns the first error.
// float32: one fused kernel, C at most 768; xn, h and the plan are unused.
extern "C" int msa_convnext_block(const void* x, const void* dw,
                                  const void* dw_b, const void* ln_g,
                                  const void* ln_b, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, const void* gamma,
                                  const void* shortcut, void* out,
                                  void* xn, void* h, int batch, int H, int W,
                                  int C, int HID, float eps, int tile_h,
                                  int fc1_bn, int fc2_bn, int dtype,
                                  void* stream) {
  using bf16 = __nv_bfloat16;
  if (C <= 0 || C % 8 || HID <= 0 || HID % 8 || batch < 0 || H < 0 || W < 0)
    return cudaErrorInvalidValue;
  msa::CbArgs a;
  a.x = x, a.dw = dw, a.dw_b = dw_b, a.ln_g = ln_g, a.ln_b = ln_b;
  a.w1 = w1, a.b1 = b1, a.w2 = w2, a.b2 = b2, a.gamma = gamma;
  a.shortcut = shortcut, a.out = out;
  a.H = H, a.W = W, a.C = C, a.HID = HID, a.eps = eps;
  const int n_pix = batch * H * W;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == msa::kBFloat16) {
    if (xn == nullptr || h == nullptr || tile_h * msa::kCbTileW * C >
            msa::kCbTileValues || fc1_bn != msa::kFc1Width ||
        !msa::fc2_width_ok(fc2_bn))
      return cudaErrorInvalidValue;
    if (n_pix == 0) return cudaSuccess;
    CUtensorMap xn_map, w1_map, h_map, w2_map, hs_map;
    if (!msa::encode_operand(&xn_map, xn, n_pix, C, msa::kFcRows) ||
        !msa::encode_operand(&w1_map, w1, HID, C, fc1_bn) ||
        !msa::encode_operand(&h_map, h, n_pix, HID, msa::kFcRows) ||
        !msa::encode_operand(&w2_map, w2, C, HID, fc2_bn) ||
        !msa::encode_operand(&hs_map, h, n_pix, HID, 64))
      return cudaErrorInvalidValue;
    msa::FcParams f1, f2;
    f1.bias = static_cast<const bf16*>(b1);
    f1.x = f1.gamma = nullptr;
    f1.out = static_cast<bf16*>(h);
    f1.M = n_pix, f1.N = HID, f1.K = C;
    f2.bias = static_cast<const bf16*>(b2);
    f2.x = static_cast<const bf16*>(shortcut);
    f2.gamma = static_cast<const bf16*>(gamma);
    f2.out = static_cast<bf16*>(out);
    f2.M = n_pix, f2.N = C, f2.K = HID;
    cudaError_t err = msa::launch_prologue_rows(tile_h, a, batch,
                                                static_cast<bf16*>(xn), s);
    if (err == cudaSuccess)
      err = msa::launch_fc<msa::kFc1Gelu, msa::kFc1Width>(xn_map, w1_map,
                                                          hs_map, f1, s);
    if (err == cudaSuccess) err = msa::launch_fc2(fc2_bn, h_map, w2_map, f2, s);
    return err;
  }
  if (dtype != msa::kFloat32 || C > msa::kF32MaxC) return cudaErrorInvalidValue;
  if (n_pix == 0) return cudaSuccess;
  auto kernel = msa::convnext_block_f32_kernel;
  const size_t smem = msa::cb_f32_smem(C);
  static int granted[msa::kMaxDevices] = {};
  const cudaError_t err = msa::reserve_smem(kernel, smem, granted);
  if (err != cudaSuccess) return err;
  const int blocks =
      msa::n_tiles(batch, H, W, msa::kF32TH, msa::kF32TW);
  kernel<<<blocks, msa::kCbThreads, smem, s>>>(a);
  return cudaGetLastError();
}
