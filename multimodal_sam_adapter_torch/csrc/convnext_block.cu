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
// every stage of the flagship trunk, ~10 us at 989 TFLOP/s in bf16, ~20 us
// at TF32's 495), and the bytes around them: x read, xn and h written and
// read back, out written.
//
// Why the block is unfused on this card. The TPU kernel fuses the whole
// block because its grid runs in order and VMEM holds an image's hidden
// map. On 132 SMs a fused block can only split pixels, and its float32 y
// accumulator (pixels x C) has to fit in registers: 32-pixel tiles above
// C = 192, each streaming all of w1 and w2 (16 C^2 bytes, 2.36 MB at C =
// 384) from L2, 302 MB a call at 64^2 x 384 (5.6x the tensor-core bound by
// itself, 32 FLOP a weight byte); at 32^2 x 768 only 32 tiles. Unfused,
// the hidden map h (P x 4C, bf16) is 12.6 MB at 64^2 x 384 and 6.3 MB at
// 32^2 x 768, well inside the 50 MB L2, so writing and reading it back
// costs microseconds; at 256^2 x 96 (50 MB) and 128^2 x 192 (25 MB) it
// round-trips device memory (>= 49 and >= 25 us). float32 doubles those
// bytes. Two GEMMs of 128-row tiles then give 96-1536 tiles a call, each
// weight byte feeds 128 rows, and the weights come by TMA.
//
// Design, three launches from one C entry (msa_convnext_block), in bf16 or
// float32 (T, the storage type; every sum in float32):
//   1. convnext_block_prologue_kernel<T, TH>: one block of 8 warps per TH x
//      8 pixel tile, TH chosen by the caller's plan (ops/convnext_block.py)
//      so that the grid holds >= 132 blocks where the map allows. Every
//      channel at once: the block stages the raw taps in shared memory (in
//      slabs of the plan's tap_slab channels where all of them do not fit
//      beside the tile: float32 from C = 896 at two tile rows, 1024 at
//      one); a thread takes one 32-bit word of channels (a bf16 pair, or
//      one float) and a block of <= 8 outputs of the tile, loads all of
//      their inputs into registers at once (x through L1) and runs the 49
//      taps over them, into a float32 tile. One warp per pixel then computes the LayerNorm (two passes,
//      float32) and writes the normalised row in T: xn (P, C). CUDA-core
//      work whose bound is its bytes; what holds it back is load latency
//      and the threads in flight. float32: the blocks also split w1 and w2
//      into their TF32 halves for the GEMMs (below), while the taps arrive.
//   2. convnext_block_fc_kernel<T, kFc1Gelu, 128>: h = gelu(xn w1^T + b1),
//      (P, HID) in T; bf16 takes erf by the TPU kernel's A&S formula
//      (gelu_as), float32 erff.
//   3. convnext_block_fc_kernel<T, kFc2Residual, BN>: out = x + (h w2^T +
//      b2) gamma, BN from the plan (the narrowest width >= C up to 192,
//      128 in float32; above, the widest dividing C by the tile count).
//   The GEMM: one persistent block per SM walks 128 x BN output tiles. One
//   thread of a producer warpgroup (setmaxnreg gives its other registers to
//   the consumers) issues TMA loads of 128-row A and BN-row B tiles, both
//   K-major, one 128-byte row of the reduction deep (64 bf16 or 32 float32
//   values) with the 128-byte swizzle, into a ring of 3-8 stages with a
//   full and an empty mbarrier each, running on into the next tile while
//   the consumers store this one; two consumer warpgroups of 64 rows run
//   wgmma on the stages.
//   - bf16: wgmma m64nBNk16 from shared memory, one stage's products kept
//     in flight while the next is awaited. Epilogues, float32 on the
//     accumulator: fc1 writes bf16 h into 128-byte-swizzled boxes that a
//     TMA store takes out; fc2 stages (acc + b2) gamma in padded shared
//     memory and writes whole rows of x + that with 16-byte stores.
//   - float32, 3xTF32: TF32 keeps 11 significant bits (~5e-4 an operand),
//     far from float32's 1e-4 tolerance, so each operand is split into big
//     = tf32(x) and small = tf32(x - big) (x = big + small to 2^-21 |x|)
//     and a k8 step runs a_big b_small + a_small b_big, then a_big b_big,
//     on .tf32 wgmma m64nBNk8 (a_small b_small, ~2^-22, is dropped). The
//     weights come split (the prologue's copy, (2, N, K): B's big and small
//     halves are one 3-d TMA box each); A (xn, h) crosses memory once, as
//     float32: each consumer thread reads its fragment of the stage from
//     the swizzled tile and splits it in registers (wgmma takes A from
//     registers; .tf32 has no transpose, and both operands are K-major
//     here). The stage's 12 products go to a fresh accumulator, awaited
//     before its registers are reused (the other consumer warpgroup's
//     products fill the gap), then added to the float32 sum on the CUDA
//     cores: the tensor cores' own accumulation truncates, so over a whole
//     K its error grows with K (1.3e-4 at 32^2 x 768 on an H100, against
//     the 1e-4 + 1e-4 |out| tolerance). Two accumulators hold fc2 to
//     widths <= 128 in float32. The epilogues write float2 straight from
//     the sum (a warp's row segment is a whole 32-byte sector), so no
//     staging memory.
//   Ragged edges: TMA zero-fills rows past P and N and the columns past K
//   (C = 40 under a 64-wide box) on load and clips them on store; the
//   epilogues' other stores are masked.
#include <type_traits>  // std::remove_pointer_t, std::is_same_v

#include "common.cuh"
#include "mma.cuh"  // cp.async
#include "wgmma.cuh"

namespace msa {

constexpr int kCbThreads = 256;  // 8 warps (prologue)
constexpr int kCbTileW = 8;      // prologue: pixel tile columns
// prologue: float32 dwconv outputs a tile keeps in shared memory (64 KiB),
// TH * 8 * C at most
constexpr int kCbTileValues = 16384;
// shared memory a block may take (an H100's 227 KB)
constexpr int kCbSmemMax = 232448;

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
  float* w_split;        // float32: w1's and w2's TF32 halves (4, HID * C)
  int H, W, C, HID;
  int tap_slab;          // channels whose taps the prologue stages at once
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

// LayerNorm over the C channels of each of the TP rows of src (float32, row
// stride lds), two passes in float32, one warp per row; row p's normalised
// values go to dst_row(p), a row of float32 or bf16 (none where it returns
// null).
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

__device__ __forceinline__ float2 load_bf16x2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// two neighbouring values as float32
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return load_bf16x2(p);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// ---------------------------------------------------------------- prologue
// 1. xn = LN(dwconv(x)), (P, C) in T

// The outputs of one prologue item: SH rows x SW columns of a TH x 8 tile
// (for each channel of a word), whose (SH + 6) x (SW + 6) input words stay
// in registers, 70-80 of them.
template <int TH>
struct ProSub {
  static constexpr int SH = TH >= 4 ? 4 : TH;
  static constexpr int SW = TH >= 4 ? 2 : 4;
};

// channels in a 32-bit word of x: a bf16 pair or one float32
template <typename T>
constexpr int kWordChannels = 4 / (int)sizeof(T);

// channel e of the 32-bit word v of x, as float32
template <typename T>
__device__ __forceinline__ float word_channel(uint32_t v, int e) {
  if constexpr (std::is_same_v<T, float>) return __uint_as_float(v);
  return __uint_as_float(e == 0 ? v << 16 : v & 0xffff0000u);
}

// shared memory of a prologue block: its float32 dwconv tile and one slab
// of raw taps
template <typename T>
__host__ __device__ constexpr int prologue_smem(int TH, int C, int slab) {
  return TH * kCbTileW * C * 4 + slab * 49 * (int)sizeof(T);
}

// Depthwise 7x7 conv (zero padding) + bias of channels [c0, c0 + cs) of a
// TH x 8 tile into dst[p * C + c] (float32, p = py * 8 + px). An item is
// one word of channels and one SH x SW block of the tile: it loads all of
// its inputs first (one word a pixel through L1, a warp's 32 words one
// 128-byte line; all of them in flight at once), then runs the 49 taps
// over them, each tap read from shared memory in the raw (cs, 49) layout
// (channel words a lane apart are 49 or 98 values apart: bf16 pairs read
// words 49 l + k / 2, float32 words 49 l + k, 32 banks as 49 is odd).
template <typename T, int TH>
__device__ void depthwise_tile(const CbArgs& a, const Tile& tl, float* dst,
                               const T* taps, int c0, int cs) {
  constexpr int SH = ProSub<TH>::SH, SW = ProSub<TH>::SW;
  constexpr int GW = kCbTileW / SW;        // item columns in the tile
  constexpr int ITEMS = (TH / SH) * GW;    // items of a channel word
  constexpr int CW = kWordChannels<T>;
  const T* x = static_cast<const T*>(a.x);
  const T* dwb = static_cast<const T*>(a.dw_b);
  const int C = a.C;
  const int words = cs / CW;
  for (int it = threadIdx.x; it < words * ITEMS; it += kCbThreads) {
    const int grp = it / words;
    const int cl = (it - grp * words) * CW;  // the word's channel in the slab
    const int c = c0 + cl;
    const int y0 = (grp / GW) * SH;  // the item's origin in the tile
    const int x0 = (grp % GW) * SW;
    uint32_t xv[SH + 6][SW + 6];     // words of x, zero outside the image
#pragma unroll
    for (int r = 0; r < SH + 6; ++r) {
      const int hh = tl.h0 + y0 + r - 3;
      const bool row_in = hh >= 0 && hh < a.H;
      const T* xrow = x + (ptrdiff_t)(tl.b * a.H + hh) * a.W * C + c;
#pragma unroll
      for (int cx = 0; cx < SW + 6; ++cx) {
        const int ww = tl.w0 + x0 + cx - 3;
        xv[r][cx] = row_in && ww >= 0 && ww < a.W
                        ? __ldg(reinterpret_cast<const unsigned int*>(
                              xrow + (ptrdiff_t)ww * C))
                        : 0u;
      }
    }
    float acc[SH][SW][CW];
#pragma unroll
    for (int e = 0; e < CW; ++e) {
      const float bias = to_float(dwb[c + e]);
#pragma unroll
      for (int py = 0; py < SH; ++py)
#pragma unroll
        for (int px = 0; px < SW; ++px) acc[py][px][e] = bias;
    }
    const T* t0 = taps + cl * 49;
#pragma unroll
    for (int dy = 0; dy < 7; ++dy)
#pragma unroll
      for (int dx = 0; dx < 7; ++dx) {
        float w[CW];
#pragma unroll
        for (int e = 0; e < CW; ++e) w[e] = to_float(t0[e * 49 + dy * 7 + dx]);
#pragma unroll
        for (int py = 0; py < SH; ++py)
#pragma unroll
          for (int px = 0; px < SW; ++px) {
            const uint32_t v = xv[py + dy][px + dx];
#pragma unroll
            for (int e = 0; e < CW; ++e)
              acc[py][px][e] += word_channel<T>(v, e) * w[e];
          }
      }
#pragma unroll
    for (int py = 0; py < SH; ++py)
#pragma unroll
      for (int px = 0; px < SW; ++px) {
        float* o = dst + ((y0 + py) * kCbTileW + x0 + px) * C + c;
        if constexpr (CW == 2)
          *reinterpret_cast<float2*>(o) =
              make_float2(acc[py][px][0], acc[py][px][1]);
        else
          *o = acc[py][px][0];
      }
  }
}

// float32: w1 and w2 split into their TF32 halves for the GEMMs' B tiles,
// each block a grid-stride share, kSplitLoads float4 loads of a thread in
// flight at once (at 32^2 x 768 one block an SM splits 18.9 MB): w_split =
// [w1 big, w1 small, w2 big, w2 small], HID * C values each
constexpr int kSplitLoads = 4;

__device__ void split_weights(const CbArgs& a) {
  const size_t n4 = (size_t)a.HID * a.C / 4;  // float4s of one weight
  const float4* w1 = static_cast<const float4*>(a.w1);
  const float4* w2 = static_cast<const float4*>(a.w2);
  float4* out = reinterpret_cast<float4*>(a.w_split);
  const size_t stride = (size_t)gridDim.x * kCbThreads;
  for (size_t i0 = (size_t)blockIdx.x * kCbThreads + threadIdx.x; i0 < 2 * n4;
       i0 += kSplitLoads * stride) {
    float4 v[kSplitLoads];
#pragma unroll
    for (int u = 0; u < kSplitLoads; ++u) {
      const size_t i = i0 + u * stride;
      if (i < 2 * n4) v[u] = __ldg(i < n4 ? w1 + i : w2 + (i - n4));
    }
#pragma unroll
    for (int u = 0; u < kSplitLoads; ++u) {
      const size_t i = i0 + u * stride;
      if (i >= 2 * n4) break;
      const size_t w = i / n4;  // 0: w1, 1: w2
      const size_t j = i - w * n4;
      uint4 big, small;
      split_tf32(v[u].x, big.x, small.x);
      split_tf32(v[u].y, big.y, small.y);
      split_tf32(v[u].z, big.z, small.z);
      split_tf32(v[u].w, big.w, small.w);
      out[2 * w * n4 + j] = *reinterpret_cast<const float4*>(&big);
      out[(2 * w + 1) * n4 + j] = *reinterpret_cast<const float4*>(&small);
    }
  }
}

template <typename T, int TH>
__global__ void __launch_bounds__(kCbThreads, 2)
    convnext_block_prologue_kernel(CbArgs a, T* xn) {
  constexpr int TP = TH * kCbTileW;
  extern __shared__ __align__(16) unsigned char pro_smem[];
  float* dwo = reinterpret_cast<float*>(pro_smem);                // [TP][C]
  T* taps = reinterpret_cast<T*>(pro_smem + TP * a.C * 4);  // [slab][49]
  const T* dw = static_cast<const T*>(a.dw);
  const Tile tl = block_tile<TH, kCbTileW>(a);
  for (int c0 = 0; c0 < a.C; c0 += a.tap_slab) {
    const int cs = min(a.tap_slab, a.C - c0);
    if (c0 > 0) __syncthreads();  // the last slab's taps are consumed
    // the slab's taps as they lie in dw (cs * 49 values, a multiple of 16
    // bytes, 16-byte aligned as c0 % 8 == 0), all in flight at once
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(dw + (size_t)c0 * 49);
    for (int i = threadIdx.x; i < cs * 49 * (int)sizeof(T) / 16;
         i += kCbThreads)
      cp_async16(reinterpret_cast<unsigned char*>(taps) + 16 * i, src + 16 * i,
                 true);
    cp_async_commit();
    if constexpr (std::is_same_v<T, float>)
      if (c0 == 0) split_weights(a);
    cp_async_wait<0>();
    __syncthreads();
    depthwise_tile<T, TH>(a, tl, dwo, taps, c0, cs);
  }
  __syncthreads();
  layernorm_tile<T>(a, TP, dwo, a.C, [&](int p) -> T* {
    const int P = tile_pixel<kCbTileW>(a, tl, p);
    return P < 0 ? nullptr : xn + (size_t)P * a.C;
  });
}

template <typename T, int TH>
cudaError_t launch_prologue(const CbArgs& a, int batch, T* xn,
                            cudaStream_t s) {
  auto kernel = convnext_block_prologue_kernel<T, TH>;
  const size_t smem = prologue_smem<T>(TH, a.C, a.tap_slab);
  static int granted[kMaxDevices] = {};
  const cudaError_t err = reserve_smem(kernel, smem, granted);
  if (err != cudaSuccess) return err;
  kernel<<<n_tiles(batch, a.H, a.W, TH, kCbTileW), kCbThreads, smem, s>>>(
      a, xn);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- GEMMs
// 2-3. out (M, N) = epilogue(A (M, K) B^T), B (N, K)

enum FcEpilogue : int {
  kFc1Gelu = 0,      // out = gelu(acc + bias)
  kFc2Residual = 1,  // out = x + (acc + bias) * gamma
};

constexpr int kFcRows = 128;      // output rows a block: two consumer warpgroups
constexpr int kFcRowBytes = 128;  // reduction a stage: one 128-byte swizzled row
constexpr int kFcThreads = 384;   // two consumer warpgroups and a producer
constexpr int kFcRingBytes = 225280;  // 220 KB: the ring, the staging tiles
constexpr int kFcMaxStages = 8;

template <typename T>
struct FcParams {
  const T* bias;   // (N)
  const T* x;      // fc2: the shortcut (M, N), or null
  const T* gamma;  // fc2: the layer scale (N)
  T* out;          // (M, N)
  int M, N, K;
};

// bf16: each consumer warpgroup stages its 64 x BN output tile in shared
// memory. fc1: bf16 h in BN / 64 boxes of 64 x 64 with the 128-byte
// swizzle, which a TMA store writes out. fc2: (acc + b2) gamma in float32
// (x is added before the one rounding), rows padded by 8 floats (a row
// stride of 8 banks mod 32, so the accumulator layout's stores hit every
// bank once), written out as whole rows of x + staged with 16-byte stores.
// float32 stores from registers: no staging tile, and a stage holds B
// twice (its big and small TF32 halves).
//
// Byte offsets in the block's shared memory (1024-aligned base): the ring,
// the two staging tiles, the barriers. The ring takes what the staging
// tiles leave of kFcRingBytes: more stages in flight for narrow tiles, and
// one block per SM, which setmaxnreg's register budget assumes.
// ops/convnext_block.py:fc_stages mirrors kStages.
template <typename T, int EPI, int BN>
struct FcSmem {
  static constexpr bool kF32 = std::is_same_v<T, float>;
  static constexpr int kA = kFcRows * kFcRowBytes;  // 16 KB
  static constexpr int kB = BN * kFcRowBytes;       // a multiple of 1 KB
  static constexpr int kStage = kA + (kF32 ? 2 : 1) * kB;
  static constexpr int kLdOut = BN + 8;             // fc2's staging row
  static constexpr int kOut =                       // a warpgroup's
      kF32 ? 0 : EPI == kFc1Gelu ? 64 * BN * 2 : 64 * kLdOut * 4;
  static constexpr int kRing = (kFcRingBytes - 2 * kOut) / kStage;
  static constexpr int kStages = kRing < kFcMaxStages ? kRing : kFcMaxStages;
  static constexpr int kOuts = kStages * kStage;
  static constexpr int kBars = kOuts + 2 * kOut;  // full[stages], empty[stages]
  static constexpr int kBytes = kBars + 16 * kStages + 1024;
};

template <typename T, int EPI, int BN>
__global__ void __launch_bounds__(kFcThreads, 1)
    convnext_block_fc_kernel(const __grid_constant__ CUtensorMap a_map,
                             const __grid_constant__ CUtensorMap b_map,
                             const __grid_constant__ CUtensorMap c_map,
                             const FcParams<T> p) {
  using L = FcSmem<T, EPI, BN>;
  constexpr bool kF32 = L::kF32;
  constexpr int DEPTH = kFcRowBytes / (int)sizeof(T);  // reduction a stage
  constexpr int LDO = L::kLdOut;
  constexpr int STAGES = L::kStages;
  static_assert(BN % 32 == 0 && BN <= 256 && STAGES >= 2, "tile shapes");
  static_assert(kF32 || EPI != kFc1Gelu || BN % 64 == 0,
                "bf16 fc1 stores 64-wide boxes");
  extern __shared__ __align__(1024) unsigned char fc_smem[];
  unsigned char* smem = fc_smem + ((1024 - (smem_u32(fc_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int n_cols = (p.N + BN - 1) / BN;  // column tiles of a row tile
  const int n_tiles = n_cols * ((p.M + kFcRows - 1) / kFcRows);
  const int n_k = (p.K + DEPTH - 1) / DEPTH;

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
          tma_load_2d(st, &a_map, &full[s], t * DEPTH, m0);
          if constexpr (kF32) {  // B's big and small halves
            tma_load_3d(st + L::kA, &b_map, &full[s], t * DEPTH, n0, 0);
            tma_load_3d(st + L::kA + L::kB, &b_map, &full[s], t * DEPTH, n0,
                        1);
          } else {
            tma_load_2d(st + L::kA, &b_map, &full[s], t * DEPTH, n0);
          }
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
    if constexpr (kF32) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    }
    for (int t = 0; t < n_k; ++t, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const unsigned char* st = smem + s * L::kStage;
      // descriptors: rows of 128 bytes, make_desc's 64 bf16 values
      const uint64_t db = make_desc<64>(st + L::kA);
      if constexpr (kF32) {
        // this thread's A fragment of each k8 step (rows warp * 16 + g and
        // + 8 of the warpgroup's 64, columns 8 ks + t4 and + 4) from the
        // swizzled tile (16-byte unit u of row r at u ^ (r % 8), r % 8 = g:
        // a warp's loads hit 32 banks), split into its TF32 halves
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
        const uint64_t ds = make_desc<64>(st + L::kA + L::kB);  // B small
        float part[BN / 2];  // the stage's sum
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {  // a k8 step is 32 bytes
          WgmmaTf32<BN>::run(part, big[ks], ds + 2 * ks, ks > 0);
          WgmmaTf32<BN>::run(part, small[ks], db + 2 * ks, 1);
          WgmmaTf32<BN>::run(part, big[ks], db + 2 * ks, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();  // the stage's registers are rewritten next
        fence_regs(part);
        mbar_arrive(&empty[s]);
        // promoted into the float32 sum on the CUDA cores, rounded to
        // nearest (the tensor cores' own accumulation truncates: over a
        // whole K its error grows with K, ~1e-4 at fc2's K = 3072)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
      } else {
        const uint64_t da = make_desc<64>(st + wg * 64 * kFcRowBytes);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < DEPTH / 16; ++k)  // a k16 step is 32 bytes
          WgmmaSS<BN>::run(acc, da + 2 * k, db + 2 * k, t > 0 || k > 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        if (t > 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
    }
    if constexpr (!kF32) {
      wgmma_wait<0>();
      mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    fence_regs(acc);

    if constexpr (kF32) {
      // ---------------- float32: row m, columns n and n + 1 of the
      // accumulator (thread rows 16 warp + g (+ 8), columns 8 j + 2 t4)
      // straight to memory; columns past N (N % 8 == 0: a pair is whole or
      // out) and rows past M are not stored
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * t4;
        if (n >= p.N) continue;
        const float2 b = load2(p.bias + n);
        float2 gm = make_float2(1.f, 1.f);
        if constexpr (EPI == kFc2Residual) gm = load2(p.gamma + n);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int m = m0 + wg * 64 + warp * 16 + g + 8 * i;
          if (m >= p.M) continue;
          const float v0 = acc[4 * j + 2 * i] + b.x;
          const float v1 = acc[4 * j + 2 * i + 1] + b.y;
          float2 o;
          if constexpr (EPI == kFc1Gelu) {
            o = make_float2(gelu_erf(v0), gelu_erf(v1));
          } else {
            o = make_float2(v0 * gm.x, v1 * gm.y);
            if (p.x != nullptr) {  // else delta only
              const float2 xr = load2(p.x + (size_t)m * p.N + n);
              o = make_float2(xr.x + o.x, xr.y + o.y);
            }
          }
          *reinterpret_cast<float2*>(p.out + (size_t)m * p.N + n) = o;
        }
      }
    } else if constexpr (EPI == kFc1Gelu) {
      // ---------------- bf16 fc1: gelu(acc + b1) as bf16 into the boxes
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
      // ---------------- bf16 fc2: (acc + b2) gamma, float32, to the
      // staging tile (thread rows 16 warp + g (+ 8), columns 8 j + 2 t4
      // (+ 1)); columns past N (N % 8 == 0: a pair is whole or out) stage
      // anything
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
  if (!kF32 && EPI == kFc1Gelu && (tid & 127) == 0) tma_store_wait_read<0>();
}

template <typename T>
constexpr CUtensorMapDataType kMapType =
    std::is_same_v<T, float> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

// the K-major operand (rows, K) of a GEMM: boxes of one 128-byte row of K
// (64 bf16 or 32 float32 values) x box_rows, with the 128-byte swizzle;
// halves = 2: two such operands one after the other (the float32 weights'
// TF32 big and small halves), the third coordinate picking one
template <typename T>
inline bool encode_operand(CUtensorMap* map, const void* base, int rows,
                           int K, int box_rows, int halves = 1) {
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)rows,
                              (cuuint64_t)halves};
  const cuuint64_t strides[2] = {(cuuint64_t)K * sizeof(T),
                                 (cuuint64_t)rows * K * sizeof(T)};
  const cuuint32_t box[3] = {kFcRowBytes / (cuuint32_t)sizeof(T),
                             (cuuint32_t)box_rows, 1};
  return encode_map(map, base, halves > 1 ? 3 : 2, dims, strides, box,
                    Swizzle<64>::kTma, kMapType<T>);
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
template <typename T, int EPI, int BN>
cudaError_t launch_fc(const CUtensorMap& a_map, const CUtensorMap& b_map,
                      const CUtensorMap& c_map, const FcParams<T>& p,
                      cudaStream_t s) {
  auto kernel = convnext_block_fc_kernel<T, EPI, BN>;
  static int granted[kMaxDevices] = {};
  cudaError_t err = reserve_smem(kernel, FcSmem<T, EPI, BN>::kBytes, granted);
  int sms = 0;
  if (err == cudaSuccess) err = device_sms(&sms);
  if (err != cudaSuccess) return err;
  const int tiles = ((p.N + BN - 1) / BN) * ((p.M + kFcRows - 1) / kFcRows);
  kernel<<<tiles < sms ? tiles : sms, kFcThreads, FcSmem<T, EPI, BN>::kBytes,
           s>>>(a_map, b_map, c_map, p);
  return cudaGetLastError();
}

// the tile widths the plan may ask for (ops/convnext_block.py); fc2's 192
// in bf16 only (float32's two accumulators would not fit the registers)
constexpr int kFc1Width = 128;

template <typename T>
cudaError_t launch_fc2(int bn, const CUtensorMap& a_map,
                       const CUtensorMap& b_map, const FcParams<T>& p,
                       cudaStream_t s) {
  switch (bn) {
    case 64: return launch_fc<T, kFc2Residual, 64>(a_map, b_map, a_map, p, s);
    case 96: return launch_fc<T, kFc2Residual, 96>(a_map, b_map, a_map, p, s);
    case 128: return launch_fc<T, kFc2Residual, 128>(a_map, b_map, a_map, p, s);
  }
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    if (bn == 192)
      return launch_fc<T, kFc2Residual, 192>(a_map, b_map, a_map, p, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_prologue_rows(int tile_h, const CbArgs& a, int batch,
                                 T* xn, cudaStream_t s) {
  switch (tile_h) {
    case 1: return launch_prologue<T, 1>(a, batch, xn, s);
    case 2: return launch_prologue<T, 2>(a, batch, xn, s);
    case 4: return launch_prologue<T, 4>(a, batch, xn, s);
    case 8: return launch_prologue<T, 8>(a, batch, xn, s);
  }
  return cudaErrorInvalidValue;
}

// the three launches in T; xn (P, C) and h (P, HID) are T scratch, and
// float32 also takes a.w_split
template <typename T>
cudaError_t convnext_block_launches(const CbArgs& a, int batch, T* xn, T* h,
                                    int tile_h, int fc1_bn, int fc2_bn,
                                    cudaStream_t s) {
  constexpr bool kF32 = std::is_same_v<T, float>;
  if (xn == nullptr || h == nullptr || (kF32 && a.w_split == nullptr) ||
      tile_h * kCbTileW * a.C > kCbTileValues || a.tap_slab <= 0 ||
      a.tap_slab % 8 ||
      prologue_smem<T>(tile_h, a.C, a.tap_slab) > kCbSmemMax ||
      fc1_bn != kFc1Width)
    return cudaErrorInvalidValue;  // fc2_bn: launch_fc2 refuses the others
  const int n_pix = batch * a.H * a.W;
  if (n_pix == 0) return cudaSuccess;
  // B: the weights as they are (bf16), or their split copies (float32:
  // w1's halves, then w2's)
  const void* w1 = kF32 ? static_cast<const void*>(a.w_split) : a.w1;
  const void* w2 =
      kF32 ? static_cast<const void*>(a.w_split + 2 * (size_t)a.HID * a.C)
           : a.w2;
  const int halves = kF32 ? 2 : 1;
  CUtensorMap xn_map, w1_map, h_map, w2_map, hs_map;
  if (!encode_operand<T>(&xn_map, xn, n_pix, a.C, kFcRows) ||
      !encode_operand<T>(&w1_map, w1, a.HID, a.C, fc1_bn, halves) ||
      !encode_operand<T>(&h_map, h, n_pix, a.HID, kFcRows) ||
      !encode_operand<T>(&w2_map, w2, a.C, a.HID, fc2_bn, halves) ||
      !encode_operand<T>(&hs_map, h, n_pix, a.HID, 64))  // bf16 h's stores
    return cudaErrorInvalidValue;
  FcParams<T> f1, f2;
  f1.bias = static_cast<const T*>(a.b1);
  f1.x = f1.gamma = nullptr;
  f1.out = h;
  f1.M = n_pix, f1.N = a.HID, f1.K = a.C;
  f2.bias = static_cast<const T*>(a.b2);
  f2.x = static_cast<const T*>(a.shortcut);
  f2.gamma = static_cast<const T*>(a.gamma);
  f2.out = static_cast<T*>(a.out);
  f2.M = n_pix, f2.N = a.C, f2.K = a.HID;
  cudaError_t err = launch_prologue_rows<T>(tile_h, a, batch, xn, s);
  if (err == cudaSuccess)
    err = launch_fc<T, kFc1Gelu, kFc1Width>(xn_map, w1_map, hs_map, f1, s);
  if (err == cudaSuccess) err = launch_fc2<T>(fc2_bn, h_map, w2_map, f2, s);
  return err;
}

}  // namespace msa

// x, out (B, H, W, C); dw (C, 1, 7, 7); dw_b, ln_g, ln_b, b2, gamma (C);
// w1 (HID, C); b1 (HID); w2 (C, HID); all of one dtype, bf16 or float32.
// out = shortcut + block(x), shortcut x itself at inference; a null
// shortcut gives the delta block(x) alone (training: drop path comes
// between). C and HID multiples of 8. xn (B*H*W, C) and h (B*H*W, HID), of
// that dtype, are scratch, and float32 also takes w_split (4, HID * C)
// float32; tile_h (1, 2, 4 or 8; tile_h * 8 * C <= 16384), fc1_bn (128),
// fc2_bn (64, 96, 128, or 192 in bf16) and tap_slab (a multiple of 8
// whose taps fit the prologue's shared memory beside its tile) are the plan
// (ops/convnext_block.py:convnext_block_plan). Encodes the tensor maps and
// launches the prologue, fc1 and fc2 on `stream`; returns the first error.
extern "C" int msa_convnext_block(const void* x, const void* dw,
                                  const void* dw_b, const void* ln_g,
                                  const void* ln_b, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, const void* gamma,
                                  const void* shortcut, void* out,
                                  void* xn, void* h, void* w_split,
                                  int batch, int H, int W, int C, int HID,
                                  float eps, int tile_h, int fc1_bn,
                                  int fc2_bn, int tap_slab, int dtype,
                                  void* stream) {
  if (C <= 0 || C % 8 || HID <= 0 || HID % 8 || batch < 0 || H < 0 || W < 0)
    return cudaErrorInvalidValue;
  msa::CbArgs a;
  a.x = x, a.dw = dw, a.dw_b = dw_b, a.ln_g = ln_g, a.ln_b = ln_b;
  a.w1 = w1, a.b1 = b1, a.w2 = w2, a.b2 = b2, a.gamma = gamma;
  a.shortcut = shortcut, a.out = out;
  a.w_split = static_cast<float*>(w_split);
  a.H = H, a.W = W, a.C = C, a.HID = HID, a.tap_slab = tap_slab, a.eps = eps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == msa::kBFloat16)
    return msa::convnext_block_launches(
        a, batch, static_cast<__nv_bfloat16*>(xn),
        static_cast<__nv_bfloat16*>(h), tile_h, fc1_bn, fc2_bn, s);
  if (dtype == msa::kFloat32)
    return msa::convnext_block_launches(a, batch, static_cast<float*>(xn),
                                        static_cast<float*>(h), tile_h,
                                        fc1_bn, fc2_bn, s);
  return cudaErrorInvalidValue;
}
