// One ConvNeXt block, fused: depthwise 7x7 conv (zero padding) + bias ->
// LayerNorm over C (float32 statistics, eps) -> fc1 + bias -> exact (erf)
// GELU -> fc2 + bias -> layer scale gamma -> + shortcut. The 72 blocks of
// the twin ConvNeXt-small trunk (36 per branch) run it once each.
//
// Replaces: multimodal_sam_adapter_tpu/ops/convnext_block.py,
//   convnext_block_fused_fwd (Pallas kernel _kernel). Same arithmetic, one
//   difference of contract: this kernel returns the block output (the
//   shortcut added), where the TPU kernel returns the pre-residual delta and
//   leaves the add to XLA. The TPU kernel's seven shifted copies of x (its
//   W % 8 == 0 sublane alignment) and its moments-by-matmul are Mosaic
//   workarounds; here a tile reads its input with a 3-pixel halo that is
//   zero outside the image, so any H and W work.
//
// Layouts: x and out (B, H, W, C) contiguous (channels last); dw (C, 1, 7, 7)
// and the Linear weights w1 (HID, C), w2 (C, HID) as torch stores them: for
// each output column the reduction axis is contiguous, which is the "col"
// operand layout of mma.sync, so no weight is transposed.
//
// What bounds it on an H100: the two products, 16 * H * W * C^2 FLOP per
// block (9.7 GFLOP at every stage of the flagship trunk, ~0.7 TFLOP per
// forward), with ~2 * C^2 * 4 bytes of weights re-read from L2 per pixel
// tile: tensor-core issue and the latency of the weight tiles, once the
// depthwise conv is cheap.
//
// Design (bf16: tensor cores through mma.sync; wgmma/TMA come later):
//   - one block of 8 warps per spatial tile of TP = 16 * MT pixels (8 x 8
//     for MT = 4, 4 x 8 for MT = 2) of one image; tiles at the image edge
//     hold pixels outside it, which are computed and not stored.
//   - prologue: the depthwise conv from shared memory. 64 channels at a
//     time, the tile's input with its 3-pixel halo and the taps are staged
//     in shared memory; a thread keeps one channel's 49 taps in registers
//     and produces a column of TH outputs from (TH + 6) x 7 halo reads. Then
//     one warp per pixel computes the LayerNorm (two passes, float32) and
//     writes the normalised row as bf16: the A operand of fc1, resident in
//     shared memory for the block.
//   - the hidden axis is walked in chunks of HC (64, or 32 above C = 384):
//     h = gelu(xn @ w1[chunk] + b1) on the tensor cores, rounded to bf16 in
//     shared memory, then y += h @ w2[:, chunk]. The whole w1 chunk
//     (HC x C) and w2 chunk (C x HC) are staged by cp.async, each while the
//     other product runs: w1 of the next chunk lands during fc2, w2 of this
//     chunk during fc1. y (TP x C, float32) stays in registers: warp w owns
//     pixel rows 16 * (w % MT) and the channel slab (w / MT) * NTW * 8.
//   - MT = 4 (TP = 64) up to C = 192, MT = 2 (TP = 32) up to C = 768, so the
//     accumulator stays at <= 96 floats a thread (a 64-pixel float32
//     accumulator at C = 768 would be 192 KiB), and stage 3 (64 x 64 x 384)
//     has 128 tiles for the 132 SMs. Up to C = 384, 64-unit chunks halve
//     the barriers and weight round trips of 32-unit ones. (Stage 3 on an
//     H100 80GB HBM3 at 700 W: 64-pixel tiles 0.24 ms against 0.19 with
//     32-unit chunks, and 0.138 ms with 64-unit chunks.)
//   - the last stage has few tiles (32 x 32 pixels make 32 tiles of 32), so
//     the hidden axis may be split over `splits` blocks per tile
//     (msa_convnext_block_plan): each stores its float32 partial of y to a
//     scratch buffer, and the tile's last block sums the partials in split
//     order and writes the output. Each split block repeats the prologue.
//   - the prologue's buffers are dead once the normalised rows exist, so
//     the weight tiles reuse their shared memory.
//   - epilogue: (y + b2) * gamma + x in float32, one rounding to the output.
// float32 runs on the CUDA cores (4 x 4-pixel tiles, 16 hidden units a
// chunk, y accumulated in shared memory), for float32 parity.
#include "common.cuh"
#include "mma.cuh"

namespace msa {

constexpr int kCbThreads = 256;  // 8 warps
constexpr int kCbDwCC = 64;      // channels per staged halo slab
constexpr int kCbF32HC = 16;     // hidden units per chunk (float32)

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
  void* out;
  int n_pix;  // B * H * W
  int H, W, C, HID;
  float eps;
  // bf16: the hidden axis is split over `splits` blocks per pixel tile
  // (blockIdx.y); with splits > 1 each writes its float32 partial of y to
  // partials (splits, n_pix, C) and counts itself in counters[tile]
  // (zeroed by the caller)
  int splits;
  float* partials;
  int* counters;
};

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
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
// stride lds), two passes in float32, one warp per row; the normalised rows
// go to dst (row stride ldd), zero in the padding columns [C, Cpad). src and
// dst may be the same buffer: each lane rewrites only what it read.
template <typename T, typename D>
__device__ void layernorm_tile(const CbArgs& a, int TP, const float* src,
                               int lds, D* dst, int ldd, int Cpad) {
  const T* g = static_cast<const T*>(a.ln_g);
  const T* bb = static_cast<const T*>(a.ln_b);
  const int C = a.C;
  const int lane = threadIdx.x & 31;
  for (int p = threadIdx.x >> 5; p < TP; p += kCbThreads / 32) {
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
    for (int c = lane; c < Cpad; c += 32) {
      const float o =
          c < C ? (row[c] - mean) * rstd * to_float(g[c]) + to_float(bb[c])
                : 0.f;
      dst[p * ldd + c] = from_float<D>(o);
    }
  }
}

// ---------------------------------------------------------------- bf16
template <int MT, int HC_>
struct MmaGeom {
  static constexpr int TP = 16 * MT;           // pixels per tile
  static constexpr int TH = MT == 4 ? 8 : 4;   // tile rows
  static constexpr int TW = 8;                 // tile columns
  static constexpr int HC = HC_;               // hidden units per chunk
  static constexpr int LDH = HC + 8;           // padded rows of h, w2
  static constexpr int FN = HC * MT / 64;      // fc1 column tiles per warp
};

// The geometry by C: 64-pixel tiles up to C = 192; 32-pixel tiles above,
// so that y stays at <= 96 floats a thread; 64-unit hidden chunks up to
// C = 384, 32-unit chunks above, where two 64 x C weight tiles would not
// fit in shared memory beside the normalised rows.
using Narrow = MmaGeom<4, 64>;  // C <= 192
using Mid = MmaGeom<2, 64>;     // C <= 384
using Wide = MmaGeom<2, 32>;    // C <= 768

template <int MT, int HC>
size_t cb_mma_smem(int C) {
  using G = MmaGeom<MT, HC>;
  const int Kp = round_up(C, 16);
  const size_t xs = round_up(G::TP * (Kp + 8) * 2, 16);
  const size_t prologue = round_up(G::TP * C * 4, 16) +
                          halo_bytes<__nv_bfloat16, G::TH, G::TW>() +
                          kCbTapBytes;
  const size_t mlp =
      (size_t)(G::HC * (Kp + 8) + Kp * G::LDH + G::TP * G::LDH) * 2;
  return xs + (prologue > mlp ? prologue : mlp);
}

template <int MT, int HC_, int NTW>
__global__ void __launch_bounds__(kCbThreads)
    convnext_block_mma_kernel(CbArgs a) {
  static_assert(NTW % 2 == 0, "channel tiles go in pairs");
  using G = MmaGeom<MT, HC_>;
  using bf16 = __nv_bfloat16;
  constexpr int TP = G::TP, TW = G::TW, HC = G::HC, LDH = G::LDH;
  constexpr int FN = G::FN;
  const int C = a.C;
  const int HID = a.HID;
  const int Kp = round_up(C, 16);  // fc1 depth, padded to the mma's 16
  const int LDX = Kp + 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last_split;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [TP][LDX] normalised rows
  unsigned char* region = smem_raw + round_up(TP * LDX * 2, 16);
  // prologue
  float* scratch = reinterpret_cast<float*>(region);  // [TP][C]
  bf16* halo = reinterpret_cast<bf16*>(region + round_up(TP * C * 4, 16));
  float* taps = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(halo) +
      halo_bytes<bf16, G::TH, G::TW>());
  // products
  bf16* w1s = reinterpret_cast<bf16*>(region);  // [HC][LDX]
  bf16* w2s = w1s + HC * LDX;                   // [Kp][LDH]
  bf16* hs = w2s + Kp * LDH;                    // [TP][LDH]

  const bf16* w1 = static_cast<const bf16*>(a.w1);
  const bf16* w2 = static_cast<const bf16*>(a.w2);
  const bf16* b1 = static_cast<const bf16*>(a.b1);
  const Tile tl = block_tile<G::TH, TW>(a);

  depthwise_tile<bf16, G::TH, TW>(a, tl, scratch, C, halo, taps);
  __syncthreads();
  layernorm_tile<bf16, bf16>(a, TP, scratch, C, xs, LDX, Kp);
  __syncthreads();  // the prologue's buffers are free for the weights

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lm = lane >> 3;
  const int lr = lane & 7;
  const int mt = warp % MT;   // the warp's 16 pixel rows
  const int grp = warp / MT;  // its fc1 columns and fc2 channel slab
  // this block's share of the hidden chunks (blockIdx.y of a.splits)
  const int n_chunks = (HID + HC - 1) / HC;
  const int c_begin = blockIdx.y * n_chunks / a.splits;
  const int c_end = (blockIdx.y + 1) * n_chunks / a.splits;

  // async copies of w1[h0 : h0 + HC, :] and w2[:, h0 : h0 + HC], zero
  // outside the matrices
  auto load_w1 = [&](int h0) {
    const int nv = Kp / 8;
    for (int i = tid; i < HC * nv; i += kCbThreads) {
      const int j = i / nv;
      const int c8 = (i - j * nv) * 8;
      const bool ok = h0 + j < HID && c8 < C;
      cp_async16(w1s + j * LDX + c8,
                 ok ? w1 + (size_t)(h0 + j) * C + c8 : w1, ok);
    }
  };
  auto load_w2 = [&](int h0) {
    for (int i = tid; i < Kp * (HC / 8); i += kCbThreads) {
      const int n = i / (HC / 8);
      const int c8 = (i - n * (HC / 8)) * 8;
      const bool ok = n < C && h0 + c8 < HID;
      cp_async16(w2s + n * LDH + c8,
                 ok ? w2 + (size_t)n * HID + h0 + c8 : w2, ok);
    }
  };

  float y[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j) y[j][0] = y[j][1] = y[j][2] = y[j][3] = 0.f;

  if (c_begin < c_end) {
    load_w1(c_begin * HC);
    cp_async_commit();
  }
  for (int ci = c_begin; ci < c_end; ++ci) {
    const int h0 = ci * HC;
    load_w2(h0);  // lands while fc1 runs
    cp_async_commit();
    cp_async_wait<1>();  // w1 of this chunk
    __syncthreads();
    // ---- h = xn @ w1[chunk]^T: the warp's 16 rows x FN column tiles
    float hacc[FN][4];
#pragma unroll
    for (int j = 0; j < FN; ++j)
      hacc[j][0] = hacc[j][1] = hacc[j][2] = hacc[j][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < Kp / 16; ++kk) {
      uint32_t af[4];
      ldmatrix_x4(af, xs + (mt * 16 + (lane & 15)) * LDX + kk * 16 +
                          (lane >> 4) * 8);
      if constexpr (FN == 1) {
        uint32_t b[2];
        ldmatrix_x2(b, w1s + (grp * 8 + (lane & 7)) * LDX + kk * 16 +
                           ((lane >> 3) & 1) * 8);
        mma_bf16(hacc[0], af, b[0], b[1]);
      } else {
#pragma unroll
        for (int jp = 0; jp < FN / 2; ++jp) {
          const int nt = grp * FN + 2 * jp;
          uint32_t b[4];
          ldmatrix_x4(b, w1s + ((nt + (lm >> 1)) * 8 + lr) * LDX + kk * 16 +
                             (lm & 1) * 8);
          mma_bf16(hacc[2 * jp], af, b[0], b[1]);
          mma_bf16(hacc[2 * jp + 1], af, b[2], b[3]);
        }
      }
    }
    // ---- bias + GELU, rounded to bf16: the A operand of fc2
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      const int col = (grp * FN + j) * 8 + 2 * t;
      const int hid = h0 + col;
      const float bb0 = hid < HID ? to_float(b1[hid]) : 0.f;
      const float bb1 = hid + 1 < HID ? to_float(b1[hid + 1]) : 0.f;
      const int r = mt * 16 + g;
      *reinterpret_cast<uint32_t*>(hs + r * LDH + col) =
          pack_bf16(gelu_erf(hacc[j][0] + bb0), gelu_erf(hacc[j][1] + bb1));
      *reinterpret_cast<uint32_t*>(hs + (r + 8) * LDH + col) =
          pack_bf16(gelu_erf(hacc[j][2] + bb0), gelu_erf(hacc[j][3] + bb1));
    }
    __syncthreads();  // w1s consumed, h complete
    if (ci + 1 < c_end) {  // w1 of the next chunk lands while fc2 runs
      load_w1(h0 + HC);
      cp_async_commit();
      cp_async_wait<1>();  // w2 of this chunk
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // ---- y += h @ w2[:, chunk]^T on the warp's channel slab
#pragma unroll
    for (int kk = 0; kk < HC / 16; ++kk) {
      uint32_t af[4];
      ldmatrix_x4(af, hs + (mt * 16 + (lane & 15)) * LDH + kk * 16 +
                          (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < NTW / 2; ++jp) {
        const int nb = grp * NTW + 2 * jp;
        if (nb * 8 < C) {
          uint32_t b[4];
          ldmatrix_x4(b, w2s + ((nb + (lm >> 1)) * 8 + lr) * LDH + kk * 16 +
                             (lm & 1) * 8);
          mma_bf16(y[2 * jp], af, b[0], b[1]);
          mma_bf16(y[2 * jp + 1], af, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // w2s and h consumed
  }

  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* b2 = static_cast<const bf16*>(a.b2);
  const bf16* gm = static_cast<const bf16*>(a.gamma);
  bf16* out = static_cast<bf16*>(a.out);
  if (a.splits == 1) {
    // ---- out = x + (y + b2) * gamma, float32, one rounding
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const int c = (grp * NTW + j) * 8 + 2 * t;
      if (c >= C) continue;
      const float bb0 = to_float(b2[c]), bb1 = to_float(b2[c + 1]);
      const float g0 = to_float(gm[c]), g1 = to_float(gm[c + 1]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int P = tile_pixel<TW>(a, tl, mt * 16 + g + 8 * half);
        if (P < 0) continue;
        const size_t o = (size_t)P * C + c;
        const float2 xf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(x + o));
        *reinterpret_cast<uint32_t*>(out + o) =
            pack_bf16(xf.x + (y[j][2 * half] + bb0) * g0,
                      xf.y + (y[j][2 * half + 1] + bb1) * g1);
      }
    }
    return;
  }
  // ---- split hidden axis: store this block's partial y; the block that
  // finishes the tile last sums the partials in split order (the result
  // does not depend on the blocks' timing) and writes the output
  float* part = a.partials + (size_t)blockIdx.y * a.n_pix * C;
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const int c = (grp * NTW + j) * 8 + 2 * t;
    if (c >= C) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int P = tile_pixel<TW>(a, tl, mt * 16 + g + 8 * half);
      if (P >= 0)
        *reinterpret_cast<float2*>(part + (size_t)P * C + c) =
            make_float2(y[j][2 * half], y[j][2 * half + 1]);
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last_split = atomicAdd(a.counters + blockIdx.x, 1) == a.splits - 1;
  __syncthreads();
  if (!last_split) return;
  __threadfence();
  for (int i = tid; i < TP * C; i += kCbThreads) {
    const int P = tile_pixel<TW>(a, tl, i / C);
    if (P < 0) continue;
    const int c = i % C;
    const size_t o = (size_t)P * C + c;
    float acc = 0.f;
    for (int sp = 0; sp < a.splits; ++sp)
      acc += __ldcg(a.partials + (size_t)sp * a.n_pix * C + o);
    out[o] = __float2bfloat16(to_float(x[o]) +
                              (acc + to_float(b2[c])) * to_float(gm[c]));
  }
}

template <int MT, int HC, int NTW>
cudaError_t launch_cb_mma(const CbArgs& a, int batch, cudaStream_t s) {
  using G = MmaGeom<MT, HC>;
  auto kernel = convnext_block_mma_kernel<MT, HC, NTW>;
  const size_t smem = cb_mma_smem<MT, HC>(a.C);
  static int granted[kMaxDevices] = {};
  const cudaError_t err = reserve_smem(kernel, smem, granted);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_tiles(batch, a.H, a.W, G::TH, G::TW), a.splits);
  kernel<<<grid, kCbThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// The accumulator tiles a warp needs, rounded up to an instantiated size.
template <typename G>
cudaError_t dispatch_cb_mma(const CbArgs& a, int batch, cudaStream_t s) {
  constexpr int MT = G::TP / 16, HC = G::HC;
  const int need = (a.C + 8 * (8 / MT) - 1) / (8 * (8 / MT));
  if constexpr (MT == 4) {  // C <= 192
    if (need <= 4) return launch_cb_mma<MT, HC, 4>(a, batch, s);
    if (need <= 8) return launch_cb_mma<MT, HC, 8>(a, batch, s);
    if (need <= 12) return launch_cb_mma<MT, HC, 12>(a, batch, s);
  } else if constexpr (HC == 64) {  // 192 < C <= 384
    if (need <= 8) return launch_cb_mma<MT, HC, 8>(a, batch, s);
    if (need <= 12) return launch_cb_mma<MT, HC, 12>(a, batch, s);
  } else {  // 384 < C <= 768
    if (need <= 16) return launch_cb_mma<MT, HC, 16>(a, batch, s);
    if (need <= 24) return launch_cb_mma<MT, HC, 24>(a, batch, s);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- float32
constexpr int kF32TH = 4, kF32TW = 4, kF32TP = kF32TH * kF32TW;

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

  const float* x = static_cast<const float*>(a.x);
  const float* w1 = static_cast<const float*>(a.w1);
  const float* w2 = static_cast<const float*>(a.w2);
  const float* b1 = static_cast<const float*>(a.b1);
  const int tid = threadIdx.x;
  const Tile tl = block_tile<kF32TH, kF32TW>(a);

  depthwise_tile<float, kF32TH, kF32TW>(a, tl, xs, LDX, halo, taps);
  __syncthreads();
  layernorm_tile<float, float>(a, TP, xs, LDX, xs, LDX, C);
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
  float* out = static_cast<float*>(a.out);
  for (int i = tid; i < TP * C; i += kCbThreads) {
    const int P = tile_pixel<kF32TW>(a, tl, i / C);
    if (P < 0) continue;
    const int n = i % C;
    const size_t o = (size_t)P * C + n;
    out[o] = x[o] + (ys[i] + b2[n]) * gm[n];
  }
}

}  // namespace msa

// Launch plan of the bf16 kernel for a (batch, H, W, C) input with HID
// hidden units on a card of `sms` SMs. Returns the pixel tiles (the grid's
// x extent, one counter each when splitting), or -1 when C or HID is not
// supported, and sets *splits, the blocks that share each tile's hidden
// axis. Few tiles (the last stage: 32^2 pixels make 32 tiles) would leave
// most SMs idle, so the hidden axis is split as far as the blocks still
// run in one wave (one block fits an SM): on an H100 80GB HBM3 at 700 W
// the 32^2 and 25^2 stages ran fastest at 4 splits (128 and 112 blocks),
// at 5 (two waves) 1.6x slower.
extern "C" int msa_convnext_block_plan(int batch, int H, int W, int C,
                                       int HID, int sms, int* splits) {
  if (C <= 0 || C % 8 || C > 768 || HID <= 0 || HID % 8) return -1;
  const int th = C <= 192 ? msa::Narrow::TH : msa::Wide::TH;
  const int tw = C <= 192 ? msa::Narrow::TW : msa::Wide::TW;
  const int hc = C <= 384 ? msa::Mid::HC : msa::Wide::HC;
  const int tiles = msa::n_tiles(batch, H, W, th, tw);
  const int chunks = (HID + hc - 1) / hc;
  const int want = tiles ? sms / tiles : 1;
  *splits = want < 1 ? 1 : (want > chunks ? chunks : want);
  return tiles;
}

// x, out (B, H, W, C); dw (C, 1, 7, 7); dw_b, ln_g, ln_b, b2, gamma (C);
// w1 (HID, C); b1 (HID); w2 (C, HID); all of one dtype. out = x + block(x).
// C and HID multiples of 8, C at most 768. bf16: `splits` blocks share each
// pixel tile's hidden axis (msa_convnext_block_plan); with splits > 1,
// partials is float32 (splits, B*H*W, C) scratch and counters one zeroed
// int per tile. float32: splits must be 1.
extern "C" int msa_convnext_block(const void* x, const void* dw,
                                  const void* dw_b, const void* ln_g,
                                  const void* ln_b, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, const void* gamma, void* out,
                                  int batch, int H, int W, int C, int HID,
                                  float eps, int splits, void* partials,
                                  void* counters, int dtype, void* stream) {
  int max_splits = 1;
  if (msa_convnext_block_plan(batch, H, W, C, HID, 1 << 30, &max_splits) <
          0 ||
      splits < 1 || splits > max_splits ||
      (splits > 1 && (!partials || !counters || dtype != msa::kBFloat16)))
    return cudaErrorInvalidValue;
  msa::CbArgs a;
  a.x = x, a.dw = dw, a.dw_b = dw_b, a.ln_g = ln_g, a.ln_b = ln_b;
  a.w1 = w1, a.b1 = b1, a.w2 = w2, a.b2 = b2, a.gamma = gamma, a.out = out;
  a.n_pix = batch * H * W;
  a.H = H, a.W = W, a.C = C, a.HID = HID, a.eps = eps;
  a.splits = splits;
  a.partials = static_cast<float*>(partials);
  a.counters = static_cast<int*>(counters);
  if (a.n_pix == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == msa::kBFloat16) {
    if (C <= 192) return msa::dispatch_cb_mma<msa::Narrow>(a, batch, s);
    if (C <= 384) return msa::dispatch_cb_mma<msa::Mid>(a, batch, s);
    return msa::dispatch_cb_mma<msa::Wide>(a, batch, s);
  }
  if (dtype != msa::kFloat32) return cudaErrorInvalidValue;
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
