// The eval-mode f1 assembly of the backbone, fused:
//   f1 = BN_eval(depth_to_space(ConvTranspose2x2s2(c2)) + c1 + x1)
// as one GEMM with an epilogue. The 2x2 stride-2 transposed conv is one
// product c2 (pixels x C) @ W (C x 4*O); column n = o * 4 + dy * 2 + dx of
// the product is channel o of output pixel (2h + dy, 2w + dx). The
// epilogue adds c1 and x1 and applies the per-channel affine (the eval
// BatchNorm, with the transposed conv's bias folded into the shift) in
// float32 and writes each phase straight to its interleaved output pixel:
// the depth-to-space never exists as a tensor.
//
// Replaces: multimodal_sam_adapter_tpu/ops/pixel_shuffle.py,
//   pixel_shuffle_up_bn (Pallas kernel _up_bn_kernel). Same arithmetic; the
//   TPU kernel walks one input row per grid step with the whole weight
//   resident, here blocks tile the product.
//
// Layouts, as the backbone already holds them (no permute around the
// call): c2 is the adapter's token stream, pixel rows of C contiguous
// values (row stride C, batch stride given); W is torch's ConvTranspose2d
// weight (C, O, 2, 2), i.e. row-major C x 4*O; c1 and x1 are (B, O, 2H, 2W)
// with any element strides; out is (B, O, 2H, 2W) contiguous.
//
// What bounds it on an H100: at the flagship shape the product is
// 16384 x 1024 x 4096 (137 GFLOP), the largest of the forward, against
// ~400 MB of c1, x1 and output traffic: tensor-core throughput first, then
// the epilogue's bytes.
//
// Design (bf16: mma.sync, float32 accumulators; wgmma/TMA come later):
//   - a block computes a 64-pixel x 128-column tile (32 channels x 4
//     phases) with 4 warps in a 2 x 2 grid, each warp 32 x 64; k is staged
//     32 at a time in two cp.async stages (the next slab lands while this
//     one is multiplied): c2 rows as the A operand (ldmatrix), W rows as the
//     B operand (ldmatrix.trans from the row-major tile).
//   - the accumulator tile goes through shared memory as float32; the
//     epilogue then walks the output in memory order (channel, output row,
//     output column), so the reads of c1, x1 and the stores of f1 are
//     coalesced along output rows.
// float32 runs on the CUDA cores: the same tiles, each of 256 threads
// computing 4 x 8 outputs from 16-deep shared-memory tiles.
#include "common.cuh"
#include "mma.cuh"

namespace msa {

constexpr int kPsBM = 64;   // pixels of c2 per block
constexpr int kPsBN = 128;  // product columns per block (32 channels x 4)
constexpr int kPsLDT = kPsBN + 1;  // padded row of the float32 tile

struct PsArgs {
  const void* c2;
  long long c2_bs;  // batch stride of c2, elements
  const void* wt;
  const void* c1;
  long long c1_s[4];
  const void* x1;
  long long x1_s[4];
  const float* scale;
  const float* shift;
  void* out;
  int B, H, W, C, O;
};

// out = (tile + c1 + x1) * scale + shift for the block's 64 pixels x 32
// channels x 4 phases, in output memory order.
template <typename T>
__device__ void ps_epilogue(const PsArgs& a, const float* tile, int m0,
                            int n0, int nthreads) {
  const T* c1 = static_cast<const T*>(a.c1);
  const T* x1 = static_cast<const T*>(a.x1);
  T* out = static_cast<T*>(a.out);
  const int HW = a.H * a.W;
  const int M = a.B * HW;
  const int OH = 2 * a.H, OW = 2 * a.W;
  for (int e = threadIdx.x; e < kPsBM * kPsBN; e += nthreads) {
    const int dx = e & 1;
    const int m = (e >> 1) & (kPsBM - 1);
    const int dy = (e >> 7) & 1;
    const int ol = e >> 8;
    const int P = m0 + m;
    if (P >= M) continue;
    const int b = P / HW;
    const int r = P - b * HW;
    const int h = r / a.W;
    const int w = r - h * a.W;
    const int o = n0 / 4 + ol;
    const int oy = 2 * h + dy, ox = 2 * w + dx;
    float v = tile[m * kPsLDT + ol * 4 + dy * 2 + dx];
    v += to_float(c1[b * a.c1_s[0] + o * a.c1_s[1] + oy * a.c1_s[2] +
                     ox * a.c1_s[3]]);
    v += to_float(x1[b * a.x1_s[0] + o * a.x1_s[1] + oy * a.x1_s[2] +
                     ox * a.x1_s[3]]);
    v = v * a.scale[o] + a.shift[o];
    out[(((size_t)b * a.O + o) * OH + oy) * OW + ox] = from_float<T>(v);
  }
}

constexpr int kPsMmaThreads = 128;
constexpr int kPsMmaBK = 32;
constexpr int kPsLDA = kPsMmaBK + 8;
constexpr int kPsLDB = kPsBN + 8;

inline size_t ps_smem() {
  const size_t tiles = sizeof(__nv_bfloat16) * 2 *
                       (kPsBM * kPsLDA + kPsMmaBK * kPsLDB);
  const size_t out = sizeof(float) * kPsBM * kPsLDT;
  return tiles > out ? tiles : out;
}

__global__ void __launch_bounds__(kPsMmaThreads)
    pixel_shuffle_mma_kernel(PsArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int kStage = kPsBM * kPsLDA + kPsMmaBK * kPsLDB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // two stages of {A [BM][LDA], B [BK][LDB]}; the float32 tile reuses them
  bf16* stages = reinterpret_cast<bf16*>(smem_raw);
  float* tile = reinterpret_cast<float*>(smem_raw);  // [BM][LDT], after

  const bf16* c2 = static_cast<const bf16*>(a.c2);
  const bf16* wt = static_cast<const bf16*>(a.wt);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lm = lane >> 3;
  const int lr = lane & 7;
  const int wm = warp & 1;   // rows 32 * wm
  const int wn = warp >> 1;  // columns 64 * wn
  const int m0 = blockIdx.x * kPsBM;
  const int n0 = blockIdx.y * kPsBN;
  const int HW = a.H * a.W;
  const int M = a.B * HW;
  const int N = 4 * a.O;
  const int C = a.C;

  // async copies of k-slab [k0, k0 + BK) of the A and B tiles, zero past
  // the matrices
  auto load = [&](int k0, bf16* st) {
    bf16* As = st;
    bf16* Bs = st + kPsBM * kPsLDA;
    for (int i = tid; i < kPsBM * (kPsMmaBK / 8); i += kPsMmaThreads) {
      const int r = i / (kPsMmaBK / 8);
      const int c8 = (i - r * (kPsMmaBK / 8)) * 8;
      const int P = m0 + r;
      const bool ok = P < M && k0 + c8 < C;
      const int b = ok ? P / HW : 0;
      cp_async16(As + r * kPsLDA + c8,
                 ok ? c2 + b * a.c2_bs + (size_t)(P - b * HW) * C + k0 + c8
                    : c2,
                 ok);
    }
    for (int i = tid; i < kPsMmaBK * (kPsBN / 8); i += kPsMmaThreads) {
      const int r = i / (kPsBN / 8);
      const int c8 = (i - r * (kPsBN / 8)) * 8;
      const bool ok = k0 + r < C;
      cp_async16(Bs + r * kPsLDB + c8,
                 ok ? wt + (size_t)(k0 + r) * N + n0 + c8 : wt, ok);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int nkt = (C + kPsMmaBK - 1) / kPsMmaBK;
  load(0, stages);
  cp_async_commit();
  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) {  // the next slab lands while this one is used
      load((kt + 1) * kPsMmaBK, stages + ((kt + 1) & 1) * kStage);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* As = stages + (kt & 1) * kStage;
    const bf16* Bs = As + kPsBM * kPsLDA;
#pragma unroll
    for (int kk = 0; kk < kPsMmaBK / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(af[i], As + (wm * 32 + i * 16 + (lane & 15)) * kPsLDA +
                               kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Bs + (kk * 16 + (lm & 1) * 8 + lr) * kPsLDB +
                                 wn * 64 + (2 * jp + (lm >> 1)) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * jp], af[i], b[0], b[1]);
          mma_bf16(acc[i][2 * jp + 1], af[i], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // the slab is consumed before it is refilled
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = wm * 32 + i * 16 + g;
      const int c = wn * 64 + j * 8 + 2 * t;
      tile[r * kPsLDT + c] = acc[i][j][0];
      tile[r * kPsLDT + c + 1] = acc[i][j][1];
      tile[(r + 8) * kPsLDT + c] = acc[i][j][2];
      tile[(r + 8) * kPsLDT + c + 1] = acc[i][j][3];
    }
  }
  __syncthreads();
  ps_epilogue<bf16>(a, tile, m0, n0, kPsMmaThreads);
}

constexpr int kPsF32Threads = 256;
constexpr int kPsF32BK = 16;

__global__ void __launch_bounds__(kPsF32Threads)
    pixel_shuffle_f32_kernel(PsArgs a) {
  __shared__ __align__(16) float smem[kPsBM * kPsLDT];
  float* As = smem;                     // [BK][BM], k-major
  float* Bs = smem + kPsF32BK * kPsBM;  // [BK][BN]
  float* tile = smem;                   // [BM][LDT], after

  const float* c2 = static_cast<const float*>(a.c2);
  const float* wt = static_cast<const float*>(a.wt);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows 4 * ty
  const int tx = tid & 15;  // columns 8 * tx
  const int m0 = blockIdx.x * kPsBM;
  const int n0 = blockIdx.y * kPsBN;
  const int HW = a.H * a.W;
  const int M = a.B * HW;
  const int N = 4 * a.O;
  const int C = a.C;

  float acc[4][8] = {};
  for (int k0 = 0; k0 < C; k0 += kPsF32BK) {
    __syncthreads();
    for (int i = tid; i < kPsBM * kPsF32BK; i += kPsF32Threads) {
      const int r = i / kPsF32BK;
      const int kk = i - r * kPsF32BK;
      const int P = m0 + r;
      const int k = k0 + kk;
      float v = 0.f;
      if (P < M && k < C) {
        const int b = P / HW;
        v = c2[b * a.c2_bs + (size_t)(P - b * HW) * C + k];
      }
      As[kk * kPsBM + r] = v;
    }
    for (int i = tid; i < kPsF32BK * kPsBN; i += kPsF32Threads) {
      const int kk = i / kPsBN;
      const int c = i - kk * kPsBN;
      const int k = k0 + kk;
      Bs[kk * kPsBN + c] = k < C ? wt[(size_t)k * N + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kPsF32BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(As + kk * kPsBM +
                                                          4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * kPsBN +
                                                          8 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(Bs + kk * kPsBN +
                                                          8 * tx + 4);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += ar[i] * br[j];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      tile[(4 * ty + i) * kPsLDT + 8 * tx + j] = acc[i][j];
  __syncthreads();
  ps_epilogue<float>(a, tile, m0, n0, kPsF32Threads);
}

}  // namespace msa

// c2: pixel rows of C values, image b at c2 + b * c2_bs; wt (C, O, 2, 2);
// c1, x1 (B, O, 2H, 2W) with element strides c1_s*, x1_s*; scale, shift (O)
// float32; out (B, O, 2H, 2W) contiguous. C % 8 == 0, O % 32 == 0.
extern "C" int msa_pixel_shuffle_up_bn(
    const void* c2, long long c2_bs, const void* wt, const void* c1,
    long long c1_s0, long long c1_s1, long long c1_s2, long long c1_s3,
    const void* x1, long long x1_s0, long long x1_s1, long long x1_s2,
    long long x1_s3, const void* scale, const void* shift, void* out,
    int batch, int H, int W, int C, int O, int dtype, void* stream) {
  if (C % 8 || O % 32 || C <= 0 || O <= 0) return cudaErrorInvalidValue;
  msa::PsArgs a;
  a.c2 = c2;
  a.c2_bs = c2_bs;
  a.wt = wt;
  a.c1 = c1;
  a.c1_s[0] = c1_s0, a.c1_s[1] = c1_s1, a.c1_s[2] = c1_s2, a.c1_s[3] = c1_s3;
  a.x1 = x1;
  a.x1_s[0] = x1_s0, a.x1_s[1] = x1_s1, a.x1_s[2] = x1_s2, a.x1_s[3] = x1_s3;
  a.scale = static_cast<const float*>(scale);
  a.shift = static_cast<const float*>(shift);
  a.out = out;
  a.B = batch, a.H = H, a.W = W, a.C = C, a.O = O;
  const long long M = (long long)batch * H * W;
  if (M == 0) return cudaSuccess;
  const dim3 grid((unsigned)((M + msa::kPsBM - 1) / msa::kPsBM),
                  (unsigned)(4 * O / msa::kPsBN));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == msa::kBFloat16) {
    auto kernel = msa::pixel_shuffle_mma_kernel;
    const size_t smem = msa::ps_smem();
    static int granted[msa::kMaxDevices] = {};
    const cudaError_t err = msa::reserve_smem(kernel, smem, granted);
    if (err != cudaSuccess) return err;
    kernel<<<grid, msa::kPsMmaThreads, smem, s>>>(a);
  } else if (dtype == msa::kFloat32) {
    msa::pixel_shuffle_f32_kernel<<<grid, msa::kPsF32Threads, 0, s>>>(a);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
