// Softmax attention with the decomposed relative-position bias of SAM's
// ViT, shared by the windowed (window_attention.cu) and the global
// (flash_attention.cu) kernels.
//
// For one (image or window, head) pair and a query q at grid cell (qh, qw):
//
//   out[q] = sum_k softmax_k(scale * q.k + bias_h[q, kh] + bias_w[q, kw]) v[k]
//
// with the key k at grid cell (kh, kw). The two kernels differ only in where
// the bias rows come from:
//   kTables = true : computed here from the get_rel_pos tables,
//                    bias_h[q, kh] = q . Rh[qh * grid_h + kh]  (unscaled q)
//   kTables = false: read from rel_h (B*heads, N, grid_h) and
//                    rel_w (B*heads, N, grid_w), precomputed in torch in
//                    float32 (in bf16 their rounding alone moves the
//                    softmax visibly: the terms reach |q||R| ~ 10).
//
// Layouts: qkv is the raw (nb, N, 3*C) projection with C = heads * D and the
// feature order f = s*C + h*D + dd (s = 0/1/2 for q/k/v); out is the
// heads-packed (nb, N, C). Neither side needs a head-split transpose.
//
// This file holds the float32 kernel, on the CUDA cores; bfloat16 inputs go
// to the tensor-core kernel of rel_pos_attention_mma.cuh, which computes the
// same thing. dispatch_rel_pos_attention (below) picks by dtype.
//
// Design of the float32 kernel:
//   - one block per (query tile of kBQ, nb*heads); one thread per query. The
//     thread keeps its query row and its output accumulator in registers.
//   - the block walks the keys in tiles of kBK: K and V rows are staged in
//     shared memory as float32, every thread reads the same key row, so the
//     loads are broadcasts; float4 reads give four FMAs per load.
//   - online softmax in float32: per tile, one rescale of the accumulator.
//   - the per-query bias rows live in shared memory, column-major over the
//     block's queries with a padded stride, so the per-key bias reads are
//     conflict-free.
//   - ragged tails (N = 196 for a 14x14 window is not a multiple of the
//     tiles) are masked: missing keys score -inf, missing queries skip the
//     store.
#pragma once

#include "common.cuh"
#include "rel_pos_attention_mma.cuh"

namespace msa {

constexpr int kBQ = 64;       // queries per block, one per thread
constexpr int kBK = 32;       // keys per shared-memory tile
constexpr int kLD = kBQ + 1;  // padded stride of the bias rows

inline size_t rel_pos_attention_smem(int head_dim, int grid_h, int grid_w) {
  return sizeof(float) * (2 * kBK * head_dim + (grid_h + grid_w) * kLD) +
         sizeof(int) * 2 * kBK;
}

template <int D, bool kTables>
__global__ void __launch_bounds__(kBQ)
    rel_pos_attention_kernel(const float* __restrict__ qkv,
                             const float* __restrict__ rel_a,
                             const float* __restrict__ rel_b,
                             float* __restrict__ out,
                             int n_tok, int heads, int grid_h, int grid_w,
                             float scale) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                 // [kBK][D]
  float* vs = ks + kBK * D;         // [kBK][D]
  float* bh = vs + kBK * D;         // [grid_h][kLD]
  float* bw = bh + grid_h * kLD;    // [grid_w][kLD]
  int* key_h = reinterpret_cast<int*>(bw + grid_w * kLD);  // [kBK]
  int* key_w = key_h + kBK;                                // [kBK]

  const int tid = threadIdx.x;
  const int bm = blockIdx.y;  // image (or window) * heads + head
  const int b = bm / heads;
  const int h = bm - b * heads;
  const int C = heads * D;
  const int q0 = blockIdx.x * kBQ;
  const int qi = q0 + tid;
  const bool valid = qi < n_tok;
  const float* base = qkv + (size_t)b * n_tok * 3 * C + h * D;

  float q[D];
#pragma unroll
  for (int c = 0; c < D; ++c)
    q[c] = valid ? base[(size_t)qi * 3 * C + c] : 0.f;

  // ---- bias rows of this block's queries
  if (kTables) {
    const int qh = valid ? qi / grid_w : 0;
    const int qw = valid ? qi - (qi / grid_w) * grid_w : 0;
    for (int kh = 0; kh < grid_h; ++kh) {
      const float* r = rel_a + ((size_t)qh * grid_h + kh) * D;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) acc += q[c] * r[c];
      bh[kh * kLD + tid] = acc;
    }
    for (int kw = 0; kw < grid_w; ++kw) {
      const float* r = rel_b + ((size_t)qw * grid_w + kw) * D;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) acc += q[c] * r[c];
      bw[kw * kLD + tid] = acc;
    }
  } else {
    const float* ra = rel_a + ((size_t)bm * n_tok + q0) * grid_h;
    for (int i = tid; i < kBQ * grid_h; i += kBQ) {
      const int t = i / grid_h;
      const int kh = i - t * grid_h;
      bh[kh * kLD + t] = (q0 + t < n_tok) ? ra[i] : 0.f;
    }
    const float* rb = rel_b + ((size_t)bm * n_tok + q0) * grid_w;
    for (int i = tid; i < kBQ * grid_w; i += kBQ) {
      const int t = i / grid_w;
      const int kw = i - t * grid_w;
      bw[kw * kLD + t] = (q0 + t < n_tok) ? rb[i] : 0.f;
    }
  }

  float m = -INFINITY;
  float l = 0.f;
  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;

  for (int k0 = 0; k0 < n_tok; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed, the bias rows written
    for (int i = tid; i < kBK * D; i += kBQ) {
      const int j = i / D;
      const int c = i - j * D;
      const int key = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < n_tok) {
        const float* row = base + (size_t)key * 3 * C + c;
        kv = row[C];
        vv = row[2 * C];
      }
      ks[i] = kv;
      vs[i] = vv;
    }
    if (tid < kBK) {
      const int key = k0 + tid;
      key_h[tid] = key < n_tok ? key / grid_w : -1;
      key_w[tid] = key < n_tok ? key - (key / grid_w) * grid_w : -1;
    }
    __syncthreads();

    // q.k for the tile's keys: channels outer, keys inner, so the kBK
    // partial sums are independent FMA chains (one chain per key would
    // leave each thread waiting on FMA latency)
    float s[kBK];
#pragma unroll
    for (int j = 0; j < kBK; ++j) s[j] = 0.f;
#pragma unroll
    for (int c4 = 0; c4 < D / 4; ++c4) {
#pragma unroll
      for (int j = 0; j < kBK; ++j) {
        const float4 kk = reinterpret_cast<const float4*>(ks + j * D)[c4];
        s[j] += q[4 * c4] * kk.x + q[4 * c4 + 1] * kk.y +
                q[4 * c4 + 2] * kk.z + q[4 * c4 + 3] * kk.w;
      }
    }
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const int kh = key_h[j];
      s[j] = kh >= 0 ? s[j] * scale + bh[kh * kLD + tid] +
                           bw[key_w[j] * kLD + tid]
                     : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    // the tile holds key k0 < n_tok, so m_new is finite
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] *= corr;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
      const float4* vr = reinterpret_cast<const float4*>(vs + j * D);
#pragma unroll
      for (int c4 = 0; c4 < D / 4; ++c4) {
        const float4 vv = vr[c4];
        acc[4 * c4] += p * vv.x;
        acc[4 * c4 + 1] += p * vv.y;
        acc[4 * c4 + 2] += p * vv.z;
        acc[4 * c4 + 3] += p * vv.w;
      }
    }
    m = m_new;
  }

  if (valid) {
    const float inv = 1.f / l;
    float* o = out + ((size_t)b * n_tok + qi) * C + h * D;
#pragma unroll
    for (int c = 0; c < D; ++c) o[c] = acc[c] * inv;
  }
}

template <int D, bool kTables>
cudaError_t launch_rel_pos_attention(const void* qkv, const void* rel_a,
                                     const void* rel_b, void* out, int nb,
                                     int heads, int grid_h, int grid_w,
                                     float scale, cudaStream_t stream) {
  auto kernel = rel_pos_attention_kernel<D, kTables>;
  const size_t smem = rel_pos_attention_smem(D, grid_h, grid_w);
  static int granted[kMaxDevices] = {};
  const cudaError_t err = reserve_smem(kernel, smem, granted);
  if (err != cudaSuccess) return err;
  const int n_tok = grid_h * grid_w;
  const dim3 grid((n_tok + kBQ - 1) / kBQ, nb * heads);
  kernel<<<grid, kBQ, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(rel_a),
      static_cast<const float*>(rel_b), static_cast<float*>(out), n_tok, heads,
      grid_h, grid_w, scale);
  return cudaGetLastError();
}

// Instantiates the kernels for SAM ViT-B/L's head width 64 and the narrow
// test configurations' 16 and 32; any other width is refused. bfloat16 runs
// on the tensor cores, float32 on the CUDA cores.
template <bool kTables>
int dispatch_rel_pos_attention(const void* qkv, const void* rel_a,
                               const void* rel_b, void* out, int nb,
                               int heads, int head_dim, int grid_h,
                               int grid_w, float scale, int dtype,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MSA_ATTN_CASE(DIM)                                                   \
  case DIM:                                                                  \
    return dtype == kBFloat16                                                \
               ? launch_rel_pos_attention_mma<DIM, kTables>(                 \
                     qkv, rel_a, rel_b, out, nb, heads, grid_h, grid_w,      \
                     scale, s)                                               \
               : launch_rel_pos_attention<DIM, kTables>(                     \
                     qkv, rel_a, rel_b, out, nb, heads, grid_h, grid_w,      \
                     scale, s);
  if (dtype != kFloat32 && dtype != kBFloat16) return cudaErrorInvalidValue;
  switch (head_dim) {
    MSA_ATTN_CASE(16)
    MSA_ATTN_CASE(32)
    MSA_ATTN_CASE(64)
    default:
      return cudaErrorInvalidValue;
  }
#undef MSA_ATTN_CASE
}

}  // namespace msa
