// Multi-scale deformable attention: bilinear sampling with zero padding,
// weighted by the per-head attention weights and summed over levels and
// points. One kernel serves the injectors (3 levels) and the extractors
// (1 level); the level count is a launch parameter.
//
// Replaces: multimodal_sam_adapter_tpu/ops/msda_pallas.py,
//   _digit_pallas_call_multi_prep (kernel _digit_kernel_multi_prep, L = 3)
//   and _digit_pallas_call_prep (kernel _digit_kernel_prep, L = 1), both
//   driven by ms_deform_attn_digit_flat_fwd. Same math: for each sample at
//   absolute level-grid coordinates (x, y) = (ref_x * W + off_x - 0.5,
//   ref_y * H + off_y - 0.5), the four corners around it are weighted
//   bilinearly and a corner outside [0, W-1] x [0, H-1] contributes zero
//   (grid_sample with align_corners=False and zero padding). The TPU
//   kernel's quadrant tables and digit/one-hot contraction exist because the
//   TPU has no fast gather; here each corner is a direct load. The corner
//   weights are kept in float32 (the TPU kernel rounds them to bf16).
//
// What bounds it on an H100: memory latency of the scattered corner loads.
// At the flagship shapes the value tensor is at most 21504 x 512 values
// (22 MB in bf16), which fits the 50 MB L2, so the loads are L2 hits and
// the kernel does ~4 loads per 8 FLOP: it is load-issue and latency bound,
// not DRAM bound.
//
// Design: one thread per output element (batch, query, head, channel),
// channel fastest. The D = 32 threads of a warp then share one
// (query, head): they read the same coordinates and weights (broadcast
// loads) and each corner of the value tensor as one contiguous 64-byte
// (bf16) row segment, so every corner load is coalesced.
#include "common.cuh"

namespace msa {

constexpr int kMaxLevels = 4;
constexpr int kThreads = 256;

struct Levels {
  int n;
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    msda_kernel(const T* __restrict__ value, const float* __restrict__ coords,
                const float* __restrict__ attn, T* __restrict__ out,
                int n_query, int n_val, int heads, int head_dim, int points,
                Levels lv, long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int d = (int)(idx % head_dim);
  long long t = idx / head_dim;
  const int m = (int)(t % heads);
  t /= heads;
  const int q = (int)(t % n_query);
  const long long b = t / n_query;

  const int lp = lv.n * points;
  const long long qm = (b * n_query + q) * heads + m;
  const float* cp = coords + qm * lp * 2;
  const float* ap = attn + qm * lp;
  const long long row = (long long)heads * head_dim;

  float acc = 0.f;
  for (int l = 0; l < lv.n; ++l) {
    const int H = lv.h[l];
    const int W = lv.w[l];
    const T* v = value + (b * n_val + lv.start[l]) * row + m * head_dim + d;
    for (int p = 0; p < points; ++p) {
      const int k = l * points + p;
      const float x = cp[2 * k];
      const float y = cp[2 * k + 1];
      if (!(x > -1.f && y > -1.f && x < (float)W && y < (float)H)) continue;
      const float x0f = floorf(x);
      const float y0f = floorf(y);
      const float tx = x - x0f;
      const float ty = y - y0f;
      const int x0 = (int)x0f;
      const int y0 = (int)y0f;
      float s = 0.f;
      if (y0 >= 0) {
        const T* r = v + (long long)y0 * W * row;
        if (x0 >= 0) s += (1.f - tx) * (1.f - ty) * to_float(r[x0 * row]);
        if (x0 + 1 < W) s += tx * (1.f - ty) * to_float(r[(x0 + 1) * row]);
      }
      if (y0 + 1 < H) {
        const T* r = v + (long long)(y0 + 1) * W * row;
        if (x0 >= 0) s += (1.f - tx) * ty * to_float(r[x0 * row]);
        if (x0 + 1 < W) s += tx * ty * to_float(r[(x0 + 1) * row]);
      }
      acc += ap[k] * s;
    }
  }
  out[idx] = from_float<T>(acc);
}

}  // namespace msa

// value (B, S, heads*head_dim); coords (B, Lq, heads, levels, points, 2)
// float32 absolute (x, y); attn (B, Lq, heads, levels, points) float32;
// out (B, Lq, heads*head_dim). shapes: host array of (H, W) per level.
extern "C" int msa_deform_attn(const void* value, const void* coords,
                               const void* attn, void* out, int batch,
                               int n_query, int n_val, int heads,
                               int head_dim, int levels, int points,
                               const int* shapes, int dtype, void* stream) {
  if (levels < 1 || levels > msa::kMaxLevels) return cudaErrorInvalidValue;
  msa::Levels lv;
  lv.n = levels;
  int start = 0;
  for (int l = 0; l < levels; ++l) {
    lv.h[l] = shapes[2 * l];
    lv.w[l] = shapes[2 * l + 1];
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  if (start != n_val) return cudaErrorInvalidValue;
  const long long total = (long long)batch * n_query * heads * head_dim;
  if (total == 0) return cudaSuccess;
  const long long blocks = (total + msa::kThreads - 1) / msa::kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == msa::kBFloat16) {
    msa::msda_kernel<__nv_bfloat16><<<(unsigned)blocks, msa::kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(value),
        static_cast<const float*>(coords), static_cast<const float*>(attn),
        static_cast<__nv_bfloat16*>(out), n_query, n_val, heads, head_dim,
        points, lv, total);
  } else if (dtype == msa::kFloat32) {
    msa::msda_kernel<float><<<(unsigned)blocks, msa::kThreads, 0, s>>>(
        static_cast<const float*>(value), static_cast<const float*>(coords),
        static_cast<const float*>(attn), static_cast<float*>(out), n_query,
        n_val, heads, head_dim, points, lv, total);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
