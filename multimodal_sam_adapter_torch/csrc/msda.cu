// Multi-scale deformable attention from the module's raw projections: the
// softmax of the attention logits over levels x points, the absolute
// sampling coordinates, bilinear sampling with zero padding and the
// weighted sum, in one kernel. The level count and the points per level
// are template parameters, so the same source serves the injectors
// (3 levels) and the extractors (1 level).
//
// Replaces: multimodal_sam_adapter_tpu/ops/msda_pallas.py,
//   _digit_pallas_call_multi_prep (kernel _digit_kernel_multi_prep, L = 3)
//   and _digit_pallas_call_prep (kernel _digit_kernel_prep, L = 1), both
//   driven by ms_deform_attn_digit_flat_fwd from the flat projections, with
//   the prep of _quad_prep_body inside. Same math: the weights are the
//   softmax over all L*P logits of a (query, head), the sample at absolute
//   level-grid coordinates (x, y) = (ref_x * W + off_x - 0.5,
//   ref_y * H + off_y - 0.5) weighs its four corners bilinearly, and a
//   corner outside [0, W-1] x [0, H-1] contributes zero (grid_sample with
//   align_corners=False and zero padding). The TPU kernel's quadrant tables
//   and digit/one-hot contraction exist because the TPU has no fast
//   gather; here each corner is a direct load. The corner weights stay in
//   float32 (the TPU kernel rounds them to bf16).
//
// What bounds it on an H100: the corner gather. At the flagship shapes the
// value tensor (at most 21504 x 512 values, 22 MB in bf16) fits the 50 MB
// L2, so the corners are L2 reads: 4 corners x D values a sample, ~352 MB
// a call for the extractors, ~201 MB for the injectors, at a few TB/s. No
// shared memory, wgmma or TMA helps a data-dependent gather.
//
// Design (launch plan from ops/msda_cuda.py:msda_plan):
// - one group of `lanes` = D / VEC threads a (batch, query, head): block
//   (lanes, heads a block, queries a block), grid (query blocks, batch,
//   head groups), so every index comes from the thread and block indices
//   without a division, and all of it is 32-bit (the plan keeps each
//   batch's tensors < 2^31);
// - each lane reads the (query, head)'s L*P logits and 2*L*P offsets with
//   the widest loads their row alignment allows, and does the softmax and
//   the coordinate prep in registers (each lane of the group alike);
// - per level, every corner's row and in-bounds mask first, then all 4*P
//   corner loads (VEC channels each, 16 bytes at D = 32 in bf16, through
//   the read-only path; an out-of-bounds corner is not loaded), then the
//   float32 FMAs; the VEC channels go out in one store.
#include <cstdint>

#include "common.cuh"

namespace msa {

constexpr int kMsdaMaxLevels = 4;
constexpr int kMsdaMaxThreads = 256;  // threads a block (and the plan's cap)

struct MsdaGeometry {
  int n_query, heads, head_dim;
  int value_batch, proj_batch, ref_batch, out_batch;  // elements per batch
  int h[kMsdaMaxLevels], w[kMsdaMaxLevels], start[kMsdaMaxLevels];
};

// BYTES of contiguous values, loaded and stored in one instruction
template <int BYTES> struct RawOf;
template <> struct RawOf<16> { using type = uint4; };
template <> struct RawOf<8> { using type = uint2; };
template <> struct RawOf<4> { using type = unsigned int; };
template <> struct RawOf<2> { using type = unsigned short; };

__device__ __forceinline__ unsigned word(uint4 r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}
__device__ __forceinline__ unsigned word(uint2 r, int i) {
  return i == 0 ? r.x : r.y;
}
__device__ __forceinline__ unsigned word(unsigned r, int) { return r; }
__device__ __forceinline__ unsigned word(unsigned short r, int) { return r; }

// value `i` of a raw vector of T
template <typename T, typename R>
__device__ __forceinline__ float element(R r, int i) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(word(r, i));
  } else {
    const unsigned w = word(r, i >> 1);
    return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
  }
}

template <typename T>
__device__ __forceinline__ unsigned bits(float x) {
  if constexpr (sizeof(T) == 4) {
    return __float_as_uint(x);
  } else {
    return __bfloat16_as_ushort(__float2bfloat16(x));
  }
}

// VEC floats -> one raw vector of T
template <typename T, int VEC>
__device__ __forceinline__ typename RawOf<VEC * sizeof(T)>::type pack(
    const float (&v)[VEC]) {
  using R = typename RawOf<VEC * sizeof(T)>::type;
  constexpr int kWords = (VEC * (int)sizeof(T) + 3) / 4;
  unsigned w[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    if constexpr (sizeof(T) == 4) {
      w[i] = bits<T>(v[i]);
    } else if constexpr (VEC == 1) {
      w[i] = bits<T>(v[0]);
    } else {
      w[i] = bits<T>(v[2 * i]) | (bits<T>(v[2 * i + 1]) << 16);
    }
  }
  if constexpr (sizeof(R) == 16) {
    return make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (sizeof(R) == 8) {
    return make_uint2(w[0], w[1]);
  } else if constexpr (sizeof(R) == 4) {
    return w[0];
  } else {
    return (unsigned short)w[0];
  }
}

// N contiguous values of T at p (aligned to the row's own alignment: the
// base is 16-byte aligned and p a whole number of rows past it) as floats
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* p, float (&v)[N]) {
  constexpr int kBytes = N * (int)sizeof(T);
  constexpr int kChunk = kBytes % 16 == 0 ? 16
                         : kBytes % 8 == 0 ? 8
                         : kBytes % 4 == 0 ? 4 : 2;
  constexpr int kPer = kChunk / (int)sizeof(T);
  using R = typename RawOf<kChunk>::type;
  const R* rp = reinterpret_cast<const R*>(p);
#pragma unroll
  for (int c = 0; c < N / kPer; ++c) {
    const R r = __ldg(rp + c);
#pragma unroll
    for (int i = 0; i < kPer; ++i) v[c * kPer + i] = element<T>(r, i);
  }
}

template <typename T, int L, int P, int VEC>
__global__ void __launch_bounds__(kMsdaMaxThreads)
    msda_gather_kernel(const T* __restrict__ value,
                       const T* __restrict__ offsets,
                       const T* __restrict__ logits,
                       const float* __restrict__ ref, T* __restrict__ out,
                       MsdaGeometry g) {
  using R = typename RawOf<VEC * sizeof(T)>::type;
  constexpr int LP = L * P;
  const int lane = threadIdx.x;
  const int m = blockIdx.z * blockDim.y + threadIdx.y;
  const int q = blockIdx.x * blockDim.z + threadIdx.z;
  if (q >= g.n_query) return;
  const int b = blockIdx.y;
  const int pair = q * g.heads + m;

  float a[LP];
  load_row<T, LP>(logits + (size_t)b * g.proj_batch * LP + pair * LP, a);
  float off[2 * LP];
  load_row<T, 2 * LP>(
      offsets + (size_t)b * g.proj_batch * (2 * LP) + pair * (2 * LP), off);
  float mx = a[0];
#pragma unroll
  for (int k = 1; k < LP; ++k) mx = fmaxf(mx, a[k]);
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < LP; ++k) {
    a[k] = expf(a[k] - mx);
    sum += a[k];
  }
#pragma unroll
  for (int k = 0; k < LP; ++k) a[k] = a[k] / sum;

  const float* rp = ref + (size_t)b * g.ref_batch + q * (2 * L);
  const int row = g.heads * g.head_dim;  // values per value row
  const T* vb = value + (size_t)b * g.value_batch + m * g.head_dim +
                lane * VEC;
  float acc[VEC];
#pragma unroll
  for (int c = 0; c < VEC; ++c) acc[c] = 0.f;

#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int H = g.h[l];
    const int W = g.w[l];
    // (x, y) in the order of the plain path's prep: ref * wh + off - 0.5
    const float bx = __fmul_rn(__ldg(rp + 2 * l), (float)W);
    const float by = __fmul_rn(__ldg(rp + 2 * l + 1), (float)H);
    int idx[4 * P];    // corner rows, -1: out of bounds (not loaded)
    float wt[4 * P];   // corner weights x attention weight
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int k = l * P + p;
      const float x = __fadd_rn(__fadd_rn(bx, off[2 * k]), -0.5f);
      const float y = __fadd_rn(__fadd_rn(by, off[2 * k + 1]), -0.5f);
      const bool in = x > -1.f && y > -1.f && x < (float)W && y < (float)H;
      const float x0f = floorf(in ? x : 0.f);
      const float y0f = floorf(in ? y : 0.f);
      const float tx = x - x0f;
      const float ty = y - y0f;
      const int x0 = (int)x0f;
      const int y0 = (int)y0f;
      const bool left = in && x0 >= 0, right = in && x0 + 1 < W;
      const bool top = in && y0 >= 0, bottom = in && y0 + 1 < H;
      const int r0 = g.start[l] + y0 * W + x0;
      idx[4 * p + 0] = top && left ? r0 : -1;
      idx[4 * p + 1] = top && right ? r0 + 1 : -1;
      idx[4 * p + 2] = bottom && left ? r0 + W : -1;
      idx[4 * p + 3] = bottom && right ? r0 + W + 1 : -1;
      wt[4 * p + 0] = (1.f - tx) * (1.f - ty) * a[k];
      wt[4 * p + 1] = tx * (1.f - ty) * a[k];
      wt[4 * p + 2] = (1.f - tx) * ty * a[k];
      wt[4 * p + 3] = tx * ty * a[k];
    }
    R raw[4 * P];
#pragma unroll
    for (int c = 0; c < 4 * P; ++c) {
      raw[c] = idx[c] >= 0
                   ? __ldg(reinterpret_cast<const R*>(vb + idx[c] * row))
                   : R{};
    }
#pragma unroll
    for (int c = 0; c < 4 * P; ++c) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        acc[i] = fmaf(wt[c], element<T>(raw[c], i), acc[i]);
      }
    }
  }
  *reinterpret_cast<R*>(out + (size_t)b * g.out_batch + pair * g.head_dim +
                        lane * VEC) = pack<T, VEC>(acc);
}

template <typename T, int L, int P, int VEC>
cudaError_t launch(const void* value, const void* offsets,
                   const void* logits, const float* ref, void* out,
                   const MsdaGeometry& g, int lanes, int heads_per_block,
                   int queries_per_block, int query_blocks, int batch,
                   cudaStream_t s) {
  const dim3 block(lanes, heads_per_block, queries_per_block);
  const dim3 grid(query_blocks, batch, g.heads / heads_per_block);
  msda_gather_kernel<T, L, P, VEC><<<grid, block, 0, s>>>(
      static_cast<const T*>(value), static_cast<const T*>(offsets),
      static_cast<const T*>(logits), ref, static_cast<T*>(out), g);
  return cudaGetLastError();
}

template <typename T, int L, int P>
cudaError_t launch_vec(int vec, const void* value, const void* offsets,
                       const void* logits, const float* ref, void* out,
                       const MsdaGeometry& g, int lanes, int hpb, int qpb,
                       int qblocks, int batch, cudaStream_t s) {
#define MSA_MSDA_VEC(V)                                                   \
  case V:                                                                 \
    return launch<T, L, P, V>(value, offsets, logits, ref, out, g, lanes, \
                              hpb, qpb, qblocks, batch, s);
  switch (vec) {
    MSA_MSDA_VEC(1)
    MSA_MSDA_VEC(2)
    MSA_MSDA_VEC(4)
    default:
      if constexpr (sizeof(T) == 2) {
        if (vec == 8) {
          return launch<T, L, P, 8>(value, offsets, logits, ref, out, g,
                                    lanes, hpb, qpb, qblocks, batch, s);
        }
      }
      return cudaErrorInvalidValue;
  }
#undef MSA_MSDA_VEC
}

template <typename T, int L>
cudaError_t launch_points(int points, int vec, const void* value,
                          const void* offsets, const void* logits,
                          const float* ref, void* out, const MsdaGeometry& g,
                          int lanes, int hpb, int qpb, int qblocks, int batch,
                          cudaStream_t s) {
  if (points == 2) {
    return launch_vec<T, L, 2>(vec, value, offsets, logits, ref, out, g,
                               lanes, hpb, qpb, qblocks, batch, s);
  }
  if (points == 4) {
    return launch_vec<T, L, 4>(vec, value, offsets, logits, ref, out, g,
                               lanes, hpb, qpb, qblocks, batch, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_levels(int levels, int points, int vec, const void* value,
                          const void* offsets, const void* logits,
                          const float* ref, void* out, const MsdaGeometry& g,
                          int lanes, int hpb, int qpb, int qblocks, int batch,
                          cudaStream_t s) {
  switch (levels) {
    case 1:
      return launch_points<T, 1>(points, vec, value, offsets, logits, ref,
                                 out, g, lanes, hpb, qpb, qblocks, batch, s);
    case 2:
      return launch_points<T, 2>(points, vec, value, offsets, logits, ref,
                                 out, g, lanes, hpb, qpb, qblocks, batch, s);
    case 3:
      return launch_points<T, 3>(points, vec, value, offsets, logits, ref,
                                 out, g, lanes, hpb, qpb, qblocks, batch, s);
    case 4:
      return launch_points<T, 4>(points, vec, value, offsets, logits, ref,
                                 out, g, lanes, hpb, qpb, qblocks, batch, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace msa

// value (B, S, heads*head_dim); offsets (B, Lq, heads*levels*points*2) and
// logits (B, Lq, heads*levels*points) in value's dtype, 16-byte aligned;
// ref (B or 1, Lq, levels, 2) float32, ref_batch_stride 0 to broadcast one
// batch; out (B, Lq, heads*head_dim). shapes: host array of (H, W) per
// level. vec, lanes, heads_per_block, queries_per_block, query_blocks: the
// launch plan of ops/msda_cuda.py:msda_plan; a plan that breaks an
// invariant below is refused with cudaErrorInvalidValue and nothing
// launches.
extern "C" int msa_deform_attn(const void* value, const void* offsets,
                               const void* logits, const void* ref,
                               void* out, int batch, int n_query, int n_val,
                               int heads, int head_dim, int levels,
                               int points, const int* shapes,
                               int ref_batch_stride, int vec, int lanes,
                               int heads_per_block, int queries_per_block,
                               int query_blocks, int dtype, void* stream) {
  const int esize = dtype == msa::kBFloat16 ? 2 : 4;
  if ((dtype != msa::kBFloat16 && dtype != msa::kFloat32) || levels < 1 ||
      levels > msa::kMsdaMaxLevels || batch < 1 || n_query < 1 ||
      heads < 1 || head_dim < 1 || queries_per_block < 1 ||
      heads_per_block < 1 || heads % heads_per_block ||
      heads / heads_per_block > 65535 ||
      batch > 65535 || queries_per_block > 64 || lanes * vec != head_dim ||
      vec * esize > 16 ||
      (long long)lanes * heads_per_block * queries_per_block >
          msa::kMsdaMaxThreads ||
      (long long)query_blocks * queries_per_block < n_query ||
      (long long)(query_blocks - 1) * queries_per_block >= n_query ||
      reinterpret_cast<uintptr_t>(value) % (vec * esize) ||
      reinterpret_cast<uintptr_t>(offsets) % 16 ||
      reinterpret_cast<uintptr_t>(logits) % 16 ||
      reinterpret_cast<uintptr_t>(ref) % 4 ||
      (ref_batch_stride != 0 && ref_batch_stride != n_query * levels * 2)) {
    return cudaErrorInvalidValue;
  }
  msa::MsdaGeometry g;
  g.n_query = n_query;
  g.heads = heads;
  g.head_dim = head_dim;
  long long start = 0;
  for (int l = 0; l < levels; ++l) {
    g.h[l] = shapes[2 * l];
    g.w[l] = shapes[2 * l + 1];
    if (g.h[l] < 1 || g.w[l] < 1) return cudaErrorInvalidValue;
    g.start[l] = (int)start;
    start += (long long)g.h[l] * g.w[l];
  }
  const long long row = (long long)heads * head_dim;
  const long long proj = (long long)n_query * heads;
  if (start != n_val || n_val * row >= (1LL << 31) ||
      proj * levels * points * 2 >= (1LL << 31) ||
      n_query * row >= (1LL << 31)) {
    return cudaErrorInvalidValue;
  }
  g.value_batch = (int)(n_val * row);
  g.proj_batch = (int)proj;
  g.ref_batch = ref_batch_stride;
  g.out_batch = (int)(n_query * row);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(ref);
  if (dtype == msa::kBFloat16) {
    return msa::launch_levels<__nv_bfloat16>(
        levels, points, vec, value, offsets, logits, r, out, g, lanes,
        heads_per_block, queries_per_block, query_blocks, batch, s);
  }
  return msa::launch_levels<float>(
      levels, points, vec, value, offsets, logits, r, out, g, lanes,
      heads_per_block, queries_per_block, query_blocks, batch, s);
}
