// The bfloat16 form of rel_pos_attention.cuh: the same attention with the
// decomposed rel-pos bias, with the two products q.k and p.v on the tensor
// cores (mma.sync m16n8k16, bf16 operands, float32 accumulators), in the
// register layout of FlashAttention-2.
//
// Design (tensor cores through mma.sync; wgmma/TMA come later):
//   - one block of 4 warps per (query tile of kMmaBQ = 64, nb * heads); each
//     warp owns 16 query rows. The warp's q fragments stay in registers for
//     the whole key loop; so do its output accumulator (16 x D, float32) and
//     its running row max and row sum.
//   - the block walks the keys in tiles of kMmaBK = 64: K and V rows are
//     staged in shared memory as bf16 (rows padded to D + 8 values, so the
//     8 rows an ldmatrix reads fall on distinct banks); ldmatrix gives the
//     B fragments of q.k, ldmatrix.trans those of p.v from the same
//     row-major V.
//   - scores are scaled, biased and masked in the accumulator layout; the
//     online softmax runs in float32 on exp2 (log2-scaled scores); the
//     probabilities are rounded to bf16 and reused in registers as the A
//     fragments of p.v, as FlashAttention-2 does.
//   - the bias rows of the block's queries live in shared memory as float32,
//     column-major over the queries with stride 68: the 8 rows x 4 key
//     columns a warp reads at once fall on 32 distinct banks.
//   - ragged tails are masked as in the float32 kernel: missing keys score
//     -inf (their K/V rows are zero), missing queries skip the store.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace msa {

constexpr int kMmaBQ = 64;         // queries per block, 16 per warp
constexpr int kMmaBK = 64;         // keys per shared-memory tile
constexpr int kMmaThreads = 128;   // 4 warps
constexpr int kMmaLDB = kMmaBQ + 4;  // stride of the bias rows

inline size_t rel_pos_attention_mma_smem(int head_dim, int grid_h,
                                         int grid_w) {
  return sizeof(__nv_bfloat16) * (kMmaBQ + 2 * kMmaBK) * (head_dim + 8) +
         sizeof(float) * (grid_h + grid_w) * kMmaLDB +
         sizeof(int) * 2 * kMmaBK;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16, row-major) * b (16x8, col-major), bf16 in, float32 out
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// kTables: as in rel_pos_attention.cuh (true: bias from the (N, D) bf16
// tables; false: from the float32 rel_h / rel_w terms).
template <int D, bool kTables>
__global__ void __launch_bounds__(kMmaThreads)
    rel_pos_attention_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                                 const void* __restrict__ rel_a,
                                 const void* __restrict__ rel_b,
                                 __nv_bfloat16* __restrict__ out, int n_tok,
                                 int heads, int grid_h, int grid_w,
                                 float scale) {
  static_assert(D % 16 == 0, "head width must be a multiple of 16");
  constexpr int LD = D + 8;        // padded row of the bf16 tiles
  constexpr int CH = D / 8;        // 16-byte chunks per row
  constexpr float kLog2e = 1.4426950408889634f;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kMmaBQ * LD;
  __nv_bfloat16* vs = ks + kMmaBK * LD;
  float* bh = reinterpret_cast<float*>(vs + kMmaBK * LD);  // [grid_h][LDB]
  float* bw = bh + grid_h * kMmaLDB;                       // [grid_w][LDB]
  int* key_h = reinterpret_cast<int*>(bw + grid_w * kMmaLDB);
  int* key_w = key_h + kMmaBK;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row within the 8-row group
  const int t = lane & 3;   // column pair
  const int bm = blockIdx.y;
  const int b = bm / heads;
  const int h = bm - b * heads;
  const int C = heads * D;
  const int q0 = blockIdx.x * kMmaBQ;
  const __nv_bfloat16* base = qkv + (size_t)b * n_tok * 3 * C + h * D;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  // ---- q tile (zero rows past the end)
  for (int i = tid; i < kMmaBQ * CH; i += kMmaThreads) {
    const int r = i / CH;
    const int c = (i - r * CH) * 8;
    const int qi = q0 + r;
    *reinterpret_cast<uint4*>(qs + r * LD + c) =
        qi < n_tok
            ? *reinterpret_cast<const uint4*>(base + (size_t)qi * 3 * C + c)
            : zero;
  }
  __syncthreads();

  // ---- bias rows of this block's queries
  if (kTables) {
    // threads 0-63 the h terms, 64-127 the w terms, one query each
    const int r = tid & (kMmaBQ - 1);
    const bool w_side = tid >= kMmaBQ;
    const int qi = q0 + r;
    const bool valid = qi < n_tok;
    const int qpos = valid ? (w_side ? qi % grid_w : qi / grid_w) : 0;
    const int n = w_side ? grid_w : grid_h;
    const __nv_bfloat16* tab =
        static_cast<const __nv_bfloat16*>(w_side ? rel_b : rel_a) +
        (size_t)qpos * n * D;
    float* dst = w_side ? bw : bh;
    // the query row in float32 registers; table rows read 8 values a load
    float qv[D];
#pragma unroll
    for (int c = 0; c < D; c += 2) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(qs + r * LD + c));
      qv[c] = f.x;
      qv[c + 1] = f.y;
    }
    for (int k = 0; k < n; ++k) {
      const uint4* row = reinterpret_cast<const uint4*>(tab + k * D);
      float acc = 0.f;
#pragma unroll
      for (int c8 = 0; c8 < D / 8; ++c8) {
        const uint4 u = row[c8];
        const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(p[e]);
          acc += qv[8 * c8 + 2 * e] * f.x + qv[8 * c8 + 2 * e + 1] * f.y;
        }
      }
      dst[k * kMmaLDB + r] = valid ? acc : 0.f;
    }
  } else {
    const float* ra =
        static_cast<const float*>(rel_a) + ((size_t)bm * n_tok + q0) * grid_h;
    for (int i = tid; i < kMmaBQ * grid_h; i += kMmaThreads) {
      const int r = i / grid_h;
      const int kh = i - r * grid_h;
      bh[kh * kMmaLDB + r] = (q0 + r < n_tok) ? ra[i] : 0.f;
    }
    const float* rb =
        static_cast<const float*>(rel_b) + ((size_t)bm * n_tok + q0) * grid_w;
    for (int i = tid; i < kMmaBQ * grid_w; i += kMmaThreads) {
      const int r = i / grid_w;
      const int kw = i - r * grid_w;
      bw[kw * kMmaLDB + r] = (q0 + r < n_tok) ? rb[i] : 0.f;
    }
  }

  // ---- the warp's q fragments (A operand of q.k), kept in registers
  const int r0 = warp * 16 + g;  // this thread's two rows: r0 and r0 + 8
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* p = qs + r0 * LD + kk * 16 + 2 * t;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(p);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(p + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
  }

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  // ldmatrix row addresses of this lane: matrix lane / 8, row lane % 8
  const int lm = lane >> 3;
  const int lr = lane & 7;
  // a warp whose 16 rows are all past the end (the ragged last tile of a
  // 196-token window) only helps to load the tiles
  const bool warp_active = q0 + warp * 16 < n_tok;

  for (int k0 = 0; k0 < n_tok; k0 += kMmaBK) {
    __syncthreads();  // the previous tile is consumed, the bias rows written
    for (int i = tid; i < kMmaBK * CH; i += kMmaThreads) {
      const int r = i / CH;
      const int c = (i - r * CH) * 8;
      const int key = k0 + r;
      uint4 kv = zero, vv = zero;
      if (key < n_tok) {
        const __nv_bfloat16* row = base + (size_t)key * 3 * C + c;
        kv = *reinterpret_cast<const uint4*>(row + C);
        vv = *reinterpret_cast<const uint4*>(row + 2 * C);
      }
      *reinterpret_cast<uint4*>(ks + r * LD + c) = kv;
      *reinterpret_cast<uint4*>(vs + r * LD + c) = vv;
    }
    if (tid < kMmaBK) {
      const int key = k0 + tid;
      key_h[tid] = key < n_tok ? key / grid_w : -1;
      key_w[tid] = key < n_tok ? key - (key / grid_w) * grid_w : 0;
    }
    __syncthreads();
    if (!warp_active) continue;

    // s = q.k: 16 rows x 64 keys per warp, 8 accumulator tiles of 16x8
    float s[kMmaBK / 8][4];
#pragma unroll
    for (int j = 0; j < kMmaBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < kMmaBK / 16; ++jp) {
        // matrices: (keys 2jp, d lo), (2jp, d hi), (2jp+1, lo), (2jp+1, hi)
        uint32_t kb[4];
        ldmatrix_x4(kb, ks + ((2 * jp + (lm >> 1)) * 8 + lr) * LD + kk * 16 +
                            (lm & 1) * 8);
        mma_bf16(s[2 * jp], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // scale, bias and mask in log2 units; the tile's row maxima
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kMmaBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j * 8 + 2 * t + e;
        const int kh = key_h[c];
        const int kw = key_w[c];
        if (kh < 0) {
          s[j][e] = -INFINITY;
          s[j][2 + e] = -INFINITY;
        } else {
          s[j][e] = (s[j][e] * scale + bh[kh * kMmaLDB + r0] +
                     bw[kw * kMmaLDB + r0]) * kLog2e;
          s[j][2 + e] = (s[j][2 + e] * scale + bh[kh * kMmaLDB + r0 + 8] +
                         bw[kw * kMmaLDB + r0 + 8]) * kLog2e;
        }
        mx[0] = fmaxf(mx[0], s[j][e]);
        mx[1] = fmaxf(mx[1], s[j][2 + e]);
      }
    }
    // the 4 lanes of a row hold its 64 scores between them
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    // the tile holds key k0 < n_tok, so the new maxima are finite
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m_run[i], mx[i]);
      corr[i] = exp2f(m_run[i] - m_new);
      m_run[i] = m_new;
      l_run[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }

    // p = exp2(s - m), rounded to bf16 as the A fragments of p.v: the
    // accumulator tiles 2kk and 2kk+1 are the key columns of k-step kk
    uint32_t pf[kMmaBK / 16][4];
#pragma unroll
    for (int j = 0; j < kMmaBK / 8; ++j) {
      const float p0 = exp2f(s[j][0] - m_run[0]);
      const float p1 = exp2f(s[j][1] - m_run[0]);
      const float p2 = exp2f(s[j][2] - m_run[1]);
      const float p3 = exp2f(s[j][3] - m_run[1]);
      l_run[0] += p0 + p1;
      l_run[1] += p2 + p3;
      pf[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // o += p.v
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < D / 16; ++jp) {
        // matrices: (keys lo, d 2jp), (keys hi, 2jp), (lo, 2jp+1), (hi, 2jp+1)
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vs + (kk * 16 + (lm & 1) * 8 + lr) * LD +
                                  (2 * jp + (lm >> 1)) * 8);
        mma_bf16(o[2 * jp], pf[kk], vb[0], vb[1]);
        mma_bf16(o[2 * jp + 1], pf[kk], vb[2], vb[3]);
      }
    }
  }

  // ---- normalise and store the heads-packed rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  const float inv0 = 1.f / l_run[0];
  const float inv1 = 1.f / l_run[1];
  const int qa = q0 + r0;
  const int qb = qa + 8;
  __nv_bfloat16* oa = out + ((size_t)b * n_tok + qa) * C + h * D + 2 * t;
  __nv_bfloat16* ob = oa + (size_t)8 * C;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (qa < n_tok)
      *reinterpret_cast<uint32_t*>(oa + j * 8) =
          pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
    if (qb < n_tok)
      *reinterpret_cast<uint32_t*>(ob + j * 8) =
          pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
  }
}

template <int D, bool kTables>
cudaError_t launch_rel_pos_attention_mma(const void* qkv, const void* rel_a,
                                         const void* rel_b, void* out, int nb,
                                         int heads, int grid_h, int grid_w,
                                         float scale, cudaStream_t stream) {
  auto kernel = rel_pos_attention_mma_kernel<D, kTables>;
  const size_t smem = rel_pos_attention_mma_smem(D, grid_h, grid_w);
  static int granted[kMaxDevices] = {};
  const cudaError_t err = reserve_smem(kernel, smem, granted);
  if (err != cudaSuccess) return err;
  const int n_tok = grid_h * grid_w;
  const dim3 grid((n_tok + kMmaBQ - 1) / kMmaBQ, nb * heads);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), rel_a, rel_b,
      static_cast<__nv_bfloat16*>(out), n_tok, heads, grid_h, grid_w, scale);
  return cudaGetLastError();
}

}  // namespace msa
