// K2: global (whole-grid) attention with the decomposed rel-pos bias (SAM
// ViT, the 4 global blocks of ViT-L over the 64x64 token grid).
//
// Replaces: multimodal_sam_adapter_tpu/ops/flash_attention.py,
//   flash_attention_lane (Pallas kernel _flash_lane_kernel). Same contract:
//   the raw (B, N, 3*C) qkv projection in, heads-packed (B, N, C) out, the
//   bias rel_h[q, k // W] + rel_w[q, k % W] from the unscaled q, the scale
//   on q.k only. The TPU kernel's per-head lane masks, bias-expand matrix
//   and ones-column softmax denominator are MXU/VPU workarounds and have no
//   counterpart.
//
// What bounds it on an H100: tensor-core FLOP and the exp per score. Per
// (image, head) it does 2 x 2 x 4096^2 x 64 FLOP over 4 x 4096 x 64 bf16
// values in and out (~1000 FLOP a byte): 69.8 GFLOP at 1024^2, 71 us at
// 989 TFLOP/s, and 268M scores, each with an exp (16 a clock per SM on the
// special-function units: ~72 us) and ~10 float32 operations.
//
// Design (bf16, rel_pos_attention_wgmma.cuh, kWindow = false): a block of
// two consumer warpgroups (64 queries each) and a producer warpgroup (one
// thread issues the loads; setmaxnreg gives its registers away) walks the
// keys in tiles of two whole grid rows (2W <= 128 keys), as the TPU kernel
// does (block_k = rows * W), through a 2-stage TMA ring with full/empty
// mbarriers, so loads overlap the products. S = q.k is wgmma m64n128k16
// from swizzled shared memory; the online softmax runs on exp2 in the
// accumulator layout; P feeds O += P V from registers. The rel terms are
// computed in the kernel (two 64 x 128 wgmma products over the (2H-1, D)
// and (2W-1, D) tables in the prologue), not by torch: each thread keeps
// the rel_w terms of its fixed key columns in registers for the whole loop
// and reads two rel_h values a row per tile. W = 50 (FMB's 800^2) takes
// 100 keys of a 128-row tile, the rest masked.
//
// float32 (rel_pos_attention_f32.cuh, shared with K1): the 3xTF32 core on
// .tf32 wgmma, tiles of one grid row (64 keys; W = 50: 50 of them), the
// rel terms computed in the kernel from the float32 resized tables.
#include "rel_pos_attention_f32.cuh"
#include "rel_pos_attention_wgmma.cuh"

// float32: th (2 grid_h - 1, head_dim) and tw (2 grid_w - 1, head_dim) are
// the resized rel-pos tables; key tiles of rows_per_tile grid rows,
// n_tiles of them
extern "C" int msa_flash_attention(const void* qkv, const void* th,
                                   const void* tw, void* out, int batch,
                                   int heads, int head_dim, int grid_h,
                                   int grid_w, int rows_per_tile, int n_tiles,
                                   float scale, void* stream) {
  return msa::dispatch_rel_pos_attention_f32(qkv, th, tw, out, batch, heads,
                                             head_dim, grid_h, grid_w,
                                             rows_per_tile, n_tiles, scale,
                                             stream);
}

// bf16: th (parts, 2 grid_h - 1, head_dim) and tw (parts, 2 grid_w - 1,
// head_dim) are the resized rel-pos tables as bf16 (hi[, lo]) parts;
// n_tiles = ceil(grid_h / 2) key tiles
extern "C" int msa_flash_attention_bf16(const void* qkv, const void* th,
                                        const void* tw, void* out, int batch,
                                        int heads, int head_dim, int grid_h,
                                        int grid_w, int n_tiles, int th_parts,
                                        int tw_parts, float scale,
                                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MSA_K2_CASE(DIM)                                                     \
  if (head_dim == DIM)                                                       \
    return msa::launch_rel_pos_attention_wgmma<DIM, false, msa::kGlobalKeys, \
                                               msa::kGlobalTable>(           \
        qkv, th, tw, nullptr, out, batch, heads, grid_h, grid_w,             \
        2 * grid_h - 1, 2 * grid_w - 1, th_parts, tw_parts, n_tiles, scale,  \
        s);
  MSA_K2_CASE(16)
  MSA_K2_CASE(32)
  MSA_K2_CASE(64)
#undef MSA_K2_CASE
  return cudaErrorInvalidValue;
}
