// Global (whole-grid) attention with the decomposed rel-pos bias, as a
// flash-style kernel with an online softmax (SAM ViT, the 4 global blocks
// of ViT-L over the 64x64 token grid).
//
// Replaces: multimodal_sam_adapter_tpu/ops/flash_attention.py,
//   flash_attention_lane (Pallas kernel _flash_lane_kernel). Same contract:
//   the raw (B, N, 3*C) qkv projection in, heads-packed (B, N, C) out, the
//   bias rel_h[q, k // W] + rel_w[q, k % W] added per key tile, with
//   rel_h (B*heads, N, H) and rel_w (B*heads, N, W) computed in torch (in
//   float32 here, where the TPU path rounds them to bf16). The
//   TPU kernel's per-head lane masks, bias-expand matrix and ones-column
//   softmax denominator are MXU/VPU workarounds and have no counterpart.
//
// What bounds it on an H100: arithmetic. Per (image, head) it does
// 2 * 4096^2 * 64 multiply-adds over 3 * 4096 * 64 inputs, far above the
// card's ridge point, and the N x N scores never leave the SM. bfloat16
// runs the products on the tensor cores with mma.sync; the next limits are
// the softmax's exp and rescale per score on the CUDA cores, the two
// shared-memory bias reads per score, and tile loads that are not
// overlapped with the products (no cp.async/TMA ring yet). float32 runs on
// the CUDA cores (about 67 TFLOP/s peak).
//
// Design: see rel_pos_attention.cuh (float32) and rel_pos_attention_mma.cuh
// (bfloat16). Each block loads its 64 queries' bias rows (64 * (H + W)
// float32 values, coalesced) into shared memory once, then walks all N keys
// in tiles with the online softmax, so the N x N score matrix is never
// stored. At the flagship shape the shared memory (~49 KB float32, ~62 KB
// bf16) needs the dynamic-shared-memory opt-in.
#include "rel_pos_attention.cuh"

extern "C" int msa_flash_attention(const void* qkv, const void* rel_h,
                                   const void* rel_w, void* out, int batch,
                                   int heads, int head_dim, int grid_h,
                                   int grid_w, float scale, int dtype,
                                   void* stream) {
  return msa::dispatch_rel_pos_attention<false>(
      qkv, rel_h, rel_w, out, batch, heads, head_dim, grid_h, grid_w, scale,
      dtype, stream);
}
