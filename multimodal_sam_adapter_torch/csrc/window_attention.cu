// Windowed attention with the decomposed rel-pos bias (SAM ViT, the 20
// windowed blocks of ViT-L).
//
// Replaces: multimodal_sam_adapter_tpu/ops/window_attention.py,
//   window_attention_laneblock_fwd (Pallas kernel _win_kernel_laneblock_mw /
//   _laneblock_body). Same contract: the raw (windows, N, 3*C) qkv projection
//   in, heads-packed (windows, N, C) out, bias q.Rh[qh, kh] + q.Rw[qw, kw]
//   from the (N, D) get_rel_pos tables with the unscaled q, the scale on
//   q.k only. The TPU kernel's lane masks and one-hot bias-expansion dots
//   are MXU workarounds and have no counterpart here.
//
// What bounds it on an H100: not the products. A 14x14 window is 196
// tokens, so one (window, head) pair reads 3 * 196 * 64 values and does
// 2 * 196^2 * 64 multiply-adds: ~65 FLOP per byte in bf16, and the whole
// qkv tensor of a block (25 windows at 1024^2) stays in L2. With the
// products on the tensor cores, the per-block fixed work dominates: staging
// the tiles, the 2 * 14 bias dot products per query (on the CUDA cores),
// and the softmax's exp and rescale per score. The ragged shape wastes work
// too: 196 queries and keys are padded to 4 tiles of 64.
//
// Design: see rel_pos_attention.cuh (float32, CUDA cores) and
// rel_pos_attention_mma.cuh (bfloat16, mma.sync on the tensor cores). Here
// each query's 2 * ws bias terms are computed from the tables before the key
// loop. The ragged query tile (196 = 3 * 64 + 4) and key tile are masked; in
// the bf16 kernel the 3 warps of the last tile that hold no query skip the
// products.
#include "rel_pos_attention.cuh"

extern "C" int msa_window_attention(const void* qkv, const void* rh,
                                    const void* rw, void* out, int windows,
                                    int heads, int head_dim, int ws,
                                    float scale, int dtype, void* stream) {
  return msa::dispatch_rel_pos_attention<true>(qkv, rh, rw, out, windows,
                                               heads, head_dim, ws, ws, scale,
                                               dtype, stream);
}
