// K1: windowed attention with the decomposed rel-pos bias (SAM ViT, the 20
// windowed blocks of ViT-L: 14x14 windows, 25 of them at 1024^2).
//
// Replaces: multimodal_sam_adapter_tpu/ops/window_attention.py,
//   window_attention_laneblock_fwd (Pallas kernel _win_kernel_laneblock_mw /
//   _laneblock_body). Same contract: the raw (windows, N, 3*C) qkv projection
//   in, heads-packed (windows, N, C) out, bias q.Rh[qh, kh] + q.Rw[qw, kw]
//   with the unscaled q, the scale on q.k only. The TPU kernel's lane masks
//   and one-hot bias-expansion dots are MXU workarounds and have no
//   counterpart here.
//
// What bounds it on an H100: memory. A (window, head) pair reads 3 x 196 x
// 64 bf16 values and writes 196 x 64, for 2 x 2 x 196^2 x 64 FLOP: ~65
// FLOP a byte, far below the card's ~295, so the bound is the 40 MB of qkv
// and output (12 us at 3.35 TB/s) against 4.2 GFLOP (4 us on the tensor
// cores). What decides in practice is latency: a window is too little work
// to hide its own loads, and 196 = 3 x 64 + 4 rows leave one m-tile of
// four rows in every (window, head).
//
// Design (bf16, rel_pos_attention_wgmma.cuh, kWindow = true): a block of
// one consumer warpgroup and a producer warp takes 64 queries of one
// (window, head); two blocks share an SM, so one block's TMA loads overlap
// the other's products (1,600 blocks at 1024^2). TMA brings q, the
// window's whole K and V (196 rows, zero-filled to 208 by the TMA unit
// from a 3-D map over (windows, N, 3C)), the (27, D) tables and the
// window's 0/1 expansion tiles (key -> grid row, key -> grid column) in
// one go. The bias terms are a 64 x 32 wgmma product per table in the
// prologue; S = q.k + bias is one 64 x 208 wgmma accumulation, the bias
// entering as four k16 products of the terms (A, from registers) with the
// expansion tiles, so the score loop reads no shared memory (a lookup of
// both terms per score was a third of the kernel's time). The softmax is a
// single pass with no online rescale, and P goes from registers into the
// O += P V wgmma. What is left of the gap to the bound: every m-tile block
// loads the window's K and V and the tables again (~120 MB from L2 for
// 40 MB of data), and 196 = 3 x 64 + 4 rows waste most of a fourth
// m-tile. float32 stays on the CUDA-core kernel of rel_pos_attention.cuh,
// from the gathered (N, D) tables.
#include "rel_pos_attention.cuh"
#include "rel_pos_attention_wgmma.cuh"

extern "C" int msa_window_attention(const void* qkv, const void* rh,
                                    const void* rw, void* out, int windows,
                                    int heads, int head_dim, int ws,
                                    float scale, void* stream) {
  return msa::dispatch_rel_pos_attention<true>(qkv, rh, rw, out, windows,
                                               heads, head_dim, ws, ws, scale,
                                               stream);
}

// bf16: th, tw are the (parts, 2 ws - 1, head_dim) rel-pos tables as bf16
// (hi[, lo]) parts; keys_per_tile (64 or 208) holds the window's ws^2 keys;
// ex (2, keys_per_tile, 16) bf16 the window's 0/1 expansion tiles
extern "C" int msa_window_attention_bf16(const void* qkv, const void* th,
                                         const void* tw, const void* ex,
                                         void* out, int windows, int heads,
                                         int head_dim, int ws,
                                         int keys_per_tile, int th_parts,
                                         int tw_parts, float scale,
                                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = 2 * ws - 1;
#define MSA_K1_CASE(DIM, BK)                                                 \
  if (head_dim == DIM && keys_per_tile == BK)                                \
    return msa::launch_rel_pos_attention_wgmma<DIM, true, BK,                \
                                               msa::kWindowTable>(           \
        qkv, th, tw, ex, out, windows, heads, ws, ws, rows, rows, th_parts,   \
        tw_parts, 1, scale, s);
  MSA_K1_CASE(16, 64)
  MSA_K1_CASE(32, 64)
  MSA_K1_CASE(64, 64)
  MSA_K1_CASE(16, 208)
  MSA_K1_CASE(32, 208)
  MSA_K1_CASE(64, 208)
#undef MSA_K1_CASE
  return cudaErrorInvalidValue;
}
