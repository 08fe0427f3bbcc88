"""Mask2Former transformer decoder: the counterpart of
multimodal_sam_adapter_tpu/models/mask2former/transformer_decoder.py.

Each layer: cross-attention over one memory level, restricted to the
foreground of the previous prediction's masks (every key where a query's
mask is empty), then self-attention over the queries, then the FFN, each
followed by its LayerNorm. The layers take the three memory levels (stride
32, 16, 8) in turn. The attention logits are float32 whatever the compute
dtype, autocast included, as the JAX package takes its einsums with
preferred_element_type=float32; these products are plain PyTorch.

Parameter names are the reference checkpoint's keys: the attentions hold
torch's nn.MultiheadAttention layout (`attn.in_proj_weight` packing q, k
and v, `attn.out_proj`), `attentions.0` cross and `attentions.1` self,
`norms.{0,1,2}`, `ffns.0`.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.kernels import autocast_off
from ...utils.interpolate import resize_bilinear
from .pixel_decoder import FFN

NEG_INF = -1e9


class _PackedAttention(nn.Module):
    """nn.MultiheadAttention's parameters: q, k and v projections packed
    in `in_proj_weight` (3C, C) and `in_proj_bias` (3C), and `out_proj`."""

    def __init__(self, dim: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = nn.Linear(dim, dim)


def float32_logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q @ k^T in float32, autocast off: (..., Nq, d) x (..., Nk, d)."""
    with autocast_off(q.device):
        return torch.matmul(q.float(), k.float().transpose(-1, -2))


class MultiheadAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.attn = _PackedAttention(dim)

    def forward(self, q, k, v, keep: Optional[torch.Tensor] = None):
        """q (B, Nq, C), k / v (B, Nk, C); keep (B, Nq, Nk) bool or None:
        where it is False the logit gets NEG_INF."""
        B, Nq, C = q.shape
        M, hd = self.num_heads, C // self.num_heads
        w, b = self.attn.in_proj_weight, self.attn.in_proj_bias

        def heads(t, i):
            t = F.linear(t, w[i * C:(i + 1) * C], b[i * C:(i + 1) * C])
            return t.view(B, -1, M, hd).transpose(1, 2)

        qh, kh, vh = heads(q, 0), heads(k, 1), heads(v, 2)
        logits = float32_logits(qh * hd ** -0.5, kh)
        if keep is not None:
            logits = logits + torch.where(
                keep, 0.0, NEG_INF).to(torch.float32)[:, None]
        attn = logits.softmax(-1).to(vh.dtype)
        out = torch.matmul(attn, vh).transpose(1, 2).reshape(B, Nq, C)
        return self.attn.out_proj(out)


class DecoderLayer(nn.Module):
    def __init__(self, dim: int = 256, num_heads: int = 8,
                 ffn_dim: int = 2048):
        super().__init__()
        self.attentions = nn.ModuleList(MultiheadAttention(dim, num_heads)
                                        for _ in range(2))
        self.norms = nn.ModuleList(nn.LayerNorm(dim, eps=1e-5)
                                   for _ in range(3))
        self.ffns = nn.ModuleList([FFN(dim, ffn_dim)])

    def forward(self, queries, query_pos, memory, memory_pos, keep=None):
        y = self.attentions[0](queries + query_pos, memory + memory_pos,
                               memory, keep)
        queries = self.norms[0](queries + y)
        qp = queries + query_pos
        queries = self.norms[1](queries + self.attentions[1](qp, qp,
                                                             queries))
        return self.norms[2](queries + self.ffns[0](queries))


class TransformerDecoder(nn.Module):
    """The layers and the norm after them (`post_norm`), as the reference
    nests them under `transformer_decoder.`."""

    def __init__(self, num_layers: int, dim: int, num_heads: int,
                 ffn_dim: int):
        super().__init__()
        self.layers = nn.ModuleList(DecoderLayer(dim, num_heads, ffn_dim)
                                    for _ in range(num_layers))
        self.post_norm = nn.LayerNorm(dim, eps=1e-5)


def attention_keep(mask_logits: torch.Tensor, level_hw: Sequence[int]
                   ) -> torch.Tensor:
    """The cross-attention mask from the previous prediction: the mask
    logits (B, Q, h, w) resized to the memory level, sigmoid > 0.5 in
    float32, and every key kept for a query whose mask is empty. Returns
    (B, Q, h' * w') bool."""
    B, Q = mask_logits.shape[:2]
    m = resize_bilinear(mask_logits.detach(), level_hw)
    m = (torch.sigmoid(m.float()) > 0.5).reshape(B, Q, -1)
    return m | ~m.any(-1, keepdim=True)


class Mask2FormerDecoder(nn.Module):
    """The queries, the layers and the prediction heads. Its parameters are
    the head's own keys (`query_embed`, `query_feat`, `level_embed`,
    `transformer_decoder`, `cls_embed`, `mask_embed`): Mask2FormerHead
    extends it with the pixel decoder."""

    def __init__(self, num_classes: int, dim: int = 256, num_heads: int = 8,
                 num_layers: int = 9, num_queries: int = 100,
                 ffn_dim: int = 2048):
        super().__init__()
        self.num_queries = num_queries
        self.query_embed = nn.Embedding(num_queries, dim)
        self.query_feat = nn.Embedding(num_queries, dim)
        # added to the memory tokens of each level (distinct from the
        # pixel decoder's level_encoding)
        self.level_embed = nn.Embedding(3, dim)
        self.transformer_decoder = TransformerDecoder(num_layers, dim,
                                                      num_heads, ffn_dim)
        self.cls_embed = nn.Linear(dim, num_classes + 1)
        self.mask_embed = nn.Sequential(
            nn.Linear(dim, dim), nn.ReLU(), nn.Linear(dim, dim), nn.ReLU(),
            nn.Linear(dim, dim))

    def predict(self, queries: torch.Tensor, mask_features: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (class logits (B, Q, K + 1), mask logits (B, Q, H/4, W/4))."""
        q = self.transformer_decoder.post_norm(queries)
        return self.cls_embed(q), torch.einsum(
            "bqc,bchw->bqhw", self.mask_embed(q), mask_features)

    def decode(self, mask_features: torch.Tensor,
               memories: Sequence[torch.Tensor],
               memory_pos: Sequence[torch.Tensor],
               keep: Optional[Sequence[torch.Tensor]] = None):
        """mask_features (B, C, H/4, W/4); memories NCHW, coarse to fine;
        memory_pos (h, w, C) each; keep: the cross-attention masks to use
        in place of those computed (one (B, Q, h * w) bool a layer), or
        None. Returns ([(class logits, mask logits)] for the queries before
        the first layer and after each, the masks used)."""
        B, dt = mask_features.shape[0], mask_features.dtype
        shape = (B, self.num_queries, -1)
        queries = self.query_feat.weight.to(dt)[None].expand(shape)
        qpos = self.query_embed.weight.to(dt)[None].expand(shape)
        preds = [self.predict(queries, mask_features)]
        used = []
        for i, layer in enumerate(self.transformer_decoder.layers):
            lvl = i % len(memories)
            mem = memories[lvl]
            h, w = mem.shape[-2:]
            k = (attention_keep(preds[-1][1], (h, w)) if keep is None
                 else keep[i])
            used.append(k)
            tokens = (mem.flatten(2).transpose(1, 2)
                      + self.level_embed.weight[lvl].to(mem.dtype))
            queries = layer(queries, qpos, tokens,
                            memory_pos[lvl].reshape(1, h * w, -1)
                            .to(mem.dtype), k)
            preds.append(self.predict(queries, mask_features))
        return preds, used
