"""Mask2Former and MaskFormer heads: the counterparts of
multimodal_sam_adapter_tpu/models/mask2former/head.py.

Semantic inference follows the reference einsum, in float32:
    seg = softmax(cls)[..., :-1] (x) sigmoid(masks)  -> (B, K, H/4, W/4).

Parameter names are the reference Mask2Former checkpoint's keys. The
MaskFormer head has no converter in the JAX package; its names follow the
Mask2Former keys wherever the modules coincide (`pixel_decoder`,
`transformer_decoder.layers` / `.post_norm`, `query_embed`, `cls_embed`,
`mask_embed`).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ...nn.layers import KeyedDraws
from ...ops.kernels import autocast_off
from .pixel_decoder import MSDeformAttnPixelDecoder
from .positional_encoding import sine_positional_encoding
from .transformer_decoder import Mask2FormerDecoder, TransformerDecoder

Preds = Tuple[List[torch.Tensor], List[torch.Tensor]]


def semantic_inference(cls_logits: torch.Tensor, mask_logits: torch.Tensor
                       ) -> torch.Tensor:
    """(B, Q, K + 1) x (B, Q, h, w) -> (B, K, h, w) float32 scores, with
    autocast off."""
    with autocast_off(cls_logits.device):
        probs = cls_logits.float().softmax(-1)[..., :-1]
        return torch.einsum("bqk,bqhw->bkhw", probs,
                            mask_logits.float().sigmoid())


class Mask2FormerHead(Mask2FormerDecoder, KeyedDraws):
    """Pixel decoder, then the masked-attention decoder. `pinned`, when
    set, is a dict whose "attn_masks" replaces the cross-attention masks
    the layers compute (and whose "assign" the segmentor's loss takes in
    place of its matching); `record` holds the masks of the last forward
    and the assignments of the last loss. The step's key
    (nn.layers.set_dropout_key) roots the loss's point draws."""

    def __init__(self, in_channels: int, num_classes: int,
                 feat_channels: int = 256, num_queries: int = 100,
                 num_decoder_layers: int = 9, num_encoder_layers: int = 6):
        super().__init__(num_classes, feat_channels,
                         num_layers=num_decoder_layers,
                         num_queries=num_queries)
        self.num_classes = num_classes
        self.pixel_decoder = MSDeformAttnPixelDecoder(
            in_channels, feat_channels, num_encoder_layers)
        self.pinned: Optional[Dict[str, list]] = None
        self.record: Dict[str, list] = {}

    def forward(self, feats: Sequence[torch.Tensor]) -> Preds:
        """feats: four NCHW maps -> (class logits, mask logits) lists, one
        pair for the queries before the first layer and after each."""
        mask_features, memories = self.pixel_decoder(feats)
        memory_pos = [sine_positional_encoding(
            m.shape[2], m.shape[3], m.shape[1] // 2, device=m.device)
            for m in memories]
        pinned = (self.pinned or {}).get("attn_masks")
        preds, used = self.decode(mask_features, memories, memory_pos,
                                  pinned)
        self.record["attn_masks"] = used
        return [p[0] for p in preds], [p[1] for p in preds]

    semantic_inference = staticmethod(semantic_inference)


class MaskFormerHead(nn.Module):
    """The per-pixel-embedding variant: the pixel decoder without encoder
    layers, a plain transformer decoder over the coarsest memory (no
    masked attention), queries starting at zero."""

    def __init__(self, in_channels: int, num_classes: int,
                 feat_channels: int = 256, num_queries: int = 100,
                 num_decoder_layers: int = 6, num_heads: int = 8,
                 ffn_dim: int = 2048):
        super().__init__()
        C = feat_channels
        self.num_queries = num_queries
        self.pixel_decoder = MSDeformAttnPixelDecoder(in_channels, C, 0)
        self.query_embed = nn.Embedding(num_queries, C)
        self.transformer_decoder = TransformerDecoder(num_decoder_layers, C,
                                                      num_heads, ffn_dim)
        self.cls_embed = nn.Linear(C, num_classes + 1)
        self.mask_embed = nn.Sequential(
            nn.Linear(C, C), nn.ReLU(), nn.Linear(C, C), nn.ReLU(),
            nn.Linear(C, C))

    def forward(self, feats: Sequence[torch.Tensor]) -> Preds:
        mask_features, memories = self.pixel_decoder(feats)
        mem = memories[0]
        B, C, h, w = mem.shape
        tokens = mem.flatten(2).transpose(1, 2)
        pos = sine_positional_encoding(h, w, C // 2, device=mem.device)
        pos = pos.reshape(1, h * w, C).to(mem.dtype)
        queries = mem.new_zeros((B, self.num_queries, C))
        qpos = self.query_embed.weight.to(mem.dtype)[None].expand(
            B, -1, -1)
        for layer in self.transformer_decoder.layers:
            queries = layer(queries, qpos, tokens, pos)
        q = self.transformer_decoder.post_norm(queries)
        masks = torch.einsum("bqc,bchw->bqhw", self.mask_embed(q),
                             mask_features)
        return [self.cls_embed(q)], [masks]

    semantic_inference = staticmethod(semantic_inference)
