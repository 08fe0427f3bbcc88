"""SegFormer all-MLP decode head on NCHW maps: the counterpart of
multimodal_sam_adapter_tpu/models/segformer_head.py.

Per level a 1x1 conv + BN + ReLU, bilinear resize to the stride-4 grid,
concat, a 1x1 fusion conv + BN + ReLU, dropout (train mode only), and the
1x1 class conv. (The JAX package applies the fusion conv before the
resize, which is equal in exact arithmetic, the BN statistics included.)
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn

from ..nn.layers import ConvNormAct, KeyedDropout
from ..utils.interpolate import resize_bilinear


class SegformerHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int,
                 channels: int = 512, num_inputs: int = 4,
                 dropout_ratio: float = 0.1):
        super().__init__()
        self.convs = nn.ModuleList(
            ConvNormAct(in_channels, channels, 1, norm="bn", act="relu")
            for _ in range(num_inputs))
        self.fusion_conv = ConvNormAct(channels * num_inputs, channels, 1,
                                       norm="bn", act="relu")
        self.dropout = KeyedDropout(dropout_ratio)
        self.conv_seg = nn.Conv2d(channels, num_classes, 1)

    def forward(self, inputs: List[torch.Tensor]) -> torch.Tensor:
        """inputs: 4 NCHW maps at strides 4/8/16/32 -> NCHW logits at
        stride 4."""
        size = inputs[0].shape[-2:]
        outs = [resize_bilinear(conv(x), size)
                for conv, x in zip(self.convs, inputs)]
        out = self.fusion_conv(torch.cat(outs, dim=1))
        return self.conv_seg(self.dropout(out))
