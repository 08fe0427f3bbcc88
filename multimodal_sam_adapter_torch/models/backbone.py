"""SAMAdapterBimodal: the SAM ViT wrapped with the multimodal adapter. The
counterpart of multimodal_sam_adapter_tpu/models/backbone.py.

Input (B, 3 + aux, H, W) NCHW: the RGB and auxiliary channels feed the
twin ConvNeXt spatial prior, the RGB channels feed the ViT patch embed.
Four interaction stages {inject -> ViT blocks -> extract}, then the pyramid
assembly: a 2x2 stride-2 ConvTranspose2d lifts c2 onto c1, bilinearly
resized ViT features are added per level, and four BatchNorms finish. In
eval mode the f1 level (transposed conv, both adds, norm1) is one call of
K6 (ops/pixel_shuffle.py), with norm1 as its eval-mode affine; in train
mode it is the plain composition with norm1 on the batch's statistics, as
the JAX package fuses f1 only when not training.
Train mode also drops tokens after the position embedding (`drop_rate`)
and, with `with_cp`, runs the spatial prior and each interaction stage
under activation checkpointing (the JAX package's nn.remat units).
`forward_features` returns [f1, f2, f3, f4] NCHW at strides 4/8/16/32;
`forward` takes and returns NHWC, the JAX package's layout.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from ..nn.layers import KeyedDropout, checkpoint
from ..ops.pixel_shuffle import pixel_shuffle_up_bn
from ..utils.interpolate import resize_bicubic, resize_bilinear
from .adapter import InteractionBlock, SpatialPriorModuleBimodal
from .sam_vit import PatchEmbed, ViTBlock


class SAMAdapterBimodal(nn.Module):
    def __init__(self, img_size: int = 1024, patch_size: int = 16,
                 embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 mlp_ratio: float = 4.0, conv_inplane: int = 48,
                 n_points: int = 4, deform_num_heads: int = 16,
                 cffn_ratio: float = 0.25, deform_ratio: float = 0.5,
                 interaction_indexes: Sequence[Tuple[int, int]] = (
                     (0, 5), (6, 11), (12, 17), (18, 23)),
                 global_attn_indexes: Sequence[int] = (5, 11, 17, 23),
                 window_size: int = 14, pretrained_size: int = 1024,
                 modalities_ch: Sequence[int] = (3, 3), arch: str = "small",
                 drop_path_rate: float = 0.3,
                 conv_drop_path_rate: float = 0.4, drop_rate: float = 0.0,
                 with_cp: bool = True, init_values: float = 1e-6):
        super().__init__()
        # init_values: the injector gamma's initial value in the JAX
        # package's own init; the port's weights come from a state_dict or
        # `random_init_`, so it is accepted and unused
        del init_values
        if len(modalities_ch) < 2:
            raise NotImplementedError(
                "the RGB-only spatial prior is not ported yet")
        del conv_inplane  # the SPM widths follow from the ConvNeXt arch
        self.embed_dim = embed_dim
        self.with_cp = with_cp
        self.rgb_ch = modalities_ch[0]
        self.interaction_indexes = tuple(tuple(s) for s in
                                         interaction_indexes)
        grid = pretrained_size // patch_size
        self.spm = SpatialPriorModuleBimodal(
            embed_dim, arch, img_size,
            (modalities_ch[0], sum(modalities_ch[1:])), conv_drop_path_rate)
        self.level_embed = nn.Parameter(torch.zeros(3, embed_dim))
        self.patch_embed = PatchEmbed(self.rgb_ch, embed_dim, patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, embed_dim))
        self.pos_drop = KeyedDropout(drop_rate)
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, mlp_ratio,
                     0 if i in global_attn_indexes else window_size,
                     (grid, grid))
            for i in range(depth))
        n_stages = len(self.interaction_indexes)
        self.interactions = nn.ModuleList(
            InteractionBlock(embed_dim, deform_num_heads, n_points,
                             deform_ratio, cffn_ratio,
                             extra_extractor=si == n_stages - 1,
                             drop_path=drop_path_rate)
            for si in range(n_stages))
        self.up = nn.ConvTranspose2d(embed_dim, embed_dim, 2, 2)
        for i in range(1, 5):
            setattr(self, f"norm{i}", nn.BatchNorm2d(embed_dim, eps=1e-5))

    def forward_features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: (B, C_in, H, W). Returns four NCHW maps of embed_dim channels."""
        B, _, H_img, W_img = x.shape
        E = self.embed_dim
        x_rgb, x_aux = x[:, :self.rgb_ch], x[:, self.rgb_ch:]
        remat = (self.with_cp and self.training and torch.is_grad_enabled())

        def run(module, *args):
            if remat:
                return checkpoint(module, *args, module=module)
            return module(*args)

        c1, c2, c3, c4 = run(self.spm, x_rgb, x_aux)
        lvl = self.level_embed.to(c2.dtype)
        c = torch.cat([c2 + lvl[0], c3 + lvl[1], c4 + lvl[2]], dim=1)
        n2, n3 = c2.shape[1], c3.shape[1]

        tokens, H, W = self.patch_embed(x_rgb)
        pos = self.pos_embed
        if pos.shape[1:3] != (H, W):
            pos = resize_bicubic(pos.permute(0, 3, 1, 2), (H, W))
            pos = pos.permute(0, 2, 3, 1)
        xt = self.pos_drop(tokens + pos.reshape(1, H * W, E).to(tokens.dtype))

        pyr_shapes = ((H_img // 8, W_img // 8), (H_img // 16, W_img // 16),
                      (H_img // 32, W_img // 32))
        outs = []
        for si, (lo, hi) in enumerate(self.interaction_indexes):
            xt, c = run(self.interactions[si], xt, c,
                        self.blocks[lo:hi + 1], (H, W), pyr_shapes)
            outs.append(xt.transpose(1, 2).reshape(B, E, H, W))

        c2 = c[:, :n2].transpose(1, 2).reshape(B, E, 2 * H, 2 * W)
        c3 = c[:, n2:n2 + n3].transpose(1, 2).reshape(B, E, H, W)
        c4 = c[:, n2 + n3:].transpose(1, 2).reshape(B, E, H // 2, W // 2)
        x1, x2, x3, x4 = outs
        x1 = resize_bilinear(x1, (4 * H, 4 * W))
        x2 = resize_bilinear(x2, (2 * H, 2 * W))
        x4 = resize_bilinear(x4, (H // 2, W // 2))
        if self.training:
            f1 = self.norm1(self.up(c2) + c1 + x1)
        else:
            scale, shift = self._f1_affine()
            f1 = pixel_shuffle_up_bn(c2, self.up.weight, c1, x1, scale,
                                     shift)
        return [f1, self.norm2(c2 + x2), self.norm3(c3 + x3),
                self.norm4(c4 + x4)]

    def _f1_affine(self):
        """norm1 in eval mode as f1 = y * scale + shift, float32, with the
        transposed conv's bias folded in: scale = w / sqrt(var + eps),
        shift = b - mean * scale + up.bias * scale."""
        bn = self.norm1
        scale = bn.weight.float() * torch.rsqrt(bn.running_var.float()
                                                + bn.eps)
        shift = (bn.bias.float() - bn.running_mean.float() * scale
                 + self.up.bias.float() * scale)
        return scale, shift

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: (B, H, W, C_in) NHWC. Returns four NHWC maps."""
        feats = self.forward_features(x.permute(0, 3, 1, 2))
        return [f.permute(0, 2, 3, 1) for f in feats]
