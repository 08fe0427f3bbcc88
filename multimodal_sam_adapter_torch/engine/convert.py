"""JAX variables -> reference PyTorch state_dict: the inverse of
multimodal_sam_adapter_tpu/engine/convert_full.py:convert_full_checkpoint.

The port names its parameters exactly as the reference checkpoint keys, so
the JAX package's {'params', 'batch_stats'} tree (numpy arrays) maps one to
one onto the port's `state_dict`. Layouts undone here:

- Dense kernels (in, out) -> Linear weights (out, in);
- conv kernels (kh, kw, in/g, out) -> Conv2d weights (out, in/g, kh, kw);
- the PixelShuffleUp kernel (C, 2, 2, O) -> ConvTranspose2d (C, O, 2, 2);
- the fusion neck's gate/val halves -> the fused 2x-wide project_in and
  dwconv weights;
- the twin ConvNeXt `branch_x` / `branch_y` trees -> `_x` / `_y` keys;
- the RGB-only prior's `stem1..stem3` / `conv2..conv4` units -> the
  nn.Sequential indices of ViT-Adapter's `stem` / `conv2..conv4`;
- the Mask2Former head's separate q / k / v Dense layers -> the packed
  `in_proj_weight` / `in_proj_bias` of nn.MultiheadAttention.

The Mask2Former head's keys are the reference checkpoint's, those that the
JAX package's engine/convert_m2f.py:convert_mask2former_head reads: a
reference Mask2Former state dict loads into the port as it is, so the port
needs no converter of its own for it (as it needs none for the full
checkpoint).

Every BatchNorm also gets a zero `num_batches_tracked`, as a checkpoint
saved by PyTorch carries.
"""
from __future__ import annotations

import re
from typing import Dict, Iterator, Sequence, Tuple

import numpy as np
import torch

Tree = Dict[str, object]


def _lin(k):
    return np.ascontiguousarray(np.asarray(k).T)


def _conv(k):
    return np.ascontiguousarray(np.asarray(k).transpose(3, 2, 0, 1))


def _ln(tree: Tree, key: str) -> Iterator[Tuple[str, np.ndarray]]:
    """flax LayerNorm wrapper ('ln' subtree) or bare _LNCore leaves."""
    node = tree.get("ln", tree)
    yield f"{key}.weight", node["scale"]
    if "bias" in node:
        yield f"{key}.bias", node["bias"]


def _bn(params: Tree, stats: Tree, key: str):
    yield f"{key}.weight", params["bn"]["scale"]
    yield f"{key}.bias", params["bn"]["bias"]
    yield f"{key}.running_mean", stats["bn"]["mean"]
    yield f"{key}.running_var", stats["bn"]["var"]
    yield f"{key}.num_batches_tracked", np.asarray(0, np.int64)


def _dense(tree: Tree, key: str):
    yield f"{key}.weight", _lin(tree["kernel"])
    if "bias" in tree:
        yield f"{key}.bias", tree["bias"]


def _conv2d(tree: Tree, key: str):
    yield f"{key}.weight", _conv(tree["kernel"])
    if "bias" in tree:
        yield f"{key}.bias", tree["bias"]


def vit_block(p: Tree, key: str):
    """One ViTBlock subtree -> `<key>.norm1.weight`, `<key>.attn.qkv...`."""
    yield from _ln(p["norm1"], f"{key}.norm1")
    yield from _ln(p["norm2"], f"{key}.norm2")
    a = p["attn"]
    yield from _dense(a["qkv"], f"{key}.attn.qkv")
    yield from _dense(a["proj"], f"{key}.attn.proj")
    yield f"{key}.attn.rel_pos_h", a["rel_pos_h"]
    yield f"{key}.attn.rel_pos_w", a["rel_pos_w"]
    yield from _dense(p["mlp"]["lin1"], f"{key}.mlp.lin1")
    yield from _dense(p["mlp"]["lin2"], f"{key}.mlp.lin2")


def msda(p: Tree, key: str):
    for name in ("sampling_offsets", "attention_weights", "value_proj",
                 "output_proj"):
        yield from _dense(p[name], f"{key}.{name}")


def injector_or_extractor(p: Tree, key: str):
    yield from _ln(p["query_norm"], f"{key}.query_norm")
    yield from _ln(p["feat_norm"], f"{key}.feat_norm")
    yield from msda(p["attn"], f"{key}.attn")
    if "gamma" in p:
        yield f"{key}.gamma", p["gamma"]
    if "ffn" in p:
        yield from _dense(p["ffn"]["fc1"], f"{key}.ffn.fc1")
        yield from _conv2d(p["ffn"]["dwconv"]["dwconv"],
                           f"{key}.ffn.dwconv.dwconv")
        yield from _dense(p["ffn"]["fc2"], f"{key}.ffn.fc2")
        yield from _ln(p["ffn_norm"], f"{key}.ffn_norm")


def convnext_branch(p: Tree, key: str, br: str):
    """_ConvNeXtBranch subtree -> reference TwinConvNeXt `_x`/`_y` keys."""
    dl = f"{key}.downsample_layers_{br}"
    yield from _conv2d(p["stem_conv"], f"{dl}.0.0")
    yield from _ln(p["stem_norm"], f"{dl}.0.1")
    for name, sub in p.items():
        m = re.fullmatch(r"down_norm(\d)", name)
        if m:
            yield from _ln(sub, f"{dl}.{m.group(1)}.0")
        m = re.fullmatch(r"down_conv(\d)", name)
        if m:
            yield from _conv2d(sub, f"{dl}.{m.group(1)}.1")
        m = re.fullmatch(r"out_norm(\d)", name)
        if m:
            yield from _ln(sub, f"{key}.norm_{br}{m.group(1)}")
        m = re.fullmatch(r"stage(\d)_block(\d+)", name)
        if m:
            s = f"{key}.stages_{br}.{m.group(1)}.{m.group(2)}"
            yield from _conv2d(sub["dwconv"], f"{s}.depthwise_conv")
            yield from _ln(sub["norm"], f"{s}.norm")
            yield from _dense(sub["pwconv1"], f"{s}.pointwise_conv1")
            yield from _dense(sub["pwconv2"], f"{s}.pointwise_conv2")
            yield f"{s}.gamma", sub["gamma"]


def fusion_neck(p: Tree, stats: Tree, key: str):
    """RoadFormer2Neck subtree (smart_fusion) -> reference neck keys."""
    for name, sub in p.items():
        m = re.fullmatch(r"gfe_(rgb|sne)(\d)", name)
        if m:
            g = f"{key}.global_feature_encoder_{m.group(1)}.{m.group(2)}"
            yield f"{g}.norm1.body.weight", sub["norm1"]["scale"]
            yield f"{g}.norm1.body.bias", sub["norm1"]["bias"]
            for conv in ("qkv1", "qkv2", "proj"):
                yield from _conv2d(sub["attn"][conv], f"{g}.attn.{conv}")
            yield f"{g}.attn.scale", sub["attn"]["scale"]
            yield f"{g}.attn.scale2", sub["attn"]["scale2"]
        m = re.fullmatch(r"local_(rgb|sne)(\d)", name)
        if m:
            loc = f"{key}.local_feature_encoder_{m.group(1)}.{m.group(2)}"
            for idx, conv in ((0, "expand"), (2, "dw"), (4, "project")):
                yield from _conv2d(sub[conv], f"{loc}.bottleneckBlock.{idx}")
            yield f"{loc}.scale", sub["scale"]
        m = re.fullmatch(r"fuse(\d)", name)
        if m:
            f = f"{key}.fuse_blocks.{m.group(1)}"
            yield f"{f}.gammax.scale", sub["gammax"]["scale"]
            yield f"{f}.gammay.scale", sub["gammay"]["scale"]
            yield from _ln(sub["norm"], f"{f}.norm")
        m = re.fullmatch(r"detail(\d)", name)
        if m:
            d = f"{key}.detail_feature_extractions.{m.group(1)}"
            for fused in ("project_in", "dwconv"):
                k = np.concatenate([sub[f"{fused}_gate"]["kernel"],
                                    sub[f"{fused}_val"]["kernel"]], axis=-1)
                yield f"{d}.{fused}.weight", _conv(k)
            yield from _conv2d(sub["project_out"], f"{d}.project_out")
        m = re.fullmatch(r"enhance(\d)", name)
        if m:
            e = f"{key}.enhance_blocks.{m.group(1)}.conv_atten"
            yield from _conv2d(sub["conv_atten"], f"{e}.conv")
            yield f"{e}.gn.weight", sub["norm"]["gn"]["scale"]
            yield f"{e}.gn.bias", sub["norm"]["gn"]["bias"]
        m = re.fullmatch(r"ca(\d)", name)
        if m:
            c = f"{key}.ca_blocks.{m.group(1)}.coord_atten"
            for conv in ("conv1", "conv_h", "conv_w"):
                yield from _conv2d(sub[conv], f"{c}.{conv}")
            yield from _bn(sub["bn1"], stats[name]["bn1"], f"{c}.bn1")
        m = re.fullmatch(r"blend(\d)", name)
        if m:
            s = f"{key}.scale_layers.{m.group(1)}"
            yield f"{s}.scale1", sub["scale1"]
            yield f"{s}.scale2", sub["scale2"]


def segformer_head(p: Tree, stats: Tree, key: str):
    for name, sub in p.items():
        m = re.fullmatch(r"convs_(\d)", name)
        if m:
            c = f"{key}.convs.{m.group(1)}"
            yield from _conv2d(sub["conv"], f"{c}.conv")
            yield from _bn(sub["norm"], stats[name]["norm"], f"{c}.bn")
    yield from _conv2d(p["fusion_conv"]["conv"], f"{key}.fusion_conv.conv")
    yield from _bn(p["fusion_conv"]["norm"], stats["fusion_conv"]["norm"],
                   f"{key}.fusion_conv.bn")
    yield from _conv2d(p["conv_seg"], f"{key}.conv_seg")


def _gn(tree: Tree, key: str):
    yield f"{key}.weight", tree["gn"]["scale"]
    yield f"{key}.bias", tree["gn"]["bias"]


def _mha(tree: Tree, key: str):
    """q / k / v / out Dense -> nn.MultiheadAttention's packed
    `in_proj_weight` / `in_proj_bias` and `out_proj` under `<key>.attn`."""
    qkv = ("q_proj", "k_proj", "v_proj")
    yield f"{key}.attn.in_proj_weight", np.concatenate(
        [_lin(tree[n]["kernel"]) for n in qkv], axis=0)
    yield f"{key}.attn.in_proj_bias", np.concatenate(
        [np.asarray(tree[n]["bias"]) for n in qkv], axis=0)
    yield from _dense(tree["out_proj"], f"{key}.attn.out_proj")


def _ffn(tree: Tree, key: str):
    yield from _dense(tree["ffn1"], f"{key}.ffns.0.layers.0.0")
    yield from _dense(tree["ffn2"], f"{key}.ffns.0.layers.1")


def pixel_decoder(p: Tree, key: str):
    """MSDeformAttnPixelDecoder subtree -> the reference keys."""
    yield f"{key}.level_encoding.weight", p["level_encoding"]
    for i in range(3):
        yield from _conv2d(p[f"input_conv{i}"], f"{key}.input_convs.{i}.conv")
        yield from _gn(p[f"input_norm{i}"], f"{key}.input_convs.{i}.gn")
    i = 0
    while f"encoder{i}" in p:
        e, t = p[f"encoder{i}"], f"{key}.encoder.layers.{i}"
        yield from msda(e["self_attn"], f"{t}.attentions.0")
        yield from _ffn(e, t)
        yield from _ln(e["norm1"], f"{t}.norms.0")
        yield from _ln(e["norm2"], f"{t}.norms.1")
        i += 1
    yield from _conv2d(p["lateral4"], f"{key}.lateral_convs.0.conv")
    yield from _gn(p["lateral4_norm"], f"{key}.lateral_convs.0.gn")
    yield from _conv2d(p["output4"], f"{key}.output_convs.0.conv")
    yield from _gn(p["output4_norm"], f"{key}.output_convs.0.gn")
    yield from _conv2d(p["mask_feature"], f"{key}.mask_feature")


def decoder_layer(p: Tree, key: str):
    """DecoderLayer subtree -> `attentions.0` (cross), `attentions.1`
    (self), `norms.{0,1,2}`, `ffns.0`."""
    yield from _mha(p["cross_attn"], f"{key}.attentions.0")
    yield from _mha(p["self_attn"], f"{key}.attentions.1")
    for n in range(3):
        yield from _ln(p[f"norm{n + 1}"], f"{key}.norms.{n}")
    yield from _ffn(p, key)


def _queries_out(p: Tree, key: str, norm: Tree):
    yield from _ln(norm, f"{key}.transformer_decoder.post_norm")
    yield from _dense(p["cls_head"], f"{key}.cls_embed")
    for i, j in enumerate((0, 2, 4)):
        yield from _dense(p[f"mask_mlp{i}"], f"{key}.mask_embed.{j}")


def mask2former_decoder(d: Tree, key: str):
    """Mask2FormerDecoder subtree -> the head-level reference keys: the
    inverse of the decoder part of the JAX package's
    engine/convert_m2f.py:convert_mask2former_head."""
    for name in ("query_embed", "query_feat", "level_embed"):
        yield f"{key}.{name}.weight", d[name]
    i = 0
    while f"layer{i}" in d:
        yield from decoder_layer(d[f"layer{i}"],
                                 f"{key}.transformer_decoder.layers.{i}")
        i += 1
    yield from _queries_out(d, key, d["decoder_norm"])


def mask2former_head(p: Tree, key: str):
    """Mask2FormerHead subtree -> the reference Mask2Former keys: the
    inverse of engine/convert_m2f.py:convert_mask2former_head (q / k / v
    packed into `in_proj`, conv kernels HWIO -> OIHW)."""
    yield from pixel_decoder(p["pixel_decoder"], f"{key}.pixel_decoder")
    yield from mask2former_decoder(p["decoder"], key)


def maskformer_head(p: Tree, key: str):
    """MaskFormerHead subtree -> the port's keys (the Mask2Former keys
    where the modules coincide; the JAX package has no converter)."""
    yield from pixel_decoder(p["pixel_decoder"], f"{key}.pixel_decoder")
    yield f"{key}.query_embed.weight", p["query_embed"]
    i = 0
    while f"layer{i}" in p:
        yield from decoder_layer(p[f"layer{i}"],
                                 f"{key}.transformer_decoder.layers.{i}")
        i += 1
    yield from _queries_out(p, key, p["norm"])


def backbone(p: Tree, stats: Tree, key: str,
             interaction_indexes: Sequence[Tuple[int, int]]):
    yield f"{key}.pos_embed", p["pos_embed"]
    yield f"{key}.level_embed", p["level_embed"]
    yield from _conv2d(p["patch_embed"]["proj"], f"{key}.patch_embed.proj")
    for s, (lo, hi) in enumerate(interaction_indexes):
        st = p[f"interactions_{s}"]
        for idx in range(lo, hi + 1):
            yield from vit_block(st[f"vit_block_{idx}"], f"{key}.blocks.{idx}")
        base = f"{key}.interactions.{s}"
        yield from injector_or_extractor(st["injector"], f"{base}.injector")
        yield from injector_or_extractor(st["extractor"], f"{base}.extractor")
        for j in range(2):
            if f"extra_extractor{j}" in st:
                yield from injector_or_extractor(
                    st[f"extra_extractor{j}"],
                    f"{base}.extra_extractors.{j}")
    yield f"{key}.up.weight", np.ascontiguousarray(
        np.asarray(p["up"]["kernel"]).transpose(0, 3, 1, 2))
    yield f"{key}.up.bias", p["up"]["bias"]
    for i in range(1, 5):
        yield from _bn(p[f"norm{i}"], stats[f"norm{i}"], f"{key}.norm{i}")
    spm, spm_stats = p["spm"], stats.get("spm", {})
    if "twin_conv" in spm:
        for br in ("x", "y"):
            yield from convnext_branch(spm["twin_conv"][f"branch_{br}"],
                                       f"{key}.spm.twin_conv", br)
        yield from fusion_neck(spm["smart_fusion"],
                               spm_stats["smart_fusion"],
                               f"{key}.spm.smart_fusion")
    else:
        yield from conv_stem(spm, spm_stats, f"{key}.spm")
    for i in range(1, 5):
        yield from _conv2d(spm[f"fc{i}"], f"{key}.spm.fc{i}")


# the RGB-only prior's ConvNormAct units -> (nn.Sequential, conv index):
# the conv at <index>, its BatchNorm at <index + 1>, the ReLU's slot after
CONV_STEM = {"stem1": ("stem", 0), "stem2": ("stem", 3), "stem3": ("stem", 6),
             "conv2": ("conv2", 0), "conv3": ("conv3", 0),
             "conv4": ("conv4", 0)}


def conv_stem(p: Tree, stats: Tree, key: str):
    """The RGB-only SpatialPriorModule's `stem1..stem3`, `conv2..conv4`
    (conv + BatchNorm params and batch_stats) -> ViT-Adapter's
    `stem.{0,1,3,4,6,7}` and `conv{2,3,4}.{0,1}` keys."""
    for name, (seq, i) in CONV_STEM.items():
        yield from _conv2d(p[name]["conv"], f"{key}.{seq}.{i}")
        yield from _bn(p[name]["norm"], stats[name]["norm"],
                       f"{key}.{seq}.{i + 1}")


def sam_encoder(p: Tree) -> Dict[str, torch.Tensor]:
    """The params of the JAX package's standalone ImageEncoderViT (e.g.
    its engine/convert.py:convert_sam_encoder(sd, standalone=True)) -> the
    port's ImageEncoderViT state_dict: SAM's encoder keys, unprefixed."""
    pairs = [*_conv2d(p["patch_embed"]["proj"], "patch_embed.proj"),
             ("pos_embed", p["pos_embed"])]
    i = 0
    while f"blocks_{i}" in p:
        pairs += vit_block(p[f"blocks_{i}"], f"blocks.{i}")
        i += 1
    return to_state_dict(pairs)


def to_state_dict(pairs) -> Dict[str, torch.Tensor]:
    sd = {}
    for k, v in pairs:
        if k in sd:
            raise KeyError(f"duplicate key {k}")
        sd[k] = torch.from_numpy(np.array(v, copy=True))
    return sd


def state_dict_from_jax(variables: Dict[str, Tree],
                        interaction_indexes: Sequence[Tuple[int, int]] = (
                            (0, 5), (6, 11), (12, 17), (18, 23)),
                        ) -> Dict[str, torch.Tensor]:
    """{'params', 'batch_stats'} of the JAX EncoderDecoder (numpy leaves)
    -> the port's EncoderDecoder state_dict (reference checkpoint keys)."""
    p, s = variables["params"], variables["batch_stats"]
    head = p["decode_head"]
    pairs = [*backbone(p["backbone"], s["backbone"], "backbone",
                       interaction_indexes),
             *(mask2former_head(head, "decode_head") if "decoder" in head
               else segformer_head(head, s["decode_head"], "decode_head"))]
    return to_state_dict(pairs)
