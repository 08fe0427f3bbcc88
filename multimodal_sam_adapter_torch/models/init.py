"""Parameter init as the JAX package draws it: one table from the port's
parameter names (the reference checkpoint keys) to the flax initializer
that the JAX module gives the same parameter.

- Linear and conv weights: flax's default `lecun_normal`, a normal of std
  sqrt(1 / fan_in) truncated at two of its (untruncated) standard
  deviations; biases zero; norm gains one, shifts zero;
- `trunc_normal_init(0.02)` (nn/layers.py:24): the twin ConvNeXt's
  depthwise, pointwise and downsample convs and the extractors' ConvFFN
  fc1 / fc2: N(0, 0.02) truncated at +/-0.04;
- `fan_out_conv_init` (nn/layers.py:29): the ConvFFN's depthwise conv and
  the spatial prior's 1x1 projections: N(0, sqrt(2 / fan_out)), fan_out =
  kh * kw * out_channels (all of them, grouped or not);
- the f1 up-projection (backbone.py:64): N(0, sqrt(2 / (2 * 2 * out)));
- zero: the position embedding, the rel-pos tables, MSDA's offset and
  attention-weight kernels and the attention-weight bias; MSDA's offset
  bias is the directional grid (ops/msda.py:306);
- `level_embed` N(0, 1) (backbone.py:159); `conv_seg` N(0, 0.01)
  (segformer_head.py:96);
- the Mask2Former head: its query, query-position and level embeddings
  and the pixel decoder's level encoding N(0, 1); the packed q / k / v
  projections `lecun_normal` (fan-in C, as each of the JAX package's three
  Dense kernels) with zero biases; its MSDA, GroupNorms, LayerNorms,
  Linear and conv layers by the rules above and below;
- constants: the injectors' gamma `init_values` (adapter.py:141), the
  ConvNeXt layer scale 1.0 (the spatial prior builds its twin trunk with
  layer_scale_init_value=1.0, adapter.py:248), the neck's channel-attention
  temperatures 1 (fusion_neck.py:174,183), the local encoders' scale 0
  (:304), the fuse blocks' gammas 0 (:329-330), the blend scales 1.

Every draw comes from one explicit `torch.Generator`; BatchNorm running
statistics start at mean 0, variance 1. A parameter that no rule covers
raises, so none is left at whatever the model was built with.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.msda import MSDeformAttention, msda_directional_bias_init

# flax's variance_scaling: the std of a standard normal truncated at +/-2
TRUNC_STD = 0.87962566103423978
# the layer scale the spatial prior gives its twin ConvNeXt (adapter.py:248)
CONVNEXT_LAYER_SCALE = 1.0


@dataclasses.dataclass(frozen=True)
class Init:
    """One initializer: `kind` 'const' (value), 'normal' (std) or
    'trunc_normal' (std of the untruncated normal, cut at +/-bound), or
    'msda_bias'. `std` is the standard deviation of the draw itself."""
    kind: str
    value: float = 0.0
    std: float = 0.0
    bound: float = float("inf")


def const(value: float) -> Init:
    return Init("const", value=float(value))


def normal(std: float) -> Init:
    return Init("normal", std=float(std))


def trunc_normal(sigma: float) -> Init:
    """N(0, sigma) cut at +/-2 sigma; the draw's std is sigma * TRUNC_STD."""
    return Init("trunc_normal", std=sigma * TRUNC_STD, bound=2.0 * sigma)


def fan_in(w: torch.Tensor) -> int:
    """Linear (out, in) or conv (out, in / groups, kh, kw) fan-in."""
    return math.prod(w.shape[1:])


def lecun_normal(w: torch.Tensor) -> Init:
    return trunc_normal(math.sqrt(1.0 / fan_in(w)) / TRUNC_STD)


def fan_out_normal(w: torch.Tensor) -> Init:
    """nn/layers.py:fan_out_conv_init on a conv weight (out, in/g, kh, kw)."""
    return normal(math.sqrt(2.0 / (w.shape[0] * w.shape[2] * w.shape[3])))


# (pattern on the parameter name, init from (weight, backbone config)):
# the first pattern that matches wins; the generic rules come last
Rule = Tuple[str, Callable[[torch.Tensor, dict], Init]]
RULES: Tuple[Rule, ...] = (
    (r"(^|\.)sampling_offsets\.bias$", lambda w, c: Init("msda_bias")),
    (r"(^|\.)(sampling_offsets|attention_weights)\.(weight|bias)$",
     lambda w, c: const(0.0)),
    (r"(^|\.)(pos_embed|rel_pos_[hw])$", lambda w, c: const(0.0)),
    (r"(^|\.)level_embed$", lambda w, c: normal(1.0)),
    # the Mask2Former head's embeddings (mask2former/transformer_decoder.py
    # :85-97, pixel_decoder.py:69) and its packed q / k / v projections,
    # three flax Dense layers of fan-in C in the JAX package
    (r"(^|\.)(query_embed|query_feat|level_embed|level_encoding)\.weight$",
     lambda w, c: normal(1.0)),
    (r"(^|\.)in_proj_weight$", lambda w, c: lecun_normal(w)),
    (r"(^|\.)in_proj_bias$", lambda w, c: const(0.0)),
    (r"(^|\.)injector\.gamma$", lambda w, c: const(c["init_values"])),
    (r"twin_conv\.stages_[xy]\.\d+\.\d+\.gamma$",
     lambda w, c: const(CONVNEXT_LAYER_SCALE)),
    (r"twin_conv\.(stages_[xy]\.\d+\.\d+\.(depthwise_conv|pointwise_conv[12])"
     r"|downsample_layers_[xy]\.[1-9]\.1)\.weight$",
     lambda w, c: trunc_normal(0.02)),
    (r"(^|\.)ffn\.fc[12]\.weight$", lambda w, c: trunc_normal(0.02)),
    (r"((^|\.)ffn\.dwconv\.dwconv|\.spm\.fc\d)\.weight$",
     lambda w, c: fan_out_normal(w)),
    (r"(^|\.)up\.weight$",
     lambda w, c: normal(math.sqrt(2.0 / (2 * 2 * w.shape[1])))),
    (r"(^|\.)conv_seg\.weight$", lambda w, c: normal(0.01)),
    (r"(^|\.)fuse_blocks\.\d+\.gamma[xy]\.scale$", lambda w, c: const(0.0)),
    (r"(^|\.)local_feature_encoder_\w+\.\d+\.scale$", lambda w, c: const(0.0)),
    (r"(^|\.)attn\.scale2?$", lambda w, c: const(1.0)),
    (r"(^|\.)scale_layers\.\d+\.scale[12]$", lambda w, c: const(1.0)),
    (r"(^|\.)bias$", lambda w, c: const(0.0)),
    # norm gains (1-D); every Linear / conv weight has two or more axes
    (r"(^|\.)weight$", lambda w, c: const(1.0) if w.dim() == 1
     else lecun_normal(w)),
)


def init_table(model: nn.Module, backbone_cfg: dict) -> Dict[str, Init]:
    """name -> Init for every parameter of `model`, an EncoderDecoder or
    one of its modules (backbone_cfg: the registry's `model.backbone`, for
    `init_values`). Raises on a parameter no rule covers."""
    cfg = {"init_values": backbone_cfg.get("init_values", 1e-6)}
    table = {}
    for name, p in model.named_parameters():
        for pattern, rule in RULES:
            if re.search(pattern, name):
                table[name] = rule(p, cfg)
                break
        else:
            raise KeyError(f"no init rule covers the parameter {name}")
    return table


@torch.no_grad()
def draw_(t: torch.Tensor, init: Init, generator: torch.Generator,
          msda: Optional[MSDeformAttention] = None) -> None:
    if init.kind == "const":
        t.fill_(init.value)
    elif init.kind == "normal":
        t.normal_(0.0, init.std, generator=generator)
    elif init.kind == "trunc_normal":
        sigma = init.bound / 2.0
        nn.init.trunc_normal_(t, 0.0, sigma, -init.bound, init.bound,
                              generator=generator)
    elif init.kind == "msda_bias":
        t.copy_(torch.from_numpy(msda_directional_bias_init(
            msda.n_heads, msda.n_levels, msda.n_points)))
    else:
        raise ValueError(f"unknown init {init.kind!r}")


@torch.no_grad()
def init_weights_(model: nn.Module, backbone_cfg: dict,
                  generator: torch.Generator) -> Dict[str, Init]:
    """Draw every parameter of `model` as the JAX package initialises its
    counterpart, from `generator` (on the model's device), and reset every
    BatchNorm's running statistics. Returns the table it drew from."""
    table = init_table(model, backbone_cfg)
    for name, p in model.named_parameters():
        owner = model.get_submodule(".".join(name.split(".")[:-2])) if (
            table[name].kind == "msda_bias") else None
        draw_(p, table[name], generator, owner)
    for m in model.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_running_stats()
    return table
