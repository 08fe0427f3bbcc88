"""Tensor parallelism of the eval forward: the counterpart of
multimodal_sam_adapter_tpu/parallel/tp.py, with the (data, model) mesh of
its mesh.py:make_mesh(('data', 'model')).

The JAX package gives the parameters NamedShardings over the mesh's
'model' axis from a rule table and leaves the all-reduces to XLA's
partitioner. The port runs one process a rank, so it splits the tensors
itself and adds the all-reduces by hand:

- `make_mesh(data, model)`: the ranks as a (data, model) grid with model
  innermost, rank = d * model + m as in JAX's make_mesh(shape=(data,
  model)), with a process group for each model row and each data column.
  The data axis splits the batch; the model axis splits the modules below.
- `tp_spec(name, param)`: the rule table, on the port's parameter names
  (the reference's keys). Column-parallel, the output axis split: the ViT's
  `attn.qkv` and `mlp.lin1`; MSDA's `value_proj`, and its
  `sampling_offsets` and `attention_weights`, which JAX replicates (the
  function is the same: MSDA's softmax runs per head); ConvFFN's `fc1` and
  its depthwise `dwconv`. Row-parallel, the input axis split: `attn.proj`,
  `mlp.lin2`, `output_proj`, `ffn.fc2`, whose partial outputs one
  all-reduce over the model group sums (in float32), the bias added once.
- The split is head-aligned, so that every rank computes whole heads and
  the model computes the unsharded function: a rank's qkv rows are the q,
  k and v rows of its num_heads / tp heads, K1 and K2 run on num_heads /
  tp heads and K3 and K4 on n_heads / tp; the rel-pos tables (one row of
  head_dim values a position, shared by every head) stay replicated.
- A module whose heads (the attentions) or hidden units (MLP, ConvFFN) do
  not divide by the model size stays replicated, as JAX replicates a leaf
  that does not divide. Everything else (the spatial prior with K5, K6,
  the neck, the head) stays replicated.

`tp_plan(model, tp)` is the split of a built model's parameters,
`shard_state_dict` / `gather_state_dict` take a full state dict to one
rank's shard and back, `shard_segmentor_` shards a built segmentor in
place. With tp = 1 each is the identity. This covers the eval forward
(no_grad, inference mode): a row-parallel layer refuses a call that
autograd would record, since training needs the backward's all-reduces.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.adapter import ConvFFN
from ..models.sam_vit import ViTAttention
from ..nn.layers import MLPBlock
from ..ops.msda import MSDeformAttention
from .ddp import rank_world


class Split(NamedTuple):
    """A tensor's axis `dim` split over the model ranks; the axis holds
    `parts` blocks (qkv's q, k and v), each split alike."""
    dim: int
    parts: int = 1


COLUMN, ROW = Split(0), Split(1)
# (name pattern, rank of the weight, split): biases are 1-D. JAX's rules
# take 2-D kernels only, which keeps the neck's 1x1-conv `attn.proj` out
_RULES = (
    (r"attn\.qkv\.(weight|bias)$", 2, Split(0, 3)),
    (r"attn\.proj\.weight$", 2, ROW),
    (r"mlp\.lin1\.(weight|bias)$", 2, COLUMN),
    (r"mlp\.lin2\.weight$", 2, ROW),
    (r"attn\.(value_proj|sampling_offsets|attention_weights)\."
     r"(weight|bias)$", 2, COLUMN),
    (r"attn\.output_proj\.weight$", 2, ROW),
    (r"ffn\.fc1\.(weight|bias)$", 2, COLUMN),
    (r"ffn\.dwconv\.dwconv\.(weight|bias)$", 4, COLUMN),
    (r"ffn\.fc2\.weight$", 2, ROW),
)
# the modules the model axis splits: their head-count attribute (None:
# the units are the row-parallel layer's input features) and their
# row-parallel layer
_MODULES = {ViTAttention: ("num_heads", "proj"),
            MSDeformAttention: ("n_heads", "output_proj"),
            MLPBlock: (None, "lin2"),
            ConvFFN: (None, "fc2")}


def tp_spec(name: str, param: torch.Tensor) -> Optional[Split]:
    """How the rule table splits parameter `name`; None: replicated."""
    for pattern, ndim, split in _RULES:
        want = 1 if name.endswith(".bias") else ndim
        if param.dim() == want and re.search(pattern, name):
            return split
    return None


def _units(module: nn.Module) -> Optional[int]:
    """What the model axis divides in `module`: its heads or its hidden
    units; None for a module it does not split."""
    kind = _MODULES.get(type(module))
    if kind is None:
        return None
    heads, row = kind
    return getattr(module, heads) if heads else getattr(module,
                                                        row).in_features


def tp_plan(model: nn.Module, tp: int) -> Dict[str, Split]:
    """name -> Split of every parameter of `model` that `tp` model ranks
    split: those the rule table names, in modules whose units divide by
    `tp`. Empty for tp = 1."""
    plan: Dict[str, Split] = {}
    if tp == 1:
        return plan
    for prefix, module in model.named_modules():
        units = _units(module)
        if units is None or units % tp:
            continue
        for name, p in module.named_parameters(prefix=prefix):
            split = tp_spec(name, p)
            if split is not None:
                plan[name] = split
    return plan


def shard(t: torch.Tensor, split: Split, m: int, tp: int) -> torch.Tensor:
    """Model rank m's share of `t` (a copy)."""
    d = split.dim
    return t.unflatten(d, (split.parts, tp, -1)).select(d + 1, m).flatten(
        d, d + 1).clone()


def gather(shards: List[torch.Tensor], split: Split) -> torch.Tensor:
    """The tensor whose model-rank shares are `shards`."""
    d = split.dim
    return torch.stack([s.unflatten(d, (split.parts, -1)) for s in shards],
                       d + 1).flatten(d, d + 2)


def shard_state_dict(state_dict: Dict[str, torch.Tensor],
                     plan: Dict[str, Split], m: int, tp: int
                     ) -> Dict[str, torch.Tensor]:
    """Model rank m's state dict: the tensors of `plan` sharded, the rest
    as they are."""
    return {k: shard(v, plan[k], m, tp) if k in plan else v
            for k, v in state_dict.items()}


def gather_state_dict(shards: List[Dict[str, torch.Tensor]],
                      plan: Dict[str, Split]) -> Dict[str, torch.Tensor]:
    """The full state dict from the model ranks' `shards`."""
    return {k: gather([s[k] for s in shards], plan[k]) if k in plan else v
            for k, v in shards[0].items()}


@dataclasses.dataclass
class Mesh:
    """This rank's place in the (data, model) grid and its groups (None
    with one process). `all_reduces` counts the row-parallel layers'
    all-reduces."""
    data: int
    model: int
    rank: int = 0
    model_group: Optional[dist.ProcessGroup] = None
    data_group: Optional[dist.ProcessGroup] = None
    all_reduces: int = 0

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model


def make_mesh(data: int, model: int) -> Mesh:
    """The (data, model) mesh over the process group, whose size must be
    data x model (one process without a group); every rank calls it."""
    rank, world = rank_world()
    if data < 1 or model < 1 or data * model != world:
        raise ValueError(
            f"a ({data}, {model}) mesh needs {data * model} ranks; the "
            f"process group has {world}"
            + ("" if dist.is_initialized() else " (there is none)"))
    mesh = Mesh(data, model, rank)
    if world > 1:
        for d in range(data):
            group = dist.new_group([d * model + m for m in range(model)])
            if d == mesh.data_rank:
                mesh.model_group = group
        for m in range(model):
            group = dist.new_group([d * model + m for d in range(data)])
            if m == mesh.model_rank:
                mesh.data_group = group
    return mesh


class RowParallelLinear(nn.Module):
    """A Linear whose input features are split over the model group: the
    rank's partial product, summed over the group by one all-reduce in
    float32, plus the bias, in the input's dtype. Its state dict is the
    Linear's (weight: this rank's columns; bias: whole)."""

    def __init__(self, linear: nn.Linear, mesh: Mesh):
        super().__init__()
        self.weight, self.bias, self.mesh = linear.weight, linear.bias, mesh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and (x.requires_grad
                                        or self.weight.requires_grad):
            raise RuntimeError("tensor parallelism covers the eval forward: "
                               "call it under torch.no_grad() or "
                               "torch.inference_mode()")
        y = F.linear(x, self.weight).float()
        dist.all_reduce(y, group=self.mesh.model_group)
        self.mesh.all_reduces += 1
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


def shard_segmentor_(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Shard `model` in place over `mesh`'s model axis (`tp_plan`): the
    split parameters become this rank's shares, the split modules' head
    counts and depthwise convs shrink to them, their row-parallel layers
    become `RowParallelLinear`s. Returns `model`; the identity at model
    size 1."""
    tp, m = mesh.model, mesh.model_rank
    if tp == 1:
        return model
    if mesh.model_group is None:
        raise RuntimeError(f"a model axis of {tp} needs a process group")
    split = [module for module in model.modules()
             if _units(module) and _units(module) % tp == 0]
    for name, s in tp_plan(model, tp).items():
        owner_name, _, attr = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        p = getattr(owner, attr)
        setattr(owner, attr, nn.Parameter(shard(p.detach(), s, m, tp),
                                          requires_grad=p.requires_grad))
    for module in split:
        heads, row = _MODULES[type(module)]
        if heads:
            setattr(module, heads, getattr(module, heads) // tp)
        for c in module.modules():
            if isinstance(c, nn.Linear):
                c.out_features, c.in_features = c.weight.shape
            elif isinstance(c, nn.Conv2d) and c.groups > 1:  # depthwise
                c.groups = c.in_channels = c.out_channels = c.weight.shape[0]
        setattr(module, row, RowParallelLinear(getattr(module, row), mesh))
    return model
