"""Tensor parallelism: the counterpart of
multimodal_sam_adapter_tpu/parallel/tp.py, with the (data, model) mesh of
its mesh.py:make_mesh(('data', 'model')), for the eval forward and the
train step (__graft_entry__.py:_dryrun_multichip_impl).

The JAX package gives the parameters NamedShardings over the mesh's
'model' axis from a rule table and leaves the collectives, forward and
backward, to XLA's partitioner. The port runs one process a rank, so it
splits the tensors itself and adds Megatron's pair of collectives by hand:

- `make_mesh(data, model)`: the ranks as a (data, model) grid with model
  innermost, rank = d * model + m as in JAX's make_mesh(shape=(data,
  model)), with a process group for each model row and each data column.
  The data axis splits the batch; the model axis splits the modules below.
- `tp_spec(name, param)`: the rule table, on the port's parameter names
  (the reference's keys). Column-parallel, the output axis split: the ViT's
  `attn.qkv` and `mlp.lin1`; MSDA's `value_proj`, and its
  `sampling_offsets` and `attention_weights`, which JAX replicates (the
  function is the same: MSDA's softmax runs per head), in the adapter
  (`attn.*`) and in the Mask2Former pixel decoder (`attentions.<i>.*`);
  ConvFFN's `fc1` and its depthwise `dwconv`. Row-parallel, the input axis
  split: `attn.proj`, `mlp.lin2`, `output_proj`, `ffn.fc2`, whose partial
  outputs one all-reduce over the model group sums (in float32), the bias
  added once.
- The split is head-aligned, so that every rank computes whole heads and
  the model computes the unsharded function: a rank's qkv rows are the q,
  k and v rows of its num_heads / tp heads, K1 and K2 run on num_heads /
  tp heads and K3 and K4 on n_heads / tp; the rel-pos tables (one row of
  head_dim values a position, shared by every head) stay replicated.
- A module whose heads (the attentions) or hidden units (MLP, ConvFFN) do
  not divide by the model size stays replicated, as JAX replicates a leaf
  that does not divide. Everything else (the spatial prior with K5, or
  the RGB-only conv stem, K6, the neck, the head) stays replicated.
- The rules read module types and parameter names only, so they shard
  any module built of these parts: the bimodal and the RGB-only
  segmentor, the Mask2Former head's pixel decoder, and the standalone SAM
  encoder (models/sam_vit.py:ImageEncoderViT, whose keys are
  `blocks.<i>.attn.qkv...`).

Training. The backward of a split module needs the other half of
Megatron's pair: its input's gradient is each rank's partial sum over its
heads (or hidden units). `_CopyToModel` (the identity forward, an
all-reduce of the gradient over the model group) sits at the inputs that
feed split projections: ViTAttention's x, MLPBlock's and ConvFFN's input,
MSDA's query (offsets and weights) and input_flatten (value), by forward
pre-hooks; the parameters that a split module uses inside the split and
keeps whole (the ViT's rel-pos tables) get the same all-reduce of their
gradient by a tensor hook. `_SumOverModel` (the all-reduce forward, the
identity backward) is the row-parallel sum. `Mesh` counts the forward's,
the `with_cp` recompute's and the backward's all-reduces apart. The
model ranks of a data row hold the same samples: the data group carries
DistributedDataParallel (parallel/ddp.py:wrap_model(model,
mesh.data_group)), the BatchNorm statistics (nn/layers.py:set_sync_group)
and the dropout rows (engine/train.py), and everything outside the split
modules computes the same on every model rank.

`tp_plan(model, tp)` is the split of a built model's parameters,
`shard_state_dict` / `gather_state_dict` take a full state dict to one
rank's shard and back, `shard_segmentor_` shards a built segmentor in
place, `gather_train_state` / `shard_train_state` take the model's and
the optimizer's state (Adam's moments, an accumulation's gradients) to
their unsharded form and back, which is what checkpoints hold. With
tp = 1 each is the identity.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.adapter import ConvFFN
from ..models.sam_vit import ViTAttention
from ..nn.layers import MLPBlock, recomputing, set_sync_group
from ..ops.msda import MSDeformAttention
from .ddp import _wire_device, average_partial_grads, rank_world


class Split(NamedTuple):
    """A tensor's axis `dim` split over the model ranks; the axis holds
    `parts` blocks (qkv's q, k and v), each split alike."""
    dim: int
    parts: int = 1


COLUMN, ROW = Split(0), Split(1)
# MSDA's prefix: `attn.` in the adapter, `attentions.<i>.` in the
# Mask2Former pixel decoder's encoder layers
_MSDA = r"(?:attn|attentions\.\d+)\."
# (name pattern, rank of the weight, split): biases are 1-D. JAX's rules
# take 2-D kernels only, which keeps the neck's 1x1-conv `attn.proj` out
_RULES = (
    (r"attn\.qkv\.(weight|bias)$", 2, Split(0, 3)),
    (r"attn\.proj\.weight$", 2, ROW),
    (r"mlp\.lin1\.(weight|bias)$", 2, COLUMN),
    (r"mlp\.lin2\.weight$", 2, ROW),
    (_MSDA + r"(value_proj|sampling_offsets|attention_weights)\."
     r"(weight|bias)$", 2, COLUMN),
    (_MSDA + r"output_proj\.weight$", 2, ROW),
    (r"ffn\.fc1\.(weight|bias)$", 2, COLUMN),
    (r"ffn\.dwconv\.dwconv\.(weight|bias)$", 4, COLUMN),
    (r"ffn\.fc2\.weight$", 2, ROW),
)
# the modules the model axis splits: their head-count attribute (None:
# the units are the row-parallel layer's input features), their
# row-parallel layer, and the positions in their forward's arguments of
# the inputs that feed split projections
_MODULES = {ViTAttention: ("num_heads", "proj", (0,)),
            MSDeformAttention: ("n_heads", "output_proj", (0, 2)),
            MLPBlock: (None, "lin2", (0,)),
            ConvFFN: (None, "fc2", (0,))}


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
    heads, row, _ = kind
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
    with one process). The model-group all-reduces, counted apart: the
    row-parallel sums of the forward (`all_reduces`) and of the `with_cp`
    recompute (`recompute_all_reduces`), the gradient sums of the backward
    (`backward_all_reduces`)."""
    data: int
    model: int
    rank: int = 0
    model_group: Optional[dist.ProcessGroup] = None
    data_group: Optional[dist.ProcessGroup] = None
    all_reduces: int = 0
    recompute_all_reduces: int = 0
    backward_all_reduces: int = 0

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    def reset_counts(self) -> None:
        self.all_reduces = self.recompute_all_reduces = 0
        self.backward_all_reduces = 0


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


def _sum_over_model_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`t` (float32) summed in place over the model group."""
    dist.all_reduce(t, group=mesh.model_group)
    return t


class _SumOverModel(torch.autograd.Function):
    """The row-parallel sum: the ranks' float32 partial outputs all-reduced
    over the model group in the forward (in place), the output's gradient
    handed on unchanged in the backward (each rank's partial output enters
    the sum once)."""

    @staticmethod
    def forward(ctx, y, mesh):
        _sum_over_model_(y, mesh)
        ctx.mark_dirty(y)
        if recomputing():
            mesh.recompute_all_reduces += 1
        else:
            mesh.all_reduces += 1
        return y

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def _sum_gradient(g: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A gradient that each model rank holds a partial sum of, summed over
    the model group in float32, in its own dtype."""
    out = _sum_over_model_(g.to(torch.float32, copy=True), mesh).to(g.dtype)
    mesh.backward_all_reduces += 1
    return out


class _CopyToModel(torch.autograd.Function):
    """The input of a split module: the identity in the forward; in the
    backward the input's gradient, of which each model rank holds the
    share its heads (hidden units) give, summed over the model group."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, dy):
        return _sum_gradient(dy, ctx.mesh), None


class RowParallelLinear(nn.Module):
    """A Linear whose input features are split over the model group: the
    rank's partial product, summed over the group by one all-reduce in
    float32 (`_SumOverModel`), plus the bias, in the input's dtype. Its
    state dict is the Linear's (weight: this rank's columns; bias:
    whole)."""

    def __init__(self, linear: nn.Linear, mesh: Mesh):
        super().__init__()
        self.weight, self.bias, self.mesh = linear.weight, linear.bias, mesh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _SumOverModel.apply(F.linear(x, self.weight).float(), self.mesh)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


def _copy_inputs_hook(positions: Tuple[int, ...], mesh: Mesh):
    """A forward pre-hook passing the arguments at `positions` through
    `_CopyToModel` when autograd records (eval forwards are left as they
    are)."""

    def hook(module, args):
        if not torch.is_grad_enabled():
            return None
        if len(args) <= max(positions):
            raise RuntimeError(
                f"{type(module).__name__} under tensor parallelism takes "
                f"the inputs at positions {positions} positionally")
        return tuple(_CopyToModel.apply(a, mesh) if i in positions else a
                     for i, a in enumerate(args))

    return hook


def shard_segmentor_(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Shard `model` in place over `mesh`'s model axis (`tp_plan`): the
    split parameters become this rank's shares (marked with their Split
    as `tp_split`), the split modules' head counts and depthwise convs
    shrink to them, their row-parallel layers become `RowParallelLinear`s,
    their inputs pass `_CopyToModel`, the whole parameters they use inside
    the split sum their gradients over the model group, and the BatchNorm
    statistics merge over the data group. Build the optimizer after it,
    on the new parameters. Returns `model`; the identity at model size
    1."""
    tp, m = mesh.model, mesh.model_rank
    if tp == 1:
        return model
    if mesh.model_group is None:
        raise RuntimeError(f"a model axis of {tp} needs a process group")
    plan = tp_plan(model, tp)
    split = [(prefix, module) for prefix, module in model.named_modules()
             if _units(module) and _units(module) % tp == 0]
    for name, s in plan.items():
        owner_name, _, attr = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        p = getattr(owner, attr)
        p = nn.Parameter(shard(p.detach(), s, m, tp),
                         requires_grad=p.requires_grad)
        p.tp_split = s
        setattr(owner, attr, p)
    for prefix, module in split:
        heads, row, inputs = _MODULES[type(module)]
        if not any(n in plan for n, _ in module.named_parameters(
                prefix=prefix)):
            raise RuntimeError(f"{prefix}: no rule of the table names the "
                               f"parameters of this {type(module).__name__}")
        if heads:
            setattr(module, heads, getattr(module, heads) // tp)
        for c in module.modules():
            if isinstance(c, nn.Linear):
                c.out_features, c.in_features = c.weight.shape
            elif isinstance(c, nn.Conv2d) and c.groups > 1:  # depthwise
                c.groups = c.in_channels = c.out_channels = c.weight.shape[0]
        row_layer = getattr(module, row)
        for p in module.parameters():
            if p.requires_grad and getattr(p, "tp_split", None) is None \
                    and not any(p is q for q in row_layer.parameters()):
                p.register_hook(lambda g: _sum_gradient(g, mesh))
        setattr(module, row, RowParallelLinear(row_layer, mesh))
        module.register_forward_pre_hook(_copy_inputs_hook(inputs, mesh))
    set_sync_group(model, mesh.data_group)
    return model


# ------------------------------------------------------------ train state

def gather_over_model(t: torch.Tensor, split: Split,
                       mesh: Mesh) -> torch.Tensor:
    """The whole tensor of which each model rank holds its share `t` (a
    collective over the model group; the bytes travel as they are, on the
    backend's device)."""
    flat = t.detach().contiguous().reshape(-1).view(torch.uint8).to(
        _wire_device())
    parts = [torch.empty_like(flat) for _ in range(mesh.model)]
    dist.all_gather(parts, flat, group=mesh.model_group)
    return gather([q.to(t.device).view(t.dtype).view(t.shape)
                   for q in parts], split)


def sharded_plan(model: nn.Module) -> Dict[str, Split]:
    """name -> Split of the parameters of `model` that `shard_segmentor_`
    split: the plan it was sharded by."""
    return {n: p.tp_split for n, p in model.named_parameters()
            if getattr(p, "tp_split", None) is not None}


def _names(optimizer_state: dict) -> Dict[int, str]:
    """index -> parameter name of an optimizer state dict."""
    return {i: n for g in optimizer_state["param_groups"]
            for i, n in zip(g["params"], g["names"])}


def gather_train_state(model: nn.Module, optimizer, mesh: Mesh
                       ) -> Tuple[Dict[str, torch.Tensor], dict]:
    """The unsharded model and optimizer state of a sharded run, on every
    rank (a collective: every rank calls it), as copies: the segmentor's (not its
    DDP wrapper's) state dict and the optimizer's (LayerDecayAdamW's
    format: Adam's moments, the counts, an accumulation's gradients) with
    each split tensor (`sharded_plan`) gathered over the model group. They
    equal the
    state of the unsharded model and optimizer, and are what
    engine/checkpoint.py writes. Partway through an accumulation the data
    ranks' partial gradients are first averaged over the data group, as
    the runner does before it saves (parallel/ddp.py:
    average_partial_grads)."""
    average_partial_grads(optimizer, mesh.data_group)
    plan = sharded_plan(model)
    model_sd = {k: gather_over_model(v, plan[k], mesh) if k in plan
                else v.clone() for k, v in model.state_dict().items()}
    sd = optimizer.state_dict()
    if mesh.model == 1:
        return model_sd, sd
    names = _names(sd)
    state = {i: {k: gather_over_model(v, plan[names[i]], mesh)
                 if names[i] in plan and torch.is_tensor(v) else v
                 for k, v in st.items()}
             for i, st in sd["state"].items()}
    accum = dict(sd["accum"])
    if "grads" in accum:
        accum["grads"] = [
            gather_over_model(g, plan[names[i]], mesh)
            if g is not None and names[i] in plan else g
            for i, g in enumerate(accum["grads"])]
    return model_sd, dict(sd, state=state, accum=accum)


def shard_train_state(model: nn.Module, optimizer,
                      state_dict: Dict[str, torch.Tensor],
                      optimizer_state: dict, mesh: Mesh) -> None:
    """Load the unsharded state (`gather_train_state`'s, or a checkpoint
    of an unsharded run) into this rank's sharded segmentor and its
    optimizer: each split tensor cut to the rank's share. The inverse of
    `gather_train_state`."""
    m, tp = mesh.model_rank, mesh.model
    plan = sharded_plan(model)
    model.load_state_dict(shard_state_dict(state_dict, plan, m, tp),
                          strict=True)
    names = _names(optimizer_state)

    def cut(i, v):
        if v is None or not torch.is_tensor(v) or names[i] not in plan:
            return v
        return shard(v, plan[names[i]], m, tp)

    sd = dict(optimizer_state, state={
        i: {k: cut(i, v) for k, v in st.items()}
        for i, st in optimizer_state["state"].items()})
    accum = dict(optimizer_state["accum"])
    if "grads" in accum:
        accum["grads"] = [cut(i, g) for i, g in enumerate(accum["grads"])]
    optimizer.load_state_dict(dict(sd, accum=accum))
