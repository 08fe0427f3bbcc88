"""EncoderDecoder: backbone + decode head, logits resized to the input
size. The counterpart of multimodal_sam_adapter_tpu/models/segmentor.py:
`forward` is its `__call__` with train=False (eval mode only), `loss` its
training loss, run in train mode (model.train()), also reached as
`forward(img, gt)`. The head is the SegFormer head (`head_type`
'segformer', every shipped config) or the Mask2Former head
('mask2former', models/mask2former/: semantic scores from the final
queries' class x mask product; Hungarian-matched point losses over every
decoder layer's predictions).

Build models with `build_segmentor`: it constructs on the meta device (no
random draw) and then either loads a state_dict or draws every parameter
from an explicit `torch.Generator`: as the JAX package initialises it
(`init="jax"`, models/init.py, the start of training), or from N(0, std)
(`random_init_`, the default: every kernel path carries signal, which the
tests and the kernel checks want).
"""
from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..nn.layers import (BiasFreeLayerNorm, LayerNorm2d, checkpoint,
                         fold_in)
from ..utils.interpolate import resize_bilinear
from .backbone import SAMAdapterBimodal
from .init import init_weights_
from .losses import ohem_cross_entropy
from .mask2former import (Mask2FormerHead, draw_points, mask2former_loss,
                          match_queries, semantic_inference)
from .segformer_head import SegformerHead

HEAD_TYPES = ("segformer", "mask2former")


class EncoderDecoder(nn.Module):
    def __init__(self, num_classes: int = 25, head_channels: int = 512,
                 backbone_cfg: Optional[dict] = None,
                 dropout_ratio: float = 0.1, head_type: str = "segformer",
                 head_cfg: Optional[dict] = None):
        super().__init__()
        if head_type not in HEAD_TYPES:
            raise ValueError(f"unknown head_type {head_type!r}")
        self.num_classes = num_classes
        self.head_type = head_type
        self.backbone = SAMAdapterBimodal(**(backbone_cfg or {}))
        if head_type == "mask2former":
            self.decode_head = Mask2FormerHead(
                self.backbone.embed_dim, num_classes, head_channels,
                **(head_cfg or {}))
        else:
            self.decode_head = SegformerHead(self.backbone.embed_dim,
                                             num_classes, head_channels,
                                             dropout_ratio=dropout_ratio)

    def _head_logits(self, feats):
        """The head's NCHW logits at stride 4 (Mask2Former: the final
        prediction's float32 semantic scores)."""
        if self.head_type == "mask2former":
            all_cls, all_masks = self.decode_head(feats)
            return semantic_inference(all_cls[-1], all_masks[-1])
        return self.decode_head(feats)

    def forward(self, img: torch.Tensor, gt: Optional[torch.Tensor] = None,
                **loss_kw):
        """img (B, H, W, C_in) NHWC -> logits (B, H, W, classes) NHWC, in
        eval mode. With `gt`, `loss(img, gt, **loss_kw)` in train mode:
        the train step calls the loss through `forward`, where
        DistributedDataParallel prepares its gradient all-reduce."""
        if gt is not None:
            return self.loss(img, gt, **loss_kw)
        self._check_eval()
        feats = self.backbone.forward_features(img.permute(0, 3, 1, 2))
        logits = resize_bilinear(self._head_logits(feats), img.shape[1:3])
        return logits.permute(0, 2, 3, 1)

    def loss(self, img: torch.Tensor, gt: torch.Tensor,
             ignore_index: int = 255, ohem_thresh: float = 0.7,
             ohem_min_kept: int = 100_000, ohem_per_sample: bool = True
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The training loss: OHEM cross entropy on the head's logits
        resized to the label grid. img (B, H, W, C_in) NHWC, gt (B, H', W')
        integer labels. Returns (loss, logits (B, H', W', classes) NHWC).
        Head, resize and loss run as one checkpointed unit while autograd
        records (the JAX package's nn.remat(_head_loss)): their float32
        full-resolution logits and softmax are not kept for the backward.
        In train mode every dropout draws from the key that
        nn.layers.set_dropout_key set.

        The Mask2Former head takes `mask2former_loss` instead (the OHEM
        arguments do not apply), not checkpointed, as the JAX package
        runs it."""
        feats = self.backbone.forward_features(img.permute(0, 3, 1, 2))
        if self.head_type == "mask2former":
            return self._mask2former_loss(feats, gt, ignore_index)

        def head_loss(*feats):
            logits = resize_bilinear(self.decode_head(list(feats)),
                                     gt.shape[1:3]).permute(0, 2, 3, 1)
            loss = ohem_cross_entropy(
                logits, gt, ignore_index=ignore_index, thresh=ohem_thresh,
                min_kept=ohem_min_kept, per_sample=ohem_per_sample)
            return loss, logits

        if torch.is_grad_enabled():
            return checkpoint(head_loss, *feats, module=self.decode_head)
        return head_loss(*feats)

    def _mask2former_loss(self, feats, gt, ignore_index):
        """The mean of `mask2former_loss` over the predictions before the
        first decoder layer and after each. Prediction i of sample b draws
        its points from fold_in(fold_in(key, i), row), key the step's
        (set_dropout_key), row b's index in the global batch. The head's
        `pinned["assign"]`, when set, replaces the matching; `record`
        keeps the assignments used. Returns (loss, the final prediction's
        scores resized to the labels, NHWC, detached)."""
        head = self.decode_head
        if head.seed is None:
            raise RuntimeError("no loss key: call set_dropout_key(model, "
                               "key) before the Mask2Former loss")
        all_cls, all_masks = head(feats)
        B, Q = all_cls[0].shape[:2]
        first = head.shard[0] * B
        pinned = (head.pinned or {}).get("assign")
        g = torch.Generator(device=gt.device)
        total, used = 0.0, []
        for i, (cls_l, mask_l) in enumerate(zip(all_cls, all_masks)):
            key = fold_in(head.seed, i)
            draws = [draw_points(g.manual_seed(fold_in(key, first + b)), Q)
                     for b in range(B)]
            assign = (pinned[i] if pinned is not None else match_queries(
                cls_l, mask_l, gt, draws, self.num_classes, ignore_index))
            used.append(assign)
            total = total + mask2former_loss(
                cls_l, mask_l, gt, draws, self.num_classes, ignore_index,
                assign=assign)
        head.record["assign"] = used
        logits = semantic_inference(all_cls[-1].detach(),
                                    all_masks[-1].detach())
        logits = resize_bilinear(logits, gt.shape[1:3]).permute(0, 2, 3, 1)
        return total / len(all_cls), logits

    def _check_eval(self):
        if self.training:
            raise NotImplementedError(
                "forward runs in eval mode only (call .eval() first); the "
                "train-mode forward is `loss`, or forward(img, gt)")


# Normalisation layers, whose gains `random_init_` draws around 1: gains
# around 0 would shrink every activation behind them until the softmaxes
# are uniform, and a wrong attention or sampling kernel would no longer
# show in the logits.
_NORMS = (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d, LayerNorm2d,
          BiasFreeLayerNorm)


@torch.no_grad()
def random_init_(model: nn.Module, generator: torch.Generator,
                 std: float = 0.05) -> nn.Module:
    """Draw every parameter from N(0, std), except the norm gains, which
    are 1 + N(0, std), and every BatchNorm running mean from N(0, std) with
    running variance |N(0, std)| + 0.5, all from `generator` (on the
    model's device)."""
    for p in model.parameters():
        p.normal_(0.0, std, generator=generator)
    for m in model.modules():
        if isinstance(m, _NORMS):
            m.weight.add_(1.0)
        if isinstance(m, nn.BatchNorm2d):
            m.running_mean.normal_(0.0, std, generator=generator)
            m.running_var.normal_(0.0, std, generator=generator)
            m.running_var.abs_().add_(0.5)
            m.num_batches_tracked.zero_()
    return model


def build_segmentor(model_cfg: Dict, device, *,
                    state_dict: Optional[Dict[str, torch.Tensor]] = None,
                    generator: Optional[torch.Generator] = None,
                    init: str = "random") -> EncoderDecoder:
    """EncoderDecoder from a registry `model` config, in eval mode on
    `device`, with weights from `state_dict` (loaded strictly) or drawn from
    `generator` by `init`: 'random' (`random_init_`) or 'jax'
    (models/init.py:init_weights_). Exactly one of state_dict and generator
    must be given."""
    if (state_dict is None) == (generator is None):
        raise ValueError("give exactly one of state_dict and generator")
    cfg = copy.deepcopy(model_cfg)
    with torch.device("meta"):
        model = EncoderDecoder(num_classes=cfg["num_classes"],
                               head_channels=cfg["head_channels"],
                               backbone_cfg=cfg["backbone"],
                               dropout_ratio=cfg.get("dropout_ratio", 0.1),
                               head_type=cfg.get("head_type", "segformer"),
                               head_cfg=cfg.get("head"))
    model = model.to_empty(device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    elif init == "jax":
        init_weights_(model, cfg["backbone"], generator)
    elif init == "random":
        random_init_(model, generator)
    else:
        raise ValueError(f"unknown init {init!r}")
    return model.eval()
