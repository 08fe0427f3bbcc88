"""EncoderDecoder: backbone + SegFormer head, logits resized to the input
size. The counterpart of multimodal_sam_adapter_tpu/models/segmentor.py:
`forward` is its `__call__` with train=False (eval mode only), `loss` its
training loss, run in train mode (model.train()).

Build models with `build_segmentor`: it constructs on the meta device (no
random draw) and then either loads a state_dict or draws every parameter
from an explicit `torch.Generator`.
"""
from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..nn.layers import BiasFreeLayerNorm, LayerNorm2d, checkpoint
from ..utils.interpolate import resize_bilinear
from .backbone import SAMAdapterBimodal
from .losses import ohem_cross_entropy
from .segformer_head import SegformerHead


class EncoderDecoder(nn.Module):
    def __init__(self, num_classes: int = 25, head_channels: int = 512,
                 backbone_cfg: Optional[dict] = None,
                 dropout_ratio: float = 0.1):
        super().__init__()
        self.backbone = SAMAdapterBimodal(**(backbone_cfg or {}))
        self.decode_head = SegformerHead(self.backbone.embed_dim,
                                         num_classes, head_channels,
                                         dropout_ratio=dropout_ratio)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        """img (B, H, W, C_in) NHWC -> logits (B, H, W, classes) NHWC."""
        self._check_eval()
        feats = self.backbone.forward_features(img.permute(0, 3, 1, 2))
        logits = resize_bilinear(self.decode_head(feats), img.shape[1:3])
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
        nn.layers.set_dropout_key set."""
        feats = self.backbone.forward_features(img.permute(0, 3, 1, 2))

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

    def _check_eval(self):
        if self.training:
            raise NotImplementedError(
                "forward runs in eval mode only (call .eval() first); the "
                "train-mode forward is `loss`")


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
                    generator: Optional[torch.Generator] = None
                    ) -> EncoderDecoder:
    """EncoderDecoder from a registry `model` config, in eval mode on
    `device`, with weights from `state_dict` (loaded strictly) or drawn from
    `generator`. Exactly one of the two must be given."""
    if (state_dict is None) == (generator is None):
        raise ValueError("give exactly one of state_dict and generator")
    cfg = copy.deepcopy(model_cfg)
    with torch.device("meta"):
        model = EncoderDecoder(num_classes=cfg["num_classes"],
                               head_channels=cfg["head_channels"],
                               backbone_cfg=cfg["backbone"],
                               dropout_ratio=cfg.get("dropout_ratio", 0.1))
    model = model.to_empty(device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        random_init_(model, generator)
    return model.eval()
