"""Config registry: one entry per (dataset x modality), mirroring the
reference's configs/ tree (SURVEY.md 2.5).

The port's own copy of multimodal_sam_adapter_tpu/configs/registry.py:
the same names and the same dicts (tests/test_torch_shared_copies.py holds
the two equal).

Configs are plain nested dicts (json-able, CLI-overridable via dotted
paths). `_base_`-style inheritance is replaced by python composition below —
same shape, no custom loader magic.
"""
from __future__ import annotations

import copy
from typing import Dict

# ---------------------------------------------------------------------------
# shared building blocks
# ---------------------------------------------------------------------------

SAM_VIT_L_ADAPTER = dict(
    img_size=1024,
    patch_size=16,
    embed_dim=1024,
    depth=24,
    num_heads=16,
    mlp_ratio=4.0,
    drop_path_rate=0.3,
    conv_drop_path_rate=0.4,
    conv_inplane=48,
    n_points=4,
    deform_num_heads=16,
    init_values=1e-6,
    cffn_ratio=0.25,
    deform_ratio=0.5,
    interaction_indexes=((0, 5), (6, 11), (12, 17), (18, 23)),
    global_attn_indexes=(5, 11, 17, 23),
    window_size=14,
    pretrained_size=1024,
    arch="small",
    with_cp=True,
)

OPTIMIZER = dict(
    base_lr=2e-4,
    weight_decay=0.01,
    betas=(0.9, 0.999),
    num_layers=24,
    layer_decay_rate=0.9,
    power=0.9,
    min_lr=0.0,
    warmup_epochs=10,
    warmup_ratio=0.1,
    max_epochs=100,
)

# per-modality normalization (reference configs/*: mean/std with
# norm_by_max=True -> divide by 255 first; aux modality mean 0 / std 1)
IMAGENET_RGB = dict(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225))
UNIT_AUX = dict(mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0))
# MUSES (reference configs/MUSES/*): norm_by_max divides ONLY the RGB slice
# by 255 (ImageNet 0-1 stats); aux uses measured stats, no BGR flip
MUSES_RGB = IMAGENET_RGB
MUSES_LIDAR = dict(mean=(1.4628459, 1.8271197, 0.07808967),
                   std=(7.55678107, 9.85001751, 0.67012253))
MUSES_EVENT = dict(mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0))


def _deliver(modality: str, mod_suffix: str) -> dict:
    return dict(
        name=f"deliver_rgb{modality}",
        dataset=dict(
            type="DELIVER",
            num_classes=25,
            img_dir="samples/images/{split}",
            ann_dir="samples/annotations/{split}",
            mod_dir="samples/" + modality + "/{split}",
            split_names=dict(train="training", val="validation", test="test"),
            img_suffix="_rgb_front.png",
            seg_map_suffix="_semantic_front.png",
            mod_suffix=mod_suffix,
            modalities_name=("rgb", modality),
            modalities_ch=(3, 3),
            reduce_zero_label=False,
        ),
        model=dict(
            num_classes=25,
            head_channels=512,
            dropout_ratio=0.1,
            backbone=dict(SAM_VIT_L_ADAPTER, modalities_ch=(3, 3)),
        ),
        train_pipeline=dict(
            gaussian_blur=dict(kernel_size=3, p=0.2),
            resize=dict(img_scale=(1042, 1042), ratio_range=(0.5, 2.0)),
            crop=dict(crop_size=(1024, 1024), cat_max_ratio=0.75),
            flip=dict(prob=0.5),
            photometric=True,
            normalize=dict(rgb=IMAGENET_RGB, aux=UNIT_AUX, norm_by_max=True),
            pad=dict(size=(1024, 1024), pad_val=0, seg_pad_val=255),
        ),
        test_pipeline=dict(
            resize=dict(img_scale=(1024, 1024), keep_ratio=True),
            normalize=dict(rgb=IMAGENET_RGB, aux=UNIT_AUX, norm_by_max=True),
        ),
        test_cfg=dict(mode="whole_dim", rescale=True, dim=(1024, 1024)),
        optimizer=dict(OPTIMIZER),
        data=dict(samples_per_gpu=1, grad_accum=4),
        evaluation=dict(
            interval=1, metric="mIoU", save_best="mIoU",
            resize_dim=(1024, 1024),
            case=("motionblur", "overexposure", "underexposure",
                  "lidarjitter", "eventlowres"),
        ),
        runner=dict(max_epochs=100),
        checkpoint=dict(interval=1, max_keep_ckpts=1),
    )


def _fmb(split: str = "val") -> dict:
    cfg = dict(
        name=f"fmb_rgbtherm_{split}" if split != "val" else "fmb_rgbtherm",
        dataset=dict(
            type=f"FMB_{split}",
            num_classes=14,
            img_dir="{split}/Visible",
            ann_dir="{split}/Label",
            mod_dir="{split}/Infrared",
            split_names=dict(train="train", val="val", test="test"),
            img_suffix=".png",
            seg_map_suffix=".png",
            mod_suffix=".png",
            modalities_name=("rgb", "therm"),
            modalities_ch=(3, 3),
            reduce_zero_label=True,
        ),
        model=dict(
            num_classes=14,
            head_channels=512,
            dropout_ratio=0.1,
            backbone=dict(SAM_VIT_L_ADAPTER, img_size=800, modalities_ch=(3, 3)),
        ),
        train_pipeline=dict(
            gaussian_blur=dict(kernel_size=3, p=0.2),
            resize=dict(img_scale=(800, 600), ratio_range=(0.5, 2.0)),
            crop=dict(crop_size=(800, 800), cat_max_ratio=0.75),
            flip=dict(prob=0.5),
            photometric=True,
            normalize=dict(rgb=IMAGENET_RGB, aux=UNIT_AUX, norm_by_max=True),
            pad=dict(size=(800, 800), pad_val=0, seg_pad_val=255),
        ),
        # reference FMB test pipeline pads the 800x600 input to 800x800
        # BEFORE normalize (no resize); whole_dim_cut crops logits back
        test_pipeline=dict(
            resize=None,
            pad=dict(size=(800, 800)),
            normalize=dict(rgb=IMAGENET_RGB, aux=UNIT_AUX, norm_by_max=True),
        ),
        test_cfg=dict(
            mode="whole_dim_cut", rescale=False, dim=(600, 800),
            cut_dim=(800, 600),
        ),
        optimizer=dict(OPTIMIZER),
        data=dict(samples_per_gpu=2, grad_accum=2),
        evaluation=dict(interval=1, metric="mIoU", save_best="mIoU",
                        resize_dim=(800, 600), case=None),
        runner=dict(max_epochs=100),
        checkpoint=dict(interval=1, max_keep_ckpts=1),
    )
    return cfg


def _muses(modality: str) -> dict:
    aux_norm = MUSES_LIDAR if modality == "lidar" else MUSES_EVENT
    return dict(
        name=f"muses_rgb{modality}",
        dataset=dict(
            type="MUSES",
            num_classes=19,
            img_dir="frame_camera/{split}",
            ann_dir="gt_semantic/{split}",
            mod_dir="projected_to_rgb/" + modality + "/{split}",
            split_names=dict(train="train", val="val", test="test"),
            img_suffix="_frame_camera.png",
            seg_map_suffix="_gt_labelTrainIds.png",
            mod_suffix=f"_{'event_camera' if modality == 'event' else modality}.npz",
            modalities_name=("rgb", modality),
            modalities_ch=(3, 3),
            cases=("clear", "rain", "fog", "snow"),
            conditions=("day", "night"),
            reduce_zero_label=False,
        ),
        model=dict(
            num_classes=19,
            head_channels=512,
            dropout_ratio=0.1,
            backbone=dict(SAM_VIT_L_ADAPTER, modalities_ch=(3, 3)),
        ),
        train_pipeline=dict(
            gaussian_blur=dict(kernel_size=3, p=0.2),
            resize=dict(img_scale=(2048, 1024), ratio_range=(0.5, 2.0)),
            crop=dict(crop_size=(1024, 1024), cat_max_ratio=0.75),
            flip=dict(prob=0.5),
            photometric=True,
            normalize=dict(rgb=MUSES_RGB, aux=aux_norm, norm_by_max=True,
                           rgb_only_255=True, to_rgb=(True, False)),
            pad=dict(size=(1024, 1024), pad_val=0, seg_pad_val=255),
        ),
        test_pipeline=dict(
            resize=dict(img_scale=(2048, 1024), keep_ratio=True),
            normalize=dict(rgb=MUSES_RGB, aux=aux_norm, norm_by_max=True,
                           rgb_only_255=True, to_rgb=(True, False)),
        ),
        test_cfg=dict(mode="slide", crop_size=(1024, 1024), stride=(640, 640)),
        optimizer=dict(OPTIMIZER),
        data=dict(samples_per_gpu=1, grad_accum=4),
        evaluation=dict(interval=1, metric="mIoU", save_best="mIoU",
                        resize_dim=None, case=None),
        runner=dict(max_epochs=100),
        checkpoint=dict(interval=1, max_keep_ckpts=1),
    )


_CONFIGS: Dict[str, dict] = {}


def _register(cfg: dict):
    _CONFIGS[cfg["name"]] = cfg


_register(_deliver("lidar", "_lidar_front.png"))
_register(_deliver("depth", "_depth_front.png"))
_register(_deliver("event", "_event_front.png"))
for split in ("easy", "hard"):
    c = _deliver("lidar", "_lidar_front.png")
    c["name"] = f"deliver_rgblidar_{split}"
    c["dataset"]["type"] = f"DELIVER_{split}"
    _register(c)
_register(_fmb("val"))
_register(_fmb("easy"))
_register(_fmb("hard"))
_register(_muses("lidar"))
_register(_muses("event"))


def _muses_two_aux() -> dict:
    """RGB + event + lidar: mod_dir/mod_suffix as aligned LISTS, mirroring
    the reference's base dataset config (configs/_base_/datasets/muses.py:
    30-31 carries ['projected_to_rgb/event_camera/...',
    'projected_to_rgb/lidar/...'])."""
    cfg = _muses("lidar")
    cfg["name"] = "muses_rgbeventlidar"
    d = cfg["dataset"]
    d["mod_dir"] = ["projected_to_rgb/event_camera/{split}",
                    "projected_to_rgb/lidar/{split}"]
    d["mod_suffix"] = ["_event_camera.npz", "_lidar.npz"]
    d["modalities_name"] = ("rgb", "event", "lidar")
    d["modalities_ch"] = (3, 3, 3)
    cfg["model"]["backbone"]["modalities_ch"] = (3, 3, 3)
    for pl in ("train_pipeline", "test_pipeline"):
        cfg[pl]["normalize"]["aux"] = [MUSES_EVENT, MUSES_LIDAR]
        cfg[pl]["normalize"]["to_rgb"] = (True, False, False)
    return cfg


_register(_muses_two_aux())


def _deliver_tiny() -> dict:
    """Test-scale config: atto twin-conv, 4-block ViT, 64x64 crops. Used by
    the CLI integration tests and CI-scale experiments."""
    cfg = _deliver("lidar", "_lidar_front.png")
    cfg["name"] = "deliver_tiny"
    cfg["model"]["num_classes"] = 25
    cfg["model"]["head_channels"] = 16
    cfg["model"]["backbone"] = dict(
        img_size=64, patch_size=16, embed_dim=32, depth=4, num_heads=2,
        drop_path_rate=0.1, conv_drop_path_rate=0.1, conv_inplane=40,
        n_points=2, deform_num_heads=4, init_values=1e-6, cffn_ratio=0.25,
        deform_ratio=0.5,
        interaction_indexes=((0, 0), (1, 1), (2, 2), (3, 3)),
        global_attn_indexes=(1, 3), window_size=2, pretrained_size=64,
        modalities_ch=(3, 3), arch="atto",
    )
    cfg["train_pipeline"]["resize"] = dict(img_scale=(80, 80),
                                           ratio_range=(0.8, 1.2))
    cfg["train_pipeline"]["crop"] = dict(crop_size=(64, 64),
                                         cat_max_ratio=0.75)
    cfg["train_pipeline"]["pad"] = dict(size=(64, 64), pad_val=0,
                                        seg_pad_val=255)
    cfg["test_pipeline"]["resize"] = dict(img_scale=(64, 64), keep_ratio=True)
    cfg["test_cfg"] = dict(mode="whole_dim", rescale=True, dim=(64, 64))
    cfg["optimizer"].update(max_epochs=2, warmup_epochs=1)
    cfg["data"] = dict(samples_per_gpu=2, grad_accum=1)
    cfg["evaluation"] = dict(interval=1, metric="mIoU", save_best="mIoU",
                             resize_dim=(64, 64),
                             case=("motionblur",))
    cfg["runner"] = dict(max_epochs=2)
    return cfg


_register(_deliver_tiny())


def _deliver_tiny_m2f() -> dict:
    """Test-scale Mask2Former-head variant (the reference registers
    Mask2FormerHead but ships no config using it; this config exercises the
    full query-based head + matched point-sampled losses end to end)."""
    cfg = _deliver_tiny()
    cfg["name"] = "deliver_tiny_m2f"
    cfg["model"]["head_type"] = "mask2former"
    cfg["model"]["head_channels"] = 32
    cfg["model"]["head"] = dict(num_queries=8, num_decoder_layers=2,
                                num_encoder_layers=1)
    return cfg


_register(_deliver_tiny_m2f())


def _muses_tiny() -> dict:
    """Test-scale MUSES config (case x condition dir tree, .npz aux,
    slide inference) for the CLI integration tests."""
    cfg = _muses("lidar")
    cfg["name"] = "muses_tiny"
    cfg["model"]["num_classes"] = 19
    cfg["model"]["head_channels"] = 16
    cfg["model"]["backbone"] = dict(
        copy.deepcopy(_CONFIGS["deliver_tiny"]["model"]["backbone"]),
        modalities_ch=(3, 3),
    )
    cfg["train_pipeline"]["resize"] = dict(img_scale=(96, 80),
                                           ratio_range=(0.8, 1.2))
    cfg["train_pipeline"]["crop"] = dict(crop_size=(64, 64),
                                         cat_max_ratio=0.75)
    cfg["train_pipeline"]["pad"] = dict(size=(64, 64), pad_val=0,
                                        seg_pad_val=255)
    cfg["test_pipeline"]["resize"] = dict(img_scale=(96, 80), keep_ratio=True)
    cfg["test_cfg"] = dict(mode="slide", crop_size=(64, 64), stride=(32, 32))
    cfg["optimizer"].update(max_epochs=2, warmup_epochs=1)
    cfg["data"] = dict(samples_per_gpu=2, grad_accum=1)
    cfg["evaluation"] = dict(interval=1, metric="mIoU", save_best="mIoU",
                             resize_dim=None, case=("rain",))
    cfg["runner"] = dict(max_epochs=2)
    return cfg


_register(_muses_tiny())


def list_configs():
    return sorted(_CONFIGS)


def get_config(name: str) -> dict:
    if name not in _CONFIGS:
        raise KeyError(f"unknown config '{name}'; known: {list_configs()}")
    return copy.deepcopy(_CONFIGS[name])


def apply_overrides(cfg: dict, overrides: Dict[str, str]) -> dict:
    """CLI --cfg-options style dotted-path deep overrides."""
    import ast

    for dotted, raw in overrides.items():
        node = cfg
        keys = dotted.split(".")
        for k in keys[:-1]:
            # create missing intermediate dicts (mmcv's merge_from_dict
            # semantics): lets overrides add optional blocks like
            # log_config.interval without pre-declaring them per-config
            node = node.setdefault(k, {}) if isinstance(node, dict) else node[k]
        try:
            val = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            val = raw
        node[keys[-1]] = val
    return cfg
