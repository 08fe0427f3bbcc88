"""A cell at deliver_tiny's sizes for the CPU tests: the harness's
configuration, mixes and limits, built in memory."""
from __future__ import annotations

import copy
import json

from port_bench import yardstick
from port_bench.harness import REPO

TINY_MODEL = {
    "num_classes": 25, "head_channels": 16, "dropout_ratio": 0.1,
    "backbone": {
        "img_size": 64, "patch_size": 16, "embed_dim": 32, "depth": 4,
        "num_heads": 2, "drop_path_rate": 0.1, "conv_drop_path_rate": 0.1,
        "conv_inplane": 40, "n_points": 2, "deform_num_heads": 4,
        "init_values": 1e-6, "cffn_ratio": 0.25, "deform_ratio": 0.5,
        "interaction_indexes": [[0, 0], [1, 1], [2, 2], [3, 3]],
        "global_attn_indexes": [1, 3], "window_size": 2,
        "pretrained_size": 64, "modalities_ch": [3, 3], "arch": "atto",
        "mlp_ratio": 4.0, "with_cp": True}}


def tiny_loaded(workload: str, mode: str = "whole_dim",
                limits=None) -> dict:
    """load_cell's result for `workload` of BENCHMARK.json, its
    configuration cut to deliver_tiny's model at 64x64 (96x128 frames for
    slide, in 64x64 windows at stride 32) in float32."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    from port_bench.harness import load_cell
    loaded = load_cell(workload, bench)
    config = copy.deepcopy(loaded["config"])
    config["model"] = copy.deepcopy(TINY_MODEL)
    config["model"]["num_classes"] = config["model"]["num_classes"]
    config["serve_dtype"] = "float32"
    config["compute_dtype"] = None
    config["optimizer"].update(max_epochs=2, warmup_epochs=1)
    config["steps_per_epoch"] = 4
    if mode == "slide":
        config["model"]["backbone"]["modalities_ch"] = [3, 3, 3]
        config["test_cfg"] = {"mode": "slide", "crop_size": [64, 64],
                              "stride": [32, 32]}
        config["frame_hw"] = [96, 128]
    else:
        config["test_cfg"] = {"mode": "whole_dim", "rescale": True,
                              "dim": [64, 64]}
        config["frame_hw"] = [64, 64]
    config["flops"] = {
        "forward": {"64x64": yardstick.count_flops(config["model"], 1,
                                                    (64, 64), False)},
        "train": {"64x64": yardstick.count_flops(config["model"], 1,
                                                  (64, 64), True)}}
    loaded["config"] = config
    loaded["mix"] = dict(loaded["mix"], pool=min(loaded["mix"]["pool"], 4))
    if limits is not None:
        loaded["limits"] = limits
    return loaded
