"""Kind "predict": a closed loop of one client through
`InferenceEngine.predict`; the check compares a seeded sample of the
window's class maps with the reference's float32 logits."""
from __future__ import annotations

import statistics
import sys
import time
from typing import Dict, List, Optional

from .. import traffic, yardstick
from ..harness import (DTYPES, WARM_UP_REQUESTS, free, geometry,
                       reference_precision, sync)
from ..reference import engine as ref_engine
from ..reference import model as ref_model
from ..weights import draw_state_dict


class Cell:
    """Requests of `mix["batch"]` frames from the host, one at a time."""

    FLOPS_KEY = "forward"   # the configuration's stored count a step
    FORWARDS = 1            # forwards a step runs

    @staticmethod
    def net_inputs(config: dict, mix: dict):
        """(images a step, their (H, W)) as the network sees them: a
        request's frames, or its slide windows."""
        hw = tuple(config["frame_hw"])
        test = config["test_cfg"]
        if test["mode"] == "slide":
            n = len(ref_engine.slide_windows(hw, test["crop_size"],
                                             test["stride"]))
            return mix["batch"] * n, tuple(test["crop_size"])
        return mix["batch"], hw

    def __init__(self, config, mix, seed, device):
        from multimodal_sam_adapter_torch.engine.inference import \
            InferenceEngine
        from multimodal_sam_adapter_torch.models.segmentor import \
            build_segmentor

        self.config, self.mix, self.seed, self.device = (config, mix, seed,
                                                         device)
        dtype = DTYPES[config["serve_dtype"]]
        sd = draw_state_dict(config["model"], seed, device, dtype)
        model = build_segmentor(config["model"], device, state_dict=sd)
        del sd
        self.engine = InferenceEngine(model.to(dtype), config["test_cfg"])
        self.pool = traffic.requests(mix, geometry(config), seed, device)
        self.order = traffic.order(seed, mix["pool"], 1 << 16)
        self.sent = 0
        self.failed = 0

    def sampler(self) -> traffic.Reservoir:
        return traffic.Reservoir(self.mix["sample"], self.seed)

    def warm_up(self) -> None:
        for _ in range(WARM_UP_REQUESTS):
            self.engine.predict(self.pool[0])
        sync(self.device)

    def window(self, seconds: float, sample: Optional[traffic.Reservoir]
               ) -> Dict:
        """Requests back to back until `seconds` have passed since the
        first was sent; each is timed from the call until its class map is
        on the host."""
        lat: List[float] = []
        start = time.perf_counter()
        end = start
        while end - start < seconds:
            idx = self.order[self.sent % len(self.order)]
            self.sent += 1
            t0 = time.perf_counter()
            try:
                out = self.engine.predict(self.pool[idx])
            except RuntimeError as exc:
                print(f"request {self.sent - 1} failed: {exc}",
                      file=sys.stderr)
                self.failed += 1
                end = time.perf_counter()
                continue
            end = time.perf_counter()
            lat.append(end - t0)
            if sample is not None:
                sample.offer((idx, out))
        return dict(steps=len(lat), elapsed=end - start, latencies=lat,
                    work=len(lat) * self.mix["batch"])

    def steps(self, n: int) -> None:
        for _ in range(n):
            idx = self.order[self.sent % len(self.order)]
            self.sent += 1
            self.engine.predict(self.pool[idx])

    def e2e(self, w: Dict) -> Dict[str, float]:
        return dict(img_per_s=w["work"] / w["elapsed"],
                    frame_p95_ms=1e3 * yardstick.percentile(
                        w["latencies"], 95))

    def release(self) -> None:
        del self.engine

    def judge(self, sample: traffic.Reservoir, control: bool = False
              ) -> Dict[str, Dict[str, float]]:
        return judge(self.config, self.seed, self.device, self.pool,
                     sample.items, control)


def judge(config, seed, device, pool, items, control=False
          ) -> Dict[str, Dict[str, float]]:
    """The served class maps of the sampled requests against the
    reference's float32 logits of the same frames: the share of pixels
    whose class is not the reference's, and the reference's probability
    of its best class less that of the served one, averaged over an
    image's pixels (the mean over images) and at the worst pixel. With
    `control`, the same for the class maps of the reference computed on
    float8 operands."""
    dtype = DTYPES[config["serve_dtype"]]
    sd = draw_state_dict(config["model"], seed, device, dtype)
    ref = ref_model.build(config["model"], device)
    ref.load_state_dict({k: v.float() if v.is_floating_point() else v
                         for k, v in sd.items()})
    del sd
    ref.eval()
    sides = ["program"] + (["control"] if control else [])
    acc = {s: dict(wrong=0, pixels=0, gaps=[], worst=0.0) for s in sides}
    test = config["test_cfg"]
    for idx, served in items:
        imgs = pool[idx].to(device)
        for b in range(imgs.shape[0]):
            img = imgs[b:b + 1].float()
            with reference_precision():
                want = ref_engine.logits_of(ref, img, test)[0]
            prob = want.softmax(-1)
            best = prob.max(-1).values
            label = want.argmax(-1)
            maps = dict(program=served[b].to(device))
            if control:
                with reference_precision(fp8=True):
                    maps["control"] = ref_engine.logits_of(
                        ref, img, test)[0].argmax(-1)
            for side, got in maps.items():
                a = acc[side]
                if tuple(got.shape) != tuple(want.shape[:2]):
                    # an answer of another shape is wrong at every pixel
                    a["wrong"] += label.numel()
                    a["pixels"] += label.numel()
                    a["gaps"].append(1.0)
                    a["worst"] = 1.0
                    continue
                gap = best - prob.gather(-1, got.long()[..., None])[..., 0]
                a["wrong"] += int((got != label).sum())
                a["pixels"] += got.numel()
                a["gaps"].append(float(gap.mean()))
                a["worst"] = max(a["worst"], float(gap.max()))
    del ref
    free(device)
    return {s: dict(mismatch_share=a["wrong"] / max(a["pixels"], 1),
                    mean_prob_gap=(statistics.fmean(a["gaps"]) if a["gaps"]
                                   else 1.0),
                    max_prob_gap=a["worst"]) for s, a in acc.items()}
