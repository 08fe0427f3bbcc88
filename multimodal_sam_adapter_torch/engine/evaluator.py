"""Evaluation loop: dataset -> inference engine -> metrics (+ case routing).

The counterpart of multimodal_sam_adapter_tpu/engine/evaluator.py. The
histograms, the flat mIoU and the DELIVER condition x case report come from
the port's `engine/metrics.py`, a copy of the JAX package's (held equal to
it by tests/test_torch_shared_copies.py):

- per sample: inference -> argmax -> per-image intersect/union histogram;
- DELIVER: each image goes to nested[condition][case] by its meta, then the
  nested micro/macro aggregation; other datasets: flat mIoU;
- same-shape images are stacked into one batched forward (`batch_size`),
  one image at a time for slide mode and for TTA;
- inputs are padded to a multiple of 32 and the engine cuts the pad band
  off the logits before its final resize.

`shard=(rank, world)` evaluates indices rank::world of the dataset, by
default this process's rank and the process group's size
(parallel/ddp.py); with more than one rank the histogram sums (flat and
on the condition x case grid, float64 on the wire) are summed over the
ranks, the counterpart of the JAX package's `_gather_shards`, so every
rank reports the metrics of the whole dataset. `show` and `format_only`
write images with OpenCV, which the port does not use: they raise.

A dataset yields dicts {'img': (H, W, C) float array, already normalised,
'gt': (H, W) label map or None, 'meta': {'condition', 'case', ...}} and
carries CLASSES (and, for case routing, CONDITIONS and CASES).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.ddp import all_reduce_sum, rank_world
from ..utils.interpolate import resize_bilinear
from .inference import InferenceEngine
from .metrics import (Hist, _sum_hists, format_metrics_table,
                      intersect_and_union, pre_eval_to_metrics,
                      pre_eval_to_metrics_dict, render_nested_report)


def _pad_for_model(img: np.ndarray, multiple: int = 32):
    """Pad H and W up to a multiple (zeros at the bottom and right)."""
    H, W = img.shape[:2]
    ph, pw = (-H) % multiple, (-W) % multiple
    if ph or pw:
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)))
    return img, (H, W)


def _tensor(img: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(img, dtype=np.float32))


class Evaluator:
    def __init__(self, engine: InferenceEngine, dataset, num_classes: int,
                 ignore_index: int = 255, case_aware: bool = False):
        self.engine = engine
        self.dataset = dataset
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.case_aware = case_aware

    def run(self, pipeline: Optional[Callable] = None,
            max_samples: Optional[int] = None, format_only: bool = False,
            show: bool = False, progress_every: int = 50,
            batch_size: int = 1,
            shard: Optional[Tuple[int, int]] = None,
            aug_cfg: Optional[Dict] = None) -> Dict:
        """Evaluate indices rank::world of the first `max_samples` samples
        (`shard`, by default the process group's (rank, world)), the
        histograms summed over the ranks when world > 1 and the process
        group has more than one rank (a shard given without a group is
        that shard's own). The results'
        `payload` holds the histogram sums the metrics come from and, when
        summed over the ranks, `rank_payload` this rank's own.

        pipeline(sample, scale_ratio=1.0) -> sample, the test pipeline;
        aug_cfg {'ratios': [...], 'flip': bool}: multi-scale + flip TTA,
        the softmax averaged over every (ratio x flip) before the argmax
        (a ratio other than 1.0 needs the pipeline, which does the resize).
        """
        if show or format_only:
            raise NotImplementedError(
                "show / format_only write images with OpenCV, which the "
                "port does not use")
        rank, world = shard or rank_world()
        flat: List[Hist] = []
        nested: Dict[str, Dict[str, List[Hist]]] = {}
        n = len(self.dataset) if max_samples is None else min(
            max_samples, len(self.dataset))
        if self.engine.test_cfg.get("mode") in ("slide", "slide_mod_sel"):
            batch_size = 1
        if aug_cfg:
            batch_size = 1
        warned = [False]

        def handle(sample, gt, pred, img=None, valid_hw=None):
            if gt is None:
                return
            if pred.shape != gt.shape:
                # as the reference: resize the class probabilities (not the
                # argmax) to the label grid, and say so once
                if not warned[0]:
                    print(f"WARNING: prediction shape {pred.shape} != GT "
                          f"shape {gt.shape}; re-running inference and "
                          f"bilinearly resizing the class probabilities to "
                          f"the GT grid. Check test_cfg dim against the "
                          f"dataset's label size.", flush=True)
                    warned[0] = True
                if img is not None:
                    probs = self.engine.inference(_tensor(img)[None],
                                                  valid_hw=valid_hw)
                    probs = resize_bilinear(probs.permute(0, 3, 1, 2),
                                            gt.shape[:2])
                    pred = probs.argmax(dim=1)[0].cpu().numpy()
                else:
                    pred = F.interpolate(
                        torch.from_numpy(pred)[None, None].float(),
                        size=gt.shape[:2], mode="nearest")[0, 0]
                    pred = pred.long().numpy()
            hist = intersect_and_union(pred, gt, self.num_classes,
                                       self.ignore_index)
            flat.append(hist)
            if self.case_aware:
                meta = sample.get("meta") or {}
                cond = meta.get("condition") or "all"
                case = meta.get("case") or "ordinary"
                nested.setdefault(cond, {}).setdefault(case, []).append(hist)

        buf: List = []

        def flush():
            if not buf:
                return
            imgs = torch.stack([_tensor(b[2]) for b in buf])
            preds = self.engine.predict(imgs, valid_hw=buf[0][3]).numpy()
            for (sample, gt, img, vhw), pred in zip(buf, preds):
                handle(sample, gt, pred, img=img, valid_hw=vhw)
            buf.clear()

        def aug_predict(raw):
            ratios = list(aug_cfg.get("ratios") or [1.0])
            flips = [False, True] if aug_cfg.get("flip") else [False]
            ori_hw = tuple(raw["img"].shape[:2])
            acc = None
            for r in ratios:
                s = dict(raw)
                s["meta"] = dict(raw.get("meta") or {})
                s["img"] = np.array(raw["img"])
                if pipeline is not None:
                    s = pipeline(s, scale_ratio=r)
                elif r != 1.0:
                    raise ValueError(
                        "multi-scale TTA needs the test pipeline, which "
                        "resizes the input")
                for fl in flips:
                    arr = np.ascontiguousarray(s["img"][:, ::-1]) if fl \
                        else s["img"]
                    img, valid = _pad_for_model(arr)
                    p = self.engine.inference(_tensor(img)[None],
                                              ori_shape=ori_hw, flip=fl,
                                              valid_hw=valid)
                    acc = p if acc is None else acc + p
            acc = acc / (len(ratios) * len(flips))
            return acc.argmax(dim=-1)[0].cpu().numpy()

        done = 0
        total = (n - rank + world - 1) // world
        for i in range(rank, n, world):
            sample = self.dataset[i]
            gt = sample.get("gt")
            if aug_cfg:
                handle(sample, gt, aug_predict(sample))
            else:
                if pipeline is not None:
                    sample = pipeline(sample)
                img, ori_hw = _pad_for_model(sample["img"])
                if buf and (buf[0][2].shape != img.shape
                            or buf[0][3] != ori_hw):
                    flush()
                buf.append((sample, gt, img, ori_hw))
                if len(buf) >= batch_size:
                    flush()
            done += 1
            if progress_every and done % progress_every == 0:
                print(f"eval {done}/{total}", flush=True)
        flush()

        flat_sum, dense = self._densify(flat, nested)
        results: Dict = {"payload": {"flat": flat_sum, "nested": dense}}
        if world > 1 and rank_world()[1] > 1:
            results["rank_payload"] = results["payload"]
            flat_sum, dense = all_reduce_sum(flat_sum), all_reduce_sum(dense)
            results["payload"] = {"flat": flat_sum, "nested": dense}
            flat, nested = self._undensify(flat_sum, dense)
        if flat:
            results["flat"] = pre_eval_to_metrics(flat, ("mIoU",))
            results["summary"] = {
                "mIoU": float(np.nanmean(results["flat"]["IoU"])) * 100,
                "aAcc": float(results["flat"]["aAcc"]) * 100,
                "mAcc": float(np.nanmean(results["flat"]["Acc"])) * 100,
            }
        if self.case_aware and nested:
            results["nested"] = pre_eval_to_metrics_dict(
                nested, ("microIoU",), num_classes=self.num_classes)
            text, eval_results, nested_summary = render_nested_report(
                results["nested"], self.dataset.CLASSES)
            results["nested_report"] = text
            results["eval_results"] = eval_results
            results["summary"].update(nested_summary)
        return results

    def _key_grid(self):
        conds = list(getattr(self.dataset, "CONDITIONS", ()) or ()) + ["all"]
        cases = list(getattr(self.dataset, "CASES", ()) or ()) + ["ordinary"]
        return conds, cases

    def _densify(self, flat: List[Hist],
                 nested: Dict[str, Dict[str, List[Hist]]]):
        """Histogram sums, flat (4, K) and on the dataset's CONDITIONS x
        CASES grid (+ 'all' / 'ordinary'), so shards can be summed."""
        K = self.num_classes
        flat_sum = (np.stack(_sum_hists(flat)) if flat
                    else np.zeros((4, K), np.float64))
        conds, cases = self._key_grid()
        dense = np.zeros((len(conds), len(cases), 4, K), np.float64)
        for ci, c in enumerate(conds):
            for si, s in enumerate(cases):
                hists = nested.get(c, {}).get(s)
                if hists:
                    dense[ci, si] = np.stack(_sum_hists(hists))
        return flat_sum, dense

    def _undensify(self, flat_sum: np.ndarray, dense: np.ndarray):
        """Histogram lists from the dense sums: one entry a non-empty cell
        (the JAX package's `_undensify`)."""
        flat = [tuple(flat_sum)] if flat_sum.sum() > 0 else []
        nested: Dict[str, Dict[str, List[Hist]]] = {}
        conds, cases = self._key_grid()
        for ci, c in enumerate(conds):
            for si, s in enumerate(cases):
                if dense[ci, si].sum() > 0:
                    nested.setdefault(c, {}).setdefault(s, []).append(
                        tuple(dense[ci, si]))
        return flat, nested

    def print_tables(self, results: Dict):
        if "flat" in results:
            print(format_metrics_table(results["flat"], self.dataset.CLASSES))
        if "nested_report" in results:
            print(results["nested_report"])
        if "summary" in results:
            print({k: round(v, 2) for k, v in results["summary"].items()})
