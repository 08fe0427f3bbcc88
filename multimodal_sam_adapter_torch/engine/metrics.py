"""Segmentation metrics: intersect/union accumulation, flat and nested
(condition x case) aggregation.

Re-design of reference mmseg_custom/apis/evaluation/metrics_micro.py:
- `intersect_and_union`: per-image 4-tuple (intersect, union, pred_area,
  label_area) histograms (reference :26-87, torch.histc -> np.bincount)
- `total_area_to_metrics`: IoU / Dice / Fscore / per-class Acc / aAcc
  (reference :451-526)
- `pre_eval_to_metrics`: flat aggregation (reference :294-369)
- `pre_eval_to_metrics_dict`: nested condition x case aggregation producing
  per-cell metrics, per-condition micro-IoU (sum inter / sum union),
  per-case micro-IoU, and 'global' aggregates (reference :370-448)

All numpy float64; the device produces only the per-image histograms
(evaluator.py). The port's own copy of
multimodal_sam_adapter_tpu/engine/metrics.py, held equal to it by
tests/test_torch_shared_copies.py.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Hist = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def intersect_and_union(
    pred: np.ndarray,
    label: np.ndarray,
    num_classes: int,
    ignore_index: int = 255,
    label_map: Optional[dict] = None,
    reduce_zero_label: bool = False,
) -> Hist:
    """Per-image (intersect, union, pred_area, label_area), each
    (num_classes,) float64."""
    pred = np.asarray(pred).reshape(-1)
    label = np.asarray(label).reshape(-1).copy()
    if label_map:
        for old, new in label_map.items():
            label[label == old] = new
    if reduce_zero_label:
        label[label == 0] = 255
        label = label - 1
        label[label == 254] = 255
    mask = label != ignore_index
    pred = pred[mask]
    label = label[mask]
    inter = pred[pred == label]
    area_inter = np.bincount(inter, minlength=num_classes)[:num_classes]
    area_pred = np.bincount(pred, minlength=num_classes)[:num_classes]
    area_label = np.bincount(label, minlength=num_classes)[:num_classes]
    area_union = area_pred + area_label - area_inter
    return (
        area_inter.astype(np.float64),
        area_union.astype(np.float64),
        area_pred.astype(np.float64),
        area_label.astype(np.float64),
    )


def total_area_to_metrics(
    total_inter, total_union, total_pred, total_label,
    metrics: Sequence[str] = ("mIoU",),
    nan_to_num: Optional[float] = None,
    beta: float = 1.0,
) -> Dict[str, np.ndarray]:
    """aAcc + per-class metric arrays for the requested metric families."""
    allowed = {"mIoU", "mDice", "mFscore", "microIoU"}
    metrics = [metrics] if isinstance(metrics, str) else list(metrics)
    if not set(metrics) <= allowed:
        raise KeyError(f"metrics {metrics} not in {allowed}")
    with np.errstate(divide="ignore", invalid="ignore"):
        ret: "OrderedDict[str, np.ndarray]" = OrderedDict(
            {"aAcc": np.nansum(total_inter) / np.nansum(total_label)}
        )
        for metric in metrics:
            if metric in ("mIoU", "microIoU"):
                ret["IoU"] = total_inter / total_union
                ret["Acc"] = total_inter / total_label
            elif metric == "mDice":
                ret["Dice"] = 2 * total_inter / (total_pred + total_label)
                ret["Acc"] = total_inter / total_label
            elif metric == "mFscore":
                precision = total_inter / total_pred
                recall = total_inter / total_label
                f = (1 + beta**2) * (precision * recall) / (
                    beta**2 * precision + recall
                )
                ret["Fscore"] = f
                ret["Precision"] = precision
                ret["Recall"] = recall
    if nan_to_num is not None:
        ret = OrderedDict(
            {k: np.nan_to_num(v, nan=nan_to_num) for k, v in ret.items()}
        )
    return ret


def _sum_hists(hists: List[Hist]) -> Hist:
    cols = tuple(zip(*hists))
    return tuple(np.sum(np.stack(c), axis=0) for c in cols)  # type: ignore


def pre_eval_to_metrics(
    pre_eval_results: List[Hist],
    metrics: Sequence[str] = ("mIoU",),
    nan_to_num: Optional[float] = None,
    beta: float = 1.0,
) -> Dict[str, np.ndarray]:
    """Flat aggregation over all images."""
    ti, tu, tp, tl = _sum_hists(list(pre_eval_results))
    return total_area_to_metrics(ti, tu, tp, tl, metrics, nan_to_num, beta)


def pre_eval_to_metrics_dict(
    nested: Dict[str, Dict[str, List[Hist]]],
    metrics: Sequence[str] = ("microIoU",),
    nan_to_num: Optional[float] = None,
    num_classes: int = 25,
    beta: float = 1.0,
) -> Dict:
    """Nested condition x case aggregation.

    nested[condition][case] is a list of per-image 4-tuples. Produces:
    - ret[condition][case]: per-cell metric dict
    - ret[condition]['micro_IoU']: sum(inter)/sum(union) over the condition
    - ret['global']: metrics over everything, plus per-condition and
      per-case micro-IoU scalars
    """
    ret: Dict = {}
    cum = [np.zeros(num_classes, np.float64) for _ in range(4)]
    case_micro: Dict[str, Dict[str, np.ndarray]] = {}
    for cond, cases in nested.items():
        ret[cond] = {}
        cond_inter = np.zeros(num_classes, np.float64)
        cond_union = np.zeros(num_classes, np.float64)
        for case, hists in cases.items():
            if not hists:
                continue
            ti, tu, tp, tl = _sum_hists(hists)
            for c, t in zip(cum, (ti, tu, tp, tl)):
                c += t
            cond_inter += ti
            cond_union += tu
            ret[cond][case] = total_area_to_metrics(
                ti, tu, tp, tl, metrics, nan_to_num, beta
            )
            m = case_micro.setdefault(
                case,
                {"inter": np.zeros(num_classes, np.float64),
                 "union": np.zeros(num_classes, np.float64)},
            )
            m["inter"] += ti
            m["union"] += tu
        if cond_union.sum() > 0:
            with np.errstate(divide="ignore", invalid="ignore"):
                ret[cond]["micro_IoU"] = cond_inter / cond_union
    ret["global"] = total_area_to_metrics(*cum, metrics, nan_to_num, beta)
    for cond in nested:
        if "micro_IoU" in ret.get(cond, {}):
            ret["global"][cond] = {"micro_IoU": ret[cond]["micro_IoU"]}
    for case, m in case_micro.items():
        if m["union"].sum() > 0:
            with np.errstate(divide="ignore", invalid="ignore"):
                ret["global"][case] = m["inter"] / m["union"]
    return ret


def summarize(ret_metrics: Dict[str, np.ndarray],
              class_names: Sequence[str]) -> Dict[str, float]:
    """Flat metric dict -> summary scalars (mIoU/aAcc/mAcc, percent)."""
    out = {}
    for k, v in ret_metrics.items():
        if np.ndim(v) == 0:
            out[k] = float(v) * 100
        else:
            out["m" + k] = float(np.nanmean(v)) * 100
    return out


def format_metrics_table(ret_metrics: Dict[str, np.ndarray],
                         class_names: Sequence[str]) -> str:
    """Per-class table (the reference prints PrettyTables; plain text here)."""
    keys = [k for k in ret_metrics if np.ndim(ret_metrics[k]) > 0]
    header = ["Class"] + keys
    widths = [max(len(c) for c in list(class_names) + ["Class"]) + 2] + [
        10 for _ in keys
    ]
    lines = ["".join(h.ljust(w) for h, w in zip(header, widths))]
    for i, name in enumerate(class_names):
        row = [name] + [
            f"{ret_metrics[k][i] * 100:.2f}" if np.isfinite(ret_metrics[k][i])
            else "nan"
            for k in keys
        ]
        lines.append("".join(c.ljust(w) for c, w in zip(row, widths)))
    means = ["mean"] + [f"{np.nanmean(ret_metrics[k]) * 100:.2f}" for k in keys]
    lines.append("".join(c.ljust(w) for c, w in zip(means, widths)))
    if "aAcc" in ret_metrics:
        lines.append(f"aAcc: {float(ret_metrics['aAcc']) * 100:.2f}")
    return "\n".join(lines)


def _ascii_table(columns: "OrderedDict[str, Sequence]") -> str:
    """Plain-text column table (the reference prints PrettyTables,
    reference DELIVER.py:345-359; prettytable isn't available here)."""
    keys = list(columns)
    rows = max((len(v) if np.ndim(v) > 0 else 1) for v in columns.values())
    cells = {}
    for k, v in columns.items():
        vals = v if np.ndim(v) > 0 else [v]
        cells[k] = [
            (f"{x:.2f}" if isinstance(x, (int, float, np.floating)) else str(x))
            for x in vals
        ] + [""] * (rows - len(vals))
    widths = {k: max(len(k), *(len(c) for c in cells[k])) for k in keys}
    sep = "+" + "+".join("-" * (widths[k] + 2) for k in keys) + "+"
    out = [sep, "|" + "|".join(f" {k.ljust(widths[k])} " for k in keys) + "|",
           sep]
    for r in range(rows):
        out.append("|" + "|".join(
            f" {cells[k][r].ljust(widths[k])} " for k in keys) + "|")
    out.append(sep)
    return "\n".join(out)


def render_nested_report(ret: Dict, class_names: Sequence[str]):
    """Render the nested condition x case report and build the eval-results
    dict, mirroring reference DELIVER.py:261-617 (microIoU path):

    - one per-class table + summary line per (condition, case) cell
    - one table per condition's micro_IoU array (sum inter / sum union)
    - a global table plus the two scalars the reference dumps:
      mMicroIoU (mean over the per-condition micro means) and
      mMicroIoU_per_condition (mean over the global per-case micro arrays —
      the reference's name for it, DELIVER.py:434-441)

    Returns (text, eval_results, summary_scalars). eval_results values are
    fractions in [0, 1] exactly as the reference stores them (value/100).
    """
    lines: List[str] = []
    eval_results: Dict = {}
    mMiou_l: List[float] = []
    names = list(class_names)

    def cell_tables(tag: str, cell: Dict[str, np.ndarray]):
        summary = OrderedDict(
            (k, float(np.round(np.nanmean(v) * 100, 2)))
            for k, v in cell.items()
        )
        arrays = OrderedDict(
            (k, np.round(np.asarray(v, np.float64) * 100, 2))
            for k, v in cell.items() if np.ndim(v) > 0
        )
        tbl = OrderedDict([("Class", names)])
        tbl.update(arrays)
        lines.append(f"\n per class {tag} results:")
        lines.append(_ascii_table(tbl))
        lines.append(f"Summary  {tag}:")
        lines.append(_ascii_table(OrderedDict(
            (k if k == "aAcc" else "m" + k, [v]) for k, v in summary.items()
        )))
        er = {}
        for k, v in summary.items():
            er["aAcc" if k == "aAcc" else "m" + k] = v / 100.0
        for k, arr in arrays.items():
            er.update({f"{k}.{n}": float(arr[i]) / 100.0
                       for i, n in enumerate(names)})
        return er

    for cond, cases in ret.items():
        if cond == "global":
            continue
        eval_results[cond] = {}
        for case, cell in cases.items():
            if isinstance(cell, dict):
                eval_results[cond][case] = cell_tables(f"{cond}_{case}", cell)
            else:  # per-condition micro_IoU array
                arr = np.round(np.asarray(cell, np.float64) * 100, 2)
                m = float(np.round(np.nanmean(arr), 2))
                mMiou_l.append(m)
                lines.append(f"\n per class {cond}_micro_IoU results:")
                lines.append(_ascii_table(OrderedDict(
                    [("Class", names), ("micro_IoU", arr)])))
                lines.append(f"Summary  {cond}_micro_IoU:")
                lines.append(_ascii_table(OrderedDict(mmicroIoU=[m])))
                er = {"mmicroIoU": m / 100.0}
                er.update({f"micro_IoU.{n}": float(arr[i]) / 100.0
                           for i, n in enumerate(names)})
                eval_results[cond]["micro_IoU"] = er

    g = ret.get("global", {})
    g_metrics = {k: v for k, v in g.items()
                 if not isinstance(v, dict) and k in ("IoU", "Acc", "aAcc")}
    case_arrays = {k: v for k, v in g.items()
                   if not isinstance(v, dict) and k not in g_metrics}
    eval_results["global"] = cell_tables("global", g_metrics)
    summary = {
        ("aAcc" if k == "aAcc" else "m" + k):
            float(np.round(np.nanmean(v) * 100, 2))
        for k, v in g_metrics.items()
    }
    if mMiou_l:
        summary["mMicroIoU"] = float(np.round(np.nanmean(mMiou_l), 2))
    if case_arrays:
        summary["mMicroIoU_per_condition"] = float(np.round(np.nanmean(
            [np.nanmean(np.asarray(v, np.float64)) for v in case_arrays.values()]
        ) * 100, 2))
        for k, v in case_arrays.items():
            arr = np.round(np.asarray(v, np.float64) * 100, 2)
            lines.append(f"\n per class global_{k} (micro) results:")
            lines.append(_ascii_table(OrderedDict(
                [("Class", names), ("micro_IoU", arr)])))
            eval_results["global"][k] = {
                f"micro_IoU.{n}": float(arr[i]) / 100.0
                for i, n in enumerate(names)
            }
    if "mMicroIoU" in summary or "mMicroIoU_per_condition" in summary:
        lines.append("Summary  global:")
        lines.append(_ascii_table(OrderedDict(
            (k, [v]) for k, v in summary.items()
        )))
    eval_results["global"].update({k: v / 100.0 for k, v in summary.items()
                                   if k.startswith("mMicroIoU")})
    return "\n".join(lines), eval_results, summary
