"""Metrics facade — interface parity with
ClipCap's clipcap/eval/metrics.py:31-304.

``evaluate_metrics_from_lists`` / ``evaluate_metrics_from_files`` /
``evaluate_metrics`` (CSV front-end) with the same COCO reformat, the same
5-reference assertion, and the same combined per-file output shape.  Unlike
the reference there is no mandatory temp-file round trip — lists are scored
in memory (``evaluate_metrics_from_files`` still accepts files for parity).
"""
from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Any, Dict, List, Tuple, Union

from clipcap_tpu_torch.eval.coco import COCO
from clipcap_tpu_torch.eval.scorer import COCOEvalCap


def write_json(data, path: Path) -> None:
    with Path(path).open("w") as f:
        json.dump(data, f)


def reformat_to_coco(predictions: List[str], ground_truths: List[List[str]],
                     ids=None) -> Tuple[List[dict], dict]:
    """Reformat to the MSCOCO results format (reference metrics.py:31-89)."""
    if ids is None:
        ids = list(range(len(predictions)))
    pred = []
    ref = {
        "info": {"description": "reference captions"},
        "audio samples": [],
        "licenses": [{"id": 1}, {"id": 2}, {"id": 3}],
        "type": "captions",
        "annotations": [],
    }
    cap_id = 0
    for audio_id, p, gt in zip(ids, predictions, ground_truths):
        p = p[0] if isinstance(p, list) else p
        pred.append({"audio_id": audio_id, "caption": p})
        ref["audio samples"].append({"id": audio_id})
        for cap in gt:
            ref["annotations"].append({"audio_id": audio_id, "id": cap_id, "caption": cap})
            cap_id += 1
    return pred, ref


def evaluate_metrics_from_files(pred_file, ref_file):
    coco = COCO(str(ref_file) if isinstance(ref_file, (str, Path)) else ref_file)
    cocoRes = coco.loadRes(str(pred_file) if isinstance(pred_file, (str, Path)) else pred_file)
    cocoEval = COCOEvalCap(coco, cocoRes)
    cocoEval.params["audio_id"] = cocoRes.getAudioIds()
    cocoEval.evaluate()
    return dict(cocoEval.eval.items()), cocoEval.audioToEval


def evaluate_metrics_from_lists(predictions: List[str],
                                ground_truths: List[List[str]],
                                ids=None):
    """Score prediction/reference lists (reference metrics.py:121-173;
    the 5-reference assertion at :140 is preserved)."""
    assert len(predictions) == len(ground_truths)
    assert all(len(i) == 5 for i in ground_truths)
    if ids is None:
        ids = list(range(len(predictions)))
    pred, ref = reformat_to_coco(predictions, ground_truths, ids)
    return evaluate_metrics_from_files(pred, ref)


def check_and_read_csv(path) -> List[Dict[str, str]]:
    if isinstance(path, list):
        return path
    with Path(path).open("r") as f:
        return [row for row in csv.DictReader(f, dialect="unix")]


def combine_single_and_per_file_metrics(single_metrics, per_file_metrics, file_names):
    total: Dict[str, Dict[str, Any]] = {}
    for metric, score in single_metrics.items():
        total[metric] = {"score": score, "scores": {}}
    for file_idx, metric_dict in per_file_metrics.items():
        file_name = file_names[file_idx]
        for metric in total.keys():
            if metric not in metric_dict:
                continue
            if metric == "SPICE":
                value = metric_dict[metric]["All"]["f"]
            else:
                value = metric_dict[metric]
            total[metric]["scores"][file_name] = value
    return total


def evaluate_metrics(prediction_file, reference_file, nb_reference_captions: int = 5):
    """CSV front-end (reference metrics.py:242-304): rows keyed by
    ``file_name`` with ``caption_predicted`` / ``caption_reference_XX``."""
    prediction_file = check_and_read_csv(prediction_file)
    reference_file = check_and_read_csv(reference_file)

    prediction_file.sort(key=lambda row: row["file_name"])
    reference_file.sort(key=lambda row: row["file_name"])

    reference_dict = {row["file_name"]: row for row in reference_file}
    file_names = [row["file_name"] for row in prediction_file]
    assert all(name in reference_dict for name in file_names)

    predictions, ground_truths = [], []
    for row in prediction_file:
        predictions.append(row["caption_predicted"])
        cap_names = [f"caption_reference_{i:02d}" for i in range(1, nb_reference_captions + 1)]
        ground_truths.append([reference_dict[row["file_name"]][c] for c in cap_names])

    metrics, per_file_metrics = evaluate_metrics_from_lists(predictions, ground_truths)
    total = combine_single_and_per_file_metrics(metrics, per_file_metrics, file_names)
    return {key.lower(): value for key, value in total.items()}
