"""Padded device outputs -> the NumPy evaluator's pred dict (counterpart of
``vidsgg/eval/adapter.py``): trim padding, hand over plain arrays keyed
like the reference entry."""

from __future__ import annotations

import numpy as np
import torch

from vidsgg_torch.data.entry import Entry


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def to_eval_pred(entry: Entry, out: dict, mode: str) -> dict:
    obj_mask, pair_mask = _np(entry.obj_mask), _np(entry.pair_mask)
    n = int(obj_mask.sum())
    p = int(pair_mask.sum())
    scores = _np(entry.scores)
    sp_gt = _np(entry.spatial_gt)[:p]
    con_gt = _np(entry.contacting_gt)[:p]
    pred = {
        "boxes": _np(entry.boxes)[:n],
        "labels": _np(entry.labels)[:n],
        "scores": scores[:n],
        "im_idx": _np(entry.im_idx)[:p],
        "pair_idx": _np(entry.pair_idx)[:p],
        "attention_distribution": _np(out["attention_distribution"])[:p],
        "spatial_distribution": _np(out["spatial_distribution"])[:p],
        "contacting_distribution": _np(out["contacting_distribution"])[:p],
        "attention_gt": [[int(x)] for x in _np(entry.attention_gt)[:p]],
        "spatial_gt": [np.where(row > 0)[0].tolist() for row in sp_gt],
        "contacting_gt": [np.where(row > 0)[0].tolist() for row in con_gt],
    }
    if mode == "predcls":
        pred["pred_labels"] = pred["labels"]
        pred["pred_scores"] = pred["scores"]
    else:
        pred["pred_labels"] = _np(entry.pred_labels)[:n]
        pred["pred_scores"] = scores[:n]
    return pred
