"""Padded device outputs -> the NumPy evaluator's pred dict (counterpart of
``vidsgg/eval/adapter.py``): trim padding, hand over plain arrays keyed
like the reference entry.

A bfloat16 tensor (bfloat16 serving) comes over as a float32 array that
holds its values exactly, and its key is listed under ``"bf16_fields"``:
``vidsgg`` hands the evaluator ``ml_dtypes.bfloat16`` arrays there, whose
arithmetic the evaluator then reproduces (NumPy has no bfloat16 of its
own, and the card's machine no ``ml_dtypes``). Without bfloat16 tensors
the dict has no such key."""

from __future__ import annotations

import numpy as np
import torch

from vidsgg_torch.data.entry import Entry


BF16_FIELDS = "bf16_fields"


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


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
    sources = {"boxes": entry.boxes, "scores": entry.scores, "pred_scores": entry.scores,
               **{k: out[k] for k in ("attention_distribution", "spatial_distribution",
                                      "contacting_distribution")}}
    bf16 = tuple(k for k, t in sources.items() if t.dtype == torch.bfloat16)
    if bf16:
        pred[BF16_FIELDS] = bf16
    return pred
