"""Temporal-consistency metric (test time).

The port's own copy of ``vidsgg/eval/temporal.py``, numerics verbatim.

NumPy port of tools/utils/temporal_consistency.py: for each object class,
find intervals where the first GT label stays constant for >= ``window``
consecutive pairs (over the whole video pair list), then score
KL(softmax(pred) || log_softmax(one-hot GT)) per interval, torch
``KLDivLoss(reduction='batchmean')`` convention. Not defined for sgdet
(temporal_consistency.py:29). Reported x100, spatial and contacting averaged
(print_temp_cons_score, :75-83).
"""

from __future__ import annotations

import numpy as np


def _log_softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    return x - np.log(np.exp(x).sum(axis=axis, keepdims=True))


def _softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def find_consecutive_duplicates(target_bool, gt_seq, window=6):
    """Intervals [start, end) where target_bool holds and the GT label repeats
    for >= window steps. Faithful port of temporal_consistency.py:8-25,
    including its quirks (prev_state updates on every reset; the trailing
    interval is emitted only if the final step continued a run)."""
    intervals = []
    cnt = 0
    prev = -1
    i = -1
    b = gt = None
    for i, (b, gt) in enumerate(zip(target_bool, gt_seq)):
        if b and gt == prev:
            cnt += 1
        else:
            if cnt >= window:
                intervals.append([i - cnt, i])
            cnt = 0
            prev = gt
    # trailing run: the reference appends [id-cnt, id] with id = the LAST loop
    # index, i.e. the final element of the run is excluded (:22-23 quirk)
    if b is not None and b and gt == prev and cnt >= window:
        intervals.append([i - cnt, i])
    return intervals


def _kl_batchmean(log_p: np.ndarray, q: np.ndarray) -> float:
    """torch.nn.KLDivLoss(reduction='batchmean')(input=log_p, target=q)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        term = np.where(q > 0, q * (np.log(q) - log_p), 0.0)
    return float(term.sum() / log_p.shape[0])


def evaluate_temporal_consistency(pred, mode, window=6):
    """Per-video temporal-consistency KL scores.

    Args:
      pred: dict with 'spatial_gt' / 'contacting_gt' (list of per-pair label
        lists), 'spatial_distribution' [P,6], 'contacting_distribution'
        [P,17], 'pred_labels' [N], 'pair_idx' [P,2].
      mode: 'predcls' | 'sgcls' | 'sgdet' (sgdet -> (None, None), as ref).

    Returns (spatial_scores, contacting_scores) as 1-D float arrays.
    """
    if mode == "sgdet":
        return None, None

    spatial_gt = np.array([int(np.asarray(i).reshape(-1)[0]) for i in pred["spatial_gt"]])
    contact_gt = np.array([int(np.asarray(i).reshape(-1)[0]) for i in pred["contacting_gt"]])
    spatial_pred = np.asarray(pred["spatial_distribution"])
    contact_pred = np.asarray(pred["contacting_distribution"])

    pred_labels = np.asarray(pred["pred_labels"])
    pair_idx = np.asarray(pred["pair_idx"])
    # the reference indexes pred_labels over *boxes* and filters !=1 (person);
    # in pair order this is exactly the object of each pair
    obj_cls = pred_labels[pred_labels != 1]
    # Guard the load-bearing layout assumption: the i-th non-person box must
    # be the object of the i-th pair (person-first frame-major box order —
    # what the reference's direct box indexing relies on,
    # temporal_consistency.py:33-38). A permuted box list would silently
    # mis-align the GT sequences. Unequal lengths are NOT an error: an
    # object box classified as person shortens obj_cls, and the reference
    # then zip-truncates — reproduced by find_consecutive_duplicates.
    obj_from_pairs = pred_labels[pair_idx[:, 1]]
    if obj_cls.shape == obj_from_pairs.shape and not np.array_equal(
            obj_cls, obj_from_pairs):
        raise ValueError(
            "pred box order violates the person-first frame-major layout "
            "the temporal-consistency metric assumes (i-th non-person box "
            "!= object of i-th pair); fix the entry builder rather than "
            "scoring silently mis-aligned sequences")

    s_scores, c_scores = [], []
    for cls in np.unique(obj_cls):
        target = obj_cls == cls
        for s, e in find_consecutive_duplicates(target, spatial_gt, window):
            gt_1h = np.eye(6)[spatial_gt[s:e]]
            log_p = _log_softmax(gt_1h.astype(np.float64), axis=1)
            q = _softmax(spatial_pred[s:e].astype(np.float64), axis=1)
            s_scores.append(_kl_batchmean(log_p, q))
        for s, e in find_consecutive_duplicates(target, contact_gt, window):
            gt_1h = np.eye(17)[contact_gt[s:e]]
            log_p = _log_softmax(gt_1h.astype(np.float64), axis=1)
            q = _softmax(contact_pred[s:e].astype(np.float64), axis=1)
            c_scores.append(_kl_batchmean(log_p, q))
    return np.array(s_scores), np.array(c_scores)


def temporal_consistency_summary(spatial_scores, contact_scores):
    """x100 means + combined score (print_temp_cons_score semantics)."""
    s = float(np.mean(spatial_scores) * 100) if len(spatial_scores) else float("nan")
    c = float(np.mean(contact_scores) * 100) if len(contact_scores) else float("nan")
    return {
        "spatial": s,
        "contacting": c,
        "combined": (s + c) / 2,
        "num_spatial_intervals": int(len(spatial_scores)),
        "num_contacting_intervals": int(len(contact_scores)),
    }
