"""Test-time object relabeling & pair rebuild for sgcls / sgdet, on the host.

The port's own copy of ``vidsgg/models/postprocess.py`` (NumPy): the exact
path :class:`vidsgg_torch.train.eval_pipeline.EvalPipeline` takes when the
fused device stage reports overflow.

Host-side NumPy port of the data-dependent eval-time logic in
lib/tempura.py:257-423 (and its near-duplicate in
tools/utils/object_classifier.py:250-413):

* sgcls (:259-316): argmax labels over the 36-way test distribution offset
  by the reference's extra column drop, per-frame human selection (highest
  person score), one-round duplicate suppression of the modal class, pair
  rebuild (human x non-person boxes).
* sgdet (:319-423): ``clean_class`` duplication for classes {5, 8, 17},
  per-(frame, argmax-class) NMS at IoU 0.6, relabel, human selection, pair
  rebuild.

It sits between the OSPU forward and the union-feature ROIAlign + STTran
forward, and runs once per video at eval only.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from vidsgg_torch.numerics import round_bf16


def _np_iou(boxes_a, boxes_b, bf16: bool = False):
    """Inclusive (+1) IoU. ``bf16``: the boxes hold bfloat16 values, and the
    coordinate differences round to bfloat16, as ``ml_dtypes`` arrays do in
    ``vidsgg``; the ``+ 1`` takes NumPy to float32 there, and the rest runs
    in float32 in both."""
    def sub(x, y):
        return round_bf16(x - y) if bf16 else x - y

    area_a = (sub(boxes_a[:, 2], boxes_a[:, 0]) + 1) * (sub(boxes_a[:, 3], boxes_a[:, 1]) + 1)
    area_b = (sub(boxes_b[:, 2], boxes_b[:, 0]) + 1) * (sub(boxes_b[:, 3], boxes_b[:, 1]) + 1)
    iw = sub(np.minimum(boxes_a[:, None, 2], boxes_b[None, :, 2]),
             np.maximum(boxes_a[:, None, 0], boxes_b[None, :, 0])) + 1
    ih = sub(np.minimum(boxes_a[:, None, 3], boxes_b[None, :, 3]),
             np.maximum(boxes_a[:, None, 1], boxes_b[None, :, 1])) + 1
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def _greedy_nms(boxes, scores, thresh, bf16: bool = False):
    order = np.argsort(-scores, kind="stable")
    iou = _np_iou(boxes[order], boxes[order], bf16)
    keep = []
    suppressed = np.zeros(len(order), bool)
    for i in range(len(order)):
        if suppressed[i]:
            continue
        keep.append(order[i])
        suppressed |= (np.arange(len(order)) > i) & (iou[i] > thresh)
    return np.array(keep, int)


@dataclasses.dataclass
class ObjectsView:
    """Mutable host view of the object axis during postprocessing."""

    boxes: np.ndarray          # [N, 5]
    distribution: np.ndarray   # [N, 36] test-phase class scores (no bg col)
    features: np.ndarray       # [N, 2048]
    mem_features: np.ndarray   # [N, D]
    pred_labels: np.ndarray    # [N]
    pred_scores: np.ndarray    # [N]
    labels: np.ndarray         # [N] GT (kept aligned for metrics)

    def select(self, idx):
        return ObjectsView(
            self.boxes[idx], self.distribution[idx], self.features[idx],
            self.mem_features[idx], self.pred_labels[idx],
            self.pred_scores[idx], self.labels[idx],
        )

    @staticmethod
    def concat(views):
        return ObjectsView(
            *[np.concatenate([getattr(v, f.name) for v in views], 0)
              for f in dataclasses.fields(ObjectsView)]
        )


def _assign_labels_and_human(o: ObjectsView, num_frames: int):
    """distribution[:, 1:] argmax + 2; per-frame human = best person score
    (lib/tempura.py:263-275)."""
    o.pred_scores = o.distribution[:, 1:].max(1)
    o.pred_labels = o.distribution[:, 1:].argmax(1) + 2
    frame = o.boxes[:, 0].astype(int)
    human_idx = np.zeros(num_frames, int)
    for i in range(num_frames):
        sel = np.where(frame == i)[0]
        if len(sel) == 0:
            continue
        h = sel[np.argmax(o.distribution[sel, 0])]
        human_idx[i] = h
        o.pred_labels[h] = 1
        o.pred_scores[h] = o.distribution[h, 0]
    return human_idx


def _dedup_modal_class(o: ObjectsView, num_frames: int):
    """One-round suppression of the per-frame modal predicted class
    (lib/tempura.py:277-290). torch.mode picks the smallest most-common
    value; np.bincount().argmax() matches that tie-break."""
    frame = o.boxes[:, 0].astype(int)
    for i in range(num_frames):
        present = np.where(frame == i)[0]
        if len(present) == 0:
            continue
        labels_i = o.pred_labels[present]
        modal = np.bincount(labels_i).argmax()
        dup = present[labels_i == modal]
        if len(dup) == 0:
            continue
        order = np.argsort(o.distribution[dup, modal - 1], kind="stable")[:-1]
        for j in order:
            ch = dup[j]
            o.distribution[ch, modal - 1] = 0
            o.pred_labels[ch] = o.distribution[ch].argmax() + 1
            o.pred_scores[ch] = o.distribution[ch].max()


def _rebuild_pairs(o: ObjectsView, human_idx: np.ndarray, num_frames: int):
    """human x non-person objects per frame (lib/tempura.py:293-303)."""
    frame = o.boxes[:, 0].astype(int)
    im_idx, pairs = [], []
    for j in range(num_frames):
        h = human_idx[j]
        for m in np.where((frame == j) & (o.pred_labels != 1))[0]:
            im_idx.append(j)
            pairs.append([int(h), int(m)])
    return (
        np.array(im_idx, np.int32),
        np.array(pairs, np.int32).reshape(-1, 2),
    )


def sgcls_postprocess(o: ObjectsView, num_frames: int):
    human_idx = _assign_labels_and_human(o, num_frames)
    _dedup_modal_class(o, num_frames)
    im_idx, pairs = _rebuild_pairs(o, human_idx, num_frames)
    return o, human_idx, im_idx, pairs


def _clean_class(o: ObjectsView, num_frames: int, class_idx: int) -> ObjectsView:
    """Duplicate boxes predicted as ``class_idx`` with their runner-up label
    (lib/tempura.py:114-158). Grows the object axis."""
    frame = o.boxes[:, 0].astype(int)
    out = []
    for i in range(num_frames):
        present = np.where(frame == i)[0]
        out.append(o.select(present))
        hit = present[o.pred_labels[present] == class_idx]
        dup = o.select(hit)
        dup.distribution = dup.distribution.copy()
        dup.distribution[:, class_idx - 1] = 0
        if len(hit) > 0:
            dup.pred_labels = dup.distribution.argmax(1) + 1
            dup.pred_scores = dup.distribution.max(1)
        out.append(dup)
    return ObjectsView.concat(out)


def sgdet_postprocess(o: ObjectsView, num_frames: int, nms_thresh: float = 0.6,
                      bf16: bool = False):
    """``o.pred_labels`` must arrive prefilled with the *detector's* labels:
    clean_class keys off them before OSPU relabeling (lib/tempura.py:331-333).
    ``bf16``: the boxes and scores hold bfloat16 values (see ``_np_iou``)."""
    for cls in (5, 8, 17):
        o = _clean_class(o, num_frames, cls)

    frame = o.boxes[:, 0].astype(int)
    num_obj_classes = o.distribution.shape[1]
    keep_parts = []
    for i in range(num_frames):
        present = np.where(frame == i)[0]
        if len(present) == 0:
            continue
        scores = o.distribution[present]
        argmax_cls = scores.argmax(1)
        for j in range(num_obj_classes):
            inds = present[argmax_cls == j]
            if len(inds) == 0:
                continue
            cls_scores = o.distribution[inds, j]
            keep = _greedy_nms(o.boxes[inds, 1:], cls_scores, nms_thresh, bf16)
            keep_parts.append(inds[keep])
    kept = np.concatenate(keep_parts) if keep_parts else np.zeros(0, int)
    # reference concatenation order is frame-major then class-major; re-sort
    # by (frame, class) to match its final_boxes stacking (:340-375)
    order = np.lexsort(
        (o.distribution[kept].argmax(1), o.boxes[kept, 0].astype(int))
    )
    o = o.select(kept[order])

    human_idx = _assign_labels_and_human(o, num_frames)
    im_idx, pairs = _rebuild_pairs(o, human_idx, num_frames)
    return o, human_idx, im_idx, pairs
