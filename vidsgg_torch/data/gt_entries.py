"""GT-box entry construction (predcls / sgcls front half).

Counterpart of ``vidsgg/data/gt_entries.py``: iterate frames in order,
person box first then objects, record (human, object) pairs and the three
GT predicate sets per pair, in NumPy on the host; the padded
:class:`~vidsgg_torch.data.entry.Entry` is then moved to the device with
zeroed feature fields, which :func:`vidsgg_torch.detector.featurize_gt_entry`
fills. Boxes stay in original-image scale; the caller sets ``im_scale``.

The box and pair order is the reference's: the evaluator's per-frame
selection and the temporal-consistency metric both index the flat pair
list by position.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vidsgg_torch import constants as C
from vidsgg_torch.data.entry import Entry, EntryCapacity
from vidsgg_torch.device import resolve_device


def video_counts(gt_annotation) -> tuple[int, int, int]:
    """(num_frames, num_boxes, num_pairs) of one video annotation."""
    f = len(gt_annotation)
    n = sum(len(frame) for frame in gt_annotation)
    p = sum(len(frame) - 1 for frame in gt_annotation)
    return f, n, p


def build_gt_entry(gt_annotation, cap: EntryCapacity,
                   num_classes: int = C.NUM_OBJ_CLASSES, device=None) -> Entry:
    """The padded GT entry skeleton of one video, on ``device``.

    Args:
      gt_annotation: list (frames) of lists; frame[0] has 'person_bbox'
        ([1,4] or [4]); following dicts have 'bbox' [4] (xyxy), 'class', and
        'attention/spatial/contacting_relationship' index lists.
      cap: static capacities; must cover the video.
    """
    dev = resolve_device(device)
    f, n, p = video_counts(gt_annotation)
    if f > cap.max_frames or n > cap.max_objs or p > cap.max_pairs:
        raise ValueError(
            f"video ({f} frames, {n} boxes, {p} pairs) exceeds capacity {cap}")

    boxes = np.zeros((cap.max_objs, 5), np.float32)
    labels = np.zeros((cap.max_objs,), np.int32)
    scores = np.zeros((cap.max_objs,), np.float32)
    obj_mask = np.zeros((cap.max_objs,), bool)
    human_idx = np.zeros((cap.max_frames,), np.int32)
    frame_mask = np.zeros((cap.max_frames,), bool)

    im_idx = np.zeros((cap.max_pairs,), np.int32)
    pair_idx = np.zeros((cap.max_pairs, 2), np.int32)
    pair_mask = np.zeros((cap.max_pairs,), bool)
    attention_gt = np.zeros((cap.max_pairs,), np.int32)
    spatial_gt = np.zeros((cap.max_pairs, C.NUM_SPATIAL), np.float32)
    contacting_gt = np.zeros((cap.max_pairs, C.NUM_CONTACTING), np.float32)

    bbox_i = 0
    pair_i = 0
    for i, frame in enumerate(gt_annotation):
        frame_mask[i] = True
        for m in frame:
            if "person_bbox" in m:
                boxes[bbox_i, 1:] = np.asarray(m["person_bbox"], np.float32).reshape(-1)[:4]
                boxes[bbox_i, 0] = i
                labels[bbox_i] = 1
                scores[bbox_i] = 1.0
                human_idx[i] = bbox_i
                obj_mask[bbox_i] = True
                bbox_i += 1
            else:
                boxes[bbox_i, 1:] = np.asarray(m["bbox"], np.float32).reshape(-1)[:4]
                boxes[bbox_i, 0] = i
                labels[bbox_i] = int(m["class"])
                scores[bbox_i] = 1.0
                obj_mask[bbox_i] = True
                im_idx[pair_i] = i
                pair_idx[pair_i] = (human_idx[i], bbox_i)
                pair_mask[pair_i] = True
                att = np.asarray(m["attention_relationship"]).reshape(-1)
                attention_gt[pair_i] = int(att[0])
                for s in np.asarray(m["spatial_relationship"]).reshape(-1):
                    spatial_gt[pair_i, int(s)] = 1.0
                for c in np.asarray(m["contacting_relationship"]).reshape(-1):
                    contacting_gt[pair_i, int(c)] = 1.0
                pair_i += 1
                bbox_i += 1

    def t(a):
        return torch.from_numpy(a).to(dev)

    base = Entry.zeros(cap, num_classes=num_classes, device=dev)
    return dataclasses.replace(
        base,
        boxes=t(boxes),
        labels=t(labels),
        scores=t(scores),
        pred_labels=t(labels.copy()),  # predcls default; sgcls/sgdet overwrite
        obj_mask=t(obj_mask),
        im_idx=t(im_idx),
        pair_idx=t(pair_idx),
        pair_mask=t(pair_mask),
        attention_gt=t(attention_gt),
        spatial_gt=t(spatial_gt),
        contacting_gt=t(contacting_gt),
        human_idx=t(human_idx),
        frame_mask=t(frame_mask),
        num_frames=torch.tensor(f, dtype=torch.int32, device=dev),
    )
