"""On-device sgcls / sgdet test-time postprocess (counterpart of
``vidsgg/models/postprocess_device.py``).

* sgcls: label assignment, per-frame human selection, one-round
  modal-class duplicate suppression, pair rebuild;
* sgdet: ``clean_class`` duplication for classes {5, 8, 17} on a
  statically expanded object axis, per-(frame, argmax-class) greedy NMS at
  IoU 0.6, the reference's (frame, class)-lexsorted re-ordering, label
  assignment + human selection, pair rebuild.

Masked ops on padded buffers; no host sync.

Exactness notes (as in ``vidsgg``): the modal class is the smallest of the
most frequent labels (``torch.mode``'s tie-break: ``argmax`` takes the
first maximum); among equally scored modal duplicates the *last* index is
kept (an argmax over the flipped row); a scatter that ``vidsgg`` drops at
index ``n`` goes to an ``n + 1`` buffer that is sliced, since an
out-of-range index is a device assert on CUDA. clean_class growth is
bounded by the ``expand`` factor and an overflow flag reports truncation;
the post-NMS lexsort is stable over the NMS-keep order, i.e.
score-descending within each (frame, class) group, reproduced by keying on
the global score rank. Every ``argsort(stable=True)`` is a stable
``torch.sort``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from vidsgg_torch.data.entry import Entry
from vidsgg_torch.ops.nms import grouped_nms

_NEG = -1e9
_BIG = 2 ** 31 - 1
EXPAND = 2                   # object-axis growth bound for clean_class
NMS_THRESH = 0.6             # per-(frame, class) NMS (lib/tempura.py:369)
CLEAN_CLASSES = (5, 8, 17)   # classes clean_class duplicates


def _stable_argsort(keys):
    return torch.sort(keys, stable=True).indices


def _rows(mask, like):
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


def _clean_round(fields: dict, valid, frame, cls: int):
    """One clean_class round: duplicate boxes whose current pred_label == cls
    with the class column zeroed and the runner-up label, appended per frame
    after that frame's current rows."""
    m = valid.shape[0]
    dev = valid.device
    dist = fields["distribution"]
    dup_src = valid & (fields["pred_labels"] == cls)
    dup_dist = dist.clone()
    dup_dist[:, cls - 1] = 0.0
    dup_fields = dict(fields)
    dup_fields["distribution"] = dup_dist
    dup_fields["pred_labels"] = (dup_dist.argmax(1) + 1).to(fields["pred_labels"].dtype)
    dup_fields["scores"] = dup_dist.max(1).values

    slot = torch.arange(m, device=dev)
    big = torch.full_like(slot, _BIG)
    frame = frame.long()
    key_orig = torch.where(valid, frame * (2 * m) + slot, big)
    key_dup = torch.where(dup_src, frame * (2 * m) + m + slot, big)
    keys = torch.cat([key_orig, key_dup])
    order = _stable_argsort(keys)[:m]
    src = order % m
    from_dup = order >= m
    new_valid = keys[order] < _BIG
    overflow = dup_src.sum() + valid.sum() > m

    out = {}
    for k, v in fields.items():
        picked = torch.where(_rows(from_dup, v), dup_fields[k][src], v[src])
        if v.dtype == torch.bool:
            out[k] = picked & new_valid
        else:
            out[k] = picked * _rows(new_valid, picked).to(picked.dtype)
    return out, new_valid, frame[src] * new_valid, overflow


def _labels_and_human(dist, frame, valid, frame_mask):
    """distribution[:, 1:] argmax + 2; per-frame human = best person score."""
    f_cap = frame_mask.shape[0]
    n = dist.shape[0]
    dev = dist.device
    zero = torch.zeros((), dtype=dist.dtype, device=dev)
    pred_scores = torch.where(valid, dist[:, 1:].max(1).values, zero)
    pred_labels = torch.where(valid, dist[:, 1:].argmax(1) + 2, 0)
    in_frame = (frame[None, :] == torch.arange(f_cap, device=dev)[:, None]) & valid[None, :]
    person_scores = torch.where(in_frame, dist[None, :, 0],
                                torch.full((), _NEG, dtype=dist.dtype, device=dev))
    human_idx = person_scores.argmax(1)
    frame_has_box = in_frame.any(1) & frame_mask
    is_human = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    is_human[torch.where(frame_has_box, human_idx, n)] = True
    is_human = is_human[:n]
    pred_labels = torch.where(is_human, 1, pred_labels)
    pred_scores = torch.where(is_human, dist[:, 0], pred_scores)
    return pred_labels, pred_scores, human_idx, in_frame, frame_has_box


def _rebuild_pairs_device(frame, valid, labels, human_idx, frame_has_box,
                          f_cap, p_cap):
    """human x non-person boxes per frame, frame-major."""
    is_obj = valid & (labels != 1) & frame_has_box[torch.clamp(frame, 0, f_cap - 1)]
    order = _stable_argsort(torch.where(is_obj, frame, f_cap + 1))
    slot_valid = is_obj[order]
    pair_frame = frame[order]
    pair_human = human_idx[torch.clamp(pair_frame, 0, f_cap - 1)]
    im_idx = torch.where(slot_valid, pair_frame, 0)[:p_cap]
    pair_idx = torch.stack(
        [torch.where(slot_valid, pair_human, 0), torch.where(slot_valid, order, 0)],
        dim=1,
    )[:p_cap]
    return im_idx.to(torch.int32), pair_idx.to(torch.int32), slot_valid[:p_cap]


def sgcls_postprocess_device(entry: Entry, distribution: torch.Tensor) -> Entry:
    """entry + OSPU test distribution [N, C-1] -> relabeled entry with
    rebuilt pairs (same object axis; pair axis capacity reused)."""
    n, ncm1 = distribution.shape
    f_cap = entry.frame_mask.shape[0]
    p_cap = entry.pair_mask.shape[0]
    dev = distribution.device
    valid = entry.obj_mask
    frame = entry.boxes[:, 0].long()
    frame_c = torch.clamp(frame, 0, f_cap - 1)

    dist = distribution * valid[:, None]
    pred_labels, pred_scores, human_idx, in_frame, frame_has_box = _labels_and_human(
        dist, frame, valid, entry.frame_mask)

    # one round of modal-class duplicate suppression per frame
    onehot = torch.nn.functional.one_hot(pred_labels, ncm1 + 2) * valid[:, None]
    counts = in_frame.to(torch.float32) @ onehot.to(torch.float32)   # [F, labels]
    modal = counts.argmax(1)           # first maximum = the smallest tied label
    modal_of_box = modal[frame_c]
    is_dup = valid & (pred_labels == modal_of_box) & frame_has_box[frame_c]
    modal_col = torch.clamp(modal_of_box - 1, 0, ncm1 - 1)
    dup_score = torch.gather(dist, 1, modal_col[:, None])[:, 0]
    neg = torch.full((), _NEG, dtype=dist.dtype, device=dev)
    dup_scores_fr = torch.where(in_frame & is_dup[None, :], dup_score[None, :], neg)
    keep_idx = n - 1 - dup_scores_fr.flip(1).argmax(1)   # last index among ties
    has_dup = frame_has_box & (dup_scores_fr.max(1).values > _NEG / 2)
    keep_mask = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    keep_mask[torch.where(has_dup, keep_idx, n)] = True
    demote = is_dup & ~keep_mask[:n]
    col = torch.arange(ncm1, device=dev)
    dist2 = torch.where(demote[:, None] & (col[None, :] == modal_col[:, None]),
                        torch.zeros((), dtype=dist.dtype, device=dev), dist)
    new_labels = torch.where(demote, dist2.argmax(1) + 1, pred_labels)
    new_scores = torch.where(demote, dist2.max(1).values, pred_scores)

    im_idx, pair_idx, pair_mask = _rebuild_pairs_device(
        frame, valid, new_labels, human_idx, frame_has_box, f_cap, p_cap)
    return dataclasses.replace(
        entry,
        distribution=dist2,
        pred_labels=new_labels.to(torch.int32),
        scores=new_scores,
        im_idx=im_idx,
        pair_idx=pair_idx,
        pair_mask=pair_mask,
        human_idx=human_idx.to(torch.int32),
    )


def clean_class_objects(entry: Entry, distribution: torch.Tensor,
                        mem_features: torch.Tensor):
    """entry (detector labels in ``pred_labels``) + OSPU test distribution ->
    (fields, valid, frame, overflow): the object fields on the ``EXPAND * N``
    axis after the clean_class rounds, their validity, frame and the
    overflow flag."""
    n = distribution.shape[0]
    m = EXPAND * n

    def grow(a):
        out = a.new_zeros((m,) + a.shape[1:])
        out[:n] = a
        return out

    fields = {
        "boxes": grow(entry.boxes),
        "distribution": grow(distribution * entry.obj_mask[:, None]),
        "features": grow(entry.features),
        "mem_features": grow(mem_features),
        # clean_class keys off the detector's labels before OSPU relabeling
        "pred_labels": grow(entry.pred_labels.to(torch.int32)),
        "scores": grow(entry.scores),
        "labels": grow(entry.labels.to(torch.int32)),
    }
    valid = grow(entry.obj_mask)
    frame = fields["boxes"][:, 0].long()

    overflow = torch.zeros((), dtype=torch.bool, device=distribution.device)
    for cls in CLEAN_CLASSES:
        fields, valid, frame, ovf = _clean_round(fields, valid, frame, cls)
        overflow = overflow | ovf
    return fields, valid, frame, overflow


def nms_problem(fields: dict, frame: torch.Tensor):
    """The per-(frame, argmax class) NMS over the cleaned objects ->
    (boxes4 [M, 4], scores [M], group [M]): :func:`grouped_nms`'s inputs
    beside ``valid``."""
    dist = fields["distribution"]
    group = frame * dist.shape[1] + dist.argmax(1)
    return fields["boxes"][:, 1:], dist.max(1).values, group


def sgdet_postprocess_device(entry: Entry, distribution: torch.Tensor,
                             mem_features: torch.Tensor):
    """entry (detector labels in ``pred_labels``) + OSPU test distribution ->
    (relabeled entry on an ``EXPAND * N`` object axis, gathered mem
    features, overflow flag). Pair capacity = expanded object capacity."""
    m = EXPAND * distribution.shape[0]
    f_cap = entry.frame_mask.shape[0]
    dev = distribution.device
    fields, valid, frame, overflow = clean_class_objects(entry, distribution, mem_features)
    boxes4, scores, group = nms_problem(fields, frame)
    with record_function("vidsgg.grouped_nms"):
        keep, rank = grouped_nms(boxes4, scores, group, valid, NMS_THRESH)

    key = torch.where(keep, group * m + rank, torch.full_like(group, _BIG))
    order = _stable_argsort(key)
    new_valid = key[order] < _BIG
    for k in fields:
        v = fields[k][order]
        fields[k] = v & new_valid if v.dtype == torch.bool else v * _rows(new_valid, v).to(v.dtype)
    valid = new_valid
    frame = fields["boxes"][:, 0].long() * valid

    dist = fields["distribution"]
    pred_labels, pred_scores, human_idx, _, frame_has_box = _labels_and_human(
        dist, frame, valid, entry.frame_mask)
    im_idx, pair_idx, pair_mask = _rebuild_pairs_device(
        frame, valid, pred_labels, human_idx, frame_has_box, f_cap, m)

    union_hw = entry.union_feat.shape[1]
    union_ch = entry.union_feat.shape[-1]
    mask_s = entry.spatial_masks.shape[-1]
    f32 = torch.float32
    entry2 = dataclasses.replace(
        entry,
        boxes=fields["boxes"],
        labels=fields["labels"],
        scores=pred_scores,
        distribution=dist,
        pred_labels=pred_labels.to(torch.int32),
        features=fields["features"],
        obj_mask=valid,
        im_idx=im_idx,
        pair_idx=pair_idx,
        pair_mask=pair_mask,
        union_feat=torch.zeros((m, union_hw, union_hw, union_ch), dtype=f32, device=dev),
        spatial_masks=torch.zeros((m, 2, mask_s, mask_s), dtype=f32, device=dev),
        attention_gt=torch.zeros((m,), dtype=torch.int32, device=dev),
        spatial_gt=torch.zeros((m, entry.spatial_gt.shape[1]), dtype=f32, device=dev),
        contacting_gt=torch.zeros((m, entry.contacting_gt.shape[1]), dtype=f32, device=dev),
        human_idx=human_idx.to(torch.int32),
    )
    return entry2, fields["mem_features"], overflow
