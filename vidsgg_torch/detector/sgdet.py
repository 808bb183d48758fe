"""SGDet test frontend: frozen Faster R-CNN -> padded detections -> Entry.

Counterpart of the test side of ``vidsgg/detector/sgdet.py``: class-specific
box decode (stds [0.1, 0.1, 0.2, 0.2]), score threshold 0.1, NMS@0.4 over
the (frame, class) grid through the hand-written kernel, person kept top-1
only, the top-D detections per frame, then the on-device pack into an
``Entry``. The train side waits for a later slice.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from vidsgg_torch.data.entry import Entry, EntryCapacity
from vidsgg_torch.detector.faster_rcnn import FasterRCNN
from vidsgg_torch.detector.rpn import top_k
from vidsgg_torch.device import resolve_device
from vidsgg_torch.ops.boxes import bbox_transform_inv, clip_boxes
from vidsgg_torch.ops.nms import batched_class_nms

BBOX_STDS = (0.1, 0.1, 0.2, 0.2)
SCORE_THRESH = 0.1
NMS_THRESH = 0.4


@dataclasses.dataclass(frozen=True)
class SgdetCaps:
    dets_per_frame: int = 16


def class_grid(model: FasterRCNN, out: dict, im_hw, im_scale):
    """Detector output -> the per-(frame, class) NMS problem:
    (cls_boxes [F, C-1, N, 4] original scale, cls_scores [F, C-1, N],
    valid [F, C-1, N])."""
    rois = out["rois"][..., 1:]                               # [F, N, 4]
    nc = model.num_classes
    stds = torch.tensor(BBOX_STDS, dtype=out["bbox_pred"].dtype,
                        device=rois.device).repeat(nc)
    pred = bbox_transform_inv(rois, out["bbox_pred"] * stds)
    im_scale = torch.as_tensor(im_scale, dtype=pred.dtype, device=rois.device)
    scale = im_scale.reshape(im_scale.shape + (1,) * (pred.dim() - im_scale.dim()))
    pred = clip_boxes(pred, im_hw) / scale                    # original scale
    f, n, _ = rois.shape
    cls_boxes = pred.reshape(f, n, nc, 4)[:, :, 1:, :].permute(0, 2, 1, 3)
    cls_scores = out["cls_prob"][:, :, 1:].permute(0, 2, 1)   # [F, C-1, N]
    valid = (cls_scores > SCORE_THRESH) & out["roi_mask"][:, None, :]
    return cls_boxes, cls_scores, valid


def make_detect_fn(model: FasterRCNN, caps: SgdetCaps):
    """Returns detect(frames [F,H,W,3], im_hw, im_scale) -> per-frame padded
    detections dict (boxes, labels, scores, features, mask, dists,
    base_feat)."""

    def detect(frames, im_hw, im_scale):
        out = model(frames, im_hw)
        cls_boxes, cls_scores, valid = class_grid(model, out, im_hw, im_scale)
        with record_function("vidsgg.class_nms"):
            keep = batched_class_nms(cls_boxes, cls_scores, valid, NMS_THRESH)
        f, _, n = cls_scores.shape
        fi = torch.arange(f, device=keep.device)

        # person class (index 0): keep only the top-scoring survivor
        person_scores = torch.where(keep[:, 0], cls_scores[:, 0],
                                    torch.full_like(cls_scores[:, 0], -1.0))
        top_person = torch.argmax(person_scores, dim=1)
        person_keep = torch.zeros_like(keep[:, 0])
        person_keep[fi, top_person] = keep[:, 0].any(dim=1)
        keep = keep.clone()
        keep[:, 0] = person_keep

        # top-D detections per frame by score
        flat_scores = torch.where(keep, cls_scores,
                                  torch.full_like(cls_scores, -1.0)).reshape(f, -1)
        top_scores, flat_idx = top_k(flat_scores, caps.dets_per_frame)
        det_mask = top_scores > 0
        cls_idx = flat_idx // n
        roi_idx = flat_idx % n
        det_boxes = cls_boxes[fi[:, None], cls_idx, roi_idx].clamp(min=0.0)
        det_labels = (cls_idx + 1) * det_mask
        det_feats = out["roi_features"][fi[:, None], roi_idx] * det_mask[..., None]
        logits = model.class_scores(det_feats.reshape(-1, det_feats.shape[-1]))
        logits = logits.reshape(f, -1, model.num_classes)
        dist = torch.softmax(logits[..., 1:], dim=-1) * det_mask[..., None]
        return {
            "boxes": det_boxes * det_mask[..., None],
            "labels": det_labels,
            "scores": top_scores * det_mask,
            "features": det_feats,
            "mask": det_mask,
            "dists": dist,
            "base_feat": out["base_feat"],
        }

    return detect


def _pack_test_dets(dets, cap: EntryCapacity, im_scale, video_size, num_frames):
    """Padded per-frame detections -> test Entry (one video): valid rows
    first, frame-major slot order kept (a stable sort of the validity)."""
    f, d = dets["mask"].shape
    dev = dets["mask"].device
    frame_valid = torch.arange(f, device=dev) < num_frames
    mask_flat = (dets["mask"] & frame_valid[:, None]).reshape(-1)
    order = torch.sort(torch.where(mask_flat, 0, 1), stable=True).indices
    # true detection count, uncapped (the caller checks n <= max_objs)
    n = mask_flat.sum()
    valid = torch.arange(cap.max_objs, device=dev) < torch.clamp(n, max=cap.max_objs)
    take = min(cap.max_objs, f * d)

    def fit(a):
        a = a[order[:take]]
        pad = a.new_zeros((cap.max_objs - a.shape[0],) + a.shape[1:])
        return torch.cat([a, pad], dim=0)

    frame_of = (torch.arange(f * d, device=dev) // d).to(dets["boxes"].dtype)
    boxes5 = fit(torch.cat([frame_of[:, None], dets["boxes"].reshape(f * d, 4)], dim=1))
    boxes5 = boxes5 * valid[:, None]
    feats = fit(dets["features"].reshape(f * d, -1)) * valid[:, None]
    dists = fit(dets["dists"].reshape(f * d, -1)) * valid[:, None]
    pred_labels = ((dists.argmax(1) + 1) * valid).to(torch.int32)
    pred_scores = dists.max(1).values * valid

    e = dataclasses.replace(
        Entry.zeros(cap, device=dev),
        boxes=boxes5,
        labels=pred_labels,
        scores=pred_scores,
        distribution=dists,
        pred_labels=pred_labels,
        features=feats,
        obj_mask=valid,
        frame_mask=torch.arange(cap.max_frames, device=dev) < num_frames,
        im_scale=torch.as_tensor(im_scale, dtype=torch.float32, device=dev),
        num_frames=torch.as_tensor(num_frames, dtype=torch.int32, device=dev),
        video_size=torch.as_tensor(video_size, dtype=torch.float32, device=dev),
    )
    return e, n


def make_test_entry_fn(model: FasterRCNN, caps: SgdetCaps, entry_cap: EntryCapacity):
    """(frames, im_hw, im_scale, video_size, num_frames) -> (Entry,
    base_feat, n_objs): the whole sgdet test frontend on the device."""
    detect = make_detect_fn(model, caps)

    def test_entry(frames, im_hw, im_scale, video_size, num_frames):
        dets = detect(frames, im_hw, im_scale)
        with record_function("vidsgg.pack_entry"):
            e, n = _pack_test_dets(dets, entry_cap, im_scale, video_size, num_frames)
        return e, dets["base_feat"], n

    return test_entry


class SgdetFrontend:
    """Video frames -> relation-stage Entry (test side)."""

    def __init__(self, model: FasterRCNN, caps: SgdetCaps,
                 entry_cap: EntryCapacity, device=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"detector lives on {model.device}, frontend on {self.device}")
        self.model = model
        self.caps = caps
        self.entry_cap = entry_cap
        self.test_entry_device = make_test_entry_fn(model, caps, entry_cap)

    @torch.inference_mode()
    def __call__(self, frames, im_hw, im_scale, video_size=(600.0, 400.0),
                 num_frames=None):
        """frames [F, H, W, 3] (BGR mean-subtracted, network scale) ->
        (Entry, base_feat [F, h, w, 1024]). ``num_frames``: true frame count
        when ``frames`` is padded to a frame-count bucket."""
        frames = torch.as_tensor(frames, device=self.device)
        if num_frames is None:
            num_frames = frames.shape[0]
        im_hw = torch.as_tensor(im_hw, device=self.device)
        entry, base_feat, n = self.test_entry_device(
            frames, im_hw, im_scale, video_size, num_frames)
        # compact regime (capacity < frames * dets): one scalar fetch checks
        # that the video fits, as vidsgg does
        full = self.entry_cap.max_objs >= frames.shape[0] * self.caps.dets_per_frame
        if not full and int(n) > self.entry_cap.max_objs:
            raise ValueError(
                f"sgdet detections ({int(n)}) exceed entry capacity "
                f"{self.entry_cap.max_objs}"
            )
        return entry, base_feat
