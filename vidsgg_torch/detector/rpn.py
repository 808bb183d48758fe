"""Region Proposal Network + proposal layer (counterpart of ``vidsgg/detector/rpn.py``).

A 3x3/512 conv trunk with 2A-way objectness and 4A-way box-delta heads over
stride-16 anchors, then the proposal layer: decode, clip, exact top-K
pre-NMS, NMS@0.7 through the hand-written kernel (presorted, stopping at
``post_nms_top_n`` keeps), the first ``post_nms_top_n`` keeps. The keep-set
becomes a fixed-size buffer with a validity mask; invalid slots are zero.

Top-k ties break by lower index, as ``jax.lax.top_k`` does: every top-k here
is a stable descending sort, sliced.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from vidsgg_torch.ops.boxes import bbox_transform_inv, clip_boxes
from vidsgg_torch.ops.nms import nms_mask_batched


@dataclasses.dataclass(frozen=True)
class RPNConfig:
    anchor_scales: tuple = (4, 8, 16, 32)
    anchor_ratios: tuple = (0.5, 1.0, 2.0)
    feat_stride: int = 16
    pre_nms_top_n: int = 6000
    # 100 proposals per frame: the reference's frozen detector serves 100
    # rois/frame (rois [10, 100, 5] at tools/utils/object_detector.py:85-94)
    post_nms_top_n: int = 100
    nms_thresh: float = 0.7


def generate_anchors(cfg: RPNConfig, fh: int, fw: int) -> np.ndarray:
    """[fh*fw*A, 4] anchors in image coordinates, (h, w, anchor) order
    (jwyang generate_anchors lineage: base 16 box, ratio then scale)."""
    base = 16.0
    anchors = []
    for r in cfg.anchor_ratios:
        size = base * base
        ws = np.round(np.sqrt(size / r))
        hs = np.round(ws * r)
        for s in cfg.anchor_scales:
            w, h = ws * s, hs * s
            cx = cy = (base - 1) / 2.0
            anchors.append(
                [cx - 0.5 * (w - 1), cy - 0.5 * (h - 1),
                 cx + 0.5 * (w - 1), cy + 0.5 * (h - 1)]
            )
    anchors = np.array(anchors)
    sx = np.arange(fw) * cfg.feat_stride
    sy = np.arange(fh) * cfg.feat_stride
    sx, sy = np.meshgrid(sx, sy)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    all_anchors = (anchors[None, :, :] + shifts[:, None, :]).reshape(-1, 4)
    return all_anchors.astype(np.float32)


class RPN(nn.Module):
    """[B, 1024, fh, fw] -> (objectness [B, K], deltas [B, K, 4]) over
    K = fh*fw*A anchors in (h, w, anchor) order. Names follow jwyang's
    ``RCNN_rpn``."""

    def __init__(self, num_anchors: int, in_channels: int = 1024):
        super().__init__()
        self.num_anchors = num_anchors
        self.RPN_Conv = nn.Conv2d(in_channels, 512, 3, padding=1)
        self.RPN_cls_score = nn.Conv2d(512, 2 * num_anchors, 1)
        self.RPN_bbox_pred = nn.Conv2d(512, 4 * num_anchors, 1)

    def forward(self, feat):
        a = self.num_anchors
        h = torch.relu(self.RPN_Conv(feat.to(self.RPN_Conv.weight.dtype)))
        # channels-last, so the flattening below is vidsgg's NHWC one:
        # score channels are (bg, fg) x anchor, deltas anchor x 4
        score = self.RPN_cls_score(h).permute(0, 2, 3, 1)
        bbox = self.RPN_bbox_pred(h).permute(0, 2, 3, 1)
        b, fh, fw, _ = score.shape
        score = score.reshape(b, fh * fw, 2, a)
        fg = torch.softmax(score, dim=2)[:, :, 1, :].reshape(b, fh * fw * a)
        return fg, bbox.reshape(b, fh * fw * a, 4)


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: ties go to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def decode_topk(fg_scores, deltas, anchors, im_hw, cfg: RPNConfig):
    """Decode and clip every anchor, then take the exact top
    ``pre_nms_top_n`` by objectness: -> (boxes [B, k, 4], scores [B, k]),
    score-descending (the NMS kernel's presorted input)."""
    b = fg_scores.shape[0]
    im_hw = torch.as_tensor(im_hw, device=fg_scores.device)
    im_hw_b = torch.broadcast_to(im_hw, (b, 2))
    boxes = bbox_transform_inv(anchors, deltas)            # [B, K, 4]
    boxes = clip_boxes(boxes, im_hw_b)
    k = min(cfg.pre_nms_top_n, fg_scores.shape[1])
    top_scores, idx = top_k(fg_scores, k)
    top_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    return top_boxes, top_scores


def proposal_layer(fg_scores, deltas, anchors, im_hw, cfg: RPNConfig):
    """fg [B, K], deltas [B, K, 4], anchors [K, 4], im_hw [2] or [B, 2] ->
    (rois [B, N, 4], roi_scores [B, N], roi_mask [B, N])."""
    top_boxes, top_scores = decode_topk(fg_scores, deltas, anchors, im_hw, cfg)
    valid = torch.ones(top_scores.shape, dtype=torch.bool, device=top_scores.device)
    # greedy NMS is prefix-stable, so the scan may stop at post_nms_top_n
    # keeps: the selection below takes exactly that many
    keep = nms_mask_batched(top_boxes, top_scores, valid, cfg.nms_thresh,
                            max_keep=cfg.post_nms_top_n, presorted=True)
    k = top_boxes.shape[1]
    col = torch.arange(k, device=keep.device)
    rank = torch.where(keep, col, torch.full_like(col, k))
    # first post_nms_top_n keeps in score order, then unkept slots by index
    order = torch.sort(rank, dim=-1, stable=True).indices[:, :cfg.post_nms_top_n]
    mask = torch.gather(keep, 1, order)
    boxes = torch.gather(top_boxes, 1, order[..., None].expand(-1, -1, 4))
    scores = torch.gather(top_scores, 1, order)
    return boxes * mask[..., None], scores * mask, mask
