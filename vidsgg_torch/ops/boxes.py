"""Box utilities (xyxy convention, inclusive-pixel "+1" areas).

Counterpart of ``vidsgg/ops/boxes.py``; every function keeps its operation
order so float32 results round the same way.
"""

from __future__ import annotations

import torch


def bbox_overlaps(boxes: torch.Tensor, query_boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU between ``boxes`` [N,4] and ``query_boxes`` [K,4]."""
    boxes = boxes.float()
    query_boxes = query_boxes.float()
    area_q = (query_boxes[:, 2] - query_boxes[:, 0] + 1.0) * (
        query_boxes[:, 3] - query_boxes[:, 1] + 1.0
    )
    area_b = (boxes[:, 2] - boxes[:, 0] + 1.0) * (boxes[:, 3] - boxes[:, 1] + 1.0)
    iw = (
        torch.minimum(boxes[:, None, 2], query_boxes[None, :, 2])
        - torch.maximum(boxes[:, None, 0], query_boxes[None, :, 0])
        + 1.0
    )
    ih = (
        torch.minimum(boxes[:, None, 3], query_boxes[None, :, 3])
        - torch.maximum(boxes[:, None, 1], query_boxes[None, :, 1])
        + 1.0
    )
    inter = iw.clamp(min=0.0) * ih.clamp(min=0.0)
    union = area_b[:, None] + area_q[None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def center_size(boxes: torch.Tensor) -> torch.Tensor:
    """xyxy -> (cx, cy, w, h) with inclusive widths (w = x2-x1+1)."""
    wh = boxes[..., 2:4] - boxes[..., 0:2] + 1.0
    ctr = boxes[..., 0:2] + 0.5 * (wh - 1.0)
    return torch.cat([ctr, wh], dim=-1)


def box_union(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Elementwise union of two aligned box sets [..., 4] (xyxy)."""
    lo = torch.minimum(boxes_a[..., 0:2], boxes_b[..., 0:2])
    hi = torch.maximum(boxes_a[..., 2:4], boxes_b[..., 2:4])
    return torch.cat([lo, hi], dim=-1)


def bbox_transform_inv(boxes: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Decode class-specific deltas [..., N, 4*C] onto boxes [..., N, 4]."""
    widths = boxes[..., 2] - boxes[..., 0] + 1.0
    heights = boxes[..., 3] - boxes[..., 1] + 1.0
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights

    d = deltas.reshape(deltas.shape[:-1] + (deltas.shape[-1] // 4, 4))
    dx, dy, dw, dh = d[..., 0], d[..., 1], d[..., 2], d[..., 3]

    pred_ctr_x = dx * widths[..., None] + ctr_x[..., None]
    pred_ctr_y = dy * heights[..., None] + ctr_y[..., None]
    pred_w = torch.exp(dw) * widths[..., None]
    pred_h = torch.exp(dh) * heights[..., None]

    out = torch.stack(
        [
            pred_ctr_x - 0.5 * pred_w,
            pred_ctr_y - 0.5 * pred_h,
            pred_ctr_x + 0.5 * pred_w,
            pred_ctr_y + 0.5 * pred_h,
        ],
        dim=-1,
    )
    return out.reshape(deltas.shape)


def clip_boxes(boxes: torch.Tensor, im_hw: torch.Tensor) -> torch.Tensor:
    """Clip xyxy(-packed) boxes [..., 4*C] to image bounds: ``im_hw`` is [2]
    or [..., 2] aligned with the leading axes of ``boxes``."""
    im_hw = torch.as_tensor(im_hw, dtype=boxes.dtype, device=boxes.device)
    h, w = im_hw[..., 0], im_hw[..., 1]
    b = boxes.reshape(boxes.shape[:-1] + (boxes.shape[-1] // 4, 4))
    extra = b[..., 0].ndim - h.ndim
    h = h.reshape(h.shape + (1,) * extra)
    w = w.reshape(w.shape + (1,) * extra)
    x1 = torch.clamp(b[..., 0], torch.zeros_like(w), w - 1.0)
    y1 = torch.clamp(b[..., 1], torch.zeros_like(h), h - 1.0)
    x2 = torch.clamp(b[..., 2], torch.zeros_like(w), w - 1.0)
    y2 = torch.clamp(b[..., 3], torch.zeros_like(h), h - 1.0)
    return torch.stack([x1, y1, x2, y2], dim=-1).reshape(boxes.shape)
