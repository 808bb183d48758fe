"""Entry featurization (counterpart of ``vidsgg/detector/featurize.py``).

Per-pair union boxes (min of top-lefts, max of bottom-rights), ROIAlign of
the unions over the base feature maps to [P, 7, 7, 1024], and the 2x27x27
pair spatial masks centred by -0.5; for a GT-box entry (predcls, sgcls)
also the object features: the boxes scaled to network resolution, pooled
7x7 at 1/16 and passed through the R-CNN head. Masked rows are zero.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.profiler import record_function

from vidsgg_torch import constants as C
from vidsgg_torch.data.entry import Entry
from vidsgg_torch.ops.roi_align import roi_align, roi_align_fused
from vidsgg_torch.ops.union_masks import draw_union_masks


def _union_boxes(entry: Entry):
    pair = entry.pair_idx.long()
    b = entry.boxes[:, 1:]
    sub = b[pair[:, 0]]
    obj = b[pair[:, 1]]
    union = torch.cat([torch.minimum(sub[:, 0:2], obj[:, 0:2]),
                       torch.maximum(sub[:, 2:4], obj[:, 2:4])], dim=1)
    # float32 frame column beside the scaled unions: the concatenation
    # promotes (float32 for bfloat16 boxes, float64 for float64 ones)
    union_boxes = torch.cat(
        [entry.im_idx[:, None].to(torch.float32), union * entry.im_scale], dim=1)
    return sub, obj, union_boxes


def _spatial_masks(sub, obj, pm):
    masks = draw_union_masks(torch.cat([sub, obj], dim=1), C.SPATIAL_MASK_SIZE) - 0.5
    return masks * pm[:, None, None, None]


def pair_union_features(entry: Entry, fmaps: torch.Tensor):
    """(union_feat [P,7,7,Cf], union_boxes [P,5], spatial_masks [P,2,S,S]).

    ``entry.boxes`` are in original-image scale; the union ROIAlign uses
    network scale (boxes * im_scale), the masks original scale.
    """
    sub, obj, union_boxes = _union_boxes(entry)
    pm = entry.pair_mask
    union_feat = roi_align(fmaps, union_boxes, out_size=C.ROI_ALIGN_OUT,
                           spatial_scale=C.ROI_ALIGN_SCALE)
    union_feat = union_feat * pm[:, None, None, None]
    return union_feat, union_boxes, _spatial_masks(sub, obj, pm)


def pair_union_features_grouped(entry: Entry, fmaps: torch.Tensor,
                                pairs_per_frame: int):
    """:func:`pair_union_features` through per-frame grouped pooling.

    Pairs scatter into a [F, pairs_per_frame] grid by frame, pool through
    the per-frame ROIAlign product, and gather back to flat pair order.
    Returns (union_feat, union_boxes, spatial_masks, overflow): ``overflow``
    is True when some frame holds more than ``pairs_per_frame`` valid pairs,
    and the caller then takes the exact general path.
    """
    sub, obj, union_boxes = _union_boxes(entry)
    pm = entry.pair_mask
    p = pm.shape[0]
    f = fmaps.shape[0]
    dev = pm.device
    im = entry.im_idx.long()
    idx = torch.arange(p, device=dev)
    # rank of each pair among valid same-frame pairs
    slot = ((im[None, :] == im[:, None]) & (idx[None, :] < idx[:, None])
            & pm[None, :]).sum(1)
    overflow = (pm & (slot >= pairs_per_frame)).any()
    slot = torch.clamp(slot, max=pairs_per_frame - 1)
    frame_ext = torch.where(pm, im, torch.full_like(im, f))  # invalid -> dump row

    grid = torch.zeros((f + 1, pairs_per_frame, 4), dtype=union_boxes.dtype, device=dev)
    grid[frame_ext, slot] = union_boxes[:, 1:] * pm[:, None]
    pooled = roi_align_fused(fmaps, grid[:f], out_size=C.ROI_ALIGN_OUT,
                             spatial_scale=C.ROI_ALIGN_SCALE)  # [F, P_f, 7, 7, Cf]
    union_feat = pooled[torch.clamp(frame_ext, max=f - 1), slot]
    union_feat = union_feat * pm[:, None, None, None]
    return union_feat, union_boxes, _spatial_masks(sub, obj, pm), overflow


def featurize_pair_entry(entry: Entry, fmaps: torch.Tensor) -> Entry:
    """Fill union_feat / spatial_masks of an entry whose boxes, pairs and
    per-object features are already set."""
    union_feat, _, spatial_masks = pair_union_features(entry, fmaps)
    return dataclasses.replace(entry, union_feat=union_feat, spatial_masks=spatial_masks)


def featurize_gt_entry(entry: Entry, fmaps: torch.Tensor,
                       head_fn: Callable[[torch.Tensor], torch.Tensor]) -> Entry:
    """Fill features / union_feat / spatial_masks of a GT-box entry.

    Args:
      entry: skeleton from :func:`vidsgg_torch.data.build_gt_entry`, boxes in
        original-image scale, ``im_scale`` set by the caller.
      fmaps: [F, H, W, 1024] base feature maps (NHWC) at network resolution.
      head_fn: maps [N, 7, 7, 1024] pooled features -> [N, 2048] (the
        detector's ``head_to_tail``).
    """
    scaled = torch.cat([entry.boxes[:, :1], entry.boxes[:, 1:] * entry.im_scale], dim=1)
    pooled = roi_align(fmaps, scaled, out_size=C.ROI_ALIGN_OUT,
                       spatial_scale=C.ROI_ALIGN_SCALE)
    feats = head_fn(pooled) * entry.obj_mask[:, None]
    union_feat, _, spatial_masks = pair_union_features(entry, fmaps)
    return dataclasses.replace(entry, features=feats, union_feat=union_feat,
                               spatial_masks=spatial_masks)


class GtFrontend:
    """Frames + GT-box entry skeleton -> featurized Entry and base feature
    maps: ResNet base, GT ROIAlign 7x7 at 1/16 and the R-CNN head. The
    detector is frozen: no gradient, and ``no_grad`` rather than
    ``inference_mode``, so that a train step can save the entry for
    backward."""

    def __init__(self, model):
        self.model = model

    @torch.no_grad()
    def __call__(self, frames, entry):
        """frames [F, H, W, 3] (network scale) -> (Entry, fmaps [F, h, w, 1024])."""
        with record_function("vidsgg.backbone"):
            fmaps = self.model.base_features(frames).permute(0, 2, 3, 1)
        with record_function("vidsgg.featurize_gt"):
            entry = featurize_gt_entry(entry, fmaps, self.model.head_to_tail)
        return entry, fmaps
