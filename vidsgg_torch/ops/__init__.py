from vidsgg_torch.ops.boxes import (
    bbox_overlaps,
    bbox_transform_inv,
    box_union,
    center_size,
    clip_boxes,
)
from vidsgg_torch.ops.laplacian import masked_laplacian_eig
from vidsgg_torch.ops.nms import batched_class_nms, nms_mask, nms_mask_batched
from vidsgg_torch.ops.roi_align import roi_align, roi_align_fused
from vidsgg_torch.ops.union_masks import draw_union_masks

__all__ = [
    "bbox_overlaps", "bbox_transform_inv", "box_union", "center_size",
    "clip_boxes", "masked_laplacian_eig", "batched_class_nms", "nms_mask", "nms_mask_batched",
    "roi_align", "roi_align_fused", "draw_union_masks",
]
