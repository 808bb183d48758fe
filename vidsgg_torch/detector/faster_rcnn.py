"""Faster R-CNN (frozen, inference-only): the sgdet front-end network.

Counterpart of ``vidsgg/detector/faster_rcnn.py``. Parameter names are the
jwyang checkpoint's (``RCNN_base.*``, ``RCNN_top.0``, ``RCNN_rpn.*``,
``RCNN_cls_score``, ``RCNN_bbox_pred``). Frames come in as ``[B, H, W, 3]``
and ``base_feat`` goes out as ``[B, h, w, 1024]`` (a view of the NCHW
tensor the convolutions produce).

``dtype`` is the compute dtype of the base and the head, as
``vidsgg``'s ``FasterRCNN(dtype=...)``: with ``torch.bfloat16`` their
convolutions run in bfloat16 on float32 weights (``resnet.py``) and the
box ROIAlign takes it as its ``compute_dtype``; the RPN, ``RCNN_cls_score``
and ``RCNN_bbox_pred`` stay in the parameters' dtype, and the parameters
and ``state_dict()`` stay float32. ``dtype=None`` computes everything in
the parameters' dtype (``model.double()`` runs the detector in float64).
The base and head outputs are float32 either way, as in ``vidsgg``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.profiler import record_function

from vidsgg_torch import constants as C
from vidsgg_torch.detector.resnet import ResNet101Base, ResNetHead, set_compute_dtype
from vidsgg_torch.detector.rpn import RPN, RPNConfig, generate_anchors, proposal_layer
from vidsgg_torch.device import resolve_device
from vidsgg_torch.init import init_weights_
from vidsgg_torch.ops.roi_align import roi_align_fused


class FasterRCNN(nn.Module):
    def __init__(self, num_classes: int = C.NUM_OBJ_CLASSES,
                 rpn_cfg: RPNConfig = RPNConfig(),
                 base_blocks: tuple = (3, 4, 23), head_blocks: int = 3,
                 device=None, generator: torch.Generator | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        self.rpn_cfg = rpn_cfg
        na = len(rpn_cfg.anchor_scales) * len(rpn_cfg.anchor_ratios)
        self.RCNN_base = ResNet101Base(base_blocks)
        self.RCNN_top = ResNetHead(head_blocks)
        self.RCNN_rpn = RPN(na)
        self.RCNN_cls_score = nn.Linear(2048, num_classes)
        self.RCNN_bbox_pred = nn.Linear(2048, 4 * num_classes)
        init_weights_(self, generator)
        self.set_compute_dtype(dtype)
        self.to(dev)
        self.eval()

    def set_compute_dtype(self, dtype: torch.dtype | None):
        """The compute dtype of the base and the head (None: the
        parameters'); the weights are left as they are."""
        self.compute_dtype = dtype
        set_compute_dtype(self, dtype)

    @property
    def device(self) -> torch.device:
        return self.RCNN_cls_score.weight.device

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype of the base and the head."""
        return self.compute_dtype or self.RCNN_cls_score.weight.dtype

    def base_features(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> [B, 1024, H/16, W/16] (RCNN_base), NCHW."""
        return self.RCNN_base(images.permute(0, 3, 1, 2))

    def head_to_tail(self, pooled: torch.Tensor) -> torch.Tensor:
        """[N, 7, 7, 1024] -> [N, 2048] (_head_to_tail)."""
        return self.RCNN_top(pooled.permute(0, 3, 1, 2))

    def class_scores(self, feats: torch.Tensor) -> torch.Tensor:
        """[N, 2048] -> [N, C] raw logits (RCNN_cls_score)."""
        return self.RCNN_cls_score(feats.to(self.RCNN_cls_score.weight.dtype))

    def forward(self, images: torch.Tensor, im_hw) -> dict:
        """images [B, H, W, 3] preprocessed frames; im_hw [2] network-scale
        (H, W) for clipping. Returns rois [B, N, 5], roi_mask [B, N],
        cls_prob [B, N, C], bbox_pred [B, N, 4C], base_feat [B, h, w, 1024],
        roi_features [B, N, 2048]."""
        with record_function("vidsgg.backbone"):
            base = self.base_features(images)
        b, _, fh, fw = base.shape
        anchors = torch.from_numpy(generate_anchors(self.rpn_cfg, fh, fw)).to(base.device)
        with record_function("vidsgg.rpn_head"):
            fg, deltas = self.RCNN_rpn(base)
        with record_function("vidsgg.proposal_layer"):
            rois, _, roi_mask = proposal_layer(fg, deltas, anchors, im_hw, self.rpn_cfg)

        n = rois.shape[1]
        batch_idx = torch.arange(b, device=rois.device, dtype=rois.dtype)[:, None]
        rois5 = torch.cat([batch_idx.expand(b, n)[..., None], rois], dim=-1)
        base_nhwc = base.permute(0, 2, 3, 1)
        with record_function("vidsgg.roi_align"):
            pooled = roi_align_fused(
                base_nhwc, rois, out_size=C.ROI_ALIGN_OUT,
                spatial_scale=C.ROI_ALIGN_SCALE,
                compute_dtype=None if self.dtype == torch.float32 else self.dtype,
            ).reshape(b * n, C.ROI_ALIGN_OUT, C.ROI_ALIGN_OUT, -1)
        with record_function("vidsgg.rcnn_head"):
            feats = self.head_to_tail(pooled).reshape(b, n, -1)
        logits = self.class_scores(feats)
        cls_prob = torch.softmax(logits, dim=-1)
        bbox_pred = self.RCNN_bbox_pred(feats.to(self.RCNN_bbox_pred.weight.dtype))
        m = roi_mask[..., None]
        return {
            "rois": rois5 * m,
            "roi_mask": roi_mask,
            "cls_prob": cls_prob * m,
            "bbox_pred": bbox_pred * m,
            "base_feat": base_nhwc,
            "roi_features": feats * m,
        }
