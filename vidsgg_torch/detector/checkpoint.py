"""Faster R-CNN checkpoint loading (the port's counterpart of
``vidsgg/detector/convert.py:load_faster_rcnn_checkpoint``).

The port names its detector parameters in the jwyang faster-rcnn.pytorch
layout the reference's ``faster_rcnn_ag.pth`` uses (``RCNN_base.*``,
``RCNN_top.0``, ``RCNN_rpn.*``, ``RCNN_cls_score``, ``RCNN_bbox_pred``), so
the checkpoint loads with no conversion. The strict ``load_state_dict`` is
the audit: a missing, unexpected or misshaped tensor raises, so no trained
weight can silently stay at its random initial value.
"""

from __future__ import annotations

import torch

from vidsgg_torch.detector.faster_rcnn import FasterRCNN

# keys carrying no learnable or statistical content in the jwyang layout
IGNORABLE_SUFFIXES = ("num_batches_tracked",)


def load_faster_rcnn_checkpoint(path, model: FasterRCNN) -> FasterRCNN:
    """Load a ``faster_rcnn_ag.pth``-style checkpoint (the state_dict alone,
    or a dict holding it under ``"model"``; a path or a binary file object,
    as ``torch.load`` takes) into ``model`` on its device, strictly.
    Returns ``model``."""
    ckpt = torch.load(path, map_location=model.device, weights_only=True)
    state = ckpt.get("model", ckpt)
    state = {k: v for k, v in state.items() if not k.endswith(IGNORABLE_SUFFIXES)}
    model.load_state_dict(state, strict=True)
    return model
