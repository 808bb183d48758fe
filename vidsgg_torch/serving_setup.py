"""The sgdet serving configuration the port is measured at on the card.

``chip_smoke.py`` and ``scripts/profile_torch_sgdet.py`` both build it from
here: the default ``tempura_test --mode sgdet`` models at full width with
seeded random weights (no checkpoint ships), 16-frame 608x1008 videos made
from a seed, and the detector's output layers rescaled to trained-like
spreads so that proposals and detections fill their slots.
"""

from __future__ import annotations

import torch

from vidsgg_torch.data.entry import EntryCapacity
from vidsgg_torch.detector import FasterRCNN, SgdetCaps, SgdetFrontend
from vidsgg_torch.models import Tempura, TempuraConfig
from vidsgg_torch.train import EvalPipeline, create_serving_state

FRAMES, H, W = 16, 608, 1008
DETS = 16
# spreads of the detector's output layers under random weights, set to what
# a trained detector gives: box deltas about N(0, 0.2) (wider ones decode
# to boxes that all clip to the frame border) and class logits about
# N(0, 3) (flatter ones leave every class under the 0.1 score threshold)
DELTA_STD = 0.2
LOGIT_STD = 3.0


def make_frames(seed: int, frames: int, h: int, w: int, device) -> torch.Tensor:
    """BGR mean-subtracted-like frames from a seed, made on the device."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((frames, h, w, 3), generator=g, device=device) * 255.0 - 115.0


@torch.no_grad()
def calibrate_random_heads(det: FasterRCNN, frames, hw):
    """Rescale the three output layers of a randomly initialised detector
    so their outputs have the spreads above on ``frames`` (deterministic:
    the weights and frames come from seeds)."""
    def spread(t):
        return float(t.double().std())

    base = det.base_features(frames)
    _, deltas = det.RCNN_rpn(base)
    det.RCNN_rpn.RPN_bbox_pred.weight.mul_(DELTA_STD / spread(deltas))
    det.RCNN_rpn.RPN_bbox_pred.bias.zero_()
    out = det(frames, hw)
    mask = out["roi_mask"]
    det.RCNN_bbox_pred.weight.mul_(DELTA_STD / spread(out["bbox_pred"][mask]))
    logits = det.class_scores(out["roi_features"][mask])
    det.RCNN_cls_score.weight.mul_(LOGIT_STD / spread(logits))


def build_models(device=None):
    """Full-width FasterRCNN (ResNet-101, RPN 6000/100@0.7) and TEMPURA
    (linear object head, GMM relation heads) from seeds 0 and 1, the
    detector's heads calibrated on two seeded frames."""
    det = FasterRCNN(device=device, generator=torch.Generator().manual_seed(0))
    cfg = TempuraConfig.for_mode("sgdet", obj_head="linear", rel_head="gmm")
    rel = Tempura(cfg, device=device, generator=torch.Generator().manual_seed(1))
    calibrate_random_heads(det, make_frames(99, 2, H, W, det.device), (float(H), float(W)))
    return det, rel


def build_pipeline(det: FasterRCNN, rel: Tempura):
    """(SgdetFrontend, EvalPipeline("sgdet"), ServingState) at
    ``EntryCapacity(16, 256, 48)`` and 32 union pairs per frame."""
    cap = EntryCapacity(FRAMES, FRAMES * DETS, 48)
    front = SgdetFrontend(det, SgdetCaps(dets_per_frame=DETS), cap, device=det.device)
    pipe = EvalPipeline("sgdet", cap, union_pairs_per_frame=2 * DETS, device=det.device)
    return front, pipe, create_serving_state(rel)
