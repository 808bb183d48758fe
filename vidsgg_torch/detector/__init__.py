from vidsgg_torch.detector.faster_rcnn import FasterRCNN
from vidsgg_torch.detector.featurize import (
    GtFrontend,
    featurize_gt_entry,
    featurize_pair_entry,
    pair_union_features,
    pair_union_features_grouped,
)
from vidsgg_torch.detector.rpn import RPNConfig
from vidsgg_torch.detector.sgdet import SgdetCaps, SgdetFrontend

__all__ = [
    "FasterRCNN", "GtFrontend", "RPNConfig", "SgdetCaps", "SgdetFrontend", "featurize_gt_entry",
    "featurize_pair_entry", "pair_union_features", "pair_union_features_grouped",
]
