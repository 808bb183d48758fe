"""The ``Entry`` structure: the contract between detector and relation models.

Counterpart of ``vidsgg/data/entry.py``: a frozen dataclass of fixed-capacity
tensors plus validity masks, with the same field names, shapes and dtypes.
Padding rows are zero. Update with ``dataclasses.replace``.

* object axis ``N`` — all boxes of a video, padded to ``max_objs``;
* pair axis ``P`` — all (human, object) pairs, padded to ``max_pairs``;
* frame axis ``F`` — padded to ``max_frames``.
"""

from __future__ import annotations

import dataclasses

import torch

from vidsgg_torch import constants as C
from vidsgg_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class EntryCapacity:
    """Static padding capacities."""

    max_frames: int = 16
    max_objs: int = 48     # all boxes across the video (person + objects)
    max_pairs: int = 32    # (human, object) pairs across the video


@dataclasses.dataclass(frozen=True)
class Entry:
    """Detector -> relation-model interface (fixed shapes, masked)."""

    # object axis [N]
    boxes: torch.Tensor          # [N, 5] (frame_idx, x1, y1, x2, y2), image scale
    labels: torch.Tensor         # [N] GT class (0 where unknown)
    scores: torch.Tensor         # [N]
    distribution: torch.Tensor   # [N, num_classes-1] detector class scores (no bg)
    pred_labels: torch.Tensor    # [N]
    features: torch.Tensor       # [N, 2048] ROI head features
    obj_mask: torch.Tensor       # [N] bool

    # pair axis [P]
    im_idx: torch.Tensor         # [P] frame index of each pair
    pair_idx: torch.Tensor       # [P, 2] (human, object) indices into object axis
    union_feat: torch.Tensor     # [P, 7, 7, 1024] union-box ROI features (NHWC)
    spatial_masks: torch.Tensor  # [P, 2, S, S] rasterized pair masks (-0.5 centered)
    pair_mask: torch.Tensor      # [P] bool

    # GT predicates on the pair axis
    attention_gt: torch.Tensor   # [P] int index
    spatial_gt: torch.Tensor     # [P, 6] multi-hot float
    contacting_gt: torch.Tensor  # [P, 17] multi-hot float

    # frame axis [F]
    human_idx: torch.Tensor      # [F] object index of the person box per frame
    frame_mask: torch.Tensor     # [F] bool

    # scalars
    im_scale: torch.Tensor       # [] image scale factor
    num_frames: torch.Tensor     # [] int
    video_size: torch.Tensor     # [2] original (w, h) of the video

    @property
    def device(self) -> torch.device:
        return self.boxes.device

    def to(self, device) -> "Entry":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })

    @classmethod
    def zeros(cls, cap: EntryCapacity, num_classes: int = C.NUM_OBJ_CLASSES,
              device=None) -> "Entry":
        dev = resolve_device(device)
        n, p, f = cap.max_objs, cap.max_pairs, cap.max_frames
        mask_size, union_hw = C.SPATIAL_MASK_SIZE, C.ROI_ALIGN_OUT
        f32, i32 = torch.float32, torch.int32

        def z(shape, dtype=f32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return cls(
            boxes=z((n, 5)),
            labels=z((n,), i32),
            scores=z((n,)),
            distribution=z((n, num_classes - 1)),
            pred_labels=z((n,), i32),
            features=z((n, 2048)),
            obj_mask=z((n,), torch.bool),
            im_idx=z((p,), i32),
            pair_idx=z((p, 2), i32),
            union_feat=z((p, union_hw, union_hw, 1024)),
            spatial_masks=z((p, 2, mask_size, mask_size)),
            pair_mask=z((p,), torch.bool),
            attention_gt=z((p,), i32),
            spatial_gt=z((p, C.NUM_SPATIAL)),
            contacting_gt=z((p, C.NUM_CONTACTING)),
            human_idx=z((f,), i32),
            frame_mask=z((f,), torch.bool),
            im_scale=torch.ones((), dtype=f32, device=dev),
            num_frames=z((), i32),
            video_size=torch.ones((2,), dtype=f32, device=dev),
        )
