"""Synthetic Action Genome-style annotations and features for tests/benchmarks.

The port's own copy of ``vidsgg/data/synthetic.py``: the same
``np.random.RandomState`` draws, so a seed gives the same annotation.

The reference has no test suite (SURVEY.md §4); this generator provides
deterministic videos with known GT so end-to-end predcls/sgcls paths can be
exercised — and evaluated exactly — without the AG dataset on disk.
"""

from __future__ import annotations

import numpy as np

from vidsgg_torch import constants as C


def synthetic_video_annotation(
    num_frames: int = 6,
    objs_per_frame: int = 2,
    seed: int = 0,
    image_wh: tuple[int, int] = (480, 270),
    stable: bool = False,
):
    """A gt_annotation list in the reference's schema.

    When ``stable`` is set, object classes and relationships stay constant
    across frames (useful for the temporal-consistency metric, which needs
    >= 6-frame stable intervals).
    """
    rng = np.random.RandomState(seed)
    w, h = image_wh
    ann = []
    stable_cls = rng.randint(2, C.NUM_OBJ_CLASSES, size=objs_per_frame)
    stable_att = rng.randint(0, C.NUM_ATTENTION, size=objs_per_frame)
    stable_spa = rng.randint(0, C.NUM_SPATIAL, size=objs_per_frame)
    stable_con = rng.randint(0, C.NUM_CONTACTING, size=objs_per_frame)
    for f in range(num_frames):
        px, py = rng.randint(0, w // 2), rng.randint(0, h // 2)
        frame = [
            {
                "person_bbox": np.array(
                    [[px, py, px + w // 4, py + h // 4]], np.float32
                ),
                "frame": f"vid/{f:06d}.png",
            }
        ]
        for o in range(objs_per_frame):
            x, y = rng.randint(0, 3 * w // 4), rng.randint(0, 3 * h // 4)
            lo_w, lo_h = max(4, min(20, w // 8)), max(4, min(20, h // 8))
            bw = rng.randint(lo_w, max(w // 4, lo_w + 1))
            bh = rng.randint(lo_h, max(h // 4, lo_h + 1))
            if stable:
                cls = int(stable_cls[o])
                att = [int(stable_att[o])]
                spa = sorted({int(stable_spa[o]), int(rng.randint(0, C.NUM_SPATIAL))})
                con = [int(stable_con[o])]
            else:
                cls = int(rng.randint(2, C.NUM_OBJ_CLASSES))
                att = [int(rng.randint(0, C.NUM_ATTENTION))]
                spa = sorted(
                    set(
                        rng.randint(
                            0, C.NUM_SPATIAL, size=rng.randint(1, 3)
                        ).tolist()
                    )
                )
                con = sorted(
                    set(
                        rng.randint(
                            0, C.NUM_CONTACTING, size=rng.randint(1, 3)
                        ).tolist()
                    )
                )
            frame.append(
                {
                    "bbox": np.array([x, y, x + bw, y + bh], np.float32),
                    "class": cls,
                    "attention_relationship": att,
                    "spatial_relationship": spa,
                    "contacting_relationship": con,
                    "metadata": {"set": "train"},
                    "visible": True,
                }
            )
        ann.append(frame)
    return ann


def synthetic_base_fmaps(num_frames: int, hw: tuple[int, int] = (38, 67),
                         channels: int = 1024, seed: int = 0) -> np.ndarray:
    """Random base feature maps [F, H, W, C] standing in for the ResNet-101
    conv4 output (object_detector.py:357-358), NHWC."""
    rng = np.random.RandomState(seed)
    return rng.randn(num_frames, hw[0], hw[1], channels).astype(np.float32) * 0.1
