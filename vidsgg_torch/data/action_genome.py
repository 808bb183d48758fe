"""Action Genome dataset loader (counterpart of ``vidsgg/data/action_genome.py``).

The annotation parse is ``vidsgg``'s, verbatim: ``annotations/person_bbox.pkl``
+ ``object_bbox_and_relationship.pkl``, the class-name remaps, the predicate
taxonomy split 3/6/17, frames without a person box and videos with fewer
than 3 valid frames dropped, xywh GT boxes converted to xyxy, and
``datasize='mini'`` truncating to the first 80k frame records.

Frames (:meth:`ActionGenome.load_video_frames`) are decoded on the host by
:mod:`vidsgg_torch.data.png`, moved to the device as ``uint8``, and
preprocessed there with the reference's ``prep_im_for_blob`` and
``im_list_to_blob`` semantics: BGR mean subtraction, then a bilinear
min-side resize with ``cv2.resize(fx=scale, interpolation=INTER_LINEAR)``'s
coordinates, then zero padding to the video's largest frame.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from vidsgg_torch import constants as C
from vidsgg_torch.data.png import read_png
from vidsgg_torch.device import resolve_device


class ActionGenome:
    def __init__(self, mode: str, datasize: str = "large",
                 data_path: str = "/data/AG/",
                 filter_nonperson_box_frame: bool = True,
                 filter_small_box: bool = False,
                 target_min_side: int = C.TARGET_MIN_SIDE):
        self.mode = mode
        self.data_path = data_path
        self.frames_path = os.path.join(data_path, "frames/")
        # min-side resize target; the reference hardcodes 600
        # (action_genome.py:176). Smaller values shrink every downstream
        # shape — the CLI --frame_size hook for cheap end-to-end rehearsal.
        self.target_min_side = int(target_min_side)

        # class lists from the dataset when available, constants otherwise
        obj_file = os.path.join(data_path, "annotations/object_classes.txt")
        rel_file = os.path.join(data_path, "annotations/relationship_classes.txt")
        if os.path.exists(obj_file):
            self.object_classes = ["__background__"]
            with open(obj_file) as f:
                self.object_classes += [l.strip("\n") for l in f if l.strip()]
            for i, name in (
                (9, "closet/cabinet"), (11, "cup/glass/bottle"),
                (23, "paper/notebook"), (24, "phone/camera"), (31, "sofa/couch"),
            ):
                self.object_classes[i] = name
        else:
            self.object_classes = list(C.AG_OBJECT_CLASSES)
        if os.path.exists(rel_file):
            rel = []
            with open(rel_file) as f:
                rel += [l.strip("\n") for l in f if l.strip()]
            for i, name in (
                (0, "looking_at"), (1, "not_looking_at"), (5, "in_front_of"),
                (7, "on_the_side_of"), (10, "covered_by"), (11, "drinking_from"),
                (13, "have_it_on_the_back"), (15, "leaning_on"), (16, "lying_on"),
                (17, "not_contacting"), (18, "other_relationship"),
                (19, "sitting_on"), (20, "standing_on"), (25, "writing_on"),
            ):
                rel[i] = name
            self.relationship_classes = rel
        else:
            self.relationship_classes = list(C.AG_RELATIONSHIP_CLASSES)
        self.attention_relationships = self.relationship_classes[0:3]
        self.spatial_relationships = self.relationship_classes[3:9]
        self.contacting_relationships = self.relationship_classes[9:]

        with open(os.path.join(data_path, "annotations/person_bbox.pkl"), "rb") as f:
            person_bbox = pickle.load(f)
        obj_pkl = (
            "annotations/object_bbox_and_relationship_filtersmall.pkl"
            if filter_small_box
            else "annotations/object_bbox_and_relationship.pkl"
        )
        obj_path = os.path.join(data_path, obj_pkl)
        if not os.path.exists(obj_path):
            obj_path = os.path.join(
                data_path, "annotations/object_bbox_and_relationship.pkl"
            )
        with open(obj_path, "rb") as f:
            object_bbox = pickle.load(f)

        if datasize == "mini":
            keys = list(person_bbox.keys())[:80000]
            person_bbox = {k: person_bbox[k] for k in keys}
            object_bbox = {k: object_bbox[k] for k in keys}

        # collect valid frames per video (a frame is valid if any object is
        # visible; reference :90-105)
        video_dict: dict[str, list[str]] = {}
        for key in person_bbox.keys():
            if object_bbox[key][0]["metadata"]["set"] != mode:
                continue
            if any(o["visible"] for o in object_bbox[key]):
                video_dict.setdefault(key.split("/")[0], []).append(key)

        self.video_list: list[list[str]] = []
        self.video_size: list = []
        self.gt_annotations: list = []
        self.non_gt_human_nums = 0
        self.non_person_video = 0
        self.one_frame_video = 0
        self.valid_nums = 0

        for vid, keys in video_dict.items():
            video, gt_video = [], []
            last_key = keys[-1]
            for key in keys:
                if filter_nonperson_box_frame and person_bbox[key]["bbox"].shape[0] == 0:
                    self.non_gt_human_nums += 1
                    continue
                video.append(key)
                self.valid_nums += 1
                frame_gt = [
                    {"person_bbox": person_bbox[key]["bbox"], "frame": key}
                ]
                for o in object_bbox[key]:
                    if not o["visible"]:
                        continue
                    assert o["bbox"] is not None, "visible object without bbox"
                    item = dict(o)
                    item["class"] = self.object_classes.index(o["class"])
                    b = o["bbox"]
                    item["bbox"] = np.array(
                        [b[0], b[1], b[0] + b[2], b[1] + b[3]], np.float32
                    )
                    item["attention_relationship"] = [
                        self.attention_relationships.index(r)
                        for r in o["attention_relationship"]
                    ]
                    item["spatial_relationship"] = [
                        self.spatial_relationships.index(r)
                        for r in o["spatial_relationship"]
                    ]
                    item["contacting_relationship"] = [
                        self.contacting_relationships.index(r)
                        for r in o["contacting_relationship"]
                    ]
                    frame_gt.append(item)
                gt_video.append(frame_gt)
            if len(video) > 2:
                self.video_list.append(video)
                self.video_size.append(person_bbox[last_key]["bbox_size"])
                self.gt_annotations.append(gt_video)
            elif len(video) == 1:
                self.one_frame_video += 1
            else:
                self.non_person_video += 1

    def __len__(self):
        return len(self.video_list)

    def read_frames(self, index: int) -> list[np.ndarray]:
        """The video's frames as decoded: [H, W, 3] uint8 BGR each (host)."""
        return [read_png(os.path.join(self.frames_path, name))
                for name in self.video_list[index]]

    def load_video_frames(self, index: int, device=None):
        """Decode + preprocess all frames of one video.

        Returns (frames [F, Hmax, Wmax, 3] float32 BGR mean-subtracted on
        ``device``, im_scale of the first frame), as ``prep_im_for_blob`` +
        ``im_list_to_blob`` (action_genome.py:219-254)."""
        return prep_frames(self.read_frames(index), self.target_min_side, device)


def _linear_taps(n_in: int, n_out: int, scale: float, device):
    """cv2 ``INTER_LINEAR`` taps along one axis: ``src = (dst + 0.5) / scale
    - 0.5`` in float32, both source indices clamped to the image (a border
    output copies the edge pixel). -> (i0, i1, w1) with w1 in float32."""
    dst = torch.arange(n_out, dtype=torch.float64, device=device)
    src = ((dst + 0.5) * (1.0 / scale) - 0.5).to(torch.float32)
    lo = torch.floor(src)
    w1 = src - lo
    lo = lo.to(torch.int64)
    return lo.clamp(0, n_in - 1), (lo + 1).clamp(0, n_in - 1), w1


def resize_bilinear(im: torch.Tensor, scale: float) -> torch.Tensor:
    """[..., H, W, C] float32 -> [..., round(H * scale), round(W * scale), C]:
    ``cv2.resize(im, None, fx=scale, fy=scale, interpolation=INTER_LINEAR)``,
    a horizontal then a vertical lerp."""
    h, w = im.shape[-3], im.shape[-2]
    out_h, out_w = round(h * scale), round(w * scale)
    x0, x1, wx = _linear_taps(w, out_w, scale, im.device)
    y0, y1, wy = _linear_taps(h, out_h, scale, im.device)
    wx = wx[:, None]
    rows = im.index_select(-2, x0) * (1.0 - wx) + im.index_select(-2, x1) * wx
    wy = wy[:, None, None]
    return rows.index_select(-3, y0) * (1.0 - wy) + rows.index_select(-3, y1) * wy


def prep_im_for_blob(im: torch.Tensor, target_size: int = C.TARGET_MIN_SIDE):
    """[H, W, 3] BGR (any dtype) -> (float32 mean-subtracted, min-side
    resized frame, scale) (action_genome.py:235-254)."""
    # in float64, rounded once to float32, as NumPy's in-place subtraction
    # of the float64 means from a float32 frame does
    means = torch.tensor(C.PIXEL_MEANS_BGR, dtype=torch.float64, device=im.device)
    im = (im.to(torch.float64) - means).to(torch.float32)
    scale = float(target_size) / float(min(im.shape[0], im.shape[1]))
    return resize_bilinear(im, scale), scale


def prep_frames(raw: list[np.ndarray], target_size: int = C.TARGET_MIN_SIDE,
                device=None):
    """Decoded uint8 frames -> (blob [F, Hmax, Wmax, 3] float32 on
    ``device``, the first frame's scale): each frame uploaded as it is,
    preprocessed there and zero-padded to the largest (im_list_to_blob)."""
    dev = resolve_device(device)
    ims, scales = [], []
    for im in raw:
        im, scale = prep_im_for_blob(torch.from_numpy(im).to(dev), target_size)
        ims.append(im)
        scales.append(scale)
    max_h = max(im.shape[0] for im in ims)
    max_w = max(im.shape[1] for im in ims)
    blob = torch.zeros((len(ims), max_h, max_w, 3), dtype=torch.float32, device=dev)
    for i, im in enumerate(ims):
        blob[i, : im.shape[0], : im.shape[1]] = im
    return blob, scales[0]
