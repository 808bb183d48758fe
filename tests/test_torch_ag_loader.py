"""The port's Action Genome input path against ``vidsgg``'s: the annotation
parse, the PNG reader, the frame preprocessing, the canvas and bucket
helpers of the CLI's data sources, and the detector checkpoint loader.

Tolerances:
* ``ActionGenome``'s video lists, annotations, class lists and counters:
  exact, for ``datasize`` mini and large, with and without
  ``filter_small_box`` and the dataset's class files;
* the PNG reader: byte-equal to ``cv2.imread(..., IMREAD_UNCHANGED)``;
* the frame preprocessing against ``vidsgg``'s cv2 path
  (``prep_im_for_blob`` + ``im_list_to_blob``): the shape exact, values
  within atol 0.01 (on values up to about 150; both are float32 bilinear
  resizes with the same taps, summed in another order) — and exact where
  the scale is 1;
* canvases and buckets: exact;
* the checkpoint loader: a tiny detector saved in the jwyang layout and
  loaded by both packages gives the same base features, RPN outputs and
  head features within atol 1e-4 x max|ref| (float32 convolutions summed in
  another order), as ``tests/test_torch_detector.py`` holds them.
"""

import dataclasses
import io
import os
import pickle
import struct
import zlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_utils import random_tree, to_np

import vidsgg.cli.data_source as jds
from vidsgg.data.action_genome import ActionGenome as JActionGenome
from vidsgg.data.action_genome import im_list_to_blob
from vidsgg.data.action_genome import prep_im_for_blob as jax_prep
from vidsgg.detector.convert import load_faster_rcnn_checkpoint as jax_load_checkpoint
from vidsgg.detector.faster_rcnn import FasterRCNN as JFasterRCNN
from vidsgg.detector.rpn import RPNConfig as JRPNConfig
from vidsgg_torch.cli import data_source as tds
from vidsgg_torch.convert import faster_rcnn_from_jax
from vidsgg_torch.data.action_genome import ActionGenome, prep_frames
from vidsgg_torch.data.png import decode_png, read_png
from vidsgg_torch.detector.checkpoint import load_faster_rcnn_checkpoint

# the raw names of AG's class files, which the loader renames
RAW_OBJECTS = ["person", "bag", "bed", "blanket", "book", "box", "broom", "chair",
               "closetcabinet", "clothes", "cupglassbottle", "dish", "door", "doorknob",
               "doorway", "floor", "food", "groceries", "laptop", "light", "medicine",
               "mirror", "papernotebook", "phonecamera", "picture", "pillow", "refrigerator",
               "sandwich", "shelf", "shoe", "sofacouch", "table", "television", "towel",
               "vacuum", "window"]
RAW_RELATIONS = ["lookingat", "notlookingat", "unsure", "above", "beneath", "infrontof",
                 "behind", "onthesideof", "in", "carrying", "coveredby", "drinkingfrom",
                 "eating", "haveitontheback", "holding", "leaningon", "lyingon",
                 "notcontacting", "otherrelationship", "sittingon", "standingon", "touching",
                 "twisting", "wearing", "wiping", "writingon"]


def _write_annotations(root, class_files: bool):
    os.makedirs(root / "annotations")
    person, objects, small = {}, {}, {}
    rng = np.random.RandomState(3)

    def add_frame(vid, f, split, with_person=True, objs=(("chair", True),)):
        key = f"{vid}/{f:06d}.png"
        person[key] = {
            "bbox": (rng.rand(1, 4).astype(np.float32) * 100 if with_person
                     else np.zeros((0, 4), np.float32)),
            "bbox_size": (480, 270),
        }
        rows = []
        for k, (cls, visible) in enumerate(objs):
            rows.append({
                "class": cls,
                "bbox": list(rng.rand(4) * 50) if visible else None,   # xywh
                "attention_relationship": ["looking_at", "unsure"][k % 2:k % 2 + 1],
                "spatial_relationship": ["in_front_of", "on_the_side_of"][: 1 + k % 2],
                "contacting_relationship": ["sitting_on", "covered_by", "writing_on"][k % 3:],
                "visible": visible,
                "metadata": {"set": split},
            })
        objects[key] = rows
        small[key] = [r for r in rows if r["class"] != "cup/glass/bottle"] or rows[:1]

    for f in range(4):
        add_frame("A.mp4", f, "train")
    add_frame("B.mp4", 0, "train")                       # one valid frame
    add_frame("B.mp4", 1, "train", with_person=False)
    add_frame("C.mp4", 0, "test", with_person=False)     # no valid frame
    for f in range(2):
        add_frame("D.mp4", f, "test")                    # two valid frames
    for f in range(5):                                   # mixed visibility and classes
        add_frame("E.mp4", f, "test", with_person=f != 2,
                  objs=(("cup/glass/bottle", True), ("sofa/couch", f % 2 == 0),
                        ("phone/camera", True)))
    add_frame("E.mp4", 5, "test", objs=(("chair", False),))   # nothing visible
    for f in range(3):
        add_frame("F.mp4", f, "test", objs=(("paper/notebook", True), ("closet/cabinet", True)))

    def dump(name, obj):
        with open(root / "annotations" / name, "wb") as fh:
            pickle.dump(obj, fh)

    dump("person_bbox.pkl", person)
    dump("object_bbox_and_relationship.pkl", objects)
    dump("object_bbox_and_relationship_filtersmall.pkl", small)
    if class_files:
        (root / "annotations/object_classes.txt").write_text("\n".join(RAW_OBJECTS) + "\n")
        (root / "annotations/relationship_classes.txt").write_text(
            "\n".join(RAW_RELATIONS) + "\n")
    return str(root)


@pytest.fixture(scope="module", params=[False, True], ids=["constants", "class_files"])
def annotation_root(request, tmp_path_factory):
    return _write_annotations(tmp_path_factory.mktemp("ag_ann"), request.param)


def _assert_same(got, want, path="ann"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


@pytest.mark.parametrize("datasize", ["mini", "large"])
@pytest.mark.parametrize("split,filter_small_box", [("test", False), ("test", True),
                                                     ("train", False)])
def test_annotation_parse_matches_vidsgg(annotation_root, datasize, split, filter_small_box):
    kw = dict(filter_small_box=filter_small_box, target_min_side=48)
    got = ActionGenome(split, datasize, annotation_root, **kw)
    want = JActionGenome(split, datasize, annotation_root, **kw)
    for attr in ("video_list", "video_size", "gt_annotations", "object_classes",
                 "relationship_classes", "attention_relationships", "spatial_relationships",
                 "contacting_relationships", "non_gt_human_nums", "non_person_video",
                 "one_frame_video", "valid_nums", "frames_path", "target_min_side"):
        _assert_same(getattr(got, attr), getattr(want, attr), attr)
    assert len(got) == len(want) > 0


def _frames(seed, h=270, w=480):
    """Bands of a smooth gradient, of uniform noise and of a noisy gradient:
    rows that the adaptive filters encode in every way."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    smooth = np.stack([(x * 0.5 + seed) % 256, (y * 0.9) % 256, (x + y) % 256], -1)
    im = smooth + rng.randn(h, w, 3) * 8
    im[: h // 3] = smooth[: h // 3]
    im[h // 3: 2 * h // 3] = rng.randint(0, 256, (2 * h // 3 - h // 3, w, 3))
    return np.clip(im, 0, 255).astype(np.uint8)


def _filters(data: bytes):
    """The row filter types a PNG file uses."""
    from vidsgg_torch.data.png import _chunks

    idat = b"".join(body for kind, body in _chunks(data) if kind == b"IDAT")
    w, h = struct.unpack(">II", data[16:24])
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    return set(rows[:, 0].tolist())


@pytest.mark.parametrize("png_filter", ["ALL_FILTERS", "FILTER_NONE", "FILTER_SUB",
                                        "FILTER_UP", "FILTER_AVG", "FILTER_PAETH"])
def test_png_reader_is_byte_equal_to_cv2(png_filter, tmp_path):
    seen = set()
    for seed in range(3):
        path = str(tmp_path / f"{seed}.png")
        params = [cv2.IMWRITE_PNG_FILTER, getattr(cv2, f"IMWRITE_PNG_{png_filter}")]
        assert cv2.imwrite(path, _frames(seed), params)
        want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        got = read_png(path)
        assert got.dtype == np.uint8 and got.shape == want.shape == (270, 480, 3)
        np.testing.assert_array_equal(got, want)
        with open(path, "rb") as f:
            seen |= _filters(f.read())
    if png_filter == "ALL_FILTERS":     # adaptive: Paeth and Avg rows among others
        assert {3, 4} <= seen and len(seen) >= 3, seen
    else:
        assert len(seen) == 1


@pytest.mark.parametrize("image,field", [
    (np.zeros((6, 5), np.uint8), "colour type 0"),
    (np.zeros((6, 5, 4), np.uint8), "colour type 6"),
    (np.zeros((6, 5, 3), np.uint16), "bit depth 16"),
])
def test_png_reader_refuses_other_formats(image, field):
    ok, buf = cv2.imencode(".png", image)
    assert ok
    with pytest.raises(ValueError, match=field):
        decode_png(buf.tobytes())


def test_png_reader_refuses_interlace_and_bad_crc():
    ok, buf = cv2.imencode(".png", _frames(0, 6, 5))
    data = bytearray(buf.tobytes())
    broken = bytearray(data)
    broken[40] ^= 0xFF                   # inside the first IDAT payload
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(broken))
    data[28] = 1                         # IHDR interlace method: Adam7
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    with pytest.raises(ValueError, match="interlace method 1"):
        decode_png(bytes(data))


@pytest.mark.parametrize("sizes,target,atol", [
    ([(270, 480)] * 2, 600, 0.01),              # AG's frames: 1067 x 600
    ([(480, 270)], 600, 0.01),                  # portrait
    ([(270, 480), (240, 480)], 600, 0.01),      # sizes differ: zero padding
    ([(100, 130)], 37, 0.01),                   # downscale
    ([(48, 64)] * 3, 48, 0.0),                  # scale 1: the frames as they are
])
def test_preprocessing_matches_the_cv2_path(sizes, target, atol):
    raw = [_frames(i, h, w) for i, (h, w) in enumerate(sizes)]
    ims, scales = zip(*(jax_prep(im.copy(), target) for im in raw))
    want = im_list_to_blob(list(ims))
    got, scale = prep_frames(raw, target, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert scale == scales[0]
    np.testing.assert_allclose(to_np(got), want, rtol=0, atol=atol)


def test_canvases_and_buckets_match_vidsgg():
    for size in (600, 48, 300, 800, 1000):
        assert tds.scale_canvases(size) == jds.scale_canvases(size)
        canvases = tds.scale_canvases(size)
        for h in range(8, 1200, 37):
            for w in range(8, 1200, 41):
                assert tds.pick_canvas(h, w, canvases) == jds.pick_canvas(h, w, canvases)
    for max_frames in (16, 32, 48, 64, 128):
        got = tds.default_buckets(max_frames)
        want = jds.default_buckets(max_frames)
        assert [(b.max_frames, b.max_objs, b.max_pairs) for b in got] == [
            (b.max_frames, b.max_objs, b.max_pairs) for b in want]
        for f in range(1, 140, 7):
            for nb in range(1, 600, 53):
                for p in range(0, 450, 61):
                    g, w = tds.pick_bucket(got, f, nb, p), jds.pick_bucket(want, f, nb, p)
                    assert (g is None) == (w is None)
                    if g is not None:
                        assert (g.max_frames, g.max_objs, g.max_pairs) == (
                            w.max_frames, w.max_objs, w.max_pairs)


def _pth(obj) -> io.BytesIO:
    """``torch.save`` into memory: a tiny detector's checkpoint is about
    50 MB, and the test host's disk is short."""
    buf = io.BytesIO()
    torch.save(obj, buf)
    buf.seek(0)
    return buf


def test_checkpoint_loader_matches_vidsgg():
    rpn = dict(pre_nms_top_n=64, post_nms_top_n=16)
    jdet = JFasterRCNN(rpn_cfg=JRPNConfig(**rpn), base_blocks=(1, 1, 1), head_blocks=1)
    shapes = jax.eval_shape(
        lambda r: jdet.init(r, jnp.zeros((1, 64, 64, 3)), jnp.array([64.0, 64.0])),
        jax.random.PRNGKey(0))
    # a jwyang-layout checkpoint, as the reference's training saves it
    state = faster_rcnn_from_jax(random_tree(shapes, np.random.default_rng(30)))
    state["RCNN_base.1.num_batches_tracked"] = torch.tensor(7)
    ckpt = _pth({"model": state, "epoch": 3})
    det, canvases = tds.build_detector(ckpt, tiny=True, frame_size=48, device="cpu")
    ckpt.seek(0)
    jvars = jax_load_checkpoint(ckpt, model=jdet)
    assert canvases == jds.scale_canvases(48)
    want_rpn = dataclasses.asdict(JRPNConfig(**rpn))
    assert want_rpn.pop("approx_topk") is False    # the TPU-only option
    assert dataclasses.asdict(det.rpn_cfg) == want_rpn
    # the strict load is the audit: a missing or an unknown tensor raises
    with pytest.raises(RuntimeError, match="Missing key"):
        load_faster_rcnn_checkpoint(_pth({k: v for k, v in state.items()
                                          if k != "RCNN_rpn.RPN_Conv.bias"}), det)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_faster_rcnn_checkpoint(_pth({**state, "RCNN_extra.weight": torch.zeros(1)}), det)

    frames = np.random.RandomState(31).randn(2, 64, 80, 3).astype(np.float32) * 40
    pooled = np.random.RandomState(32).randn(5, 7, 7, 1024).astype(np.float32)

    def jax_part(method, x):
        return np.asarray(jdet.apply(jvars, jnp.asarray(x), method=method))

    with torch.inference_mode():
        base = det.base_features(torch.from_numpy(frames))
        fg, deltas = det.RCNN_rpn(base)
        head = det.head_to_tail(torch.from_numpy(pooled))
    want_base = jax_part("base_features", frames)
    for got, want in ((base.permute(0, 2, 3, 1), want_base),
                      (head, jax_part("head_to_tail", pooled))):
        np.testing.assert_allclose(to_np(got), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    j_fg, j_deltas = jdet.apply(jvars, jnp.asarray(want_base), method=lambda m, x: m.rpn(x))
    for got, want in ((fg, j_fg), (deltas, j_deltas)):
        want = np.asarray(want)
        np.testing.assert_allclose(to_np(got), want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_ag_loader_reads_the_frames_it_lists(tmp_path):
    """``load_video_frames`` on a tree at scale 1 equals ``vidsgg``'s cv2
    path on the same files exactly (``vidsgg``'s own ``load_video_frames``
    takes its native C++ path where that is built, which subtracts float32
    means after the resize: ROADMAP.md section 3)."""
    from torch_parity_utils import write_ag_tree

    root = write_ag_tree(tmp_path / "ag", long_frames=3, over_frames=0)
    ds = ActionGenome("test", "large", root, target_min_side=48)
    assert len(ds) == 3
    for i in range(len(ds)):
        want = [cv2.imread(os.path.join(root, "frames", k), cv2.IMREAD_UNCHANGED)
                for k in ds.video_list[i]]
        for g, w in zip(ds.read_frames(i), want, strict=True):
            np.testing.assert_array_equal(g, w)
        ims, scales = zip(*(jax_prep(im, 48) for im in want))
        got, scale = ds.load_video_frames(i, device="cpu")
        assert scale == scales[0] == 1.0
        np.testing.assert_array_equal(to_np(got), im_list_to_blob(list(ims)))
