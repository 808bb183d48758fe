"""The bfloat16 detector (``FasterRCNN(dtype=torch.bfloat16)``) against
``vidsgg``'s ``FasterRCNN(dtype=jnp.bfloat16)``, with the same float32
weights carried across (a shrunk ResNet: base blocks (1, 1, 1), one head
block).

Each stage is compared on the same inputs, since a bfloat16 rounding that
falls the other way upstream reorders proposals downstream:

* base features from the same frames, pooled features from ``vidsgg``'s
  base features and proposals, head features from ``vidsgg``'s pooled
  features: atol 2**-6 x max|ref|, four bfloat16 ulps at the largest
  magnitude (the convolutions sum in another order before each rounding to
  bfloat16, and the port rounds the pooling product to bfloat16 where
  ``vidsgg`` rounds it at the head's first convolution); and closer to
  ``vidsgg``'s bfloat16 values than the port's float32 detector is;
* the RPN and proposal layer (float32 in both) on ``vidsgg``'s bfloat16
  base features: the keep mask exact, boxes atol 2e-3 x max|ref|;
* the packed sgdet entry and the GT featurization on a bfloat16 detector
  keep ``vidsgg``'s float32 fields;
* weights and ``state_dict`` stay float32, keys unchanged: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_utils import random_tree, to_np

from vidsgg.data.entry import EntryCapacity as JCap
from vidsgg.detector.faster_rcnn import FasterRCNN as JFasterRCNN
from vidsgg.detector.rpn import RPNConfig as JRPNConfig
from vidsgg.detector.sgdet import SgdetCaps as JCaps
from vidsgg.detector.sgdet import make_test_entry_fn as jax_test_entry_fn
from vidsgg.ops.roi_align import roi_align_fused as jax_roi_align_fused
from vidsgg_torch.convert import faster_rcnn_from_jax
from vidsgg_torch.data import EntryCapacity, build_gt_entry, synthetic_video_annotation
from vidsgg_torch.detector import GtFrontend
from vidsgg_torch.detector.faster_rcnn import FasterRCNN
from vidsgg_torch.detector.rpn import RPNConfig, generate_anchors, proposal_layer
from vidsgg_torch.detector.sgdet import SgdetCaps, make_test_entry_fn
from vidsgg_torch.ops.roi_align import roi_align_fused

F, H, W = 4, 160, 256
PRE, POST, DETS = 600, 16, 8
HW = (float(H), float(W))
BF16_ATOL = 2.0 ** -6     # x max|ref|: four bfloat16 ulps at the largest value


def _jax_model(dtype):
    return JFasterRCNN(rpn_cfg=JRPNConfig(pre_nms_top_n=PRE, post_nms_top_n=POST),
                       base_blocks=(1, 1, 1), head_blocks=1, dtype=dtype)


def _port(variables, dtype):
    m = FasterRCNN(rpn_cfg=RPNConfig(pre_nms_top_n=PRE, post_nms_top_n=POST),
                   base_blocks=(1, 1, 1), head_blocks=1, device="cpu", dtype=dtype)
    m.load_state_dict(faster_rcnn_from_jax(variables))
    return m


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= BF16_ATOL * np.abs(want).max(), (what, err, np.abs(want).max())
    return err


@pytest.fixture(scope="module")
def runs():
    shapes = jax.eval_shape(
        lambda r: _jax_model(jnp.float32).init(r, jnp.zeros((1, 64, 64, 3)),
                                               jnp.array([64.0, 64.0])),
        jax.random.PRNGKey(0))
    variables = random_tree(shapes, np.random.default_rng(0), np.float32)
    variables["params"]["cls_score"]["kernel"] *= 8.0
    frames = (np.random.RandomState(2).randn(F, H, W, 3) * 40.0).astype(np.float32)
    jm = _jax_model(jnp.bfloat16)
    jbase = np.array(jm.apply(variables, jnp.asarray(frames), method="base_features"))
    jout = jax.tree.map(np.asarray, jm.apply(variables, jnp.asarray(frames), jnp.asarray(HW)))
    rois4 = jout["rois"][..., 1:]
    jpooled = np.asarray(jax_roi_align_fused(jnp.asarray(jbase), jnp.asarray(rois4), 7,
                                             1.0 / 16.0, 0, jnp.bfloat16))
    jpooled = jpooled.reshape(-1, 7, 7, jpooled.shape[-1])
    jhead = np.asarray(jm.apply(variables, jnp.asarray(jpooled), method="head_to_tail"))
    return dict(variables=variables, frames=frames, jbase=jbase, jout=jout, rois4=rois4,
                jpooled=jpooled, jhead=jhead)


def test_bf16_detector_keeps_float32_weights(runs):
    det, ref = _port(runs["variables"], torch.bfloat16), _port(runs["variables"], None)
    assert det.dtype == torch.bfloat16 and ref.dtype == torch.float32
    sd, sd_ref = det.state_dict(), ref.state_dict()
    assert list(sd) == list(sd_ref)
    for k, v in sd.items():
        assert v.dtype == torch.float32 and torch.equal(v, sd_ref[k]), k


@pytest.mark.parametrize("stage", ["base", "pooled", "head"])
def test_bf16_stages_on_shared_inputs(runs, stage):
    det, det32 = _port(runs["variables"], torch.bfloat16), _port(runs["variables"], None)
    with torch.no_grad():
        if stage == "base":
            frames = torch.from_numpy(runs["frames"])
            got, got32 = (to_np(d.base_features(frames).permute(0, 2, 3, 1))
                          for d in (det, det32))
            want = runs["jbase"]
        elif stage == "pooled":
            args = (torch.from_numpy(runs["jbase"]), torch.from_numpy(runs["rois4"]), 7,
                    1.0 / 16.0)
            got = to_np(roi_align_fused(*args, compute_dtype=torch.bfloat16))
            got32 = to_np(roi_align_fused(*args))
            want = runs["jpooled"].reshape(got.shape)
        else:
            pooled = torch.from_numpy(runs["jpooled"])
            got, got32 = (to_np(d.head_to_tail(pooled)) for d in (det, det32))
            want = runs["jhead"]
    assert got.dtype == np.float32
    err = _close(got, want, stage)
    err32 = np.abs(got32.astype(np.float64) - want).max()
    assert err < err32, (stage, err, err32)


def test_bf16_proposals_on_vidsgg_base(runs):
    det = _port(runs["variables"], torch.bfloat16)
    jbase, jout = runs["jbase"], runs["jout"]
    with torch.no_grad():
        fg, deltas = det.RCNN_rpn(torch.from_numpy(jbase).permute(0, 3, 1, 2))
        anchors = torch.from_numpy(generate_anchors(det.rpn_cfg, H // 16, W // 16))
        rois, _, mask = proposal_layer(fg, deltas, anchors, torch.tensor(HW), det.rpn_cfg)
    assert jout["roi_mask"].any()
    np.testing.assert_array_equal(to_np(mask), jout["roi_mask"])
    want = runs["rois4"]
    np.testing.assert_allclose(to_np(rois), want, rtol=0, atol=2e-3 * np.abs(want).max())


def test_bf16_frontends_keep_float32_fields(runs):
    det = _port(runs["variables"], torch.bfloat16)
    frames = runs["frames"]
    cap = (F, F * DETS, 48)
    fn = jax_test_entry_fn(_jax_model(jnp.bfloat16), JCaps(dets_per_frame=DETS), JCap(*cap))
    je, _, _ = fn(runs["variables"], jnp.asarray(frames), jnp.asarray(HW),
                  jnp.asarray(0.8), jnp.asarray([320.0, 200.0]), jnp.asarray(F))
    with torch.no_grad():
        fn = make_test_entry_fn(det, SgdetCaps(dets_per_frame=DETS), EntryCapacity(*cap))
        te, base, _ = fn(torch.from_numpy(frames), torch.tensor(HW), 0.8, (320.0, 200.0), F)
    assert base.dtype == torch.float32
    for f in dataclasses.fields(te):
        got, want = getattr(te, f.name), np.asarray(getattr(je, f.name))
        assert to_np(got).dtype == want.dtype and got.shape == want.shape, f.name
        assert torch.isfinite(got.double()).all(), f.name

    ann = synthetic_video_annotation(num_frames=F, objs_per_frame=2, seed=3)
    skeleton = build_gt_entry(ann, EntryCapacity(F, 3 * F, 2 * F), device="cpu")
    skeleton = dataclasses.replace(skeleton, im_scale=torch.tensor(0.25))
    with torch.no_grad():
        entry, fmaps = GtFrontend(det)(torch.from_numpy(frames), skeleton)
    assert fmaps.dtype == entry.features.dtype == entry.union_feat.dtype == torch.float32
    assert float(entry.features.abs().max()) > 0
