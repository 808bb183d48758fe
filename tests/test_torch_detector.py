"""Faster R-CNN, the proposal layer and the sgdet test pack in the port
against ``vidsgg``, with weights carried across by ``faster_rcnn_from_jax``.

Tolerances:
* conv stacks in float32 on both sides: atol 1e-4 x max|ref| (the
  convolutions sum in another order);
* the proposal layer on shared inputs: exact order and mask, boxes 1e-5;
* the whole detector and the packed Entry in float64 on both sides (JAX in
  its x64 context, as ``PARITY.md`` does for deterministic math), so that
  rounding cannot reorder near-tied scores: every integer and bool output
  exact; proposals and base maps atol 1e-8 x max(1, max|ref|). Both stacks
  round the ROIAlign product and the head output to float32 (as ``vidsgg``
  does), and XLA accumulates its float64-in/float32-out product at a
  precision of its own, so what follows the pooling (roi features, class
  scores, deltas, detections) is held at atol 1e-5 x max(1, max|ref|);
* the converter round trip: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_utils import assert_trees_equal, random_tree, to_np, tree_leaves

from vidsgg.data.entry import EntryCapacity as JCap
from vidsgg.detector.convert import convert_jwyang_state_dict
from vidsgg.detector.faster_rcnn import FasterRCNN as JFasterRCNN
from vidsgg.detector.rpn import RPNConfig as JRPNConfig
from vidsgg.detector.rpn import generate_anchors as jax_anchors
from vidsgg.detector.rpn import proposal_layer as jax_proposal_layer
from vidsgg.detector.sgdet import SgdetCaps as JCaps
from vidsgg.detector.sgdet import make_test_entry_fn as jax_test_entry_fn
from vidsgg_torch.convert import faster_rcnn_from_jax
from vidsgg_torch.data.entry import EntryCapacity
from vidsgg_torch.detector.faster_rcnn import FasterRCNN
from vidsgg_torch.detector.rpn import RPNConfig, generate_anchors, proposal_layer
from vidsgg_torch.detector.sgdet import SgdetCaps, make_test_entry_fn

F, H, W = 4, 160, 256
PRE, POST, DETS = 600, 16, 8
HW = (float(H), float(W))


def _jax_model(dtype=jnp.float32):
    return JFasterRCNN(rpn_cfg=JRPNConfig(pre_nms_top_n=PRE, post_nms_top_n=POST),
                       base_blocks=(1, 1, 1), head_blocks=1, dtype=dtype)


@pytest.fixture(scope="module")
def jax_vars():
    shapes = jax.eval_shape(
        lambda r: _jax_model().init(r, jnp.zeros((1, 64, 64, 3)), jnp.array([64.0, 64.0])),
        jax.random.PRNGKey(0))
    tree = random_tree(shapes, np.random.default_rng(0), np.float64)
    # sharper class scores, so detections clear the 0.1 score threshold
    tree["params"]["cls_score"]["kernel"] *= 8.0
    return tree


def _cast(tree, dtype):
    return {k: _cast(v, dtype) if isinstance(v, dict) else v.astype(dtype)
            for k, v in tree.items()}


def _port(jax_vars, dtype):
    m = FasterRCNN(rpn_cfg=RPNConfig(pre_nms_top_n=PRE, post_nms_top_n=POST),
                   base_blocks=(1, 1, 1), head_blocks=1, device="cpu")
    m.to(dtype).load_state_dict(faster_rcnn_from_jax(jax_vars))
    return m


def _frames(seed=0):
    return (np.random.RandomState(seed).randn(F, H, W, 3) * 40.0).astype(np.float32)


def test_converter_round_trip(jax_vars):
    port = _port(jax_vars, torch.float32)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = convert_jwyang_state_dict(sd, strict=True)
    assert_trees_equal(back, _cast(jax_vars, np.float32))
    assert len(tree_leaves(back)) == len(sd)


def test_conv_stacks_float32(jax_vars):
    v32 = _cast(jax_vars, np.float32)
    jm = _jax_model()
    frames = _frames()
    jbase = jm.apply(v32, jnp.asarray(frames), method="base_features")
    jfg, jdeltas = jm.apply(v32, jbase, method=lambda mdl, x: mdl.rpn(x))
    port = _port(jax_vars, torch.float32)
    with torch.no_grad():
        base = port.base_features(torch.from_numpy(frames))
        want = np.asarray(jbase)
        np.testing.assert_allclose(to_np(base.permute(0, 2, 3, 1)), want,
                                   atol=1e-4 * np.abs(want).max())
        fg, deltas = port.RCNN_rpn(torch.tensor(want).permute(0, 3, 1, 2))
        for got, ref in ((fg, jfg), (deltas, jdeltas)):
            ref = np.asarray(ref)
            np.testing.assert_allclose(to_np(got), ref, atol=1e-4 * np.abs(ref).max())


def test_proposal_layer_on_shared_inputs():
    rng = np.random.RandomState(1)
    fh, fw = H // 16, W // 16
    anchors = jax_anchors(JRPNConfig(), fh, fw)
    np.testing.assert_array_equal(generate_anchors(RPNConfig(), fh, fw), anchors)
    k = anchors.shape[0]
    fg = rng.rand(F, k).astype(np.float32)
    fg[:, :40] = 0.5                         # ties: lower index first
    deltas = (0.3 * rng.randn(F, k, 4)).astype(np.float32)
    jcfg = JRPNConfig(pre_nms_top_n=PRE, post_nms_top_n=POST)
    want = jax_proposal_layer(jnp.asarray(fg), jnp.asarray(deltas),
                              jnp.asarray(anchors), jnp.asarray(HW), jcfg)
    got = proposal_layer(torch.from_numpy(fg), torch.from_numpy(deltas),
                         torch.from_numpy(anchors), torch.tensor(HW),
                         RPNConfig(pre_nms_top_n=PRE, post_nms_top_n=POST))
    np.testing.assert_array_equal(to_np(got[2]), np.asarray(want[2]))
    np.testing.assert_array_equal(to_np(got[1]), np.asarray(want[1]))
    np.testing.assert_allclose(to_np(got[0]), np.asarray(want[0]), atol=1e-5, rtol=1e-6)
    assert to_np(got[2]).all()


@pytest.fixture(scope="module")
def float64_runs(jax_vars):
    frames = _frames(2)
    jcap = JCap(F, F * DETS, 48)
    with jax.enable_x64(True):
        jm = _jax_model(jnp.float64)
        out = jax.jit(jm.apply)(jax_vars, jnp.asarray(frames), jnp.asarray(HW))
        out = jax.tree.map(np.asarray, out)
        fn = jax_test_entry_fn(jm, JCaps(dets_per_frame=DETS), jcap)
        je, jbase, jn = fn(jax_vars, jnp.asarray(frames), jnp.asarray(HW),
                           jnp.asarray(0.8), jnp.asarray([320.0, 200.0]), jnp.asarray(F))
        je = jax.tree.map(np.asarray, je)
    port = _port(jax_vars, torch.float64)
    with torch.no_grad():
        tout = port(torch.from_numpy(frames), torch.tensor(HW))
        fn = make_test_entry_fn(port, SgdetCaps(dets_per_frame=DETS),
                                EntryCapacity(F, F * DETS, 48))
        te, tbase, tn = fn(torch.from_numpy(frames), torch.tensor(HW), 0.8,
                           (320.0, 200.0), F)
    return out, tout, je, te, int(jn), int(tn)


def test_faster_rcnn_float64(float64_runs):
    out, tout, *_ = float64_runs
    np.testing.assert_array_equal(to_np(tout["roi_mask"]), out["roi_mask"])
    for k, tol in (("rois", 1e-8), ("base_feat", 1e-8), ("cls_prob", 1e-5),
                   ("bbox_pred", 1e-5), ("roi_features", 1e-5)):
        ref = out[k]
        np.testing.assert_allclose(to_np(tout[k]), ref, atol=tol * max(1.0, np.abs(ref).max()),
                                   err_msg=k)


def test_packed_test_entry_float64(float64_runs):
    _, _, je, te, jn, tn = float64_runs
    assert tn == jn > 0
    for f in dataclasses.fields(te):
        got, want = to_np(getattr(te, f.name)), np.asarray(getattr(je, f.name))
        assert got.shape == want.shape, f.name
        if want.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want, err_msg=f.name)
        else:
            np.testing.assert_allclose(got, want, atol=1e-5 * max(1.0, np.abs(want).max()),
                                       err_msg=f.name)
    # padding rows are zero
    n = int(np.asarray(je.obj_mask).sum())
    assert not to_np(te.boxes)[n:].any() and not to_np(te.features)[n:].any()
