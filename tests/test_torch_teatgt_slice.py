"""TEAT-GT serving through ``EvalPipeline(mode, cap, needs_union=False)`` in
the port against ``vidsgg``'s, on the same entries with the same weights
(converted by ``teatgt_from_jax``): predcls and sgcls on GT-box entries,
sgdet on a detector entry packed by both packages' ``SgdetFrontend`` (a
shrunk ResNet); the device route and the host route. TEAT-GT at tiny
encoder width (d=32, 2 layers, 4 heads), the OSPU of sgcls and sgdet at
its full width with its 3-layer tracking encoder.

Both run in float64 (JAX in its x64 context), with the same Laplacian
eigenvectors (``EigBridge``: the port's adjacency must equal ``vidsgg``'s
exactly). Tolerances: every discrete output exact, floats atol
1e-8 x max(1, max|ref|) on GT-box entries and 1e-5 x max(1, max|ref|) on
the detector entry, whose ROIAlign product and head output both stacks
round to float32 (see ``test_torch_sgdet_slice.py``); the OSPU's outputs
at 1e-8; identical evaluator grids.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from teatgt_parity_utils import EigBridge
from torch_parity_utils import assert_pred_equal, entry_to_torch, random_tree, to_np

import vidsgg.eval.evaluator as jeval
import vidsgg_torch.eval.evaluator as teval
from vidsgg.data import build_gt_entry as jax_build_gt_entry
from vidsgg.data import synthetic_video_annotation as jax_annotation
from vidsgg.data.entry import Entry as JEntry
from vidsgg.data.entry import EntryCapacity as JCap
from vidsgg.detector.faster_rcnn import FasterRCNN as JFasterRCNN
from vidsgg.detector.rpn import RPNConfig as JRPNConfig
from vidsgg.detector.sgdet import SgdetCaps as JCaps
from vidsgg.detector.sgdet import SgdetFrontend as JFrontend
from vidsgg.models.convert_teatgt import expected_teatgt_shapes
from vidsgg.models.graph_build import ClipCaps as JClipCaps
from vidsgg.models.teatgt import TeatGT as JTeatGT
from vidsgg.models.teatgt import TeatGTConfig as JConfig
from vidsgg.train.eval_pipeline import EvalPipeline as JEvalPipeline
from vidsgg.train.state import TrainState
from vidsgg_torch.convert import faster_rcnn_from_jax, teatgt_from_jax
from vidsgg_torch.data.entry import EntryCapacity
from vidsgg_torch.detector import FasterRCNN, RPNConfig, SgdetCaps, SgdetFrontend
from vidsgg_torch.models.graph_build import ClipCaps
from vidsgg_torch.models.teatgt import TeatGT, TeatGTConfig
from vidsgg_torch.train import EvalPipeline, create_serving_state

F = 6
GT_CAP = (8, 32, 24)
TINY = dict(encoder_layers=2, encoder_attention_heads=4, encoder_embed_dim=32,
            encoder_ffn_embed_dim=48)
# sgdet: 4 frames of 160x256, 8 detections a frame; its clip holds 24
# tokens, fewer than the video's persons and pair objects, so tokens are
# dropped as ``vidsgg`` drops them
DF, DH, DW, DETS = 4, 160, 256, 8
CLIPS = {"gt": (5, 2, 24, 128, 8), "sgdet": (5, 1, 24, 200, 8)}


def _gt_entry(seed, mode):
    """A GT-box entry (boxes of a 480x270 video, seeded float64 features);
    sgcls gets a detector-style class distribution."""
    ann = jax_annotation(num_frames=F, objs_per_frame=3, seed=seed, stable=True)
    e = jax_build_gt_entry(ann, JCap(*GT_CAP))
    rng = np.random.RandomState(seed)
    n = GT_CAP[1]
    obj_mask = np.asarray(e.obj_mask)
    slot = np.arange(n) % 4
    features = (rng.randn(4, 2048)[slot] + 0.3 * rng.randn(n, 2048)) * obj_mask[:, None]
    logits = rng.randn(n, 36)
    logits[np.arange(n), np.clip(np.asarray(e.labels) - 1, 0, 35)] += 4.0
    dist = np.exp(logits) / np.exp(logits).sum(1, keepdims=True) * obj_mask[:, None]
    return ann, e.replace(features=features, boxes=np.asarray(e.boxes, np.float64),
                          pred_labels=np.asarray(e.labels), distribution=dist,
                          video_size=np.array([480.0, 270.0]))


@pytest.fixture(scope="module")
def sgdet_entries():
    """One video through both packages' ``SgdetFrontend`` in float64."""
    rpn = dict(pre_nms_top_n=600, post_nms_top_n=16)
    shapes = jax.eval_shape(
        lambda r: JFasterRCNN(rpn_cfg=JRPNConfig(**rpn), base_blocks=(1, 1, 1),
                              head_blocks=1).init(r, jnp.zeros((1, 64, 64, 3)),
                                                  jnp.array([64.0, 64.0])),
        jax.random.PRNGKey(0))
    det_vars = random_tree(shapes, np.random.default_rng(10), np.float64)
    det_vars["params"]["cls_score"]["kernel"] *= 8.0
    cap = (DF, DF * DETS, 48)
    frames = (np.random.RandomState(12).randn(DF, DH, DW, 3) * 40.0).astype(np.float32)
    hw, video_size = (float(DH), float(DW)), (float(DW), float(DH))
    with jax.enable_x64(True):
        jdet = JFasterRCNN(rpn_cfg=JRPNConfig(**rpn), base_blocks=(1, 1, 1), head_blocks=1,
                           dtype=jnp.float64)
        jentry, jfmaps = JFrontend(jdet, det_vars, JCaps(dets_per_frame=DETS), JCap(*cap))(
            jnp.asarray(frames), jnp.asarray(hw), 1.0, video_size=video_size)
        jentry = jax.tree.map(np.asarray, jentry)
    det = FasterRCNN(rpn_cfg=RPNConfig(**rpn), base_blocks=(1, 1, 1), head_blocks=1,
                     device="cpu").double()
    det.load_state_dict(faster_rcnn_from_jax(det_vars))
    entry, fmaps = SgdetFrontend(det, SgdetCaps(dets_per_frame=DETS), EntryCapacity(*cap),
                                 device="cpu")(torch.from_numpy(frames), hw, 1.0,
                                               video_size=video_size)
    ann = jax_annotation(num_frames=DF, objs_per_frame=3, seed=13, image_wh=(DW, DH))
    return dict(cap=cap, jentry=jentry, jfmaps=np.asarray(jfmaps), entry=entry,
                fmaps=fmaps, ann=ann)


@pytest.fixture(scope="module", params=["predcls", "sgcls", "sgdet"])
def models(request):
    mode = request.param
    clips = CLIPS["sgdet" if mode == "sgdet" else "gt"]
    jcfg = JConfig.for_mode(mode, caps=JClipCaps(*clips), **TINY)
    tcfg = TeatGTConfig.for_mode(mode, caps=ClipCaps(*clips), **TINY)
    assert tcfg.tracking == (mode != "predcls")
    variables = random_tree(expected_teatgt_shapes(jcfg, JEntry.zeros(JCap(*GT_CAP))),
                            np.random.default_rng(30), np.float64)
    port = TeatGT(tcfg, device="cpu").double()
    port.load_state_dict(teatgt_from_jax(variables, tcfg))
    yield mode, jcfg, variables, port
    del port, variables


def _run_both(models, jentry, entry, jfmaps, fmaps, cap, device_postprocess, monkeypatch):
    mode, jcfg, variables, port = models
    bridge = EigBridge(monkeypatch)
    with jax.enable_x64(True):
        state = TrainState(
            step=jnp.zeros((), jnp.int32), params=variables["params"],
            batch_stats=variables.get("batch_stats", {}), opt_state=None,
            rel_memory=jnp.zeros((26, 1936)), obj_memory=jnp.zeros((36, 1024)),
            mem_active=jnp.asarray(False), apply_fn=JTeatGT(jcfg).apply, tx=None)
        jentry = jax.tree.map(jnp.asarray, jentry)
        want = JEvalPipeline(mode, JCap(*cap), needs_union=False,
                             device_postprocess=device_postprocess)(
            state, jentry, None if jfmaps is None else jnp.asarray(jfmaps), gt_entry=jentry)
    pipe = EvalPipeline(mode, EntryCapacity(*cap), needs_union=False,
                        device_postprocess=device_postprocess, device="cpu")
    got = pipe(create_serving_state(port), entry, fmaps, gt_entry=entry)
    bridge.assert_consumed()
    return got, want, pipe.last_route


def _scale(pred):
    return max(1.0, max(float(np.abs(np.asarray(v)).max(initial=0)) for k, v in pred.items()
                        if k.endswith("distribution") or k == "boxes"))


def _same_grids(mode, ann, got, want):
    for jev, tev in zip(jeval.get_ag_evaluators(mode), teval.get_ag_evaluators(mode),
                        strict=True):
        jev.evaluate_scene_graph(ann, want)
        tev.evaluate_scene_graph(ann, got)
        assert tev.result_dict.keys() == jev.result_dict.keys()
        for key, w in jev.result_dict.items():
            for k in w:
                np.testing.assert_array_equal(np.asarray(tev.result_dict[key][k]),
                                              np.asarray(w[k]), err_msg=f"{key} {k}")


@pytest.mark.parametrize("device_postprocess", [True, False])
def test_eval_pipeline(models, sgdet_entries, device_postprocess, monkeypatch):
    """Every mode on both routes (predcls has one: it is the same call)."""
    mode = models[0]
    if mode == "sgdet":
        s = sgdet_entries
        jentry, entry, jfmaps, fmaps, cap, ann = (s["jentry"], s["entry"], s["jfmaps"],
                                                  s["fmaps"], s["cap"], s["ann"])
        rel = 1e-5
    else:
        ann, jentry = _gt_entry(20, mode)
        entry, jfmaps, cap, rel = entry_to_torch(jentry), None, GT_CAP, 1e-8
        fmaps = None
    got, want, route = _run_both(models, jentry, entry, jfmaps, fmaps, cap,
                                 device_postprocess, monkeypatch)
    assert route == ("device" if device_postprocess or mode == "predcls" else "host")
    assert len(want["pair_idx"]) > 0
    assert_pred_equal(got, want, atol=rel * _scale(want))
    _same_grids(mode, ann, got, want)
    if mode == "sgdet":   # the caps drop object tokens: their pairs get zero logits
        assert np.isclose(want["attention_distribution"], 1.0 / 3).all(axis=1).any()


def test_object_classifier(models, sgdet_entries):
    """TEAT-GT's OSPU (linear head, no memory, tracking, pe 400 or 600
    long), a variant TEMPURA does not serve, against ``vidsgg``'s."""
    mode, jcfg, variables, port = models
    if mode == "predcls":
        assert not hasattr(port, "object_classifier")
        return
    jentry = sgdet_entries["jentry"] if mode == "sgdet" else _gt_entry(21, mode)[1]
    with jax.enable_x64(True):
        jaux = JTeatGT(jcfg).apply(variables, jax.tree.map(jnp.asarray, jentry), phase="test",
                                   method="classify_objects")
        jaux = jax.tree.map(np.asarray, jaux)
    with torch.no_grad():
        aux = port.classify_objects(entry_to_torch(jentry))
    assert sorted(aux) == sorted(jaux)
    for k in jaux:
        want = jaux[k]
        np.testing.assert_allclose(to_np(aux[k]), want, rtol=0,
                                   atol=1e-8 * max(1.0, float(np.abs(want).max())), err_msg=k)
    assert port.object_classifier.positional_encoder.pe.shape[1] == (
        600 if mode == "sgdet" else 400)
