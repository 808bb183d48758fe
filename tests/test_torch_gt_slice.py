"""The predcls and sgcls serving slice: GT entries, synthetic videos, GT
featurization, the sgcls device postprocess and ``EvalPipeline`` in the
port against ``vidsgg``, with the same weights carried across (a shrunk
detector head, a full-width relation stack with one layer of each kind).

Tolerances:
* ``synthetic_video_annotation`` and ``build_gt_entry``: every field exact;
* ``featurize_gt_entry``: both sides pool in float32 and round the head's
  float64 output to float32 (as ``vidsgg`` does), so features, union
  features and masks at atol 1e-5 x max(1, max|ref|);
* ``sgcls_postprocess_device`` selects, compares and copies: every output
  exact against ``vidsgg``'s, and every discrete output exact against the
  port's host ``sgcls_postprocess``, on entries with tied label counts and
  tied duplicate scores;
* ``EvalPipeline`` (relation stack in float64 on both sides, JAX in its x64
  context): every discrete output exact, floats at atol
  1e-5 x max(1, max|ref|), the sgdet slice's tolerance;
* the converter round trips: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_utils import (
    assert_pred_equal,
    assert_trees_equal,
    entry_to_torch,
    random_tree,
    to_np,
)

from vidsgg.data import build_gt_entry as jax_build_gt_entry
from vidsgg.data import synthetic_video_annotation as jax_annotation
from vidsgg.data.entry import Entry as JEntry
from vidsgg.data.entry import EntryCapacity as JCap
from vidsgg.data.synthetic import synthetic_base_fmaps as jax_fmaps
from vidsgg.detector import featurize_gt_entry as jax_featurize
from vidsgg.detector.faster_rcnn import FasterRCNN as JFasterRCNN
from vidsgg.detector.rpn import RPNConfig as JRPNConfig
from vidsgg.models.convert_relation import convert_tempura_state_dict, expected_tempura_shapes
from vidsgg.models.postprocess_device import sgcls_postprocess_device as jax_sgcls_device
from vidsgg.models.tempura import Tempura as JTempura
from vidsgg.models.tempura import TempuraConfig as JConfig
from vidsgg.train.eval_pipeline import EvalPipeline as JEvalPipeline
from vidsgg.train.state import TrainState
from vidsgg_torch.convert import faster_rcnn_from_jax, memory_from_jax, tempura_from_jax
from vidsgg_torch.data import (
    EntryCapacity,
    build_gt_entry,
    synthetic_base_fmaps,
    synthetic_video_annotation,
    video_counts,
)
from vidsgg_torch.detector import FasterRCNN, RPNConfig, featurize_gt_entry
from vidsgg_torch.models import Tempura, TempuraConfig
from vidsgg_torch.models.postprocess import ObjectsView, sgcls_postprocess
from vidsgg_torch.models.postprocess_device import sgcls_postprocess_device
from vidsgg_torch.train import EvalPipeline, create_serving_state

F, OBJS = 6, 3
CAP = (8, 32, 24)
IMAGE_WH = (480, 270)
IM_SCALE = 2.0 / 3.0           # 480x270 -> 320x180, inside the 12x20 base map
FMAP_HW = (12, 20)
TEMPURA_KW = dict(obj_head="linear", rel_head="gmm", enc_layers=1, dec_layers=1,
                  track_layers=1)
RPN = dict(pre_nms_top_n=64, post_nms_top_n=8)


def _fields(entry):
    return {f.name: to_np(getattr(entry, f.name)) for f in dataclasses.fields(entry)}


def _assert_fields_close(got, want, atol_scale=None, names=None):
    for k in names or want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, (k, g.shape, w.shape, g.dtype, w.dtype)
        if atol_scale is None or w.dtype.kind != "f":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(
                g, w, rtol=0, atol=atol_scale * max(1.0, float(np.abs(w).max(initial=0))),
                err_msg=k)


@pytest.mark.parametrize("seed,stable", [(0, False), (3, True), (11, True)])
def test_annotation_and_gt_entry_exact(seed, stable):
    kw = dict(num_frames=F, objs_per_frame=OBJS, seed=seed, image_wh=IMAGE_WH, stable=stable)
    ann, jann = synthetic_video_annotation(**kw), jax_annotation(**kw)
    assert len(ann) == len(jann)
    for frame, jframe in zip(ann, jann):
        assert len(frame) == len(jframe)
        for obj, jobj in zip(frame, jframe):
            assert sorted(obj) == sorted(jobj)
            for k in jobj:
                if isinstance(jobj[k], np.ndarray):
                    assert obj[k].dtype == jobj[k].dtype
                    np.testing.assert_array_equal(obj[k], jobj[k])
                else:
                    assert obj[k] == jobj[k], k
    assert video_counts(ann) == (F, F * (1 + OBJS), F * OBJS)
    entry = build_gt_entry(ann, EntryCapacity(*CAP), device="cpu")
    jentry = jax_build_gt_entry(jann, JCap(*CAP))
    _assert_fields_close(_fields(entry), {k: np.asarray(v) for k, v in _fields(jentry).items()})
    np.testing.assert_array_equal(synthetic_base_fmaps(F, hw=FMAP_HW, seed=seed),
                                  jax_fmaps(F, hw=FMAP_HW, seed=seed))


def test_gt_entry_refuses_an_over_capacity_video():
    ann = synthetic_video_annotation(num_frames=F, objs_per_frame=OBJS, seed=1)
    with pytest.raises(ValueError, match="exceeds capacity"):
        build_gt_entry(ann, EntryCapacity(F, 10, 24), device="cpu")


def _sgcls_dist(entry, seed):
    """The detector-style distribution of ``vidsgg``'s synthetic source:
    seeded logits, +4 on the GT class, softmax, masked."""
    n = entry.obj_mask.shape[0]
    rng = np.random.RandomState(seed)
    logits = rng.randn(n, 36).astype(np.float32)
    lbl = np.asarray(entry.labels)
    logits[np.arange(n), np.clip(lbl - 1, 0, 35)] += 4.0
    dist = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return dist * np.asarray(entry.obj_mask)[:, None]


@pytest.fixture(scope="module")
def gt_setup():
    """The shrunk detector's head in both stacks, two videos featurized by
    each stack's own ``featurize_gt_entry`` on the same base maps."""
    shapes = jax.eval_shape(
        lambda r: JFasterRCNN(rpn_cfg=JRPNConfig(**RPN), base_blocks=(1, 1, 1),
                              head_blocks=1).init(r, jnp.zeros((1, 64, 64, 3)),
                                                  jnp.array([64.0, 64.0])),
        jax.random.PRNGKey(0))
    det_vars = random_tree(shapes, np.random.default_rng(20), np.float64)
    jdet = JFasterRCNN(rpn_cfg=JRPNConfig(**RPN), base_blocks=(1, 1, 1), head_blocks=1,
                       dtype=jnp.float64)
    det = FasterRCNN(rpn_cfg=RPNConfig(**RPN), base_blocks=(1, 1, 1), head_blocks=1,
                     device="cpu").double()
    det.load_state_dict(faster_rcnn_from_jax(det_vars))

    videos = []
    for seed in (5, 6):
        ann = synthetic_video_annotation(num_frames=F, objs_per_frame=OBJS, seed=seed,
                                         image_wh=IMAGE_WH, stable=True)
        fmaps = synthetic_base_fmaps(CAP[0], hw=FMAP_HW, seed=seed)
        with jax.enable_x64(True):
            jentry = jax.tree.map(jnp.asarray, jax_build_gt_entry(ann, JCap(*CAP)))
            jentry = jentry.replace(im_scale=jnp.float32(IM_SCALE))
            jentry = jax_featurize(
                jentry, jnp.asarray(fmaps),
                lambda p: jdet.apply(det_vars, p, method="head_to_tail"))
            jentry = jentry.replace(distribution=jnp.asarray(_sgcls_dist(jentry, seed)))
            jentry = jax.tree.map(np.asarray, jentry)
        entry = build_gt_entry(ann, EntryCapacity(*CAP), device="cpu")
        entry = dataclasses.replace(entry, im_scale=torch.tensor(IM_SCALE, dtype=torch.float32))
        with torch.no_grad():
            entry = featurize_gt_entry(entry, torch.from_numpy(fmaps), det.head_to_tail)
        entry = dataclasses.replace(entry, distribution=torch.from_numpy(
            _sgcls_dist(entry, seed)))
        videos.append(dict(ann=ann, fmaps=fmaps, jentry=jentry, entry=entry))
    return dict(videos=videos)


def test_featurize_gt_entry(gt_setup):
    for v in gt_setup["videos"]:
        got, want = _fields(v["entry"]), _fields(v["jentry"])
        assert np.abs(want["features"]).max() > 0 and np.abs(want["union_feat"]).max() > 0
        _assert_fields_close(got, want, atol_scale=1e-5)


def _tied_sgcls_case():
    """A GT entry (5 boxes a frame) and a distribution with ties built in:
    frame 0 has two labels twice each (the modal class is the smaller) and
    its two modal duplicates score the same in the modal column (the last
    index is kept); frame 1's modal class is unique but tied at the top of
    three boxes; frame 2 has all labels distinct (the human is modal)."""
    ann = synthetic_video_annotation(num_frames=4, objs_per_frame=4, seed=9)
    entry = build_gt_entry(ann, EntryCapacity(*CAP), device="cpu")
    n = CAP[1]
    rng = np.random.RandomState(9)
    dist = (np.round(rng.rand(n, 36) * 4) / 40).astype(np.float32)
    dist[:, 0] = 0.01
    for f in range(4):
        dist[5 * f, 0] = 0.9                       # the human of each frame
    dist[[1, 2], 7] = 0.8                          # frame 0: label 8 twice, tied
    dist[[3, 4], 10] = 0.8                         # ... and label 11 twice
    dist[[6, 7, 8], 20] = 0.7                      # frame 1: label 21 three times
    dist[[6, 7, 8], 12] = [0.5, 0.6, 0.6]          # runners-up, tied
    for i, col in zip(range(11, 15), (3, 5, 9, 13)):
        dist[i, col] = 0.95                        # frame 2: distinct labels
    dist *= to_np(entry.obj_mask)[:, None]
    return entry, dist


def _sgcls_cases():
    cases = {"tied": _tied_sgcls_case()}
    for seed in (0, 1, 2):
        ann = synthetic_video_annotation(num_frames=5, objs_per_frame=3, seed=seed)
        entry = build_gt_entry(ann, EntryCapacity(*CAP), device="cpu")
        rng = np.random.RandomState(seed)
        dist = rng.rand(CAP[1], 36).astype(np.float32)
        n = int(entry.obj_mask.sum())
        dist[: n // 2, 7] += 1.5                   # many duplicates of one class
        dist = dist / dist.sum(1, keepdims=True) * to_np(entry.obj_mask)[:, None]
        cases[f"seed{seed}"] = (entry, dist)
    return cases


@pytest.mark.parametrize("case", ["tied", "seed0", "seed1", "seed2"])
def test_sgcls_postprocess_device(case):
    entry, dist = _sgcls_cases()[case]
    jentry = JEntry(**{k: jnp.asarray(v) for k, v in _fields(entry).items()})
    want = _fields(jax_sgcls_device(jentry, jnp.asarray(dist)))
    got = _fields(sgcls_postprocess_device(entry, torch.from_numpy(dist)))
    _assert_fields_close(got, want)

    n = int(entry.obj_mask.sum())
    num_frames = int(entry.num_frames)
    o = ObjectsView(
        boxes=to_np(entry.boxes)[:n], distribution=dist[:n].copy(),
        features=np.zeros((n, 4), np.float32), mem_features=np.zeros((n, 4), np.float32),
        pred_labels=np.zeros(n, np.int64), pred_scores=np.zeros(n, np.float32),
        labels=to_np(entry.labels)[:n])
    ho, human, im_idx, pairs = sgcls_postprocess(o, num_frames)
    p = int(got["pair_mask"].sum())
    np.testing.assert_array_equal(got["pred_labels"][:n], ho.pred_labels)
    np.testing.assert_array_equal(got["scores"][:n], ho.pred_scores)
    np.testing.assert_array_equal(got["distribution"][:n], ho.distribution)
    np.testing.assert_array_equal(got["human_idx"][:num_frames], human)
    np.testing.assert_array_equal(got["im_idx"][:p], im_idx)
    np.testing.assert_array_equal(got["pair_idx"][:p], pairs)
    if case == "tied":
        labels = got["pred_labels"]
        assert labels[1] != 8 and labels[2] == 8      # the last tied duplicate stays
        assert list(labels[3:5]) == [11, 11]          # the larger tied label is not modal
        assert list(labels[6:9]) == [13, 13, 21]      # the last of the three stays


def _config(mode):
    return JConfig.for_mode(mode, **TEMPURA_KW), TempuraConfig.for_mode(mode, **TEMPURA_KW)


@pytest.fixture(scope="module")
def relation_models():
    out = {}
    for mode, seed in (("predcls", 30), ("sgcls", 31)):
        jcfg, tcfg = _config(mode)
        variables = random_tree(expected_tempura_shapes(jcfg, JEntry.zeros(JCap(*CAP))),
                                np.random.default_rng(seed), np.float64)
        port = Tempura(tcfg, device="cpu").double()
        port.load_state_dict(tempura_from_jax(variables, tcfg))
        out[mode] = (jcfg, variables, port)
    return out


@pytest.mark.parametrize("mode", ["predcls", "sgcls"])
def test_converter_round_trip(relation_models, mode):
    jcfg, variables, port = relation_models[mode]
    assert port.cfg.k == (6 if mode == "predcls" else 4)
    if mode == "sgcls":
        assert port.object_classifier.positional_encoder.pe.shape == (1, 400, 2376)
    else:
        assert not hasattr(port, "object_classifier")
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    assert_trees_equal(convert_tempura_state_dict(sd, jcfg, strict=True), variables)


def _run_both(relation_models, video, mode, device_postprocess, mem_active):
    jcfg, variables, port = relation_models[mode]
    rel_mem = (np.random.RandomState(40).randn(26, 1936) if mem_active
               else np.zeros((26, 1936)))
    obj_mem = np.zeros((36, 2376 if mode == "sgcls" else 1024))
    with jax.enable_x64(True):
        state = TrainState(
            step=jnp.zeros((), jnp.int32), params=variables["params"],
            batch_stats=variables["batch_stats"], opt_state=None,
            rel_memory=jnp.asarray(rel_mem), obj_memory=jnp.asarray(obj_mem),
            mem_active=jnp.asarray(mem_active), apply_fn=JTempura(jcfg).apply, tx=None)
        jentry = jax.tree.map(jnp.asarray, video["jentry"])
        want = JEvalPipeline(mode, JCap(*CAP), device_postprocess=device_postprocess)(
            state, jentry, jnp.asarray(video["fmaps"]), gt_entry=jentry)
    tstate = create_serving_state(port)
    tstate.rel_memory, tstate.obj_memory, tstate.mem_active = memory_from_jax(
        rel_mem, obj_mem, mem_active)
    pipe = EvalPipeline(mode, EntryCapacity(*CAP), device_postprocess=device_postprocess,
                        device="cpu")
    got = pipe(tstate, video["entry"], torch.from_numpy(video["fmaps"]),
               gt_entry=video["entry"])
    return got, want, pipe.last_route


def _scale(pred):
    return max(1.0, max(float(np.abs(np.asarray(v)).max()) for k, v in pred.items()
                        if k.endswith("distribution") or k == "boxes"))


@pytest.mark.parametrize("mode,device_postprocess,mem_active,video", [
    ("predcls", True, True, 0),
    ("predcls", True, False, 1),
    ("sgcls", True, True, 0),
    ("sgcls", True, False, 1),
    ("sgcls", False, True, 0),
])
def test_eval_pipeline(gt_setup, relation_models, mode, device_postprocess, mem_active,
                       video):
    got, want, route = _run_both(relation_models, gt_setup["videos"][video], mode,
                                 device_postprocess, mem_active)
    assert route == ("host" if not device_postprocess else "device")
    assert len(want["pair_idx"]) > 0
    assert_pred_equal(got, want, atol=1e-5 * _scale(want))


def test_sgcls_routes_agree(gt_setup, relation_models):
    """The port's device and host sgcls routes give the same discrete
    outputs on the same video."""
    video = gt_setup["videos"][1]
    port = relation_models["sgcls"][2]
    preds = {}
    for dp in (True, False):
        pipe = EvalPipeline("sgcls", EntryCapacity(*CAP), device_postprocess=dp,
                            device="cpu")
        preds[dp] = pipe(create_serving_state(port), video["entry"],
                         torch.from_numpy(video["fmaps"]), gt_entry=video["entry"])
    assert_pred_equal(preds[True], preds[False], atol=1e-5 * _scale(preds[False]))


def test_predcls_forward_is_the_relation_stage(relation_models, gt_setup):
    """predcls has no object classifier: ``Tempura.forward`` is the
    relation stage on the entry as it is."""
    port = relation_models["predcls"][2]
    entry = entry_to_torch(gt_setup["videos"][0]["jentry"])
    state = create_serving_state(port)
    with torch.no_grad():
        full = port(entry, rel_memory=state.rel_memory, obj_memory=state.obj_memory,
                    mem_active=state.mem_active)
        rel = port.relation_forward(entry, None, rel_memory=state.rel_memory,
                                    mem_active=state.mem_active)
    assert sorted(full) == sorted(rel)
    for k in rel:
        assert torch.equal(full[k], rel[k]), k


def test_other_modes_are_refused():
    with pytest.raises(NotImplementedError):
        EvalPipeline("teatgt", EntryCapacity(*CAP), device="cpu")
