"""bfloat16 serving of TEMPURA: ``EvalPipeline(compute_dtype=torch.bfloat16)``
against ``vidsgg``'s ``EvalPipeline(compute_dtype=jnp.bfloat16)`` on the
same entries (``vidsgg``'s) with the same float32 weights carried across,
one-layer TEMPURA at full width; the bfloat16 grouped NMS, the device and
host postprocesses and the evaluator on ``vidsgg``'s own bfloat16 inputs.

Tolerances:
* the whole pipeline (predcls; sgcls on both routes; sgdet on the fused
  and the host route): the same fields held bfloat16 values as in
  ``vidsgg`` (``bf16_fields``), every discrete output exact, floats atol
  2**-6 x max(1, max|ref|), four bfloat16 ulps at 1 (products and
  normalisations sum in another order before each rounding); and the
  port's bfloat16 against its own float32 held to ``vidsgg``'s bar for
  bfloat16 serving (``tests/test_sgdet_eval_fused.py``): label agreement
  > 0.9, distributions within atol 0.08;
* the grouped NMS on bfloat16 boxes and scores (IoUs within one bfloat16
  ulp of bfloat16(0.6) = 0.6015625, tied scores), the device
  postprocesses on ``vidsgg``'s bfloat16 classifier output, and the host
  postprocess on ``vidsgg``'s ``ml_dtypes`` arrays: exact;
* the evaluator given ``vidsgg``'s bfloat16 pred values (float32 arrays
  marked ``bf16_fields``): grids, per-class pickles and temporal scores
  identical to ``vidsgg``'s on its ``ml_dtypes`` dict.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch_parity_utils import entry_to_torch, random_tree, to_np

import vidsgg.eval.evaluator as jeval
import vidsgg.eval.temporal as jtemp
import vidsgg.models.postprocess as jpost
import vidsgg_torch.eval.evaluator as teval
import vidsgg_torch.eval.temporal as ttemp
import vidsgg_torch.models.postprocess as tpost
from vidsgg.data import build_gt_entry as jax_build_gt_entry
from vidsgg.data import synthetic_video_annotation as jax_annotation
from vidsgg.data.entry import Entry as JEntry
from vidsgg.data.entry import EntryCapacity as JCap
from vidsgg.detector.faster_rcnn import FasterRCNN as JFasterRCNN
from vidsgg.detector.rpn import RPNConfig as JRPNConfig
from vidsgg.detector.sgdet import SgdetCaps as JCaps
from vidsgg.detector.sgdet import SgdetFrontend as JFrontend
from vidsgg.models import postprocess_device as jpd
from vidsgg.models.convert_relation import expected_tempura_shapes
from vidsgg.models.tempura import Tempura as JTempura
from vidsgg.models.tempura import TempuraConfig as JConfig
from vidsgg.train.eval_pipeline import EvalPipeline as JEvalPipeline
from vidsgg.train.eval_pipeline import _cast_floating, cast_state_for_serving
from vidsgg.train.state import TrainState
from vidsgg_torch.convert import memory_from_jax, tempura_from_jax
from vidsgg_torch.data.entry import EntryCapacity
from vidsgg_torch.eval.adapter import BF16_FIELDS
from vidsgg_torch.models import Tempura, TempuraConfig
from vidsgg_torch.models import postprocess_device as tpd
from vidsgg_torch.ops.nms import grouped_nms
from vidsgg_torch.train import EvalPipeline, create_serving_state
from vidsgg_torch.train.eval_pipeline import cast_floating

BF16 = ml_dtypes.bfloat16
BF16_ATOL = 2.0 ** -6
KW = dict(obj_head="linear", rel_head="gmm", enc_layers=1, dec_layers=1, track_layers=1)
GT_CAP, F = (8, 32, 24), 6
DF, DH, DW, DETS = 4, 160, 256, 8
SGDET_CAP = (DF, DF * DETS, 48)
FLOATS = ("boxes", "scores", "pred_scores", "attention_distribution",
          "spatial_distribution", "contacting_distribution")


def _gt_video(seed):
    """A GT-box entry (float32): seeded features of four prototypes, a
    detector-style class distribution, union features and spatial masks
    for predcls, base maps for sgcls's union pooling."""
    ann = jax_annotation(num_frames=F, objs_per_frame=3, seed=seed, stable=True)
    e = jax_build_gt_entry(ann, JCap(*GT_CAP))
    rng = np.random.RandomState(seed)
    n = GT_CAP[1]
    om, pm = np.asarray(e.obj_mask), np.asarray(e.pair_mask)
    feats = (rng.randn(4, 2048)[np.arange(n) % 4] + 0.3 * rng.randn(n, 2048)) * om[:, None]
    logits = rng.randn(n, 36)
    logits[np.arange(n), np.clip(np.asarray(e.labels) - 1, 0, 35)] += 4.0
    dist = np.exp(logits) / np.exp(logits).sum(1, keepdims=True) * om[:, None]
    fmaps = rng.randn(GT_CAP[0], 12, 20, 1024).astype(np.float32)
    union = 0.5 * rng.randn(GT_CAP[2], 7, 7, 1024) * pm[:, None, None, None]
    masks = (rng.rand(GT_CAP[2], 2, 27, 27) - 0.5) * pm[:, None, None, None]
    e = e.replace(features=feats.astype(np.float32), distribution=dist.astype(np.float32),
                  pred_labels=np.asarray(e.labels), im_scale=np.float32(2.0 / 3.0),
                  union_feat=union.astype(np.float32), spatial_masks=masks.astype(np.float32))
    return ann, jax.tree.map(np.asarray, e), fmaps


@pytest.fixture(scope="module")
def videos():
    """predcls/sgcls: a GT-box video; sgdet: one video through ``vidsgg``'s
    float32 ``SgdetFrontend`` (shrunk ResNet)."""
    rpn = dict(pre_nms_top_n=600, post_nms_top_n=16)
    jdet = JFasterRCNN(rpn_cfg=JRPNConfig(**rpn), base_blocks=(1, 1, 1), head_blocks=1)
    shapes = jax.eval_shape(
        lambda r: jdet.init(r, jnp.zeros((1, 64, 64, 3)), jnp.array([64.0, 64.0])),
        jax.random.PRNGKey(0))
    det_vars = random_tree(shapes, np.random.default_rng(10), np.float32)
    det_vars["params"]["cls_score"]["kernel"] *= 8.0
    frames = (np.random.RandomState(12).randn(DF, DH, DW, 3) * 40.0).astype(np.float32)
    jentry, jfmaps = JFrontend(jdet, det_vars, JCaps(dets_per_frame=DETS), JCap(*SGDET_CAP))(
        jnp.asarray(frames), jnp.asarray((float(DH), float(DW))), 1.0,
        video_size=(float(DW), float(DH)))
    ann = jax_annotation(num_frames=DF, objs_per_frame=3, seed=13, image_wh=(DW, DH))
    gt = _gt_video(5)
    return {"gt": gt, "sgdet": (ann, jax.tree.map(np.asarray, jentry), np.asarray(jfmaps))}


@pytest.fixture(scope="module")
def relation_models():
    out = {}
    for mode, seed in (("predcls", 30), ("sgcls", 31), ("sgdet", 11)):
        jcfg, tcfg = JConfig.for_mode(mode, **KW), TempuraConfig.for_mode(mode, **KW)
        cap = SGDET_CAP if mode == "sgdet" else GT_CAP
        variables = random_tree(expected_tempura_shapes(jcfg, JEntry.zeros(JCap(*cap))),
                                np.random.default_rng(seed), np.float32)
        port = Tempura(tcfg, device="cpu")
        port.load_state_dict(tempura_from_jax(variables, tcfg))
        obj = np.zeros((36, 1024 if mode == "predcls" else 2376), np.float32)
        rel = np.random.RandomState(40).randn(26, 1936).astype(np.float32)
        state = TrainState(
            step=jnp.zeros((), jnp.int32), params=variables["params"],
            batch_stats=variables["batch_stats"], opt_state=None, rel_memory=jnp.asarray(rel),
            obj_memory=jnp.asarray(obj), mem_active=jnp.asarray(True),
            apply_fn=JTempura(jcfg).apply, tx=None)
        tstate = create_serving_state(port)
        tstate.rel_memory, tstate.obj_memory, tstate.mem_active = memory_from_jax(rel, obj, True)
        out[mode] = (jcfg, state, tstate)
    return out


def _pipelines(relation_models, videos, mode, route):
    jcfg, state, tstate = relation_models[mode]
    ann, jentry, fmaps = videos["sgdet" if mode == "sgdet" else "gt"]
    cap = SGDET_CAP if mode == "sgdet" else GT_CAP
    kw = {}
    if mode == "sgcls":
        kw = dict(device_postprocess=route == "device")
    elif mode == "sgdet":   # two pairs a frame overflow the grouped pooling
        kw = dict(union_pairs_per_frame=2 * DETS if route == "device" else 2)
    jje = jax.tree.map(jnp.asarray, jentry)
    want = JEvalPipeline(mode, JCap(*cap), compute_dtype=jnp.bfloat16, **kw)(
        state, jje, jnp.asarray(fmaps), gt_entry=jje)
    entry = entry_to_torch(jentry)
    got = {}
    for dtype in (torch.bfloat16, None):
        pipe = EvalPipeline(mode, EntryCapacity(*cap), device="cpu", compute_dtype=dtype, **kw)
        got[dtype] = pipe(tstate, entry, torch.from_numpy(fmaps), gt_entry=entry)
        assert pipe.last_route == route
    return ann, got[torch.bfloat16], got[None], want


ROUTES = [("predcls", "device"), ("sgcls", "device"), ("sgcls", "host"), ("sgdet", "device"),
          ("sgdet", "host")]


@pytest.mark.parametrize("mode,route", ROUTES)
def test_bf16_pipeline(relation_models, videos, mode, route):
    _, got, got32, want = _pipelines(relation_models, videos, mode, route)
    assert len(want["pair_idx"]) > 0
    bf16_fields = tuple(k for k in FLOATS if want[k].dtype == BF16)
    assert got.pop(BF16_FIELDS, ()) == bf16_fields and BF16_FIELDS not in got32
    assert sorted(got) == sorted(want)
    for k in ("labels", "im_idx", "pair_idx", "pred_labels"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("attention_gt", "spatial_gt", "contacting_gt"):
        assert got[k] == want[k], k
    scale = max(1.0, max(float(np.abs(np.asarray(want[k], np.float64)).max()) for k in FLOATS))
    for k in FLOATS:
        np.testing.assert_allclose(got[k], np.asarray(want[k], np.float32), rtol=0,
                                   atol=BF16_ATOL * scale, err_msg=k)
    # the port's bfloat16 against its float32: vidsgg's own bar
    assert np.mean(got["pred_labels"] == got32["pred_labels"]) > 0.9
    np.testing.assert_array_equal(got["pair_idx"], got32["pair_idx"])
    for k in FLOATS[3:]:
        np.testing.assert_allclose(got[k], got32[k], rtol=0, atol=0.08, err_msg=k)


def _bf16_case(n, seed):
    """bfloat16 boxes and scores (as float32 arrays holding them) with tied
    scores and pairs whose bfloat16 IoU sits within one ulp of 0.6015625."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 200, (n, 2))
    wh = rng.uniform(20, 60, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1)
    # partners: the same box shifted so the IoU lands near 0.6
    for i in range(0, n - 1, 4):
        w, h = boxes[i, 2:] - boxes[i, :2] + 1
        dx = w * (1 - 0.6) / (1 + 0.6) + rng.uniform(-1.5, 1.5)
        boxes[i + 1] = boxes[i] + np.array([dx, 0, dx, 0])
    boxes = boxes.astype(BF16).astype(np.float32)
    scores = (np.round(rng.rand(n) * 16) / 16).astype(BF16).astype(np.float32)   # ties
    group = rng.randint(0, 3, n)
    valid = rng.rand(n) < 0.9
    return boxes, scores, group, valid


@pytest.mark.parametrize("n,seed", [(64, 0), (200, 1), (512, 2)])
def test_bf16_grouped_nms_exact(n, seed):
    boxes, scores, group, valid = _bf16_case(n, seed)
    iou = np.asarray(jpd._pairwise_iou(jnp.asarray(boxes, jnp.bfloat16)), np.float32)
    near = {0.59765625, 0.6015625, 0.60546875}
    assert sum(np.isin(iou[np.triu_indices(n, 1)], list(near))) >= 3
    assert len(np.unique(scores[valid])) < valid.sum() // 2
    jkeep, jrank = jpd._grouped_nms(jnp.asarray(boxes, jnp.bfloat16),
                                    jnp.asarray(scores, jnp.bfloat16), jnp.asarray(group),
                                    jnp.asarray(valid), 0.6)
    keep, rank = grouped_nms(torch.from_numpy(boxes).bfloat16(),
                             torch.from_numpy(scores).bfloat16(), torch.from_numpy(group),
                             torch.from_numpy(valid), 0.6)
    np.testing.assert_array_equal(to_np(keep), np.asarray(jkeep))
    np.testing.assert_array_equal(to_np(rank), np.asarray(jrank))
    # the bfloat16 threshold decides: float32 arithmetic keeps another set
    keep32, _ = grouped_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                            torch.from_numpy(group), torch.from_numpy(valid), 0.6)
    if n == 512:
        assert not torch.equal(keep32, keep)


def _classified(relation_models, videos, mode):
    """``vidsgg``'s bfloat16 entry and its bfloat16 OSPU output."""
    jcfg, state, _ = relation_models[mode]
    _, jentry, _ = videos["sgdet" if mode == "sgdet" else "gt"]
    st = cast_state_for_serving(state, jnp.bfloat16)
    je = _cast_floating(jax.tree.map(jnp.asarray, jentry), jnp.bfloat16)
    aux = jax.jit(lambda s, e: s.apply_fn({"params": s.params, "batch_stats": s.batch_stats},
                                          e, phase="test", obj_memory=s.obj_memory,
                                          mem_active=s.mem_active,
                                          method="classify_objects"))(st, je)
    assert aux["distribution"].dtype == jnp.bfloat16
    return je, aux


def _fields(entry):
    return {f.name: np.asarray(to_np(getattr(entry, f.name).float())
                               if getattr(entry, f.name).dtype == torch.bfloat16
                               else to_np(getattr(entry, f.name)))
            for f in dataclasses.fields(entry)}


@pytest.mark.parametrize("mode", ["sgcls", "sgdet"])
def test_bf16_device_postprocess_exact(relation_models, videos, mode):
    je, aux = _classified(relation_models, videos, mode)
    entry = cast_floating(entry_to_torch(jax.tree.map(lambda a: np.asarray(a, np.float32)
                                                      if a.dtype == jnp.bfloat16 else
                                                      np.asarray(a), je)), torch.bfloat16)
    dist = torch.from_numpy(np.asarray(aux["distribution"], np.float32)).bfloat16()
    if mode == "sgcls":
        want = jax.jit(jpd.sgcls_postprocess_device)(je, aux["distribution"])
        got = tpd.sgcls_postprocess_device(entry, dist)
        extra = ()
    else:
        mem = torch.from_numpy(np.asarray(aux["object_mem_features"], np.float32)).bfloat16()
        want, wmem, wovf = jax.jit(jpd.sgdet_postprocess_device)(
            je, aux["distribution"], aux["object_mem_features"])
        got, gmem, govf = tpd.sgdet_postprocess_device(entry, dist, mem)
        assert bool(govf) == bool(wovf)
        extra = ((to_np(gmem.float()), np.asarray(wmem, np.float32)),)
    g, w = _fields(got), {k: np.asarray(v) for k, v in dataclasses.asdict(want).items()}
    assert int(w["pair_mask"].sum()) > 0
    for k in w:
        assert getattr(got, k).dtype == getattr(torch, str(w[k].dtype)), k
        np.testing.assert_array_equal(g[k], np.asarray(w[k], g[k].dtype), err_msg=k)
    for a, b in extra:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["sgcls", "sgdet"])
def test_bf16_host_postprocess_exact(relation_models, videos, mode):
    """``vidsgg``'s host postprocess on ``ml_dtypes`` arrays against the
    port's on float32 arrays holding the same values."""
    je, aux = _classified(relation_models, videos, mode)
    n = int(np.asarray(je.obj_mask).sum())

    def view(mod, cast):
        return mod.ObjectsView(
            boxes=cast(je.boxes)[:n], distribution=cast(aux["distribution"])[:n].copy(),
            features=cast(je.features)[:n], mem_features=cast(aux["object_mem_features"])[:n],
            pred_labels=np.asarray(je.pred_labels)[:n].astype(np.int64),
            pred_scores=np.zeros(n, np.float32), labels=np.asarray(je.labels)[:n])

    num_frames = int(np.asarray(je.num_frames))
    jo = view(jpost, np.asarray)
    to = view(tpost, lambda a: np.asarray(a, np.float32))
    if mode == "sgcls":
        want = jpost.sgcls_postprocess(jo, num_frames)
        got = tpost.sgcls_postprocess(to, num_frames)
    else:
        want = jpost.sgdet_postprocess(jo, num_frames)
        got = tpost.sgdet_postprocess(to, num_frames, bf16=True)
    for g, w in zip(got[1:], want[1:], strict=True):
        np.testing.assert_array_equal(g, w)
    for f in dataclasses.fields(jpost.ObjectsView):
        np.testing.assert_array_equal(getattr(got[0], f.name),
                                      np.asarray(getattr(want[0], f.name), np.float32)
                                      if getattr(want[0], f.name).dtype == BF16
                                      else getattr(want[0], f.name), err_msg=f.name)


@pytest.mark.parametrize("n,seed", [(64, 0), (200, 1)])
def test_bf16_host_nms_exact(n, seed):
    """The host route's greedy NMS on ``ml_dtypes`` boxes against the
    port's on float32 arrays holding them (``bf16=True``), with IoUs near
    the threshold; read as float32 arithmetic the larger case keeps another
    set."""
    boxes, scores, _, _ = _bf16_case(n, seed)
    want = jpost._greedy_nms(boxes.astype(BF16), scores.astype(BF16), 0.6)
    got = tpost._greedy_nms(boxes, scores, 0.6, bf16=True)
    np.testing.assert_array_equal(got, want)
    if n == 200:
        assert not np.array_equal(tpost._greedy_nms(boxes, scores, 0.6), want)


def _tied_bf16_pred(order_seed: int):
    """A one-frame pred dict of ``ml_dtypes.bfloat16`` floats on the GT
    boxes of 101 objects, each pair scored at its GT attention predicate
    alone, whose "no"-constraint top 100 turns on a bfloat16 tie: with the
    person's score 0.8984375, objects scored 0.74609375 (labelled right)
    and 0.75 (labelled wrong) have score products 0.6703 and 0.6738 in
    float32 but 0.671875 both in bfloat16, at ranks 100 and 101 behind 99
    objects scored higher. ``order_seed`` shuffles the pair list."""
    objs = 101
    ann = jax_annotation(num_frames=1, objs_per_frame=objs, seed=4, stable=True)
    frame = ann[0]
    obj_scores = np.r_[np.linspace(1.0, 0.8, objs - 2), 0.74609375, 0.75]
    right = np.r_[np.ones(objs - 1, bool), False]
    boxes = [np.r_[0, np.asarray(frame[0]["person_bbox"]).reshape(-1)[:4]]]
    boxes += [np.r_[0, np.asarray(o["bbox"], float)] for o in frame[1:]]
    labels = [1] + [int(o["class"]) + (0 if ok else 1) for o, ok in zip(frame[1:], right)]
    scores = np.r_[0.8984375, obj_scores].astype(BF16)
    pairs = np.random.RandomState(order_seed).permutation(objs) + 1
    att = np.zeros((objs, 3))        # the GT attention predicate of each object
    att[np.arange(objs), [int(np.ravel(frame[k]["attention_relationship"])[0])
                          for k in pairs]] = 0.5
    pred = {
        "boxes": np.array(boxes).astype(BF16), "labels": np.array(labels), "scores": scores,
        "pred_labels": np.array(labels), "pred_scores": scores, "im_idx": np.zeros(objs, int),
        "pair_idx": np.stack([np.zeros(objs, int), pairs], 1),
        "attention_distribution": att.astype(BF16),
        "spatial_distribution": np.zeros((objs, 6), BF16),
        "contacting_distribution": np.zeros((objs, 17), BF16),
        "attention_gt": [[0]] * objs, "spatial_gt": [[1]] * objs,
        "contacting_gt": [[2]] * objs,
    }
    return ann, pred


def _as_port(pred):
    """The port's form of a bfloat16 pred dict: float32 arrays + marks."""
    out = {k: (np.asarray(v, np.float32) if getattr(v, "dtype", None) == BF16 else v)
           for k, v in pred.items()}
    out[BF16_FIELDS] = tuple(k for k in FLOATS if pred[k].dtype == BF16)
    return out


def _grids(module, mode, cases, output_dir):
    out = []
    for ev in module.get_ag_evaluators(mode, output_dir=str(output_dir)):
        for ann, pred in cases:
            ev.evaluate_scene_graph(ann, copy.deepcopy(pred))
        out.append((copy.deepcopy(ev.result_dict), [ev.recall_at(k) for k in ev.KS],
                    [ev.mean_recall_at(k) for k in ev.KS]))
        ev.print_stats(metric=ev.constraint)
    return out


@pytest.mark.parametrize("mode", ["predcls", "sgcls", "sgdet"])
def test_bf16_evaluator_on_vidsgg_values(relation_models, videos, mode, tmp_path):
    """vidsgg's bfloat16 pred dicts (its pipeline's, and two whose "no"
    ranking turns on a bfloat16 tie) through both evaluators and temporal
    metrics."""
    ann, _, _, want = _pipelines(relation_models, videos, mode, "device")
    cases = [(ann, want)] + [_tied_bf16_pred(seed) for seed in (0, 1)]
    assert all(v["pred_scores"].dtype == BF16 for _, v in cases)
    jg = _grids(jeval, mode, cases, tmp_path / "jax")
    tg = _grids(teval, mode, [(a, _as_port(p)) for a, p in cases], tmp_path / "torch")
    assert tg == jg
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "torch").iterdir()) and names
    for name in names:
        assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    # the tie decides: read as float32 values, the first tied case scores lower
    unmarked = {k: v for k, v in _as_port(cases[1][1]).items() if k != BF16_FIELDS}
    no_f32 = teval.get_ag_evaluators(mode)[2]
    no_f32.evaluate_scene_graph(cases[1][0], unmarked)
    no_bf16 = teval.get_ag_evaluators(mode)[2]
    no_bf16.evaluate_scene_graph(cases[1][0], _as_port(cases[1][1]))
    assert no_f32.recall_at(100) < no_bf16.recall_at(100)
    for a, p in cases[:1]:     # the tied cases' shuffled pairs are not frame-major
        js = jtemp.evaluate_temporal_consistency(p, mode)
        ts = ttemp.evaluate_temporal_consistency(_as_port(p), mode)
        for x, y in zip(ts, js, strict=True):
            assert (x is None and y is None) or np.array_equal(x, y)
