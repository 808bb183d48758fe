"""The port's R/mR evaluator and temporal-consistency metric against
``vidsgg``'s, on the same pred dicts and annotations: the cases of
``test_evaluator.py`` and ``test_temporal_metric.py`` plus seeded random
videos with tied scores, in all three modes and under all three constraints.

Tolerances: the R/mR grids (``result_dict``, ``recall_at``,
``mean_recall_at``, ``calc_mrecall``) and the per-class pickles identical;
temporal scores within 1e-12.
"""

import copy

import numpy as np
import pytest

from vidsgg.data.synthetic import synthetic_video_annotation
from vidsgg.eval import evaluator as jev
from vidsgg.eval import temporal as jtemp
from vidsgg_torch.eval import evaluator as tev
from vidsgg_torch.eval import temporal as ttemp

MODES = ("predcls", "sgcls", "sgdet")
CONSTRAINTS = ("with", "semi", "no")


def _one_frame_fixture():
    """Person + 2 objects with known relations (``test_evaluator.py``)."""
    gt = [[
        {"person_bbox": np.array([[0.0, 0.0, 10.0, 10.0]]), "frame": "v/0"},
        {"bbox": np.array([20.0, 20.0, 30.0, 30.0]), "class": 3,
         "attention_relationship": [0], "spatial_relationship": [1],
         "contacting_relationship": [2, 4]},
        {"bbox": np.array([40.0, 40.0, 50.0, 50.0]), "class": 5,
         "attention_relationship": [1], "spatial_relationship": [0, 2],
         "contacting_relationship": [0]},
    ]]
    att = np.array([[0.98, 0.01, 0.01], [0.01, 0.98, 0.01]])
    spa = np.full((2, 6), 0.01)
    spa[0, 1] = spa[1, 0] = spa[1, 2] = 0.95
    con = np.full((2, 17), 0.01)
    con[0, 2] = con[0, 4] = con[1, 0] = 0.95
    pred = {
        "boxes": np.array([[0.0, 0.0, 0.0, 10.0, 10.0], [0.0, 20.0, 20.0, 30.0, 30.0],
                           [0.0, 40.0, 40.0, 50.0, 50.0]]),
        "labels": np.array([1, 3, 5]),
        "scores": np.array([1.0, 1.0, 1.0]),
        "pred_labels": np.array([1, 3, 5]),
        "pred_scores": np.array([1.0, 1.0, 1.0]),
        "im_idx": np.array([0, 0]),
        "pair_idx": np.array([[0, 1], [0, 2]]),
        "attention_distribution": att,
        "spatial_distribution": spa,
        "contacting_distribution": con,
    }
    return gt, pred


def _fixture_case(name):
    gt, pred = _one_frame_fixture()
    if name == "displaced":          # object A moved: IoU < 0.5
        pred["boxes"] = pred["boxes"].copy()
        pred["boxes"][1, 1:] += 25.0
    elif name == "misclassified":    # object B predicted as class 7 (sgcls)
        pred["pred_labels"] = np.array([1, 3, 7])
        pred["pred_scores"] = np.array([0.9, 0.9, 0.9])
    elif name == "two_frames":
        gt = gt + gt
        pred["im_idx"] = np.array([0, 0, 1, 1])
        pred["pair_idx"] = np.array([[0, 1], [0, 2], [0, 1], [0, 2]])
        for k in ("attention_distribution", "spatial_distribution",
                  "contacting_distribution"):
            pred[k] = np.concatenate([pred[k], pred[k]], 0)
    return gt, pred


def _random_case(seed, mode, frames=6, objs=3):
    """A synthetic annotation and a pred dict scored on it: scores quantised
    to quarters so that ties occur everywhere (the 'no' constraint's top-100
    and the triplet order break them by numpy's unstable argsort); sgcls
    mislabels some objects; sgdet jitters the boxes, adds a box per frame
    and lets some pairs miss their GT."""
    gt = synthetic_video_annotation(num_frames=frames, objs_per_frame=objs, seed=seed)
    rng = np.random.RandomState(1000 + seed)
    boxes, labels, im_idx, pair_idx = [], [], [], []
    for f, frame in enumerate(gt):
        human = len(boxes)
        boxes.append([f, *np.asarray(frame[0]["person_bbox"]).reshape(-1)[:4]])
        labels.append(1)
        for obj in frame[1:]:
            pair_idx.append([human, len(boxes)])
            im_idx.append(f)
            boxes.append([f, *obj["bbox"]])
            labels.append(obj["class"])
        if mode == "sgdet":
            x, y = rng.randint(0, 300, 2)
            pair_idx.append([human, len(boxes)])
            im_idx.append(f)
            boxes.append([f, x, y, x + 40, y + 30])
            labels.append(int(rng.randint(2, 37)))
    boxes = np.array(boxes, np.float64)
    labels = np.array(labels)
    pred_labels = labels.copy()
    if mode != "predcls":
        flip = (rng.rand(len(labels)) < 0.2) & (labels != 1)
        pred_labels[flip] = rng.randint(2, 37, int(flip.sum()))
    if mode == "sgdet":
        boxes[:, 1:] += np.round(rng.randn(len(boxes), 4) * 3)
    p = len(pair_idx)

    def quarters(*shape):
        return np.round(rng.rand(*shape) * 4) / 4

    pred = {
        "boxes": boxes,
        "labels": labels,
        "scores": np.ones(len(labels)),
        "pred_labels": pred_labels,
        "pred_scores": np.maximum(quarters(len(labels)), 0.25),
        "im_idx": np.array(im_idx),
        "pair_idx": np.array(pair_idx),
        "attention_distribution": quarters(p, 3),
        "spatial_distribution": quarters(p, 6),
        "contacting_distribution": quarters(p, 17),
    }
    return gt, pred


def _grid(evaluators, gt_pred_list, output_dir=None):
    """Run videos through each evaluator; -> comparable grids."""
    out = []
    for ev in evaluators:
        for gt, pred in gt_pred_list:
            ev.evaluate_scene_graph(gt, copy.deepcopy(pred))
        ks = ev.KS
        out.append(dict(
            result_dict=copy.deepcopy(ev.result_dict),
            recall=[ev.recall_at(k) for k in ks],
            mean_recall=[ev.mean_recall_at(k) for k in ks],
            mrecall=ev.calc_mrecall(),
            per_class=copy.deepcopy(ev.per_class_recall),
        ))
        if output_dir is not None:
            ev.print_stats(metric="test")
    return out


def _assert_grids_equal(mode, cases, tmp_path=None, **kw):
    dirs = (None, None) if tmp_path is None else (tmp_path / "jax", tmp_path / "torch")
    want = _grid(jev.get_ag_evaluators(mode, output_dir=dirs[0], **kw), cases, dirs[0])
    got = _grid(tev.get_ag_evaluators(mode, output_dir=dirs[1], **kw), cases, dirs[1])
    assert got == want
    return got


@pytest.mark.parametrize("name", ["plain", "displaced", "misclassified", "two_frames"])
@pytest.mark.parametrize("mode", MODES)
def test_fixture_grids_identical(name, mode):
    got = _assert_grids_equal(mode, [_fixture_case(name)])
    if name == "plain":   # the values test_evaluator.py asserts
        with_c, semi, no = got
        assert np.isclose(with_c["recall"][0], 6.0 / 8.0)
        assert np.isclose(semi["recall"][0], 1.0)
        assert np.isclose(no["recall"][3], 1.0)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_tied_grids_identical(mode, seed):
    cases = [_random_case(seed * 10 + v, mode) for v in range(3)]
    got = _assert_grids_equal(mode, cases)
    assert any(0.0 < r < 1.0 for g in got for r in g["recall"])


@pytest.mark.parametrize("constraint", CONSTRAINTS)
def test_constraint_alone_and_semithreshold(constraint):
    """A single evaluator per constraint (with a non-default semithreshold
    and IoU threshold) gives the same grid."""
    cases = [_random_case(40 + v, "sgdet") for v in range(2)]
    kw = dict(constraint=constraint, semithreshold=0.7, iou_threshold=0.4)
    want = _grid([jev.SceneGraphEvaluator("sgdet", **kw)], cases)
    got = _grid([tev.SceneGraphEvaluator("sgdet", **kw)], cases)
    assert got == want


@pytest.mark.parametrize("mode", MODES)
def test_per_class_pickles_identical(mode, tmp_path):
    cases = [_random_case(70 + v, mode) for v in range(2)]
    _assert_grids_equal(mode, cases, tmp_path)
    want = sorted(p.name for p in (tmp_path / "jax").iterdir())
    got = sorted(p.name for p in (tmp_path / "torch").iterdir())
    assert got == want and len(want) == 3 * 4
    for name in want:
        assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_helpers_identical():
    rng = np.random.RandomState(3)
    scores = np.round(rng.rand(30, 26) * 4) / 4          # heavy ties
    np.testing.assert_array_equal(tev.argsort_desc(scores), jev.argsort_desc(scores))
    a, b = rng.randint(0, 3, (20, 3)), rng.randint(0, 3, (15, 3))
    np.testing.assert_array_equal(tev.intersect_2d(a, b), jev.intersect_2d(a, b))
    boxes = np.round(rng.rand(12, 4) * 50)
    boxes[:, 2:] += boxes[:, :2]
    np.testing.assert_array_equal(tev.np_bbox_overlaps(boxes, boxes[::-1]),
                                  jev.np_bbox_overlaps(boxes, boxes[::-1]))
    with pytest.raises(ValueError):
        tev.intersect_2d(a, b[:, :2])


# ---------------------------------------------------------------------------
# temporal consistency
# ---------------------------------------------------------------------------


def _pairs(p):
    return np.stack([np.arange(p) * 2, np.arange(p) * 2 + 1], 1)


@pytest.mark.parametrize("tb,gt,window", [
    ([True] * 8, [2] * 8, 6),
    ([True] * 12, [1] * 5 + [2] * 7, 6),
    ([True] * 12, [2] * 8 + [5] * 4, 6),
    ([True] * 4, [1] * 4, 6),
    ([True, False] * 10, [3] * 20, 2),
    ([], [], 6),
])
def test_find_consecutive_duplicates_identical(tb, gt, window):
    assert (ttemp.find_consecutive_duplicates(tb, gt, window)
            == jtemp.find_consecutive_duplicates(tb, gt, window))


def _temporal_cases():
    p = 10
    rng = np.random.RandomState(0)
    labels = np.array([1, 4] * 8)
    labels[2 * 3 + 1] = 1          # an object predicted as person (sgcls)
    return {
        "confident": ({
            "spatial_gt": [[1]] * p, "contacting_gt": [[3]] * p,
            "spatial_distribution": np.tile(np.eye(6)[1] * 5.0, (p, 1)),
            "contacting_distribution": np.tile(np.eye(17)[3] * 5.0, (p, 1)),
            "pred_labels": np.array([1, 4] * p), "pair_idx": _pairs(p),
        }, "predcls", 6),
        "random": ({
            "spatial_gt": [[2]] * 8, "contacting_gt": [[0]] * 8,
            "spatial_distribution": rng.rand(8, 6),
            "contacting_distribution": np.zeros((8, 17)),
            "pred_labels": np.array([1, 9] * 8), "pair_idx": _pairs(8),
        }, "predcls", 6),
        "person_mislabel": ({
            "spatial_gt": [[1]] * 8, "contacting_gt": [[3]] * 8,
            "spatial_distribution": np.tile(np.eye(6)[1] * 5.0, (8, 1)),
            "contacting_distribution": np.tile(np.eye(17)[3] * 5.0, (8, 1)),
            "pred_labels": labels, "pair_idx": _pairs(8),
        }, "sgcls", 3),
    }


@pytest.mark.parametrize("name", ["confident", "random", "person_mislabel"])
def test_temporal_scores_match(name):
    pred, mode, window = _temporal_cases()[name]
    ws, wc = jtemp.evaluate_temporal_consistency(pred, mode, window)
    gs, gc = ttemp.evaluate_temporal_consistency(pred, mode, window)
    assert len(gs) == len(ws) and len(gc) == len(wc) and len(ws) > 0
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-12)
    np.testing.assert_allclose(gc, wc, rtol=0, atol=1e-12)
    got = ttemp.temporal_consistency_summary(gs, gc)
    want = jtemp.temporal_consistency_summary(ws, wc)
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, k


@pytest.mark.parametrize("seed,objs", [(0, 1), (1, 1), (0, 3)])
def test_temporal_on_stable_video_matches(seed, objs):
    """A stable synthetic video scored with random distributions, scores
    within 1e-12. The metric scans the flat frame-major pair list, so it
    finds intervals with one object per frame, and none with three objects
    of distinct classes (a run needs 7 consecutive pairs of one class)."""
    gt = synthetic_video_annotation(num_frames=16, objs_per_frame=objs, seed=seed, stable=True)
    rng = np.random.RandomState(seed)
    labels, pairs, sp, con = [], [], [], []
    for frame in gt:
        human = len(labels)
        labels.append(1)
        for obj in frame[1:]:
            pairs.append([human, len(labels)])
            labels.append(obj["class"])
            sp.append(list(obj["spatial_relationship"]))
            con.append(list(obj["contacting_relationship"]))
    pred = {"spatial_gt": sp, "contacting_gt": con, "pred_labels": np.array(labels),
            "pair_idx": np.array(pairs),
            "spatial_distribution": rng.rand(len(pairs), 6),
            "contacting_distribution": rng.rand(len(pairs), 17)}
    ws, wc = jtemp.evaluate_temporal_consistency(pred, "predcls")
    gs, gc = ttemp.evaluate_temporal_consistency(pred, "predcls")
    assert (len(ws) + len(wc) > 0) == (objs == 1)
    assert len(gs) == len(ws) and len(gc) == len(wc)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-12)
    np.testing.assert_allclose(gc, wc, rtol=0, atol=1e-12)


def test_temporal_sgdet_and_permuted_order():
    assert ttemp.evaluate_temporal_consistency({}, "sgdet") == (None, None)
    p = 8
    pred = {
        "spatial_gt": [[1]] * p, "contacting_gt": [[3]] * p,
        "spatial_distribution": np.zeros((p, 6)),
        "contacting_distribution": np.zeros((p, 17)),
        "pred_labels": np.array(([1, 4] * (p // 2)) + ([1, 9] * (p // 2))),
        "pair_idx": np.concatenate([_pairs(p)[p // 2:], _pairs(p)[: p // 2]]),
    }
    with pytest.raises(ValueError, match="person-first"):
        jtemp.evaluate_temporal_consistency(pred, "predcls", window=6)
    with pytest.raises(ValueError, match="person-first"):
        ttemp.evaluate_temporal_consistency(pred, "predcls", window=6)
    assert np.isnan(ttemp.temporal_consistency_summary([], [])["combined"])
