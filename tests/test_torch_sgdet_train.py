"""sgdet training in the port against ``vidsgg``'s: the train frontend (the
greedy GT assignment, the SUPPLY rows, the row plan, the device pack), two
train steps on its entries, and the train source's order and skips.

The detector is ``vidsgg``'s tiny one of ``tests/test_sgdet_train.py``
(``base_blocks=(1, 1, 1)``, one head block, RPN 64 / 16, ``SgdetCaps(8,
16)``, ``EntryCapacity(4, 32, 16)``, two 64x96 frames a video) with seeded
weights (the class layer scaled so that boxes pass the score threshold),
carried across by ``convert.py``, in float64 on both sides. Tolerances:

* ``assign_relations`` on crafted frames (a collision of two GT boxes on
  one detection, a frame without detections, a frame where every GT box
  is supplied) and the plan, given the same host arrays: exactly equal;
* the train entry of the whole frontend: every discrete field exactly,
  floating fields within 1e-5 x max(1, max|ref|) (both stacks round the
  head's output and the ROIAlign weights to float32, as ``vidsgg`` does);
* two sgdet train steps on ``vidsgg``'s entries in float64, the port on
  ``vidsgg``'s dropout masks and GMM noise: losses, ``grad_norm`` and every
  parameter at 1e-8;
* two TEAT-GT sgdet train steps on ``vidsgg``'s entries, as
  ``test_torch_teatgt_train_modes.py`` holds sgcls's;
* the train source (``make_sgdet_source(is_train=True)``) over three
  epochs: the order of the videos and the skip count equal to ``vidsgg``'s
  (a video over the entry's frames, and one whose plan raises).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_teatgt_train_modes import SGDET_CLIPS, float64_entry, lock_step
from test_torch_train_sgcls import _models
from torch_parity_utils import entry_to_torch, random_tree
from train_parity_utils import SharedNoise, close, compare_state

import vidsgg.cli.data_source as jds
from vidsgg.data.entry import Entry as JEntry
from vidsgg.data.entry import EntryCapacity as JCap
from vidsgg.data.synthetic import synthetic_video_annotation
from vidsgg.detector import sgdet as jsgdet
from vidsgg.detector.faster_rcnn import FasterRCNN as JFasterRCNN
from vidsgg.detector.rpn import RPNConfig as JRPNConfig
from vidsgg.train import steps as jsteps
from vidsgg_torch.cli import data_source as tds
from vidsgg_torch.convert import faster_rcnn_from_jax
from vidsgg_torch.data.entry import EntryCapacity
from vidsgg_torch.detector import FasterRCNN, RPNConfig
from vidsgg_torch.detector import sgdet as tsgdet
from vidsgg_torch.train import LossFlags, create_train_state, make_train_step

F, H, W = 2, 64, 96
HW = (float(H), float(W))
RPN = dict(pre_nms_top_n=64, post_nms_top_n=16)
CAPS = dict(dets_per_frame=8, supply_cap=16)
CAP = (4, 32, 16)
K = 4
FLAGS = dict(mode="sgdet", obj_con_loss="euc_con")


@pytest.fixture(scope="module")
def frontends():
    """Both packages' train frontends on the same float64 detector weights."""
    shapes = jax.eval_shape(
        lambda r: JFasterRCNN(rpn_cfg=JRPNConfig(**RPN), base_blocks=(1, 1, 1),
                              head_blocks=1).init(r, jnp.zeros((1, H, W, 3)), jnp.array(HW)),
        jax.random.PRNGKey(0))
    det_vars = random_tree(shapes, np.random.default_rng(20), np.float64)
    det_vars["params"]["cls_score"]["kernel"] *= 8.0
    jdet = JFasterRCNN(rpn_cfg=JRPNConfig(**RPN), base_blocks=(1, 1, 1), head_blocks=1,
                       dtype=jnp.float64)
    with jax.enable_x64(True):
        jfront = jsgdet.SgdetFrontend(jdet, det_vars, jsgdet.SgdetCaps(**CAPS), JCap(*CAP))
    det = FasterRCNN(rpn_cfg=RPNConfig(**RPN), base_blocks=(1, 1, 1), head_blocks=1,
                     device="cpu").double()
    det.load_state_dict(faster_rcnn_from_jax(det_vars))
    tfront = tsgdet.SgdetFrontend(det, tsgdet.SgdetCaps(**CAPS), EntryCapacity(*CAP),
                                  device="cpu")
    return jfront, tfront


def _frames(seed):
    return (np.random.RandomState(seed).rand(F, H, W, 3) * 80.0 - 40.0).astype(np.float32)


def _videos(jfront):
    """Three train videos whose annotations are built on ``vidsgg``'s
    detections: the person on a detected box, one object on a detected box
    (found), one on the same box (a collision: it takes the next
    candidate), one nowhere near a detection (SUPPLY); the third video has a
    GT-only annotation (every box supplied)."""
    out = []
    for v in range(3):
        frames = _frames(30 + v)
        ann = synthetic_video_annotation(num_frames=F, objs_per_frame=3, seed=40 + v,
                                         image_wh=(W, H))
        if v < 2:
            with jax.enable_x64(True):
                dets = jax.device_get(jfront.detect(jfront.variables, jnp.asarray(frames),
                                                    jnp.asarray(HW), jnp.asarray(1.0)))
            for i, frame in enumerate(ann):
                boxes = dets["boxes"][i][dets["mask"][i]]
                assert len(boxes) >= 3, "the detector must find boxes"
                frame[0]["person_bbox"] = boxes[0][None].astype(np.float32)
                frame[1]["bbox"] = boxes[1].astype(np.float32)
                frame[2]["bbox"] = boxes[1].astype(np.float32)
        out.append((frames, ann))
    return out


def _crafted_frames():
    """Host detections and annotations of frames that exercise every rule."""
    def item(cls, box):
        return {"class": cls, "bbox": np.asarray(box, np.float32),
                "attention_relationship": [0], "spatial_relationship": [1],
                "contacting_relationship": [2]}

    person = {"person_bbox": np.asarray([[10, 10, 40, 60]], np.float32)}
    dets = [np.asarray([[10, 10, 40, 60], [50, 50, 80, 90], [52, 51, 80, 88],
                        [0, 0, 5, 5]], np.float32),           # a collision on box 1
            np.zeros((0, 4), np.float32),                     # no detections
            np.asarray([[100, 100, 120, 130]], np.float32),   # nothing overlaps
            np.asarray([[10, 12, 41, 60], [50, 50, 80, 90]], np.float32)]
    anns = [[person, item(5, [50, 50, 80, 90]), item(7, [50, 50, 80, 90]),
             item(9, [0, 0, 5, 5])],
            [person, item(3, [1, 1, 9, 9])],
            [person, item(4, [1, 1, 9, 9]), item(6, [20, 20, 30, 30])],
            [person, item(8, [51, 50, 80, 90])]]
    return dets, anns


def test_assign_relations_equals_vidsggs():
    dets, anns = _crafted_frames()
    want = jsgdet.assign_relations(dets, None, anns)
    got = tsgdet.assign_relations(dets, None, anns)
    found, gts, supply, assigned = got
    assert found == want[0] and gts == want[1] and supply == want[2]
    for g, w in zip(assigned, want[3], strict=True):
        np.testing.assert_array_equal(g, w)
    assert found[0] == [0, 1, 2, 3] and found[1] == [] and len(supply[2]) == 3
    assert assigned[0].tolist() == [1, 5, 7, 9]


def test_train_plan_equals_vidsggs(frontends):
    jfront, tfront = frontends
    dets, anns = _crafted_frames()
    d = CAPS["dets_per_frame"]
    boxes = np.zeros((len(dets), d, 4), np.float32)
    scores = np.zeros((len(dets), d), np.float32)
    mask = np.zeros((len(dets), d), bool)
    for i, b in enumerate(dets):
        boxes[i, :len(b)] = b
        scores[i, :len(b)] = np.linspace(0.9, 0.5, len(b))
        mask[i, :len(b)] = True
    cap = (len(dets), 32, 16)
    jfront_big = jsgdet.SgdetFrontend(jfront.model, jfront.variables, jfront.caps, JCap(*cap))
    tfront_big = tsgdet.SgdetFrontend(tfront.model, tfront.caps, EntryCapacity(*cap),
                                      device="cpu")
    args = (boxes, scores, mask, anns, 1.5, (96.0, 64.0), len(dets))
    want = jfront_big._train_plan(*args)
    got = tfront_big._train_plan(*args)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the capacities: too many objects, too many SUPPLY rows
    with pytest.raises(ValueError, match="objs"):
        tsgdet.SgdetFrontend(tfront.model, tfront.caps, EntryCapacity(len(dets), 8, 16),
                             device="cpu")._train_plan(*args)
    with pytest.raises(ValueError, match="SUPPLY"):
        tsgdet.SgdetFrontend(tfront.model, tsgdet.SgdetCaps(8, 2), EntryCapacity(*cap),
                             device="cpu")._train_plan(*args)


@pytest.fixture(scope="module")
def train_entries(frontends):
    """Each video's train entry from both frontends."""
    jfront, tfront = frontends
    out = []
    for frames, ann in _videos(jfront):
        with jax.enable_x64(True):
            je, jf = jfront(jnp.asarray(frames), jnp.asarray(HW), 1.0, gt_annotation=ann,
                            is_train=True, video_size=(W, H))
            je = jax.device_get(je)
        te, tf = tfront(torch.from_numpy(frames), HW, 1.0, video_size=(W, H),
                        gt_annotation=ann, is_train=True)
        out.append((je, te, np.asarray(jf), tf))
    return out


DISCRETE = ("labels", "pred_labels", "obj_mask", "im_idx", "pair_idx", "pair_mask",
            "attention_gt", "spatial_gt", "contacting_gt", "human_idx", "frame_mask",
            "num_frames", "im_scale", "video_size")


def test_train_entry_matches_vidsggs(train_entries):
    supplied = 0
    for je, te, jf, tf in train_entries:
        assert not te.features.is_inference() and not te.features.requires_grad
        for f in dataclasses.fields(JEntry):
            got, want = getattr(te, f.name).numpy(), np.asarray(getattr(je, f.name))
            assert got.shape == want.shape, f.name
            if f.name in DISCRETE:
                assert got.dtype == want.dtype, f.name
                np.testing.assert_array_equal(got, want, err_msg=f.name)
            else:
                close(got, want, f.name, tol=1e-5)
        close(tf, jf, "base_feat", tol=1e-5)
        n = int(np.asarray(je.obj_mask).sum())
        supplied += int((np.asarray(je.scores)[:n] == 1.0).sum())
        assert int(np.asarray(je.pair_mask).sum()) >= 2
    assert supplied > 0


def test_two_sgdet_train_steps_match_vidsgg(train_entries, monkeypatch):
    kw = dict(enc_layers=1, dec_layers=1, track_layers=1, obj_head="linear", rel_head="gmm")
    entries = [jax.tree.map(lambda a: np.asarray(a, np.float64)
                            if np.asarray(a).dtype.kind == "f" else np.asarray(a), je)
               for je, _, _, _ in train_entries[:2]]
    jstate, port, tcfg = _models(kw, seed=6, mode="sgdet", cap=JCap(*CAP), steps_per_epoch=2)
    noise = SharedNoise(monkeypatch, heads=(3, 6, 17), rows={(CAP[2], K)})
    with jax.enable_x64(True):
        jtrain = jsteps.make_train_step(jsteps.LossFlags(**FLAGS))
        state = create_train_state(port, steps_per_epoch=2)
        ttrain = make_train_step(LossFlags(**FLAGS))
        for step, je in enumerate(entries):
            jstate, jm = jtrain(jstate, je, jax.random.PRNGKey(step))
            jax.effects_barrier()
            replay = noise.replay()
            assert len(replay.masks) == 14
            tm = ttrain(state, entry_to_torch(je), replay)
            assert replay.exhausted() and list(tm) == list(jm)
            assert "object_loss" in tm and "object_contrastive_loss" in tm
            for k in jm:
                close(tm[k], jm[k], f"step {step} {k}")
            compare_state(jstate, port, tcfg, f"after step {step}")


def test_two_steps_of_teatgt_sgdet_training_match_vidsgg(train_entries, monkeypatch):
    """TEAT-GT sgdet training on these train entries against ``vidsgg``'s:
    ``test_torch_teatgt_train_modes.py:lock_step``."""
    entries = [float64_entry(jax.device_get(je)) for je, _, _, _ in train_entries[:2]]
    assert all(int(np.asarray(e.obj_mask).sum()) > 3 for e in entries)
    lock_step(monkeypatch, "sgdet", entries, JCap(*CAP), SGDET_CLIPS, seed=12,
              consistency=False)


class _Dataset:
    """A stand-in Action Genome split: annotations and random frames."""

    def __init__(self, frames_per_video):
        self.gt_annotations = [synthetic_video_annotation(num_frames=f, seed=i)
                               for i, f in enumerate(frames_per_video)]

    def __len__(self):
        return len(self.gt_annotations)

    def load_video_frames(self, i, device=None):
        f = len(self.gt_annotations[i])
        frames = np.zeros((f, 20, 30, 3), np.float32)
        return (frames if device is None else torch.from_numpy(frames)), 1.0


class _Frontend:
    """Records each call's annotation and whether it is a train call;
    raises ``ValueError`` (an over-capacity plan) for ``reject``."""

    device = torch.device("cpu")

    def __init__(self, reject):
        self.reject, self.calls = reject, []

    def __call__(self, frames, im_hw, scale, gt_annotation=None, is_train=False, **kw):
        self.calls.append((gt_annotation[0][0]["frame"], len(gt_annotation), is_train))
        if len(gt_annotation) == self.reject:
            raise ValueError("over capacity")
        return "entry", np.zeros(1, np.float32)


def test_train_source_order_and_skips_equal_vidsggs():
    frames = [3, 5, 7, 20, 4, 6, 2]       # 20 frames: over the capacity's 16
    jfront, tfront = _Frontend(reject=7), _Frontend(reject=7)
    jsrc = jds.make_sgdet_source(_Dataset(frames), JCap(16, 64, 48), jfront, is_train=True,
                                 seed=11)
    tsrc = tds.make_sgdet_source(_Dataset(frames), EntryCapacity(16, 64, 48), tfront,
                                 is_train=True, seed=11)
    for _ in range(3):
        want = [len(ann) for _, _, ann in jsrc()]
        got = [len(ann) for _, _, ann in tsrc()]
        assert got == want and len(got) == len(frames) - 2
        assert tsrc.stats.skipped == jsrc.stats.skipped == 2
    assert tfront.calls == jfront.calls and all(train for _, _, train in tfront.calls)
    assert len({tuple(c[1] for c in tfront.calls[i:i + 6]) for i in (0, 6, 12)}) > 1
    with pytest.raises(NotImplementedError, match="item 7b"):
        tds.make_sgdet_source(_Dataset(frames), EntryCapacity(16, 64, 48), tfront,
                              is_train=True, pair_detect=2)
