"""Shared helpers of the test-CLI parity tests (``test_torch_cli.py``,
``test_torch_cli_flags.py``, ``test_torch_teatgt_cli.py``): the tiny
detectors both CLIs are given, the TEMPURA CLIs run with the same weights,
what each run is recorded by, and the comparisons of two runs."""

from __future__ import annotations

import os
import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_parity_utils import assert_pred_equal, random_tree

import vidsgg.cli.data_source as jds
import vidsgg.cli.tempura_test as jcli
import vidsgg.eval.evaluator as jeval
import vidsgg_torch.cli.data_source as tds
import vidsgg_torch.cli.tempura_test as tcli
import vidsgg_torch.eval.evaluator as teval
from vidsgg.detector.faster_rcnn import FasterRCNN as JFasterRCNN
from vidsgg.detector.rpn import RPNConfig as JRPNConfig
from vidsgg.models.convert_relation import expected_tempura_shapes
from vidsgg.train.state import TrainState, obj_memory_dim
from vidsgg_torch.convert import faster_rcnn_from_jax, memory_from_jax, tempura_from_jax
from vidsgg_torch.detector import FasterRCNN, RPNConfig
from vidsgg_torch.models import Tempura
from vidsgg_torch.train import create_serving_state

TEMPURA_FLAGS = ["-enc_layer", "1", "-dec_layer", "1", "-K", "2"]

# the random detector's class logits scaled up so that sgdet keeps boxes
# above its 0.1 score threshold
CLS_SCORE_GAIN = 8.0


def jax_tiny_detector(got: dict):
    """A stand-in for ``vidsgg``'s ``build_detector``: the shrunk detector
    with seeded variables (kept in ``got["det_vars"]``)."""
    def detector(model_path=None, tiny=False, frame_size=600):
        assert tiny and model_path is None
        det = JFasterRCNN(rpn_cfg=JRPNConfig(pre_nms_top_n=64, post_nms_top_n=16),
                          base_blocks=(1, 1, 1), head_blocks=1)
        shapes = jax.eval_shape(
            lambda r: det.init(r, jnp.zeros((1, 64, 64, 3)), jnp.array([64.0, 64.0])),
            jax.random.PRNGKey(0))
        det_vars = random_tree(shapes, np.random.default_rng(20))
        det_vars["params"]["cls_score"]["kernel"] *= CLS_SCORE_GAIN
        got["det_vars"] = det_vars
        return det, det_vars, jds.scale_canvases(frame_size)
    return detector


def port_tiny_detector(got: dict):
    """A stand-in for the port's ``build_detector`` with the variables
    :func:`jax_tiny_detector` kept in ``got``."""
    def detector(model_path=None, tiny=False, frame_size=600, device=None):
        assert tiny and model_path is None
        det = FasterRCNN(rpn_cfg=RPNConfig(pre_nms_top_n=64, post_nms_top_n=16),
                         base_blocks=(1, 1, 1), head_blocks=1, device=device)
        det.load_state_dict(faster_rcnn_from_jax(got["det_vars"]))
        return det, tds.scale_canvases(frame_size)
    return detector


def record_preds(monkeypatch, evaluator_class):
    """The pred dict of every video, as the first evaluator receives it."""
    preds = []
    evaluate = evaluator_class.evaluate_scene_graph

    def recording(self, gt, pred):
        if self.constraint == "with":
            preds.append(pred)
        return evaluate(self, gt, pred)

    monkeypatch.setattr(evaluator_class, "evaluate_scene_graph", recording)
    return preds


def assert_same_preds(got, want, rel=1e-4):
    """Every video's pred dict: discrete outputs exact, floats within
    ``rel`` x max(1, max|ref|) (float32 on both sides, summed in another
    order)."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        scale = max(1.0, max(float(np.abs(np.asarray(v)).max(initial=0)) for k, v in w.items()
                             if k.endswith("distribution") or k == "boxes"))
        assert_pred_equal(g, w, atol=rel * scale)


def recording(make, sink):
    def wrapped(*args, **kw):
        src = make(*args, **kw)
        sink.append(src)
        return src
    return wrapped


def stats(sources):
    return [(s.stats.yielded, s.stats.skipped, dict(s.stats.bucket_counts))
            for s in sources if hasattr(s, "stats")]


def assert_same_run(jax_evs, jax_out, port_evs, port_out):
    for jev, tev in zip(jax_evs, port_evs, strict=True):
        assert tev.constraint == jev.constraint
        assert tev.result_dict.keys() == jev.result_dict.keys()
        for key, want in jev.result_dict.items():
            got = tev.result_dict[key]
            assert got.keys() == want.keys(), key
            for k in want:
                np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                              err_msg=f"{jev.constraint} {key} {k}")
    evaluated = re.compile(r"^evaluated (\d+) videos", re.M)
    assert evaluated.findall(port_out) == evaluated.findall(jax_out)
    temporal = re.compile(r"^Temporal Consistency: .*$", re.M)
    assert temporal.findall(port_out) == temporal.findall(jax_out)
    skipped = re.compile(r"^\[\w+_source\] skipped .*$", re.M)
    assert skipped.findall(port_out) == skipped.findall(jax_out)
    recall = re.compile(r"^m?R@\d+: .*$", re.M)
    assert recall.findall(port_out) == recall.findall(jax_out)
    notes = re.compile(r"^NOTE: .*$", re.M)
    assert notes.findall(port_out) == notes.findall(jax_out)


def pickles(out_dir):
    found = {}
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".pkl"):
            with open(os.path.join(out_dir, name), "rb") as f:
                found[name] = pickle.load(f)
    return found


def run_vidsgg_tempura(monkeypatch, capsys, argv):
    """vidsgg's CLI -> (evaluators, stdout, its weights and sources).

    Its two weight builders are replaced by seeded draws over the same
    variable trees (``random_tree``: biases and norm statistics away from
    their identity values), which is also far cheaper than running the
    models' initialisers; everything else is ``vidsgg``'s own code."""
    got = {"sources": []}

    def state(model, cfg, entry_template, rng, tx):
        variables = random_tree(expected_tempura_shapes(cfg, entry_template),
                                np.random.default_rng(21))
        got["state"] = TrainState(
            step=jnp.zeros((), jnp.int32), params=variables["params"],
            batch_stats=variables.get("batch_stats", {}), opt_state=None,
            rel_memory=jnp.zeros((26, 1936)),
            obj_memory=jnp.zeros((cfg.num_classes - 1, obj_memory_dim(cfg))),
            mem_active=jnp.asarray(False), apply_fn=model.apply, tx=tx)
        return got["state"]

    monkeypatch.setattr(jds, "build_detector", jax_tiny_detector(got))
    monkeypatch.setattr(jcli, "create_train_state", state)
    got["preds"] = record_preds(monkeypatch, jeval.SceneGraphEvaluator)
    for name in ("make_synthetic_source", "make_ag_source", "make_sgdet_source"):
        monkeypatch.setattr(jds, name, recording(getattr(jds, name), got["sources"]))
    capsys.readouterr()
    evs = jcli.main(list(argv))
    return evs, capsys.readouterr().out, got


def run_port_tempura(monkeypatch, capsys, argv, jax_run):
    """The port's CLI on the CPU with ``vidsgg``'s weights."""
    jax_state = jax_run["state"]
    sources = []

    def relation_state(cfg, device):
        tcfg = cfg.model_config()
        model = Tempura(tcfg, device=device)
        model.load_state_dict(tempura_from_jax(
            {"params": jax_state.params, "batch_stats": jax_state.batch_stats}, tcfg))
        s = create_serving_state(model)
        s.rel_memory, s.obj_memory, s.mem_active = memory_from_jax(
            jax_state.rel_memory, jax_state.obj_memory, jax_state.mem_active)
        return s

    monkeypatch.setattr(tcli, "build_relation_state", relation_state)
    monkeypatch.setattr(tds, "build_detector", port_tiny_detector(jax_run))
    preds = record_preds(monkeypatch, teval.SceneGraphEvaluator)
    for name in ("make_synthetic_source", "make_ag_source", "make_sgdet_source"):
        monkeypatch.setattr(tds, name, recording(getattr(tds, name), sources))
    capsys.readouterr()
    evs = tcli.main(list(argv) + ["--device", "cpu"])
    return evs, capsys.readouterr().out, sources, preds


def synthetic_head(monkeypatch):
    """The stand-in head: ``vidsgg``'s array in place of the port's seeded draw."""
    head = np.array(jax.random.normal(jax.random.PRNGKey(7), (1024, 2048)) * 0.02)
    monkeypatch.setattr(tds, "synthetic_head_weight", lambda: torch.from_numpy(head))
