"""The TEMPURA test CLI of the port against ``vidsgg``'s, end to end on an
Action Genome-format tree on disk (64x48 PNG frames at ``--frame_size 48``,
so neither package resamples; a 17-frame video lands in the second size
bucket of ``--bucket_frames 32`` and a 33-frame one in none), with the same
weights carried across:
``vidsgg``'s CLI runs first on seeded detector variables and TEMPURA
state, which the test then hands, converted, to the port's CLI.

Both CLIs run in float32 on the CPU (``--device cpu`` for the port) and
must give identical R/mR grids (``result_dict``) under all three
constraints, identical per-class recall pickles in ``--output_path``, the
same printed recall, skip and temporal-consistency lines, and the same
video counts (yielded, skipped, per bucket). The pred dict of every video,
as the evaluators receive it: every discrete output (labels, pairs, frame
indices) exact, floats within 1e-4 x max(1, max|ref|), and sgdet's within
1e-3 x max(1, max|ref|): its boxes are decoded through exp() of float32
box deltas, which amplifies the convolutions' 1e-4 relative difference.
"""

import os
import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_utils import assert_pred_equal, random_tree, write_ag_tree

import vidsgg.cli.data_source as jds
import vidsgg.cli.tempura_test as jcli
import vidsgg.eval.evaluator as jeval
import vidsgg_torch.eval.evaluator as teval
from vidsgg.detector.faster_rcnn import FasterRCNN as JFasterRCNN
from vidsgg.detector.rpn import RPNConfig as JRPNConfig
from vidsgg.models.convert_relation import expected_tempura_shapes
from vidsgg.train.state import TrainState, obj_memory_dim
import vidsgg_torch.cli.data_source as tds
import vidsgg_torch.cli.tempura_test as tcli
from vidsgg_torch.configs import TempuraRunConfig
from vidsgg_torch.convert import faster_rcnn_from_jax, memory_from_jax, tempura_from_jax
from vidsgg_torch.detector import FasterRCNN, RPNConfig
from vidsgg_torch.models import Tempura
from vidsgg_torch.train import create_serving_state

MODEL_FLAGS = ["-enc_layer", "1", "-dec_layer", "1", "-K", "2"]
# the random detector's class logits scaled up so that sgdet keeps boxes
# above its 0.1 score threshold
CLS_SCORE_GAIN = 8.0


@pytest.fixture(scope="module")
def ag_root(tmp_path_factory):
    return write_ag_tree(tmp_path_factory.mktemp("ag_cli"))


def _ag_flags(root):
    return ["--data_path", root, "--frame_size", "48", "--tiny_detector",
            "--bucket_frames", "32"] + MODEL_FLAGS


def _run_vidsgg(monkeypatch, capsys, argv):
    """vidsgg's CLI -> (evaluators, stdout, its weights and sources).

    Its two weight builders are replaced by seeded draws over the same
    variable trees (``random_tree``: biases and norm statistics away from
    their identity values), which is also far cheaper than running the
    models' initialisers; everything else is ``vidsgg``'s own code."""
    got = {"sources": []}

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

    monkeypatch.setattr(jds, "build_detector", detector)
    monkeypatch.setattr(jcli, "create_train_state", state)
    got["preds"] = _record_preds(monkeypatch, jeval.SceneGraphEvaluator)
    for name in ("make_synthetic_source", "make_ag_source", "make_sgdet_source"):
        monkeypatch.setattr(jds, name, _recording(getattr(jds, name), got["sources"]))
    capsys.readouterr()
    evs = jcli.main(list(argv))
    return evs, capsys.readouterr().out, got


def _run_port(monkeypatch, capsys, argv, jax_run):
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

    def detector(model_path=None, tiny=False, frame_size=600, device=None):
        assert tiny and model_path is None
        det = FasterRCNN(rpn_cfg=RPNConfig(pre_nms_top_n=64, post_nms_top_n=16),
                         base_blocks=(1, 1, 1), head_blocks=1, device=device)
        det.load_state_dict(faster_rcnn_from_jax(jax_run["det_vars"]))
        return det, tds.scale_canvases(frame_size)

    monkeypatch.setattr(tcli, "build_relation_state", relation_state)
    monkeypatch.setattr(tds, "build_detector", detector)
    preds = _record_preds(monkeypatch, teval.SceneGraphEvaluator)
    for name in ("make_synthetic_source", "make_ag_source", "make_sgdet_source"):
        monkeypatch.setattr(tds, name, _recording(getattr(tds, name), sources))
    capsys.readouterr()
    evs = tcli.main(list(argv) + ["--device", "cpu"])
    return evs, capsys.readouterr().out, sources, preds


def _record_preds(monkeypatch, evaluator_class):
    """The pred dict of every video, as the first evaluator receives it."""
    preds = []
    evaluate = evaluator_class.evaluate_scene_graph

    def recording(self, gt, pred):
        if self.constraint == "with":
            preds.append(pred)
        return evaluate(self, gt, pred)

    monkeypatch.setattr(evaluator_class, "evaluate_scene_graph", recording)
    return preds


def _assert_same_preds(got, want, rel=1e-4):
    """Every video's pred dict: discrete outputs exact, floats within
    ``rel`` x max(1, max|ref|) (float32 on both sides, summed in another
    order)."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        scale = max(1.0, max(float(np.abs(np.asarray(v)).max(initial=0)) for k, v in w.items()
                             if k.endswith("distribution") or k == "boxes"))
        assert_pred_equal(g, w, atol=rel * scale)


def _recording(make, sink):
    def wrapped(*args, **kw):
        src = make(*args, **kw)
        sink.append(src)
        return src
    return wrapped


def _stats(sources):
    return [(s.stats.yielded, s.stats.skipped, dict(s.stats.bucket_counts))
            for s in sources if hasattr(s, "stats")]


def _assert_same_run(jax_evs, jax_out, port_evs, port_out):
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


def _pickles(out_dir):
    found = {}
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".pkl"):
            with open(os.path.join(out_dir, name), "rb") as f:
                found[name] = pickle.load(f)
    return found


@pytest.mark.parametrize("mode", ["predcls", "sgcls", "sgdet"])
def test_cli_matches_vidsgg_on_an_ag_tree(mode, ag_root, tmp_path, monkeypatch, capsys):
    argv = ["--mode", mode] + _ag_flags(ag_root)
    jax_evs, jax_out, jax_run = _run_vidsgg(
        monkeypatch, capsys, argv + ["--output_path", str(tmp_path / "jax")])
    port_evs, port_out, port_sources, port_preds = _run_port(
        monkeypatch, capsys, argv + ["--output_path", str(tmp_path / "port")], jax_run)
    _assert_same_run(jax_evs, jax_out, port_evs, port_out)
    # sgdet's boxes are decoded through exp() of float32 box deltas, which
    # amplifies the 1e-4 relative difference of the convolutions
    _assert_same_preds(port_preds, jax_run["preds"], rel=1e-3 if mode == "sgdet" else 1e-4)
    assert _stats(port_sources) == _stats(jax_run["sources"])
    # three test videos served, the long one in the second bucket; the
    # 33-frame one exceeds every bucket and is counted as skipped
    assert _stats(port_sources) == [(3, 1, {} if mode == "sgdet" else {16: 2, 32: 1})]
    assert "skipped 1 over-capacity videos (25.0%)" in port_out
    jax_pkls, port_pkls = _pickles(tmp_path / "jax"), _pickles(tmp_path / "port")
    assert len(jax_pkls) == 12 and port_pkls == jax_pkls


def test_cli_matches_vidsgg_on_synthetic_videos(tmp_path, monkeypatch, capsys):
    argv = ["--mode", "predcls", "--synthetic", "2"] + MODEL_FLAGS
    jax_evs, jax_out, jax_run = _run_vidsgg(
        monkeypatch, capsys, argv + ["--output_path", str(tmp_path / "jax")])
    # the stand-in head: vidsgg's array in place of the port's seeded draw
    head = np.array(jax.random.normal(jax.random.PRNGKey(7), (1024, 2048)) * 0.02)
    monkeypatch.setattr(tds, "synthetic_head_weight", lambda: torch.from_numpy(head))
    port_evs, port_out, _, port_preds = _run_port(
        monkeypatch, capsys, argv + ["--output_path", str(tmp_path / "port")], jax_run)
    _assert_same_run(jax_evs, jax_out, port_evs, port_out)
    _assert_same_preds(port_preds, jax_run["preds"])
    assert _pickles(tmp_path / "port") == _pickles(tmp_path / "jax")


@pytest.mark.parametrize("flags", [
    ["--ckpt", "some/dir"],
    ["--ckpt_name", "best_recall"],
    ["--bf16"],
    ["--int8"],
    ["--profile", "trace/"],
    ["--pair_detect", "2"],
    ["--data_parallel", "2"],
])
def test_unported_flags_exit_nonzero(flags, capsys):
    with pytest.raises(SystemExit) as exc:
        tcli.main(["--mode", "sgdet", "--synthetic", "1", "--device", "cpu"] + flags)
    assert exc.value.code not in (0, None)
    assert "ROADMAP.md queue 1 item" in str(exc.value.code)
    assert flags[0] in str(exc.value.code)


def test_cli_runs_with_its_own_weights_on_the_cpu(tmp_path):
    """No weights handed in: seeded TEMPURA and the seeded synthetic head."""
    evs = tcli.main(["--mode", "sgcls", "--synthetic", "2", "--device", "cpu",
                     "--output_path", str(tmp_path)] + MODEL_FLAGS)
    for ev in evs:
        for k in ev.KS:
            assert 0.0 <= ev.recall_at(k) <= 1.0 and 0.0 <= ev.mean_recall_at(k) <= 1.0


def test_cli_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where there is no card")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--mode", "predcls", "--synthetic", "1"])


def test_run_config_matches_vidsgg():
    from vidsgg.configs.tempura import TempuraRunConfig as JRunConfig

    for argv in (["--mode", "predcls"], ["--mode", "sgdet", "-K", "2"],
                 ["--mode", "sgcls", "-rel_mem_compute", "None", "-obj_loss_weighting", "None",
                  "-mem_feat_lambda", "0.25", "--frame_size", "48", "--bucket_frames", "32"]):
        got, want = TempuraRunConfig.from_args(argv), JRunConfig.from_args(argv)
        assert vars(got) == vars(want)
        assert vars(got.model_config()) == {
            k: v for k, v in vars(want.model_config()).items() if k in vars(got.model_config())}
