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
same printed recall, skip, NOTE and temporal-consistency lines, and the same
video counts (yielded, skipped, per bucket). The pred dict of every video,
as the evaluators receive it: every discrete output (labels, pairs, frame
indices) exact, floats within 1e-4 x max(1, max|ref|), and sgdet's within
1e-3 x max(1, max|ref|): its boxes are decoded through exp() of float32
box deltas, which amplifies the convolutions' 1e-4 relative difference.
"""

import re

import jax
import numpy as np
import pytest
import torch
from cli_parity_utils import (
    TEMPURA_FLAGS,
    assert_same_preds,
    assert_same_run,
    pickles,
    run_port_tempura,
    run_vidsgg_tempura,
    stats,
    synthetic_head,
)
from torch_parity_utils import assert_pred_equal, random_tree, write_ag_tree

import vidsgg.cli.tempura_test as jcli
import vidsgg_torch.cli.data_source as tds
import vidsgg_torch.cli.tempura_test as tcli
from vidsgg_torch.configs import TempuraRunConfig
from vidsgg_torch.convert import tempura_from_jax
from vidsgg_torch.eval.adapter import BF16_FIELDS
from vidsgg_torch.train.checkpoint import FORMAT

@pytest.fixture(scope="module")
def ag_root(tmp_path_factory):
    return write_ag_tree(tmp_path_factory.mktemp("ag_cli"))


def _ag_flags(root):
    return ["--data_path", root, "--frame_size", "48", "--tiny_detector",
            "--bucket_frames", "32"] + TEMPURA_FLAGS


@pytest.mark.parametrize("mode", ["predcls", "sgcls", "sgdet"])
def test_cli_matches_vidsgg_on_an_ag_tree(mode, ag_root, tmp_path, monkeypatch, capsys):
    argv = ["--mode", mode] + _ag_flags(ag_root)
    jax_evs, jax_out, jax_run = run_vidsgg_tempura(
        monkeypatch, capsys, argv + ["--output_path", str(tmp_path / "jax")])
    port_evs, port_out, port_sources, port_preds = run_port_tempura(
        monkeypatch, capsys, argv + ["--output_path", str(tmp_path / "port")], jax_run)
    assert_same_run(jax_evs, jax_out, port_evs, port_out)
    # sgdet's boxes are decoded through exp() of float32 box deltas, which
    # amplifies the 1e-4 relative difference of the convolutions
    assert_same_preds(port_preds, jax_run["preds"], rel=1e-3 if mode == "sgdet" else 1e-4)
    assert stats(port_sources) == stats(jax_run["sources"])
    # three test videos served, the long one in the second bucket; the
    # 33-frame one exceeds every bucket and is counted as skipped
    assert stats(port_sources) == [(3, 1, {} if mode == "sgdet" else {16: 2, 32: 1})]
    assert "skipped 1 over-capacity videos (25.0%)" in port_out
    jax_pkls, port_pkls = pickles(tmp_path / "jax"), pickles(tmp_path / "port")
    assert len(jax_pkls) == 12 and port_pkls == jax_pkls


def test_cli_matches_vidsgg_on_synthetic_videos(tmp_path, monkeypatch, capsys):
    argv = ["--mode", "predcls", "--synthetic", "2"] + TEMPURA_FLAGS
    jax_evs, jax_out, jax_run = run_vidsgg_tempura(
        monkeypatch, capsys, argv + ["--output_path", str(tmp_path / "jax")])
    synthetic_head(monkeypatch)
    port_evs, port_out, _, port_preds = run_port_tempura(
        monkeypatch, capsys, argv + ["--output_path", str(tmp_path / "port")], jax_run)
    assert_same_run(jax_evs, jax_out, port_evs, port_out)
    assert_same_preds(port_preds, jax_run["preds"])
    assert pickles(tmp_path / "port") == pickles(tmp_path / "jax")


def test_ckpt_cli_matches_vidsgg(tmp_path, monkeypatch, capsys):
    """``--ckpt DIR --ckpt_name NAME``: both CLIs serve a checkpoint's
    weights and both banks (``mem_active``: the hallucinator attends). The
    two restores are replaced by the same seeded checkpoint: ``vidsgg``'s
    (orbax) returns it as its train state, the port's loader as its payload
    (the weights converted by ``tempura_from_jax``). Compared as
    ``test_cli_matches_vidsgg_on_synthetic_videos``, plus the restore line."""
    argv = ["--mode", "predcls", "--synthetic", "2", "--ckpt", "ckpts",
            "--ckpt_name", "checkpoint_final"] + TEMPURA_FLAGS
    restored = {}

    def jax_restore(path, state, name):
        assert (path, name) == ("ckpts", "checkpoint_final")
        rng = np.random.default_rng(23)
        shapes = jax.tree.map(lambda a: jax.ShapeDtypeStruct(np.shape(a), np.float32),
                              state.params)
        restored["state"] = state.replace(
            params=random_tree(shapes, rng), rel_memory=rng.standard_normal((26, 1936)).astype(
                np.float32), obj_memory=rng.standard_normal((36, 1024)).astype(np.float32),
            mem_active=np.bool_(True))
        return restored["state"]

    def port_load(path, name, device=None):
        assert (path, name) == ("ckpts", "checkpoint_final")
        s = restored["state"]
        tcfg = TempuraRunConfig.from_args(["--mode", "predcls"] + TEMPURA_FLAGS).model_config()
        return {"format": FORMAT,
                "model": tempura_from_jax({"params": s.params, "batch_stats": s.batch_stats}, tcfg),
                "rel_memory": torch.from_numpy(s.rel_memory),
                "obj_memory": torch.from_numpy(s.obj_memory), "mem_active": torch.tensor(True)}

    monkeypatch.setattr(jcli, "restore_checkpoint", jax_restore)
    jax_evs, jax_out, jax_run = run_vidsgg_tempura(
        monkeypatch, capsys, argv + ["--output_path", str(tmp_path / "jax")])
    monkeypatch.setattr(tcli, "load_payload", port_load)
    synthetic_head(monkeypatch)
    port_evs, port_out, _, port_preds = run_port_tempura(
        monkeypatch, capsys, argv + ["--output_path", str(tmp_path / "port")], jax_run)
    line = "restored checkpoint checkpoint_final from ckpts (incl. memory banks)"
    assert line in jax_out.splitlines() and line in port_out.splitlines()
    assert_same_run(jax_evs, jax_out, port_evs, port_out)
    assert_same_preds(port_preds, jax_run["preds"])
    assert pickles(tmp_path / "port") == pickles(tmp_path / "jax")


@pytest.mark.parametrize("flags", [
    ["--int8"],
    ["--profile", "trace/"],
    ["--pair_detect", "2"],
    ["--data_parallel", "2"],
])
def test_unported_flags_exit_nonzero(flags, capsys, monkeypatch):
    """sgdet without --max_videos on a machine with two devices (where
    ``vidsgg`` would shard ``--data_parallel 2``): every flag still exits."""
    monkeypatch.setattr(tds, "device_count", lambda device: 2)
    with pytest.raises(SystemExit) as exc:
        tcli.main(["--mode", "sgdet", "--synthetic", "1", "--device", "cpu"] + flags)
    assert exc.value.code not in (0, None)
    assert "ROADMAP.md queue 1 item" in str(exc.value.code)
    assert flags[0] in str(exc.value.code)


@pytest.mark.parametrize("mode", ["predcls", "sgdet"])
def test_bf16_cli_matches_vidsgg(mode, tmp_path, monkeypatch, capsys):
    """``--bf16``: the relation stack in bfloat16 behind the float32
    detector in both CLIs. The same NOTEs and headline lines and video
    counts; every video's pred dict holds bfloat16 values in the same
    fields (``bf16_fields``) and has as many objects and pairs; in predcls,
    whose objects and pairs are the GT's, every discrete output exact and
    the floats within 2**-6 x max(1, max|ref|), four bfloat16 ulps at 1
    (``test_torch_bf16_serving.py``). sgdet's OSPU scores differ from
    ``vidsgg``'s by a bfloat16 ulp here and there, which reorders tied
    objects through its NMS and sort. R@K and mR@K within 0.05: a rounding
    that falls the other way moves a triplet across a K boundary, one or
    two of the video's GT triplets (1/48 each in predcls)."""
    argv = ["--mode", mode, "--synthetic", "1", "--bf16"] + TEMPURA_FLAGS
    jax_evs, jax_out, jax_run = run_vidsgg_tempura(
        monkeypatch, capsys, argv + ["--output_path", str(tmp_path / "jax")])
    synthetic_head(monkeypatch)
    port_evs, port_out, _, port_preds = run_port_tempura(
        monkeypatch, capsys, argv + ["--output_path", str(tmp_path / "port")], jax_run)
    want = jax_run["preds"]
    assert len(port_preds) == len(want) == 1
    got, want = dict(port_preds[0]), want[0]
    floats = ("boxes", "scores", "pred_scores", "attention_distribution",
              "spatial_distribution", "contacting_distribution")
    assert got.pop(BF16_FIELDS) == tuple(k for k in floats if want[k].dtype.name == "bfloat16")
    assert len(got["pred_labels"]) == len(want["pred_labels"]) > 0
    assert len(got["pair_idx"]) == len(want["pair_idx"]) > 0
    if mode == "predcls":
        scale = max(1.0, max(float(np.abs(np.asarray(want[k], np.float64)).max())
                             for k in floats))
        assert_pred_equal(got, {k: np.asarray(v, np.float32) if k in floats else v
                                for k, v in want.items()}, atol=2.0 ** -6 * scale)
    for jev, tev in zip(jax_evs, port_evs, strict=True):
        for k in jev.KS:
            assert abs(tev.recall_at(k) - jev.recall_at(k)) <= 0.05
            assert abs(tev.mean_recall_at(k) - jev.mean_recall_at(k)) <= 0.05
    for pattern in (r"^evaluated (\d+) videos", r"^NOTE: .*$", r"^>>> .*$"):
        assert re.findall(pattern, port_out, re.M) == re.findall(pattern, jax_out, re.M)
    assert len(pickles(tmp_path / "port")) == len(pickles(tmp_path / "jax")) == 12


def test_cli_runs_with_its_own_weights_on_the_cpu(tmp_path):
    """No weights handed in: seeded TEMPURA and the seeded synthetic head."""
    evs = tcli.main(["--mode", "sgcls", "--synthetic", "2", "--device", "cpu",
                     "--output_path", str(tmp_path)] + TEMPURA_FLAGS)
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
