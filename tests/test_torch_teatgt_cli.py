"""The TEAT-GT test CLI of the port against ``vidsgg``'s, with the same
weights carried across (``vidsgg``'s CLI runs first on seeded detector
variables and TEAT-GT state, which the port's CLI is then given,
converted): ``--synthetic`` videos, and the Action Genome-format tree of
``test_torch_cli.py`` in all three modes (predcls with ``--bucket_frames
32``: a 17-frame video in the second size bucket, a 33-frame one in none;
sgcls and sgdet with one bucket of 16 frames, which both exceed). TEAT-GT at
d=32 (predcls 1 layer x 2 heads; sgcls and sgdet take ``vidsgg``'s
override to 6 x 16).

Both CLIs run in float32 on the CPU, with the same Laplacian eigenvectors
(``EigBridge``: every clip adjacency of the port must equal ``vidsgg``'s,
so a float32 threshold flip between the packages fails here, named). They
must give identical R/mR grids, identical per-class recall pickles (both
CLIs' evaluators are given an output directory), the same printed
recall, skip, NOTE and temporal-consistency lines and video counts; every
discrete output of every video exact, floats within 1e-4 x max(1,
max|ref|), sgdet's within 1e-3 x max(1, max|ref|) (see
``test_torch_cli.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from cli_parity_utils import (
    assert_same_preds,
    assert_same_run,
    jax_tiny_detector,
    pickles,
    port_tiny_detector,
    record_preds,
    recording,
    stats,
    synthetic_head,
)
from teatgt_parity_utils import DrawBridge, EigBridge, JaxFixedDraws
from torch_parity_utils import random_tree, write_ag_tree

import vidsgg.cli.data_source as jds
import vidsgg.cli.teatgt_test as jcli
import vidsgg.eval.evaluator as jeval
import vidsgg_torch.cli.data_source as tds
import vidsgg_torch.cli.teatgt_test as tcli
import vidsgg_torch.eval.evaluator as teval
import vidsgg_torch.models.tokengt as ttokengt
from vidsgg.models.convert_teatgt import expected_teatgt_shapes
from vidsgg.train.state import TrainState
from vidsgg_torch.cli.teatgt_test import SYNTHETIC_CLIPS
from vidsgg_torch.configs import TeatGTRunConfig
from vidsgg_torch.convert import teatgt_from_jax
from vidsgg_torch.models import TeatGT
from vidsgg_torch.train import create_serving_state
from vidsgg_torch.train.checkpoint import checkpoint_format

MODEL_FLAGS = ["--encoder_layers", "1", "--encoder_attention_heads", "2",
               "--encoder_embed_dim", "32", "--encoder_ffn_embed_dim", "32"]


@pytest.fixture(scope="module")
def ag_root(tmp_path_factory):
    return write_ag_tree(tmp_path_factory.mktemp("ag_teatgt_cli"))


def _evaluators_writing_to(monkeypatch, module, out_dir):
    """Both CLIs build their evaluators without an output directory; give
    them one, so that their per-class recall pickles can be compared."""
    make = module.get_ag_evaluators
    monkeypatch.setattr(module, "get_ag_evaluators",
                        lambda mode, **kw: make(mode, output_dir=str(out_dir), **kw))


def _run_vidsgg(monkeypatch, capsys, argv, out_dir):
    got = {"sources": []}

    def state(model, mem_cfg, entry_template, rng, tx):
        variables = random_tree(expected_teatgt_shapes(model.cfg, entry_template),
                                np.random.default_rng(22))
        got["variables"] = variables
        return TrainState(
            step=jnp.zeros((), jnp.int32), params=variables["params"],
            batch_stats=variables.get("batch_stats", {}), opt_state=None,
            rel_memory=jnp.zeros((26, 1936)), obj_memory=jnp.zeros((36, 1024)),
            mem_active=jnp.asarray(False), apply_fn=model.apply, tx=tx)

    monkeypatch.setattr(jds, "build_detector", jax_tiny_detector(got))
    monkeypatch.setattr(jcli, "create_train_state", state)
    _evaluators_writing_to(monkeypatch, jcli, out_dir)
    got["preds"] = record_preds(monkeypatch, jeval.SceneGraphEvaluator)
    for name in ("make_synthetic_source", "make_ag_source", "make_sgdet_source"):
        monkeypatch.setattr(jds, name, recording(getattr(jds, name), got["sources"]))
    capsys.readouterr()
    evs = jcli.main(list(argv))
    return evs, capsys.readouterr().out, got


def _run_port(monkeypatch, capsys, argv, out_dir, jax_run):
    sources = []

    def relation_state(cfg, clips, device):
        tcfg = cfg.model_config(clips)
        model = TeatGT(tcfg, device=device)
        model.load_state_dict(teatgt_from_jax(jax_run["variables"], tcfg))
        return create_serving_state(model)

    monkeypatch.setattr(tcli, "build_relation_state", relation_state)
    monkeypatch.setattr(tds, "build_detector", port_tiny_detector(jax_run))
    _evaluators_writing_to(monkeypatch, tcli, out_dir)
    preds = record_preds(monkeypatch, teval.SceneGraphEvaluator)
    for name in ("make_synthetic_source", "make_ag_source", "make_sgdet_source"):
        monkeypatch.setattr(tds, name, recording(getattr(tds, name), sources))
    capsys.readouterr()
    evs = tcli.main(list(argv) + ["--device", "cpu"])
    return evs, capsys.readouterr().out, sources, preds


def _run_both(argv, tmp_path, monkeypatch, capsys):
    bridge = EigBridge(monkeypatch)
    jax_evs, jax_out, jax_run = _run_vidsgg(monkeypatch, capsys, argv, tmp_path / "jax")
    port_evs, port_out, port_sources, port_preds = _run_port(
        monkeypatch, capsys, argv, tmp_path / "port", jax_run)
    bridge.assert_consumed()
    assert_same_run(jax_evs, jax_out, port_evs, port_out)
    jax_pkls, port_pkls = pickles(tmp_path / "jax"), pickles(tmp_path / "port")
    assert len(jax_pkls) == 12 and port_pkls == jax_pkls
    return jax_run, port_sources, port_preds, port_out


@pytest.mark.parametrize("mode,buckets", [("predcls", 32), ("sgcls", 16), ("sgdet", 16)])
def test_cli_matches_vidsgg_on_an_ag_tree(mode, buckets, ag_root, tmp_path, monkeypatch,
                                          capsys):
    """predcls over two size buckets (its clip caps come from the larger,
    so the 16-frame videos have empty clips); sgcls and sgdet over one."""
    argv = ["--mode", mode, "--data_path", ag_root, "--frame_size", "48", "--tiny_detector",
            "--bucket_frames", str(buckets)] + MODEL_FLAGS
    jax_run, port_sources, port_preds, port_out = _run_both(argv, tmp_path, monkeypatch,
                                                            capsys)
    assert_same_preds(port_preds, jax_run["preds"], rel=1e-3 if mode == "sgdet" else 1e-4)
    assert stats(port_sources) == stats(jax_run["sources"])
    served = {16: 2, 32: 1} if buckets == 32 else {16: 2}
    assert stats(port_sources) == [(sum(served.values()), 4 - sum(served.values()),
                                    {} if mode == "sgdet" else served)]
    skipped = 4 - sum(served.values())
    assert f"skipped {skipped} over-capacity videos ({25.0 * skipped:.1f}%)" in port_out


def test_cli_matches_vidsgg_on_synthetic_videos(tmp_path, monkeypatch, capsys):
    argv = ["--mode", "predcls", "--synthetic", "2"] + MODEL_FLAGS
    synthetic_head(monkeypatch)
    jax_run, _, port_preds, _ = _run_both(argv, tmp_path, monkeypatch, capsys)
    assert_same_preds(port_preds, jax_run["preds"])


def test_ckpt_cli_matches_vidsgg(tmp_path, monkeypatch, capsys):
    """``--ckpt DIR --ckpt_name NAME`` with the consistency losses' flags
    (the regularizer's parameters are part of such a checkpoint): both CLIs
    serve the checkpoint's weights. The two restores are replaced by the
    same seeded checkpoint: ``vidsgg``'s (orbax) returns it as its train
    state, the port's loader as its payload (the weights converted by
    ``teatgt_from_jax``, the regularizer's included). Compared as
    ``test_cli_matches_vidsgg_on_synthetic_videos``."""
    argv = ["--mode", "predcls", "--synthetic", "2", "--ckpt", "ckpts", "--ckpt_name",
            "checkpoint_final", "--use_cons_str_loss", "--use_cons_sem_loss"] + MODEL_FLAGS
    restored = {}

    def jax_restore(path, state, name):
        assert (path, name) == ("ckpts", "checkpoint_final")
        assert {"gat", "gat_semantic", "gap", "gap_sem"} <= set(state.params)
        shapes = jax.tree.map(lambda a: jax.ShapeDtypeStruct(np.shape(a), np.float32),
                              state.params)
        restored["state"] = state.replace(params=random_tree(shapes,
                                                             np.random.default_rng(23)))
        return restored["state"]

    def port_load(path, name, device=None):
        assert (path, name) == ("ckpts", "checkpoint_final")
        s = restored["state"]
        tcfg = TeatGTRunConfig.from_args(argv[:2] + argv[8:]).model_config(SYNTHETIC_CLIPS)
        return {"format": checkpoint_format(TeatGT),
                "model": teatgt_from_jax({"params": s.params}, tcfg),
                "rel_memory": torch.zeros((26, 1936)), "obj_memory": torch.zeros((36, 1024)),
                "mem_active": torch.tensor(False)}

    monkeypatch.setattr(jcli, "restore_checkpoint", jax_restore)
    monkeypatch.setattr(tcli, "load_payload", port_load)
    synthetic_head(monkeypatch)
    jax_run, _, port_preds, _ = _run_both(argv, tmp_path, monkeypatch, capsys)
    assert_same_preds(port_preds, jax_run["preds"])


@pytest.mark.parametrize("flag", ["--rand_node_id", "--orf_node_id"])
def test_node_id_flags_match_vidsgg(flag, tmp_path, monkeypatch, capsys):
    """TokenGT's random node identifiers: both CLIs serve the same, the
    port handed ``vidsgg``'s test-time draws (``rand``: its uniform draws
    from ``PRNGKey(0)``, ``JaxFixedDraws``; ``orf``: its orthogonal random
    matrices, ``DrawBridge``). Compared as
    ``test_cli_matches_vidsgg_on_synthetic_videos``."""
    argv = ["--mode", "predcls", "--synthetic", "2", flag] + MODEL_FLAGS
    synthetic_head(monkeypatch)
    draws = DrawBridge(monkeypatch)
    monkeypatch.setattr(ttokengt, "fixed_noise", JaxFixedDraws)
    jax_run, _, port_preds, _ = _run_both(argv, tmp_path, monkeypatch, capsys)
    assert_same_preds(port_preds, jax_run["preds"])
    # orf: one [clips, Tn, Tn] draw a video
    draws.assert_consumed(2 if flag == "--orf_node_id" else 0)


@pytest.mark.parametrize("flags,item", [
    (["--int8"], "item 7b"),
    (["--profile", "trace/"], "item 7b"),
    (["--pair_detect", "2"], "item 7b"),
])
def test_unported_flags_exit_nonzero(flags, item):
    with pytest.raises(SystemExit) as exc:
        tcli.main(["--mode", "sgdet", "--synthetic", "1", "--device", "cpu"] + flags)
    assert exc.value.code not in (0, None)
    assert f"ROADMAP.md queue 1 {item}" in str(exc.value.code)
    assert flags[0] in str(exc.value.code)


def test_cli_runs_with_its_own_weights_on_the_cpu(capsys):
    """No weights handed in: seeded TEAT-GT and the seeded synthetic head;
    predcls with --data_parallel 2 says that it serves on one device."""
    evs = tcli.main(["--mode", "predcls", "--synthetic", "2", "--device", "cpu",
                     "--data_parallel", "2"] + MODEL_FLAGS)
    assert "NOTE: --data_parallel shards sgdet serving only" in capsys.readouterr().out
    for ev in evs:
        for k in ev.KS:
            assert 0.0 <= ev.recall_at(k) <= 1.0 and 0.0 <= ev.mean_recall_at(k) <= 1.0


def test_run_config_matches_vidsgg():
    from vidsgg.configs.teatgt import TeatGTRunConfig as JRunConfig

    for argv in (["--mode", "predcls", "--use_cons_str_loss", "--use_ctl_loss"],
                 ["--mode", "sgdet", "--encoder_layers", "2", "--use_cons_sem_loss"],
                 ["--mode", "sgcls", "--lap_node_id_k", "8", "--frame_size", "48",
                  "--bucket_frames", "32", "--orf_node_id"]):
        got, want = TeatGTRunConfig.from_args(argv), JRunConfig.from_args(argv)
        assert vars(got) == vars(want)
        g, w = vars(got.model_config()), vars(want.model_config())
        assert g.keys() == w.keys()
        assert {k: v for k, v in g.items() if k != "caps"} == {
            k: w[k] for k in g if k != "caps"}
        assert vars(g["caps"]) == vars(w["caps"])
        g, w = vars(got.loss_flags()), vars(want.loss_flags())
        assert g == {k: w[k] for k in g} and g["ctl_variant"] == "teatgt"
