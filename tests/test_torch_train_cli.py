"""The port's TEMPURA train CLI on the CPU (``--device cpu``), one encoder
and one decoder layer at the full widths, and what it hands on:

* ``tempura_train --synthetic 4 --nepoch 2 -log_iter 1`` prints
  ``vidsgg``'s line formats (``vidsgg/train/loop.py``'s f-strings, the
  metrics in the sorted key order of ``vidsgg``'s jitted step) and
  saves ``vidsgg``'s checkpoint names in its order: ``checkpoint_0``, then
  ``best_recall`` / ``best_Mrecall`` right after each "new best" line, and
  ``checkpoint_final``; and trains (the step count, the banks, the
  hallucinator's counts);
* the Action Genome route on a small tree (train and test splits);
* ``--resume`` restores the step, the parameters, the optimizer's counts
  and moments and both banks exactly;
* ``tempura_test --ckpt DIR --ckpt_name NAME`` serves the restored model
  and banks: its grids equal those of the trained state served directly;
* the refused flags exit non-zero naming their ROADMAP item, and without
  ``--device cpu`` the CLI raises here (no card);
* the video sources' order under the same global NumPy seed (synthetic,
  ``shuffle`` and ``stable=False``) and ``RandomState(seed)`` (Action
  Genome) against ``vidsgg``'s, and their entries built under ``no_grad``.

No model checkpoint reaches the disk: the loop's saver and the CLIs'
loaders are replaced by an in-memory store (``torch.save`` into bytes),
which keeps only the payloads a test reads back. sgcls and sgdet runs:
``test_torch_train_cli_modes.py``.
"""

import contextlib
import io
import re

import numpy as np
import pytest
import torch
from torch_parity_utils import write_ag_tree

import vidsgg.cli.data_source as jds
import vidsgg_torch.cli.data_source as tds
import vidsgg_torch.cli.tempura_test as tcli
import vidsgg_torch.cli.tempura_train as tcli_train
import vidsgg_torch.train.loop as tloop
from vidsgg.data.action_genome import ActionGenome as JActionGenome
from vidsgg.data.entry import EntryCapacity as JCap
from vidsgg_torch.data.action_genome import ActionGenome
from vidsgg_torch.data.entry import EntryCapacity
from vidsgg_torch.eval import get_ag_evaluators
from vidsgg_torch.train import EvalPipeline
from vidsgg_torch.train.checkpoint import checkpoint_payload, restore_payload

LAYERS = ["-enc_layer", "1", "-dec_layer", "1"]
NUM = r"-?[0-9]+\.[0-9]{4}"
# the metrics in vidsgg's order: its jitted step returns them sorted by key
STEP_LINE = re.compile(
    rf"^epoch (\d+) step (\d+)  [0-9]+\.[0-9]{{3}}s/video  attention_relation_loss={NUM}  "
    rf"contacting_relation_loss={NUM}  grad_norm={NUM}  spatial_relation_loss={NUM}  "
    rf"total_loss={NUM}$", re.M)
VAL_LINE = re.compile(
    rf"^epoch (\d+) val: R@20={NUM} mR@20={NUM} \(semi R@20={NUM}, no R@20={NUM}\)$", re.M)
BEST_LINE = re.compile(rf"^new best (recall|Mrecall) {NUM} at epoch (\d+)$", re.M)


class MemoryStore:
    """The loop's saver and the CLIs' loaders, in memory: every name saved,
    in order, and the payload bytes of the names in ``keep``."""

    def __init__(self, monkeypatch, keep=()):
        self.names, self.blobs, self.keep = [], {}, set(keep)
        monkeypatch.setattr(tloop, "save_checkpoint", self.save)
        monkeypatch.setattr(tcli_train, "restore_checkpoint", self.restore)
        monkeypatch.setattr(tcli, "load_payload", self.load)

    def save(self, path, state, name):
        self.names.append((path, name))
        if name in self.keep:
            buf = io.BytesIO()
            torch.save(checkpoint_payload(state), buf)
            self.blobs[name] = buf.getvalue()

    def load(self, path, name, device=None):
        return torch.load(io.BytesIO(self.blobs[name]), map_location=device, weights_only=True)

    def restore(self, path, state, name):
        return restore_payload(state, self.load(path, name))


def _train(tmp_path, capsys, *flags):
    capsys.readouterr()
    state = tcli_train.main(["--device", "cpu", "--mode", "predcls", "--save_path",
                             str(tmp_path / "run")] + LAYERS + list(flags))
    return state, capsys.readouterr().out


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One synthetic run of 2 epochs x 4 videos: (state, stdout, store)."""
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("train_cli")
    store = MemoryStore(mp, keep=("checkpoint_final",))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = tcli_train.main(["--device", "cpu", "--mode", "predcls", "--synthetic", "4",
                                 "--nepoch", "2", "-log_iter", "1",
                                 "--save_path", str(tmp / "run")] + LAYERS)
    mp.undo()
    yield state, out.getvalue(), store
    del state


def vidsgg_saves(lines) -> list:
    """vidsgg's saves for a run's log lines: checkpoint_0 after epoch 0's
    validation, then one save per "new best" line in its order, and
    checkpoint_final last."""
    want = []
    for line in lines:
        if VAL_LINE.match(line) and line.startswith("epoch 0 "):
            want.append("checkpoint_0")
        found = BEST_LINE.match(line)
        if found:
            want.append(f"best_{found.group(1)}")
    return want + ["checkpoint_final"]


def test_synthetic_run_prints_and_saves_as_vidsgg(trained):
    state, out, store = trained
    lines = out.splitlines()
    assert lines[0] == ">>> TEMPURA train: mode=predcls synthetic=4"
    assert lines[-1] == ">>> TEMPURA train complete"
    steps = STEP_LINE.findall(out)
    assert [(int(e), int(s)) for e, s in steps] == [(i // 4, i + 1) for i in range(8)]
    assert [int(e) for e in VAL_LINE.findall(out)] == [0, 1]
    assert [name for _, name in store.names] == vidsgg_saves(lines)
    assert {path for path, _ in store.names} == {store.names[0][0]}
    assert state.step == 8 and state.optimizer.updates == 8 and bool(state.mem_active)
    assert float(state.rel_memory.abs().max()) > 0
    # the hallucinator skipped epoch 0 (empty banks) and trained in epoch 1
    params = dict(state.model.named_parameters())
    for name in ("glocal_transformer.mem_attention.in_proj_weight",
                 "glocal_transformer.mem_attention.out_proj.weight"):
        assert set(state.optimizer.state[params[name]]["step"].tolist()) == {4}


def test_train_cli_logs_and_metrics_files(trained, tmp_path, capsys, monkeypatch):
    MemoryStore(monkeypatch)
    _, out = _train(tmp_path, capsys, "--synthetic", "2", "--nepoch", "1", "-log_iter", "2")
    run = tmp_path / "run"
    train_log = (run / "log_train.txt").read_text()
    val_log = (run / "log_val.txt").read_text()
    assert STEP_LINE.findall(train_log) == [("0", "2")]
    assert VAL_LINE.findall(val_log) == ["0"]
    names = {line.split('"name": "')[1].split('"')[0]
             for line in (run / "metrics.jsonl").read_text().splitlines()}
    assert {"att_loss", "spatial_loss", "contact_loss", "total_loss", "with_R@20",
            "semi_MR@50", "no_R@100"} <= names


def test_resume_restores_the_state_exactly(trained, tmp_path, capsys, monkeypatch):
    state, _, store = trained
    resumed_store = MemoryStore(monkeypatch)
    # the resume reads best_recall: hand it the final state (non-empty banks)
    resumed_store.blobs["best_recall"] = store.blobs["checkpoint_final"]
    resumed, out = _train(tmp_path, capsys, "--synthetic", "4", "--nepoch", "0",
                          "--resume", "ckpts")
    assert "resumed from ckpts at step 8" in out
    assert resumed.step == state.step and resumed.optimizer.updates == 8
    assert resumed.mem_active.item() is True
    for got, want in ((resumed.rel_memory, state.rel_memory),
                      (resumed.obj_memory, state.obj_memory)):
        assert torch.equal(got, want)
    want_sd = state.model.state_dict()
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, want_sd[k]), k
    pairs = zip(resumed.model.parameters(), state.model.parameters(), strict=True)
    for p, q in pairs:
        a, b = resumed.optimizer.state[p], state.optimizer.state[q]
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a[key], b[key]), key


def test_test_cli_serves_the_checkpoint(trained, tmp_path, capsys, monkeypatch):
    state, _, store = trained
    MemoryStore(monkeypatch).blobs.update(store.blobs)
    served = {}
    restore = tcli.restore_serving

    def keep(s, payload):
        served["state"] = restore(s, payload)
        return served["state"]

    monkeypatch.setattr(tcli, "restore_serving", keep)
    capsys.readouterr()
    evs = tcli.main(["--device", "cpu", "--mode", "predcls", "--synthetic", "2", "--ckpt", "ckpts",
                     "--ckpt_name", "checkpoint_final", "--output_path", str(tmp_path)] + LAYERS)
    out = capsys.readouterr().out
    assert "restored checkpoint checkpoint_final from ckpts (incl. memory banks)" in out
    got = served["state"]
    assert bool(got.mem_active) and torch.equal(got.rel_memory, state.rel_memory)
    want_sd = state.model.state_dict()
    for k, v in got.model.state_dict().items():
        assert torch.equal(v, want_sd[k]), k
    # the same videos served from the trained state itself
    cap = EntryCapacity(max_frames=16, max_objs=48, max_pairs=32)
    src = tds.make_synthetic_source(2, cap, seed=99, shuffle=False, stable=True, device="cpu")
    pipe = EvalPipeline("predcls", cap, device="cpu")
    want = get_ag_evaluators("predcls", output_dir=str(tmp_path / "direct"))
    for entry, fmaps, gt in src():
        pred = pipe(state, entry, fmaps, gt_entry=entry)
        for ev in want:
            ev.evaluate_scene_graph(gt, pred)
    for a, b in zip(evs, want, strict=True):
        for key, grid in b.result_dict.items():
            for k in grid:
                np.testing.assert_array_equal(a.result_dict[key][k], grid[k])


def test_train_cli_on_an_ag_tree(tmp_path, capsys, monkeypatch):
    root = write_ag_tree(tmp_path / "ag")
    store = MemoryStore(monkeypatch)
    state, out = _train(tmp_path, capsys, "--data_path", root, "--frame_size", "48",
                        "--tiny_detector", "--bucket_frames", "32", "--nepoch", "1",
                        "-log_iter", "1")
    # the two train videos, then validation over the test split
    assert [s for _, s in STEP_LINE.findall(out)] == ["1", "2"]
    assert VAL_LINE.findall(out) == ["0"]
    assert "epoch 0 buckets: 16f=2  skipped=0" in out
    assert state.step == 2 and store.names[-1][1] == "checkpoint_final"


@pytest.mark.parametrize("flags,item", [
    (["--data_parallel", "2"], "item 7b"),
    (["--int8"], "item 7b"),
    (["--profile", "trace/"], "item 7b"),
    (["--pair_detect", "2", "--mode", "sgdet"], "item 7b"),
])
def test_refused_flags_exit_naming_their_item(flags, item):
    with pytest.raises(SystemExit) as exc:
        tcli_train.main(["--synthetic", "1", "--device", "cpu"] + flags)
    assert exc.value.code not in (0, None)
    assert f"ROADMAP.md queue 1 {item}" in str(exc.value.code)
    assert flags[0] in str(exc.value.code)


def test_train_cli_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli_train.main(["--mode", "predcls", "--synthetic", "1"] + LAYERS)


def test_synthetic_source_order_and_entries_match_vidsgg():
    jcap, cap = JCap(16, 48, 32), EntryCapacity(16, 48, 32)
    np.random.seed(5)
    jsrc = jds.make_synthetic_source(5, jcap, seed=3)
    jitems = [[(ann, np.asarray(e.attention_gt), np.asarray(e.labels)) for e, _, ann in jsrc()]
              for _ in range(2)]
    np.random.seed(5)
    tsrc = tds.make_synthetic_source(5, cap, seed=3, device="cpu")
    titems = [[(ann, e) for e, _, ann in tsrc()] for _ in range(2)]
    # the order moves between epochs
    assert [repr(a) for a, _, _ in jitems[0]] != [repr(a) for a, _, _ in jitems[1]]
    for jep, tep in zip(jitems, titems, strict=True):
        for (jann, jatt, jlab), (tann, te) in zip(jep, tep, strict=True):
            assert repr(tann) == repr(jann)
            np.testing.assert_array_equal(te.attention_gt.numpy(), jatt)
            np.testing.assert_array_equal(te.labels.numpy(), jlab)
            assert not te.features.is_inference() and not te.features.requires_grad


def test_ag_source_order_matches_vidsgg(tmp_path):
    root = write_ag_tree(tmp_path / "ag")
    jds_test = JActionGenome("test", "large", root, filter_small_box=False, target_min_side=48)
    tds_test = ActionGenome("test", "large", root, filter_small_box=False, target_min_side=48)
    buckets = tds.default_buckets(max_frames=32)
    jsrc = jds.make_ag_source(jds_test, JCap(32, 128, 96), seed=9,
                              buckets=jds.default_buckets(max_frames=32))
    det, canvases = tds.build_detector(tiny=True, frame_size=48, device="cpu")
    tsrc = tds.make_ag_source(tds_test, buckets, det, seed=9, canvases=canvases)
    want = [[ann[0][0]["frame"] for _, _, ann in jsrc()] for _ in range(3)]
    got = []
    for _ in range(3):
        epoch = []
        for entry, _, ann in tsrc():
            assert not entry.features.is_inference()
            epoch.append(ann[0][0]["frame"])
        got.append(epoch)
    assert got == want
    assert len({tuple(e) for e in got}) > 1          # the order moves between epochs
    assert tsrc.stats.skipped == jsrc.stats.skipped == 1
