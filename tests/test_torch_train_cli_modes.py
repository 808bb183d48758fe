"""The port's TEMPURA train CLI in sgcls and sgdet on the CPU (``--device
cpu``), one encoder and one decoder layer at the full widths (tracking
with 3 layers and K = 4, as the modes force): ``--mode sgcls`` and
``--mode sgdet`` on ``--synthetic`` (GT-box videos in every mode, as in
``vidsgg``) print ``vidsgg``'s line formats with the object losses,
``vidsgg``'s metric order and saves, and train the OSPU; ``tempura_test
--ckpt`` then serves their ``checkpoint_final`` with a strict restore, the
OSPU included. The predcls runs, the refused flags and the sources are in
``test_torch_train_cli.py``, whose in-memory checkpoint store this file
uses (nothing reaches the disk).
"""

import re

import pytest
import torch
from test_torch_train_cli import LAYERS, NUM, STEP_LINE, VAL_LINE, MemoryStore, vidsgg_saves

import vidsgg_torch.cli.tempura_test as tcli
import vidsgg_torch.cli.tempura_train as tcli_train

# sgcls and sgdet add the object losses (vidsgg's order: sorted by key)
OBJECT_STEP_LINE = re.compile(
    rf"^epoch (\d+) step (\d+)  [0-9]+\.[0-9]{{3}}s/video  attention_relation_loss={NUM}  "
    rf"contacting_relation_loss={NUM}  grad_norm={NUM}  object_contrastive_loss={NUM}  "
    rf"object_loss={NUM}  spatial_relation_loss={NUM}  total_loss={NUM}$", re.M)


@pytest.mark.parametrize("mode", ["sgcls", "sgdet"])
def test_object_modes_train_save_and_serve_as_vidsgg(mode, tmp_path, capsys, monkeypatch):
    """``--mode sgcls`` and ``--mode sgdet`` on ``--synthetic`` (GT-box
    videos in every mode, as in ``vidsgg``): the object losses in the step
    lines, vidsgg's saves, the OSPU trained (tracking, K = 4, the
    ``euc_con`` object loss); then ``tempura_test --ckpt`` serves
    ``checkpoint_final`` with a strict restore, the OSPU included."""
    store = MemoryStore(monkeypatch, keep=("checkpoint_final",))
    capsys.readouterr()
    state = tcli_train.main(["--device", "cpu", "--mode", mode, "--synthetic", "2",
                             "--nepoch", "1", "-log_iter", "1", "--save_path",
                             str(tmp_path / "run")] + LAYERS)
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[0] == f">>> TEMPURA train: mode={mode} synthetic=2"
    assert lines[-1] == ">>> TEMPURA train complete"
    assert [s for _, s in OBJECT_STEP_LINE.findall(out)] == ["1", "2"]
    assert not STEP_LINE.findall(out) and VAL_LINE.findall(out) == ["0"]
    assert [name for _, name in store.names] == vidsgg_saves(lines)
    cfg = state.model.cfg
    assert (cfg.mode, cfg.k, cfg.tracking, cfg.track_layers) == (mode, 4, True, 3)
    assert state.step == 2 and state.optimizer.updates == 2
    params = dict(state.model.named_parameters())
    assert set(state.optimizer.state[params["object_classifier.pos_embed.1.weight"]]
               ["step"].tolist()) == {2}

    served = {}
    restore = tcli.restore_serving

    def keep(s, payload):
        served["state"] = restore(s, payload)
        return served["state"]

    monkeypatch.setattr(tcli, "restore_serving", keep)
    evs = tcli.main(["--device", "cpu", "--mode", mode, "--synthetic", "2", "--ckpt", "ckpts",
                     "--ckpt_name", "checkpoint_final", "--output_path", str(tmp_path)] + LAYERS)
    assert "restored checkpoint checkpoint_final from ckpts" in capsys.readouterr().out
    got = served["state"]
    want_sd = state.model.state_dict()
    assert sorted(got.model.state_dict()) == sorted(want_sd)
    assert any(k.startswith("object_classifier.") for k in want_sd)
    for k, v in got.model.state_dict().items():
        assert torch.equal(v, want_sd[k]), k
    assert torch.equal(got.rel_memory, state.rel_memory) and bool(got.mem_active)
    assert all(0 <= ev.recall_at(20) <= 1 for ev in evs)
