"""The port's TEAT-GT train CLI against ``vidsgg``'s in ``--mode sgcls`` and
``--mode sgdet`` (``--synthetic``: GT-box videos in every mode, as in
``vidsgg``; 6 layers x 16 heads and the tracking OSPU, as both packages'
configurations force, at d = 32; the OSPU built with one tracking layer in
both packages, whose three are trained in ``chip_smoke.py`` and served in
``test_torch_teatgt_slice.py``). Its predcls runs with
``--rand_node_id`` and ``--orf_node_id``: ``test_torch_teatgt_train_cli_ids.py``.

Each case runs ``test_torch_teatgt_train_cli.py:run_both``: both CLIs in
float64 on the CPU over 2 videos x 1 epoch with ``--use_ctl_loss``, the
port handed ``vidsgg``'s weights (the OSPU's batch statistics among them),
videos, draws (the dropout masks of every step; with ``--rand_node_id``
its identifiers, with ``--orf_node_id`` its orthogonal random matrices,
and the test-time draws) and decompositions. Compared
(:func:`check_runs`): the log lines (the same words, each number within
one unit of its last printed digit), the saves in ``vidsgg``'s order, and
the final state, every parameter and batch-norm statistic at 1e-8 x
max(1, max|ref|), every AdamW count exactly and both moments; the object
bank [36, 1024] in every mode, as ``vidsgg``'s.
"""

import functools

import jax
import numpy as np
import pytest
from test_torch_teatgt_train_cli import MODEL, TIMING, _words_and_numbers, run_both
from test_torch_train_cli import vidsgg_saves
from train_parity_utils import adamw_counts, adamw_moments, close, compare_state

import vidsgg.models.teatgt as jteatgt
import vidsgg_torch.models.teatgt as tteatgt
from vidsgg_torch.convert import teatgt_from_jax

# the TokenGT widths without the consistency losses (predcls' test file
# holds them in the CLI)
WIDTHS = MODEL[:8]


def check_runs(mode, config, tmp_path, mp):
    """``run_both`` for ``--mode <mode>`` and ``config``, then the two runs
    compared."""
    try:
        (jstate, jout, jsaves), (state, out, store), _ = run_both(
            mp, tmp_path, mode, config, epochs=1, model=WIDTHS)
    finally:
        mp.undo()
    lines, jlines = out.splitlines(), jout.splitlines()
    assert lines[0] == jlines[0] == f">>> TEAT-GT train: mode={mode} synthetic=2"
    assert lines[-1] == jlines[-1] == ">>> TEAT-GT train complete"
    logged = [_words_and_numbers(TIMING.sub("  ", line)) for line in lines
              if line.startswith(("epoch", "new best"))]
    jlogged = [_words_and_numbers(TIMING.sub("  ", line)) for line in jlines
               if line.startswith(("epoch", "new best"))]
    assert [w for w, _ in logged] == [w for w, _ in jlogged]
    assert sum("step" in w for w, _ in logged) == 2
    assert all(("object_loss=#" in w) == (mode != "predcls") for w, _ in logged if "step" in w)
    for (words, got), (_, want) in zip(logged, jlogged, strict=True):
        np.testing.assert_allclose(got, want, rtol=0, atol=1.5e-4, err_msg=words)
    assert [name for _, name in store.names] == vidsgg_saves(lines)
    assert [name for name, _ in jsaves] == vidsgg_saves(jlines)

    model = state.model
    node_id = {"--rand_node_id": "rand", "--orf_node_id": "orf"}.get(next(iter(config), ""),
                                                                    "lap")
    assert (model.cfg.mode, model.cfg.node_id_mode, model.cfg.tracking) == (
        mode, node_id, mode != "predcls")
    assert tuple(state.obj_memory.shape) == (36, 1024)
    with jax.enable_x64(True):
        compare_state(jstate, model, model.cfg, "the final state", teatgt_from_jax)
    got, want = adamw_counts(jstate, model, state.optimizer, teatgt_from_jax)
    for n in got:
        np.testing.assert_array_equal(got[n].numpy(), want[n], err_msg=n)
    for n, (g, w) in adamw_moments(jstate, model, state.optimizer, teatgt_from_jax).items():
        close(g, w, n)
    assert state.step == int(jstate.step) == 2
    return state


@pytest.mark.parametrize("mode", ["sgcls", "sgdet"])
def test_train_cli_matches_vidsgg(mode, tmp_path):
    mp = pytest.MonkeyPatch()
    for module in (jteatgt, tteatgt):
        mp.setattr(module, "ObjectClassifier", functools.partial(module.ObjectClassifier,
                                                                 encoder_layers=1))
    state = check_runs(mode, [], tmp_path, mp)
    params = dict(state.model.named_parameters())       # the OSPU trained
    for name in ("object_classifier.encoder_tran.layers.0.linear2.weight",
                 "object_classifier.decoder_lin.0.weight"):
        assert set(state.optimizer.state[params[name]]["step"].tolist()) == {2}, name
