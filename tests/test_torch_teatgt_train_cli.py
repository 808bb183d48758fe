"""The port's TEAT-GT train CLI on the CPU (``--device cpu``) at tiny
widths (d = 32, FFN 48, 2 layers x 4 heads) with both consistency losses
and ``--use_ctl_loss``, against ``vidsgg``'s CLI and what it hands on:

* ``teatgt_train --mode predcls --synthetic 2 --nepoch 2 --log_iter 1``
  prints ``vidsgg``'s lines (the banner, the step lines with the metrics in
  the key order of ``vidsgg``'s jitted step and their values, the
  validation and "new best" lines), saves ``vidsgg``'s checkpoint names in
  its order, and ends with ``vidsgg``'s parameters and AdamW counts (every
  parameter at 1e-8 x max(1, max|ref|), the regularizer's included);
* ``--resume`` restores the step, the parameters and the optimizer's
  counts and moments exactly; the CLI also trains over an Action Genome
  tree;
* ``teatgt_test --ckpt DIR --ckpt_name NAME`` restores the train CLI's
  checkpoint bit for bit and serves it: its grids equal those of the
  trained state served directly;
* a checkpoint names the model it holds: ``tempura_test --ckpt`` refuses a
  TEAT-GT checkpoint and ``teatgt_test --ckpt`` a TEMPURA one;
* the refused flags exit naming their items; without ``--device cpu``
  the CLI raises here (no card). ``--mode sgcls``, ``--mode sgdet``,
  ``--rand_node_id`` and ``--orf_node_id`` against ``vidsgg``'s CLI:
  ``test_torch_teatgt_train_cli_modes.py``, through :func:`run_both`.

Both CLIs train in float64 (JAX in its x64 context; the port's model
built in float64) from ``vidsgg``'s seeded weights (its initialiser
replaced by ``random_tree`` draws over the same tree). The port is handed
what the two packages cannot share by computing it:

* the videos ``vidsgg``'s synthetic sources yield, call by call, given
  AG's video size (``AG_VIDEO_SIZE``): the two sources featurize in
  float32, XLA's rounding against torch's, and one ulp can move a token
  pair across the 0.75 cosine threshold of TEAT-GT's temporal edges (the
  sources are held to each other in ``test_torch_train_cli.py``);
* ``vidsgg``'s dropout masks and sign flips of every step
  (``SharedNoise.replay_all``);
* its eigendecompositions in call order (``EigBridge``: the train steps'
  clip and frame graphs, then validation's), and with ``--orf_node_id``
  its orthogonal random matrices (``DrawBridge``) and with
  ``--rand_node_id`` its test-time identifiers (``JaxFixedDraws``);
* the gradients whose true value is 0 and which each package computes as
  its own rounding noise, which decides whether AdamW skips a tensor: the
  pooling gates' biases, and the structural encoder on a step whose frame
  graphs are alike (``RoundingNoiseBridge``).

``vidsgg``'s orbax saver is replaced by a recorder of names; the port's
checkpoints stay in memory (``MemoryStore``).
"""

import contextlib
import dataclasses
import io
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from teatgt_parity_utils import DrawBridge, EigBridge, JaxFixedDraws, RoundingNoiseBridge
from test_torch_train_cli import NUM, VAL_LINE, MemoryStore, vidsgg_saves
from torch_parity_utils import entry_to_torch, random_tree, write_ag_tree
from train_parity_utils import SharedNoise, adamw_counts, adamw_moments, close, compare_state

import vidsgg.cli.data_source as jds
import vidsgg.cli.teatgt_train as jcli_train
import vidsgg.train.loop as jloop
import vidsgg_torch.cli.data_source as tds
import vidsgg_torch.cli.teatgt_test as tcli
import vidsgg_torch.cli.teatgt_train as tcli_train
import vidsgg_torch.cli.tempura_test as tempura_test
import vidsgg_torch.models.tokengt as ttokengt
from vidsgg.configs.teatgt import TeatGTRunConfig as JRunConfig
from vidsgg.data.entry import Entry as JEntry
from vidsgg.data.entry import EntryCapacity as JCap
from vidsgg.models.convert_teatgt import expected_teatgt_shapes
from vidsgg.models.graph_build import ClipCaps as JClipCaps
from vidsgg.train.state import TrainState
from vidsgg_torch.cli.teatgt_test import SYNTHETIC_CLIPS
from vidsgg_torch.convert import teatgt_from_jax
from vidsgg_torch.data.entry import EntryCapacity
from vidsgg_torch.eval import get_ag_evaluators
from vidsgg_torch.models import TeatGT, Tempura
from vidsgg_torch.train import EvalPipeline, create_train_state
from vidsgg_torch.train.checkpoint import checkpoint_format

MODEL = ["--encoder_layers", "2", "--encoder_attention_heads", "4", "--encoder_embed_dim", "32",
         "--encoder_ffn_embed_dim", "48", "--use_cons_str_loss", "--use_cons_sem_loss"]
RUN = ["--mode", "predcls", "--synthetic", "2", "--nepoch", "2", "--log_iter", "1",
       "--use_ctl_loss"] + MODEL
# the metrics in vidsgg's order: its jitted step returns them sorted by key
STEP_LINE = re.compile(
    rf"^epoch (\d+) step (\d+)  [0-9]+\.[0-9]{{3}}s/video  attention_con_loss={NUM}  "
    rf"attention_relation_loss={NUM}  contact_con_loss={NUM}  "
    rf"contacting_relation_loss={NUM}  grad_norm={NUM}  semantic_temp_loss={NUM}  "
    rf"spatial_con_loss={NUM}  spatial_relation_loss={NUM}  structure_temp_loss={NUM}  "
    rf"total_loss={NUM}$", re.M)


STEPS = 4                       # 2 videos x 2 epochs
# vidsgg's synthetic GT-box entries keep video size 1, so their frame
# graphs have no edges and every step's structural loss is 0; with AG's
# size one training video's frame graphs differ between frames (a real
# structural gradient) and the other's are alike in every frame (a step
# of loss 0, whose rounding noise RoundingNoiseBridge hands over)
AG_VIDEO_SIZE = np.array([480.0, 270.0], np.float32)
TIMING = re.compile(r"  [0-9]+\.[0-9]{3}s/video  ")


def _words_and_numbers(line):
    """A log line as (its text with each number replaced by #, its numbers)."""
    numbers = [float(x) for x in re.findall(NUM, line)]
    return re.sub(NUM, "#", line), numbers


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = main(list(argv))
    return state, out.getvalue()


def float64_teatgt(monkeypatch, module, variables=None):
    """``module``'s ``TeatGT`` built in float64 (loaded from ``vidsgg``'s
    ``variables`` where given)."""

    def build(cfg, device, generator):
        model = TeatGT(cfg, device=device, generator=generator).double()
        if variables is not None:
            model.load_state_dict(teatgt_from_jax(variables, cfg))
        return model

    monkeypatch.setattr(module, "TeatGT", build)


def run_both(mp, tmp, mode="predcls", config=(), videos=2, epochs=2, model=MODEL):
    """``vidsgg``'s run of ``teatgt_train --mode <mode> --synthetic <videos>
    --nepoch <epochs> --log_iter 1 --use_ctl_loss`` with the ``model`` and
    ``config`` flags, and the port's, in float64, the port handed
    ``vidsgg``'s weights, videos, draws, decompositions and (with a
    consistency loss) rounding noise: (vidsgg's final state, its stdout,
    its saves), (the port's state, stdout, store), the rounding bridge
    (None without a consistency loss)."""
    jsaves = []
    config = ["--mode", mode] + list(model) + list(config)
    argv = config + ["--synthetic", str(videos), "--nepoch", str(epochs), "--log_iter", "1",
                     "--use_ctl_loss"]
    steps = videos * epochs
    run_cfg = JRunConfig.from_args(config)
    # built before the recorders patch JAX: this trace would be recorded too
    with jax.enable_x64(True):
        shapes = expected_teatgt_shapes(run_cfg.model_config(JClipCaps(*dataclasses.astuple(
            SYNTHETIC_CLIPS))), JEntry.zeros(JCap(16, 48, 32)))
    variables = random_tree(shapes, np.random.default_rng(5), np.float64)

    def state(model, cfg, entry_template, rng, tx):
        params = jax.tree.map(jnp.asarray, variables["params"])
        assert jax.tree.map(np.shape, params) == jax.tree.map(np.shape, shapes["params"])
        assert not cfg.tracking          # vidsgg's _MemCfg: a [36, 1024] object bank
        return TrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=jax.tree.map(jnp.asarray, variables.get("batch_stats", {})),
            opt_state=tx.init(params), rel_memory=jnp.zeros((26, 1936)),
            obj_memory=jnp.zeros((36, 1024)), mem_active=jnp.asarray(False),
            apply_fn=model.apply, tx=tx)

    # vidsgg's draws inside its train steps (its data pipeline draws too)
    noise = SharedNoise(mp, heads=(), rows=set())
    noise.active = False
    base_step = jloop.make_train_step

    def make_train_step(flags):
        step = base_step(flags)

        def recorded(*args):
            noise.active = True
            try:
                return step(*args)
            finally:
                noise.active = False
        return recorded

    mp.setattr(jloop, "make_train_step", make_train_step)
    bridge = EigBridge(mp)
    draws = DrawBridge(mp, noise)
    rounding = RoundingNoiseBridge(mp) if run_cfg.use_cons_str_loss else None
    mp.setattr(jcli_train, "create_train_state", state)
    mp.setattr(jloop, "save_checkpoint", lambda path, st, name: jsaves.append((name, st)))
    # every video vidsgg's sources yield, call by call (the first video's
    # probe, the epochs' shuffled orders, validation), given AG's video
    # size, so that the frame graphs have edges
    calls = {True: [], False: []}
    base_source = jds.make_synthetic_source

    def recording_source(n_videos, cap, seed=0, shuffle=True, **kw):
        src = base_source(n_videos, cap, seed=seed, shuffle=shuffle, **kw)

        def source():
            calls[shuffle].append([])
            for entry, fmaps, ann in src():
                video = (entry.replace(video_size=jnp.asarray(AG_VIDEO_SIZE)), fmaps, ann)
                calls[shuffle][-1].append(video)
                yield video
        return source

    mp.setattr(jds, "make_synthetic_source", recording_source)
    with jax.enable_x64(True):
        jstate, jout = _run(jcli_train.main, argv + ["--save_path", str(tmp / "jax")])
    jax.effects_barrier()
    replay = noise.replay_all(steps)

    def create(model, **kw):
        st = create_train_state(model, **kw)
        if rounding is not None:
            rounding.install(st.optimizer, st.model)
        return st

    def replayed_source(n_videos, cap, seed=0, shuffle=True, device=None):
        def source():
            for entry, fmaps, ann in calls[shuffle].pop(0):
                yield entry_to_torch(entry), torch.from_numpy(np.asarray(fmaps)), ann
        return source

    mp.setattr(tds, "make_synthetic_source", replayed_source)
    float64_teatgt(mp, tcli_train, variables)
    mp.setattr(tcli_train, "Noise", types.SimpleNamespace(seeded=lambda seed, dev: replay))
    mp.setattr(tcli_train, "create_train_state", create)
    mp.setattr(ttokengt, "fixed_noise", JaxFixedDraws)
    store = MemoryStore(mp, keep=("checkpoint_final",), train_cli=tcli_train, test_cli=tcli)
    tstate, tout = _run(tcli_train.main, argv + ["--device", "cpu",
                                                 "--save_path", str(tmp / "port")])
    assert replay.exhausted() and not any(calls.values())
    bridge.assert_consumed()
    draws.assert_consumed(draws.calls)
    assert rounding is None or not rounding.recorded
    return (jstate, jout, jsaves), (tstate, tout, store), rounding


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The predcls runs of ``run_both``: 2 videos x 2 epochs."""
    mp = pytest.MonkeyPatch()
    try:
        jrun, trun, rounding = run_both(mp, tmp_path_factory.mktemp("teatgt_train_cli"))
        # one training video's frame graphs are alike in every frame: its
        # step in each epoch has a structural loss of 0
        assert rounding.structural_steps == 2
    finally:
        mp.undo()
    yield jrun, trun


def test_predcls_run_prints_and_saves_as_vidsgg(runs):
    (jstate, jout, jsaves), (state, out, store) = runs
    lines, jlines = out.splitlines(), jout.splitlines()
    assert lines[0] == jlines[0] == ">>> TEAT-GT train: mode=predcls synthetic=2"
    assert lines[-1] == jlines[-1] == ">>> TEAT-GT train complete"
    want_steps = [(str(i // 2), str(i + 1)) for i in range(STEPS)]
    assert STEP_LINE.findall(jout) == STEP_LINE.findall(out) == want_steps
    assert VAL_LINE.findall(jout) == VAL_LINE.findall(out) == ["0", "1"]
    assert len(STEP_LINE.findall(out)) == sum(line.startswith("epoch") and "step" in line
                                              for line in lines)
    # the values of every step line (its timing aside), validation and best
    # line: the same words, each number within one unit of its last printed
    # digit (two values 1e-10 apart can round to neighbouring digits)
    logged = [_words_and_numbers(TIMING.sub("  ", line)) for line in lines
              if line.startswith(("epoch", "new best"))]
    jlogged = [_words_and_numbers(TIMING.sub("  ", line)) for line in jlines
               if line.startswith(("epoch", "new best"))]
    assert [w for w, _ in logged] == [w for w, _ in jlogged]
    for (words, got), (_, want) in zip(logged, jlogged, strict=True):
        np.testing.assert_allclose(got, want, rtol=0, atol=1.5e-4, err_msg=words)
    saves = [name for _, name in store.names]
    assert saves == vidsgg_saves(lines)
    assert [name for name, _ in jsaves] == vidsgg_saves(jlines)
    assert state.step == int(jstate.step) == STEPS and state.optimizer.updates == STEPS
    assert not bool(state.mem_active)          # TEAT-GT trains with its memory off


def test_predcls_run_ends_with_vidsgg_parameters(runs):
    """The final parameters (the regularizer's included), every AdamW count
    and both AdamW moments against ``vidsgg``'s final state; its last
    checkpoint holds that state."""
    (jstate, _, jsaves), (state, _, _) = runs
    model = state.model
    assert {k.split(".")[0] for k in model.state_dict()} >= {"gat", "gat_semantic", "gap",
                                                             "gap_sem"}
    with jax.enable_x64(True):
        compare_state(jstate, model, model.cfg, "the final state", teatgt_from_jax)
        compare_state(dict(jsaves)["checkpoint_final"], model, model.cfg, "checkpoint_final",
                      teatgt_from_jax)
    got, want = adamw_counts(jstate, model, state.optimizer, teatgt_from_jax)
    for n in got:
        np.testing.assert_array_equal(got[n].numpy(), want[n], err_msg=n)
    for n, (g, w) in adamw_moments(jstate, model, state.optimizer, teatgt_from_jax).items():
        close(g, w, n)
    params = dict(model.named_parameters())
    for name in ("gat_semantic.attn_0.to_q.weight", "gat.ff_out_3.weight",
                 "TokenGT_encoder.graph_encoder.graph_feature.lap_encoder.weight"):
        assert set(state.optimizer.state[params[name]]["step"].tolist()) == {STEPS}, name


def test_resume_restores_the_state_exactly(runs, tmp_path, monkeypatch):
    _, (state, _, store) = runs
    float64_teatgt(monkeypatch, tcli_train)
    resumed_store = MemoryStore(monkeypatch, train_cli=tcli_train, test_cli=tcli)
    resumed_store.blobs["best_recall"] = store.blobs["checkpoint_final"]
    resumed, out = _run(tcli_train.main, RUN[:4] + ["--nepoch", "0", "--resume", "ckpts",
                                                    "--device", "cpu", "--save_path",
                                                    str(tmp_path)] + MODEL)
    assert "resumed from ckpts at step 4" in out
    assert resumed.step == state.step and resumed.optimizer.updates == 4
    want_sd = state.model.state_dict()
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, want_sd[k]), k
    for p, q in zip(resumed.model.parameters(), state.model.parameters(), strict=True):
        a, b = resumed.optimizer.state[p], state.optimizer.state[q]
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a[key], b[key]), key


def test_test_cli_serves_the_checkpoint(runs, tmp_path, monkeypatch):
    _, (state, _, store) = runs
    float64_teatgt(monkeypatch, tcli)
    MemoryStore(monkeypatch, train_cli=tcli_train, test_cli=tcli).blobs.update(store.blobs)
    served = {}
    restore = tcli.restore_serving

    def keep(s, payload):
        served["state"] = restore(s, payload)
        return served["state"]

    monkeypatch.setattr(tcli, "restore_serving", keep)
    evs, _ = _run(tcli.main, ["--device", "cpu", "--mode", "predcls", "--synthetic", "2",
                              "--ckpt", "ckpts", "--ckpt_name", "checkpoint_final"] + MODEL)
    got = served["state"]
    want_sd = state.model.state_dict()
    assert sorted(got.model.state_dict()) == sorted(want_sd)
    for k, v in got.model.state_dict().items():
        assert torch.equal(v, want_sd[k]), k
    # the same videos served from the trained state itself
    cap = EntryCapacity(max_frames=16, max_objs=48, max_pairs=32)
    assert state.model.cfg.caps == SYNTHETIC_CLIPS
    src = tds.make_synthetic_source(2, cap, seed=99, shuffle=False, stable=True, device="cpu")
    pipe = EvalPipeline("predcls", cap, needs_union=False, device="cpu")
    want = get_ag_evaluators("predcls", output_dir=str(tmp_path))
    for entry, fmaps, gt in src():
        pred = pipe(state, entry, fmaps, gt_entry=entry)
        for ev in want:
            ev.evaluate_scene_graph(gt, pred)
    for a, b in zip(evs, want, strict=True):
        for key, grid in b.result_dict.items():
            for k in grid:
                np.testing.assert_array_equal(a.result_dict[key][k], grid[k])


def test_train_cli_on_an_ag_tree(tmp_path, monkeypatch):
    """Over an Action Genome tree (GT boxes through the tiny detector): the
    two train videos, then validation over the test split."""
    root = write_ag_tree(tmp_path / "ag")
    store = MemoryStore(monkeypatch, train_cli=tcli_train, test_cli=tcli)
    state, out = _run(tcli_train.main, RUN[:1] + ["predcls", "--data_path", root,
                                                  "--frame_size", "48", "--tiny_detector",
                                                  "--bucket_frames", "32", "--nepoch", "1",
                                                  "--log_iter", "1", "--use_ctl_loss",
                                                  "--device", "cpu",
                                                  "--save_path", str(tmp_path / "run")] + MODEL)
    assert [s for _, s in STEP_LINE.findall(out)] == ["1", "2"]
    assert VAL_LINE.findall(out) == ["0"]
    assert "epoch 0 buckets: 16f=2  skipped=0" in out
    assert state.step == 2 and store.names[-1][1] == "checkpoint_final"


def test_checkpoints_name_their_model(runs, monkeypatch):
    """``tempura_test --ckpt`` on the TEAT-GT run's checkpoint, and
    ``teatgt_test --ckpt`` on a TEMPURA one, stop with a message that
    names both formats."""
    _, (_, _, store) = runs
    MemoryStore(monkeypatch).blobs["checkpoint_final"] = store.blobs["checkpoint_final"]
    ckpt = ["--device", "cpu", "--mode", "predcls", "--synthetic", "1", "--ckpt", "ckpts",
            "--ckpt_name", "checkpoint_final"]
    with pytest.raises(ValueError, match=r"'vidsgg_torch\.teatgt_train_state/1', not "
                                         r"'vidsgg_torch\.tempura_train_state/1'"):
        tempura_test.main(ckpt + ["-enc_layer", "1", "-dec_layer", "1"])
    buf = io.BytesIO()
    torch.save({"format": checkpoint_format(Tempura)}, buf)
    MemoryStore(monkeypatch, train_cli=tcli_train, test_cli=tcli).blobs["checkpoint_final"] = \
        buf.getvalue()
    with pytest.raises(ValueError, match=r"'vidsgg_torch\.tempura_train_state/1', not "
                                         r"'vidsgg_torch\.teatgt_train_state/1'"):
        tcli.main(ckpt + MODEL)


@pytest.mark.parametrize("flags,refused,item", [
    (["--data_parallel", "2"], "--data_parallel", "item 7b"),
    (["--int8"], "--int8", "item 7b"),
    (["--profile", "trace/"], "--profile", "item 7b"),
    (["--mode", "sgdet", "--pair_detect", "2"], "--pair_detect", "item 7b"),
])
def test_refused_flags_exit_naming_their_item(flags, refused, item):
    with pytest.raises(SystemExit) as exc:
        tcli_train.main(["--synthetic", "1", "--device", "cpu"] + flags)
    assert exc.value.code not in (0, None)
    assert f"ROADMAP.md queue 1 {item}" in str(exc.value.code)
    assert refused in str(exc.value.code)


def test_train_cli_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli_train.main(["--mode", "predcls", "--synthetic", "1"] + MODEL)
