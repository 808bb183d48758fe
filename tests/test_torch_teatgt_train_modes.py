"""TEAT-GT sgcls and sgdet training in the port held step for step to
``vidsgg``'s: two steps each at tiny TokenGT widths (d = 32, FFN 48, 2
layers x 4 heads, the published k = 50 and regularizer k = 10) with the
OSPU in its train phase (linear head, one of TEAT-GT's 3 tracking layers
of 2376, its pe table 400 or 600 long), the ctl losses and the object
losses (``eos_coef`` 0.5 and the contrastive term), in float64 (JAX in its
x64 context):

* sgcls, with both consistency losses, on GT-box entries with a
  detector-style class distribution (6 frames of 1 person + 2 objects;
  the first step's video size 1, so its frame graphs have no edges, the
  second's AG's 480x270);
* sgdet on the train entries of ``test_torch_sgdet_train.py``'s tiny
  detector (assigned detections and SUPPLY rows), without the
  regularizer (held in sgcls and predcls): that file's
  ``test_two_steps_of_teatgt_sgdet_training_match_vidsgg``, which shares
  its fixture, through :func:`lock_step`.

Both start from the same seeded parameters and batch statistics carried
across by ``convert.py:teatgt_from_jax`` and run their own train step. The
draws are shared as in ``test_torch_teatgt_train.py`` (``SharedNoise``:
the OSPU's masks first, the position MLP's, the position table's and four
in each tracking layer, then TokenGT's; ``EigBridge``;
``RoundingNoiseBridge``). Compared at 1e-8 x max(1, max|ref|) per tensor
after each step: every loss term (``object_loss`` and
``object_contrastive_loss`` among them), ``total_loss`` and ``grad_norm``,
every parameter and batch-norm statistic, every AdamW count (exactly) and
both moments. The object bank of a TEAT-GT train state is [36, 1024] in
every mode, as ``vidsgg``'s (its CLIs build the state without tracking),
in the train state and in its checkpoint.
"""

import contextlib
import dataclasses
import functools
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from teatgt_parity_utils import EigBridge, RoundingNoiseBridge
from test_torch_train_cli import VAL_LINE, MemoryStore
from torch_parity_utils import entry_to_torch, random_tree, write_ag_tree
from train_parity_utils import SharedNoise, adamw_counts, adamw_moments, close, compare_state

import vidsgg.models.teatgt as jteatgt
import vidsgg_torch.cli.teatgt_test as tcli
import vidsgg_torch.cli.teatgt_train as tcli_train
import vidsgg_torch.models.teatgt as tteatgt
from vidsgg.data import build_gt_entry
from vidsgg.data.entry import Entry as JEntry
from vidsgg.data.entry import EntryCapacity as JCap
from vidsgg.data.synthetic import synthetic_video_annotation
from vidsgg.models.convert_teatgt import expected_teatgt_shapes
from vidsgg.models.graph_build import ClipCaps as JClipCaps
from vidsgg.models.teatgt import TeatGT as JTeatGT
from vidsgg.models.teatgt import TeatGTConfig as JConfig
from vidsgg.train import make_optimizer
from vidsgg.train import steps as jsteps
from vidsgg.train.state import TrainState as JTrainState
from vidsgg_torch.convert import teatgt_from_jax
from vidsgg_torch.models.graph_build import ClipCaps
from vidsgg_torch.models.teatgt import TeatGT, TeatGTConfig
from vidsgg_torch.train import LossFlags, create_train_state, make_train_step
from vidsgg_torch.train.checkpoint import checkpoint_payload
from vidsgg_torch.train.state import TEATGT_OBJ_DIM

TINY = dict(encoder_layers=2, encoder_attention_heads=4, encoder_embed_dim=32,
            encoder_ffn_embed_dim=48)
# the OSPU's tracking layers here (TEAT-GT builds 3; their train phase at 3
# is held on the card, and in serving by test_torch_teatgt_slice.py)
TRACK_LAYERS = 1
# OSPU: position MLP, position table, 4 in each tracking layer; TokenGT:
# eig dropout, the token sequence, 4 a layer
MASKS = 2 + 4 * TRACK_LAYERS + 2 + 4 * TINY["encoder_layers"]
SGCLS_CAP = JCap(max_frames=8, max_objs=24, max_pairs=16)
SGCLS_CLIPS = (5, 2, 24, 128, 8)
SGDET_CLIPS = (5, 1, 40, 160, 20)
VIDEO_SIZES = (np.ones(2), np.array([480.0, 270.0]))
# the train CLI's TokenGT at d = 32 (sgcls and sgdet: 6 x 16, as forced)
AG_MODEL = ["--encoder_embed_dim", "32", "--encoder_ffn_embed_dim", "32"]


def _flags(mode, consistency):
    return dict(mode=mode, use_ctl_loss=True, obj_con_loss="euc_con", eos_coef=0.5,
                use_cons_str_loss=consistency, use_cons_sem_loss=consistency,
                ctl_variant="teatgt")


def _sgcls_entry(seed, video_size):
    """An sgcls GT entry (6 frames of 1 person + 2 objects) with seeded
    features and the detector-style class distribution of ``vidsgg``'s
    synthetic source (+4 on the GT class), float fields in float64."""
    ann = synthetic_video_annotation(num_frames=6, objs_per_frame=2, seed=seed, stable=True)
    e = build_gt_entry(ann, SGCLS_CAP)
    rng = np.random.default_rng(seed)
    om = np.asarray(e.obj_mask)[:, None]
    logits = rng.standard_normal((SGCLS_CAP.max_objs, 36))
    logits[np.arange(SGCLS_CAP.max_objs), np.clip(np.asarray(e.labels) - 1, 0, 35)] += 4.0
    dist = np.exp(logits) / np.exp(logits).sum(1, keepdims=True) * om
    e = e.replace(features=rng.standard_normal((SGCLS_CAP.max_objs, 2048)) * om,
                  distribution=dist, video_size=video_size)
    return float64_entry(e)


def float64_entry(e):
    return e.replace(**{f.name: np.asarray(getattr(e, f.name), np.float64)
                        for f in dataclasses.fields(JEntry)
                        if np.asarray(getattr(e, f.name)).dtype.kind == "f"})


def lock_step(monkeypatch, mode, entries, cap, clips, seed, consistency=True):
    """Two train steps of each package on ``entries``, compared after each
    (``consistency``: both consistency losses, and the regularizer)."""
    for module in (jteatgt, tteatgt):
        monkeypatch.setattr(module, "ObjectClassifier", functools.partial(
            module.ObjectClassifier, encoder_layers=TRACK_LAYERS))
    kw = dict(TINY, use_cons_str_loss=consistency, use_cons_sem_loss=consistency)
    jcfg = JConfig.for_mode(mode, caps=JClipCaps(*clips), **kw)
    tcfg = TeatGTConfig.for_mode(mode, caps=ClipCaps(*clips), **kw)
    assert tcfg.tracking and tcfg.encoder_layers == 2
    with jax.enable_x64(True):
        shapes = expected_teatgt_shapes(jcfg, JEntry.zeros(cap))
    assert "object_classifier" in shapes["params"]
    assert ("gat" in shapes["params"]) == consistency
    variables = random_tree(shapes, np.random.default_rng(seed), np.float64)
    noise = SharedNoise(monkeypatch, heads=(), rows=set())
    bridge = EigBridge(monkeypatch)
    with jax.enable_x64(True):
        tx = make_optimizer(steps_per_epoch=len(entries))
        params = jax.tree.map(jnp.asarray, variables["params"])
        jstate = JTrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
            opt_state=tx.init(params), rel_memory=jnp.zeros((26, 1936)),
            obj_memory=jnp.zeros((36, 1024)), mem_active=jnp.asarray(False),
            apply_fn=JTeatGT(jcfg).apply, tx=tx)
        jtrain = jsteps.make_train_step(jsteps.LossFlags(**_flags(mode, consistency)))

        port = TeatGT(tcfg, device="cpu").double()
        port.load_state_dict(teatgt_from_jax(variables, tcfg))
        state = create_train_state(port, obj_dim=TEATGT_OBJ_DIM, steps_per_epoch=len(entries))
        assert tuple(state.obj_memory.shape) == (36, 1024)
        ttrain = make_train_step(LossFlags(**_flags(mode, consistency)))
        if consistency:
            RoundingNoiseBridge(monkeypatch).install(state.optimizer, port)

        for step, je in enumerate(entries):
            jstate, jm = jtrain(jstate, je, jax.random.PRNGKey(step))
            jax.effects_barrier()
            replay = noise.replay()
            assert len(replay.masks) == MASKS
            # the OSPU's masks first: the position MLP's [N, 128]
            assert tuple(replay.masks[0].shape) == (cap.max_objs, 128)
            tm = ttrain(state, entry_to_torch(je), replay)
            assert replay.exhausted()
            bridge.assert_consumed()
            assert list(tm) == list(jm)
            terms = {"object_loss", "object_contrastive_loss", "attention_con_loss"}
            cons = {"structure_temp_loss", "semantic_temp_loss"}
            assert terms | (cons if consistency else set()) <= set(jm)
            assert consistency or not cons & set(jm)
            for k in jm:
                close(tm[k], jm[k], f"{mode} step {step} {k}")
            compare_state(jstate, port, tcfg, f"{mode} after step {step}", teatgt_from_jax)
            got, want = adamw_counts(jstate, port, state.optimizer, teatgt_from_jax)
            for n in got:
                np.testing.assert_array_equal(got[n].numpy(), want[n],
                                              err_msg=f"{mode} step {step} count {n}")
            for n, (g, w) in adamw_moments(jstate, port, state.optimizer,
                                           teatgt_from_jax).items():
                close(g, w, f"{mode} step {step} {n}")
    assert state.step == int(jstate.step) == len(entries)
    # the OSPU trained
    counts = [int(state.optimizer.state[p]["step"].max()) for n, p in port.named_parameters()
              if n.startswith("object_classifier.encoder_tran.")]
    assert counts and set(counts) == {len(entries)}


def test_two_steps_of_teatgt_sgcls_training_match_vidsgg(monkeypatch):
    entries = [_sgcls_entry(90 + i, size) for i, size in enumerate(VIDEO_SIZES)]
    lock_step(monkeypatch, "sgcls", entries, SGCLS_CAP, SGCLS_CLIPS, seed=11)


@pytest.mark.parametrize("mode", ["predcls", "sgcls", "sgdet"])
def test_object_bank_is_1024_wide_in_every_mode(mode, monkeypatch):
    """TEAT-GT's train state holds ``vidsgg``'s [36, 1024] object bank in
    every mode (``TeatGTConfig.for_mode`` turns tracking on in sgcls and
    sgdet, whose TEMPURA bank would be 2376 wide), as ``teatgt_train``
    builds it (its runs against ``vidsgg``'s check the CLI's state:
    ``test_torch_teatgt_train_cli_modes.py``); its checkpoint payload holds
    that bank, and ``teatgt_test --ckpt``'s serving state restores it."""
    monkeypatch.setattr(tteatgt, "ObjectClassifier", functools.partial(
        tteatgt.ObjectClassifier, encoder_layers=TRACK_LAYERS))
    run_cfg = tcli.TeatGTRunConfig.from_args(["--mode", mode] + AG_MODEL)
    model = TeatGT(run_cfg.model_config(tcli.SYNTHETIC_CLIPS), device="cpu")
    assert model.cfg.tracking == (mode != "predcls")
    state = create_train_state(model, obj_dim=TEATGT_OBJ_DIM, steps_per_epoch=1)
    assert tuple(state.obj_memory.shape) == (36, TEATGT_OBJ_DIM) == (36, 1024)
    payload = checkpoint_payload(state)
    served = tcli.restore_serving(tcli.build_relation_state(run_cfg, tcli.SYNTHETIC_CLIPS,
                                                            "cpu"), payload)
    assert tuple(served.obj_memory.shape) == (36, 1024)


@pytest.mark.parametrize("mode", ["sgcls", "sgdet"])
def test_train_cli_on_an_ag_tree(mode, tmp_path, monkeypatch):
    """Over an Action Genome tree through the tiny detector (sgcls: GT
    boxes; sgdet: the detector's boxes, GT assignment and SUPPLY rows):
    the train videos with the object losses in their step lines, then
    validation over the test split (one 16-frame bucket: its two 3-frame
    videos; the longer two skipped); the OSPU (one tracking layer)
    trained."""
    root = write_ag_tree(tmp_path / "ag")
    store = MemoryStore(monkeypatch, train_cli=tcli_train, test_cli=tcli)
    monkeypatch.setattr(tteatgt, "ObjectClassifier", functools.partial(
        tteatgt.ObjectClassifier, encoder_layers=TRACK_LAYERS))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = tcli_train.main(["--mode", mode, "--data_path", root, "--frame_size", "48",
                                 "--tiny_detector", "--bucket_frames", "16", "--nepoch", "1",
                                 "--log_iter", "1", "--device", "cpu", "--save_path",
                                 str(tmp_path / "run")] + AG_MODEL)
    out = out.getvalue()
    steps = re.findall(r"^epoch 0 step (\d+)  .*object_loss=", out, re.M)
    assert steps == ["1", "2"], out[-2000:]
    assert VAL_LINE.findall(out) == ["0"]
    assert state.step == 2 and store.names[-1][1] == "checkpoint_final"
    assert tuple(state.obj_memory.shape) == (36, 1024)
    params = dict(state.model.named_parameters())
    counts = state.optimizer.state[params["object_classifier.decoder_lin.0.weight"]]["step"]
    assert set(counts.tolist()) == {2}


def test_train_cli_filters_small_boxes_as_vidsgg():
    """Both train CLIs build the Action Genome splits with
    ``filter_small_box`` on in sgcls and sgdet and off in predcls."""
    import vidsgg.cli.teatgt_train as jcli_train
    import vidsgg.data.action_genome as jag

    class Built(Exception):
        pass

    def splits(main, module, mode, *flags):
        seen = []

        def record(split, datasize, data_path, **kw):
            seen.append((split, kw["filter_small_box"]))
            if len(seen) == 2:
                raise Built
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(module, "ActionGenome", record)
            with pytest.raises(Built):
                main(["--mode", mode, "--data_path", "AG/", *flags])
        return seen

    for mode in ("predcls", "sgcls", "sgdet"):
        want = splits(jcli_train.main, jag, mode)
        assert splits(tcli_train.main, tcli_train, mode, "--device", "cpu") == want == [
            ("train", mode != "predcls"), ("test", mode != "predcls")]
