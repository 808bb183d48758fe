"""TEMPURA sgcls training in the port held step for step to ``vidsgg``'s:
the lock-step of ``test_torch_train_lockstep.py`` with the OSPU in its
train phase. 2 epochs x 2 videos at the full widths (d = 1936, objects
2376), one encoder, one decoder and one tracking layer, K = 4, the GMM
object head, joint relation memory and the object memory
(``obj_mem_compute``: the 2376-wide bank and its hallucinator), in float64
(JAX in its x64 context).

The shared draws (``train_parity_utils.SharedNoise``): the dropout masks
of the OSPU (after the position MLP, after the position table, four in the
tracking layer) come first in ``vidsgg``'s traced step, then the relation
stack's eight, and ``ReplayNoise`` checks that the port draws every one in
that order with its shape; the GMM noise goes to the object head (37
classes, one [N, K, 37] draw) and then the three predicate heads.

Compared at 1e-8 x max(1, max|ref|) per tensor: every step's losses
(``object_loss`` and ``object_contrastive_loss`` included) and
``grad_norm``; after every step all parameters and the batch-norm
statistics (the OSPU's ``pos_bn`` at ``vidsgg``'s momentum 0.001 and
``inter_bn`` at 0.1); both banks after each epoch; and the AdamW counts of
both hallucinators, 0 through epoch 0 (empty banks: zero gradients,
skipped) and 1, 2 in epoch 1. A one-step case runs the CLI's default
object head (linear: raw logits over all 37 classes in the train phase, no
object memory), and one case holds ``pos_bn``'s running statistics after
a train-phase forward of the OSPU alone to ``vidsgg``'s momentum.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_parity_utils import entry_to_torch, random_tree
from train_parity_utils import SharedNoise, adamw_counts, close, compare_state

from vidsgg.data import build_gt_entry
from vidsgg.data.entry import Entry as JEntry
from vidsgg.data.entry import EntryCapacity as JCap
from vidsgg.data.synthetic import synthetic_video_annotation
from vidsgg.debias import memory as jmem
from vidsgg.models.convert_relation import expected_tempura_shapes
from vidsgg.models.ospu import ObjectClassifier as JObjectClassifier
from vidsgg.models.tempura import Tempura as JTempura
from vidsgg.models.tempura import TempuraConfig as JConfig
from vidsgg.train import make_optimizer
from vidsgg.train import steps as jsteps
from vidsgg.train.state import TrainState as JTrainState
from vidsgg.train.state import obj_memory_dim
from vidsgg_torch.convert import _object_classifier, tempura_from_jax
from vidsgg_torch.debias import memory as tmem
from vidsgg_torch.models.noise import Noise
from vidsgg_torch.models.ospu import POS_BN_MOMENTUM, ObjectClassifier
from vidsgg_torch.models.tempura import Tempura, TempuraConfig
from vidsgg_torch.train import LossFlags, create_train_state, eval_step, make_train_step

CAP = JCap(max_frames=4, max_objs=10, max_pairs=8)
K = 4
VIDEOS, EPOCHS = 2, 2
# OSPU: position MLP, position table, 4 in the tracking layer; relation: 8
OSPU_MASKS, MASKS = 6, 14
HEADS = (37, 3, 6, 17)          # the GMM heads' class counts, in call order
HALLUCINATORS = ("glocal_transformer.mem_attention.in_proj_weight",
                 "glocal_transformer.mem_attention.out_proj.weight",
                 "object_classifier.mem_attention.in_proj_weight",
                 "object_classifier.mem_attention.out_proj.weight")
FLAGS = dict(mode="sgcls", use_ctl_loss=True, obj_con_loss="euc_con", eos_coef=0.5,
             lambda_con=0.7)


def _entry(seed):
    """An sgcls GT entry (3 frames of 1 person + 2 objects): seeded
    features, union features and spatial masks, and the detector-style
    class distribution of ``vidsgg``'s synthetic source (+4 on the GT
    class), float fields in float64."""
    ann = synthetic_video_annotation(num_frames=3, objs_per_frame=2, seed=seed)
    e = build_gt_entry(ann, CAP)
    rng = np.random.default_rng(seed)
    om = np.asarray(e.obj_mask)[:, None]
    pm = np.asarray(e.pair_mask)[:, None, None, None]
    logits = rng.standard_normal((CAP.max_objs, 36))
    logits[np.arange(CAP.max_objs), np.clip(np.asarray(e.labels) - 1, 0, 35)] += 4.0
    dist = np.exp(logits) / np.exp(logits).sum(1, keepdims=True) * om
    e = e.replace(features=rng.standard_normal((CAP.max_objs, 2048)) * om,
                  distribution=dist,
                  union_feat=rng.standard_normal((CAP.max_pairs, 7, 7, 1024)) * 0.5 * pm,
                  spatial_masks=(rng.random((CAP.max_pairs, 2, 27, 27)) - 0.5) * pm)
    return e.replace(**{f.name: np.asarray(getattr(e, f.name), np.float64)
                        for f in dataclasses.fields(JEntry)
                        if np.asarray(getattr(e, f.name)).dtype.kind == "f"})


def _models(kw, seed, mode="sgcls", cap=CAP, steps_per_epoch=VIDEOS):
    """``vidsgg``'s train state and the port's, from the same seeded tree."""
    jcfg, tcfg = JConfig.for_mode(mode, **kw), TempuraConfig.for_mode(mode, **kw)
    with jax.enable_x64(True):
        shapes = expected_tempura_shapes(jcfg, JEntry.zeros(cap))
        variables = random_tree(shapes, np.random.default_rng(seed), np.float64)
        tx = make_optimizer(steps_per_epoch=steps_per_epoch)
        params = jax.tree.map(jnp.asarray, variables["params"])
        jstate = JTrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
            opt_state=tx.init(params), rel_memory=jnp.zeros((26, 1936)),
            obj_memory=jnp.zeros((36, obj_memory_dim(jcfg))), mem_active=jnp.asarray(False),
            apply_fn=JTempura(jcfg).apply, tx=tx)
    port = Tempura(tcfg, device="cpu").double()
    port.load_state_dict(tempura_from_jax(variables, tcfg))
    return jstate, port, tcfg


def _step_both(jtrain, ttrain, jstate, state, je, te, noise, step):
    """One train step of each, the port on ``vidsgg``'s draws; the metrics
    compared. Returns ``vidsgg``'s new state."""
    jstate, jm = jtrain(jstate, je, jax.random.PRNGKey(step))
    jax.effects_barrier()        # every mask callback has run
    replay = noise.replay()
    assert len(replay.masks) == MASKS and [tuple(n.shape[1:]) for n in replay.normals] == [
        (K, c) for c in HEADS]
    tm = ttrain(state, te, replay)
    assert replay.exhausted()
    assert list(tm) == list(jm)
    assert "object_loss" in tm and "object_contrastive_loss" in tm
    for k in jm:
        close(tm[k], jm[k], f"step {step} {k}")
    return jstate


def test_two_epochs_of_sgcls_training_match_vidsgg(monkeypatch):
    kw = dict(enc_layers=1, dec_layers=1, track_layers=1, obj_head="gmm", rel_head="gmm",
              obj_mem_compute=True)
    entries = [_entry(60 + i) for i in range(VIDEOS)]
    tentries = [entry_to_torch(e) for e in entries]
    jstate, port, tcfg = _models(kw, seed=3)
    noise = SharedNoise(monkeypatch, heads=HEADS,
                        rows={(CAP.max_pairs, K), (CAP.max_objs, K)})

    with jax.enable_x64(True):
        jtrain = jsteps.make_train_step(jsteps.LossFlags(**FLAGS))
        state = create_train_state(port, steps_per_epoch=VIDEOS)
        ttrain = make_train_step(LossFlags(**FLAGS))
        assert port.object_classifier.pos_embed[0].momentum == POS_BN_MOMENTUM == 0.001
        step = 0
        for epoch in range(EPOCHS):
            jacc = jmem.MemoryAccumulator.zeros(obj_dim=2376)
            tacc = tmem.MemoryAccumulator.zeros(obj_dim=2376, dtype=torch.float64,
                                                device="cpu")
            for je, te in zip(entries, tentries):
                jstate = _step_both(jtrain, ttrain, jstate, state, je, te, noise, step)
                compare_state(jstate, port, tcfg, f"after step {step}")
                got, want = adamw_counts(jstate, port, state.optimizer)
                for n in got:
                    np.testing.assert_array_equal(got[n].numpy(), want[n],
                                                  err_msg=f"step {step} count {n}")
                for n in HALLUCINATORS:   # skipped while the banks are empty
                    assert set(np.unique(want[n])) == {0 if epoch == 0 else step - VIDEOS + 1}

                jout = jsteps.eval_step_jit(jstate, je, True)
                tout = eval_step(state, te, unc=True)
                jacc = jmem.accumulate_memory(jacc, je, jout, "simple", "simple", True)
                tacc = tmem.accumulate_memory(tacc, te, tout, "simple", "simple", True)
                step += 1
            jrel, jobj = jmem.finalize_memory(jacc)
            trel, tobj = tmem.finalize_memory(tacc)
            close(trel, jrel, f"relation bank, epoch {epoch}")
            close(tobj, jobj, f"object bank, epoch {epoch}")
            assert float(np.abs(np.asarray(jobj)).max()) > 0
            jstate = jstate.with_memory(jrel, jobj)
            state = state.with_memory(trel, tobj)
    assert state.step == int(jstate.step) == EPOCHS * VIDEOS
    assert state.optimizer.updates == EPOCHS * VIDEOS


def test_one_step_with_the_cli_object_head_matches_vidsgg(monkeypatch):
    kw = dict(enc_layers=1, dec_layers=1, track_layers=1, obj_head="linear", rel_head="gmm")
    je = _entry(70)
    jstate, port, tcfg = _models(kw, seed=4)
    noise = SharedNoise(monkeypatch, heads=HEADS[1:], rows={(CAP.max_pairs, K)})
    with jax.enable_x64(True):
        jtrain = jsteps.make_train_step(jsteps.LossFlags(**FLAGS))
        state = create_train_state(port, steps_per_epoch=1)
        jstate, jm = jtrain(jstate, je, jax.random.PRNGKey(9))
        jax.effects_barrier()
        replay = noise.replay()
        assert len(replay.masks) == MASKS
        tm = make_train_step(LossFlags(**FLAGS))(state, entry_to_torch(je), replay)
        assert replay.exhausted()
        for k in jm:
            close(tm[k], jm[k], k)
        compare_state(jstate, port, tcfg, "after the step")


def test_pos_bn_tracks_at_vidsggs_momentum():
    """One train-phase forward of the OSPU alone: ``pos_bn``'s running
    statistics against ``vidsgg``'s, which move at momentum 0.01 / 10 (at
    the default 0.1 they would move 100 times too far)."""
    je = _entry(80)
    with jax.enable_x64(True):
        jospu = JObjectClassifier(mode="sgcls", obj_head="linear", k=K, tracking=True,
                                  encoder_layers=1, max_pe_len=400)
        shapes = jax.eval_shape(lambda r: jospu.init(r, je), jax.random.PRNGKey(0))
        variables = random_tree(shapes, np.random.default_rng(5), np.float64)
        _, mutated = jospu.apply(variables, je, phase="train", deterministic=False,
                                 mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
    sd = {}
    _object_classifier(sd, {"object_classifier": variables["params"]},
                       {"object_classifier": variables["batch_stats"]}, True, "linear", K)
    port = ObjectClassifier(obj_head="linear", k=K, tracking=True, encoder_layers=1,
                            max_pe_len=400).double()
    port.load_state_dict({k.split(".", 1)[1]: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in sd.items()})
    out = port(entry_to_torch(je), phase="train", noise=Noise.seeded(0, "cpu"))
    assert out["distribution"].shape == (CAP.max_objs, 37)     # raw logits, every class
    bn = port.pos_embed[0]
    want, before = mutated["batch_stats"]["pos_bn"], variables["batch_stats"]["pos_bn"]
    close(bn.running_mean, want["mean"], "pos_bn mean")
    close(bn.running_var, want["var"], "pos_bn var")
    assert float(np.abs(np.asarray(want["mean"]) - before["mean"]).max()) > 0
