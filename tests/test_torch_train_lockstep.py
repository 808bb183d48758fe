"""TEMPURA predcls training in the port held step for step to ``vidsgg``'s:
2 epochs x 2 videos at the full widths (d = 1936, FF 2048), one encoder and
one decoder layer, K = 6, joint relation memory, in float64 (JAX in its
x64 context).

Both start from the same seeded parameters (``vidsgg``'s tree, carried
across by ``convert.py:tempura_from_jax``) and run their own train step
(``vidsgg.train.make_train_step`` against the port's), test-phase
``unc=True`` forward, ``accumulate_memory`` and, at the end of each epoch,
``finalize_memory`` and ``with_memory``. The random draws are shared:

* the GMM heads' noise (``jax.random.normal``, one [P, K, C] draw per
  head and step) is recorded inside ``vidsgg``'s jitted step
  (``jax.debug.callback``) and dispatched to the port's heads by class
  count (attention 3, spatial 6, contacting 17), the scheme of
  ``tests/test_reference_oracle_grad.py``'s ``_SharedNoise``
  (``train_parity_utils.SharedNoise``);
* every dropout mask ``vidsgg`` draws (``jax.random.bernoulli``) is
  recorded in call order with its shape, and the port's train step
  replays them (``ReplayNoise`` checks each shape and that all were
  used).

Compared at 1e-8 x max(1, max|ref|) per tensor: every step's losses and
``grad_norm``; after every step all parameters and the batch-norm
statistics; the banks after each epoch; and the memory hallucinator's
per-tensor AdamW counts, which stay 0 through epoch 0 (empty banks: zero
gradients, skipped) and count 1, 2 in epoch 1.
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
from vidsgg.models.tempura import Tempura as JTempura
from vidsgg.models.tempura import TempuraConfig as JConfig
from vidsgg.train import make_optimizer
from vidsgg.train import steps as jsteps
from vidsgg.train.state import TrainState as JTrainState
from vidsgg_torch.convert import tempura_from_jax
from vidsgg_torch.debias import memory as tmem
from vidsgg_torch.models.tempura import Tempura, TempuraConfig
from vidsgg_torch.train import LossFlags, create_train_state, eval_step, make_train_step

CAP = JCap(max_frames=4, max_objs=10, max_pairs=8)
K = 6
VIDEOS, EPOCHS = 2, 2
HALLUCINATOR = ("glocal_transformer.mem_attention.in_proj_weight",
                "glocal_transformer.mem_attention.out_proj.weight")


def _entry(seed):
    """A predcls GT entry (3 frames of 1 person + 2 objects) with seeded
    features, union features and spatial masks, float fields in float64."""
    ann = synthetic_video_annotation(num_frames=3, objs_per_frame=2, seed=seed)
    e = build_gt_entry(ann, CAP)
    rng = np.random.default_rng(seed)
    om = np.asarray(e.obj_mask)[:, None]
    pm = np.asarray(e.pair_mask)[:, None, None, None]
    e = e.replace(features=rng.standard_normal((CAP.max_objs, 2048)) * om,
                  union_feat=rng.standard_normal((CAP.max_pairs, 7, 7, 1024)) * 0.5 * pm,
                  spatial_masks=(rng.random((CAP.max_pairs, 2, 27, 27)) - 0.5) * pm)
    return e.replace(**{f.name: np.asarray(getattr(e, f.name), np.float64)
                        for f in dataclasses.fields(JEntry)
                        if np.asarray(getattr(e, f.name)).dtype.kind == "f"})


def test_two_epochs_of_predcls_training_match_vidsgg(monkeypatch):
    kw = dict(mode="predcls", enc_layers=1, dec_layers=1, k=K, rel_head="gmm")
    jcfg, tcfg = JConfig(**kw), TempuraConfig(**kw)
    flags_kw = dict(mode="predcls", use_ctl_loss=True)
    entries = [_entry(40 + i) for i in range(VIDEOS)]
    tentries = [entry_to_torch(e) for e in entries]
    with jax.enable_x64(True):
        shapes = expected_tempura_shapes(jcfg, JEntry.zeros(CAP))
    variables = random_tree(shapes, np.random.default_rng(1), np.float64)
    noise = SharedNoise(monkeypatch, heads=(3, 6, 17), rows={(CAP.max_pairs, K)})

    with jax.enable_x64(True):
        model = JTempura(jcfg)
        tx = make_optimizer(steps_per_epoch=VIDEOS)
        params = jax.tree.map(jnp.asarray, variables["params"])
        jstate = JTrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
            opt_state=tx.init(params), rel_memory=jnp.zeros((26, 1936)),
            obj_memory=jnp.zeros((36, 1024)), mem_active=jnp.asarray(False),
            apply_fn=model.apply, tx=tx)
        jtrain = jsteps.make_train_step(jsteps.LossFlags(**flags_kw))

        port = Tempura(tcfg, device="cpu").double()
        port.load_state_dict(tempura_from_jax(variables, tcfg))
        state = create_train_state(port, steps_per_epoch=VIDEOS)
        ttrain = make_train_step(LossFlags(**flags_kw))

        step = 0
        for epoch in range(EPOCHS):
            jacc = jmem.MemoryAccumulator.zeros()
            tacc = tmem.MemoryAccumulator.zeros(dtype=torch.float64, device="cpu")
            for je, te in zip(entries, tentries):
                jstate, jm = jtrain(jstate, je, jax.random.PRNGKey(step))
                jax.effects_barrier()        # every mask callback has run
                replay = noise.replay()
                # 4 dropouts a layer, in call order: attention weights, the
                # two residual branches and the feed-forward
                assert len(replay.masks) == 8
                tm = ttrain(state, te, replay)
                assert replay.exhausted()
                assert list(tm) == list(jm)        # the key order of vidsgg's log lines
                for k in jm:
                    close(tm[k], jm[k], f"step {step} {k}")
                compare_state(jstate, port, tcfg, f"after step {step}")
                got, want = adamw_counts(jstate, port, state.optimizer)
                for n in got:
                    np.testing.assert_array_equal(got[n].numpy(), want[n],
                                                  err_msg=f"step {step} count {n}")
                # the hallucinator: skipped while the banks are empty
                for n in HALLUCINATOR:
                    assert set(np.unique(want[n])) == {0 if epoch == 0 else step - VIDEOS + 1}

                jout = jsteps.eval_step_jit(jstate, je, True)
                tout = eval_step(state, te, unc=True)
                jacc = jmem.accumulate_memory(jacc, je, jout)
                tacc = tmem.accumulate_memory(tacc, te, tout)
                step += 1
            jrel, jobj = jmem.finalize_memory(jacc)
            trel, tobj = tmem.finalize_memory(tacc)
            close(trel, jrel, f"relation bank, epoch {epoch}")
            close(tobj, jobj, f"object bank, epoch {epoch}")
            assert float(np.abs(np.asarray(jrel)).max()) > 0
            jstate = jstate.with_memory(jrel, jobj)
            state = state.with_memory(trel, tobj)
    assert state.step == int(jstate.step) == EPOCHS * VIDEOS
    assert state.optimizer.updates == EPOCHS * VIDEOS
