"""TEMPURA's relation stack in the port against ``vidsgg``: OSPU
``classify_objects``, ``relation_forward``, the sgdet device postprocess and
the converter round trip. Full widths (d=1936, OSPU 2376), one layer each.

Tolerances:
* the relation stack (attention, STTran, GMM heads, OSPU) in float64 on
  both sides (JAX in its x64 context, as ``PARITY.md``): atol
  1e-8 x max(1, max|ref|); integer outputs exact;
* ``sgdet_postprocess_device`` selects, sorts and copies: every output
  exact;
* the converter round trip: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_utils import assert_trees_equal, entry_to_torch, random_tree, to_np

from vidsgg.data.entry import Entry as JEntry
from vidsgg.data.entry import EntryCapacity as JCap
from vidsgg.models.convert_relation import convert_tempura_state_dict, expected_tempura_shapes
from vidsgg.models.postprocess_device import sgdet_postprocess_device as jax_postprocess
from vidsgg.models.tempura import Tempura as JTempura
from vidsgg.models.tempura import TempuraConfig as JConfig
from vidsgg_torch.convert import memory_from_jax, tempura_from_jax
from vidsgg_torch.models.postprocess_device import sgdet_postprocess_device
from vidsgg_torch.models.tempura import Tempura, TempuraConfig

CAP = JCap(max_frames=4, max_objs=12, max_pairs=16)
N_OBJ, N_PAIR = 10, 12
CONFIGS = {
    # the serving default: linear object head, no object memory
    "linear": dict(obj_head="linear"),
    # GMM object head, object memory with a learned gate
    "gmm": dict(obj_head="gmm", obj_mem_compute=True, selection="automated"),
}


def _cfgs(name):
    kw = dict(rel_head="gmm", enc_layers=1, dec_layers=1, track_layers=1, **CONFIGS[name])
    return JConfig.for_mode("sgdet", **kw), TempuraConfig.for_mode("sgdet", **kw)


def _entry(seed, dtype=np.float64):
    rng = np.random.RandomState(seed)
    n, p = CAP.max_objs, CAP.max_pairs
    frame = np.sort(rng.randint(0, 3, N_OBJ))
    xy = rng.rand(N_OBJ, 2) * 300
    boxes = np.zeros((n, 5))
    boxes[:N_OBJ] = np.concatenate([frame[:, None], xy, xy + rng.rand(N_OBJ, 2) * 200 + 5], 1)
    dist = np.zeros((n, 36))
    d = rng.rand(N_OBJ, 36) ** 4
    dist[:N_OBJ] = d / d.sum(1, keepdims=True)
    obj_mask = np.arange(n) < N_OBJ
    pair_idx = np.zeros((p, 2), np.int32)
    pair_idx[:N_PAIR] = rng.randint(0, N_OBJ, (N_PAIR, 2))
    im_idx = np.zeros(p, np.int32)
    im_idx[:N_PAIR] = frame[pair_idx[:N_PAIR, 0]]
    pred_labels = np.zeros(n, np.int32)
    pred_labels[:N_OBJ] = rng.randint(1, 37, N_OBJ)
    e = JEntry.zeros(CAP)
    fields = dict(
        boxes=boxes, distribution=dist, obj_mask=obj_mask,
        features=rng.randn(n, 2048) * obj_mask[:, None],
        scores=rng.rand(n) * obj_mask, pred_labels=pred_labels, labels=pred_labels,
        pair_idx=pair_idx, im_idx=im_idx, pair_mask=np.arange(p) < N_PAIR,
        union_feat=rng.randn(p, 7, 7, 1024) * 0.5,
        spatial_masks=rng.rand(p, 2, 27, 27) - 0.5,
        frame_mask=np.arange(CAP.max_frames) < 3, num_frames=np.int32(3),
    )
    out = {}
    for k, v in fields.items():
        v = np.asarray(v)
        out[k] = v.astype(dtype) if v.dtype.kind == "f" else v
    return e.replace(**out)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def models(request):
    jcfg, tcfg = _cfgs(request.param)
    shapes = expected_tempura_shapes(jcfg, JEntry.zeros(CAP))
    variables = random_tree(shapes, np.random.default_rng(1), np.float64)
    port = Tempura(tcfg, device="cpu").double()
    port.load_state_dict(tempura_from_jax(variables, tcfg))
    rng = np.random.RandomState(2)
    banks = dict(rel=rng.randn(26, 1936), obj=rng.randn(36, 2376))
    yield jcfg, tcfg, variables, port, banks
    del port, variables


def test_converter_round_trip(models):
    jcfg, _, variables, port, _ = models
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    assert_trees_equal(convert_tempura_state_dict(sd, jcfg, strict=True), variables)


def _close(got, want, name):
    want = np.asarray(want)
    got = to_np(got)
    assert got.shape == want.shape, name
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, atol=1e-8 * max(1.0, np.abs(want).max()),
                                   err_msg=name)


@pytest.mark.parametrize("mem_active", [False, True])
def test_classify_and_relation_forward(models, mem_active):
    jcfg, tcfg, variables, port, banks = models
    entry = _entry(3)
    obj_mem = banks["obj"] if mem_active else np.zeros((36, 2376))
    rel_mem = banks["rel"] if mem_active else np.zeros((26, 1936))
    with jax.enable_x64(True):
        jm = JTempura(jcfg)
        jaux = jm.apply(variables, entry, phase="test", obj_memory=jnp.asarray(obj_mem),
                        mem_active=jnp.asarray(mem_active), method="classify_objects")
        jout = jm.apply(variables, entry, jaux["object_mem_features"], phase="test",
                        rel_memory=jnp.asarray(rel_mem), mem_active=jnp.asarray(mem_active),
                        method="relation_forward")
        jaux, jout = jax.tree.map(np.asarray, (jaux, jout))
    rel_t, obj_t, active_t = memory_from_jax(rel_mem, obj_mem, mem_active)
    te = entry_to_torch(entry)
    with torch.no_grad():
        aux = port.classify_objects(te, obj_memory=obj_t, mem_active=active_t)
        out = port.relation_forward(te, aux["object_mem_features"], rel_memory=rel_t,
                                    mem_active=active_t)
    assert sorted(aux) == sorted(jaux)
    for k in jaux:
        _close(aux[k], jaux[k], k)
    assert sorted(out) == sorted(jout)
    for k in jout:
        _close(out[k], jout[k], k)
    if mem_active:   # the banks really enter
        assert not np.allclose(jout["rel_mem_features"], jout["rel_features"])


def test_sgdet_postprocess_device():
    rng = np.random.RandomState(4)
    entry = _entry(5, np.float32)
    # clean_class sources: detector labels 5, 8, 17, and near-duplicate boxes
    labels = np.asarray(entry.pred_labels).copy()
    labels[:4] = [5, 8, 17, 5]
    boxes = np.asarray(entry.boxes).copy()
    boxes[5, 1:] = boxes[4, 1:] + 1.0
    entry = entry.replace(pred_labels=labels, boxes=boxes)
    dist = rng.rand(CAP.max_objs, 36).astype(np.float32) * np.asarray(entry.obj_mask)[:, None]
    dist[4:6, 7] = 5.0                       # two overlapping boxes of one class
    mem = rng.randn(CAP.max_objs, 2376).astype(np.float32)
    je, jmem, jovf = jax_postprocess(entry, jnp.asarray(dist), jnp.asarray(mem))
    te, tmem, tovf = sgdet_postprocess_device(entry_to_torch(entry), torch.from_numpy(dist),
                                              torch.from_numpy(mem))
    assert bool(tovf) == bool(jovf) is False
    np.testing.assert_array_equal(to_np(tmem), np.asarray(jmem))
    for f in dataclasses.fields(te):
        got, want = to_np(getattr(te, f.name)), np.asarray(getattr(je, f.name))
        assert got.shape == want.shape, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)


def test_sgdet_postprocess_device_overflow_flag():
    entry = _entry(6, np.float32)
    n = CAP.max_objs
    labels = np.where(np.asarray(entry.obj_mask), 5, 0).astype(np.int32)
    dist = np.full((n, 36), 0.01, np.float32)
    dist[:, 4] = 0.9     # class 5 first: every box duplicates ...
    dist[:, 7] = 0.5     # ... as class 8, which duplicates again
    dist *= np.asarray(entry.obj_mask)[:, None]
    mem = np.zeros((n, 2376), np.float32)
    entry = entry.replace(pred_labels=labels)
    _, _, jovf = jax_postprocess(entry, jnp.asarray(dist), jnp.asarray(mem))
    _, _, tovf = sgdet_postprocess_device(entry_to_torch(entry), torch.from_numpy(dist),
                                          torch.from_numpy(mem))
    assert bool(tovf) == bool(jovf) is True
