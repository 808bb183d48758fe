"""Greedy NMS in the port against ``vidsgg``: K1, K2 and the grouped NMS.

Tolerance: exact. Keep masks are booleans and must agree bit for bit with
``vidsgg.ops.nms.nms_mask`` (vmapped), with the Pallas kernels
``nms_mask_pallas_batched`` and ``nms_mask_pallas`` run in interpret mode,
and (keep and rank) with ``vidsgg``'s ``_grouped_nms`` in float32 and, under
``jax.enable_x64``, float64. With ``max_keep`` the
Pallas kernel guarantees only each problem's first ``max_keep`` keeps (and
may mark more), while the port marks exactly those: the comparison is on
that prefix. The CUDA kernel is held to the plain version on the card in
``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidsgg.ops.nms import batched_class_nms as jax_batched_class_nms
from vidsgg.ops.nms import nms_mask as jax_nms_mask
from vidsgg.models.postprocess_device import _grouped_nms as jax_grouped_nms
from vidsgg.ops.pallas_nms import nms_mask_pallas, nms_mask_pallas_batched
from vidsgg_torch.ops import nms as tnms


def _problems(rng, shape, n, invalid_frac=0.25, span=60.0):
    x1y1 = rng.rand(*shape, n, 2).astype(np.float32) * span
    wh = rng.rand(*shape, n, 2).astype(np.float32) * 40 + 2
    boxes = np.concatenate([x1y1, x1y1 + wh], -1)
    scores = rng.rand(*shape, n).astype(np.float32)
    valid = rng.rand(*shape, n) > invalid_frac
    return boxes, scores, valid


def _port(boxes, scores, valid, thresh, **kw):
    return tnms.nms_mask_batched(torch.from_numpy(boxes), torch.from_numpy(scores),
                                 torch.from_numpy(valid), thresh, **kw).numpy()


def _first_keeps(mask_row, k):
    return np.flatnonzero(mask_row)[:k]


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
def test_plain_matches_vmapped_nms_mask(thresh):
    rng = np.random.RandomState(int(thresh * 10))
    boxes, scores, valid = _problems(rng, (3, 4), 40)
    want = np.asarray(jax_batched_class_nms(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), thresh))
    np.testing.assert_array_equal(_port(boxes, scores, valid, thresh), want)


def test_plain_matches_nms_mask_long_problem():
    """One problem longer than vidsgg's 512-box kernel switch, dense
    overlaps (a small span) so many suppressions happen."""
    rng = np.random.RandomState(5)
    boxes, scores, valid = _problems(rng, (), 600, span=200.0)
    want = np.asarray(jax_nms_mask(jnp.asarray(boxes), jnp.asarray(scores),
                                   jnp.asarray(valid), 0.7))
    got = tnms.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                        torch.from_numpy(valid), 0.7).numpy()
    np.testing.assert_array_equal(got, want)


def test_plain_matches_pallas_interpret():
    rng = np.random.RandomState(2)
    boxes, scores, valid = _problems(rng, (3, 5), 24)
    want = np.asarray(nms_mask_pallas_batched(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), 0.5, True))
    np.testing.assert_array_equal(_port(boxes, scores, valid, 0.5), want)


@pytest.mark.parametrize("max_keep", [1, 3, 8])
def test_presorted_max_keep_prefix_matches_pallas(max_keep):
    rng = np.random.RandomState(3 + max_keep)
    g, n = 6, 48
    boxes, scores, _ = _problems(rng, (g,), n, span=30.0)
    order = np.argsort(-scores, axis=1, kind="stable")
    boxes = np.take_along_axis(boxes, order[..., None], 1)
    scores = np.take_along_axis(scores, order, 1)
    valid = np.ones((g, n), bool)
    valid[1, 10:] = False          # valid boxes first, then padding
    valid[2, :] = False            # an all-padding problem
    want = np.asarray(nms_mask_pallas_batched(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), 0.5, True,
        max_keep, True))
    got = _port(boxes, scores, valid, 0.5, max_keep=max_keep, presorted=True)
    full = _port(boxes, scores, valid, 0.5)
    for i in range(g):
        np.testing.assert_array_equal(np.flatnonzero(got[i]),
                                      _first_keeps(want[i], max_keep))
        np.testing.assert_array_equal(np.flatnonzero(got[i]),
                                      _first_keeps(full[i], max_keep))
    assert not got[2].any()


def test_presorted_equals_sorted():
    rng = np.random.RandomState(4)
    boxes, scores, valid = _problems(rng, (4,), 32, invalid_frac=0.0)
    order = np.argsort(-scores, axis=1, kind="stable")
    sb = np.take_along_axis(boxes, order[..., None], 1)
    ss = np.take_along_axis(scores, order, 1)
    got = _port(sb, ss, valid, 0.4, presorted=True)
    want = np.take_along_axis(_port(boxes, scores, valid, 0.4), order, 1)
    np.testing.assert_array_equal(got, want)


def test_identical_boxes_all_invalid_single_box():
    n = 16
    boxes = np.tile(np.array([[0, 0, 10, 10]], np.float32), (n, 1))
    scores = np.linspace(1, 0, n).astype(np.float32)
    got = _port(boxes[None], scores[None], np.ones((1, n), bool), 0.5)[0]
    assert got.sum() == 1 and got[0]
    got = _port(boxes[None], scores[None], np.zeros((1, n), bool), 0.5)[0]
    assert not got.any()
    got = _port(boxes[None, :1], scores[None, :1], np.ones((1, 1), bool), 0.5)
    assert got.tolist() == [[True]]


def test_iou_equal_to_threshold_is_kept_and_ties_keep_index_order():
    # IoU of these two is exactly 0.5 ((10*10) / (10*20)): strict > keeps both
    boxes = np.array([[0, 0, 9, 9], [0, 0, 9, 19], [0, 0, 9, 19]], np.float32)
    scores = np.array([0.9, 0.8, 0.8], np.float32)   # a tie: lower index ranks first
    valid = np.ones(3, bool)
    want = np.asarray(jax_nms_mask(jnp.asarray(boxes), jnp.asarray(scores),
                                   jnp.asarray(valid), 0.5))
    got = _port(boxes[None], scores[None], valid[None], 0.5)[0]
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [True, True, False]


def test_kernel_wrapper_refuses_cpu_tensors():
    b = torch.zeros((1, 4, 4))
    v = torch.ones((1, 4), dtype=torch.bool)
    with pytest.raises(ValueError):
        tnms.nms_sorted_cuda(b, v, 0.5)


# --- K2 (nms_mask_pallas: ranking inside the call, no max_keep, no presort)

def _tied(rng, shape, n, levels=6):
    """Scores on a few levels, so many ties must keep index order."""
    return (rng.randint(0, levels, size=(*shape, n)) / levels).astype(np.float32)


@pytest.mark.parametrize("thresh", [0.4, 0.7])
def test_k2_contract_matches_pallas_interpret(thresh):
    rng = np.random.RandomState(11)
    boxes, _, valid = _problems(rng, (3, 4), 130, span=50.0)
    scores = _tied(rng, (3, 4), 130)
    valid[1, 2] = False                    # one all-invalid problem
    want = np.asarray(nms_mask_pallas(jnp.asarray(boxes), jnp.asarray(scores),
                                      jnp.asarray(valid), thresh, True))
    np.testing.assert_array_equal(_port(boxes, scores, valid, thresh), want)


# --- the relation stage's grouped NMS against vidsgg's _grouped_nms

def _grouped_problem(m=512, seed=6):
    """M slots on an integer grid (exact IoUs), several groups, tied scores,
    invalid slots, and planted pairs at IoU exactly 0.6 and just above."""
    rng = np.random.RandomState(seed)
    xy = rng.randint(0, 40, size=(m, 2)).astype(np.float64)
    wh = rng.randint(4, 20, size=(m, 2)).astype(np.float64)
    boxes = np.concatenate([xy, xy + wh], 1)
    group = rng.randint(0, 6, size=m).astype(np.int64)
    scores = rng.randint(0, 10, size=m) / 10.0
    valid = rng.rand(m) > 0.3
    # (0, 0, 9, 9) has area 100; (0, 0, 9, 5) area 60 inside it: IoU 0.6
    boxes[0], boxes[1] = (0, 0, 9, 9), (0, 0, 9, 5)
    boxes[2], boxes[3] = (100, 100, 109, 109), (100, 100, 109, 106)   # IoU 0.7
    group[:4], scores[:4], valid[:4] = 7, (0.95, 0.9, 0.95, 0.9), True
    return boxes, scores, group, valid


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_grouped_nms_matches_vidsgg(dtype):
    boxes, scores, group, valid = _grouped_problem()
    boxes, scores = boxes.astype(dtype), scores.astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        jkeep, jrank = jax_grouped_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                       jnp.asarray(group), jnp.asarray(valid), 0.6)
        jkeep, jrank = np.asarray(jkeep), np.asarray(jrank)
    keep, rank = tnms.grouped_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                                  torch.from_numpy(group), torch.from_numpy(valid), 0.6)
    assert keep.dtype == torch.bool and rank.dtype == torch.int32
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    np.testing.assert_array_equal(rank.numpy(), jrank)
    assert keep[0] and keep[1]             # IoU == threshold: both kept
    assert keep[2] and not keep[3]         # IoU above it: the lower score goes
    assert 0 < keep.sum() < valid.sum()


@pytest.mark.parametrize("max_keep", [None, 5])
def test_plain_single_group_equals_ungrouped(max_keep):
    rng = np.random.RandomState(8)
    boxes, _, valid = _problems(rng, (4,), 70, span=30.0)
    b, v = torch.from_numpy(boxes), torch.from_numpy(valid)
    one = torch.zeros(v.shape, dtype=torch.int64)
    got = tnms.nms_sorted_plain(b, v, 0.5, max_keep, group=one)
    assert torch.equal(got, tnms.nms_sorted_plain(b, v, 0.5, max_keep))
    assert int(got.sum()) < int(v.sum())


def test_plain_group_per_box_keeps_every_valid_box():
    rng = np.random.RandomState(9)
    boxes, _, valid = _problems(rng, (3,), 50, span=10.0)
    v = torch.from_numpy(valid)
    own = torch.arange(v.numel()).reshape(v.shape)
    got = tnms.nms_sorted_plain(torch.from_numpy(boxes), v, 0.3, group=own)
    assert torch.equal(got, v)
