"""Box ops, ROIAlign and union masks in the port against ``vidsgg``.

Tolerances, float32 on both sides: box and mask math atol 1e-5 (the same
operations in the same order; exp may differ in the last bit); ROIAlign
atol 1e-5 x max|ref| (the interpolation weights are the same, the products
sum in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidsgg.ops import boxes as jb
from vidsgg.ops.roi_align import roi_align as jax_roi_align
from vidsgg.ops.roi_align import roi_align_fused as jax_roi_align_fused
from vidsgg.ops.union_masks import draw_union_masks as jax_masks
from vidsgg_torch.ops import boxes as tb
from vidsgg_torch.ops.roi_align import roi_align as torch_roi_align
from vidsgg_torch.ops.roi_align import roi_align_fused as torch_roi_align_fused
from vidsgg_torch.ops.union_masks import draw_union_masks as torch_masks


def _boxes(rng, n, span=100.0):
    x1y1 = rng.rand(n, 2).astype(np.float32) * span
    wh = rng.rand(n, 2).astype(np.float32) * 50 + 1
    return np.concatenate([x1y1, x1y1 + wh], 1)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_box_ops():
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 20), _boxes(rng, 7)
    np.testing.assert_allclose(tb.bbox_overlaps(_t(a), _t(b)).numpy(),
                               np.asarray(jb.bbox_overlaps(jnp.asarray(a), jnp.asarray(b))),
                               atol=1e-5)
    np.testing.assert_allclose(tb.center_size(_t(a)).numpy(),
                               np.asarray(jb.center_size(jnp.asarray(a))), atol=1e-5)
    np.testing.assert_allclose(tb.box_union(_t(a[:7]), _t(b)).numpy(),
                               np.asarray(jb.box_union(jnp.asarray(a[:7]), jnp.asarray(b))),
                               atol=1e-5)
    deltas = (0.2 * rng.randn(3, 20, 4 * 5)).astype(np.float32)
    want = jb.bbox_transform_inv(jnp.asarray(a), jnp.asarray(deltas))
    got = tb.bbox_transform_inv(_t(a), _t(deltas))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-6)
    hw = np.array([[90.0, 120.0], [60.0, 200.0], [150.0, 80.0]], np.float32)
    np.testing.assert_allclose(
        tb.clip_boxes(got, _t(hw)).numpy(),
        np.asarray(jb.clip_boxes(want, jnp.asarray(hw))), atol=1e-5, rtol=1e-6)


def _fmaps(rng, b=3, h=12, w=20, c=8):
    return rng.randn(b, h, w, c).astype(np.float32)


@pytest.mark.parametrize("chunk_size", [4, 128])
def test_roi_align(chunk_size):
    rng = np.random.RandomState(1)
    f = _fmaps(rng)
    r = _boxes(rng, 9, span=200.0)
    # one roi large enough that its bins need more than 16 samples per axis
    r[0] = [0.0, 0.0, 2000.0, 1900.0]
    rois = np.concatenate([rng.randint(0, 3, (9, 1)).astype(np.float32), r], 1)
    want = np.asarray(jax_roi_align(jnp.asarray(f), jnp.asarray(rois)))
    got = torch_roi_align(_t(f), _t(rois), chunk_size=chunk_size).numpy()
    assert got.shape == want.shape == (9, 7, 7, 8)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_roi_align_fused_and_nchw_view():
    rng = np.random.RandomState(2)
    f = _fmaps(rng)
    rois = np.stack([_boxes(rng, 5, span=250.0) for _ in range(3)])
    rois[1, 0] = [0.0, 0.0, 3000.0, 2000.0]
    want = np.asarray(jax_roi_align_fused(jnp.asarray(f), jnp.asarray(rois)))
    got = torch_roi_align_fused(_t(f), _t(rois)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    # an NHWC view of NCHW storage (how the detector hands its maps over)
    nchw = _t(f).permute(0, 3, 1, 2).contiguous()
    got2 = torch_roi_align_fused(nchw.permute(0, 2, 3, 1), _t(rois)).numpy()
    np.testing.assert_array_equal(got2, got)


def test_union_masks():
    rng = np.random.RandomState(3)
    pair = np.concatenate([_boxes(rng, 11), _boxes(rng, 11)], 1)
    pair[0, 4:] = pair[0, :4]           # subject == object
    want = np.asarray(jax_masks(jnp.asarray(pair)))
    got = torch_masks(_t(pair)).numpy()
    assert got.shape == (11, 2, 27, 27)
    np.testing.assert_allclose(got, want, atol=1e-5)
