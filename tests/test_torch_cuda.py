"""Card-only tests: the hand-written CUDA NMS kernel against its plain
PyTorch version on the same CUDA tensors. Tolerance: exact (keep masks are
booleans). Skipped where there is no CUDA card.

This file imports neither JAX nor ``vidsgg``, so it also runs on a machine
without them: ``python -m pytest --noconftest -q tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch
from torch_parity_utils import cuda_device  # noqa: F401  (fixture)

from vidsgg_torch.ops import nms as tnms


def _problems(rng, g, n, span=400.0):
    x1y1 = rng.rand(g, n, 2).astype(np.float32) * span
    wh = rng.rand(g, n, 2).astype(np.float32) * 40 + 2
    boxes = np.concatenate([x1y1, x1y1 + wh], -1)
    scores = rng.rand(g, n).astype(np.float32)
    valid = rng.rand(g, n) > 0.25
    valid[0] = False                       # one all-invalid problem
    return boxes, scores, valid


@pytest.mark.cuda
@pytest.mark.parametrize("shape,thresh,max_keep,presorted", [
    ((16, 6000), 0.7, 100, True),          # the RPN call
    ((16 * 36, 100), 0.4, None, False),    # the (frame, class) grid
    ((3, 1), 0.5, None, False),
    ((5, 257), 0.5, None, False),          # not a multiple of the block width
    ((4, 11000), 0.5, 7, False),           # near the shared-memory ceiling
])
def test_kernel_matches_plain(cuda_device, shape, thresh, max_keep, presorted):
    rng = np.random.RandomState(0)
    boxes, scores, valid = _problems(rng, *shape)
    if presorted:
        order = np.argsort(-scores, axis=1, kind="stable")
        boxes = np.take_along_axis(boxes, order[..., None], 1)
        scores = np.take_along_axis(scores, order, 1)
        valid = np.ones(shape, bool)
    b, s, v = (torch.from_numpy(x).to(cuda_device) for x in (boxes, scores, valid))
    before = tnms.NMS_KERNEL.launches
    got = tnms.nms_mask_batched(b, s, v, thresh, max_keep=max_keep, presorted=presorted)
    torch.cuda.synchronize()
    assert tnms.NMS_KERNEL.launches == before + 1
    want = tnms.nms_mask_batched_plain(b, s, v, thresh, max_keep=max_keep,
                                       presorted=presorted)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_identical_boxes_keep_one(cuda_device):
    b = torch.tensor([[0.0, 0.0, 10.0, 10.0]], device=cuda_device).expand(2, 50, 4).contiguous()
    s = torch.linspace(1, 0, 50, device=cuda_device).expand(2, 50)
    v = torch.ones((2, 50), dtype=torch.bool, device=cuda_device)
    got = tnms.nms_mask_batched(b, s, v, 0.5)
    assert got.sum(1).tolist() == [1, 1] and got[:, 0].all()


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(cuda_device):
    n = tnms.max_boxes_per_problem() + 1
    b = torch.zeros((1, n, 4), device=cuda_device)
    v = torch.ones((1, n), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError):
        tnms.nms_sorted_cuda(b, v, 0.5)
    with pytest.raises(TypeError):
        tnms.nms_sorted_cuda(b[:, :8].double(), v[:, :8], 0.5)
