"""Shared helpers of the ``test_torch_*`` parity tests: seeded variable trees
for ``vidsgg`` models, NumPy/torch conversion, and the card fixture."""

from __future__ import annotations

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    """The CUDA card; skips the test where there is none (decided here, at
    run time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def random_tree(shapes, rng: np.random.Generator, dtype=np.float32, path=()):
    """Fill a Flax shape tree with seeded values by leaf name: kernels
    normal/sqrt(fan_in), biases and BN statistics perturbed away from their
    identity values (so a wrong mapping shows), tables standard normal."""
    if hasattr(shapes, "items"):
        return {k: random_tree(v, rng, dtype, path + (k,)) for k, v in shapes.items()}
    shape = tuple(shapes.shape)
    name = path[-1]
    normal = rng.standard_normal(shape, dtype=np.float32)
    if name == "kernel":
        v = normal / np.float32(np.sqrt(np.prod(shape[:-1])))
    elif name == "bias":
        v = 0.1 * normal
    elif name == "scale":
        v = 1.0 + 0.1 * normal
    elif name == "mean":
        v = 0.1 * normal
    elif name == "var":
        v = 0.5 + rng.random(shape, dtype=np.float32)
    else:  # embedding tables, position embeddings, pe tables
        v = normal
    return v.astype(dtype)


def to_np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def tree_leaves(tree, path=()):
    if hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(tree_leaves(v, path + (k,)))
        return out
    return {path: np.asarray(tree)}


def assert_trees_equal(got, want):
    g, w = tree_leaves(got), tree_leaves(want)
    assert sorted(g) == sorted(w), (sorted(set(g) ^ set(w)))[:10]
    for k in w:
        assert g[k].shape == w[k].shape, (k, g[k].shape, w[k].shape)
        np.testing.assert_array_equal(g[k], w[k], err_msg="/".join(k))


def entry_to_torch(entry, device="cpu"):
    """A ``vidsgg`` Entry -> the port's Entry, field by field."""
    import dataclasses

    from vidsgg_torch.data.entry import Entry

    return Entry(**{
        f.name: torch.from_numpy(np.array(getattr(entry, f.name))).to(device)
        for f in dataclasses.fields(Entry)
    })


def assert_pred_equal(got: dict, want: dict, atol: float, rtol: float = 0.0):
    """Evaluator pred dicts: exact on every discrete field, ``atol`` on floats."""
    assert sorted(got) == sorted(want)
    for k in ("labels", "im_idx", "pair_idx", "pred_labels"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("attention_gt", "spatial_gt", "contacting_gt"):
        assert got[k] == want[k], k
    for k in ("boxes", "scores", "pred_scores", "attention_distribution",
              "spatial_distribution", "contacting_distribution"):
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=rtol, err_msg=k)
