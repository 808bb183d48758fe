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


AG_FRAME_H, AG_FRAME_W = 48, 64


def write_ag_tree(root, long_frames: int = 17, over_frames: int = 33):
    """An Action Genome-format tree under ``root`` (a ``pathlib.Path``):
    annotation pickles and 64x48 PNG frames written by ``cv2.imwrite``, as
    ``tests/test_cli_e2e.py``'s fixture writes them (two train videos, two
    3-frame test videos), plus a test video of ``long_frames`` frames that
    lands in the second size bucket and, if ``over_frames``, one of that
    many frames that exceeds every bucket. Returns ``str(root)``."""
    import os
    import pickle

    import cv2

    os.makedirs(root / "annotations")
    person, objects = {}, {}
    rng = np.random.RandomState(7)

    def add_frame(vid, f, split, objs=("chair",)):
        key = f"{vid}/{f:06d}.png"
        person[key] = {
            "bbox": np.array([[4.0, 4.0, 36.0, 44.0]], np.float32),
            "bbox_size": (AG_FRAME_W, AG_FRAME_H),
        }
        rows = []
        for k, cls in enumerate(objs):
            rows.append({
                "class": cls,
                # xywh within the 64x48 frame
                "bbox": [14.0 + 6 * k, 8.0 + 4 * k, 22.0, 24.0],
                "attention_relationship": ["looking_at"],
                "spatial_relationship": ["in_front_of"],
                "contacting_relationship": ["sitting_on", "touching"],
                "visible": True,
                "metadata": {"set": split},
            })
        objects[key] = rows
        frame_dir = root / "frames" / vid
        os.makedirs(frame_dir, exist_ok=True)
        img = rng.randint(0, 255, (AG_FRAME_H, AG_FRAME_W, 3), np.uint8)
        assert cv2.imwrite(str(root / "frames" / key), img)

    for f in range(4):  # train video, two objects on later frames
        add_frame("A.mp4", f, "train",
                  objs=("chair",) if f < 2 else ("chair", "food"))
    for f in range(3):  # second train video
        add_frame("B.mp4", f, "train")
    for f in range(3):  # test-split video
        add_frame("C.mp4", f, "test")
    for f in range(3):  # second test-split video (same canvas -> pairs)
        add_frame("D.mp4", f, "test", objs=("chair", "food"))
    for f in range(long_frames):  # a test video for the second bucket
        add_frame("E.mp4", f, "test", objs=("chair", "food") if f % 2 else ("cup/glass/bottle",))
    for f in range(over_frames):  # a test video too long for any bucket
        add_frame("F.mp4", f, "test")

    with open(root / "annotations/person_bbox.pkl", "wb") as fh:
        pickle.dump(person, fh)
    with open(root / "annotations/object_bbox_and_relationship.pkl", "wb") as fh:
        pickle.dump(objects, fh)
    return str(root)
