"""Class-name word embeddings (GloVe); the port's own copy of
``vidsgg/models/embeddings.py``.

The reference initializes its label-embedding tables from a cached
glove.6B.200d lookup (tools/utils/word_vectors.py:15-35): the primary key
is always ``token.split('/')[0]`` (merged class names like 'cup/glass/bottle'
look up 'cup'), the fallback is the longest space-separated word, and a
total miss keeps the N(0,1) random init. The cache itself is gitignored
data in the reference checkout.

Here the loader reads an ``.npz`` asset (``{word: vector}``, built from the
public glove.6B.200d.txt by the word-vector CLI) and applies the same
lookup-with-fallback; without the asset it falls back to deterministic
per-name pseudo-vectors (seeded by a stable hash of the class name) — the
tables are trainable parameters in both stacks, so only the initialization
differs.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

WV_DIM = 200


def _pseudo_vector(name: str, dim: int) -> np.ndarray:
    seed = int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "little")
    rng = np.random.RandomState(seed)
    return rng.randn(dim).astype(np.float32)


def _lookup(table: dict, name: str):
    """The reference's two-stage lookup (word_vectors.py:21-33):
    split('/')[0] first, then the longest space-separated word."""
    key = name.split("/")[0]
    if key in table:
        return table[key]
    lw = sorted(name.split(" "), key=len, reverse=True)[0]
    return table.get(lw)


def word_vectors_available(wv_path: str | None = None):
    """(available, resolved_path) for the GloVe ``.npz`` asset.

    The train CLIs call this to warn loudly when label-embedding tables
    will pseudo-init (the reference's from-scratch init differs in that
    case; tools/utils/word_vectors.py:15-35)."""
    path = wv_path or os.environ.get("VIDSGG_WORD_VECTORS", "")
    return bool(path and os.path.exists(path)), (path or None)


def obj_edge_vectors(names, wv_dim: int = WV_DIM, wv_path: str | None = None) -> np.ndarray:
    """[len(names), wv_dim] embedding table with the reference's fallbacks."""
    table = {}
    path = wv_path or os.environ.get("VIDSGG_WORD_VECTORS", "")
    if path and os.path.exists(path):
        data = np.load(path)
        table = {k: np.asarray(data[k], np.float32) for k in data.files}

    out = np.zeros((len(names), wv_dim), np.float32)
    for i, name in enumerate(names):
        vec = _lookup(table, name) if table else None
        if vec is not None:
            out[i] = vec[:wv_dim]
        else:
            out[i] = _pseudo_vector(name, wv_dim)
    return out
