"""Shared helpers of the training lock-step tests: ``vidsgg``'s random draws
recorded inside its jitted train step and replayed in the port, and the
comparisons of the two packages' states after a step.

``vidsgg`` draws its dropout masks (``jax.random.bernoulli``) and the GMM
heads' noise (``jax.random.normal``) while its step is traced. The masks
are recorded with their shapes in the traced program's order, which is
the order the port draws them in; the GMM draws are recorded by class
count (the object head 37, attention 3, spatial 6, contacting 17), one
[rows, K, C] draw per head and step, and handed to the port in its heads'
call order. ``jax.debug.callback`` carries the values out (never
``jax.pure_callback``: its float64 results are checked outside the
thread-local x64 context); call ``jax.effects_barrier()`` before reading.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import torch

from vidsgg_torch.convert import tempura_from_jax
from vidsgg_torch.models.noise import ReplayNoise

TOL = 1e-8


def close(got, want, name, tol: float = TOL):
    """``got`` within ``tol`` x max(1, max|want|) of ``want``, same shape
    (NumPy's ``assert_allclose`` reports a miss; it is slow on the
    full-width tensors, so the bound is checked first)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if not want.size:
        return
    atol = tol * max(1.0, float(np.abs(want).max()))
    if not float(np.abs(got - want).max()) <= atol:      # NaN included
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)


class SharedNoise:
    """``vidsgg``'s random draws in its jitted step, recorded with
    ``jax.debug.callback``: the GMM noise by class count, the dropout masks
    under the index of their call in the traced step (the program order).

    ``heads``: the class counts of the GMM heads in the port's call order;
    ``rows``: the allowed (rows, K) of a GMM draw."""

    def __init__(self, monkeypatch, heads: tuple, rows: set):
        self.heads, self.rows = tuple(heads), set(rows)
        self.shapes = []         # the traced step's mask shapes, in call order
        self.masks, self.eps = {}, {}
        bernoulli, normal = jax.random.bernoulli, jax.random.normal

        def recording_bernoulli(key, p=0.5, shape=None):
            mask = bernoulli(key, p, shape)
            index = len(self.shapes)
            self.shapes.append(tuple(shape))
            jax.debug.callback(functools.partial(self._store, self.masks, index), mask)
            return mask

        def recording_normal(key, shape, dtype=None):
            pad, k, c = shape
            assert (pad, k) in self.rows, shape
            eps = normal(key, shape, dtype)
            jax.debug.callback(functools.partial(self._store, self.eps, c), eps)
            return eps

        monkeypatch.setattr(jax.random, "bernoulli", recording_bernoulli)
        monkeypatch.setattr(jax.random, "normal", recording_normal)

    @staticmethod
    def _store(table, key, value):
        table[key] = np.array(value)

    def replay(self) -> ReplayNoise:
        """The last step's draws for the port, then cleared."""
        assert sorted(self.masks) == list(range(len(self.shapes)))
        assert sorted(self.eps) == sorted(self.heads)
        masks = [self.masks[i] for i in range(len(self.shapes))]
        assert [m.shape for m in masks] == self.shapes
        out = ReplayNoise([torch.from_numpy(self.eps[c]) for c in self.heads],
                          [torch.from_numpy(m) for m in masks])
        self.masks.clear()
        self.eps.clear()
        return out


def compare_state(jstate, port, tcfg, what):
    """Every parameter and buffer of the port (batch-norm statistics, the
    OSPU's position table) against ``vidsgg``'s tree."""
    want = tempura_from_jax({"params": jax.tree.map(np.asarray, jstate.params),
                             "batch_stats": jax.tree.map(np.asarray, jstate.batch_stats)}, tcfg)
    got = port.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k], f"{what}: {k}")


def adamw_counts(jstate, port, opt):
    """Every parameter's AdamW counts, element by element, in the port's
    layout: ``vidsgg``'s per-tensor counts broadcast to its tensors' shapes
    and carried across as the parameters are (a packed q/k/v projection
    holds three blocks), and the port's per-segment counts likewise."""
    jcounts = jax.tree.map(lambda c, p: np.full(p.shape, int(c), np.int16),
                           jstate.opt_state[1].count, jstate.params)
    want = tempura_from_jax({"params": jcounts, "batch_stats": jstate.batch_stats}, port.cfg)
    got = {}
    for n, p in port.named_parameters():
        step = opt.state[p]["step"].to(torch.int16)
        rows = p.shape[0] // len(step)
        got[n] = step.repeat_interleave(rows).reshape((-1,) + (1,) * (p.dim() - 1)).expand(p.shape)
    return got, want
