"""Shared helpers of the training lock-step tests: ``vidsgg``'s random draws
recorded inside its jitted train step and replayed in the port, and the
comparisons of the two packages' states after a step.

``vidsgg`` draws its dropout masks (``jax.random.bernoulli``), the GMM
heads' noise (``jax.random.normal``) and TokenGT's Laplacian sign flips
(``jax.random.uniform``) while its step is traced. The masks and the
uniform draws are recorded with their shapes in the traced program's
order, which is the order the port draws them in; the GMM draws are
recorded by class count (the object head 37, attention 3, spatial 6,
contacting 17), one [rows, K, C] draw per head and step, and handed to
the port in its heads' call order. ``jax.debug.callback`` carries the values out (never
``jax.pure_callback``: its float64 results are checked outside the
thread-local x64 context); call ``jax.effects_barrier()`` before reading.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vidsgg_torch.convert import tempura_from_jax
from vidsgg_torch.models.noise import ReplayNoise

TOL = 1e-8


def exact_callback(fn, x, ordered: bool = False):
    """``jax.debug.callback(fn, x)`` that hands ``fn`` the value of ``x``
    exactly: a jitted function's callback runs outside the thread-local
    x64 context, where a float64 argument would arrive rounded to float32,
    so such an argument travels as its bits (two uint32 words a value)."""
    if x.dtype != jnp.float64:
        jax.debug.callback(lambda v: fn(np.array(v)), x, ordered=ordered)
        return

    def unpack(bits):
        bits = np.ascontiguousarray(np.array(bits, np.uint32))
        fn(bits.view(np.float64).reshape(bits.shape[:-1]))

    jax.debug.callback(unpack, jax.lax.bitcast_convert_type(x, jnp.uint32), ordered=ordered)


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
    and the uniform draws under the index of their call in the traced step
    (the program order).

    ``heads``: the class counts of the GMM heads in the port's call order;
    ``rows``: the allowed (rows, K) of a GMM draw. :meth:`replay` hands the
    port the last step's draws; :meth:`replay_all` those of every step
    run since the recorder was made, for a run of the port that takes the
    same steps. While ``active`` is false (a run's data pipeline, say) the
    draws pass through unrecorded."""

    def __init__(self, monkeypatch, heads: tuple, rows: set):
        self.heads, self.rows = tuple(heads), set(rows)
        self.shapes = []         # the traced step's mask shapes, in call order
        self.uniform_shapes = []
        self.masks, self.eps, self.uniforms = {}, {}, {}
        # every draw of every step run: {table: {key: [value per step]}}
        self.history = {"masks": {}, "eps": {}, "uniforms": {}}
        self.active = True
        bernoulli, normal, uniform = jax.random.bernoulli, jax.random.normal, jax.random.uniform

        def recording_bernoulli(key, p=0.5, shape=None):
            if not self.active:
                return bernoulli(key, p, shape)
            mask = bernoulli(key, p, shape)
            index = len(self.shapes)
            self.shapes.append(tuple(shape))
            jax.debug.callback(functools.partial(self._store, "masks", index), mask)
            return mask

        def recording_normal(key, shape, dtype=None):
            if not self.active:
                return normal(key, shape) if dtype is None else normal(key, shape, dtype)
            pad, k, c = shape
            assert (pad, k) in self.rows, shape
            eps = normal(key, shape, dtype)
            jax.debug.callback(functools.partial(self._store, "eps", c), eps)
            return eps

        def recording_uniform(key, shape=(), *args, **kw):
            u = uniform(key, shape, *args, **kw)
            if not self.active:
                return u
            index = len(self.uniform_shapes)
            self.uniform_shapes.append(tuple(shape))
            # exactly: TokenGT's random node identifiers are these values
            exact_callback(functools.partial(self._store, "uniforms", index), u)
            return u

        monkeypatch.setattr(jax.random, "bernoulli", recording_bernoulli)
        monkeypatch.setattr(jax.random, "normal", recording_normal)
        monkeypatch.setattr(jax.random, "uniform", recording_uniform)

    def _store(self, table, key, value):
        getattr(self, table)[key] = np.array(value)
        self.history[table].setdefault(key, []).append(np.array(value))

    def replay(self) -> ReplayNoise:
        """The last step's draws for the port, then cleared."""
        assert sorted(self.masks) == list(range(len(self.shapes))), (sorted(self.masks), self.shapes)
        assert sorted(self.eps) == sorted(self.heads)
        masks = [self.masks[i] for i in range(len(self.shapes))]
        assert [m.shape for m in masks] == self.shapes
        assert sorted(self.uniforms) == list(range(len(self.uniform_shapes)))
        uniforms = [self.uniforms[i] for i in range(len(self.uniform_shapes))]
        assert [u.shape for u in uniforms] == self.uniform_shapes
        out = ReplayNoise([torch.from_numpy(self.eps[c]) for c in self.heads],
                          [torch.from_numpy(m) for m in masks],
                          [torch.from_numpy(u) for u in uniforms])
        self.masks.clear()
        self.eps.clear()
        self.uniforms.clear()
        return out

    def retrace(self):
        """Forget the traced program's draw order, before another traced
        function draws (the test phase's, then a train step's)."""
        self.shapes.clear()
        self.uniform_shapes.clear()

    def replay_all(self, steps: int) -> ReplayNoise:
        """The draws of the ``steps`` steps run since the recorder was made
        (each draw recorded once a step), step after step."""
        h = self.history
        assert sorted(h["masks"]) == list(range(len(self.shapes)))
        assert sorted(h["uniforms"]) == list(range(len(self.uniform_shapes)))
        assert sorted(h["eps"]) == sorted(self.heads)
        assert all(len(v) == steps for table in h.values() for v in table.values()), {
            t: {k: len(v) for k, v in table.items()} for t, table in h.items()}

        def per_step(table, keys):
            return [torch.from_numpy(h[table][k][s]) for s in range(steps) for k in keys]

        return ReplayNoise(per_step("eps", self.heads),
                           per_step("masks", range(len(self.shapes))),
                           per_step("uniforms", range(len(self.uniform_shapes))))


def compare_state(jstate, port, tcfg, what, convert=tempura_from_jax):
    """Every parameter and buffer of the port (batch-norm statistics, the
    OSPU's position table) against ``vidsgg``'s tree, carried across by
    ``convert`` (``tempura_from_jax`` or ``teatgt_from_jax``)."""
    want = convert({"params": jax.tree.map(np.asarray, jstate.params),
                    "batch_stats": jax.tree.map(np.asarray, jstate.batch_stats)}, tcfg)
    got = port.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k], f"{what}: {k}")


def adamw_counts(jstate, port, opt, convert=tempura_from_jax):
    """Every parameter's AdamW counts, element by element, in the port's
    layout: ``vidsgg``'s per-tensor counts broadcast to its tensors' shapes
    and carried across as the parameters are (a packed q/k/v projection
    holds three blocks), and the port's per-segment counts likewise."""
    jcounts = jax.tree.map(lambda c, p: np.full(p.shape, int(c), np.int16),
                           jstate.opt_state[1].count, jstate.params)
    want = convert({"params": jcounts, "batch_stats": jstate.batch_stats}, port.cfg)
    got = {}
    for n, p in port.named_parameters():
        step = opt.state[p]["step"].to(torch.int16)
        rows = p.shape[0] // len(step)
        got[n] = step.repeat_interleave(rows).reshape((-1,) + (1,) * (p.dim() - 1)).expand(p.shape)
    return got, want


def adamw_moments(jstate, port, opt, convert=tempura_from_jax):
    """Every parameter's AdamW moments in the port's layout: ``vidsgg``'s
    ``mu`` and ``nu`` carried across as the parameters are, against the
    port's ``exp_avg`` and ``exp_avg_sq``: {name: (got, want)} for each."""
    state = jstate.opt_state[1]
    want = {m: convert({"params": jax.tree.map(np.asarray, getattr(state, m)),
                        "batch_stats": jstate.batch_stats}, port.cfg) for m in ("mu", "nu")}
    out = {}
    for n, p in port.named_parameters():
        s = opt.state[p]
        out[f"{n} exp_avg"] = (s["exp_avg"], want["mu"][n])
        out[f"{n} exp_avg_sq"] = (s["exp_avg_sq"], want["nu"][n])
    return out
