"""Shared helpers of the TEAT-GT parity tests (they import JAX, so they live
apart from ``torch_parity_utils``, which the card-only tests import):
:class:`EigBridge` and, for training, :class:`RoundingNoiseBridge`.

Laplacian eigenvectors are unique only up to sign and, for a repeated
eigenvalue, up to the basis of its eigenspace; JAX's LAPACK and torch's
pick differently, and TokenGT reads the raw vectors. So the TEAT-GT parity
tests hand both packages the same eigenvectors: :class:`EigBridge` records
every (adjacency, node mask) ``vidsgg`` decomposes and the decomposition
``vidsgg.ops.masked_laplacian_eig`` gave, and replaces the port's
``masked_laplacian_eig`` by a function that asserts its adjacency equals
the next recorded one and returns that decomposition (in ``vidsgg``'s call
order: TokenGT's clip graphs, then in training the consistency
regularizer's per-frame graphs). (Decomposing the
adjacency again outside ``vidsgg``'s jit is not the same: XLA fuses the
Laplacian's products differently there, and one ulp rotates the basis of
a repeated eigenvalue.)

:class:`DrawBridge` does the same for TokenGT's orthogonal random
matrices (the ``orf`` node identifiers, the Performer's projections):
``vidsgg`` draws them from threefry keys, whose values no torch generator
reproduces, so the port is handed ``vidsgg``'s.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import torch
from train_parity_utils import exact_callback

import vidsgg.models.teatgt as jteatgt
import vidsgg.models.tokengt as jtokengt
import vidsgg.train.eval_pipeline as jep
from vidsgg.train import steps as jsteps
from vidsgg_torch.convert import regularizer_from_jax
import vidsgg_torch.models.teatgt as tteatgt
import vidsgg_torch.models.tokengt as ttokengt


class EigBridge:
    def __init__(self, monkeypatch):
        self.recorded = []
        self.calls = 0
        original = jteatgt.masked_laplacian_eig

        def record(*arrays):
            self.recorded.append(tuple(np.array(a) for a in arrays))

        def recording(adj, mask):
            val, vec = original(adj, mask)
            # ordered: a train step decomposes twice (TokenGT's clip graphs,
            # then the regularizer's frame graphs), and unordered callbacks
            # may run in either order
            jax.debug.callback(record, adj, mask, val, vec, ordered=True)
            return val, vec

        monkeypatch.setattr(jteatgt, "masked_laplacian_eig", recording)
        # fresh jit wrappers, so that the stages trace the recording function
        # rather than reuse a trace made before the patch
        for name, fn, static in (
            ("predcls_stage", jep._predcls_stage, ()),
            ("relation_stage_no_union", jep._relation_stage_no_union, ()),
            ("sgcls_fused_stage", jep._sgcls_fused, (3,)),
            ("sgdet_fused_stage", jep._sgdet_fused, (3, 4)),
        ):
            monkeypatch.setattr(jep, name, jax.jit(fn, static_argnums=static))
        monkeypatch.setattr(tteatgt, "masked_laplacian_eig", self.port_eig)

    def port_eig(self, adj: torch.Tensor, mask: torch.Tensor):
        jax.effects_barrier()
        # the adjacency comes from boxes: nothing may differentiate eigh
        assert not adj.requires_grad
        want_adj, want_mask, val, vec = self.recorded.pop(0)
        got_adj, got_mask = adj.cpu().numpy(), mask.cpu().numpy()
        np.testing.assert_array_equal(got_mask, want_mask)
        # the port decomposes in float64, vidsgg in float32: 0/1 entries
        flips = int((got_adj != want_adj).sum())
        assert flips == 0, f"{flips} adjacency entries differ from vidsgg's"
        self.calls += 1
        return torch.from_numpy(val).to(adj.device), torch.from_numpy(vec).to(adj.device)

    def assert_consumed(self):
        jax.effects_barrier()
        assert self.calls > 0 and not self.recorded, (self.calls, len(self.recorded))


class RoundingNoiseBridge:
    """Gradients whose true value is 0, which each package computes as its
    own rounding noise (about 1e-17 in float64), exactly 0 on some steps
    and not on others:

    * the regularizer's pooling gates' biases, on every step: a bias shifts
      every node's score alike, which the softmax ignores. The port gives
      them no gradient (``GlobalAttentionPooling``);
    * the structural stream (the encoder ``gat`` and its pooling gate's
      weight), on a step whose frame graphs are alike in every frame (no
      edges at all, as on video size 1, or the same graph in each): its
      loss is then 0, every pair's KL a tie at 0.

    AdamW skips a tensor only on an exact 0; otherwise it takes a step of
    its momentum, of the learning rate's size, and the weight decay. So the
    port gets ``vidsgg``'s noise, as ``EigBridge`` hands it ``vidsgg``'s
    eigenbasis: these gradients are recorded inside ``vidsgg``'s jitted
    step (where it takes their global norm), step after step, and become
    the port's before its optimizer (:meth:`install`) reads them, the
    structural stream's only on the steps where ``vidsgg``'s gradient of
    it is all below 1e-12 (and the port's must be so too). Every other
    gradient is the port's own."""

    NOISE = 1e-12

    def __init__(self, monkeypatch):
        self.recorded = []          # per step: vidsgg's {"gap", "gap_sem", "gat"} gradients
        self.structural_steps = 0   # the steps whose structural stream was handed over
        optax = jsteps.optax

        def store(grads):
            self.recorded.append(jax.tree.map(np.array, grads))

        class RecordingOptax:
            """``optax`` as the train step's module sees it, its
            ``global_norm`` recording first (the optimizer's clip, which
            takes the same norm, is left alone: one record a step)."""

            def __getattr__(self, name):
                return getattr(optax, name)

            @staticmethod
            def global_norm(grads):
                jax.debug.callback(store, {k: grads[k] for k in ("gap", "gap_sem", "gat")},
                                   ordered=True)
                return optax.global_norm(grads)

        monkeypatch.setattr(jsteps, "optax", RecordingOptax())

    def install(self, optimizer, model):
        params = dict(model.named_parameters())
        base = optimizer.global_grad_norm

        def hand_over(name, want, port_noise):
            p = params[name]
            assert float(np.abs(want).max()) < self.NOISE, (name, want)
            assert p.grad is None or port_noise, name
            if p.grad is not None:
                assert float(p.grad.abs().max()) < self.NOISE, name
            p.grad = (torch.from_numpy(want).to(device=p.device, dtype=p.dtype)
                      if want.any() else None)

        def global_grad_norm():
            jax.effects_barrier()
            rec = self.recorded.pop(0)
            for name, gap in (("gate_nn.bias", "gap"), ("gate_sem_nn.bias", "gap_sem")):
                hand_over(name, rec[gap]["gate_nn"]["bias"], port_noise=False)
            # the structural stream: its encoder and its pooling gate's weight
            structural = {k: g for k, g in regularizer_from_jax(
                {"gat": rec["gat"], "gap": rec["gap"]}).items()
                if k.startswith("gat.") or k == "gate_nn.weight"}
            if max(float(np.abs(g).max()) for g in structural.values()) < self.NOISE:
                for name, g in structural.items():
                    hand_over(name, g, port_noise=True)
                self.structural_steps += 1
            return base()

        optimizer.global_grad_norm = global_grad_norm


class DrawBridge:
    """Every orthogonal random matrix ``vidsgg``'s TokenGT draws
    (``gaussian_orthogonal_random_matrix``: the ``orf`` node identifiers,
    then each Performer layer's projection), recorded in its call order
    inside its jit (an ordered callback) and handed to the port's TokenGT
    in the same order, each of the shape it asks for. ``noise``: a
    :class:`~train_parity_utils.SharedNoise` that must not record the
    normals of these draws (they are handed over whole)."""

    def __init__(self, monkeypatch, noise=None):
        self.recorded = []
        self.calls = 0
        original = jtokengt.gaussian_orthogonal_random_matrix

        def record(m):
            self.recorded.append(np.array(m))

        def recording(rng, nb_rows, nb_cols, batch=1):
            active = noise is not None and noise.active
            if active:
                noise.active = False
            try:
                out = original(rng, nb_rows, nb_cols, batch)
            finally:
                if active:
                    noise.active = True
            exact_callback(record, out, ordered=True)
            return out

        monkeypatch.setattr(jtokengt, "gaussian_orthogonal_random_matrix", recording)
        monkeypatch.setattr(ttokengt, "gaussian_orthogonal_random_matrix", self.port_draw)

    def port_draw(self, noise, nb_rows, nb_cols, batch=1, *, dtype, device):
        jax.effects_barrier()
        assert self.recorded, f"no recorded draw left for {(batch, nb_rows, nb_cols)}"
        want = self.recorded.pop(0)
        assert want.shape == (batch, nb_rows, nb_cols), (want.shape, (batch, nb_rows, nb_cols))
        self.calls += 1
        return torch.from_numpy(want).to(device=device, dtype=dtype)

    def assert_consumed(self, calls: int):
        jax.effects_barrier()
        assert self.calls == calls and not self.recorded, (self.calls, calls,
                                                           len(self.recorded))


class JaxFixedDraws:
    """``vidsgg``'s test-time draws of the ``rand`` node identifiers, for
    the port's ``fixed_noise``: ``jax.random.uniform`` from
    ``jax.random.PRNGKey(0)`` in the asked type (float64 stands for
    ``vidsgg`` under x64), as ``vidsgg`` draws them at every call (its
    orthogonal random matrices come through :class:`DrawBridge`)."""

    def uniform(self, shape, dtype, device):
        wide = dtype == torch.float64
        with jax.enable_x64(wide):
            u = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), tuple(shape),
                                              np.float64 if wide else np.float32))
        return torch.from_numpy(u).to(device=device, dtype=dtype)
