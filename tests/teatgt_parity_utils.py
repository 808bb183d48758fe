"""Shared helpers of the TEAT-GT parity tests (they import JAX, so they live
apart from ``torch_parity_utils``, which the card-only tests import).

Laplacian eigenvectors are unique only up to sign and, for a repeated
eigenvalue, up to the basis of its eigenspace; JAX's LAPACK and torch's
pick differently, and TokenGT reads the raw vectors. So the TEAT-GT parity
tests hand both packages the same eigenvectors: :class:`EigBridge` records
every (adjacency, node mask) ``vidsgg`` decomposes and the decomposition
``vidsgg.ops.masked_laplacian_eig`` gave, and replaces the port's
``masked_laplacian_eig`` by a function that asserts its adjacency equals
the next recorded one and returns that decomposition. (Decomposing the
adjacency again outside ``vidsgg``'s jit is not the same: XLA fuses the
Laplacian's products differently there, and one ulp rotates the basis of
a repeated eigenvalue.)
"""

from __future__ import annotations

import jax
import numpy as np
import torch

import vidsgg.models.teatgt as jteatgt
import vidsgg.train.eval_pipeline as jep
import vidsgg_torch.models.teatgt as tteatgt


class EigBridge:
    def __init__(self, monkeypatch):
        self.recorded = []
        self.calls = 0
        original = jteatgt.masked_laplacian_eig

        def record(*arrays):
            self.recorded.append(tuple(np.array(a) for a in arrays))

        def recording(adj, mask):
            val, vec = original(adj, mask)
            jax.debug.callback(record, adj, mask, val, vec)
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
