"""Attention pooling over graph nodes (counterpart of
``GlobalAttentionPooling`` in ``vidsgg/models/graph_transformer.py``).

Only the pooling the test path applies (TEAT-GT's ``gap_gru``) is here; the
edge-conditioned ``GraphTransformer`` feeds the train-time
temporal-consistency regularizer and comes with training.
"""

from __future__ import annotations

import torch
from torch import nn

from vidsgg_torch.models.attention import masked_softmax
from vidsgg_torch.models.promote import dense, result_type


class GlobalAttentionPooling(nn.Module):
    """dgl GlobalAttentionPooling (lib/teatgt.py:83-94): gate linear ->
    masked softmax over nodes -> weighted sum. x [B, N, D], mask [B, N].

    The gate is handed in: the reference registers it twice, as
    ``gate_gru_nn`` on the model and as ``gap_gru.gate_nn``, and so does
    the port."""

    def __init__(self, gate_nn: nn.Linear):
        super().__init__()
        self.gate_nn = gate_nn

    def forward(self, x, mask):
        w = masked_softmax(dense(self.gate_nn, x)[..., 0], mask)
        dt = result_type(w, x)
        return torch.einsum("bn,bnd->bd", w.to(dt), x.to(dt))
