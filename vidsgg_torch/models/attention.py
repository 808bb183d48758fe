"""Masked multi-head attention (counterpart of ``vidsgg/models/attention.py``).

Semantics of ``torch.nn.MultiheadAttention`` (packed q/k/v in-projection,
scaled dot product, softmax over allowed keys, out-projection) with the
masking written out: a fully masked row gives all-zero weights, where
``F.scaled_dot_product_attention`` gives NaN. Projections and products
promote their operands as ``vidsgg``'s Flax layers do (``promote.py``:
float32 queries over a bfloat16 memory bank attend in float32), and the
scores are divided by sqrt(head_dim) in the queries' type. Outside the
deterministic phase, dropout at ``dropout`` acts on the attention weights
(Flax's arithmetic, ``noise.py``). Parameter names are
``nn.MultiheadAttention``'s, so reference checkpoints load as they are;
:class:`SeparateProjAttention` is the same attention in fairseq's layout
(TokenGT's).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from vidsgg_torch.models.noise import dropout
from vidsgg_torch.models.promote import dense, linear, matmul

_NEG_INF = -1e9


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Softmax over the last axis restricted to mask==True keys; rows with
    no allowed key return zeros."""
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    if mask is not None:
        e = torch.where(mask, e, torch.zeros_like(e))
    denom = e.sum(dim=-1, keepdim=True)
    return e / torch.clamp(denom, min=1e-30)


def _scaled(scores, head_dim: int, qh):
    """scores / sqrt(head_dim), the divisor in the queries' type."""
    return scores / torch.tensor(math.sqrt(head_dim), dtype=qh.dtype)


class MultiheadAttention(nn.Module):
    """q/k/v: [..., T, D]; attn_mask broadcastable to [..., H, Tq, Tk]
    (a [..., Tq, Tk] mask is shared by every head); ``dropout``: the rate
    on the attention weights outside the deterministic phase."""

    def __init__(self, embed_dim: int, num_heads: int, bias: bool = True,
                 out_bias: bool = True, dropout: float = 0.0):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim)) if bias else None
        self.out_proj = nn.Linear(embed_dim, embed_dim, bias=out_bias)

    def forward(self, q, k, v, attn_mask=None, deterministic: bool = True, noise=None):
        d, h = self.embed_dim, self.num_heads
        hd = d // h
        w = self.in_proj_weight
        b = self.in_proj_bias
        bq, bk, bv = (None, None, None) if b is None else (b[:d], b[d:2 * d], b[2 * d:])
        wq = linear(q, w[:d], bq)
        wk = linear(k, w[d:2 * d], bk)
        wv = linear(v, w[2 * d:], bv)

        def split(x):  # [..., T, D] -> [..., H, T, hd]
            return x.reshape(x.shape[:-1] + (h, hd)).transpose(-3, -2)

        qh, kh, vh = split(wq), split(wk), split(wv)
        scores = _scaled(matmul(qh, kh.transpose(-1, -2)), hd, qh)
        if attn_mask is not None and attn_mask.dim() == scores.dim() - 1:
            attn_mask = attn_mask[..., None, :, :]
        w = dropout(masked_softmax(scores, attn_mask), self.dropout, noise, deterministic)
        out = matmul(w, vh).transpose(-3, -2).reshape(q.shape[:-1] + (d,))
        return dense(self.out_proj, out)


class SeparateProjAttention(nn.Module):
    """The same attention with fairseq's layout: separate ``q_proj``,
    ``k_proj``, ``v_proj`` and ``out_proj`` Linears (TokenGT's
    ``self_attn``, tokengt_graph_encoder_layer.py:61-95). Scores are divided
    by sqrt(head_dim) after the product, as ``vidsgg``'s. Inference only."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, x, attn_mask=None):
        """x: [..., T, D]; attn_mask broadcastable to [..., Tq, Tk] (shared
        by every head) or [..., H, Tq, Tk]."""
        d, h = self.embed_dim, self.num_heads
        hd = d // h

        def split(t):  # [..., T, D] -> [..., H, T, hd]
            return t.reshape(t.shape[:-1] + (h, hd)).transpose(-3, -2)

        qh = split(dense(self.q_proj, x))
        kh, vh = split(dense(self.k_proj, x)), split(dense(self.v_proj, x))
        scores = _scaled(matmul(qh, kh.transpose(-1, -2)), hd, qh)
        if attn_mask is not None and attn_mask.dim() == scores.dim() - 1:
            attn_mask = attn_mask[..., None, :, :]
        out = matmul(masked_softmax(scores, attn_mask), vh)
        return dense(self.out_proj, out.transpose(-3, -2).reshape(x.shape[:-1] + (d,)))
