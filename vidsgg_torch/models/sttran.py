"""STTran: spatial encoder + window-2 temporal decoder + memory fusion.

Counterpart of ``vidsgg/models/sttran.py``: masked dense attention over
padded pair tokens.

* Spatial encoder: self-attention over the pair axis restricted to
  same-frame keys.
* Temporal decoder: each pair token is duplicated into its two sliding
  windows (former role in window f, latter role in window f-1) as a [2P]
  token axis with a same-window mask and a 2-slot position embedding added
  to q/k; per token the 'latter' copy is taken where it exists (TEMPURA's
  mode; ``vidsgg``'s unused 'both' merge is not carried).
* Memory hallucination ('late' fusion): single-head bias-free attention of
  the pair features over the predicate memory bank, gated by a manual
  lambda or a learned sigmoid.

Outside the deterministic phase, dropout (rate 0.1, ``noise.py``) acts at
``vidsgg``'s places: on the attention weights, on both residual branches
and inside the feed-forward of each encoder and decoder layer.

Names follow the reference ``transformer`` (``local_attention.layers.i``,
``global_attention.layers.i``, ``position_embedding``, ``mem_attention``,
``selector``), so its state_dict keys are the reference's.
"""

from __future__ import annotations

import torch
from torch import nn

from vidsgg_torch.models.attention import MultiheadAttention
from vidsgg_torch.models.noise import dropout
from vidsgg_torch.models.promote import dense, layer_norm

DROPOUT = 0.1  # the reference transformer's rate, in every encoder and decoder layer


class EncoderLayer(nn.Module):
    """Post-norm encoder layer, relu, as ``torch.nn.TransformerEncoderLayer``
    (the reference's transformer.py:5-30 clone of it)."""

    def __init__(self, embed_dim: int, nhead: int, dim_feedforward: int):
        super().__init__()
        self.self_attn = MultiheadAttention(embed_dim, nhead, dropout=DROPOUT)
        self.linear1 = nn.Linear(embed_dim, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, embed_dim)
        self.norm1 = nn.LayerNorm(embed_dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, src, attn_mask, deterministic: bool = True, noise=None):
        def drop(t):
            return dropout(t, DROPOUT, noise, deterministic)

        src2 = self.self_attn(src, src, src, attn_mask, deterministic, noise)
        src = layer_norm(self.norm1, src + drop(src2))
        h = torch.relu(dense(self.linear1, src))
        src2 = dense(self.linear2, drop(h))
        return layer_norm(self.norm2, src + drop(src2))


class DecoderLayer(nn.Module):
    """Window decoder layer: q=k=x+pos, v=x; norm after attention only (the
    second residual has no LayerNorm)."""

    def __init__(self, embed_dim: int, nhead: int, dim_feedforward: int):
        super().__init__()
        self.multihead2 = MultiheadAttention(embed_dim, nhead, dropout=DROPOUT)
        self.linear1 = nn.Linear(embed_dim, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, embed_dim)
        self.norm3 = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x, pos, attn_mask, deterministic: bool = True, noise=None):
        def drop(t):
            return dropout(t, DROPOUT, noise, deterministic)

        qk = x + pos
        t2 = self.multihead2(qk, qk, x, attn_mask, deterministic, noise)
        t = layer_norm(self.norm3, x + drop(t2))
        h = torch.relu(dense(self.linear1, t))
        return t + drop(dense(self.linear2, drop(h)))


class MemoryHallucinator(nn.Module):
    """Gated attention over a memory bank, as a base class: the reference
    keeps ``mem_attention`` (and ``selector``) on the owning module, so the
    owner (:class:`STTran`, the OSPU classifier) inherits them from here.

    ``mem_compute``: 'joint' (one bank, [26, D] in [attention; spatial;
    contacting] row order) or 'seperate' (a dict of three banks).
    """

    def _init_memory(self, embed_dim: int, mem_compute: str, selection: str,
                     selection_lambda: float):
        self.mem_compute = mem_compute
        self.selection = selection
        self.selection_lambda = selection_lambda
        if mem_compute == "seperate":
            self.mem_attention = nn.ModuleDict({
                rel: MultiheadAttention(embed_dim, 1, bias=False, out_bias=False)
                for rel in ("attention", "contacting", "spatial")
            })
        else:
            self.mem_attention = MultiheadAttention(embed_dim, 1, bias=False,
                                                    out_bias=False)
        self.selector = nn.Linear(embed_dim, 1) if selection != "manual" else None

    def hallucinate(self, feat, memory, mem_active):
        if self.selector is None:
            e = self.selection_lambda
        else:
            e = torch.sigmoid(dense(self.selector, feat))
        if self.mem_compute == "seperate":
            outs = [self.mem_attention[rel](feat, memory[rel], memory[rel])
                    for rel in ("attention", "contacting", "spatial")]
            mem = sum(outs) / 3.0
        else:
            mem = self.mem_attention(feat, memory, memory)
        out = e * feat + (1.0 - e) * mem
        # while the banks are empty the attention's parameters get zero
        # gradients (not None): the optimizer's all-zero skip then holds them
        active = torch.as_tensor(mem_active, device=feat.device)
        return torch.where(active, out, feat)


class _Layers(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class STTran(MemoryHallucinator):
    """Spatial-temporal transformer over padded pair tokens."""

    def __init__(self, embed_dim: int = 1936, nhead: int = 8, enc_layers: int = 1,
                 dec_layers: int = 3, dim_feedforward: int = 2048,
                 mem_compute: str | None = "joint",
                 selection: str = "manual", selection_lambda: float = 0.5,
                 mem_fusion: str = "late"):
        super().__init__()
        self.embed_dim = embed_dim
        self.local_attention = _Layers(
            [EncoderLayer(embed_dim, nhead, dim_feedforward) for _ in range(enc_layers)])
        self.global_attention = _Layers(
            [DecoderLayer(embed_dim, nhead, dim_feedforward) for _ in range(dec_layers)])
        self.position_embedding = nn.Embedding(2, embed_dim)
        self.use_memory = bool(mem_compute) and mem_fusion == "late"
        if self.use_memory:
            self._init_memory(embed_dim, mem_compute, selection, selection_lambda)

    def forward(self, features, im_idx, pair_mask, num_frames, memory=None,
                mem_active=False, deterministic: bool = True, noise=None):
        """features [P, D], im_idx [P], pair_mask [P] bool, num_frames [] ->
        (global_output, rel_features, mem_features)."""
        p = features.shape[0]
        f = im_idx.long()
        pm = pair_mask

        same_frame = (f[:, None] == f[None, :]) & pm[:, None] & pm[None, :]
        x = features
        for layer in self.local_attention.layers:
            x = layer(x, same_frame, deterministic, noise)
        local_output = x * pm[:, None]

        window = torch.cat([f, f - 1])
        valid = torch.cat([pm & (f <= num_frames - 2), pm & (f >= 1)])
        pos_table = self.position_embedding.weight
        pos = torch.cat([pos_table[0].expand(p, -1), pos_table[1].expand(p, -1)])
        win_mask = (window[:, None] == window[None, :]) & valid[:, None] & valid[None, :]
        y = torch.cat([local_output, local_output], dim=0)
        for layer in self.global_attention.layers:
            y = layer(y, pos, win_mask, deterministic, noise)

        former_out, latter_out = y[:p], y[p:]
        out = torch.where((f >= 1)[:, None], latter_out, former_out) * pm[:, None]

        if self.use_memory:
            rel_features = out
            out = self.hallucinate(out, memory, mem_active) * pm[:, None]
            mem_features = out
        else:
            rel_features = local_output
            mem_features = local_output
        return out, rel_features, mem_features
