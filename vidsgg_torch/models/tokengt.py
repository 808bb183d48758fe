"""TokenGT: a tokenized graph transformer over per-clip scene graphs
(counterpart of ``vidsgg/models/tokengt.py``), Laplacian node identifiers.

Batched over the clips of a video ([B, T, D]). The reference's quirks are
kept, since they are part of the trained function:

* node token = atom_encoder(1168 -> D) + temporal PE ``Embedding(100, D,
  padding_idx=0)`` of the clip-rebased frame index: the clip's first frame
  gets a zero temporal embedding (tokenizer.py:44,242-246);
* edge token = ``edge_encoder Embedding(5, D, padding_idx=0)`` of the edge
  type (spatial 0 / temporal 1): every spatial edge gets a zero embedding;
* node identifiers: Laplacian eigenvectors truncated or zero-padded to k;
  a token's identifier is [id_u; id_v] through a bias-free 2k -> D
  ``lap_encoder`` (nodes (i, i), edges (u, v));
* type identifier ``order_encoder`` Embedding(3, D): 1 for nodes, u == v
  for edges; [graph] and [null] tokens first;
* pre-norm layers, exact GELU, LayerNorm eps 1e-5; the encoder's final
  prenorm LayerNorm is created in the reference but never applied, so the
  port has none;
* LM head: dense D -> D + GELU + LayerNorm, then a bias-free D -> 26
  projection plus a learned output bias.

Outside the deterministic phase (training) it draws from the run's noise
source (``noise.py``), in ``vidsgg``'s program order: eig dropout 0.2 on
the identifiers, a sign flip per graph and eigenvector (``uniform >=
0.5``), dropout 0.1 on the token sequence, then in each layer dropout 0.1
on the attention weights, the attention branch, the feed-forward's
activation and its output.

The other node identifiers (tokenizer.py:257-275): ``rand``, uniform
draws of k values a node, L2-normalised; ``orf``, the rows of a
[Tn, Tn] orthogonal random matrix per graph (``performer.py``), truncated
or zero-padded to k, L2-normalised. Their encoder is ``rand_encoder`` or
``orf_encoder``, the reference's name for it. With ``performer=True``
every layer attends through FAVOR+ (:class:`MultiheadPerformerAttention`,
no attention dropout) instead of softmax attention. In training the
identifiers are drawn from the run's noise (``vidsgg``'s dropout stream),
first, and each layer's projection from the ``performer`` draws (the
train step's, which change every ``performer_redraw_interval`` steps); at
test time all of them come from :func:`~vidsgg_torch.models.noise.
fixed_noise`, as ``vidsgg``'s come from ``jax.random.PRNGKey(0)``: the same
draw for every call and layer. Threefry's values cannot be reproduced in
torch, so the port's draws are its own (ROADMAP.md queue 3).

Names are the reference's (``TokenGT_encoder.*`` of a TEAT-GT checkpoint).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vidsgg_torch.models.attention import SeparateProjAttention
from vidsgg_torch.models.noise import dropout, fixed_noise
from vidsgg_torch.models.performer import (
    draw_dtype,
    favor_attention,
    gaussian_orthogonal_random_matrix,
)
from vidsgg_torch.models.promote import dense, layer_norm

NODE_ID_MODES = ("lap", "rand", "orf")
DROPOUT = 0.1   # the token sequence, the attention weights, both branches, the activation


class _FeedForward(nn.Module):
    def __init__(self, embed_dim: int, ffn_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(embed_dim, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, embed_dim)

    def forward(self, x, deterministic: bool = True, noise=None):
        h = dropout(F.gelu(dense(self.fc1, x)), DROPOUT, noise, deterministic)
        return dense(self.fc2, h)


class MultiheadPerformerAttention(nn.Module):
    """FAVOR+ self-attention with fairseq's projections
    (modules/multihead_performer_attention.py): ``q_proj``, ``k_proj``,
    ``v_proj``, ``out_proj``; a projection of ``nb_features`` rows per call,
    drawn from ``performer`` outside the deterministic phase and from
    :func:`fixed_noise` otherwise (or without it)."""

    def __init__(self, embed_dim: int, num_heads: int, nb_features: int = 256):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.nb_features = nb_features
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, x, key_mask, deterministic: bool = True, performer=None):
        """x: [..., T, D]; key_mask: [..., T] bool."""
        d, h = self.embed_dim, self.num_heads
        hd = d // h

        def split(t):  # [..., T, D] -> [..., H, T, hd]
            return t.reshape(t.shape[:-1] + (h, hd)).transpose(-3, -2)

        q = split(dense(self.q_proj, x))
        k, v = split(dense(self.k_proj, x)), split(dense(self.v_proj, x))
        draws = performer if not deterministic and performer is not None else fixed_noise()
        proj = gaussian_orthogonal_random_matrix(draws, self.nb_features, hd,
                                                 dtype=draw_dtype(q), device=q.device)[0]
        out = favor_attention(q, k, v, key_mask[..., None, :], proj)
        return dense(self.out_proj, out.transpose(-3, -2).reshape(x.shape[:-1] + (d,)))


class TokenGTLayer(nn.Module):
    """Pre-norm encoder layer (tokengt_graph_encoder_layer.py:158-191);
    softmax attention, or FAVOR+ with ``performer``."""

    def __init__(self, embed_dim: int, num_heads: int, ffn_dim: int, performer: bool = False,
                 performer_nb_features: int = 256):
        super().__init__()
        self.performer = performer
        self.self_attn = (
            MultiheadPerformerAttention(embed_dim, num_heads, performer_nb_features)
            if performer else SeparateProjAttention(embed_dim, num_heads, dropout=DROPOUT))
        self.self_attn_layer_norm = nn.LayerNorm(embed_dim, eps=1e-5)
        self.feedforward = _FeedForward(embed_dim, ffn_dim)
        self.final_layer_norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x, attn_mask, deterministic: bool = True, noise=None, key_mask=None,
                performer=None):
        h = layer_norm(self.self_attn_layer_norm, x)
        if self.performer:
            h = self.self_attn(h, key_mask, deterministic, performer)
        else:
            h = self.self_attn(h, attn_mask, deterministic, noise)
        x = x + dropout(h, DROPOUT, noise, deterministic)
        h = self.feedforward(layer_norm(self.final_layer_norm, x), deterministic, noise)
        return x + dropout(h, DROPOUT, noise, deterministic)


class GraphFeatureTokenizer(nn.Module):
    """The token embeddings (tokenizer.py:43-70); the node identifiers'
    encoder is ``{node_id_mode}_encoder``."""

    def __init__(self, num_atoms: int, embed_dim: int, lap_node_id_k: int,
                 node_id_mode: str = "lap"):
        super().__init__()
        self.atom_encoder = nn.Linear(num_atoms, embed_dim)
        self.temp_encoder = nn.Embedding(100, embed_dim)
        self.edge_encoder = nn.Embedding(5, embed_dim)
        self.order_encoder = nn.Embedding(3, embed_dim)
        self.graph_token = nn.Embedding(1, embed_dim)
        self.null_token = nn.Embedding(1, embed_dim)
        self.id_encoder_name = f"{node_id_mode}_encoder"
        self.add_module(self.id_encoder_name,
                        nn.Linear(2 * lap_node_id_k, embed_dim, bias=False))

    @property
    def id_encoder(self) -> nn.Linear:
        return getattr(self, self.id_encoder_name)


class GraphEncoder(nn.Module):
    def __init__(self, num_atoms, embed_dim, layers, heads, ffn_dim, lap_node_id_k,
                 node_id_mode="lap", performer=False, performer_nb_features=256):
        super().__init__()
        self.graph_feature = GraphFeatureTokenizer(num_atoms, embed_dim, lap_node_id_k,
                                                   node_id_mode)
        self.layers = nn.ModuleList(
            [TokenGTLayer(embed_dim, heads, ffn_dim, performer, performer_nb_features)
             for _ in range(layers)])


class TokenGTEncoder(nn.Module):
    """Tokenizer + transformer + LM head over a batch of padded clip graphs.

    Inputs (leading clip axis B):
      node_data   [B, Tn, num_atoms]  raw node tokens
      node_mask   [B, Tn] bool
      frame_idx   [B, Tn] clip-rebased frame index of each node
      edge_index  [B, Te, 2] (u, v) node indices
      edge_type   [B, Te] 0 = spatial / 1 = temporal
      edge_mask   [B, Te] bool
      lap_eigvec  [B, Tn, Tn] eigenvectors (columns = modes)

    Returns (logits [B, Tn, num_output], hidden [B, Tn, D], graph_rep [B, D]).
    """

    def __init__(self, num_atoms: int = 1168, num_output: int = 26, embed_dim: int = 768,
                 layers: int = 12, heads: int = 32, ffn_dim: int = 768,
                 lap_node_id_k: int = 50, lap_sign_flip: bool = True,
                 lap_eig_dropout: float = 0.2, node_id_mode: str = "lap",
                 performer: bool = False, performer_nb_features: int = 256):
        super().__init__()
        if node_id_mode not in NODE_ID_MODES:
            raise ValueError(f"node_id_mode {node_id_mode!r}: one of {NODE_ID_MODES}")
        self.lap_node_id_k = lap_node_id_k
        self.lap_sign_flip = lap_sign_flip
        self.lap_eig_dropout = lap_eig_dropout
        self.node_id_mode = node_id_mode
        self.graph_encoder = GraphEncoder(num_atoms, embed_dim, layers, heads, ffn_dim,
                                          lap_node_id_k, node_id_mode, performer,
                                          performer_nb_features)
        self.lm_head_transform_weight = nn.Linear(embed_dim, embed_dim)
        self.layer_norm = nn.LayerNorm(embed_dim, eps=1e-5)
        self.embed_out = nn.Linear(embed_dim, num_output, bias=False)
        self.lm_output_learned_bias = nn.Parameter(torch.zeros(num_output))

    def node_identifiers(self, node_data, lap_eigvec, deterministic: bool = True,
                         noise=None) -> torch.Tensor:
        """[B, Tn, k]: each node's identifier (tokenizer.py:257-287).
        ``lap``: the eigenvectors truncated or zero-padded to k, and in
        training eig dropout and a sign flip per graph and eigenvector;
        ``rand`` and ``orf``: random unit rows, drawn from ``noise`` in
        training and from :func:`fixed_noise` at test time."""
        b, tn = node_data.shape[:2]
        k = self.lap_node_id_k
        if self.node_id_mode != "lap":
            draws = fixed_noise() if deterministic else noise
            dt, dev = draw_dtype(node_data), node_data.device
            if self.node_id_mode == "rand":
                ids = draws.uniform((b, tn, k), dt, dev)
            else:
                ids = gaussian_orthogonal_random_matrix(draws, tn, tn, batch=b, dtype=dt,
                                                        device=dev)
                ids = F.pad(ids, (0, max(k - tn, 0)))[..., :k]
            return ids * torch.rsqrt((ids * ids).sum(-1, keepdim=True) + 1e-12)
        eig = lap_eigvec[..., : min(k, lap_eigvec.shape[-1])]
        if eig.shape[-1] < k:
            eig = F.pad(eig, (0, k - eig.shape[-1]))
        eig = dropout(eig, self.lap_eig_dropout, noise, deterministic)
        if self.lap_sign_flip and not deterministic:
            u = noise.uniform((b, 1, k), eig.dtype, eig.device)
            eig = eig * torch.where(u >= 0.5, 1.0, -1.0).to(eig.dtype)
        return eig

    def forward(self, node_data, node_mask, frame_idx, edge_index, edge_type, edge_mask,
                lap_eigvec, deterministic: bool = True, noise=None, performer=None):
        """``performer``: the train phase's draws of the FAVOR+ projections
        (with ``performer=True``)."""
        gf = self.graph_encoder.graph_feature
        b, tn = node_data.shape[:2]
        d = gf.atom_encoder.weight.shape[0]
        batch_ix = torch.arange(b, device=node_data.device)[:, None]
        frame_idx = frame_idx.long()
        edge_index = edge_index.long()
        edge_type = edge_type.long()

        # node features + temporal PE (zero for the clip's first frame)
        node_feat = dense(gf.atom_encoder, node_data)
        tpe = gf.temp_encoder.weight[torch.clamp(frame_idx, 0, 99)] * (frame_idx != 0)[..., None]
        node_feat = node_feat + tpe
        # edge features (zero for spatial edges)
        edge_feat = gf.edge_encoder.weight[edge_type] * (edge_type != 0)[..., None]

        # node identifiers [id_u ; id_v]
        eig = self.node_identifiers(node_data, lap_eigvec, deterministic, noise)
        node_id_pairs = torch.cat([eig, eig], dim=-1)
        eig_u = eig[batch_ix, edge_index[..., 0]]
        eig_v = eig[batch_ix, edge_index[..., 1]]
        node_feat = node_feat + dense(gf.id_encoder, node_id_pairs)
        edge_feat = edge_feat + dense(gf.id_encoder, torch.cat([eig_u, eig_v], dim=-1))

        # type identifiers: 1 for nodes, (u == v) for edges
        order = gf.order_encoder.weight
        node_feat = node_feat + order[1]
        edge_feat = edge_feat + order[(edge_index[..., 0] == edge_index[..., 1]).long()]

        # [graph], [null], nodes, edges
        special = torch.cat([gf.graph_token.weight, gf.null_token.weight], dim=0)
        seq = torch.cat([special[None].expand(b, 2, d), node_feat, edge_feat], dim=1)
        seq_mask = torch.cat([torch.ones((b, 2), dtype=torch.bool, device=seq.device),
                              node_mask, edge_mask], dim=1)
        seq = dropout(seq * seq_mask[..., None], DROPOUT, noise, deterministic)
        attn_mask = seq_mask[:, None, :] & seq_mask[:, :, None]
        for layer in self.graph_encoder.layers:
            seq = layer(seq, attn_mask, deterministic, noise, key_mask=seq_mask,
                        performer=performer)

        # LM head on the node tokens (per-token, so the others are not needed)
        h = layer_norm(self.layer_norm,
                       F.gelu(dense(self.lm_head_transform_weight, seq[:, 2: 2 + tn])))
        logits = dense(self.embed_out, h) + self.lm_output_learned_bias
        return logits * node_mask[..., None], h * node_mask[..., None], seq[:, 0]
