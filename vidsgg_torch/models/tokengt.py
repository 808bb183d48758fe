"""TokenGT: a tokenized graph transformer over per-clip scene graphs
(counterpart of ``vidsgg/models/tokengt.py``), test phase, Laplacian node
identifiers.

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

Names are the reference's (``TokenGT_encoder.*`` of a TEAT-GT checkpoint).
The random node identifiers (``rand``, ``orf``) and the performer
attention draw from ``jax.random.PRNGKey(0)`` in ``vidsgg`` even at test
time; no torch generator reproduces those draws, so they are refused.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vidsgg_torch.models.attention import SeparateProjAttention
from vidsgg_torch.models.promote import dense, layer_norm

RANDOM_DRAWS = "ROADMAP.md queue 1 item 6c (random node identifiers and the performer)"


class _FeedForward(nn.Module):
    def __init__(self, embed_dim: int, ffn_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(embed_dim, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, embed_dim)

    def forward(self, x):
        return dense(self.fc2, F.gelu(dense(self.fc1, x)))


class TokenGTLayer(nn.Module):
    """Pre-norm encoder layer (tokengt_graph_encoder_layer.py:158-191)."""

    def __init__(self, embed_dim: int, num_heads: int, ffn_dim: int):
        super().__init__()
        self.self_attn = SeparateProjAttention(embed_dim, num_heads)
        self.self_attn_layer_norm = nn.LayerNorm(embed_dim, eps=1e-5)
        self.feedforward = _FeedForward(embed_dim, ffn_dim)
        self.final_layer_norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x, attn_mask):
        x = x + self.self_attn(layer_norm(self.self_attn_layer_norm, x), attn_mask)
        return x + self.feedforward(layer_norm(self.final_layer_norm, x))


class GraphFeatureTokenizer(nn.Module):
    """The token embeddings (tokenizer.py:43-70)."""

    def __init__(self, num_atoms: int, embed_dim: int, lap_node_id_k: int):
        super().__init__()
        self.atom_encoder = nn.Linear(num_atoms, embed_dim)
        self.temp_encoder = nn.Embedding(100, embed_dim)
        self.edge_encoder = nn.Embedding(5, embed_dim)
        self.order_encoder = nn.Embedding(3, embed_dim)
        self.graph_token = nn.Embedding(1, embed_dim)
        self.null_token = nn.Embedding(1, embed_dim)
        self.lap_encoder = nn.Linear(2 * lap_node_id_k, embed_dim, bias=False)


class GraphEncoder(nn.Module):
    def __init__(self, num_atoms, embed_dim, layers, heads, ffn_dim, lap_node_id_k):
        super().__init__()
        self.graph_feature = GraphFeatureTokenizer(num_atoms, embed_dim, lap_node_id_k)
        self.layers = nn.ModuleList(
            [TokenGTLayer(embed_dim, heads, ffn_dim) for _ in range(layers)])


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
                 lap_node_id_k: int = 50, node_id_mode: str = "lap", performer: bool = False):
        super().__init__()
        if node_id_mode != "lap":
            raise NotImplementedError(
                f"TokenGT node_id_mode={node_id_mode!r} is not ported: {RANDOM_DRAWS}")
        if performer:
            raise NotImplementedError(f"TokenGT performer attention is not ported: {RANDOM_DRAWS}")
        self.lap_node_id_k = lap_node_id_k
        self.graph_encoder = GraphEncoder(num_atoms, embed_dim, layers, heads, ffn_dim,
                                          lap_node_id_k)
        self.lm_head_transform_weight = nn.Linear(embed_dim, embed_dim)
        self.layer_norm = nn.LayerNorm(embed_dim, eps=1e-5)
        self.embed_out = nn.Linear(embed_dim, num_output, bias=False)
        self.lm_output_learned_bias = nn.Parameter(torch.zeros(num_output))

    def forward(self, node_data, node_mask, frame_idx, edge_index, edge_type, edge_mask,
                lap_eigvec):
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

        # Laplacian node identifiers [id_u ; id_v]
        k = self.lap_node_id_k
        eig = lap_eigvec[..., : min(k, lap_eigvec.shape[-1])]
        if eig.shape[-1] < k:
            eig = F.pad(eig, (0, k - eig.shape[-1]))
        node_id_pairs = torch.cat([eig, eig], dim=-1)
        eig_u = eig[batch_ix, edge_index[..., 0]]
        eig_v = eig[batch_ix, edge_index[..., 1]]
        node_feat = node_feat + dense(gf.lap_encoder, node_id_pairs)
        edge_feat = edge_feat + dense(gf.lap_encoder, torch.cat([eig_u, eig_v], dim=-1))

        # type identifiers: 1 for nodes, (u == v) for edges
        order = gf.order_encoder.weight
        node_feat = node_feat + order[1]
        edge_feat = edge_feat + order[(edge_index[..., 0] == edge_index[..., 1]).long()]

        # [graph], [null], nodes, edges
        special = torch.cat([gf.graph_token.weight, gf.null_token.weight], dim=0)
        seq = torch.cat([special[None].expand(b, 2, d), node_feat, edge_feat], dim=1)
        seq_mask = torch.cat([torch.ones((b, 2), dtype=torch.bool, device=seq.device),
                              node_mask, edge_mask], dim=1)
        seq = seq * seq_mask[..., None]
        attn_mask = seq_mask[:, None, :] & seq_mask[:, :, None]
        for layer in self.graph_encoder.layers:
            seq = layer(seq, attn_mask)

        # LM head on the node tokens (per-token, so the others are not needed)
        h = layer_norm(self.layer_norm,
                       F.gelu(dense(self.lm_head_transform_weight, seq[:, 2: 2 + tn])))
        logits = dense(self.embed_out, h) + self.lm_output_learned_bias
        return logits * node_mask[..., None], h * node_mask[..., None], seq[:, 0]
