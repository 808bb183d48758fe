"""TEAT-GT: Temporal-Edge-Augmented Tokenized Graph Transformer, test phase
(counterpart of ``vidsgg/models/teatgt.py``, the reference's lib/teatgt.py).

  OSPU (linear head, no memory; sgcls and sgdet only)
  -> person/object tokens: fc(2048 -> 968) ⊕ 200-d label embedding = 1168
  -> frame-ordered tokens, 5-frame clips
  -> per-clip graphs: spatial edges (center distance <= 0.5 x the video
     diagonal, rounded to 4 decimals) + temporal edges (token cosine >= 0.75
     across adjacent frames)
  -> normalized-Laplacian eigenvectors as node identifiers (in float64)
  -> TokenGT -> 26-way logits on object tokens -> split 3/6/17,
     softmax/sigmoid.

All clips of a video go through TokenGT as one batch: the reference's
pooled state carried between clips is never read by its TokenGT, so clips
are independent; the pooled state is still returned as
``clip_hidden_state``. The train-time temporal-consistency regularizer
(``GraphTransformer``s over per-frame graphs) comes with training.

Names are the reference checkpoint's keys (``subj_fc``, ``obj_fc``,
``node_label_tokenizer``, ``TokenGT_encoder.*``, ``gate_gru_nn`` and its
twin ``gap_gru.gate_nn``, ``object_classifier.*``). Each layer computes
in the promotion of its input's and its parameters' types, as ``vidsgg``'s
(``promote.py``). In a bfloat16 copy the graph is built from bfloat16
tokens, centres and video size (the spatial threshold's constants take
that type too, as JAX's weak-typed scalars do); the eigenvectors reach
TokenGT as float32, the type of ``vidsgg``'s float32 eigendecomposition,
so the Laplacian identifiers and with them TokenGT run in float32.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.profiler import record_function

from vidsgg_torch import constants as C
from vidsgg_torch.data.entry import Entry
from vidsgg_torch.device import resolve_device
from vidsgg_torch.init import init_weights_
from vidsgg_torch.models.embeddings import obj_edge_vectors
from vidsgg_torch.models.graph_build import (
    ClipCaps,
    build_token_layout,
    clip_edge_masks,
    masks_to_edge_list,
)
from vidsgg_torch.models.graph_transformer import GlobalAttentionPooling
from vidsgg_torch.models.ospu import ObjectClassifier
from vidsgg_torch.models.promote import dense, weak
from vidsgg_torch.models.tokengt import TokenGTEncoder
from vidsgg_torch.ops.laplacian import masked_laplacian_eig


@dataclasses.dataclass(frozen=True)
class TeatGTConfig:
    """Names and defaults of ``vidsgg``'s (tools/utils/teatgt_config.py,
    with its mode-derived overrides); its train-only fields (Laplacian sign
    flips and eig dropout, the regularizer's) come with training."""

    mode: str = "predcls"
    num_classes: int = C.NUM_OBJ_CLASSES
    tracking: bool = False
    encoder_layers: int = 12
    encoder_attention_heads: int = 32
    encoder_embed_dim: int = 768
    encoder_ffn_embed_dim: int = 768
    num_atoms: int = 1168
    num_output: int = 26
    lap_node_id_k: int = 50
    node_id_mode: str = "lap"   # 'lap'; 'orf' and 'rand' are refused
    performer: bool = False     # refused
    spatial_thr: float = 0.5
    sim_thr: float = 0.75
    caps: ClipCaps = ClipCaps()

    @staticmethod
    def for_mode(mode: str, **kw) -> "TeatGTConfig":
        """Non-predcls modes: tracking, 6 layers, 16 heads (teatgt_config.py:11-14)."""
        if mode != "predcls":
            kw.setdefault("tracking", True)
            kw.setdefault("encoder_layers", 6)
            kw.setdefault("encoder_attention_heads", 16)
        return TeatGTConfig(mode=mode, **kw)


def spatial_threshold(video_size: torch.Tensor, spatial_thr: float) -> torch.Tensor:
    """``spatial_thr`` x the video diagonal, rounded to 4 decimals like the
    reference's ``np.round(..., 4)``, in the video size's type (the
    constants take it too, as JAX's weak-typed scalars do)."""
    diag = torch.sqrt((video_size ** 2).sum())
    e4 = weak(1e4, diag)
    return torch.round(weak(spatial_thr, diag) * diag * e4) / e4


class TeatGT(nn.Module):
    def __init__(self, cfg: TeatGTConfig, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        if cfg.mode != "predcls":
            self.object_classifier = ObjectClassifier(
                obj_head="linear", k=4, num_classes=cfg.num_classes, mem_compute=False,
                selection=None, tracking=cfg.tracking,
                max_pe_len=600 if cfg.mode == "sgdet" else 400,
            )
        self.subj_fc = nn.Linear(2048, 968)
        self.obj_fc = nn.Linear(2048, 968)
        self.node_label_tokenizer = nn.Embedding(cfg.num_classes, 200)
        self.TokenGT_encoder = TokenGTEncoder(
            num_atoms=cfg.num_atoms, num_output=cfg.num_output,
            embed_dim=cfg.encoder_embed_dim, layers=cfg.encoder_layers,
            heads=cfg.encoder_attention_heads, ffn_dim=cfg.encoder_ffn_embed_dim,
            lap_node_id_k=cfg.lap_node_id_k, node_id_mode=cfg.node_id_mode,
            performer=cfg.performer,
        )
        self.gate_gru_nn = nn.Linear(cfg.encoder_embed_dim, 1)
        self.gap_gru = GlobalAttentionPooling(self.gate_gru_nn)
        init_weights_(self, generator)
        with torch.no_grad():  # label tables start from the word vectors
            init = torch.from_numpy(obj_edge_vectors(list(C.AG_OBJECT_CLASSES)[: cfg.num_classes]))
            self.node_label_tokenizer.weight.copy_(init)
            if cfg.mode != "predcls":
                self.object_classifier.obj_embed.weight.copy_(init[1:])
        self.to(dev)
        self.eval()

    def classify_objects(self, entry: Entry, obj_memory=None, mem_active=False) -> dict:
        """OSPU, test phase."""
        return self.object_classifier(entry, obj_memory, mem_active)

    def relation_forward(self, entry: Entry, obj_mem_features=None, rel_memory=None,
                         mem_active=False) -> dict:
        """Graph construction + TokenGT + heads, test phase. The memory
        arguments are taken for ``EvalPipeline``'s sake and unused: TEAT-GT
        has no memory."""
        cfg = self.cfg
        caps = cfg.caps
        dev = entry.pair_mask.device
        with record_function("vidsgg.graph_build"):
            layout = build_token_layout(entry, caps)

            # token features: person/object projections + label embedding = 1168
            feats = entry.features[layout.token_box]
            proj = torch.where(layout.token_is_person[:, None], dense(self.subj_fc, feats),
                               dense(self.obj_fc, feats))
            tok = torch.cat([proj, self.node_label_tokenizer.weight[layout.token_label]], dim=1)
            tok = tok * layout.token_valid[:, None]

            # per-clip gathers
            ct = layout.clip_tokens.long()
            cmask = layout.clip_mask
            cfeat = tok[ct] * cmask[..., None]
            offset = (torch.arange(caps.n_clips, device=dev) * caps.clip_size)[:, None]
            cframe = torch.where(cmask, layout.token_frame[ct] - offset, torch.zeros_like(ct))
            ccenter = layout.token_center[ct]

            thr = spatial_threshold(entry.video_size, cfg.spatial_thr)
            spatial, temporal = clip_edge_masks(cframe, ccenter, cfeat, cmask, thr,
                                                cfg.sim_thr)
            edge_index, edge_type, edge_mask, adj = masks_to_edge_list(
                spatial, temporal, caps.edges_per_clip)
        with record_function("vidsgg.eigh"):
            # float64: the padding's 1e6 diagonal sets the norm of these
            # small matrices, and float32 cuSOLVER on the H100 returned
            # eigenvalues up to 1.0 off and cluster projectors up to 0.94
            # off, where float64 is within 1e-13 of the CPU's and no slower
            # (chip_smoke.py, PERF.md)
            _, eigvec = masked_laplacian_eig(adj.double(), cmask)
        with record_function("vidsgg.tokengt"):
            node_logits, node_hidden, _ = self.TokenGT_encoder(
                cfeat, cmask, cframe, edge_index, edge_type, edge_mask, eigvec.float())
        out = {"clip_hidden_state": self.gap_gru(node_hidden, cmask)}

        # object-token logits -> pair axis; row p_cap takes every other token
        p_cap = entry.pair_mask.shape[0]
        is_obj = cmask & ~layout.token_is_person[ct]
        pair_ids = torch.where(is_obj, layout.token_pair[ct],
                               torch.full_like(ct, p_cap)).reshape(-1)

        def to_pairs(x):
            buf = x.new_zeros((p_cap + 1, x.shape[-1]))
            buf[pair_ids] = x.reshape(-1, x.shape[-1])
            return buf[:p_cap]

        pair_logits = to_pairs(node_logits)
        pm = entry.pair_mask[:, None]
        out["attention_distribution"] = torch.softmax(pair_logits[:, :3], dim=-1) * pm
        out["spatial_distribution"] = torch.sigmoid(pair_logits[:, 3:9]) * pm
        out["contacting_distribution"] = torch.sigmoid(pair_logits[:, 9:]) * pm
        # object-token hidden states in pair order
        out["rel_features"] = to_pairs(node_hidden)
        return out

    def forward(self, entry: Entry, rel_memory=None, obj_memory=None,
                mem_active=False) -> dict:
        """The full test-phase forward: OSPU (none in predcls), then the
        relation stage on the entry as it is (the predcls test step)."""
        aux = ({} if self.cfg.mode == "predcls"
               else self.classify_objects(entry, obj_memory, mem_active))
        return {**aux, **self.relation_forward(entry)}
