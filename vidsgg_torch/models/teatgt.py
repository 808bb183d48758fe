"""TEAT-GT: Temporal-Edge-Augmented Tokenized Graph Transformer
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

  + in training, under ``use_cons_str_loss``/``use_cons_sem_loss``, the
     temporal-consistency regularizer: per-frame spatial graphs through two
     ``GraphTransformer``s (structural on the graphs' Laplacian
     eigenvectors, semantic on TokenGT's hidden states), attention-pooled,
     pairwise KL / dt between the frames of each clip
     (:meth:`TeatGT._consistency_losses`).

All clips of a video go through TokenGT as one batch: the reference's
pooled state carried between clips is never read by its TokenGT, so clips
are independent; the pooled state is still returned as
``clip_hidden_state``.

The phase is explicit, as in :mod:`~vidsgg_torch.models.tempura`:
``phase`` ("test" by default, "train"), ``deterministic`` (default: not
the train phase) and ``noise`` (the run's draws: the OSPU's dropouts in
sgcls and sgdet, then TokenGT's dropouts, eig dropout and sign flips, or
its random node identifiers) are arguments of every call, and
``performer`` (the FAVOR+ projections' draws) of the train step's; ``unc`` is taken and
unused, as in ``vidsgg`` (TEAT-GT has no GMM heads).

Names are the reference checkpoint's keys (``subj_fc``, ``obj_fc``,
``node_label_tokenizer``, ``TokenGT_encoder.*``, ``gate_gru_nn`` and its
twin ``gap_gru.gate_nn``, ``object_classifier.*``; with a consistency loss
on, ``gat.*``, ``gat_semantic.*``, ``gate_nn``/``gap.gate_nn`` and
``gate_sem_nn``/``gap_sem.gate_nn``). The regularizer's modules exist only
when a consistency loss is on, as its parameters do in ``vidsgg``, so
the serving model's parameters are the same either way. Each layer computes
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
import torch.nn.functional as F
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
from vidsgg_torch.models.graph_transformer import GlobalAttentionPooling, GraphTransformer
from vidsgg_torch.models.ospu import ObjectClassifier
from vidsgg_torch.models.promote import dense, weak
from vidsgg_torch.models.tokengt import TokenGTEncoder
from vidsgg_torch.ops.laplacian import masked_laplacian_eig


@dataclasses.dataclass(frozen=True)
class TeatGTConfig:
    """Names and defaults of ``vidsgg``'s (tools/utils/teatgt_config.py,
    with its mode-derived overrides)."""

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
    lap_node_id_sign_flip: bool = True
    lap_node_id_eig_dropout: float = 0.2
    node_id_mode: str = "lap"   # 'lap' | 'orf' | 'rand'
    performer: bool = False     # FAVOR+ attention in TokenGT (a model option: no CLI flag)
    performer_nb_features: int = 256
    spatial_thr: float = 0.5
    sim_thr: float = 0.75
    reg_lap_k: int = 10
    # the temporal-consistency regularizer runs (and has parameters) only
    # in training with one of these on
    use_cons_str_loss: bool = False
    use_cons_sem_loss: bool = False
    caps: ClipCaps = ClipCaps()

    @property
    def regularizer(self) -> bool:
        return self.use_cons_str_loss or self.use_cons_sem_loss

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
            lap_node_id_k=cfg.lap_node_id_k, lap_sign_flip=cfg.lap_node_id_sign_flip,
            lap_eig_dropout=cfg.lap_node_id_eig_dropout, node_id_mode=cfg.node_id_mode,
            performer=cfg.performer, performer_nb_features=cfg.performer_nb_features,
        )
        self.gate_gru_nn = nn.Linear(cfg.encoder_embed_dim, 1)
        self.gap_gru = GlobalAttentionPooling(self.gate_gru_nn)
        if cfg.regularizer:
            tf = cfg.caps.tokens_per_frame
            self.gat = GraphTransformer(cfg.reg_lap_k, max_nodes=tf)
            self.gat_semantic = GraphTransformer(cfg.encoder_embed_dim, max_nodes=tf)
            self.gate_nn = nn.Linear(cfg.reg_lap_k, 1)
            self.gap = GlobalAttentionPooling(self.gate_nn)
            self.gate_sem_nn = nn.Linear(cfg.encoder_embed_dim, 1)
            self.gap_sem = GlobalAttentionPooling(self.gate_sem_nn)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        init_weights_(self, gen)
        if cfg.regularizer:
            self.gat.init_pos_(gen)
            self.gat_semantic.init_pos_(gen)
        with torch.no_grad():  # label tables start from the word vectors
            init = torch.from_numpy(obj_edge_vectors(list(C.AG_OBJECT_CLASSES)[: cfg.num_classes]))
            self.node_label_tokenizer.weight.copy_(init)
            if cfg.mode != "predcls":
                self.object_classifier.obj_embed.weight.copy_(init[1:])
        self.to(dev)
        self.eval()

    def classify_objects(self, entry: Entry, obj_memory=None, mem_active=False, *,
                         phase: str = "test", unc: bool = False,
                         deterministic: bool | None = None, noise=None) -> dict:
        """OSPU (test phase by default)."""
        return self.object_classifier(entry, obj_memory, mem_active, phase=phase, unc=unc,
                                      deterministic=deterministic, noise=noise)

    def relation_forward(self, entry: Entry, obj_mem_features=None, rel_memory=None,
                         mem_active=False, *, phase: str = "test", unc: bool = False,
                         deterministic: bool | None = None, noise=None,
                         performer=None) -> dict:
        """Graph construction + TokenGT + heads (+ in the train phase the
        consistency regularizer's ``structure_temp_loss`` and
        ``semantic_temp_loss``, both whenever either loss is on). The
        memory arguments are taken for ``EvalPipeline``'s sake and unused:
        TEAT-GT has no memory. ``performer``: the train step's draws of the
        FAVOR+ projections (``cfg.performer``)."""
        cfg = self.cfg
        caps = cfg.caps
        if deterministic is None:
            deterministic = phase != "train"
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
                cfeat, cmask, cframe, edge_index, edge_type, edge_mask, eigvec.float(),
                deterministic, noise, performer)
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

        if phase == "train" and cfg.regularizer:
            with record_function("vidsgg.consistency"):
                out["structure_temp_loss"], out["semantic_temp_loss"] = \
                    self._consistency_losses(entry, layout, node_hidden)
        return out

    def forward(self, entry: Entry, rel_memory=None, obj_memory=None,
                mem_active=False, *, phase: str = "test", unc: bool = False,
                deterministic: bool | None = None, noise=None, performer=None) -> dict:
        """The full forward: OSPU (none in predcls; its draws come first),
        then the relation stage on the entry as it is (the predcls test
        step; training in every mode)."""
        if deterministic is None:
            deterministic = phase != "train"
        kw = dict(phase=phase, unc=unc, deterministic=deterministic, noise=noise)
        aux = ({} if self.cfg.mode == "predcls"
               else self.classify_objects(entry, obj_memory, mem_active, **kw))
        return {**aux, **self.relation_forward(entry, performer=performer, **kw)}

    def _consistency_losses(self, entry: Entry, layout, node_hidden):
        """Per-frame graph embeddings -> pairwise KL / dt within clips
        (lib/teatgt.py:285-334): (structural loss, semantic loss)."""
        cfg = self.cfg
        caps = cfg.caps
        dev = entry.pair_mask.device
        f_cap = entry.frame_mask.shape[0]

        # per-frame spatial graphs: centre distance <= the rounded threshold
        ft = layout.frame_tokens.long()   # [F, Tf]
        fmask = layout.frame_mask
        fcenter = layout.token_center[ft]
        thr = spatial_threshold(entry.video_size, cfg.spatial_thr)
        vv = fmask[:, :, None] & fmask[:, None, :]
        not_self = ~torch.eye(caps.tokens_per_frame, dtype=torch.bool, device=dev)[None]
        d = torch.sqrt(((fcenter[:, :, None, :] - fcenter[:, None, :, :]) ** 2).sum(-1)
                       + weak(1e-12, fcenter))
        f_adj = (vv & not_self & (d <= thr)).float()

        # structural stream: the first k eigenvectors (float64, as serving's;
        # float32 afterwards, vidsgg's type), zero-padded to k
        _, f_eig = masked_laplacian_eig(f_adj.double(), fmask)
        k = cfg.reg_lap_k
        f_nodes = f_eig.float()[:, :, : min(k, f_eig.shape[-1])]
        if f_nodes.shape[-1] < k:
            f_nodes = F.pad(f_nodes, (0, k - f_nodes.shape[-1]))

        # semantic stream: TokenGT's hidden states scattered back to the
        # global token axis (padding to a dump row), gathered per frame
        t_cap = layout.token_frame.shape[0]
        dmodel = node_hidden.shape[-1]
        flat_tokens = layout.clip_tokens.long().reshape(-1)
        flat_ok = layout.clip_mask.reshape(-1)
        hidden_global = node_hidden.new_zeros((t_cap + 1, dmodel))
        hidden_global[torch.where(flat_ok, flat_tokens, torch.full_like(flat_tokens, t_cap))] = \
            node_hidden.reshape(-1, dmodel)
        f_sem = hidden_global[:t_cap][ft] * fmask[..., None]

        edges = f_adj[..., None]
        g_struct = self.gap(self.gat(f_nodes, edges, fmask), fmask)              # [F, k]
        g_sem = self.gap_sem(self.gat_semantic(f_sem, edges, fmask), fmask)      # [F, D]

        frame_ok = fmask.any(-1) & entry.frame_mask
        u = torch.arange(f_cap, device=dev)
        same_clip = (u[:, None] // caps.clip_size) == (u[None, :] // caps.clip_size)
        ok = same_clip & (u[None, :] > u[:, None]) & frame_ok[:, None] & frame_ok[None, :]
        dt = torch.clamp((u[None, :] - u[:, None]).float(), min=1.0)
        cnt = torch.clamp(ok.sum(), min=1)

        def pairwise_kl(sym):
            # kl[u, v] = sum_d q_v (log q_v - logp_u); the maxima are
            # torch.maximum for jnp.maximum's (and jnp.clip's) tie gradient
            logp = torch.log_softmax(sym, dim=-1)
            q = torch.softmax(sym, dim=-1)
            ent = (q * torch.log(torch.maximum(q, torch.full_like(q, 1e-30)))).sum(-1)
            kl = (ent[:, None] - q @ logp.T).T
            scores = torch.where(ok, torch.maximum(kl, torch.zeros_like(kl)) / dt,
                                 torch.zeros_like(kl))
            return scores.sum() / cnt

        return pairwise_kl(g_struct), pairwise_kl(g_sem)
