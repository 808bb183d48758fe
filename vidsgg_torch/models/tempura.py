"""TEMPURA: OSPU + pair features + STTran + GMM predicate heads.

Counterpart of ``vidsgg/models/tempura.py``. The module exposes the two
stages between which sgcls and sgdet interpose their relabel (and NMS)
and pair rebuild: :meth:`Tempura.classify_objects` (OSPU) and
:meth:`Tempura.relation_forward`; :meth:`Tempura.forward` runs both
back to back, which is the whole predcls step (predcls has no object
classifier: the GT labels pass through).

The phase is explicit, as in ``vidsgg``, never ``nn.Module.train()``:
``phase`` ("test" by default, "train"), ``unc`` (the GMM heads'
uncertainties instead of distributions) and ``deterministic`` (default:
not the train phase) are arguments of every call, and the train phase
draws its dropout masks and GMM noise from the ``noise`` argument
(``noise.py``). Non-deterministic calls use the batch statistics of the
masked batch norms and update their running statistics; in sgcls and sgdet
the train forward runs the OSPU's train phase and then the relation stage
on the entry as it is (its ``pred_labels``: the GT labels of sgcls, the
assigned ones of sgdet).

Pair features: subj_fc(2048->512) ⊕ obj_fc(2048->512) ⊕ vr (1x1 conv over
the union ROI features + a conv stack over the 2x27x27 spatial masks,
flattened CHW through vr_fc->512) ⊕ two 200-d label embeddings = 1936.

Names are the reference TEMPURA checkpoint's keys (``union_func1``,
``conv.{0,2,4,6}``, ``subj_fc``, ``obj_fc``, ``vr_fc``, ``obj_embed``,
``obj_embed2``, ``glocal_transformer.*``, ``{a,s,c}_rel_compress``,
``object_classifier.*``), so the pair-feature layers sit on the model
itself (:class:`PairFeatures` is its base class). Since the convolutions
run NCHW, ``vr_fc`` takes the reference's CHW flatten with the reference's
weight as it is.

Each layer computes in the promotion of its input's and its parameters'
types, as ``vidsgg``'s Flax layers do (``promote.py``): ``model.double()``
gives float64; a bfloat16 copy (``EvalPipeline(compute_dtype=...)``) runs
bfloat16 where its inputs are bfloat16 and float32 where they are float32
(the spatial masks, and with them the visual pair features and the
relation transformer, in the sgcls and sgdet stages).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from vidsgg_torch import constants as C
from vidsgg_torch.data.entry import Entry
from vidsgg_torch.device import resolve_device
from vidsgg_torch.init import init_weights_
from vidsgg_torch.models.embeddings import obj_edge_vectors
from vidsgg_torch.models.gmm_head import GMMHead
from vidsgg_torch.models.norm import MaskedBatchNorm
from vidsgg_torch.models.ospu import ObjectClassifier
from vidsgg_torch.models.promote import conv2d, dense
from vidsgg_torch.models.sttran import STTran


@dataclasses.dataclass(frozen=True)
class TempuraConfig:
    """Model hyperparameters (names and defaults of ``vidsgg``'s)."""

    mode: str = "predcls"
    num_classes: int = C.NUM_OBJ_CLASSES
    attention_class_num: int = C.NUM_ATTENTION
    spatial_class_num: int = C.NUM_SPATIAL
    contact_class_num: int = C.NUM_CONTACTING
    enc_layers: int = 1
    dec_layers: int = 3
    obj_head: str = "linear"
    rel_head: str = "gmm"
    k: int = 6
    tracking: bool = False
    track_layers: int = 3
    obj_mem_compute: bool = False
    rel_mem_compute: str | None = "joint"  # 'joint' | 'seperate' | None
    take_obj_mem_feat: bool = False
    mem_fusion: str = "late"
    selection: str = "manual"
    selection_lambda: float = 0.5

    @staticmethod
    def for_mode(mode: str, **kw) -> "TempuraConfig":
        """Non-predcls modes force K=4 and tracking, as the reference does."""
        if mode != "predcls":
            kw.setdefault("k", 4)
            kw.setdefault("tracking", True)
        return TempuraConfig(mode=mode, **kw)


class PairFeatures(nn.Module):
    """The pair-feature layers, as a base class of :class:`Tempura` (the
    reference keeps them at the top of its checkpoint)."""

    def _init_pair_features(self, cfg: TempuraConfig):
        self.union_func1 = nn.Conv2d(1024, 256, 1)
        self.conv = nn.Sequential(
            nn.Conv2d(2, 128, 7, stride=2, padding=3),
            nn.ReLU(),
            MaskedBatchNorm(128, channel_dim=1, momentum=0.01),
            nn.MaxPool2d(3, stride=2, padding=1),
            nn.Conv2d(128, 256, 3, padding=1),
            nn.ReLU(),
            MaskedBatchNorm(256, channel_dim=1, momentum=0.01),
        )
        self.subj_fc = nn.Linear(2048, 512)
        self.obj_fc = nn.Linear(2048, 512)
        self.vr_fc = nn.Linear(256 * 7 * 7, 512)
        self.obj_embed = nn.Embedding(cfg.num_classes, 200)
        self.obj_embed2 = nn.Embedding(cfg.num_classes, 200)

    def pair_features(self, entry: Entry, obj_mem_features, pred_labels,
                      deterministic: bool = True):
        """-> (rel [P, 1936], obj_class [P]). Not deterministic: the mask
        convs' batch norms take the valid pairs' batch statistics."""
        pair = entry.pair_idx.long()
        pm = entry.pair_mask
        src = obj_mem_features if self.cfg.take_obj_mem_feat else entry.features
        subj = dense(self.subj_fc, src[pair[:, 0]])
        obj = dense(self.obj_fc, src[pair[:, 1]])

        u = conv2d(self.union_func1, entry.union_feat.permute(0, 3, 1, 2))
        h = entry.spatial_masks
        for layer in self.conv:
            if isinstance(layer, nn.Conv2d):
                h = conv2d(layer, h)
            elif isinstance(layer, MaskedBatchNorm):
                mask = pm[:, None, None].expand(h.shape[0], h.shape[2], h.shape[3])
                h = layer(h, mask, use_running_average=deterministic)
            else:
                h = layer(h)
        vr = dense(self.vr_fc, (u + h).reshape(u.shape[0], -1))     # CHW flatten
        x_visual = torch.cat([subj, obj, vr], dim=1)

        subj_cls = pred_labels.long()[pair[:, 0]]
        obj_cls = pred_labels.long()[pair[:, 1]]
        x_sem = torch.cat([self.obj_embed.weight[subj_cls],
                           self.obj_embed2.weight[obj_cls]], dim=1)
        rel = torch.cat([x_visual, x_sem], dim=1)
        return rel * pm[:, None], obj_cls


class Tempura(PairFeatures):
    def __init__(self, cfg: TempuraConfig, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self._init_pair_features(cfg)
        if cfg.mode != "predcls":
            self.object_classifier = ObjectClassifier(
                obj_head=cfg.obj_head, k=cfg.k,
                num_classes=cfg.num_classes, mem_compute=cfg.obj_mem_compute,
                selection=cfg.selection, selection_lambda=cfg.selection_lambda,
                tracking=cfg.tracking, encoder_layers=cfg.track_layers,
                max_pe_len=600 if cfg.mode == "sgdet" else 400,
            )
        self.glocal_transformer = STTran(
            embed_dim=1936, nhead=8, enc_layers=cfg.enc_layers,
            dec_layers=cfg.dec_layers, dim_feedforward=2048,
            mem_compute=cfg.rel_mem_compute, selection=cfg.selection,
            selection_lambda=cfg.selection_lambda, mem_fusion=cfg.mem_fusion,
        )
        if cfg.rel_head == "gmm":
            self.a_rel_compress = GMMHead(1936, cfg.attention_class_num, cfg.k, "attention")
            self.s_rel_compress = GMMHead(1936, cfg.spatial_class_num, cfg.k, "spatial")
            self.c_rel_compress = GMMHead(1936, cfg.contact_class_num, cfg.k, "contact")
        else:
            self.a_rel_compress = nn.Linear(1936, cfg.attention_class_num)
            self.s_rel_compress = nn.Linear(1936, cfg.spatial_class_num)
            self.c_rel_compress = nn.Linear(1936, cfg.contact_class_num)
        init_weights_(self, generator)
        with torch.no_grad():  # label tables start from the word vectors
            init = torch.from_numpy(obj_edge_vectors(list(C.AG_OBJECT_CLASSES)[: cfg.num_classes]))
            self.obj_embed.weight.copy_(init)
            self.obj_embed2.weight.copy_(init)
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
                         deterministic: bool | None = None, noise=None) -> dict:
        """Pair features -> STTran -> predicate heads."""
        cfg = self.cfg
        if deterministic is None:
            deterministic = phase != "train"
        if obj_mem_features is None:
            obj_mem_features = entry.features
        rel_in, obj_class = self.pair_features(entry, obj_mem_features, entry.pred_labels,
                                               deterministic)
        global_output, rel_feats, mem_feats = self.glocal_transformer(
            rel_in, entry.im_idx, entry.pair_mask, entry.num_frames,
            memory=rel_memory, mem_active=mem_active, deterministic=deterministic,
            noise=noise,
        )
        out = {
            "obj_class": obj_class,
            "rel_features": rel_feats,
            "rel_mem_features": mem_feats,
        }
        pm = entry.pair_mask[:, None]
        heads = (("attention", self.a_rel_compress), ("spatial", self.s_rel_compress),
                 ("contacting", self.c_rel_compress))
        if cfg.rel_head == "gmm":
            for name, head in heads:
                if unc:
                    out[f"{name}_al_uc"], out[f"{name}_ep_uc"] = head(
                        global_output, phase, unc=True)
                else:
                    out[f"{name}_distribution"] = head(global_output, phase,
                                                       noise=noise) * pm
        else:
            a = dense(self.a_rel_compress, global_output)
            if phase == "test":
                a = torch.softmax(a, dim=-1)
            out["attention_distribution"] = a * pm
            out["spatial_distribution"] = torch.sigmoid(
                dense(self.s_rel_compress, global_output)) * pm
            out["contacting_distribution"] = torch.sigmoid(
                dense(self.c_rel_compress, global_output)) * pm
        return out

    def forward(self, entry: Entry, rel_memory=None, obj_memory=None,
                mem_active=False, *, phase: str = "test", unc: bool = False,
                deterministic: bool | None = None, noise=None, performer=None) -> dict:
        """The full forward: OSPU (none in predcls), then the relation stage
        on the entry as it is. The train step of every mode and the predcls
        test step; sgcls and sgdet tests relabel between the two stages
        instead. ``performer`` (the train step's Performer draws, which
        ``vidsgg`` hands every model) is taken and unused: TEMPURA has no
        Performer attention."""
        if deterministic is None:
            deterministic = phase != "train"
        aux = {} if self.cfg.mode == "predcls" else self.classify_objects(
            entry, obj_memory, mem_active, phase=phase, unc=unc,
            deterministic=deterministic, noise=noise)
        out = self.relation_forward(entry, aux.get("object_mem_features"), rel_memory,
                                    mem_active, phase=phase, unc=unc,
                                    deterministic=deterministic, noise=noise)
        return {**aux, **out}
