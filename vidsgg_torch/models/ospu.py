"""OSPU: the object classifier (counterpart of ``vidsgg/models/ospu.py``).

* object features = roi_feat(2048) ⊕ distribution·GloVe(200) ⊕
  pos_embed(128 of BatchNorm+Linear over center-size boxes);
* tracking: one masked self-attention over all object tokens restricted to
  same-predicted-class keys, with the frame rank of each token within its
  class sequence as its sinusoidal position;
* optional memory hallucination over the object memory bank;
* GMM or linear decoder.

The phase is explicit (``phase``, ``unc``, ``deterministic``), as in
``vidsgg``. Outside the deterministic phase the two batch norms take the
valid rows' batch statistics and update their running statistics
(``pos_bn`` at ``vidsgg``'s momentum 0.01 / 10), and dropout at 0.1 acts
after the position MLP, after the position table is added and inside each
tracking layer; every mask comes from the ``noise`` argument
(``noise.py``), in ``vidsgg``'s program order. The train phase's linear
head returns raw logits over all classes, the GMM head its sampled train
distribution; ``phase="train", unc=True`` gives the test-phase
distribution plus ``obj_al_uc``/``obj_ep_uc`` (``vidsgg``'s quirk).

Names follow the reference (``object_classifier.*`` in a TEMPURA
checkpoint): ``positional_encoder.pe`` (a buffer, carried across, never
recomputed), ``obj_embed``, ``pos_embed.{0,1}``, ``encoder_tran.layers.i``,
``intermediate.{0,1}``, ``decoder_lin``, ``mem_attention``/``selector``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from vidsgg_torch import constants as C
from vidsgg_torch.models.gmm_head import GMMHead
from vidsgg_torch.models.noise import dropout
from vidsgg_torch.models.norm import MaskedBatchNorm
from vidsgg_torch.models.promote import dense, matmul
from vidsgg_torch.models.sttran import EncoderLayer, MemoryHallucinator, _Layers

OBJ_FEAT_DIM = 2048 + 200 + 128  # 2376
DROPOUT = 0.1
POS_BN_MOMENTUM = 0.01 / 10.0   # vidsgg/models/ospu.py:150

# the tracking encoder is a torch.nn.TransformerEncoderLayer in the reference
TorchEncoderLayer = EncoderLayer


def sinusoidal_pe(max_len: int, d_model: int) -> np.ndarray:
    """Standard sin/cos table (lib/tempura.py:26-49)."""
    position = np.arange(max_len)[:, None]
    div = np.exp(np.arange(0, d_model, 2) * (-math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), np.float32)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


def center_size(boxes: torch.Tensor) -> torch.Tensor:
    wh = boxes[..., 2:4] - boxes[..., 0:2] + 1.0
    return torch.cat([boxes[..., 0:2] + 0.5 * (wh - 1.0), wh], dim=-1)


class _PositionalEncoder(nn.Module):
    def __init__(self, max_len: int, d_model: int):
        super().__init__()
        self.register_buffer("pe", torch.from_numpy(sinusoidal_pe(max_len, d_model))[None])


class ObjectClassifier(MemoryHallucinator):
    def __init__(self, obj_head: str = "gmm", k: int = 4,
                 num_classes: int = C.NUM_OBJ_CLASSES, mem_compute: bool = False,
                 selection: str | None = None, selection_lambda: float = 0.5,
                 tracking: bool = False, encoder_layers: int = 3,
                 max_pe_len: int = 600):
        super().__init__()
        self.obj_head = obj_head
        self.num_classes = num_classes
        self.tracking = tracking
        self.max_pe_len = max_pe_len
        self.use_memory = mem_compute
        self.obj_embed = nn.Embedding(num_classes - 1, 200)
        # the Dropout keeps the reference's state_dict layout; it never runs
        # (the train phase's dropout is noise.py's)
        self.pos_embed = nn.Sequential(MaskedBatchNorm(4, momentum=POS_BN_MOMENTUM),
                                       nn.Linear(4, 128), nn.ReLU(), nn.Dropout(DROPOUT))
        if tracking:
            self.positional_encoder = _PositionalEncoder(max_pe_len, OBJ_FEAT_DIM)
            self.encoder_tran = _Layers(
                [TorchEncoderLayer(OBJ_FEAT_DIM, 8, 1024) for _ in range(encoder_layers)])
        mem_dim = OBJ_FEAT_DIM if tracking else 1024
        if mem_compute:
            self._init_memory(mem_dim, "joint", selection, selection_lambda)
        self.intermediate = nn.Sequential(
            nn.Linear(OBJ_FEAT_DIM, 1024), MaskedBatchNorm(1024), nn.ReLU())
        if obj_head == "gmm":
            self.decoder_lin = GMMHead(1024, num_classes, k, rel_type=None)
        else:
            self.decoder_lin = nn.Sequential(nn.Linear(1024, num_classes))

    def _track_positions(self, seq_cls, frame, valid, max_frames):
        """Frame rank of each token within its predicted-class sequence."""
        nc = self.num_classes - 1
        counts = torch.zeros((nc, max_frames), dtype=torch.int32, device=seq_cls.device)
        counts.index_put_((seq_cls, frame), valid.to(torch.int32), accumulate=True)
        present = (counts > 0).to(torch.int32)
        cum = torch.cumsum(present, dim=1) - present
        return cum[seq_cls, frame]

    def _intermediate(self, x, valid, deterministic):
        fc, bn, relu = self.intermediate
        return relu(bn(dense(fc, x), valid, use_running_average=deterministic))

    def forward(self, entry, obj_memory=None, mem_active=False, *, phase: str = "test",
                unc: bool = False, deterministic: bool | None = None, noise=None):
        """Returns 'distribution' (train: [N, C]; test: [N, C-1]),
        'object_features', 'object_mem_features', and with ``phase="train",
        unc=True`` on the GMM head 'obj_al_uc'/'obj_ep_uc'."""
        if deterministic is None:
            deterministic = phase != "train"

        def drop(t):
            return dropout(t, DROPOUT, noise, deterministic)

        valid = entry.obj_mask
        obj_embed = matmul(entry.distribution, self.obj_embed.weight)
        bn, fc = self.pos_embed[0], self.pos_embed[1]
        csn = bn(center_size(entry.boxes[:, 1:]), valid, use_running_average=deterministic)
        pos = drop(torch.relu(dense(fc, csn)))
        feats = torch.cat([entry.features, obj_embed, pos], dim=1)

        if self.tracking:
            seq_cls = torch.argmax(entry.distribution, dim=1)
            frame = entry.boxes[:, 0].to(torch.int64)
            pos_idx = self._track_positions(seq_cls, frame, valid,
                                            entry.frame_mask.shape[0])
            pe = self.positional_encoder.pe[0]
            x = drop(feats + pe[torch.clamp(pos_idx, 0, self.max_pe_len - 1).long()])
            same_seq = (seq_cls[:, None] == seq_cls[None, :]) & valid[:, None] & valid[None, :]
            for layer in self.encoder_tran.layers:
                x = layer(x, same_seq, deterministic, noise)
            obj_features = x * valid[:, None]
            object_features = obj_features
            if self.use_memory:
                obj_features = self.hallucinate(obj_features, obj_memory, mem_active)
            object_mem_features = obj_features
            h = self._intermediate(obj_features, valid, deterministic)
        else:
            h = self._intermediate(feats, valid, deterministic)
            object_features = h
            if self.use_memory:
                h = self.hallucinate(h, obj_memory, mem_active)
            object_mem_features = h

        out = {
            "object_features": object_features * valid[:, None],
            "object_mem_features": object_mem_features * valid[:, None],
        }
        if self.obj_head == "gmm":
            if phase == "train" and unc:
                # vidsgg's quirk: test-phase logits for the distribution
                dist = self.decoder_lin(h, "test")
                out["obj_al_uc"], out["obj_ep_uc"] = self.decoder_lin(h, "test", unc=True)
            else:
                dist = self.decoder_lin(h, phase, noise=noise)
        else:
            logits = dense(self.decoder_lin[0], h)
            dist = logits if phase == "train" else torch.softmax(logits[:, 1:], dim=1)
        out["distribution"] = dist * valid[:, None]
        return out
