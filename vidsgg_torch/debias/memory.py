"""Uncertainty-weighted memory banks, single pass and on the device
(counterpart of ``vidsgg/debias/memory.py``).

The reference (tools/utils/Uncertainty.py + tools/utils/Memory.py) dumps
embeddings to ``.npy`` every step and re-reads the epoch's files at epoch
end. Algebraically the epoch-end bank is

* weight_type 'simple': mem[c] = mean of the embeddings labelled c;
* 'al' / 'ep': mem[c] = sum_i exp(u_ic) f_i / (sum_i exp(u_ic) + 1e-12);
* 'both': numerator weights exp(al + ep), with the two quirks of the
  reference's ``stats2`` denominator (``+`` concatenates Python lists):
  relations divide by **2 * sum_i exp(al_ic)** (al twice), objects by
  **sum_i exp(al_ic) + sum_i exp(ep_ic)**.

So each video folds (weighted feature sums, weight sums) per class into a
:class:`MemoryAccumulator` on the device, and :func:`finalize_memory`
divides once at epoch end: no disk, no second pass, no host transfer.
Background objects are excluded.

Bank layout: relation rows are [attention(3); spatial(6); contacting(17)],
the order :func:`accumulate_memory` writes them in, which the joint
hallucinator attends over.
"""

from __future__ import annotations

import dataclasses

import torch

from vidsgg_torch import constants as C
from vidsgg_torch.data.entry import Entry


@dataclasses.dataclass
class MemoryAccumulator:
    rel_wsum: torch.Tensor   # [26, Dr] weighted feature sums
    rel_w: torch.Tensor      # [26] weight sums
    obj_wsum: torch.Tensor   # [C-1, Do]
    obj_w: torch.Tensor      # [C-1]
    # per-class uncertainty statistics (the reference's Uncertainty.stats)
    rel_al_sum: torch.Tensor
    rel_ep_sum: torch.Tensor
    rel_cnt: torch.Tensor
    obj_al_sum: torch.Tensor
    obj_ep_sum: torch.Tensor
    obj_cnt: torch.Tensor
    # per-class exp-sums (the stats2 normalisers)
    rel_expal: torch.Tensor
    rel_expep: torch.Tensor
    obj_expal: torch.Tensor
    obj_expep: torch.Tensor

    @classmethod
    def zeros(cls, rel_dim: int = 1936, obj_dim: int = 1024,
              num_obj_classes: int = C.NUM_OBJ_CLASSES, dtype=torch.float32,
              device=None) -> "MemoryAccumulator":
        nr, no = C.NUM_PREDICATES, num_obj_classes - 1

        def z(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)

        return cls(
            rel_wsum=z(nr, rel_dim), rel_w=z(nr), obj_wsum=z(no, obj_dim), obj_w=z(no),
            rel_al_sum=z(nr), rel_ep_sum=z(nr), rel_cnt=z(nr),
            obj_al_sum=z(no), obj_ep_sum=z(no), obj_cnt=z(no),
            rel_expal=z(nr), rel_expep=z(nr), obj_expal=z(no), obj_expep=z(no),
        )


def _rel_label_matrix(entry: Entry, dtype) -> torch.Tensor:
    """[P, 26] multi-hot over the joint predicate space, masked."""
    att = torch.eye(C.NUM_ATTENTION, dtype=dtype, device=entry.device)[entry.attention_gt.long()]
    lab = torch.cat([att, entry.spatial_gt.to(dtype), entry.contacting_gt.to(dtype)], dim=1)
    return lab * entry.pair_mask[:, None]


def _weights(lab, al, ep, weight_type):
    """Per-sample per-class aggregation weights on labelled slots."""
    if weight_type == "simple" or al is None:
        return lab
    u = {"al": al, "ep": ep}.get(weight_type)
    if u is None:  # 'both'
        u = al + ep
    return lab * torch.exp(u)


def _take_label(u, labels):
    return u.gather(1, labels[:, None])


def accumulate_memory(acc: MemoryAccumulator, entry: Entry, out: dict,
                      rel_weight_type: str = "simple", obj_weight_type: str = "simple",
                      obj_mem: bool = False) -> MemoryAccumulator:
    """Fold one video's uncertainty pass (the ``unc=True`` forward's output)
    into the accumulator; returns the new accumulator."""
    rel_feats = out["rel_features"]  # [P, 1936]
    lab = _rel_label_matrix(entry, rel_feats.dtype)  # [P, 26]
    if "attention_al_uc" in out:
        al = torch.cat([out["attention_al_uc"], out["spatial_al_uc"],
                        out["contacting_al_uc"]], dim=1)
        ep = torch.cat([out["attention_ep_uc"], out["spatial_ep_uc"],
                        out["contacting_ep_uc"]], dim=1)
    else:
        al = ep = None

    w = _weights(lab, al, ep, rel_weight_type)  # [P, 26]
    new = dict(rel_wsum=acc.rel_wsum + w.T @ rel_feats, rel_w=acc.rel_w + w.sum(0))
    if al is not None:
        new.update(
            rel_al_sum=acc.rel_al_sum + (lab * al).sum(0),
            rel_ep_sum=acc.rel_ep_sum + (lab * ep).sum(0),
            rel_cnt=acc.rel_cnt + lab.sum(0),
            rel_expal=acc.rel_expal + (lab * torch.exp(al)).sum(0),
            rel_expep=acc.rel_expep + (lab * torch.exp(ep)).sum(0),
        )

    if obj_mem and "object_features" in out:
        # object axis: background excluded; class c occupies row c - 1
        labels = entry.labels.long()
        valid = entry.obj_mask & (labels != 0)
        n_cls = acc.obj_w.shape[0] + 1
        eye = torch.eye(n_cls, dtype=rel_feats.dtype, device=entry.device)
        olab = eye[labels][:, 1:] * valid[:, None]  # [N, C-1]
        if obj_weight_type != "simple" and "obj_al_uc" in out:
            # uncertainties over the full class axis: take the labelled column
            oal = _take_label(out["obj_al_uc"], labels)
            oep = _take_label(out["obj_ep_uc"], labels)
            u = {"al": oal, "ep": oep}.get(obj_weight_type)
            if u is None:
                u = oal + oep
            ow = olab * torch.exp(u)
        else:
            ow = olab
        new.update(obj_wsum=acc.obj_wsum + ow.T @ out["object_features"],
                   obj_w=acc.obj_w + ow.sum(0))
        if "obj_al_uc" in out:
            oal = _take_label(out["obj_al_uc"], labels)[:, 0]
            oep = _take_label(out["obj_ep_uc"], labels)[:, 0]
            new.update(
                obj_al_sum=acc.obj_al_sum + (olab * oal[:, None]).sum(0),
                obj_ep_sum=acc.obj_ep_sum + (olab * oep[:, None]).sum(0),
                obj_cnt=acc.obj_cnt + olab.sum(0),
                obj_expal=acc.obj_expal + (olab * torch.exp(oal)[:, None]).sum(0),
                obj_expep=acc.obj_expep + (olab * torch.exp(oep)[:, None]).sum(0),
            )
    return dataclasses.replace(acc, **new)


def _denominator(weight_type, w, expal, expep, joint_quirk):
    """The reference's per-class normaliser: 'simple' divides the indicator
    sums by the counts (a class without samples stays zero), the weighted
    types by the stats2 exp-sums + 1e-12, 'both' with the quirks above
    (relations: ``joint_quirk``)."""
    if weight_type == "simple":
        return torch.where(w > 0, w, torch.full_like(w, float("inf")))
    if weight_type == "al":
        return expal + 1e-12
    if weight_type == "ep":
        return expep + 1e-12
    if joint_quirk:  # 'both', relations: stats2's np.exp(al + al)
        return 2.0 * expal + 1e-12
    return expal + expep + 1e-12  # 'both', objects: exp(al) ++ exp(ep)


def finalize_memory(acc: MemoryAccumulator, rel_weight_type: str = "simple",
                    obj_weight_type: str = "simple"):
    """(rel_memory [26, Dr], obj_memory [C-1, Do]); classes without samples
    stay zero."""
    rel_den = _denominator(rel_weight_type, acc.rel_w, acc.rel_expal, acc.rel_expep, True)
    obj_den = _denominator(obj_weight_type, acc.obj_w, acc.obj_expal, acc.obj_expep, False)
    return acc.rel_wsum / rel_den[:, None], acc.obj_wsum / obj_den[:, None]


def uncertainty_stats(acc: MemoryAccumulator) -> dict:
    """Per-class mean uncertainties (the reference's unc_vals.stats view)."""
    rel_c = torch.clamp(acc.rel_cnt, min=1.0)
    obj_c = torch.clamp(acc.obj_cnt, min=1.0)
    return {
        "rel_al_mean": acc.rel_al_sum / rel_c,
        "rel_ep_mean": acc.rel_ep_sum / rel_c,
        "rel_count": acc.rel_cnt,
        "obj_al_mean": acc.obj_al_sum / obj_c,
        "obj_ep_mean": acc.obj_ep_sum / obj_c,
        "obj_count": acc.obj_cnt,
    }
