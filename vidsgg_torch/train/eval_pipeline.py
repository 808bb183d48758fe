"""Mode-aware evaluation pipelines (counterpart of
``vidsgg/train/eval_pipeline.py``).

* predcls: the whole model forward on the GT-box entry (no object
  classifier: the GT labels pass through).
* sgcls (fused): OSPU classify -> on-device relabel, modal-class dedup and
  pair rebuild -> union refeaturize -> relation forward.
* sgdet (fused): OSPU classify -> on-device clean_class + grouped NMS +
  relabel + pair rebuild on the expanded object axis -> union refeaturize
  (ungrouped, ``vidsgg``'s default; per-frame grouped pooling with
  ``union_pairs_per_frame``, as the test CLIs ask for) -> relation
  forward. When it reports overflow (clean_class growth past the expanded
  axis, or a frame with more pairs than ``union_pairs_per_frame``), the
  exact host path runs instead.
* the host path (sgcls with ``device_postprocess=False``, sgdet on
  overflow): OSPU classify -> NumPy postprocess -> repacked Entry -> union
  ROIAlign -> relation forward.

With ``needs_union=False`` (TEAT-GT, which reads object features and
pairs only) no stage pools union features, and sgdet's overflow comes from
its postprocess alone.

``compute_dtype`` (``torch.bfloat16``) serves in ``vidsgg``'s
serving precision: the model's parameters and buffers, both memory banks,
the entry's floating fields and the feature maps are cast to it
(:func:`cast_state_for_serving`, :func:`cast_floating`), and each layer
promotes as ``vidsgg``'s do. The host path then receives bfloat16 values
(as float32 arrays holding them) and rebuilds a float32 entry, as
``vidsgg``'s does through ``np.asarray``.

The result is an evaluator-ready NumPy pred dict.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from vidsgg_torch.data.entry import Entry, EntryCapacity
from vidsgg_torch.detector.featurize import (
    featurize_pair_entry,
    pair_union_features,
    pair_union_features_grouped,
)
from vidsgg_torch.device import resolve_device
from vidsgg_torch.eval.adapter import to_eval_pred
from vidsgg_torch.models.postprocess import ObjectsView, sgcls_postprocess, sgdet_postprocess
from vidsgg_torch.models.postprocess_device import (
    sgcls_postprocess_device,
    sgdet_postprocess_device,
)
from vidsgg_torch.train.state import ServingState, TrainState, cast_state_for_serving


MODES = ("predcls", "sgcls", "sgdet")


def cast_floating(entry: Entry, dtype: torch.dtype) -> Entry:
    """The entry with every floating field cast to ``dtype``."""
    return dataclasses.replace(entry, **{
        f.name: getattr(entry, f.name).to(dtype) for f in dataclasses.fields(entry)
        if getattr(entry, f.name).is_floating_point()})


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host; bfloat16 as float32 holding its values."""
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _predcls_stage(state: ServingState, entry: Entry):
    """The whole predcls test forward (GT boxes + labels -> predicate
    distributions)."""
    with record_function("vidsgg.relation_forward"):
        return state.model(entry, rel_memory=state.rel_memory,
                           obj_memory=state.obj_memory, mem_active=state.mem_active)


def _classify_stage(state: ServingState, entry: Entry):
    return state.model.classify_objects(
        entry, obj_memory=state.obj_memory, mem_active=state.mem_active)


def _relation_stage(state: ServingState, entry: Entry, obj_mem_features, fmaps,
                    needs_union: bool):
    if needs_union:
        entry = featurize_pair_entry(entry, fmaps)
    out = state.model.relation_forward(
        entry, obj_mem_features, rel_memory=state.rel_memory,
        mem_active=state.mem_active)
    return entry, out


def _sgcls_fused(state: ServingState, entry: Entry, fmaps, needs_union: bool):
    """The whole sgcls test step on the device -> (entry2, out)."""
    with record_function("vidsgg.classify"):
        aux = _classify_stage(state, entry)
    with record_function("vidsgg.postprocess"):
        entry2 = sgcls_postprocess_device(entry, aux["distribution"])
    if needs_union:
        with record_function("vidsgg.union_features"):
            entry2 = featurize_pair_entry(entry2, fmaps)
    with record_function("vidsgg.relation_forward"):
        out = state.model.relation_forward(
            entry2, aux.get("object_mem_features"), rel_memory=state.rel_memory,
            mem_active=state.mem_active)
    return entry2, out


def _sgdet_fused(state: ServingState, entry: Entry, fmaps, union_ppf: int | None,
                 needs_union: bool):
    """The whole sgdet test step on the device. Returns (entry2, out,
    overflow); the caller re-runs the exact host path on overflow.
    ``union_ppf``: the per-frame pair bound of grouped union pooling, or
    None for ungrouped pooling (no union overflow)."""
    with record_function("vidsgg.classify"):
        aux = _classify_stage(state, entry)
    with record_function("vidsgg.postprocess"):
        entry2, mem2, overflow = sgdet_postprocess_device(
            entry, aux["distribution"], aux["object_mem_features"])
    if needs_union:
        with record_function("vidsgg.union_features"):
            if union_ppf is None:
                union_feat, _, spatial_masks = pair_union_features(entry2, fmaps)
            else:
                union_feat, _, spatial_masks, u_ovf = pair_union_features_grouped(
                    entry2, fmaps, union_ppf)
                overflow = overflow | u_ovf
        entry2 = dataclasses.replace(entry2, union_feat=union_feat,
                                     spatial_masks=spatial_masks)
    with record_function("vidsgg.relation_forward"):
        out = state.model.relation_forward(
            entry2, mem2, rel_memory=state.rel_memory, mem_active=state.mem_active)
    return entry2, out, overflow


def _pad_rows(arr: np.ndarray, cap: int) -> np.ndarray:
    out = np.zeros((cap,) + arr.shape[1:], arr.dtype)
    out[: len(arr)] = arr
    return out


def _rebuild_entry(entry: Entry, o: ObjectsView, human_idx, im_idx, pairs,
                   cap: EntryCapacity):
    """Pack the postprocessed host view back into a padded Entry on the
    entry's device. Returns (entry, mem_features_padded)."""
    n = len(o.boxes)
    p = len(im_idx)
    if n > cap.max_objs or p > cap.max_pairs:
        raise ValueError(
            f"postprocessed video ({n} objs, {p} pairs) exceeds capacity {cap}")
    dev = entry.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    base = Entry.zeros(cap, num_classes=entry.distribution.shape[1] + 1, device=dev)
    new = dataclasses.replace(
        base,
        boxes=t(_pad_rows(o.boxes.astype(np.float32), cap.max_objs)),
        labels=t(_pad_rows(o.labels.astype(np.int32), cap.max_objs)),
        scores=t(_pad_rows(o.pred_scores.astype(np.float32), cap.max_objs)),
        distribution=t(_pad_rows(o.distribution.astype(np.float32), cap.max_objs)),
        pred_labels=t(_pad_rows(o.pred_labels.astype(np.int32), cap.max_objs)),
        features=t(_pad_rows(o.features.astype(np.float32), cap.max_objs)),
        obj_mask=t(np.arange(cap.max_objs) < n),
        im_idx=t(_pad_rows(im_idx.astype(np.int32), cap.max_pairs)),
        pair_idx=t(_pad_rows(pairs.astype(np.int32), cap.max_pairs)),
        pair_mask=t(np.arange(cap.max_pairs) < p),
        human_idx=t(_pad_rows(human_idx.astype(np.int32), cap.max_frames)),
        frame_mask=entry.frame_mask,
        im_scale=entry.im_scale,
        num_frames=entry.num_frames,
        video_size=entry.video_size,
    )
    mem = t(_pad_rows(o.mem_features.astype(np.float32), cap.max_objs))
    return new, mem


@dataclasses.dataclass
class EvalPipeline:
    mode: str
    cap: EntryCapacity
    # False for TEAT-GT: no union features are pooled
    needs_union: bool = True
    # sgcls and sgdet relabel on the device; False takes the host path
    device_postprocess: bool = True
    # per-frame pair bound of sgdet's grouped union pooling (None:
    # ungrouped, vidsgg's default); the sgdet postprocess doubles the object
    # axis, so 2 * dets_per_frame covers every frame
    union_pairs_per_frame: int | None = None
    device: object = None
    # e.g. torch.bfloat16: vidsgg's serving-precision mode
    compute_dtype: torch.dtype | None = None

    def __post_init__(self):
        # "device" or "host": which route the last call took
        self.last_route = None
        if self.mode not in MODES:
            raise NotImplementedError(f"EvalPipeline: mode {self.mode!r} is not ported")
        self.device = resolve_device(self.device)
        self._cast = None

    def _serving_state(self, state: ServingState) -> ServingState:
        """The state in ``compute_dtype``. The cast copy is kept while the
        state's model and banks are the same objects, so later in-place
        changes to the original parameters do not reach it."""
        if self.compute_dtype is None:
            return state
        src = (state.model, state.rel_memory, state.obj_memory)
        if self._cast is None or any(a is not b for a, b in zip(self._cast[0], src)):
            self._cast = (src, cast_state_for_serving(state, self.compute_dtype))
        return dataclasses.replace(self._cast[1], mem_active=state.mem_active)

    @torch.inference_mode()
    def __call__(self, state: ServingState, entry: Entry, fmaps, gt_entry=None):
        """One video -> evaluator-ready pred dict (NumPy).

        Args:
          state: the serving state (or a train state: its serving view).
          entry: featurized entry (GT boxes for predcls/sgcls; detector
            output for sgdet).
          fmaps: [F, H, W, 1024] base feature maps for union re-pooling
            (unused in predcls and with ``needs_union=False``).
          gt_entry: the GT entry whose predicate lists the pred dict carries
            in the original GT pair order (sgcls, sgdet).
        """
        entry = entry.to(self.device)
        if isinstance(state, TrainState):
            state = state.serving()
        state = self._serving_state(state)
        if self.compute_dtype is not None:
            entry = cast_floating(entry, self.compute_dtype)
        if self.mode == "predcls":
            self.last_route = "device"
            return to_eval_pred(entry, _predcls_stage(state, entry), "predcls")
        if self.needs_union:
            fmaps = torch.as_tensor(fmaps, device=self.device)
            if self.compute_dtype is not None:
                fmaps = fmaps.to(self.compute_dtype)
        if self.device_postprocess:
            if self.mode == "sgcls":
                entry2, out = _sgcls_fused(state, entry, fmaps, self.needs_union)
                overflow = False
            else:
                entry2, out, overflow = _sgdet_fused(state, entry, fmaps,
                                                     self.union_pairs_per_frame,
                                                     self.needs_union)
            if not bool(overflow):
                self.last_route = "device"
                return self._attach_gt(to_eval_pred(entry2, out, self.mode), gt_entry)
        self.last_route = "host"

        # the exact host path (sgdet: rare truncation)
        aux = _classify_stage(state, entry)
        n = int(entry.obj_mask.sum())
        num_frames = int(entry.num_frames)
        dist = _host(aux["distribution"][:n])
        o = ObjectsView(
            boxes=_host(entry.boxes[:n]),
            distribution=dist.copy(),
            features=_host(entry.features[:n]),
            mem_features=_host(aux["object_mem_features"][:n]),
            # sgdet's clean_class reads the detector's labels before OSPU
            # relabeling
            pred_labels=entry.pred_labels[:n].cpu().numpy().astype(np.int64),
            pred_scores=np.zeros(n, np.float32),
            labels=entry.labels[:n].cpu().numpy(),
        )
        if self.mode == "sgcls":
            o, human_idx, im_idx, pairs = sgcls_postprocess(o, num_frames)
        else:
            o, human_idx, im_idx, pairs = sgdet_postprocess(
                o, num_frames, bf16=entry.boxes.dtype == torch.bfloat16)
        eval_cap = EntryCapacity(self.cap.max_frames, self.cap.max_objs,
                                 max(self.cap.max_objs, self.cap.max_pairs))
        entry2, mem = _rebuild_entry(entry, o, human_idx, im_idx, pairs, eval_cap)
        entry2, out = _relation_stage(state, entry2, mem, fmaps, self.needs_union)
        return self._attach_gt(to_eval_pred(entry2, out, self.mode), gt_entry)

    @staticmethod
    def _attach_gt(pred, gt_entry):
        """The GT predicate lists in the original GT pair order (read by the
        temporal-consistency metric)."""
        if gt_entry is None:
            return pred
        pgt = int(gt_entry.pair_mask.sum())
        att = _host(gt_entry.attention_gt)
        sp = _host(gt_entry.spatial_gt)
        con = _host(gt_entry.contacting_gt)
        pred["attention_gt"] = [[int(x)] for x in att[:pgt]]
        pred["spatial_gt"] = [np.where(r > 0)[0].tolist() for r in sp[:pgt]]
        pred["contacting_gt"] = [np.where(r > 0)[0].tolist() for r in con[:pgt]]
        return pred
