"""The serving and training configurations the port is measured at on the card.

``chip_smoke.py`` and ``scripts/profile_torch_sgdet.py`` build them from
here: the default ``tempura_test`` models at full width with seeded random
weights (no checkpoint ships), 16-frame 608x1008 videos made from a seed.

* sgdet: the detector's output layers rescaled to trained-like spreads so
  that proposals and detections fill their slots.
* predcls and sgcls: GT-box videos following ``vidsgg``'s synthetic source
  (``vidsgg/cli/data_source.py:make_synthetic_source``) with the detector's
  base and head in place of its random stand-ins: a stable synthetic
  annotation of 16 frames x (1 person + 3 objects) at AG's 480x270 frame
  size, scaled by ``1000 / 480`` (AG's min-side-600 / max-side-1000 resize
  gives 1000x562, inside the 608x1008 canvas), ``EntryCapacity(16, 64,
  48)`` (the first of ``vidsgg``'s default buckets, which such a video
  fills exactly); sgcls also gets the detector-style class distribution of
  that source (seeded logits, +4 on the GT class, softmax, masked).
* TEAT-GT at its published widths (predcls 12 layers x 32 heads, sgcls and
  sgdet 6 x 16 with tracking; d = 768, FFN 768, Laplacian node ids k = 50)
  through ``EvalPipeline(mode, cap, needs_union=False)``: the GT-box videos
  with the test CLI's synthetic clip caps (``vidsgg/cli/teatgt_test.py:59``),
  sgdet with the caps its Action Genome source gives a 16-frame bucket.
* bfloat16 serving: :func:`bf16_detector` is ``bench.py``'s detector
  (``FasterRCNN(dtype=bfloat16)``, ``bench.py:105-108``) on the same float32
  weights, and ``build_pipeline(..., compute_dtype=torch.bfloat16)`` the
  relation stack of ``tempura_test --bf16`` (``vidsgg/cli/tempura_test.py:132``).
* training: :func:`train_steps_card_vs_cpu`, two float64 predcls or sgcls
  train steps (the second with filled banks) of a one-layer TEMPURA on a
  device and on the CPU with the same recorded noise; sgdet training's
  annotations and capacity (:func:`sgdet_train_annotation`,
  :data:`SGDET_TRAIN_CAP`); TEAT-GT's: the train model of each mode at the
  published widths (:func:`build_teatgt_train`), and
  :func:`teatgt_train_steps_card_vs_cpu`, the CPU's decompositions handed
  to the device's run (:func:`injected_eigh`).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses

import numpy as np
import torch

from vidsgg_torch.cli.data_source import make_synthetic_source
from vidsgg_torch.cli.teatgt_test import SYNTHETIC_CLIPS, ag_clip_caps
from vidsgg_torch.configs.teatgt import TeatGTRunConfig
from vidsgg_torch.data import EntryCapacity, build_gt_entry, synthetic_video_annotation
from vidsgg_torch.debias import MemoryAccumulator, accumulate_memory, finalize_memory
from vidsgg_torch.detector import FasterRCNN, GtFrontend, SgdetCaps, SgdetFrontend
from vidsgg_torch.models import TeatGT, TeatGTConfig, Tempura, TempuraConfig
from vidsgg_torch.models import teatgt
from vidsgg_torch.models.noise import Noise, RecordingNoise
from vidsgg_torch.train import (
    EvalPipeline,
    LossFlags,
    create_serving_state,
    create_train_state,
    eval_step,
    make_train_step,
)
from vidsgg_torch.train.eval_pipeline import cast_floating
from vidsgg_torch.train.state import TEATGT_OBJ_DIM, obj_memory_dim

FRAMES, H, W = 16, 608, 1008
DETS = 16
# spreads of the detector's output layers under random weights, set to what
# a trained detector gives: box deltas about N(0, 0.2) (wider ones decode
# to boxes that all clip to the frame border) and class logits about
# N(0, 3) (flatter ones leave every class under the 0.1 score threshold)
DELTA_STD = 0.2
LOGIT_STD = 3.0

# the GT-box videos of predcls and sgcls
GT_OBJS_PER_FRAME = 3
GT_IMAGE_WH = (480, 270)
GT_IM_SCALE = 1000.0 / 480.0
GT_CAP = EntryCapacity(FRAMES, FRAMES * (1 + GT_OBJS_PER_FRAME), 48)
GT_LABEL_BIAS = 4.0

# sgdet training: SgdetCaps(16, 64) on the serving frames, and an entry
# capacity that admits every video: 16 detections a frame and every SUPPLY
# row (vidsgg's EntryCapacity(16, 256, 48) does not: 256 detection rows
# fill it before any SUPPLY)
SUPPLY_CAP = 64
SGDET_TRAIN_CAP = EntryCapacity(FRAMES, FRAMES * DETS + SUPPLY_CAP, FRAMES * GT_OBJS_PER_FRAME)

# TEAT-GT's clip capacities: the test CLI's for its synthetic source (GT-box
# videos), and for an Action Genome bucket of 16 frames (sgdet)
TEATGT_GT_CLIPS = SYNTHETIC_CLIPS
TEATGT_SGDET_CLIPS = ag_clip_caps(FRAMES)


def make_frames(seed: int, frames: int, h: int, w: int, device) -> torch.Tensor:
    """BGR mean-subtracted-like frames from a seed, made on the device."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((frames, h, w, 3), generator=g, device=device) * 255.0 - 115.0


@torch.no_grad()
def calibrate_random_heads(det: FasterRCNN, frames, hw):
    """Rescale the three output layers of a randomly initialised detector
    so their outputs have the spreads above on ``frames`` (deterministic:
    the weights and frames come from seeds)."""
    def spread(t):
        return float(t.double().std())

    base = det.base_features(frames)
    _, deltas = det.RCNN_rpn(base)
    det.RCNN_rpn.RPN_bbox_pred.weight.mul_(DELTA_STD / spread(deltas))
    det.RCNN_rpn.RPN_bbox_pred.bias.zero_()
    out = det(frames, hw)
    mask = out["roi_mask"]
    det.RCNN_bbox_pred.weight.mul_(DELTA_STD / spread(out["bbox_pred"][mask]))
    logits = det.class_scores(out["roi_features"][mask])
    det.RCNN_cls_score.weight.mul_(LOGIT_STD / spread(logits))


def build_relation(mode: str, device=None) -> Tempura:
    """Full-width TEMPURA for ``mode`` (linear object head, GMM relation
    heads; predcls K=6 without an object classifier, sgcls/sgdet K=4 with
    tracking) from seed 1."""
    cfg = TempuraConfig.for_mode(mode, obj_head="linear", rel_head="gmm")
    return Tempura(cfg, device=device, generator=torch.Generator().manual_seed(1))


def build_teatgt(mode: str, device=None) -> TeatGT:
    """Full-width TEAT-GT for ``mode`` at the clip caps above, from seed 2."""
    caps = TEATGT_SGDET_CLIPS if mode == "sgdet" else TEATGT_GT_CLIPS
    return TeatGT(TeatGTConfig.for_mode(mode, caps=caps), device=device,
                  generator=torch.Generator().manual_seed(2))


# teatgt_train's predcls run with the regularizer and TEAT-GT's ctl losses
TEATGT_TRAIN_ARGS = ["--use_cons_str_loss", "--use_cons_sem_loss", "--use_ctl_loss"]


def build_teatgt_train(device=None, mode: str = "predcls", args=(), **model_kw):
    """TEAT-GT as ``teatgt_train --mode <mode>`` with
    :data:`TEATGT_TRAIN_ARGS` (and ``args``, e.g. ``--rand_node_id``)
    builds it, at the published widths (d = 768, FFN 768, k = 50; predcls
    12 layers x 32 heads, sgcls and sgdet 6 x 16 with the tracking OSPU;
    with a consistency loss on, the regularizer's ``GraphTransformer``s at
    k = 10 and d = 768), with the GT-box videos' clip caps (sgdet: those
    its Action Genome source gives a 16-frame bucket) and ``model_kw``
    (``performer=True``: a model option, no flag), from seed 3: (model, the
    run's loss flags)."""
    run_cfg = TeatGTRunConfig.from_args(["--mode", mode] + TEATGT_TRAIN_ARGS + list(args))
    clips = TEATGT_SGDET_CLIPS if mode == "sgdet" else TEATGT_GT_CLIPS
    cfg = dataclasses.replace(run_cfg.model_config(clips), **model_kw)
    model = TeatGT(cfg, device=device, generator=torch.Generator().manual_seed(3))
    return model, run_cfg.loss_flags()


def build_models(device=None, mode: str = "sgdet"):
    """Full-width FasterRCNN (ResNet-101, RPN 6000/100@0.7) from seed 0 and
    :func:`build_relation`'s TEMPURA. For sgdet the detector's heads are
    calibrated on two seeded frames; predcls and sgcls use only its base
    and head, which the calibration leaves as they are."""
    det = FasterRCNN(device=device, generator=torch.Generator().manual_seed(0))
    rel = build_relation(mode, device)
    if mode == "sgdet":
        calibrate_random_heads(det, make_frames(99, 2, H, W, det.device),
                               (float(H), float(W)))
    return det, rel


def bf16_detector(det: FasterRCNN) -> FasterRCNN:
    """A copy of ``det`` with the same float32 weights whose base and head
    compute in bfloat16 (``bench.py``'s detector)."""
    out = copy.deepcopy(det)
    out.set_compute_dtype(torch.bfloat16)
    return out


def build_pipeline(det: FasterRCNN, rel, mode: str = "sgdet",
                   compute_dtype: torch.dtype | None = None):
    """(frontend, EvalPipeline(mode), ServingState) for TEMPURA or TEAT-GT
    (``needs_union=False``). sgdet: an ``SgdetFrontend`` at
    ``EntryCapacity(16, 256, 48)`` and 32 union pairs per frame; predcls and
    sgcls: a :class:`GtFrontend` at ``GT_CAP``. ``compute_dtype``: the
    relation stack's serving precision (``torch.bfloat16``)."""
    needs_union = not isinstance(rel, TeatGT)
    if mode == "sgdet":
        cap = EntryCapacity(FRAMES, FRAMES * DETS, 48)
        front = SgdetFrontend(det, SgdetCaps(dets_per_frame=DETS), cap, device=det.device)
        pipe = EvalPipeline("sgdet", cap, needs_union=needs_union,
                            union_pairs_per_frame=2 * DETS, device=det.device,
                            compute_dtype=compute_dtype)
    else:
        front = GtFrontend(det)
        pipe = EvalPipeline(mode, GT_CAP, needs_union=needs_union, device=det.device,
                            compute_dtype=compute_dtype)
    return front, pipe, create_serving_state(rel)


def gt_video(seed: int, mode: str, device, cap: EntryCapacity = GT_CAP,
             num_frames: int = FRAMES, objs_per_frame: int = GT_OBJS_PER_FRAME,
             im_scale: float = GT_IM_SCALE):
    """(annotation, GT-box entry skeleton) of one synthetic video: stable
    layout, boxes in 480x270 image scale, ``im_scale`` 1000/480 by default;
    for sgcls also the detector-style class distribution. Host work, made
    before a timed run like a data loader's."""
    ann = synthetic_video_annotation(num_frames=num_frames, objs_per_frame=objs_per_frame,
                                     image_wh=GT_IMAGE_WH, stable=True, seed=seed)
    entry = build_gt_entry(ann, cap, device=device)
    entry = dataclasses.replace(
        entry, im_scale=torch.tensor(im_scale, dtype=torch.float32, device=entry.device))
    if mode == "sgcls":
        rng = np.random.RandomState(seed)
        logits = rng.randn(cap.max_objs, 36).astype(np.float32)
        lbl = entry.labels.cpu().numpy()
        logits[np.arange(cap.max_objs), np.clip(lbl - 1, 0, 35)] += GT_LABEL_BIAS
        dist = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        dist *= entry.obj_mask.cpu().numpy()[:, None]
        entry = dataclasses.replace(entry, distribution=torch.from_numpy(dist).to(entry.device))
    return ann, entry


def sgdet_train_annotation(seed: int, num_frames: int = FRAMES):
    """A synthetic annotation of 1 person + 3 objects a frame over the
    serving frames (608x1008 at image scale 1)."""
    return synthetic_video_annotation(num_frames=num_frames, objs_per_frame=GT_OBJS_PER_FRAME,
                                      image_wh=(W, H), seed=seed)


def _train_two_steps(model, entry, noises) -> dict:
    """Step, ``unc`` fold, bank finalize, step: the metrics of both steps,
    the banks, and every parameter and buffer afterwards."""
    cfg = model.cfg
    state = create_train_state(model, steps_per_epoch=1)
    step = make_train_step(LossFlags(mode=cfg.mode, use_ctl_loss=True,
                                     obj_con_loss=None if cfg.mode == "predcls" else "euc_con"))
    out = {"step 0": step(state, entry, noises[0])}
    acc = MemoryAccumulator.zeros(obj_dim=obj_memory_dim(cfg), dtype=torch.float64,
                                  device=entry.device)
    acc = accumulate_memory(acc, entry, eval_step(state, entry, unc=True),
                            obj_mem=cfg.obj_mem_compute)
    state = state.with_memory(*finalize_memory(acc))
    out["step 1"] = step(state, entry, noises[1])
    out["banks"] = {"rel_memory": state.rel_memory, "obj_memory": state.obj_memory}
    out["state"] = model.state_dict()
    return out


def train_steps_card_vs_cpu(device, seed: int = 0, mode: str = "predcls") -> float:
    """Two float64 train steps of a one-layer TEMPURA (d = 1936) on a
    synthetic video, on ``device`` and on the CPU, the CPU's dropout masks
    and GMM noise replayed on ``device``: predcls, or sgcls with the OSPU
    (one tracking layer, the object memory) and its losses. Returns the
    largest difference of any loss, gradient norm, bank, parameter or
    batch-norm statistic, relative to max(1, max|CPU's|) of its tensor."""
    cap = EntryCapacity(6, 18, 12)   # the synthetic video: 6 frames of 3 boxes
    if mode == "predcls":
        cfg = TempuraConfig(mode="predcls", enc_layers=1, dec_layers=1)
    else:
        cfg = TempuraConfig.for_mode(mode, enc_layers=1, dec_layers=1, track_layers=1,
                                     obj_mem_compute=True)
    model = Tempura(cfg, device="cpu", generator=torch.Generator().manual_seed(seed)).double()
    card_model = copy.deepcopy(model).to(device)
    entry = next(iter(make_synthetic_source(1, cap, seed=seed, shuffle=False, stable=True,
                                            device="cpu")()))[0]
    entry = cast_floating(entry, torch.float64)
    noises = [RecordingNoise(Noise.seeded(seed + i, "cpu")) for i in range(2)]
    want = _train_two_steps(model, entry, noises)
    got = _train_two_steps(card_model, entry.to(device), [n.replay() for n in noises])
    return max(_max_rel_err(got[part], want[part]) for part in want)

@contextlib.contextmanager
def injected_eigh(recorded: list, inject: bool):
    """The CPU run records each decomposition TEAT-GT makes (inputs and
    outputs: the clip graphs, and in training the regularizer's frame
    graphs); the card's run (``inject``) gets them back in order, after
    its adjacency is checked equal to the CPU's: eigenvectors are unique
    only up to sign and the basis of a repeated eigenvalue's eigenspace,
    which LAPACK and cuSOLVER pick differently, and TEAT-GT reads them raw."""
    eig = teatgt.masked_laplacian_eig

    def record(adj, mask):
        val, vec = eig(adj, mask)
        recorded.append((adj.cpu().clone(), mask.cpu().clone(), val.cpu(), vec.cpu()))
        return val, vec

    def replay(adj, mask):
        want_adj, want_mask, val, vec = recorded.pop(0)
        if not (torch.equal(adj.cpu(), want_adj) and torch.equal(mask.cpu(), want_mask)):
            flips = int((adj.cpu() != want_adj).sum())
            raise AssertionError(f"TEAT-GT: {flips} adjacency entries differ between the "
                                 f"card and the CPU")
        return val.to(adj.device), vec.to(adj.device)

    teatgt.masked_laplacian_eig = replay if inject else record
    try:
        yield
    finally:
        teatgt.masked_laplacian_eig = eig


def _teatgt_reference(seed: int, mode: str):
    """A float64 TEAT-GT of ``mode`` with both consistency losses (2 layers
    at the published width: d = 768, FFN 768, k = 50, predcls 32 heads,
    sgcls and sgdet 16 with the tracking OSPU, cut to one of its three
    2376-wide tracking layers) from ``seed`` and a synthetic video (6
    frames of 3 moving boxes in a 480x270 frame, the detector-style class
    distribution) given a 240x135 video size: the spatial threshold (138
    px) keeps some pairs and cuts others, so the frame graphs vary and both
    losses are nonzero."""
    cfg = TeatGTConfig.for_mode(mode, encoder_layers=2, caps=TEATGT_GT_CLIPS,
                                use_cons_str_loss=True, use_cons_sem_loss=True)
    model = TeatGT(cfg, device="cpu", generator=torch.Generator().manual_seed(seed)).double()
    if mode != "predcls":
        del model.object_classifier.encoder_tran.layers[1:]
    entry = next(iter(make_synthetic_source(1, EntryCapacity(6, 18, 12), seed=seed,
                                            shuffle=False, device="cpu")()))[0]
    entry = dataclasses.replace(cast_floating(entry, torch.float64),
                                video_size=torch.tensor([240.0, 135.0], dtype=torch.float64))
    return model, entry


def _max_rel_err(got: dict, want: dict) -> float:
    err = 0.0
    for k, w in want.items():
        g, w = got[k].detach().cpu().double(), w.detach().double()
        err = max(err, float((g - w).abs().max()) / max(1.0, float(w.abs().max())))
    return err


def teatgt_train_steps_card_vs_cpu(device, seed: int = 0,
                                   mode: str = "predcls") -> tuple[float, dict]:
    """Two float64 TEAT-GT train steps of ``mode`` (:func:`_teatgt_reference`;
    the train CLI's losses: the ctl and both consistency losses, and in
    sgcls and sgdet the object loss) on ``device`` and on the CPU, the
    CPU's dropout masks and sign flips replayed and its decompositions
    injected on ``device``. Returns the largest difference of any loss,
    gradient norm, parameter or batch-norm statistic, relative to max(1,
    max|CPU's|) of its tensor, and the CPU's two consistency losses of the
    first step."""
    model, entry = _teatgt_reference(seed, mode)
    flags = TeatGTRunConfig.from_args(["--mode", mode] + TEATGT_TRAIN_ARGS).loss_flags()
    card_model = copy.deepcopy(model).to(device)
    noises = [RecordingNoise(Noise.seeded(seed + i, "cpu")) for i in range(2)]
    recorded = []

    def two_steps(m, e, draws):
        state = create_train_state(m, obj_dim=TEATGT_OBJ_DIM, steps_per_epoch=1)
        step = make_train_step(flags)
        out = {}
        for i, noise in enumerate(draws):
            out.update({f"step {i} {k}": v for k, v in step(state, e, noise).items()})
        return {**out, **m.state_dict()}

    with injected_eigh(recorded, inject=False):
        want = two_steps(model, entry, noises)
    with injected_eigh(recorded, inject=True):
        got = two_steps(card_model, entry.to(device), [n.replay() for n in noises])
    return _max_rel_err(got, want), {
        k: float(want[f"step 0 {k}"]) for k in ("structure_temp_loss", "semantic_temp_loss")}
