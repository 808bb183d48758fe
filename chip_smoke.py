#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``vidsgg_torch``) on one card.

    python3 chip_smoke.py

Drives the port's serving paths, TEMPURA sgdet (the main path, through
the NMS kernel), predcls and sgcls, and TEAT-GT in all three modes,
TEMPURA training in all three modes and TEAT-GT predcls training, at
full width on the CUDA card, scores what they serve with the port's
evaluator, and fails (nonzero exit, no result line) on any fault:

1. device: name, count, ``nvidia-smi`` name and power limit; TF32 off;
2. build: compiles the NMS kernel (``vidsgg_torch/ops/csrc/nms.cu``) with
   nvcc and prints what ``-Xptxas -v`` says;
3. the kernel against its plain PyTorch versions on the card, bit for bit,
   on the real inputs of a served video through its three calls: the RPN
   proposal NMS (16 frames x 6000 presorted boxes, max_keep 100, IoU 0.7),
   the (frame, class) grid [16, 36, 100] at 0.4, ranked inside the kernel
   (K2's contract), and the relation stage's grouped NMS over 512 object
   slots at 0.6 (keep and rank); then on edge cases: tile boundaries
   (N = 31 ... 1025), max_keep inside a tile, IoU at the threshold, tied
   scores, one group per box, a single group, float64, a [3, 4, 130] grid;
   then times the three calls (device time from CUDA graph replays, the
   eager call, the plain version) beside each call's bound;
4. serving: the default ``tempura_test --mode sgdet`` configuration with
   seeded random weights (ResNet-101 + RPN 6000/100, 16 dets per frame,
   TEMPURA d=1936) answers one warm-up and three timed 16x608x1008 videos
   through ``SgdetFrontend`` -> ``EvalPipeline("sgdet")``; every video must
   launch the kernel exactly 3 times, once through each call;
5. predcls and sgcls serving: GT-box videos (a stable synthetic
   annotation, 16 frames x (1 person + 3 objects), AG's 480x270 frames
   scaled by 1000/480 into the 608x1008 canvas) through the same
   ResNet-101 base and head (``GtFrontend``: base, GT ROIAlign, head) ->
   ``EvalPipeline("predcls" | "sgcls")`` with full-width TEMPURA (predcls
   K=6 without tracking, sgcls K=4 with tracking), one warm-up and three
   timed videos each; no NMS kernel launch may happen on these paths;
6. TEAT-GT serving at its published widths (predcls 12 layers x 32
   heads, sgcls and sgdet 6 x 16 with tracking; d = 768, k = 50) through
   ``EvalPipeline(mode, cap, needs_union=False)``: the GT-box videos of 5.
   (clip caps 5 x 32 tokens) and sgdet on the serving frames of 4. (clip
   caps 5 x 40 tokens), one warm-up and three timed videos each; every sgdet
   video launches the kernel 3 times, each call bit-equal to the plain
   version on its own inputs, predcls and sgcls none; per mode the eigh of
   the timed videos' clip graphs (float64 on the card, the path's, and
   float32, each against float64 on the CPU: eigenvalues, cluster
   projectors, ms per call) and sgdet's tokens dropped by the clip caps;
7. scoring: every timed video of every mode through the port's R/mR
   evaluator (``get_ag_evaluators``) against its synthetic annotation
   (sgdet takes the GT modes' annotations as its frames' GT), and predcls
   and sgcls through the temporal-consistency metric; every R@K and mR@K
   must be finite and in [0, 1]. Random weights make these numbers
   meaningless as accuracy: they show that the path runs;
8. reference: small configurations served on the card (sgdet's grouped
   NMS through the kernel's float64 instantiation) and on the CPU (plain
   versions) in float64, in all three modes, must agree on every discrete
   output and give identical evaluator grids; the predcls video (one
   object per frame, so that the temporal metric finds intervals) must
   give at least one interval; a small TEAT-GT likewise in all three modes,
   the CPU's eigendecompositions injected into the card's run after its
   adjacency is checked equal (eigenvectors are unique only up to sign and
   eigenspace basis, which LAPACK and cuSOLVER pick differently);
9. the test CLI (``vidsgg_torch.cli.tempura_test.main``, as a user runs
   it) on an Action Genome-format test split written to a temporary
   directory: annotation pickles and random 480x270 PNG frames (a minimal
   writer here, all five row filters), three 16-frame videos and one of 20
   frames, and the calibrated ResNet-101 detector saved there as a
   jwyang-format checkpoint for ``--model_path``; predcls, sgcls and sgdet
   at full width (``--frame_size 600``, default TEMPURA), each run as a
   one-video warm-up, the three 16-frame videos, the 20-frame video alone
   (the 32-frame bucket), then all four: every video served (no skip),
   exactly 3 NMS launches per sgdet video and none in predcls or sgcls,
   every R@K and mR@K finite and in [0, 1], and in sgdet's run of all
   four videos (buckets 16 and 32) every NMS call's output bit-equal to
   the plain version on the inputs the path gave it; ms per video and
   peak memory per run; then ``vidsgg_torch.cli.teatgt_test`` on the same
   split at full width, all four videos in one run a mode, with the same
   checks; what is live at a predcls video's peak (the allocator's
   history); the RPN conv alone by frame count; and the AG load (PNG
   decode, upload and resize) on its own, its frames on the card equal to
   the CPU's within 1e-4;
10. bfloat16 serving (``serve_bf16_phase``): TEMPURA sgdet on the serving
    frames with ``bench.py``'s bfloat16 detector and with the float32 one
    (what ``tempura_test --bf16`` serves), predcls and sgcls, and TEAT-GT
    sgdet, each with the bfloat16 relation stack, one warm-up and three
    timed videos each: ms per video, peak memory, NMS launches by dtype
    (the RPN and class grid float32, the grouped call bfloat16, every call
    bit-equal to its plain version on its own inputs), agreement with the
    float32 run of the same video, R/mR in [0, 1]; the kernel phase also
    times the bfloat16 grouped call, and the CLI phase runs
    ``tempura_test --bf16`` in sgdet over its split;
11. TEMPURA training at the published widths (1 + 3 layers, joint memory;
    float32): predcls (K = 6) and sgcls (K = 4, 3 tracking layers, the
    ``euc_con`` object loss and the object memory), 2 epochs each over the
    four GT-box videos of 5. through ``run_training`` (``train_phase``: the
    train step, AdamW, the ``unc`` forward and memory fold, the finalize
    and validation each timed between synchronizes; finite losses, moved
    parameters, the memory hallucinators untouched through epoch 0 and
    trained in epoch 1, no NMS launch; two float64 train steps on the card
    equal to the CPU's within 1e-8 with the same noise); sgdet on the
    calibrated detector (``sgdet_train_phase``: four videos of the serving
    frames with synthetic annotations, the train frontend's detect, GT
    assignment, SUPPLY and pack, 2 epochs validated through the test
    frontend; no video skipped, 2 kernel launches per train video and 3 per
    validation video, every call bit-equal to the plain version); then
    ``tempura_train`` as a user runs it in all three modes over AG-format
    trees with train splits, ``--resume`` and ``tempura_test --ckpt``
    (``train_cli_phase``: the checkpoint files against the states bit for
    bit, each mode's directory deleted after);
12. TEAT-GT training at the published widths with both consistency
    losses and the ctl losses (``teatgt_train_phase``), in predcls (12
    layers x 32 heads, d = 768; 2 epochs over the four GT-box videos of
    5.), sgcls (6 x 16 with the tracking OSPU and the object loss; 1 epoch
    over the same videos with their class distributions) and sgdet (1
    epoch over the four videos of sgdet training through the train
    frontend, TEAT-GT's clip caps counting the tokens they drop): the
    regularizer's share of a step (with and without it, and the
    ``vidsgg.consistency`` range in a profile), ``run_training`` (the train
    step, AdamW against its bound, validation, sgdet's detect + plan +
    pack; finite losses, moved parameters, the OSPU's all, NMS launches:
    none in predcls and sgcls, in sgdet 2 per train and 3 per validation
    video, every call bit-equal to the plain version; float64 train steps
    and the regularizer's losses on the card equal to the CPU's within
    1e-8 with the same draws and decompositions), then ``teatgt_train``
    in the mode over an AG-format tree, ``--resume`` and ``teatgt_test
    --ckpt`` (the files against the states bit for bit, sgdet's launches
    counted, the directory deleted after);
13. TokenGT's random node identifiers and the Performer
    (``node_id_phase``): ``teatgt_test --rand_node_id`` and
    ``--orf_node_id`` over an AG-format test split, a small float64
    TEAT-GT of each configuration served on the card against the CPU, and
    one timed train step of each at the published predcls widths;
14. a ``kernels`` JSON line (K1 and K2, launches per main path: TEMPURA's
    and TEAT-GT's sgdet videos, in float32 and in bfloat16, TEMPURA
    predcls and sgcls training's 0, sgdet training's, TEAT-GT predcls and
    sgcls training's 0, TEAT-GT sgdet training's; K1's calls with the
    bfloat16 grouped call), then the result line.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import io
import json
import os
import pickle
import re
import struct
import subprocess
import sys
import tempfile
import time
import warnings
import zlib

import numpy as np
import torch

from vidsgg_torch import constants as C
from vidsgg_torch.data import synthetic_video_annotation
from vidsgg_torch.detector import GtFrontend
from vidsgg_torch.eval import (
    evaluate_temporal_consistency,
    get_ag_evaluators,
    temporal_consistency_summary,
)
from vidsgg_torch.serving_setup import (
    FRAMES,
    GT_IMAGE_WH,
    GT_OBJS_PER_FRAME,
    TEATGT_TRAIN_ARGS,
    H,
    W,
    bf16_detector,
    build_models,
    build_pipeline,
    build_relation,
    build_teatgt,
    build_teatgt_train,
    calibrate_random_heads,
    gt_video,
    injected_eigh,
    make_frames,
)

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12         # float32 outside the tensor cores
IOU_FLOPS = 14                  # min/max x4, 4 add/sub, 2 max, mul, add, sub, div (+ compare)
N_VIDEOS = 3
GT_MODES = ("predcls", "sgcls")
# seeds of the GT-mode videos (warm-up first); their annotations are also
# the GT that sgdet's timed videos are scored against
GT_SEEDS = [200 + i for i in range(N_VIDEOS + 1)]
# the reference phase's two runs: the plain versions, then the card
REFERENCE_DEVICES = ("cpu", "cuda")
# NMS kernel launches of one served video, by call contract: the RPN
# proposal NMS, the (frame, class) grid, the relation stage's grouped NMS
PATH_LAUNCHES = {"presorted": 1, "ranked": 1, "grouped": 1}
TEATGT_MODES = ("predcls", "sgcls", "sgdet")
# eigenvalues of the float64 reference closer than this form one cluster,
# whose projector the card's eigenvectors are held to
EIG_CLUSTER_TOL = 1e-6


def log(msg: str):
    print(msg, flush=True)


def device_phase():
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {name} count={count} torch={torch.__version__} cuda={torch.version.cuda}")
    log(smi)
    log("[device] TF32 off for matmul and cuDNN (float32 end to end)")
    return name, count, smi


def build_phase():
    from vidsgg_torch.ops.nms import NMS_KERNEL

    t0 = time.perf_counter()
    path = NMS_KERNEL.build()
    NMS_KERNEL.lib()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s")
    for line in NMS_KERNEL.build_log.splitlines():
        if "ptxas" in line or "spill" in line:
            log(f"[build] {line.strip()}")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Per-call time of ``fn`` as the host issues it (CUDA events around
    ``iters`` calls): the device time, or the host's, whichever is longer."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Per-call device time of ``fn``: ``reps`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so the host's
    Python and launch overheads drop out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def nms_bound_ms(keep_sorted: torch.Tensor, valid_sorted: torch.Tensor,
                 max_keep: int | None, presorted: bool,
                 group_sorted: torch.Tensor | None = None,
                 item: int = 4) -> tuple[float, str, list]:
    """Least time for the work this call's data needs. Per problem, in rank
    order, only the first L boxes can change the result: L is one past the
    max_keep-th keep (all N without max_keep, or with fewer keeps).
    Bytes: the valid flags (and groups) of those L boxes and the coordinates
    of the valid ones among them (the scores, flags and groups of all N when
    the call must rank them), the N-byte keep mask written once, and with
    groups the int32 rank of all N. Operations: each kept box's IoU with
    every later valid box below L of its own group. ``item``: bytes per
    coordinate and score. Returns (ms, what bounds it, L per problem)."""
    g, n = keep_sorted.shape
    pos = torch.arange(n, device=keep_sorted.device)
    if max_keep:
        hit = keep_sorted & (torch.cumsum(keep_sorted, 1) == max_keep)
        first_len = torch.where(hit, pos + 1, torch.full_like(pos, n)).min(1).values
    else:
        first_len = torch.full((g,), n, device=keep_sorted.device)
    inside = pos < first_len[:, None]
    v = valid_sorted & inside
    if group_sorted is None:
        later_valid = v.sum(1, keepdim=True) - torch.cumsum(v, 1)
    else:
        later = pos[None, :] > pos[:, None]
        same = group_sorted[:, :, None] == group_sorted[:, None, :]
        later_valid = (same & later & v[:, None, :]).sum(2)
    ious = int((later_valid * (keep_sorted & inside)).sum())
    group_bytes = 0 if group_sorted is None else 8
    flags = 1 + group_bytes
    ranked = flags * int(inside.sum()) if presorted else (item + flags) * g * n
    out = g * n + (0 if group_sorted is None else 4 * g * n)
    nbytes = ranked + 4 * item * int(v.sum()) + out
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ious * IOU_FLOPS / H100_FP32_FLOPS * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return bound + (first_len.tolist(),)


def first_keeps(keep: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of each row's first k keeps (rank order), -1 padded."""
    n = keep.shape[1]
    col = torch.arange(n, device=keep.device)
    rank = torch.where(keep, col, torch.full_like(col, n))
    first = torch.sort(rank, dim=1, stable=True).values[:, :k]
    return torch.where(first < n, first, torch.full_like(first, -1))


def mask_err(got: torch.Tensor, want: torch.Tensor, what: str) -> int:
    """Largest |kernel - plain| over a keep mask or a rank (integers);
    raises unless 0."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"NMS kernel differs from the plain version: {what} "
                             f"({tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype})")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if err:
        raise AssertionError(f"NMS kernel differs from the plain version: {what}")
    return err


def grouped_inputs(det, rel, frames0, hw, compute_dtype=None):
    """The grouped NMS's inputs on a served video, through the public
    functions the pipeline calls: frontend -> OSPU classify -> clean_class
    -> (boxes4 [512, 4], scores, group, valid); with ``compute_dtype`` the
    relation stack's serving-precision copy on the entry cast as the
    pipeline casts it."""
    from vidsgg_torch.models.postprocess_device import clean_class_objects, nms_problem
    from vidsgg_torch.train.eval_pipeline import cast_floating, cast_state_for_serving

    front, _, state = build_pipeline(det, rel)
    with torch.inference_mode():
        entry, _ = front(frames0, hw, 1.0, video_size=(float(W), float(H)))
        if compute_dtype is not None:
            state = cast_state_for_serving(state, compute_dtype)
            entry = cast_floating(entry, compute_dtype)
        aux = state.model.classify_objects(entry, obj_memory=state.obj_memory,
                                           mem_active=state.mem_active)
        fields, valid, frame, _ = clean_class_objects(entry, aux["distribution"],
                                                      aux["object_mem_features"])
        boxes4, scores, group = nms_problem(fields, frame)
    return boxes4, scores, group, valid


def edge_cases(dev, grouped):
    """Every edge case bit-equal to the plain version; returns
    (max error over K1's contracts, over K2's)."""
    from vidsgg_torch.ops import nms as tnms

    gen = torch.Generator(device="cpu").manual_seed(5)

    def rand_boxes(g, n, span=300.0):
        xy = torch.rand((g, n, 2), generator=gen) * span
        wh = torch.rand((g, n, 2), generator=gen) * 40 + 2
        return torch.cat([xy, xy + wh], -1).to(dev)

    def rand_valid(g, n):
        return (torch.rand((g, n), generator=gen) > 0.25).to(dev)

    def tied_scores(g, n):
        return (torch.randint(0, 6, (g, n), generator=gen) / 6.0).to(dev)

    err_k1 = err_k2 = 0
    names = []

    def check(name, got, want, k2=False):
        nonlocal err_k1, err_k2
        e = mask_err(got, want, name)
        if k2:
            err_k2 = max(err_k2, e)
        err_k1 = max(err_k1, e)
        names.append(name)

    # tile boundaries: ranked inside the kernel (N <= 1024) or by torch
    # (1025), and presorted with max_keep
    for n in (31, 32, 33, 64, 65, 1024, 1025):
        b, v, s = rand_boxes(4, n), rand_valid(4, n), tied_scores(4, n)
        check(f"ranked n={n}", tnms.nms_mask_batched(b, s, v, 0.5),
              tnms.nms_mask_batched_plain(b, s, v, 0.5), k2=True)
        ones = torch.ones_like(v)
        check(f"presorted max_keep=20 n={n}",
              tnms.nms_mask_batched(b, s, ones, 0.5, max_keep=20, presorted=True),
              tnms.nms_mask_batched_plain(b, s, ones, 0.5, max_keep=20, presorted=True))
    # max_keep reached inside a tile (the 40th keep falls in ranks 32-63)
    b = rand_boxes(6, 300, span=120.0)
    ones = torch.ones((6, 300), dtype=torch.bool, device=dev)
    s = torch.linspace(1, 0, 300, device=dev).expand(6, -1)
    got = tnms.nms_mask_batched(b, s, ones, 0.3, max_keep=40, presorted=True)
    check("max_keep=40 inside a tile", got,
          tnms.nms_mask_batched_plain(b, s, ones, 0.3, max_keep=40, presorted=True))
    if got.sum(1).tolist() != [40] * 6:
        raise AssertionError(f"max_keep=40 marked {got.sum(1).tolist()} keeps")
    # IoU exactly at the threshold: (0,0,9,9) and (0,0,9,5) have IoU 0.6
    b = torch.tensor([[[0.0, 0.0, 9.0, 9.0], [0.0, 0.0, 9.0, 5.0]]], device=dev)
    s = torch.tensor([[0.9, 0.8]], device=dev)
    v = torch.ones((1, 2), dtype=torch.bool, device=dev)
    got = tnms.nms_mask_batched(b, s, v, 0.6)
    check("iou == threshold", got, tnms.nms_mask_batched_plain(b, s, v, 0.6), k2=True)
    if not bool(got.all()):
        raise AssertionError("a box at IoU == threshold was suppressed")
    # tied scores keep index order: 40 identical boxes of one score keep index 3
    b = torch.tensor([0.0, 0.0, 10.0, 10.0], device=dev).expand(1, 40, 4).contiguous()
    s = torch.full((1, 40), 0.5, device=dev)
    v = torch.arange(40, device=dev)[None] >= 3
    got = tnms.nms_mask_batched(b, s, v, 0.5)
    check("tied scores", got, tnms.nms_mask_batched_plain(b, s, v, 0.5), k2=True)
    if got.nonzero()[:, 1].tolist() != [3]:
        raise AssertionError(f"tied scores kept {got.nonzero()[:, 1].tolist()}, want [3]")
    # all-invalid problems and the K2 case: a [3, 4, 130] grid, not presorted
    b = rand_boxes(12, 130, span=60.0).reshape(3, 4, 130, 4)
    s = tied_scores(12, 130).reshape(3, 4, 130)
    v = rand_valid(12, 130).reshape(3, 4, 130)
    v[1, 2] = False
    got = tnms.nms_mask_batched(b, s, v, 0.4)
    check("k2 grid [3, 4, 130]", got, tnms.nms_mask_batched_plain(b, s, v, 0.4), k2=True)
    if got[1, 2].any():
        raise AssertionError("an all-invalid problem kept a box")
    # the grouped call: one group per box, a single group, float64
    gb, gs, gg, gv = grouped
    own = torch.arange(gg.shape[0], device=dev)
    keep, rank = tnms.grouped_nms(gb, gs, own, gv, 0.6)
    want = tnms.grouped_nms_plain(gb, gs, own, gv, 0.6)
    check("grouped, a group per box: keep", keep, want[0])
    check("grouped, a group per box: rank", rank, want[1])
    if not torch.equal(keep, gv):
        raise AssertionError("one group per box did not keep every valid box")
    zero = torch.zeros_like(gg)
    keep, rank = tnms.grouped_nms(gb, gs, zero, gv, 0.6)
    want = tnms.grouped_nms_plain(gb, gs, zero, gv, 0.6)
    check("grouped, one group: keep", keep, want[0])
    check("grouped, one group: rank", rank, want[1])
    order = torch.argsort(rank)
    ungrouped = tnms.nms_sorted_cuda(gb[order][None].contiguous(), gv[order][None], 0.6)[0]
    check("grouped, one group == ungrouped", keep[order], ungrouped)
    b64, s64 = gb.double(), gs.double()
    keep, rank = tnms.grouped_nms(b64, s64, gg, gv, 0.6)
    want = tnms.grouped_nms_plain(b64, s64, gg, gv, 0.6)
    check("grouped float64: keep", keep, want[0])
    check("grouped float64: rank", rank, want[1])
    return err_k1, err_k2, names


def kernel_phase(det, rel, frames0, hw):
    from vidsgg_torch.detector.rpn import decode_topk, generate_anchors
    from vidsgg_torch.detector.sgdet import class_grid
    from vidsgg_torch.ops import nms as tnms

    cfg = det.rpn_cfg
    with torch.inference_mode():
        base = det.base_features(frames0)
        fh, fw = base.shape[2:]
        anchors = torch.from_numpy(generate_anchors(cfg, fh, fw)).to(base.device)
        fg, deltas = det.RCNN_rpn(base)
        top_boxes, top_scores = decode_topk(fg, deltas, anchors, hw, cfg)
        rpn_b = top_boxes.float().contiguous()
        rpn_v = torch.ones(top_scores.shape, dtype=torch.bool, device=rpn_b.device)
        out = det(frames0, hw)
        grid_b, grid_s, grid_v = class_grid(det, out, hw, 1.0)
    grouped = grouped_inputs(det, rel, frames0, hw)
    torch.cuda.synchronize()

    calls = {}
    max_err = 0
    # the RPN call: presorted, max_keep
    k = cfg.post_nms_top_n
    rpn_kw = dict(max_keep=k, presorted=True)
    got = tnms.nms_mask_batched(rpn_b, top_scores, rpn_v, cfg.nms_thresh, **rpn_kw)
    want = tnms.nms_mask_batched_plain(rpn_b, top_scores, rpn_v, cfg.nms_thresh, **rpn_kw)
    fk_got, fk_want = first_keeps(got, k), first_keeps(want, k)
    max_err = max(max_err, mask_err(got, want, "rpn keep mask"),
                  mask_err(fk_got, fk_want, "rpn first keeps"))
    sel = torch.gather(rpn_b, 1, fk_got.clamp(min=0)[..., None].expand(-1, -1, 4))
    sel_want = torch.gather(rpn_b, 1, fk_want.clamp(min=0)[..., None].expand(-1, -1, 4))
    if not torch.equal(sel, sel_want):
        raise AssertionError("selected proposals differ")
    keeps = got.sum(1).tolist()
    log(f"[kernel] rpn {tuple(rpn_b.shape[:2])} presorted max_keep={k}: keep mask and "
        f"proposals bit-equal, keeps/frame min {min(keeps)} max {max(keeps)}")
    calls["rpn"] = dict(
        run=lambda: tnms.nms_mask_batched(rpn_b, top_scores, rpn_v, cfg.nms_thresh, **rpn_kw),
        plain=lambda: tnms.nms_mask_batched_plain(rpn_b, top_scores, rpn_v, cfg.nms_thresh,
                                                  **rpn_kw),
        bound=nms_bound_ms(got, rpn_v, k, True), shape=list(rpn_v.shape))

    # the (frame, class) grid: ranked inside the kernel, validity masks (K2's contract)
    got = tnms.nms_mask_batched(grid_b, grid_s, grid_v, 0.4)
    want = tnms.nms_mask_batched_plain(grid_b, grid_s, grid_v, 0.4)
    grid_err = mask_err(got, want, "class grid")
    log(f"[kernel] class grid {tuple(grid_v.shape)} at 0.4: bit-equal, "
        f"{int(grid_v.sum())} valid, {int(got.sum())} kept")
    n = grid_v.shape[-1]
    order = torch.sort(torch.where(grid_v, grid_s.float(), torch.finfo(torch.float32).min)
                       .reshape(-1, n), dim=1, descending=True, stable=True).indices
    calls["grid"] = dict(
        run=lambda: tnms.nms_mask_batched(grid_b, grid_s, grid_v, 0.4),
        plain=lambda: tnms.nms_mask_batched_plain(grid_b, grid_s, grid_v, 0.4),
        bound=nms_bound_ms(torch.gather(got.reshape(-1, n), 1, order),
                           torch.gather(grid_v.reshape(-1, n), 1, order), None, False),
        shape=list(grid_v.shape))

    # the relation stage's grouped NMS on the same video's 512 slots
    gb, gs, gg, gv = grouped
    keep, rank = tnms.grouped_nms(gb, gs, gg, gv, 0.6)
    want_keep, want_rank = tnms.grouped_nms_plain(gb, gs, gg, gv, 0.6)
    max_err = max(max_err, mask_err(keep, want_keep, "grouped keep"),
                  mask_err(rank, want_rank, "grouped rank"))
    log(f"[kernel] grouped {list(gv.shape)} ({gb.dtype}) at 0.6: keep and rank bit-equal, "
        f"{int(gv.sum())} valid, {int(keep.sum())} kept, {int(torch.unique(gg[gv]).numel())} "
        f"groups")
    order = torch.argsort(rank)
    calls["grouped"] = dict(
        run=lambda: tnms.grouped_nms(gb, gs, gg, gv, 0.6),
        plain=lambda: tnms.grouped_nms_plain(gb, gs, gg, gv, 0.6),
        bound=nms_bound_ms(keep[order][None], gv[order][None], None, False,
                           group_sorted=gg[order][None], item=gb.element_size()),
        shape=list(gv.shape))

    # the bfloat16 route of the grouped call, on the same video served by
    # the bfloat16 detector and the bfloat16 relation stack
    det16 = bf16_detector(det)
    hb, hs, hg, hv = grouped_inputs(det16, rel, frames0, hw, compute_dtype=torch.bfloat16)
    del det16
    keep16, rank16 = tnms.grouped_nms(hb, hs, hg, hv, 0.6)
    want_keep, want_rank = tnms.grouped_nms_plain(hb, hs, hg, hv, 0.6)
    max_err = max(max_err, mask_err(keep16, want_keep, "grouped bfloat16 keep"),
                  mask_err(rank16, want_rank, "grouped bfloat16 rank"))
    log(f"[kernel] grouped {list(hv.shape)} ({hb.dtype}) at 0.6 (bfloat16 0.6015625): keep "
        f"and rank bit-equal, {int(hv.sum())} valid, {int(keep16.sum())} kept")
    order = torch.argsort(rank16)
    calls["grouped_bf16"] = dict(
        run=lambda: tnms.grouped_nms(hb, hs, hg, hv, 0.6),
        plain=lambda: tnms.grouped_nms_plain(hb, hs, hg, hv, 0.6),
        bound=nms_bound_ms(keep16[order][None], hv[order][None], None, False,
                           group_sorted=hg[order][None], item=hb.element_size()),
        shape=list(hv.shape))

    err_k1, err_k2, names = edge_cases(rpn_b.device, grouped)
    log(f"[kernel] edge cases bit-equal: {', '.join(names)}")
    torch.cuda.synchronize()

    # times at the three call shapes
    timings = {}
    for name, c in calls.items():
        ms = graph_ms(c["run"])
        call_ms = cuda_ms(c["run"], iters=20)
        plain_ms = cuda_ms(c["plain"], iters=1, warmup=1)
        bound, bound_by, first_len = c["bound"]
        timings[name] = dict(shape=c["shape"], ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                             bound_ms=bound, bound_by=bound_by)
        log(f"[kernel] time {name} {c['shape']}: kernel {ms:.4f} ms (device, graph replay), "
            f"{call_ms:.4f} ms per eager call, plain {plain_ms:.3f} ms, bound {bound:.6f} ms "
            f"({bound_by}; ranks that matter per problem {min(first_len)}-{max(first_len)})")
    errs = dict(k1=max(max_err, grid_err, err_k1), k2=max(grid_err, err_k2))
    return timings, errs


def check_pred(pred: dict, video_size):
    n = len(pred["pred_labels"])
    p = len(pred["pair_idx"])
    for key, width in (("attention_distribution", 3), ("spatial_distribution", 6),
                       ("contacting_distribution", 17)):
        a = pred[key]
        if a.shape != (p, width) or not np.isfinite(a).all():
            raise AssertionError(f"{key}: shape {a.shape}, finite {np.isfinite(a).all()}")
    boxes = pred["boxes"]
    if boxes.shape != (n, 5) or not np.isfinite(boxes).all():
        raise AssertionError("boxes malformed")
    w, h = video_size
    if (boxes[:, 1:] < 0).any() or (boxes[:, [1, 3]] > w).any() or (boxes[:, [2, 4]] > h).any():
        raise AssertionError("boxes outside the frame")
    if p and (pred["pair_idx"].max() >= n or pred["im_idx"].max() >= FRAMES):
        raise AssertionError("pair indices out of range")
    if not set(np.unique(pred["pred_labels"]).tolist()) <= set(range(1, 37)):
        raise AssertionError("labels out of range")
    return n, p


def serve_phase(det, rel, frames_all, hw):
    from vidsgg_torch.ops.nms import NMS_KERNEL

    front, pipe, state = build_pipeline(det, rel)
    video_size = (float(W), float(H))
    rows, preds = [], []
    for i, frames in enumerate(frames_all):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        NMS_KERNEL.reset_counts()
        t0 = time.perf_counter()
        entry, fmaps = front(frames, hw, 1.0, video_size=video_size)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pred = pipe(state, entry, fmaps)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches, by = NMS_KERNEL.launches, dict(NMS_KERNEL.launches_by)
        n, p = check_pred(pred, video_size)
        tag = "warm-up" if i == 0 else f"video {i}"
        log(f"[serve] {tag}: {1e3 * (t2 - t0):.1f} ms (detect {1e3 * (t1 - t0):.1f}, "
            f"relation {1e3 * (t2 - t1):.1f}), objects {n}, pairs {p}, "
            f"route {pipe.last_route}, nms launches {launches} {by}")
        if launches != 3 or by != PATH_LAUNCHES:
            raise AssertionError(f"{tag}: NMS kernel launches {by}, want {PATH_LAUNCHES}")
        if i > 0:
            rows.append(dict(ms=1e3 * (t2 - t0), detect_ms=1e3 * (t1 - t0),
                             relation_ms=1e3 * (t2 - t1), objects=n, pairs=p,
                             route=pipe.last_route, launches=launches, launches_by=by))
            preds.append(pred)
    peak = torch.cuda.max_memory_allocated()
    log(f"[serve] peak memory allocated {peak} bytes ({peak / 2**30:.2f} GiB)")
    return rows, peak, preds


def serve_gt_phase(det, mode: str):
    """predcls or sgcls serving at full width: one warm-up and N_VIDEOS
    timed GT-box videos through ``GtFrontend`` -> ``EvalPipeline(mode)``.
    The annotation and entry skeleton of a video are made before its timed
    run, as a data loader would; the NMS kernel must not launch."""
    from vidsgg_torch.ops.nms import NMS_KERNEL

    t0 = time.perf_counter()
    rel = build_relation(mode, det.device)
    front, pipe, state = build_pipeline(det, rel, mode)
    torch.cuda.synchronize()
    log(f"[serve {mode}] TEMPURA {rel.cfg} built in {time.perf_counter() - t0:.1f} s")
    video_size = (float(GT_IMAGE_WH[0]), float(GT_IMAGE_WH[1]))
    rows, preds, anns = [], [], []
    for i, seed in enumerate(GT_SEEDS):
        ann, skeleton = gt_video(seed, mode, det.device)
        frames = make_frames(seed, FRAMES, H, W, det.device)
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        NMS_KERNEL.reset_counts()
        t0 = time.perf_counter()
        entry, fmaps = front(frames, skeleton)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pred = pipe(state, entry, fmaps, gt_entry=entry)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = NMS_KERNEL.launches
        n, p = check_pred(pred, video_size)
        tag = "warm-up" if i == 0 else f"video {i}"
        log(f"[serve {mode}] {tag}: {1e3 * (t2 - t0):.1f} ms (featurize "
            f"{1e3 * (t1 - t0):.1f}: base + GT ROIAlign + head; relation "
            f"{1e3 * (t2 - t1):.1f}), objects {n}, pairs {p}, route {pipe.last_route}, "
            f"nms launches {launches}")
        if launches != 0:
            raise AssertionError(f"{mode} {tag}: {launches} NMS kernel launches, want 0")
        if pipe.last_route != "device":
            raise AssertionError(f"{mode} {tag}: took the {pipe.last_route} route")
        if i > 0:
            rows.append(dict(ms=1e3 * (t2 - t0), featurize_ms=1e3 * (t1 - t0),
                             relation_ms=1e3 * (t2 - t1), objects=n, pairs=p,
                             route=pipe.last_route, launches=launches))
            preds.append(pred)
            anns.append(ann)
    peak = torch.cuda.max_memory_allocated()
    log(f"[serve {mode}] peak memory allocated {peak} bytes ({peak / 2**30:.2f} GiB)")
    mean = {k: sum(r[k] for r in rows) / len(rows) for k in ("ms", "featurize_ms", "relation_ms")}
    log(f"[serve {mode}] mean over timed videos: " + json.dumps(mean))
    del front, pipe, state, rel
    torch.cuda.empty_cache()
    return dict(videos=rows, peak_memory_bytes=peak, mean=mean), preds, anns


def grid(mode: str, anns, preds):
    """The (with, semi, no) evaluators of ``mode`` over the videos ->
    {constraint: {"R@K": ..., "mR@K": ...}} and the raw result dicts."""
    out, raw = {}, {}
    for ev in get_ag_evaluators(mode):
        for ann, pred in zip(anns, preds):
            ev.evaluate_scene_graph(ann, pred)
        out[ev.constraint] = {
            **{f"R@{k}": ev.recall_at(k) for k in ev.KS},
            **{f"mR@{k}": ev.mean_recall_at(k) for k in ev.KS},
        }
        raw[ev.constraint] = ev.result_dict
    return out, raw


def temporal(mode: str, preds):
    """The temporal-consistency scores of ``mode`` over the videos."""
    s_all, c_all = [], []
    for pred in preds:
        s, c = evaluate_temporal_consistency(pred, mode)
        s_all.extend(s.tolist())
        c_all.extend(c.tolist())
    return s_all, c_all


def score_phase(mode: str, anns, preds):
    """R/mR (and for predcls and sgcls the temporal summary) of the timed
    videos; every R and mR must be finite and in [0, 1]."""
    t0 = time.perf_counter()
    scores, _ = grid(mode, anns, preds)
    for constraint, vals in scores.items():
        bad = {k: v for k, v in vals.items() if not (np.isfinite(v) and 0.0 <= v <= 1.0)}
        if bad:
            raise AssertionError(f"{mode} {constraint}: values outside [0, 1]: {bad}")
        log(f"[score {mode}] {constraint}: " + " ".join(f"{k} {v:.4f}" for k, v in vals.items()))
    out = dict(grid=scores)
    if mode != "sgdet":
        s, c = temporal(mode, preds)
        out["temporal"] = temporal_consistency_summary(s, c)
        note = ("" if s or c else " (no interval: the metric scans the frame-major pair "
                "list and needs 7 consecutive pairs of one object class; these videos "
                "have 3 objects of distinct classes a frame)")
        log(f"[score {mode}] temporal consistency: {json.dumps(out['temporal'])}{note}")
    log(f"[score {mode}] {len(preds)} videos scored in {time.perf_counter() - t0:.2f} s "
        f"(random weights: the numbers show that the path runs, not accuracy)")
    return out


# the bfloat16 builds (name, detector, mode, relation model): bench.py's
# bfloat16 detector with the bfloat16 relation stack, and the float32
# detector behind it, as tempura_test --bf16 serves
BF16_BUILDS = (
    ("tempura sgdet bf16 detector", "bf16", "sgdet", "tempura"),
    ("tempura sgdet f32 detector", "f32", "sgdet", "tempura"),
    ("tempura predcls", "bf16", "predcls", "tempura"),
    ("tempura sgcls", "bf16", "sgcls", "tempura"),
    ("teatgt sgdet", "bf16", "sgdet", "teatgt"),
)
# NMS kernel launches of one bfloat16 sgdet video, by contract and dtype:
# the RPN and the class grid stay float32, the grouped call is bfloat16
BF16_PATH_LAUNCHES = {"presorted float32": 1, "ranked float32": 1, "grouped bfloat16": 1}


def f32_agreement(a: dict, b: dict) -> dict:
    """A bfloat16 pred dict ``a`` against the float32 one ``b`` of the same
    video: the share of equal ``pred_labels`` (over the shorter list) and,
    where the pair lists agree, the largest |difference| of the three
    distributions."""
    n = min(len(a["pred_labels"]), len(b["pred_labels"]))
    out = dict(objects=[len(a["pred_labels"]), len(b["pred_labels"])],
               pairs=[len(a["pair_idx"]), len(b["pair_idx"])],
               label_share=float(np.mean(a["pred_labels"][:n] == b["pred_labels"][:n]))
               if n else None, max_abs_diff=None)
    if a["pair_idx"].shape == b["pair_idx"].shape and np.array_equal(a["pair_idx"],
                                                                     b["pair_idx"]):
        out["max_abs_diff"] = max(float(np.abs(a[k] - b[k]).max(initial=0.0)) for k in (
            "attention_distribution", "spatial_distribution", "contacting_distribution"))
    return out


def serve_bf16_phase(det, sgdet_frames, f32_preds):
    """bfloat16 serving at full width: each of ``BF16_BUILDS`` answers one
    warm-up and N_VIDEOS timed videos (the frames and GT-box videos of the
    float32 phases); per build ms per video, peak memory, NMS launches by
    dtype (the grouped call in bfloat16, every call of every sgdet video
    bit-equal to its plain version on its own inputs), agreement with the
    float32 run of the same video, and R/mR in [0, 1]."""
    from vidsgg_torch.ops.nms import NMS_KERNEL

    det16 = bf16_detector(det)
    dets = {"bf16": det16, "f32": det}
    runs, scores = {}, {}
    for name, which, mode, model in BF16_BUILDS:
        t0 = time.perf_counter()
        rel = (build_relation if model == "tempura" else build_teatgt)(mode, det.device)
        front, pipe, state = build_pipeline(dets[which], rel, mode,
                                            compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        log(f"[bf16 {name}] {which} detector, bfloat16 relation stack; built in "
            f"{time.perf_counter() - t0:.1f} s")
        sgdet = mode == "sgdet"
        video_size = (float(W), float(H)) if sgdet else (float(GT_IMAGE_WH[0]),
                                                         float(GT_IMAGE_WH[1]))
        want = BF16_PATH_LAUNCHES if sgdet else {}
        rows, preds, anns = [], [], []
        for i, seed in enumerate(GT_SEEDS):
            ann = synthetic_video_annotation(num_frames=FRAMES, objs_per_frame=GT_OBJS_PER_FRAME,
                                             image_wh=GT_IMAGE_WH, stable=True, seed=seed)
            if not sgdet:
                ann, skeleton = gt_video(seed, mode, det.device)
                frames = make_frames(seed, FRAMES, H, W, det.device)
            if i == 1:
                torch.cuda.reset_peak_memory_stats()
            calls = []
            torch.cuda.synchronize()
            NMS_KERNEL.reset_counts()
            with recording_nms_calls(calls) if sgdet else contextlib.nullcontext():
                t0 = time.perf_counter()
                if sgdet:
                    entry, fmaps = front(sgdet_frames[i], (float(H), float(W)), 1.0,
                                         video_size=video_size)
                else:
                    entry, fmaps = front(frames, skeleton)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                pred = pipe(state, entry, fmaps, gt_entry=None if sgdet else entry)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
            by = dict(NMS_KERNEL.launches_by_dtype)
            n, p = check_pred(pred, video_size)
            tag = "warm-up" if i == 0 else f"video {i}"
            if by != want:
                raise AssertionError(f"bf16 {name} {tag}: NMS launches {by}, want {want}")
            if len(calls) != (3 if sgdet else 0):
                raise AssertionError(f"bf16 {name} {tag}: {len(calls)} NMS calls recorded")
            shapes = check_recorded_nms(calls, f"bf16 {name}", tag) if calls else []
            if sgdet and calls[2]["args"][0].dtype != torch.bfloat16:
                raise AssertionError(f"bf16 {name} {tag}: grouped NMS on "
                                     f"{calls[2]['args'][0].dtype}")
            row = dict(ms=1e3 * (t2 - t0), front_ms=1e3 * (t1 - t0),
                       relation_ms=1e3 * (t2 - t1), objects=n, pairs=p, route=pipe.last_route,
                       launches=sum(by.values()), launches_by_dtype=by)
            if i > 0:
                row["vs_float32"] = f32_agreement(pred, f32_preds[(model, mode)][i - 1])
                rows.append(row)
                preds.append(pred)
                anns.append(ann)
            log(f"[bf16 {name}] {tag}: {row['ms']:.1f} ms (front {row['front_ms']:.1f}, "
                f"relation {row['relation_ms']:.1f}), objects {n}, pairs {p}, route "
                f"{pipe.last_route}, nms launches {by}"
                + (f", every NMS call bit-equal to plain {shapes}" if shapes else "")
                + (f", against float32: {json.dumps(row['vs_float32'])}" if i else ""))
        peak = torch.cuda.max_memory_allocated()
        mean = {k: sum(r[k] for r in rows) / len(rows) for k in ("ms", "front_ms", "relation_ms")}
        log(f"[bf16 {name}] peak memory allocated {peak} bytes ({peak / 2**30:.2f} GiB); mean "
            f"over timed videos: {json.dumps(mean)}")
        runs[name] = dict(videos=rows, peak_memory_bytes=peak, mean=mean)
        scores[name] = score_phase(mode, anns, preds)
        del front, pipe, state, rel
        torch.cuda.empty_cache()
    del det16
    torch.cuda.empty_cache()
    return runs, scores



def agree(a: dict, b: dict, what: str) -> float:
    """The card's pred dict ``a`` against the CPU's ``b``: every discrete
    output equal, floats within 1e-5 x max(1, max|b|). Returns the largest
    float difference."""
    for key in ("labels", "im_idx", "pair_idx", "pred_labels"):
        if not np.array_equal(a[key], b[key]):
            raise AssertionError(f"{what}: card and CPU disagree on {key}")
    worst = 0.0
    for key in ("boxes", "pred_scores", "attention_distribution",
                "spatial_distribution", "contacting_distribution"):
        ref = np.abs(b[key]).max() if b[key].size else 0.0
        err = float(np.abs(a[key] - b[key]).max()) if b[key].size else 0.0
        if err > 1e-5 * max(1.0, ref):
            raise AssertionError(f"{what}: card and CPU differ on {key} by {err}")
        worst = max(worst, err)
    if len(b["pair_idx"]) == 0:
        raise AssertionError(f"{what}: reference video produced no pairs")
    return worst


def same_grids(mode: str, ann, a: dict, b: dict):
    """The card's and the CPU's pred dicts give identical evaluator grids."""
    ga, raw_a = grid(mode, [ann], [a])
    gb, raw_b = grid(mode, [ann], [b])
    if raw_a != raw_b or ga != gb:
        raise AssertionError(f"{mode}: card and CPU evaluator grids differ")
    return gb


def reference_gt(mode: str, det):
    """A small float64 GT-box video (8 frames of 160x256, one object a
    frame, stable) served in ``mode`` on the card and on the CPU."""
    from vidsgg_torch.data.entry import EntryCapacity
    from vidsgg_torch.models import Tempura, TempuraConfig
    from vidsgg_torch.ops.nms import NMS_KERNEL
    from vidsgg_torch.detector import GtFrontend
    from vidsgg_torch.train import EvalPipeline, create_serving_state

    f, h, w = 8, 160, 256
    cap = EntryCapacity(f, 2 * f, f)
    frames = make_frames(11, f, h, w, "cpu")
    ann, skeleton = gt_video(31, mode, "cpu", cap=cap, num_frames=f, objs_per_frame=1,
                             im_scale=w / GT_IMAGE_WH[0])
    cfg = TempuraConfig.for_mode(mode, obj_head="linear", rel_head="gmm",
                                 enc_layers=1, dec_layers=1, track_layers=1)
    rel = Tempura(cfg, device="cpu", generator=torch.Generator().manual_seed(8)).double()
    preds = []
    for dev in REFERENCE_DEVICES:
        d = det if dev == "cpu" else copy.deepcopy(det).to(dev)
        r = rel if dev == "cpu" else copy.deepcopy(rel).to(dev)
        entry, fmaps = GtFrontend(d)(frames.to(dev), skeleton.to(dev))
        pipe = EvalPipeline(mode, cap, device=dev)
        NMS_KERNEL.reset_counts()
        preds.append(pipe(create_serving_state(r), entry, fmaps, gt_entry=entry))
        if NMS_KERNEL.launches:
            raise AssertionError(f"{mode} reference: {NMS_KERNEL.launches} NMS launches")
    b, a = preds
    worst = agree(a, b, f"{mode} reference")
    scores = same_grids(mode, ann, a, b)
    (sa, ca), (sb, cb) = (temporal(mode, [x]) for x in (a, b))
    if len(sa) != len(sb) or len(ca) != len(cb):
        raise AssertionError(f"{mode} reference: temporal interval counts differ")
    tworst = float(np.abs(np.array(sa + ca) - np.array(sb + cb)).max(initial=0.0))
    if tworst > 1e-5 * max(1.0, float(np.abs(np.array(sb + cb)).max(initial=0.0))):
        raise AssertionError(f"{mode} reference: temporal scores differ by {tworst}")
    if mode == "predcls" and not sb + cb:
        raise AssertionError("predcls reference: the temporal metric found no interval")
    log(f"[reference] small float64 {mode} video: card == CPU on every discrete output "
        f"({len(b['pred_labels'])} objects, {len(b['pair_idx'])} pairs), identical "
        f"grids (with R@20 {scores['with']['R@20']:.4f}), {len(sb)} + {len(cb)} temporal "
        f"intervals (max difference {tworst:.3e}); max float difference {worst:.3e}")


def reference_phase():
    """Small configurations, float64, served on the card (the kernel) and
    on the CPU (the plain versions) from the same weights in every mode:
    discrete outputs must be equal, floats close, evaluator grids
    identical."""
    from vidsgg_torch.data.entry import EntryCapacity
    from vidsgg_torch.detector import FasterRCNN, RPNConfig, SgdetCaps, SgdetFrontend
    from vidsgg_torch.models import Tempura, TempuraConfig
    from vidsgg_torch.ops.nms import NMS_KERNEL
    from vidsgg_torch.train import EvalPipeline, create_serving_state

    f, h, w, dets = 4, 160, 256, 8
    cap = EntryCapacity(f, f * dets, 48)
    det = FasterRCNN(rpn_cfg=RPNConfig(pre_nms_top_n=600, post_nms_top_n=16),
                     base_blocks=(1, 1, 1), head_blocks=1, device="cpu",
                     generator=torch.Generator().manual_seed(7)).double()
    frames = make_frames(9, f, h, w, "cpu")
    calibrate_random_heads(det, frames, (float(h), float(w)))
    cfg = TempuraConfig.for_mode("sgdet", obj_head="linear", rel_head="gmm",
                                 enc_layers=1, dec_layers=1, track_layers=1)
    rel = Tempura(cfg, device="cpu", generator=torch.Generator().manual_seed(8)).double()
    preds = []
    for dev in REFERENCE_DEVICES:
        d = det if dev == "cpu" else copy.deepcopy(det).to(dev)
        r = rel if dev == "cpu" else copy.deepcopy(rel).to(dev)
        front = SgdetFrontend(d, SgdetCaps(dets_per_frame=dets), cap, device=dev)
        entry, fmaps = front(frames.to(dev), (float(h), float(w)), 1.0,
                             video_size=(float(w), float(h)))
        pipe = EvalPipeline("sgdet", cap, union_pairs_per_frame=2 * dets, device=dev)
        NMS_KERNEL.reset_counts()
        preds.append(pipe(create_serving_state(r), entry, fmaps))
    # the card's run went through the kernel: the float64 grouped call too
    if NMS_KERNEL.launches_by != {"grouped": 1}:
        raise AssertionError(f"reference pipeline NMS launches {NMS_KERNEL.launches_by}")
    b, a = preds
    worst = agree(a, b, "sgdet reference")
    ann = synthetic_video_annotation(num_frames=f, objs_per_frame=GT_OBJS_PER_FRAME,
                                     image_wh=(w, h), seed=10)
    same_grids("sgdet", ann, a, b)
    log(f"[reference] small float64 video: card (kernel, float64 grouped NMS) == CPU "
        f"(plain) on every "
        f"discrete output ({len(b['pred_labels'])} objects, {len(b['pair_idx'])} pairs), "
        f"identical grids; max float difference {worst:.3e}")
    for mode in GT_MODES:
        reference_gt(mode, det)
    for mode in TEATGT_MODES:
        reference_teatgt(mode, det, (frames, (f, h, w, dets)))


@contextlib.contextmanager
def recording_eigh(calls: list):
    """Records each (adjacency, node mask) TEAT-GT decomposes (clones; no
    sync), for the eigh measurements after the timed run."""
    from vidsgg_torch.models import teatgt

    eig = teatgt.masked_laplacian_eig

    def wrapped(adj, mask):
        calls.append((adj.clone(), mask.clone()))
        return eig(adj, mask)

    teatgt.masked_laplacian_eig = wrapped
    try:
        yield calls
    finally:
        teatgt.masked_laplacian_eig = eig


def projector_error(val, vec, val64, vec64, mask) -> tuple[float, float]:
    """(largest |P - P64| over the eigenvalue clusters of each graph's valid
    spectrum, largest |eigenvalue - float64 eigenvalue| there): clusters are
    runs of float64 eigenvalues closer than ``EIG_CLUSTER_TOL``, and P the
    projector onto the columns of a cluster."""
    val, vec, val64, vec64 = (t.double().cpu() for t in (val, vec, val64, vec64))
    proj = eig = 0.0
    for b in range(val64.shape[0]):
        nv = int(mask[b].sum())
        i = 0
        while i < nv:
            j = i + 1
            while j < nv and float(val64[b, j] - val64[b, j - 1]) < EIG_CLUSTER_TOL:
                j += 1
            v, v64 = vec[b][:, i:j], vec64[b][:, i:j]
            proj = max(proj, float((v @ v.T - v64 @ v64.T).abs().max()))
            i = j
        if nv:
            eig = max(eig, float((val[b, :nv] - val64[b, :nv]).abs().max()))
    return proj, eig


def eigh_stats(calls: list) -> dict:
    """Over the recorded clip graphs: the eigendecomposition on the card in
    float64 (the path's) and in float32 (``vidsgg``'s dtype), each against
    float64 on the CPU, and the time of each call on the card."""
    from vidsgg_torch.ops.laplacian import masked_laplacian_eig

    out = dict(graphs=0, shape=None, proj_err_f32=0.0, eig_err_f32=0.0, proj_err_f64=0.0,
               eig_err_f64=0.0, ms_f32=[], ms_f64=[])
    for adj, mask in calls:
        ref = masked_laplacian_eig(adj.double().cpu(), mask.cpu())
        for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
            a = adj.to(dt)
            val, vec = masked_laplacian_eig(a, mask)
            p, e = projector_error(val, vec, *ref, mask.cpu())
            out[f"proj_err_{tag}"] = max(out[f"proj_err_{tag}"], p)
            out[f"eig_err_{tag}"] = max(out[f"eig_err_{tag}"], e)
            out[f"ms_{tag}"].append(cuda_ms(lambda: masked_laplacian_eig(a, mask), iters=5))
        out["graphs"] += adj.shape[0]
        out["shape"] = list(adj.shape)
        out["valid_nodes"] = sorted(set(out.get("valid_nodes", [])) | set(mask.sum(1).tolist()))
    return out


def token_drops(pred: dict, caps) -> tuple[int, int]:
    """(tokens beyond their clip's capacity, tokens) of a served video: a
    frame with pairs holds its person token and one per pair, and a clip
    keeps its first ``tokens_per_clip`` in frame order (``vidsgg``'s
    semantics: a dropped object token leaves its pair with zero logits)."""
    per_frame = np.bincount(pred["im_idx"], minlength=caps.n_clips * caps.clip_size)
    tokens = per_frame + (per_frame > 0)
    per_clip = tokens[: caps.n_clips * caps.clip_size].reshape(caps.n_clips, caps.clip_size).sum(1)
    return int(np.maximum(per_clip - caps.tokens_per_clip, 0).sum()), int(tokens.sum())


def serve_teatgt_phase(det, mode: str, sgdet_frames=None):
    """TEAT-GT at full width in ``mode``: one warm-up and N_VIDEOS timed
    videos, the GT-box videos of ``serve_gt_phase`` (predcls, sgcls) or the
    serving phase's frames (sgdet), through ``EvalPipeline(mode, cap,
    needs_union=False)``. Each sgdet video launches the NMS kernel 3 times,
    every call held bit for bit to the plain version on its own inputs;
    predcls and sgcls none. Then the eigh measurements on the timed videos'
    clip graphs, and sgdet's token drops."""
    from vidsgg_torch.ops.nms import NMS_KERNEL

    t0 = time.perf_counter()
    rel = build_teatgt(mode, det.device)
    front, pipe, state = build_pipeline(det, rel, mode)
    torch.cuda.synchronize()
    caps = rel.cfg.caps
    log(f"[teatgt {mode}] TEAT-GT {rel.cfg.encoder_layers} layers x "
        f"{rel.cfg.encoder_attention_heads} heads, d {rel.cfg.encoder_embed_dim}, k "
        f"{rel.cfg.lap_node_id_k}, tracking {rel.cfg.tracking}, {caps}; built in "
        f"{time.perf_counter() - t0:.1f} s")
    video_size = (float(W), float(H)) if mode == "sgdet" else (float(GT_IMAGE_WH[0]),
                                                               float(GT_IMAGE_WH[1]))
    want = PATH_LAUNCHES if mode == "sgdet" else {}
    rows, preds, anns, eig_calls = [], [], [], []
    for i, seed in enumerate(GT_SEEDS):
        ann = synthetic_video_annotation(num_frames=FRAMES, objs_per_frame=GT_OBJS_PER_FRAME,
                                         image_wh=GT_IMAGE_WH, stable=True, seed=seed)
        if mode != "sgdet":
            ann, skeleton = gt_video(seed, mode, det.device)
            frames = make_frames(seed, FRAMES, H, W, det.device)
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        calls, eigs = [], []
        torch.cuda.synchronize()
        NMS_KERNEL.reset_counts()
        with recording_nms_calls(calls) if mode == "sgdet" else contextlib.nullcontext():
            t0 = time.perf_counter()
            if mode == "sgdet":
                entry, fmaps = front(sgdet_frames[i], (float(H), float(W)), 1.0,
                                     video_size=video_size)
            else:
                entry, fmaps = front(frames, skeleton)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with recording_eigh(eigs):
                pred = pipe(state, entry, fmaps, gt_entry=None if mode == "sgdet" else entry)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        by = dict(NMS_KERNEL.launches_by)
        n, p = check_pred(pred, video_size)
        tag = "warm-up" if i == 0 else f"video {i}"
        if by != want:
            raise AssertionError(f"teatgt {mode} {tag}: NMS launches {by}, want {want}")
        if pipe.last_route != "device":
            raise AssertionError(f"teatgt {mode} {tag}: took the {pipe.last_route} route")
        if len(eigs) != 1:
            raise AssertionError(f"teatgt {mode} {tag}: {len(eigs)} eigendecompositions")
        if len(calls) != (3 if mode == "sgdet" else 0):
            raise AssertionError(f"teatgt {mode} {tag}: {len(calls)} NMS calls recorded")
        shapes = check_recorded_nms(calls, f"teatgt {mode}", tag) if calls else []
        dropped, tokens = token_drops(pred, caps)
        log(f"[teatgt {mode}] {tag}: {1e3 * (t2 - t0):.1f} ms ({'detect' if mode == 'sgdet' else 'featurize'} "
            f"{1e3 * (t1 - t0):.1f}; relation {1e3 * (t2 - t1):.1f}), objects {n}, pairs {p}, "
            f"tokens {tokens}, dropped by the clip caps {dropped}, nms launches {by}"
            + (f", every NMS call bit-equal to plain {shapes}" if shapes else ""))
        if i > 0:
            rows.append(dict(ms=1e3 * (t2 - t0), front_ms=1e3 * (t1 - t0),
                             relation_ms=1e3 * (t2 - t1), objects=n, pairs=p, tokens=tokens,
                             dropped_tokens=dropped, launches=sum(by.values()),
                             launches_by=by))
            preds.append(pred)
            anns.append(ann)
            eig_calls.extend(eigs)
    peak = torch.cuda.max_memory_allocated()
    mean = {k: sum(r[k] for r in rows) / len(rows) for k in ("ms", "front_ms", "relation_ms")}
    eig = eigh_stats(eig_calls)
    log(f"[teatgt {mode}] peak memory allocated {peak} bytes ({peak / 2**30:.2f} GiB); mean "
        f"over timed videos: {json.dumps(mean)}")
    log(f"[teatgt {mode}] eigh on {eig['graphs']} clip graphs {eig['shape']} (valid nodes "
        f"{eig['valid_nodes']}): float64 on the card (the path's) {min(eig['ms_f64']):.3f}-"
        f"{max(eig['ms_f64']):.3f} ms per call, projector error {eig['proj_err_f64']:.3e}, "
        f"eigenvalue error {eig['eig_err_f64']:.3e}; float32 on the card "
        f"{min(eig['ms_f32']):.3f}-{max(eig['ms_f32']):.3f} ms, projector error "
        f"{eig['proj_err_f32']:.3e}, eigenvalue error {eig['eig_err_f32']:.3e} (both "
        f"against float64 on the CPU)")
    del front, pipe, state, rel
    torch.cuda.empty_cache()
    return dict(videos=rows, peak_memory_bytes=peak, mean=mean, eigh=eig), preds, anns


def reference_teatgt(mode: str, det, sgdet_video=None, **model_kw):
    """A small float64 TEAT-GT (d 32, 2 layers, 4 heads; the OSPU at full
    width; ``model_kw``: random node identifiers or the Performer, whose
    test-time draws are the same on both devices) served in ``mode`` on the
    CPU (plain versions) and on the card, the CPU's eigendecompositions
    injected into the card's run: every discrete output equal, identical
    grids. GT modes: an 8-frame GT-box video of 3 objects a frame; sgdet:
    the reference phase's video."""
    from vidsgg_torch.data.entry import EntryCapacity
    from vidsgg_torch.detector import GtFrontend, SgdetCaps, SgdetFrontend
    from vidsgg_torch.models import TeatGT, TeatGTConfig
    from vidsgg_torch.models.graph_build import ClipCaps
    from vidsgg_torch.train import EvalPipeline, create_serving_state

    cfg = TeatGTConfig.for_mode(mode, encoder_layers=2, encoder_attention_heads=4,
                                encoder_embed_dim=32, encoder_ffn_embed_dim=48,
                                caps=ClipCaps(5, 2, 24, 96, 8), **model_kw)
    rel = TeatGT(cfg, device="cpu", generator=torch.Generator().manual_seed(9)).double()
    if mode == "sgdet":
        frames, (f, h, w, dets) = sgdet_video
        cap = EntryCapacity(f, f * dets, 48)
        ann = synthetic_video_annotation(num_frames=f, objs_per_frame=GT_OBJS_PER_FRAME,
                                         image_wh=(w, h), seed=10)
    else:
        f, h, w = 8, 160, 256
        cap = EntryCapacity(f, 4 * f, 3 * f)
        frames = make_frames(12, f, h, w, "cpu")
        ann, skeleton = gt_video(32, mode, "cpu", cap=cap, num_frames=f,
                                 im_scale=w / GT_IMAGE_WH[0])
    preds, recorded = [], []
    for dev in REFERENCE_DEVICES:
        d = det if dev == "cpu" else copy.deepcopy(det).to(dev)
        r = rel if dev == "cpu" else copy.deepcopy(rel).to(dev)
        pipe = EvalPipeline(mode, cap, needs_union=False, device=dev)
        with injected_eigh(recorded, inject=bool(preds)), torch.inference_mode():
            if mode == "sgdet":
                entry, fmaps = SgdetFrontend(d, SgdetCaps(dets_per_frame=dets), cap, device=dev)(
                    frames.to(dev), (float(h), float(w)), 1.0, video_size=(float(w), float(h)))
                preds.append(pipe(create_serving_state(r), entry, fmaps))
            else:
                entry, fmaps = GtFrontend(d)(frames.to(dev), skeleton.to(dev))
                preds.append(pipe(create_serving_state(r), entry, fmaps, gt_entry=entry))
    if recorded:
        raise AssertionError(f"TEAT-GT {mode} reference: {len(recorded)} decompositions unused")
    b, a = preds
    worst = agree(a, b, f"teatgt {mode} {model_kw} reference")
    scores = same_grids(mode, ann, a, b)
    log(f"[reference] small float64 TEAT-GT {mode} {model_kw} video, the CPU's eigenvectors "
        f"in the card's run: card == CPU on every discrete output ({len(b['pred_labels'])} "
        f"objects, {len(b['pair_idx'])} pairs), identical grids (with R@20 "
        f"{scores['with']['R@20']:.4f}); max float difference {worst:.3e}")
    return worst


# the CLI phase: an Action Genome-format test split on disk, served through
# ``vidsgg_torch.cli.tempura_test.main`` in every mode
AG_WH = (480, 270)              # AG's frame size: min side 600 gives 1067 x 600
CLI_FRAME_SIZE = 600
CLI_VIDEOS = 3                  # 16-frame videos (the first size bucket)
CLI_LONG = 20                   # one more video, for the 32-frame bucket
CLI_SEEDS = [300 + i for i in range(CLI_VIDEOS + 1)]
# GT-box modes keep the default buckets (16/32/64 frames at 4 boxes a
# frame); sgdet's entries hold 16 detections a frame, so a 32-frame bucket
# video needs 512 object slots: the 128-frame ladder's capacity
CLI_FLAGS = {"predcls": [], "sgcls": [], "sgdet": ["--bucket_frames", "128"]}
# the AG load's frames on the card against the CPU's (float32 values in
# [-123, 152]: a few ulps)
AG_LOAD_ATOL = 1e-4
# frame counts of the RPN conv timed alone (the sgdet frame buckets)
RPN_CONV_FRAMES = (8, 16, 32)


def png_bytes(bgr: np.ndarray) -> bytes:
    """A minimal PNG writer: 8-bit RGB, zlib, row y filtered with type
    y % 5 (None, Sub, Up, Avg, Paeth), so a frame uses all five filters."""
    h, w, _ = bgr.shape
    raw = np.ascontiguousarray(bgr[:, :, ::-1]).reshape(h, w * 3).astype(np.int32)
    left = np.zeros_like(raw)
    left[:, 3:] = raw[:, :-3]
    up = np.zeros_like(raw)
    up[1:] = raw[:-1]
    upleft = np.zeros_like(raw)
    upleft[1:, 3:] = raw[:-1, :-3]
    pa, pb, pc = np.abs(up - upleft), np.abs(left - upleft), np.abs(left + up - 2 * upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = np.stack([np.zeros_like(raw), left, up, (left + up) // 2, paeth])
    kind = np.arange(h) % 5
    filtered = ((raw - preds[kind, np.arange(h)]) % 256).astype(np.uint8)
    scanlines = np.concatenate([kind.astype(np.uint8)[:, None], filtered], axis=1)

    def chunk(tag: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(scanlines.tobytes(), 1)) + chunk(b"IEND", b""))


def write_ag_split(root: str, videos: list):
    """An Action Genome-format tree: annotation pickles in AG's schema
    (person boxes xyxy, object boxes xywh, class and predicate names) from
    stable synthetic annotations of 1 person + 3 objects a frame, and
    random 480x270 PNG frames; ``videos`` lists (seed, frames) per video,
    or (seed, frames, split) where the split is not "test", in dataset
    order."""
    os.makedirs(os.path.join(root, "annotations"))
    person, objects = {}, {}
    for v, (seed, frames, *split) in enumerate(videos):
        split = split[0] if split else "test"
        ann = synthetic_video_annotation(num_frames=frames, objs_per_frame=GT_OBJS_PER_FRAME,
                                         image_wh=AG_WH, stable=True, seed=seed)
        rng = np.random.RandomState(seed)
        os.makedirs(os.path.join(root, "frames", f"{v}.mp4"))
        for f, frame in enumerate(ann):
            key = f"{v}.mp4/{f:06d}.png"
            person[key] = {"bbox": frame[0]["person_bbox"], "bbox_size": AG_WH}
            objects[key] = [{
                "class": C.AG_OBJECT_CLASSES[o["class"]],
                "bbox": [float(o["bbox"][0]), float(o["bbox"][1]),
                         float(o["bbox"][2] - o["bbox"][0]), float(o["bbox"][3] - o["bbox"][1])],
                "attention_relationship": [C.AG_ATTENTION_RELATIONSHIPS[i]
                                           for i in o["attention_relationship"]],
                "spatial_relationship": [C.AG_SPATIAL_RELATIONSHIPS[i]
                                         for i in o["spatial_relationship"]],
                "contacting_relationship": [C.AG_CONTACTING_RELATIONSHIPS[i]
                                            for i in o["contacting_relationship"]],
                "visible": True,
                "metadata": {"set": split},
            } for o in frame[1:]]
            img = rng.randint(0, 256, (AG_WH[1], AG_WH[0], 3), dtype=np.uint8)
            with open(os.path.join(root, "frames", key), "wb") as fh:
                fh.write(png_bytes(img))
    for name, obj in (("person_bbox.pkl", person),
                      ("object_bbox_and_relationship.pkl", objects)):
        with open(os.path.join(root, "annotations", name), "wb") as fh:
            pickle.dump(obj, fh)


def run_cli(argv: list, cli: str = "tempura_test") -> tuple:
    """``vidsgg_torch.cli.<cli>.main(argv)`` with its output kept:
    (evaluators, stdout, videos evaluated, seconds of its evaluation loop)."""
    import importlib

    module = importlib.import_module(f"vidsgg_torch.cli.{cli}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        evs = module.main(list(argv))
    text = out.getvalue()
    found = re.search(r"^evaluated (\d+) videos in ([0-9.]+)s$", text, re.M)
    if found is None:
        raise AssertionError(f"{cli} printed no 'evaluated' line")
    if "skipped" in text:
        raise AssertionError(f"{cli} skipped a video: " + text[-500:])
    return evs, text, int(found.group(1)), float(found.group(2))


@contextlib.contextmanager
def recording_nms_calls(calls: list):
    """Records, at the three sites where the sgdet path calls an NMS
    wrapper (the RPN proposals, the class grid, the grouped NMS), each
    call's inputs and output. The wrapper itself still runs and counts its
    launch."""
    from vidsgg_torch.detector import rpn, sgdet
    from vidsgg_torch.models import postprocess_device
    from vidsgg_torch.ops import nms as tnms

    # (module, name it calls, call, plain version)
    sites = ((rpn, "nms_mask_batched", "rpn", tnms.nms_mask_batched_plain),
             (sgdet, "batched_class_nms", "grid", tnms.nms_mask_batched_plain),
             (postprocess_device, "grouped_nms", "grouped", tnms.grouped_nms_plain))

    def clone(x):
        return x.clone() if torch.is_tensor(x) else x

    def recorder(fn, call, plain):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            calls.append(dict(call=call, plain=plain, args=[clone(a) for a in args], kw=kw,
                              out=[clone(o) for o in (out if isinstance(out, tuple) else (out,))]))
            return out
        return wrapped

    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _, _ in sites]
    try:
        for mod, attr, call, plain in sites:
            setattr(mod, attr, recorder(getattr(mod, attr), call, plain))
        yield calls
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def check_recorded_nms(calls: list, mode: str, run: str) -> list:
    """Every recorded call's output bit-equal to its plain version on the
    same inputs; returns (call, problem shape) per call."""
    shapes = []
    for i, c in enumerate(calls):
        want = c["plain"](*c["args"], **c["kw"])
        want = want if isinstance(want, tuple) else (want,)
        for j, (got, w) in enumerate(zip(c["out"], want, strict=True)):
            mask_err(got, w, f"{mode} {run}: call {i} ({c['call']}) output {j}")
        shapes.append((c["call"], list(c["args"][0].shape[:-1])))
    return shapes


def peak_attribution(snapshot: dict, base: int, device: int, top: int = 8) -> dict:
    """From a memory-history snapshot (``torch.cuda.memory._snapshot``):
    the bytes live at the run's peak, grouped by the innermost
    ``vidsgg_torch`` frame that allocated them (a workspace that a library
    call takes counts at the line that called it; ``base``: the bytes
    allocated before the history started)."""
    events = snapshot["device_traces"][device]
    freed = ("free_completed", "free")
    total = best = 0
    best_i = -1
    for i, e in enumerate(events):
        if e["action"] == "alloc":
            total += e["size"]
        elif e["action"] in freed:
            total -= e["size"]
        if total > best:
            best, best_i = total, i
    live = {}
    for e in events[:best_i + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
        elif e["action"] in freed:
            live.pop(e["addr"], None)
    by_site = {}
    for e in live.values():
        site = next((f"{f['filename'][f['filename'].rfind('vidsgg_torch'):]}:{f['line']} "
                     f"({f['name']})" for f in e.get("frames", [])
                     if "vidsgg_torch" in f["filename"]), "outside vidsgg_torch")
        nbytes, blocks, largest = by_site.get(site, (0, 0, 0))
        by_site[site] = (nbytes + e["size"], blocks + 1, max(largest, e["size"]))
    # (site, bytes, blocks, largest block)
    sites = sorted(((k,) + v for k, v in by_site.items()), key=lambda r: -r[1])
    return dict(peak_bytes=base + best, before_run_bytes=base,
                live_at_peak_bytes=sum(v[0] for v in by_site.values()), sites=sites[:top])


def live_cuda_tensors(top: int = 6) -> dict:
    """What Python still reaches on the card (the tensors ``gc`` finds,
    parameters included, each storage once), largest (shape, dtype) first,
    beside ``torch.cuda.memory_allocated()``."""
    storages, by = {}, {}
    with warnings.catch_warnings():    # deprecated objects warn when inspected
        warnings.simplefilter("ignore")
        tensors = [o for o in gc.get_objects() if isinstance(o, torch.Tensor) and o.is_cuda]
    for o in tensors:
        st = o.untyped_storage()
        if st.data_ptr() not in storages:
            storages[st.data_ptr()] = st.nbytes()
            key = f"{list(o.shape)} {o.dtype}"
            by[key] = by.get(key, 0) + st.nbytes()
    return dict(allocated_bytes=torch.cuda.memory_allocated(),
                reachable_bytes=sum(storages.values()),
                largest=sorted(by.items(), key=lambda kv: -kv[1])[:top])


def rpn_conv_by_frames(det) -> list:
    """The RPN's 3x3 1024->512 conv alone on the CLI's sgdet feature maps
    (the 608x1152 canvas at stride 16: 38 x 72) by frame count: device ms
    per call (CUDA events over 5 calls after 2) and the peak allocated
    beyond the input (cuDNN's workspace)."""
    conv = det.RCNN_rpn.RPN_Conv
    gen = torch.Generator(device=det.device).manual_seed(1)
    rows = []
    for frames in RPN_CONV_FRAMES:
        x = torch.randn((frames, 1024, 38, 72), generator=gen, device=det.device)
        with torch.inference_mode():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            ms = cuda_ms(lambda: conv(x), iters=5)
            peak = torch.cuda.max_memory_allocated() - before
        rows.append(dict(frames=frames, ms=ms, ms_per_frame=ms / frames, peak_beyond_input=peak))
        log(f"[cli] RPN conv alone, {frames} x 1024 x 38 x 72: {ms:.3f} ms "
            f"({ms / frames:.3f} ms per frame), peak beyond the input {peak} bytes "
            f"({peak / 2**30:.2f} GiB)")
        del x
        torch.cuda.empty_cache()
    return rows


def cli_phase(det):
    """The test CLI at full width on AG-format splits in a temporary
    directory (and the calibrated detector saved there as a jwyang-format
    checkpoint, which ``--model_path`` loads): per mode a one-video
    warm-up, the three 16-frame videos (the first bucket), the 20-frame
    video alone (the 32-frame bucket, its own split), then all four in one
    run (the pipeline switching buckets), with the NMS launches, skips,
    R/mR range and peak memory of each run checked; in sgdet's last run
    every NMS call's output is held bit for bit against the plain version
    on the inputs the path gave it. Then one predcls video under the
    allocator's history (what is live at its peak), the RPN conv by frame
    count, and the AG load (PNG decode, upload, resize) on its own, its
    frames on the card against the CPU's."""
    from vidsgg_torch.data.action_genome import ActionGenome, prep_frames
    from vidsgg_torch.ops.nms import NMS_KERNEL

    results = {"held_before": live_cuda_tensors()}
    log(f"[cli] before the CLI runs: {results['held_before']}")
    with tempfile.TemporaryDirectory(prefix="ag_split_") as tmp:
        t0 = time.perf_counter()
        short = [(seed, FRAMES) for seed in CLI_SEEDS[:CLI_VIDEOS]]
        long = [(CLI_SEEDS[CLI_VIDEOS], CLI_LONG)]
        splits = {"all": os.path.join(tmp, "ag"), "long": os.path.join(tmp, "ag_long")}
        write_ag_split(splits["all"], short + long)
        write_ag_split(splits["long"], long)
        ckpt = os.path.join(tmp, "faster_rcnn_ag.pth")
        torch.save({"model": det.state_dict()}, ckpt)
        log(f"[cli] AG splits ({[f for _, f in short + long]} frames of {AG_WH[0]}x{AG_WH[1]}, "
            f"PNG with all five row filters; the last video alone in a second split) and the "
            f"detector checkpoint written in {time.perf_counter() - t0:.1f} s")

        def argv(mode, split, n):
            return (["--mode", mode, "--data_path", splits[split], "--model_path", ckpt,
                     "--frame_size", str(CLI_FRAME_SIZE), "--max_videos", str(n),
                     "--output_path", os.path.join(tmp, "out", mode)] + CLI_FLAGS[mode])

        # (run, split, videos)
        plan = (("warm-up", "all", 1), ("bucket 16", "all", CLI_VIDEOS),
                ("bucket 32", "long", 1), ("all", "all", CLI_VIDEOS + 1))
        for mode in ("predcls", "sgcls", "sgdet"):
            want = PATH_LAUNCHES if mode == "sgdet" else {}
            runs = {}
            for name, split, n in plan:
                calls = []
                record = mode == "sgdet" and name == "all"
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                NMS_KERNEL.reset_counts()
                with recording_nms_calls(calls) if record else contextlib.nullcontext():
                    evs, text, served, seconds = run_cli(argv(mode, split, n))
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated()
                by = dict(NMS_KERNEL.launches_by)
                if served != n:
                    raise AssertionError(f"{mode} {name}: evaluated {served} videos, want {n}")
                if by != {k: v * n for k, v in want.items()}:
                    raise AssertionError(f"{mode} {name}: NMS launches {by} for {n} videos, "
                                         f"want {want} each")
                grid_vals = {f"{ev.constraint} {m}@{k}": f(k) for ev in evs for k in ev.KS
                             for m, f in (("R", ev.recall_at), ("mR", ev.mean_recall_at))}
                bad = {k: v for k, v in grid_vals.items() if not (np.isfinite(v) and 0 <= v <= 1)}
                if bad:
                    raise AssertionError(f"{mode} {name}: R/mR outside [0, 1]: {bad}")
                runs[name] = dict(videos=n, seconds=seconds, ms_per_video=1e3 * seconds / n,
                                  peak_memory_bytes=peak, before_run_bytes=before,
                                  own_peak_bytes=peak - before, nms_launches=by,
                                  r20={ev.constraint: ev.recall_at(20) for ev in evs})
                log(f"[cli {mode}] {name}: {n} videos in {seconds:.3f} s "
                    f"({1e3 * seconds / n:.1f} ms per video), peak {peak} bytes "
                    f"({peak / 2**30:.2f} GiB; {before} bytes allocated before the run, "
                    f"{(peak - before) / 2**30:.2f} GiB its own), nms launches {by}")
                if record:
                    if len(calls) != 3 * n:
                        raise AssertionError(f"{mode} {name}: recorded {len(calls)} NMS calls")
                    shapes = check_recorded_nms(calls, mode, name)
                    runs[name]["nms_calls_bit_equal"] = shapes
                    log(f"[cli {mode}] {name}: every NMS call of the run bit-equal to the plain "
                        f"version on its own inputs (call, problem shape): {shapes}")
                    del calls
            for line in text.splitlines():
                if re.match(r"^(-{9}|R@|mR@|Temporal)", line):
                    log(f"[cli {mode}] {line}")
            results[mode] = runs

        # tempura_test --bf16 in sgdet on the same split, all four videos:
        # the relation stack in bfloat16 behind the float32 detector, the
        # grouped NMS through the kernel's bfloat16 route
        n = CLI_VIDEOS + 1
        calls = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        NMS_KERNEL.reset_counts()
        with recording_nms_calls(calls):
            evs, text, served, seconds = run_cli(argv("sgdet", "all", n) + ["--bf16"])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        by = dict(NMS_KERNEL.launches_by_dtype)
        if served != n:
            raise AssertionError(f"sgdet --bf16: evaluated {served} videos, want {n}")
        if by != {k: v * n for k, v in BF16_PATH_LAUNCHES.items()}:
            raise AssertionError(f"sgdet --bf16: NMS launches {by} for {n} videos")
        bad = {f"{ev.constraint} {m}@{k}": f(k) for ev in evs for k in ev.KS
               for m, f in (("R", ev.recall_at), ("mR", ev.mean_recall_at))
               if not (np.isfinite(f(k)) and 0 <= f(k) <= 1)}
        if bad:
            raise AssertionError(f"sgdet --bf16: R/mR outside [0, 1]: {bad}")
        grouped = [c for c in calls if c["call"] == "grouped"]
        if len(calls) != 3 * n or any(c["args"][0].dtype != torch.bfloat16 for c in grouped):
            raise AssertionError(f"sgdet --bf16: recorded {len(calls)} NMS calls, grouped "
                                 f"dtypes {[c['args'][0].dtype for c in grouped]}")
        shapes = check_recorded_nms(calls, "sgdet --bf16", "all")
        del calls
        results["sgdet --bf16"] = dict(
            videos=n, seconds=seconds, ms_per_video=1e3 * seconds / n,
            peak_memory_bytes=peak, own_peak_bytes=peak - before, nms_launches=by,
            nms_calls_bit_equal=shapes, r20={ev.constraint: ev.recall_at(20) for ev in evs})
        log(f"[cli sgdet --bf16] all: {n} videos in {seconds:.3f} s "
            f"({1e3 * seconds / n:.1f} ms per video), own peak {peak - before} bytes "
            f"({(peak - before) / 2**30:.2f} GiB), nms launches {by}, every NMS call "
            f"bit-equal to the plain version on its own inputs")
        for line in text.splitlines():
            if re.match(r"^(R@20|mR@20)", line):
                log(f"[cli sgdet --bf16] {line}")

        # teatgt_test on the same split: all four videos in one run a mode
        for mode in ("predcls", "sgcls", "sgdet"):
            want = PATH_LAUNCHES if mode == "sgdet" else {}
            n = CLI_VIDEOS + 1
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            NMS_KERNEL.reset_counts()
            evs, text, served, seconds = run_cli(argv(mode, "all", n), cli="teatgt_test")
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            by = dict(NMS_KERNEL.launches_by)
            if served != n:
                raise AssertionError(f"teatgt_test {mode}: evaluated {served} videos, want {n}")
            if by != {k: v * n for k, v in want.items()}:
                raise AssertionError(f"teatgt_test {mode}: NMS launches {by} for {n} videos, "
                                     f"want {want} each")
            bad = {f"{ev.constraint} {m}@{k}": f(k) for ev in evs for k in ev.KS
                   for m, f in (("R", ev.recall_at), ("mR", ev.mean_recall_at))
                   if not (np.isfinite(f(k)) and 0 <= f(k) <= 1)}
            if bad:
                raise AssertionError(f"teatgt_test {mode}: R/mR outside [0, 1]: {bad}")
            results[f"teatgt {mode}"] = dict(
                videos=n, seconds=seconds, ms_per_video=1e3 * seconds / n,
                peak_memory_bytes=peak, own_peak_bytes=peak - before, nms_launches=by,
                r20={ev.constraint: ev.recall_at(20) for ev in evs})
            log(f"[cli teatgt {mode}] all: {n} videos in {seconds:.3f} s "
                f"({1e3 * seconds / n:.1f} ms per video), own peak {peak - before} bytes "
                f"({(peak - before) / 2**30:.2f} GiB), nms launches {by}")
            for line in text.splitlines():
                if re.match(r"^(R@20|mR@20|Temporal)", line):
                    log(f"[cli teatgt {mode}] {line}")

        # what is live at a predcls CLI video's peak, by allocation site
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        torch.cuda.memory._record_memory_history(context="alloc", stacks="python",
                                                 max_entries=1_000_000)
        try:
            run_cli(argv("predcls", "all", 1))
            torch.cuda.synchronize()
            snapshot = torch.cuda.memory._snapshot()
        finally:
            torch.cuda.memory._record_memory_history(enabled=None)
        attribution = peak_attribution(snapshot, before, torch.cuda.current_device())
        attribution["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        del snapshot
        log(f"[cli predcls] peak of one video under the allocator history: "
            f"{attribution['peak_bytes']} bytes by replay, {attribution['max_memory_allocated']} "
            f"by max_memory_allocated, {before} allocated before the run; live at the peak:")
        for site, nbytes, blocks, largest in attribution["sites"]:
            log(f"[cli predcls]   {nbytes:>12} bytes ({nbytes / 2**30:.2f} GiB) in {blocks} "
                f"blocks, the largest {largest} bytes: {site}")
        results["predcls_peak_attribution"] = attribution
        results["rpn_conv_by_frames"] = rpn_conv_by_frames(det)

        # the AG load on its own: PNG decode on the host, then upload + resize
        ds = ActionGenome("test", "large", splits["all"], target_min_side=CLI_FRAME_SIZE)
        scale = CLI_FRAME_SIZE / min(AG_WH)
        frame_shape = (round(AG_WH[1] * scale), round(AG_WH[0] * scale), 3)
        load = []
        for i in range(len(ds)):
            t0 = time.perf_counter()
            raw = ds.read_frames(i)
            t1 = time.perf_counter()
            blob, scale = prep_frames(raw, CLI_FRAME_SIZE, det.device)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if tuple(blob.shape) != (len(raw),) + frame_shape or not bool(torch.isfinite(blob).all()):
                raise AssertionError(f"AG load: frames {tuple(blob.shape)}")
            row = dict(frames=len(raw), decode_ms=1e3 * (t1 - t0),
                       upload_resize_ms=1e3 * (t2 - t1), scale=scale)
            if i == 0:
                # the card's upload, mean subtraction, resize and padding
                # against the same code on the CPU
                cpu_blob, cpu_scale = prep_frames(raw, CLI_FRAME_SIZE, "cpu")
                err = float((blob.cpu() - cpu_blob).abs().max())
                if cpu_scale != scale or err > AG_LOAD_ATOL:
                    raise AssertionError(f"AG load on the card differs from the CPU's: max "
                                         f"|diff| {err}, scale {scale} vs {cpu_scale}")
                row["max_abs_err_vs_cpu"] = err
                log(f"[cli] AG load of video 0 on the card == on the CPU: max |diff| {err} "
                    f"(tolerance {AG_LOAD_ATOL})")
            load.append(row)
            log(f"[cli] AG load of video {i} ({len(raw)} frames): PNG decode {1e3 * (t1 - t0):.1f} ms "
                f"({1e3 * (t1 - t0) / len(raw):.2f} ms per frame), upload + mean subtraction + "
                f"resize {1e3 * (t2 - t1):.1f} ms, frames {tuple(blob.shape)}, scale {scale:.6f}")
        results["ag_load"] = load
    log("[cli] " + json.dumps(results))
    return results


# ---------------------------------------------------------------------------
# training: TEMPURA predcls and sgcls through run_training, sgdet through
# its train frontend and run_training, then the train CLI in all three modes
# ---------------------------------------------------------------------------

TRAIN_EPOCHS = 2
# the memory hallucinators' parameters: untouched while the banks are empty
HALLUCINATORS = {
    "predcls": ("glocal_transformer.mem_attention.in_proj_weight",
                "glocal_transformer.mem_attention.out_proj.weight"),
}
HALLUCINATORS["sgcls"] = HALLUCINATORS["predcls"] + (
    "object_classifier.mem_attention.in_proj_weight",
    "object_classifier.mem_attention.out_proj.weight")
TRAIN_CARD_CPU_TOL = 1e-8
# the train CLI's trees: two train videos and two test videos a mode, 16
# frames for the GT-box modes; sgdet's of 12 frames, whose 16 detections a
# frame and SUPPLY rows fit vidsgg's largest bucket, EntryCapacity(64, 256,
# 192)
TRAIN_CLI_VIDEOS = {
    "predcls": [(500, FRAMES, "train"), (501, FRAMES, "train"),
                (510, FRAMES, "test"), (511, FRAMES, "test")],
    "sgdet": [(520, 12, "train"), (521, 12, "train"), (530, 12, "test"), (531, 12, "test")],
}
TRAIN_CLI_VIDEOS["sgcls"] = TRAIN_CLI_VIDEOS["predcls"]
# sgdet training: four videos of the serving frames, 2 epochs, validated on
# the same videos
SGDET_TRAIN_SEEDS = [600 + i for i in range(N_VIDEOS + 1)]


@contextlib.contextmanager
def patched(module, **attrs):
    """``module``'s attributes replaced for the block."""
    old = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def synced(fn, sink: list, peaks: list | None = None):
    """``fn`` timed on the host clock between two synchronizes, in ms; with
    ``peaks``, also the peak bytes allocated during the call."""
    def wrapped(*args, **kw):
        torch.cuda.synchronize()
        if peaks is not None:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        sink.append(1e3 * (time.perf_counter() - t0))
        if peaks is not None:
            peaks.append(torch.cuda.max_memory_allocated())
        return out
    return wrapped


def spread(ms: list) -> dict:
    """The first call, then min / median / max of the others."""
    rest = sorted(ms[1:]) or ms
    return dict(calls=len(ms), first=ms[0], min=rest[0], median=rest[len(rest) // 2],
                max=rest[-1])


def adamw_bound(model) -> dict:
    """The least time of one AdamW update over ``model``: it reads p, g, m
    and v and writes p, m and v, 7 x the parameters' float32 bytes, at the
    card's memory rate; its operations (about 15 a parameter) at the
    float32 rate take a tenth of that."""
    n = sum(p.numel() for p in model.parameters())
    return dict(parameters=n, bytes=7 * 4 * n, bound_ms=1e3 * 7 * 4 * n / H100_BYTES_PER_S,
                ops_ms=1e3 * 15 * n / H100_FP32_FLOPS, bound_by="bytes")


def train_model(mode: str, device):
    """TEMPURA as ``tempura_train --mode <mode>`` builds it (the run
    config's mode overrides: sgcls and sgdet K = 4 with 3 tracking layers,
    the ``euc_con`` object loss), from seed 1; sgcls adds
    ``-obj_mem_compute`` (the 2376-wide object bank and its hallucinator).
    Returns (model, loss flags, the run config)."""
    from vidsgg_torch.configs.tempura import TempuraRunConfig
    from vidsgg_torch.models import Tempura

    run_cfg = TempuraRunConfig(mode=mode, obj_mem_compute=mode == "sgcls")
    model = Tempura(run_cfg.model_config(), device=device,
                    generator=torch.Generator().manual_seed(1))
    return model, run_cfg.loss_flags(), run_cfg


class TrainTimes:
    """Stage times (ms between synchronizes) and per-call peaks of a
    ``run_training`` run, through the loop's module attributes: the train
    step (and the optimizer's update inside it), the ``unc`` forward, the
    memory fold, the finalize and validation per video. It also keeps every
    step's metrics and checks the hallucinators at the end of epoch 0."""

    STAGES = ("train_step", "adamw", "unc_forward", "memory_fold", "finalize", "validation")

    def __init__(self, state, hallucinators):
        from vidsgg_torch.train import loop as tloop

        self.tloop = tloop
        self.times = {k: [] for k in self.STAGES}
        self.peaks = {k: [] for k in self.STAGES}
        self.metrics, self.saved, self.epoch0 = [], [], {}
        self.state, self.hallucinators = state, hallucinators
        self.params = dict(state.model.named_parameters())
        self.initial = {k: v.detach().clone() for k, v in self.params.items()}

    def stage(self, name, fn):
        return synced(fn, self.times[name], self.peaks[name])

    @contextlib.contextmanager
    def active(self):
        tloop, times = self.tloop, self
        base_step, base_finalize = tloop.make_train_step, tloop.finalize_memory

        def make_train_step(flags):
            step = times.stage("train_step", base_step(flags))

            def train_step(st, entry, noise):
                times.metrics.append(step(st, entry, noise))
                return times.metrics[-1]
            return train_step

        def finalize(*args):
            if not times.epoch0:   # the end of epoch 0: the hallucinators have not moved
                opt = times.state.optimizer
                times.epoch0["counts"] = {n: opt.state[times.params[n]]["step"].tolist()
                                          for n in times.hallucinators}
                times.epoch0["equal"] = all(torch.equal(times.params[n], times.initial[n])
                                            for n in times.hallucinators)
            return times.stage("finalize", base_finalize)(*args)

        class TimedPipeline(tloop.EvalPipeline):
            def __call__(self, *args, **kw):
                return times.stage("validation", super().__call__)(*args, **kw)

        opt = self.state.optimizer
        opt.step = synced(opt.step, self.times["adamw"])
        try:
            with patched(tloop, make_train_step=make_train_step,
                         eval_step=self.stage("unc_forward", tloop.eval_step),
                         accumulate_memory=self.stage("memory_fold", tloop.accumulate_memory),
                         finalize_memory=finalize, EvalPipeline=TimedPipeline,
                         save_checkpoint=lambda path, st, name: self.saved.append(name)):
                yield self
        finally:
            del opt.step

    def adamw_share(self) -> float:
        """AdamW's share of a train step (the two stages' medians)."""
        return (spread(self.times["adamw"])["median"]
                / spread(self.times["train_step"])["median"])

    def check(self, state, what: str, videos: int) -> dict:
        """Finite losses, moved parameters, the hallucinators (if any)
        untouched through epoch 0 and trained in epoch 1, vidsgg's
        checkpoint names."""
        host = torch.stack([torch.stack(list(m.values())) for m in self.metrics]).cpu()
        if not bool(torch.isfinite(host).all()):
            raise AssertionError(f"{what}: non-finite losses {host.tolist()}")
        params = self.params
        moved = [k for k, p in params.items() if not torch.equal(p, self.initial[k])]
        if len(moved) < 0.9 * len(params):
            raise AssertionError(f"{what}: only {len(moved)} of {len(params)} parameters moved")
        e0 = self.epoch0
        if self.hallucinators and (not e0.get("equal") or any(
                set(c) != {0} for c in e0["counts"].values())):
            raise AssertionError(f"{what}: a hallucinator moved in epoch 0: {e0}")
        hall = {n: state.optimizer.state[params[n]]["step"].tolist() for n in self.hallucinators}
        if any(torch.equal(params[n], self.initial[n]) for n in self.hallucinators) or any(
                set(c) != {videos} for c in hall.values()):
            raise AssertionError(f"{what}: a hallucinator did not train in epoch 1: {hall}")
        if self.saved[0] != "checkpoint_0" or self.saved[-1] != "checkpoint_final":
            raise AssertionError(f"{what}: checkpoints {self.saved}")
        return dict(moved_parameters=len(moved), parameters=len(params),
                    losses={k: host[:, i].tolist() for i, k in enumerate(self.metrics[0])},
                    hallucinator_counts={"epoch 0": e0.get("counts"), "end": hall},
                    unmoved=sorted(set(params) - set(moved)), checkpoints=self.saved)


def train_phase(det, mode: str = "predcls"):
    """TEMPURA predcls or sgcls training at the published widths (1 encoder
    + 3 decoder layers; predcls K = 6; sgcls K = 4, 3 tracking layers of
    2376, linear object head, ``euc_con``, and the object memory; joint
    relation memory; float32, TF32 off) through ``run_training``: 2 epochs
    over the four GT-box videos of ``serve_gt_phase`` (featurized by the
    calibrated ResNet-101 first, as a loader would), validated on the same
    videos. Times each stage between synchronizes; the run's peak memory.
    Checks: finite losses, moved parameters, the hallucinators untouched
    through epoch 0 and trained in epoch 1, no NMS launch; then two float64
    train steps on the card against the CPU with the same noise."""
    from vidsgg_torch.models.noise import Noise
    from vidsgg_torch.ops.nms import NMS_KERNEL
    from vidsgg_torch.serving_setup import GT_CAP, train_steps_card_vs_cpu
    from vidsgg_torch.train import create_train_state
    from vidsgg_torch.train import loop as tloop
    from vidsgg_torch.train.metrics import MetricsWriter

    tag = "[train]" if mode == "predcls" else f"[train {mode}]"
    t0 = time.perf_counter()
    model, flags, run_cfg = train_model(mode, det.device)
    state = create_train_state(model, steps_per_epoch=len(GT_SEEDS))
    front = GtFrontend(det)
    videos = []
    for seed in GT_SEEDS:
        ann, skeleton = gt_video(seed, mode, det.device)
        entry, fmaps = front(make_frames(seed, FRAMES, H, W, det.device), skeleton)
        videos.append((entry, fmaps, ann))
    torch.cuda.synchronize()
    log(f"{tag} TEMPURA {model.cfg}, {sum(p.numel() for p in model.parameters())} "
        f"parameters, and {len(videos)} featurized videos ready in "
        f"{time.perf_counter() - t0:.1f} s")

    times = TrainTimes(state, HALLUCINATORS[mode])
    cfg = tloop.TrainLoopConfig(mode=mode, nepoch=TRAIN_EPOCHS, log_iter=len(videos),
                                obj_mem_compute=run_cfg.obj_mem_compute)
    with tempfile.TemporaryDirectory(prefix="train_log_") as logdir, times.active(), \
            contextlib.redirect_stdout(io.StringIO()) as out:
        writer = MetricsWriter(logdir)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        NMS_KERNEL.reset_counts()
        t0 = time.perf_counter()
        state = tloop.run_training(state, flags, cfg, lambda: iter(videos),
                                   lambda: iter(videos), GT_CAP, writer,
                                   Noise.seeded(1, det.device))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        writer.close()
    peak = max(p for ps in times.peaks.values() for p in ps)
    launches = NMS_KERNEL.launches
    for line in out.getvalue().splitlines():
        log(f"{tag} {line}")
    checked = times.check(state, tag, len(videos))
    if launches != 0:
        raise AssertionError(f"{tag} {launches} NMS kernel launches, want 0")
    err = train_steps_card_vs_cpu(det.device, mode=mode)
    if err > TRAIN_CARD_CPU_TOL:
        raise AssertionError(f"{tag} float64 steps on the card differ from the CPU's by {err}")
    result = dict(
        videos=len(videos), epochs=TRAIN_EPOCHS, wall_s=wall,
        ms_per_video=1e3 * wall / (TRAIN_EPOCHS * len(videos)),
        stages_ms={k: spread(v) for k, v in times.times.items()},
        peak_memory_bytes=peak, before_run_bytes=before, nms_launches=launches,
        adamw=adamw_bound(model), adamw_share_of_step=times.adamw_share(),
        float64_card_vs_cpu_max_rel_err=err, **checked)
    log(f"{tag} {TRAIN_EPOCHS} epochs x {len(videos)} videos in {wall:.2f} s "
        f"({result['ms_per_video']:.1f} ms per trained video, validation and the stage "
        f"synchronizes included), peak {peak} bytes ({peak / 2**30:.2f} GiB; {before} before "
        f"the run), NMS launches {launches}, {checked['moved_parameters']} of "
        f"{checked['parameters']} parameters moved; float64 steps card vs CPU: max rel err "
        f"{err:.3g} (tolerance {TRAIN_CARD_CPU_TOL})")
    for k, v in result["stages_ms"].items():
        log(f"{tag}   {k} ms: " + json.dumps(v))
    log(f"{tag}   AdamW bound: " + json.dumps(result["adamw"]) + f"; AdamW "
        f"{result['adamw_share_of_step']:.3f} of a step (medians)")
    del model, state, videos, times
    torch.cuda.empty_cache()
    return result


def sgdet_train_phase(det):
    """TEMPURA sgdet training at full width, as ``tempura_train --mode
    sgdet`` builds the model (1 + 3 layers, K = 4, 3 tracking layers,
    linear object head, ``euc_con``; float32, TF32 off), on the calibrated
    ResNet-101 detector: four videos of the serving frames (16 x 608x1008,
    RPN 6000 / 100) with synthetic annotations of 1 person + 3 objects a
    frame, through ``SgdetFrontend(..., is_train=True)`` (``SgdetCaps(16,
    64)``; an entry capacity that admits 16 detections a frame and every
    SUPPLY row) and ``run_training``, 2 epochs, validated on the same
    videos through the test frontend and ``EvalPipeline("sgdet")``
    (``vidsgg``'s ungrouped union pooling). Times detect + plan + pack, the
    train step and the other stages, with each stage's own peak memory.
    Checks: no video skipped, the NMS kernel launched twice per train video
    and three times per validation video, every call bit-equal to its plain
    version on the inputs the path gave it, finite losses, moved
    parameters, the hallucinator untouched through epoch 0."""
    from vidsgg_torch.detector import SgdetCaps, SgdetFrontend
    from vidsgg_torch.models.noise import Noise
    from vidsgg_torch.ops.nms import NMS_KERNEL
    from vidsgg_torch.serving_setup import DETS, SGDET_TRAIN_CAP, SUPPLY_CAP
    from vidsgg_torch.serving_setup import sgdet_train_annotation
    from vidsgg_torch.train import create_train_state
    from vidsgg_torch.train import loop as tloop
    from vidsgg_torch.train.metrics import MetricsWriter

    tag = "[train sgdet]"
    t0 = time.perf_counter()
    model, flags, run_cfg = train_model("sgdet", det.device)
    state = create_train_state(model, steps_per_epoch=len(SGDET_TRAIN_SEEDS))
    front = SgdetFrontend(det, SgdetCaps(DETS, SUPPLY_CAP), SGDET_TRAIN_CAP, device=det.device)
    videos = [(make_frames(seed, FRAMES, H, W, det.device), sgdet_train_annotation(seed))
              for seed in SGDET_TRAIN_SEEDS]
    hw = (float(H), float(W))
    times = TrainTimes(state, HALLUCINATORS["predcls"])
    for k in ("detect_plan_pack", "detect_test"):
        times.times[k], times.peaks[k] = [], []
    train_entry = times.stage("detect_plan_pack", front)
    test_entry = times.stage("detect_test", front)
    skipped, rows = [], []

    def train_data():
        for frames, ann in videos:
            try:
                entry, fmaps = train_entry(frames, hw, 1.0, video_size=(float(W), float(H)),
                                           gt_annotation=ann, is_train=True)
            except ValueError as e:
                skipped.append(str(e))
                continue
            n = int(entry.obj_mask.sum())
            rows.append(dict(rows=n, supply=int((entry.scores[:n] == 1.0).sum()),
                             pairs=int(entry.pair_mask.sum())))
            yield entry, fmaps, ann

    def val_data():
        for frames, ann in videos:
            entry, fmaps = test_entry(frames, hw, 1.0, video_size=(float(W), float(H)))
            yield entry, fmaps, ann

    torch.cuda.synchronize()
    log(f"{tag} TEMPURA {model.cfg}, {sum(p.numel() for p in model.parameters())} "
        f"parameters, SgdetCaps({DETS}, {SUPPLY_CAP}), {SGDET_TRAIN_CAP}, "
        f"{len(videos)} videos of {FRAMES}x{H}x{W} ready in {time.perf_counter() - t0:.1f} s")
    cfg = tloop.TrainLoopConfig(mode="sgdet", nepoch=TRAIN_EPOCHS, log_iter=len(videos))
    calls = []
    with tempfile.TemporaryDirectory(prefix="train_log_") as logdir, times.active(), \
            recording_nms_calls(calls), contextlib.redirect_stdout(io.StringIO()) as out:
        writer = MetricsWriter(logdir)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        NMS_KERNEL.reset_counts()
        t0 = time.perf_counter()
        state = tloop.run_training(state, flags, cfg, train_data, val_data, SGDET_TRAIN_CAP,
                                   writer, Noise.seeded(1, det.device))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        writer.close()
    launches, launches_by = NMS_KERNEL.launches, dict(NMS_KERNEL.launches_by)
    for line in out.getvalue().splitlines():
        log(f"{tag} {line}")
    if skipped:
        raise AssertionError(f"{tag} {len(skipped)} videos skipped: {skipped}")
    n_train = n_val = TRAIN_EPOCHS * len(videos)
    want = 2 * n_train + 3 * n_val
    if launches != want or len(calls) != want:
        raise AssertionError(f"{tag} {launches} NMS launches ({len(calls)} recorded), want "
                             f"{want}: 2 per train video, 3 per validation video")
    shapes = check_recorded_nms(calls, "sgdet", "training")
    del calls
    checked = times.check(state, tag, len(videos))
    peaks = {k: max(v) for k, v in times.peaks.items() if v}
    result = dict(
        videos=len(videos), epochs=TRAIN_EPOCHS, wall_s=wall,
        ms_per_video=1e3 * wall / n_train, skipped=len(skipped), train_rows=rows,
        stages_ms={k: spread(v) for k, v in times.times.items()},
        stage_peak_bytes=peaks, peak_memory_bytes=max(peaks.values()),
        before_run_bytes=before, nms_launches=launches, nms_launches_by=launches_by,
        nms_calls_bit_equal=len(shapes), adamw=adamw_bound(model),
        adamw_share_of_step=times.adamw_share(), **checked)
    log(f"{tag} {TRAIN_EPOCHS} epochs x {len(videos)} videos in {wall:.2f} s "
        f"({result['ms_per_video']:.1f} ms per trained video with its validation video), "
        f"0 skipped, NMS launches {launches} ({launches_by}; 2 per train video, 3 per "
        f"validation video), every call bit-equal to the plain version; peak "
        f"{result['peak_memory_bytes'] / 2**30:.2f} GiB ({before} bytes before the run)")
    for k, v in result["stages_ms"].items():
        log(f"{tag}   {k} ms: " + json.dumps(v) + f", peak {peaks.get(k, 0) / 2**30:.2f} GiB")
    log(f"{tag}   rows per train entry: " + json.dumps(rows))
    log(f"{tag}   AdamW bound: " + json.dumps(result["adamw"]) + f"; AdamW "
        f"{result['adamw_share_of_step']:.3f} of a step (medians)")
    del model, state, videos, times, front
    torch.cuda.empty_cache()
    return result


def run_train_cli(argv: list, cli: str = "tempura_train") -> tuple:
    """``vidsgg_torch.cli.<cli>.main(argv)`` with its output kept:
    (final state, stdout, seconds)."""
    import importlib

    module = importlib.import_module(f"vidsgg_torch.cli.{cli}")
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        state = module.main(list(argv))
    torch.cuda.synchronize()
    return state, out.getvalue(), time.perf_counter() - t0


def same_state(model, banks: dict, payload: dict, what: str, optimizer=None, step=None):
    """The model's state_dict, the banks (and the optimizer's state and the
    step) bit for bit equal to a checkpoint payload's."""
    sd = model.state_dict()
    if sorted(sd) != sorted(payload["model"]):
        raise AssertionError(f"{what}: model keys differ")
    bad = [k for k, v in sd.items() if not torch.equal(v, payload["model"][k])]
    bad += [k for k, v in banks.items() if not torch.equal(v, payload[k])]
    if optimizer is not None:
        want = payload["optimizer"]
        got = optimizer.state_dict()
        if got["updates"] != want["updates"] or step != payload["step"]:
            bad.append("updates/step")
        for i, st in got["state"].items():
            bad += [f"optimizer {i} {k}" for k, v in st.items()
                    if not torch.equal(v, want["state"][i][k])]
    if bad:
        raise AssertionError(f"{what}: differs from the checkpoint in {bad[:8]}")


def train_cli_phase(det):
    """``tempura_train`` as a user runs it, in predcls, sgcls and sgdet: an
    AG-format tree a mode with a train split (two videos) and a test split
    (two), random 480x270 PNGs, the calibrated detector as a jwyang
    ``.pth``, the default TEMPURA of the mode (1 + 3 layers; sgcls and
    sgdet K = 4 with tracking), one epoch, checkpoints on disk; sgdet's
    videos are 12 frames (16 detections a frame and the SUPPLY rows fit
    ``vidsgg``'s largest bucket) and its source may skip none. Then
    ``--resume`` (restores ``best_recall``, or ``checkpoint_final`` copied
    to that name where the run saved no ``best_recall``: the state must
    equal the file's bit for bit) and ``tempura_test --ckpt ... --ckpt_name
    checkpoint_final`` (the served model and banks must equal the file's,
    which must equal the train run's final state). NMS launches: none in
    predcls and sgcls; in sgdet 2 per train video (the CLI's probe of its
    first video included) and 3 per validation video. Each mode's directory
    is deleted before the next."""
    import shutil

    from vidsgg_torch.cli import tempura_test
    from vidsgg_torch.ops.nms import NMS_KERNEL
    from vidsgg_torch.train.checkpoint import checkpoint_file, load_payload

    results = {}
    for mode in ("predcls", "sgcls", "sgdet"):
        tag = f"[train cli {mode}]"
        with tempfile.TemporaryDirectory(prefix=f"ag_train_{mode}_") as tmp:
            root = os.path.join(tmp, "ag")
            write_ag_split(root, TRAIN_CLI_VIDEOS[mode])
            pth = os.path.join(tmp, "faster_rcnn_ag.pth")
            torch.save({"model": det.state_dict()}, pth)
            save = os.path.join(tmp, "checkpoints")
            common = ["--mode", mode, "--data_path", root, "--model_path", pth,
                      "--frame_size", str(CLI_FRAME_SIZE)]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            NMS_KERNEL.reset_counts()
            state, text, seconds = run_train_cli(common + ["--nepoch", "1", "-log_iter", "1",
                                                           "--save_path", save])
            peak = torch.cuda.max_memory_allocated()
            launches = NMS_KERNEL.launches
            per_video = [float(x) for x in
                         re.findall(r"^epoch 0 step \d+  ([0-9.]+)s/video", text, re.M)]
            # sgdet: the probe of the first train video, two train videos,
            # two validation videos
            want = 2 * 3 + 3 * 2 if mode == "sgdet" else 0
            skipped = re.search(r"skipped=[1-9]|\[sgdet_source\] skipped", text)
            if len(per_video) != 2 or launches != want or skipped:
                raise AssertionError(f"{tag} {len(per_video)} step lines, NMS launches "
                                     f"{launches} (want {want}): {text[-800:]}")
            files = sorted(os.listdir(save))
            log(f"{tag} tempura_train: {seconds:.1f} s, s/video per step line {per_video}, "
                f"NMS launches {launches}, peak {peak} bytes ({(peak - before) / 2**30:.2f} "
                f"GiB its own), files {files}")
            for line in text.splitlines():
                if line.startswith(("epoch", "new best", ">>>")):
                    log(f"{tag}   {line}")
            sizes = {f: os.path.getsize(os.path.join(save, f)) for f in files}
            final = load_payload(save, "checkpoint_final", det.device)
            same_state(state.model, {"rel_memory": state.rel_memory,
                                     "obj_memory": state.obj_memory,
                                     "mem_active": state.mem_active}, final,
                       f"{tag} checkpoint_final against the train run's state",
                       state.optimizer, state.step)
            del state
            # --resume reads best_recall and trains no further epoch; a run
            # whose R@20 never rose above 0 (random weights: sgdet) saved
            # none, as vidsgg's would, and resumes from checkpoint_final
            resume_from = "best_recall"
            if not os.path.exists(checkpoint_file(save, "best_recall")):
                shutil.copyfile(checkpoint_file(save, "checkpoint_final"),
                                checkpoint_file(save, "best_recall"))
                resume_from = "checkpoint_final"
            resumed, text2, seconds2 = run_train_cli(common + [
                "--nepoch", "0", "--resume", save, "--save_path", os.path.join(tmp, "resumed")])
            best = load_payload(save, "best_recall", det.device)
            same_state(resumed.model, {"rel_memory": resumed.rel_memory,
                                       "obj_memory": resumed.obj_memory,
                                       "mem_active": resumed.mem_active}, best,
                       f"{tag} --resume against {resume_from}", resumed.optimizer, resumed.step)
            line = re.search(r"^resumed from .* at step (\d+)$", text2, re.M)
            if line is None or int(line.group(1)) != best["step"]:
                raise AssertionError(f"{tag} --resume printed no resume line: {text2[-500:]}")
            del resumed, best
            # tempura_test serves checkpoint_final
            served = {}
            restore = tempura_test.restore_serving

            def keep(s, payload):
                served["state"] = restore(s, payload)
                return served["state"]

            with patched(tempura_test, restore_serving=keep):
                evs, text3, n, seconds3 = run_cli(common + [
                    "--ckpt", save, "--ckpt_name", "checkpoint_final",
                    "--output_path", os.path.join(tmp, "out")])
            s = served["state"]
            same_state(s.model, {"rel_memory": s.rel_memory, "obj_memory": s.obj_memory,
                                 "mem_active": s.mem_active}, final,
                       f"{tag} tempura_test --ckpt against checkpoint_final")
            if "restored checkpoint checkpoint_final" not in text3 or n != 2:
                raise AssertionError(f"{tag} tempura_test --ckpt: {text3[-500:]}")
            bad = {f"{ev.constraint} {m}@{k}": f(k) for ev in evs for k in ev.KS
                   for m, f in (("R", ev.recall_at), ("mR", ev.mean_recall_at))
                   if not (np.isfinite(f(k)) and 0 <= f(k) <= 1)}
            if bad:
                raise AssertionError(f"{tag} tempura_test --ckpt: R/mR outside [0, 1]: {bad}")
            del served, s, final
            shutil.rmtree(save)
            if os.path.exists(save):
                raise AssertionError(f"{tag} the checkpoint directory was not deleted")
            results[mode] = dict(train_seconds=seconds, s_per_video_lines=per_video,
                                 nms_launches=launches, own_peak_bytes=peak - before,
                                 checkpoint_bytes=sizes, resumed_from=resume_from,
                                 resume_seconds=seconds2,
                                 test_seconds=seconds3,
                                 test_r20={ev.constraint: ev.recall_at(20) for ev in evs})
            log(f"{tag} --resume equal to {resume_from} bit for bit ({seconds2:.1f} s); "
                f"tempura_test --ckpt served checkpoint_final, equal to it and to the train "
                f"run's state bit for bit ({seconds3:.1f} s); checkpoint directory deleted")
        torch.cuda.empty_cache()
        log(f"{tag} " + json.dumps(results[mode]))
    return results


# TEAT-GT predcls training: the published widths with both consistency
# losses and the ctl losses, through run_training, then its train CLI
TEATGT_SHARE_STEPS = 5          # train steps a side of the regularizer's A/B (the first warms up)
# the parameters that no loss reaches: the test-time pooling gate (its
# pooled state is returned, not trained) and the regularizer's pooling
# gates' biases (a softmax shift: zero gradient, none in the port)
TEATGT_UNMOVED = {"gate_gru_nn.weight", "gate_gru_nn.bias", "gate_nn.bias", "gate_sem_nn.bias"}


def consistency_share(model, flags, videos, device) -> dict:
    """The regularizer's share of a train step, two ways, on copies of the
    model (its own optimizer each): the step's ms between synchronizes with
    the regularizer and without it (the config's consistency flags and the
    two loss terms off: the same model otherwise), and ``torch.profiler``'s
    device time of the ``vidsgg.consistency`` range (the regularizer's
    forward; its backward is not in the range) against the whole step's,
    over three steps after a warm-up."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from vidsgg_torch.models.noise import Noise
    from vidsgg_torch.train import create_train_state, make_train_step
    from vidsgg_torch.train.state import TEATGT_OBJ_DIM

    def steps(m, f, n, trace=None):
        state = create_train_state(m, obj_dim=TEATGT_OBJ_DIM, steps_per_epoch=len(videos))
        step, noise, ms = make_train_step(f), Noise.seeded(5, device), []
        for i in range(n):
            if trace is not None and i == 1:        # after the warm-up step
                trace.start()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with record_function("vidsgg.train_step"):
                step(state, videos[i % len(videos)][0], noise)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        if trace is not None:
            trace.stop()
        return ms

    on = steps(copy.deepcopy(model), flags, TEATGT_SHARE_STEPS)
    off_model = copy.deepcopy(model)
    off_model.cfg = dataclasses.replace(model.cfg, use_cons_str_loss=False,
                                        use_cons_sem_loss=False)
    off = steps(off_model, dataclasses.replace(flags, use_cons_str_loss=False,
                                               use_cons_sem_loss=False), TEATGT_SHARE_STEPS)
    del off_model
    on_s, off_s = spread(on), spread(off)
    result = dict(step_ms_with=on_s, step_ms_without=off_s,
                  share_of_step=1.0 - off_s["median"] / on_s["median"])
    try:
        trace = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        steps(copy.deepcopy(model), flags, 4, trace)
        avg = {e.key: e for e in trace.key_averages()}

        def dev(key):
            e = avg.get(key)
            return None if e is None else float(getattr(e, "device_time_total",
                                                        getattr(e, "cuda_time_total", 0.0)))

        cons, step = dev("vidsgg.consistency"), dev("vidsgg.train_step")
        result["profiler"] = dict(
            steps=3, consistency_forward_device_us=cons, train_step_device_us=step,
            share=(cons / step) if cons and step else "not measured (no device time)")
    except Exception as exc:   # no CUPTI tracing: the A/B share above stands
        result["profiler"] = f"not measured: {type(exc).__name__}: {exc}"
    return result


def regularizer_gradients(model, flags, entry, noise) -> dict:
    """The gradient norm of each of the regularizer's encoders (``gat``,
    ``gat_semantic``) in one train-phase forward and backward of the whole
    loss on ``entry`` (no update; the gradients are dropped after)."""
    from vidsgg_torch.train.steps import assemble_losses

    model.zero_grad(set_to_none=True)
    out = model(entry, phase="train", noise=noise)
    sum(assemble_losses(out, entry, flags).values()).backward()
    norms = {}
    for stream in ("gat", "gat_semantic"):
        grads = [p.grad.double().pow(2).sum() for n, p in model.named_parameters()
                 if n.startswith(f"{stream}.") and p.grad is not None]
        norms[stream] = float(torch.stack(grads).sum().sqrt()) if grads else 0.0
    model.zero_grad(set_to_none=True)
    return norms


def teatgt_train_phase(det, mode: str = "predcls"):
    """TEAT-GT training of ``mode`` at the published widths
    (``serving_setup.build_teatgt_train``: predcls 12 layers x 32 heads,
    sgcls and sgdet 6 x 16 with the tracking OSPU; both consistency
    losses and the ctl losses, in sgcls and sgdet the object loss; float32,
    TF32 off) through ``run_training`` with the memory off and the
    [36, 1024] object bank, as ``teatgt_train`` runs it, validated on the
    same videos: predcls 2 epochs and sgcls 1 over the four GT-box videos
    of ``serve_gt_phase`` (sgcls with their class distributions), given
    their 480x270 frame size (the GT-box entries keep ``vidsgg``'s video
    size 1, whose 0.71 px threshold leaves every frame graph without
    edges); sgdet 1 epoch over the four videos of ``sgdet_train_phase``
    through the train frontend on the calibrated detector (``SgdetCaps(16,
    64)``, ``EntryCapacity(16, 320, 48)``, TEAT-GT's Action Genome clip
    caps, whose token drops are counted), validated through the test
    frontend. The train step, AdamW (against its bytes bound), validation
    and sgdet's detect + plan + pack timed between synchronizes, the run's
    peak memory; finite losses, every parameter moved but those no loss
    reaches (``TEATGT_UNMOVED``; the OSPU's all move), a non-zero gradient
    in both of the regularizer's encoders; no NMS launch in predcls and
    sgcls, in sgdet 2 per train video and 3 per validation video, every
    call bit-equal to the plain version; the regularizer's share of a step
    (:func:`consistency_share`); two float64 train steps on the card
    against the CPU's within 1e-8 (the same draws, the CPU's
    decompositions; every loss, the regularizer's nonzero ones among
    them). Then ``teatgt_train`` as a user runs it
    (:func:`teatgt_train_cli_phase`)."""
    from vidsgg_torch.detector import SgdetCaps, SgdetFrontend
    from vidsgg_torch.models.noise import Noise
    from vidsgg_torch.ops.nms import NMS_KERNEL
    from vidsgg_torch.serving_setup import (
        DETS,
        GT_CAP,
        SGDET_TRAIN_CAP,
        SUPPLY_CAP,
        sgdet_train_annotation,
        teatgt_train_steps_card_vs_cpu,
    )
    from vidsgg_torch.train import create_train_state
    from vidsgg_torch.train import loop as tloop
    from vidsgg_torch.train.metrics import MetricsWriter
    from vidsgg_torch.train.state import TEATGT_OBJ_DIM

    tag = "[teatgt train]" if mode == "predcls" else f"[teatgt train {mode}]"
    epochs = TRAIN_EPOCHS if mode == "predcls" else 1
    t0 = time.perf_counter()
    model, flags = build_teatgt_train(det.device, mode)
    caps = model.cfg.caps
    videos, drops = [], []
    if mode == "sgdet":
        front = SgdetFrontend(det, SgdetCaps(DETS, SUPPLY_CAP), SGDET_TRAIN_CAP,
                              device=det.device)
        raw = [(make_frames(seed, FRAMES, H, W, det.device), sgdet_train_annotation(seed))
               for seed in SGDET_TRAIN_SEEDS]
        cap, hw, size = SGDET_TRAIN_CAP, (float(H), float(W)), (float(W), float(H))
    else:
        front, cap = GtFrontend(det), GT_CAP
        for seed in GT_SEEDS:
            ann, skeleton = gt_video(seed, mode, det.device)
            entry, fmaps = front(make_frames(seed, FRAMES, H, W, det.device), skeleton)
            entry = dataclasses.replace(entry, video_size=torch.tensor(
                GT_IMAGE_WH, dtype=entry.video_size.dtype, device=det.device))
            videos.append((entry, fmaps, ann))
    state = create_train_state(model, obj_dim=TEATGT_OBJ_DIM, steps_per_epoch=4)
    times = TrainTimes(state, ())
    if mode == "sgdet":
        for k in ("detect_plan_pack", "detect_test"):
            times.times[k], times.peaks[k] = [], []
        train_entry = times.stage("detect_plan_pack", front)
        test_entry = times.stage("detect_test", front)

        def train_data():
            for frames, ann in raw:
                entry, fmaps = train_entry(frames, hw, 1.0, video_size=size,
                                           gt_annotation=ann, is_train=True)
                im_idx = entry.im_idx[entry.pair_mask].cpu().numpy()
                drops.append(token_drops({"im_idx": im_idx}, caps))
                yield entry, fmaps, ann

        def val_data():
            for frames, ann in raw:
                entry, fmaps = test_entry(frames, hw, 1.0, video_size=size)
                yield entry, fmaps, ann

        # the regularizer's share is measured on the train entries
        NMS_KERNEL.reset_counts()
        videos = list(train_data())
        drops.clear()
    else:
        def train_data():
            return iter(videos)
        val_data = train_data
    torch.cuda.synchronize()
    log(f"{tag} TEAT-GT {model.cfg}, {sum(p.numel() for p in model.parameters())} "
        f"parameters, and {len(videos)} videos ready in {time.perf_counter() - t0:.1f} s")
    share = consistency_share(model, flags, videos, det.device)
    log(f"{tag} the regularizer's share of a step: " + json.dumps(share))
    first_entry = videos[0][0]
    if mode == "sgdet":
        del videos

    cfg = tloop.TrainLoopConfig(mode=mode, nepoch=epochs, log_iter=4, mem_enabled=False)
    calls = []
    with tempfile.TemporaryDirectory(prefix="teatgt_train_log_") as logdir, times.active(), \
            recording_nms_calls(calls) if mode == "sgdet" else contextlib.nullcontext(), \
            contextlib.redirect_stdout(io.StringIO()) as out:
        writer = MetricsWriter(logdir)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        NMS_KERNEL.reset_counts()
        t0 = time.perf_counter()
        state = tloop.run_training(state, flags, cfg, train_data, val_data, cap, writer,
                                   Noise.seeded(3, det.device))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        writer.close()
    peaks = {k: max(v) for k, v in times.peaks.items() if v}
    peak = max(peaks.values())
    launches, launches_by = NMS_KERNEL.launches, dict(NMS_KERNEL.launches_by)
    for line in out.getvalue().splitlines():
        log(f"{tag} {line}")
    checked = times.check(state, tag, 4)
    want = 2 * 4 * epochs + 3 * 4 * epochs if mode == "sgdet" else 0
    if launches != want or len(calls) != want:
        raise AssertionError(f"{tag} {launches} NMS launches ({len(calls)} recorded), want "
                             f"{want}")
    shapes = check_recorded_nms(calls, f"teatgt {mode}", "training") if calls else []
    del calls
    ospu_unmoved = [k for k in checked["unmoved"] if k.startswith("object_classifier.")]
    if set(checked["unmoved"]) - TEATGT_UNMOVED or ospu_unmoved:
        raise AssertionError(f"{tag} unmoved parameters {checked['unmoved']}")
    grad_norms = regularizer_gradients(state.model, flags, first_entry,
                                       Noise.seeded(4, det.device))
    if not all(np.isfinite(v) and v > 0 for v in grad_norms.values()):
        raise AssertionError(f"{tag} the regularizer's gradient norms {grad_norms}")
    stages = {k: spread(v) for k, v in times.times.items() if v}
    adamw, adamw_share = adamw_bound(model), times.adamw_share()
    del model, state, times
    torch.cuda.empty_cache()
    # the regularizer's losses are among the compared step metrics
    err, cons_losses = teatgt_train_steps_card_vs_cpu(det.device, mode=mode)
    if err > TRAIN_CARD_CPU_TOL or not all(v > 0 for v in cons_losses.values()):
        raise AssertionError(f"{tag} float64 card vs CPU: train steps {err}, the CPU's "
                             f"consistency losses {cons_losses}")
    result = dict(
        videos=4, epochs=epochs, wall_s=wall, ms_per_video=1e3 * wall / (epochs * 4),
        stages_ms=stages, stage_peak_bytes=peaks, peak_memory_bytes=peak,
        before_run_bytes=before, nms_launches=launches, nms_launches_by=launches_by,
        nms_calls_bit_equal=len(shapes), adamw=adamw, consistency=share,
        regularizer_grad_norms=grad_norms, adamw_share_of_step=adamw_share,
        float64_card_vs_cpu_max_rel_err=err, consistency_reference_losses=cons_losses,
        **checked)
    if mode == "sgdet":
        result["token_drops"] = [dict(dropped=d, tokens=t) for d, t in drops]
    validation = result["stages_ms"].get("validation")
    log(f"{tag} {epochs} epochs x 4 videos in {wall:.2f} s "
        f"({result['ms_per_video']:.1f} ms per trained video, validation and the stage "
        f"synchronizes included), peak {peak} bytes ({peak / 2**30:.2f} GiB; {before} before "
        f"the run), NMS launches {launches} ({launches_by}"
        + (f", every call bit-equal to plain {len(shapes)}" if shapes else "") + "), "
        f"{checked['moved_parameters']} of {checked['parameters']} parameters moved, the "
        f"regularizer's gradient norms {grad_norms}; validation ms per video "
        f"{json.dumps(validation)}; float64 card vs CPU: train steps max rel err {err:.3g} "
        f"(tolerance {TRAIN_CARD_CPU_TOL}; the CPU's consistency losses {cons_losses})")
    if mode == "sgdet":
        log(f"{tag} tokens dropped by the clip caps {caps} per train video "
            f"(dropped, tokens): {drops}")
    for k, v in result["stages_ms"].items():
        log(f"{tag}   {k} ms: " + json.dumps(v) + f", peak {peaks.get(k, 0) / 2**30:.2f} GiB")
    log(f"{tag}   AdamW bound: " + json.dumps(result["adamw"]) + f"; AdamW "
        f"{result['adamw_share_of_step']:.3f} of a step (medians)")
    torch.cuda.empty_cache()
    result["cli"] = teatgt_train_cli_phase(det, mode)
    return result


def teatgt_train_cli_phase(det, mode: str = "predcls"):
    """``teatgt_train --mode <mode>`` with both consistency losses and
    ``--use_ctl_loss`` at the default widths, as a user runs it: an
    AG-format tree with a train split (two videos) and a test split (two),
    16 frames (sgdet 12, as ``train_cli_phase``), the calibrated detector
    as a jwyang ``.pth``, one epoch, checkpoints on disk; every metric of
    its step lines finite, the regularizer's losses among them (and in
    sgcls and sgdet the object loss). Then ``--resume`` (the state must
    equal the file's bit for bit; ``checkpoint_final`` copied to
    ``best_recall`` where the run saved none) and ``teatgt_test --ckpt ...
    --ckpt_name checkpoint_final`` with the same model flags (the served
    model must equal the file's, which must equal the train run's final
    state). NMS launches: none in predcls and sgcls; in sgdet 2 per train
    video (the CLI's probe of its first video included) and 3 per
    validation and test video. The directory is deleted after."""
    import shutil

    from vidsgg_torch.cli import teatgt_test
    from vidsgg_torch.ops.nms import NMS_KERNEL
    from vidsgg_torch.train.checkpoint import checkpoint_file, load_payload

    tag = "[teatgt train cli]" if mode == "predcls" else f"[teatgt train cli {mode}]"
    detect = mode == "sgdet"
    with tempfile.TemporaryDirectory(prefix=f"ag_teatgt_train_{mode}_") as tmp:
        root = os.path.join(tmp, "ag")
        write_ag_split(root, TRAIN_CLI_VIDEOS[mode])
        pth = os.path.join(tmp, "faster_rcnn_ag.pth")
        torch.save({"model": det.state_dict()}, pth)
        save = os.path.join(tmp, "checkpoints")
        common = ["--mode", mode, "--data_path", root, "--model_path", pth,
                  "--frame_size", str(CLI_FRAME_SIZE)] + TEATGT_TRAIN_ARGS
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        NMS_KERNEL.reset_counts()
        state, text, seconds = run_train_cli(common + ["--nepoch", "1", "--log_iter", "1",
                                                       "--save_path", save], "teatgt_train")
        peak = torch.cuda.max_memory_allocated()
        launches, launches_by = {"train": NMS_KERNEL.launches}, dict(NMS_KERNEL.launches_by)
        per_video = [float(x) for x in
                     re.findall(r"^epoch 0 step \d+  ([0-9.]+)s/video", text, re.M)]
        want = {"train": 2 * 3 + 3 * 2 if detect else 0}
        skipped = re.search(r"skipped=[1-9]|\[sgdet_source\] skipped", text)
        if len(per_video) != 2 or launches != want or skipped:
            raise AssertionError(f"{tag} {len(per_video)} step lines, NMS launches "
                                 f"{launches} (want {want}): {text[-800:]}")
        # every logged metric finite, the regularizer's and the ctl losses
        # among them
        step_metrics = [dict((k, float(v)) for k, v in re.findall(r"(\w+)=(\S+)", line))
                        for line in re.findall(r"^epoch 0 step \d+ .*$", text, re.M)]
        wanted = {"structure_temp_loss", "semantic_temp_loss", "attention_con_loss"}
        if mode != "predcls":
            wanted.add("object_loss")
        if not all(wanted <= m.keys() and all(np.isfinite(v) for v in m.values())
                   for m in step_metrics):
            raise AssertionError(f"{tag} step metrics {step_metrics}")
        if tuple(state.obj_memory.shape) != (36, 1024):
            raise AssertionError(f"{tag} object bank {tuple(state.obj_memory.shape)}")
        files = sorted(os.listdir(save))
        sizes = {f: os.path.getsize(os.path.join(save, f)) for f in files}
        log(f"{tag} teatgt_train: {seconds:.1f} s, s/video per step line {per_video}, "
            f"NMS launches {launches['train']}, peak {peak} bytes "
            f"({(peak - before) / 2**30:.2f} GiB its own), files {sizes}")
        for line in text.splitlines():
            if line.startswith(("epoch", "new best", ">>>")):
                log(f"{tag}   {line}")
        final = load_payload(save, "checkpoint_final", det.device)
        banks = ("rel_memory", "obj_memory", "mem_active")
        same_state(state.model, {k: getattr(state, k) for k in banks}, final,
                   f"{tag} checkpoint_final against the train run's state", state.optimizer,
                   state.step)
        del state
        resume_from = "best_recall"
        if not os.path.exists(checkpoint_file(save, "best_recall")):
            shutil.copyfile(checkpoint_file(save, "checkpoint_final"),
                            checkpoint_file(save, "best_recall"))
            resume_from = "checkpoint_final"
        NMS_KERNEL.reset_counts()
        resumed, text2, seconds2 = run_train_cli(common + [
            "--nepoch", "0", "--resume", save, "--save_path", os.path.join(tmp, "resumed")],
            "teatgt_train")
        launches["resume"] = NMS_KERNEL.launches       # the probe of the first video
        best = load_payload(save, "best_recall", det.device)
        same_state(resumed.model, {k: getattr(resumed, k) for k in banks}, best,
                   f"{tag} --resume against {resume_from}", resumed.optimizer, resumed.step)
        line = re.search(r"^resumed from .* at step (\d+)$", text2, re.M)
        if line is None or int(line.group(1)) != best["step"]:
            raise AssertionError(f"{tag} --resume printed no resume line: {text2[-500:]}")
        del resumed, best
        served = {}
        restore = teatgt_test.restore_serving

        def keep(s, payload):
            served["state"] = restore(s, payload)
            return served["state"]

        NMS_KERNEL.reset_counts()
        with patched(teatgt_test, restore_serving=keep):
            evs, _, n, seconds3 = run_cli(common + ["--ckpt", save, "--ckpt_name",
                                                    "checkpoint_final"], cli="teatgt_test")
        launches["test"] = NMS_KERNEL.launches
        s = served["state"]
        same_state(s.model, {k: getattr(s, k) for k in banks}, final,
                   f"{tag} teatgt_test --ckpt against checkpoint_final")
        bad = {f"{ev.constraint} {m}@{k}": f(k) for ev in evs for k in ev.KS
               for m, f in (("R", ev.recall_at), ("mR", ev.mean_recall_at))
               if not (np.isfinite(f(k)) and 0 <= f(k) <= 1)}
        want.update(resume=2 if detect else 0, test=3 * n if detect else 0)
        if n != 2 or bad or launches != want:
            raise AssertionError(f"{tag} teatgt_test --ckpt: {n} videos, NMS launches "
                                 f"{launches} (want {want}), R/mR outside [0, 1]: {bad}")
        del served, s, final
        shutil.rmtree(save)
        result = dict(train_seconds=seconds, s_per_video_lines=per_video,
                      nms_launches=launches["train"], nms_launches_by=launches_by,
                      nms_launches_by_run=launches,
                      own_peak_bytes=peak - before, checkpoint_bytes=sizes,
                      resumed_from=resume_from, resume_seconds=seconds2,
                      test_seconds=seconds3,
                      test_r20={ev.constraint: ev.recall_at(20) for ev in evs})
        log(f"{tag} --resume equal to {resume_from} bit for bit ({seconds2:.1f} s); "
            f"teatgt_test --ckpt served checkpoint_final, equal to it and to the train run's "
            f"state bit for bit ({seconds3:.1f} s); NMS launches {launches}; checkpoint "
            f"directory deleted")
    torch.cuda.empty_cache()
    log(f"{tag} " + json.dumps(result))
    return result


# TokenGT's other node identifiers and attention: (name, train CLI flags,
# model options)
NODE_ID_CONFIGS = (("rand", ["--rand_node_id"], {}), ("orf", ["--orf_node_id"], {}),
                   ("performer", [], {"performer": True}))


def node_id_phase(det):
    """TokenGT's random node identifiers (``rand``, ``orf``) and the
    Performer on the card: ``teatgt_test --mode predcls --rand_node_id``
    and ``--orf_node_id`` as a user runs them over an AG-format test split
    (two 16-frame videos; default widths; no NMS launch, R/mR in [0, 1]);
    a small float64 TEAT-GT predcls of each configuration served on the
    card against the CPU with the same test-time draws
    (:func:`reference_teatgt`); and one train step of each at the
    published predcls widths (``build_teatgt_train`` with the consistency
    and ctl losses) on a GT-box video, timed between synchronizes (a
    warm-up step first): finite losses, moved parameters."""
    from vidsgg_torch.detector import FasterRCNN, RPNConfig
    from vidsgg_torch.models.noise import Noise
    from vidsgg_torch.ops.nms import NMS_KERNEL
    from vidsgg_torch.train import create_train_state, make_train_step
    from vidsgg_torch.train.state import TEATGT_OBJ_DIM

    tag = "[node ids]"
    result = {"test_cli": {}, "float64_card_vs_cpu": {}, "train_step": {}}
    with tempfile.TemporaryDirectory(prefix="ag_node_ids_") as tmp:
        root = os.path.join(tmp, "ag")
        write_ag_split(root, TRAIN_CLI_VIDEOS["predcls"])
        pth = os.path.join(tmp, "faster_rcnn_ag.pth")
        torch.save({"model": det.state_dict()}, pth)
        common = ["--mode", "predcls", "--data_path", root, "--model_path", pth,
                  "--frame_size", str(CLI_FRAME_SIZE)]
        for name, flags, _ in NODE_ID_CONFIGS[:2]:
            NMS_KERNEL.reset_counts()
            evs, _, n, seconds = run_cli(common + flags, cli="teatgt_test")
            bad = {f"{ev.constraint} {m}@{k}": f(k) for ev in evs for k in ev.KS
                   for m, f in (("R", ev.recall_at), ("mR", ev.mean_recall_at))
                   if not (np.isfinite(f(k)) and 0 <= f(k) <= 1)}
            if n != 2 or bad or NMS_KERNEL.launches:
                raise AssertionError(f"{tag} teatgt_test {flags}: {n} videos, NMS launches "
                                     f"{NMS_KERNEL.launches}, R/mR outside [0, 1]: {bad}")
            result["test_cli"][name] = dict(videos=n, seconds=seconds,
                                            r20={ev.constraint: ev.recall_at(20)
                                                 for ev in evs})
            log(f"{tag} teatgt_test {' '.join(flags)}: {n} videos in {seconds:.2f} s, R@20 "
                f"{result['test_cli'][name]['r20']}")
    # the float64 references' small detector (predcls reads its base and head)
    small = FasterRCNN(rpn_cfg=RPNConfig(pre_nms_top_n=600, post_nms_top_n=16),
                       base_blocks=(1, 1, 1), head_blocks=1, device="cpu",
                       generator=torch.Generator().manual_seed(7)).double()
    for name, _, kw in NODE_ID_CONFIGS:
        model_kw = kw or {"node_id_mode": name}
        result["float64_card_vs_cpu"][name] = reference_teatgt("predcls", small, **model_kw)

    front = GtFrontend(det)
    ann, skeleton = gt_video(GT_SEEDS[0], "predcls", det.device)
    entry, _ = front(make_frames(GT_SEEDS[0], FRAMES, H, W, det.device), skeleton)
    entry = dataclasses.replace(entry, video_size=torch.tensor(
        GT_IMAGE_WH, dtype=entry.video_size.dtype, device=det.device))
    for name, flags, kw in NODE_ID_CONFIGS:
        model, loss_flags = build_teatgt_train(det.device, "predcls", flags, **kw)
        state = create_train_state(model, obj_dim=TEATGT_OBJ_DIM, steps_per_epoch=1)
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        step, noise, ms = make_train_step(loss_flags), Noise.seeded(6, det.device), []
        metrics = [synced(step, ms)(state, entry, noise) for _ in range(2)]
        host = torch.stack([torch.stack(list(m.values())) for m in metrics]).cpu()
        moved = sum(not torch.equal(p, before[k]) for k, p in model.named_parameters())
        if not bool(torch.isfinite(host).all()) or moved < 0.9 * len(before):
            raise AssertionError(f"{tag} {name} train steps: losses {host.tolist()}, "
                                 f"{moved} of {len(before)} parameters moved")
        cfg = model.cfg
        result["train_step"][name] = dict(
            warm_up_ms=ms[0], step_ms=ms[1], moved_parameters=moved, parameters=len(before),
            node_id_mode=cfg.node_id_mode, performer=cfg.performer,
            losses=dict(zip(metrics[1], host[1].tolist())))
        log(f"{tag} {name}: TEAT-GT predcls {cfg.encoder_layers} x "
            f"{cfg.encoder_attention_heads}, node ids {cfg.node_id_mode}, performer "
            f"{cfg.performer}: train step {ms[1]:.1f} ms (warm-up {ms[0]:.1f}), {moved} of "
            f"{len(before)} parameters moved, total loss {float(host[1, -1]):.4f}")
        del model, state
        torch.cuda.empty_cache()
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs on the card only", file=sys.stderr)
        return 2
    start = time.perf_counter()
    seconds = {}      # each phase's wall seconds, for where the script's time goes

    def lap(name):
        seconds[name] = time.perf_counter() - start - sum(seconds.values())

    device_name, count, _ = device_phase()
    build_phase()
    lap("device and build")

    t0 = time.perf_counter()
    det, rel = build_models()
    torch.cuda.synchronize()
    log(f"[models] FasterRCNN ResNet-101 (3, 4, 23) + head 3, RPN 6000/100@0.7; "
        f"TEMPURA {rel.cfg}; built and calibrated in {time.perf_counter() - t0:.1f} s")
    hw = (float(H), float(W))
    videos = [make_frames(100 + i, FRAMES, H, W, "cuda") for i in range(N_VIDEOS + 1)]

    lap("models")
    timings, errs = kernel_phase(det, rel, videos[0], hw)
    lap("kernels")
    rows, peak, sgdet_preds = serve_phase(det, rel, videos, hw)
    lap("serve sgdet")
    per_video = {k: sum(r[k] for r in rows) / len(rows) for k in ("ms", "detect_ms", "relation_ms")}
    log("[serve] mean over timed videos: " + json.dumps(per_video))
    del rel
    torch.cuda.empty_cache()
    gt_runs, scores = {}, {}
    # the float32 pred dicts of each timed video, for the bfloat16 phase
    f32_preds = {("tempura", "sgdet"): sgdet_preds}
    for mode in GT_MODES:
        gt_runs[mode], preds, anns = serve_gt_phase(det, mode)
        scores[mode] = score_phase(mode, anns, preds)
        f32_preds[("tempura", mode)] = preds
    # sgdet's frames are scored against the GT modes' timed annotations
    sgdet_anns = [synthetic_video_annotation(
        num_frames=FRAMES, objs_per_frame=GT_OBJS_PER_FRAME, image_wh=GT_IMAGE_WH,
        stable=True, seed=seed) for seed in GT_SEEDS[1:]]
    scores["sgdet"] = score_phase("sgdet", sgdet_anns, sgdet_preds)
    lap("serve predcls, sgcls")
    teatgt_runs = {}
    for mode in TEATGT_MODES:
        teatgt_runs[mode], preds, anns = serve_teatgt_phase(det, mode, videos)
        scores[f"teatgt {mode}"] = score_phase(mode, anns, preds)
        f32_preds[("teatgt", mode)] = preds
    lap("serve teatgt")
    bf16_runs, bf16_scores = serve_bf16_phase(det, videos, f32_preds)
    lap("serve bf16")
    scores.update({f"bf16 {k}": v for k, v in bf16_scores.items()})
    del f32_preds
    reference_phase()
    lap("float64 references")
    # the CLI's peak memory counts only what the CLI holds besides the detector
    del videos
    torch.cuda.empty_cache()
    cli_phase(det)
    lap("test CLIs")
    train = {mode: train_phase(det, mode) for mode in ("predcls", "sgcls")}
    lap("train predcls, sgcls")
    train["sgdet"] = sgdet_train_phase(det)
    lap("train sgdet")
    train_cli = train_cli_phase(det)
    lap("train CLI")
    teatgt_train = {mode: teatgt_train_phase(det, mode) for mode in ("predcls", "sgcls")}
    lap("teatgt train predcls, sgcls and their CLI")
    teatgt_train["sgdet"] = teatgt_train_phase(det, "sgdet")
    lap("teatgt train sgdet and its CLI")
    node_ids = node_id_phase(det)
    lap("node ids and performer")
    # launches on the main paths: TEMPURA's and TEAT-GT's sgdet videos, in
    # float32 and in bfloat16
    paths = {"tempura sgdet": rows, "teatgt sgdet": teatgt_runs["sgdet"]["videos"]}
    bf16_paths = {f"bf16 {build}": bf16_runs[build]["videos"]
                  for build, _, mode, _ in BF16_BUILDS if mode == "sgdet"}
    launches = {k: sum(r["launches"] for r in v) for k, v in {**paths, **bf16_paths}.items()}
    ranked_launches = {k: sum(r["launches_by"].get("ranked", 0) for r in v)
                       for k, v in paths.items()}
    ranked_launches.update({k: sum(r["launches_by_dtype"].get("ranked float32", 0) for r in v)
                            for k, v in bf16_paths.items()})
    # TEMPURA predcls and sgcls training reach no NMS; sgdet training's
    # detect launches it twice a train video, validation three times
    for mode in ("predcls", "sgcls"):
        launches[f"tempura {mode} train"] = ranked_launches[f"tempura {mode} train"] = \
            train[mode]["nms_launches"]
    launches["tempura sgdet train"] = train["sgdet"]["nms_launches"]
    # TEAT-GT predcls and sgcls training reach no NMS either; its sgdet
    # training launches as TEMPURA's does (the CLI's run: 2 per train video
    # with its probe, 3 per validation video)
    for mode in ("predcls", "sgcls"):
        launches[f"teatgt {mode} train"] = ranked_launches[f"teatgt {mode} train"] = \
            teatgt_train[mode]["nms_launches"] + teatgt_train[mode]["cli"]["nms_launches"]
    launches["teatgt sgdet train"] = (teatgt_train["sgdet"]["nms_launches"]
                                      + teatgt_train["sgdet"]["cli"]["nms_launches"])
    ranked_launches["tempura sgdet train"] = train["sgdet"]["nms_launches_by"].get("ranked", 0)
    ranked_launches["teatgt sgdet train"] = sum(
        run["nms_launches_by"].get("ranked", 0)
        for run in (teatgt_train["sgdet"], teatgt_train["sgdet"]["cli"]))

    def entry(name, replaces, call_names, launched, err, more_calls=()):
        sel = [timings[c] for c in call_names]
        return {
            "name": name,
            "route": "cuda",
            "source": "vidsgg_torch/ops/csrc/nms.cu",
            "replaces": replaces,
            "launches": sum(launched.values()),
            "launches_by_path": launched,
            "max_abs_err": err,
            # per served video: the sum over its calls (one launch each)
            "ms": sum(t["ms"] for t in sel),
            "plain_ms": sum(t["plain_ms"] for t in sel),
            "bound_ms": sum(t["bound_ms"] for t in sel),
            "bound_by": ("bytes" if all(t["bound_by"] == "bytes" for t in sel)
                         else "operations"),
            "library_ms": None,
            # per call; the bfloat16 grouped call replaces the float32 one in
            # bfloat16 serving, and is not in the sums above
            "calls": {c: timings[c] for c in (*call_names, *more_calls)},
        }

    kernels = [
        # K1: the RPN call, the class grid and the relation stage's grouped NMS
        entry("nms_tile", "vidsgg/ops/pallas_nms.py:206", ["rpn", "grid", "grouped"],
              launches, errs["k1"], more_calls=["grouped_bf16"]),
        # K2: its contract (ranking inside the call, no max_keep) is the grid call
        entry("nms_tile:ranked", "vidsgg/ops/pallas_nms.py:257", ["grid"],
              ranked_launches, errs["k2"]),
    ]
    log("[serve] " + json.dumps({"videos": rows, "peak_memory_bytes": peak,
                                 "frames": [FRAMES, H, W]}))
    for mode in GT_MODES:
        log(f"[serve {mode}] " + json.dumps(gt_runs[mode]))
    for mode in TEATGT_MODES:
        log(f"[teatgt {mode}] " + json.dumps(teatgt_runs[mode]))
    for build, run in bf16_runs.items():
        log(f"[bf16 {build}] " + json.dumps(run))
    log("[score] " + json.dumps(scores))
    for mode, run in train.items():
        log(f"[train {mode}] " + json.dumps(run))
    log("[train cli] " + json.dumps(train_cli))
    for mode, run in teatgt_train.items():
        log(f"[teatgt train {mode}] " + json.dumps(run))
    log("[node ids] " + json.dumps(node_ids))
    log("[phases] wall seconds: " + json.dumps(seconds))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                             "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
