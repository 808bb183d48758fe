#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``vidsgg_torch``) on one card.

    python3 chip_smoke.py

Drives the port's main path, TEMPURA sgdet serving, at full width on the
CUDA card and fails (nonzero exit, no result line) on any fault:

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
5. reference: a small configuration served on the card (its grouped NMS
   through the kernel's float64 instantiation) and on the CPU (plain
   versions) in float64 must agree;
6. a ``kernels`` JSON line (K1 and K2), then the result line.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

from vidsgg_torch.serving_setup import (
    FRAMES,
    H,
    W,
    build_models,
    build_pipeline,
    calibrate_random_heads,
    make_frames,
)

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12         # float32 outside the tensor cores
IOU_FLOPS = 14                  # min/max x4, 4 add/sub, 2 max, mul, add, sub, div (+ compare)
N_VIDEOS = 3
# NMS kernel launches of one served video, by call contract: the RPN
# proposal NMS, the (frame, class) grid, the relation stage's grouped NMS
PATH_LAUNCHES = {"presorted": 1, "ranked": 1, "grouped": 1}


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


def grouped_inputs(det, rel, frames0, hw):
    """The grouped NMS's inputs on a served video, through the public
    functions the pipeline calls: frontend -> OSPU classify -> clean_class
    -> (boxes4 [512, 4], scores, group, valid)."""
    from vidsgg_torch.models.postprocess_device import clean_class_objects, nms_problem

    front, _, state = build_pipeline(det, rel)
    with torch.inference_mode():
        entry, _ = front(frames0, hw, 1.0, video_size=(float(W), float(H)))
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
    rows = []
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
    peak = torch.cuda.max_memory_allocated()
    log(f"[serve] peak memory allocated {peak} bytes ({peak / 2**30:.2f} GiB)")
    return rows, peak


def reference_phase():
    """A small configuration, float64, served on the card (the kernel) and
    on the CPU (the plain versions) from the same weights: discrete outputs
    must be equal, floats close."""
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
    preds = {}
    for dev in ("cpu", "cuda"):
        d = det if dev == "cpu" else copy.deepcopy(det).to(dev)
        r = rel if dev == "cpu" else copy.deepcopy(rel).to(dev)
        front = SgdetFrontend(d, SgdetCaps(dets_per_frame=dets), cap, device=dev)
        entry, fmaps = front(frames.to(dev), (float(h), float(w)), 1.0,
                             video_size=(float(w), float(h)))
        pipe = EvalPipeline("sgdet", cap, union_pairs_per_frame=2 * dets, device=dev)
        NMS_KERNEL.reset_counts()
        preds[dev] = pipe(create_serving_state(r), entry, fmaps)
    # the card's run went through the kernel: the float64 grouped call too
    if NMS_KERNEL.launches_by != {"grouped": 1}:
        raise AssertionError(f"reference pipeline NMS launches {NMS_KERNEL.launches_by}")
    a, b = preds["cuda"], preds["cpu"]
    for key in ("labels", "im_idx", "pair_idx", "pred_labels"):
        if not np.array_equal(a[key], b[key]):
            raise AssertionError(f"card and CPU disagree on {key}")
    worst = 0.0
    for key in ("boxes", "pred_scores", "attention_distribution",
                "spatial_distribution", "contacting_distribution"):
        ref = np.abs(b[key]).max() if b[key].size else 0.0
        err = float(np.abs(a[key] - b[key]).max()) if b[key].size else 0.0
        if err > 1e-5 * max(1.0, ref):
            raise AssertionError(f"card and CPU differ on {key} by {err}")
        worst = max(worst, err)
    if len(b["pair_idx"]) == 0:
        raise AssertionError("reference video produced no pairs")
    log(f"[reference] small float64 video: card (kernel, float64 grouped NMS) == CPU "
        f"(plain) on every "
        f"discrete output ({len(b['pred_labels'])} objects, {len(b['pair_idx'])} pairs); "
        f"max float difference {worst:.3e}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs on the card only", file=sys.stderr)
        return 2
    name, count, _ = device_phase()
    build_phase()

    t0 = time.perf_counter()
    det, rel = build_models()
    torch.cuda.synchronize()
    log(f"[models] FasterRCNN ResNet-101 (3, 4, 23) + head 3, RPN 6000/100@0.7; "
        f"TEMPURA {rel.cfg}; built and calibrated in {time.perf_counter() - t0:.1f} s")
    hw = (float(H), float(W))
    videos = [make_frames(100 + i, FRAMES, H, W, "cuda") for i in range(N_VIDEOS + 1)]

    timings, errs = kernel_phase(det, rel, videos[0], hw)
    rows, peak = serve_phase(det, rel, videos, hw)
    reference_phase()

    per_video = {k: sum(r[k] for r in rows) / len(rows) for k in ("ms", "detect_ms", "relation_ms")}
    log("[serve] mean over timed videos: " + json.dumps(per_video))
    launches = sum(r["launches"] for r in rows)
    ranked_launches = sum(r["launches_by"].get("ranked", 0) for r in rows)

    def entry(name, replaces, call_names, launched, err):
        sel = [timings[c] for c in call_names]
        return {
            "name": name,
            "route": "cuda",
            "source": "vidsgg_torch/ops/csrc/nms.cu",
            "replaces": replaces,
            "launches": launched,
            "max_abs_err": err,
            # per served video: the sum over its calls (one launch each)
            "ms": sum(t["ms"] for t in sel),
            "plain_ms": sum(t["plain_ms"] for t in sel),
            "bound_ms": sum(t["bound_ms"] for t in sel),
            "bound_by": ("bytes" if all(t["bound_by"] == "bytes" for t in sel)
                         else "operations"),
            "library_ms": None,
            "calls": {c: timings[c] for c in call_names},
        }

    kernels = [
        # K1: the RPN call, the class grid and the relation stage's grouped NMS
        entry("nms_tile", "vidsgg/ops/pallas_nms.py:206", ["rpn", "grid", "grouped"],
              launches, errs["k1"]),
        # K2: its contract (ranking inside the call, no max_keep) is the grid call
        entry("nms_tile:ranked", "vidsgg/ops/pallas_nms.py:257", ["grid"],
              ranked_launches, errs["k2"]),
    ]
    log("[serve] " + json.dumps({"videos": rows, "peak_memory_bytes": peak,
                                 "frames": [FRAMES, H, W]}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
