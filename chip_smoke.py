#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``vidsgg_torch``) on one card.

    python3 chip_smoke.py

Drives the port's main path, TEMPURA sgdet serving, at full width on the
CUDA card and fails (nonzero exit, no result line) on any fault:

1. device: name, count, ``nvidia-smi`` name and power limit; TF32 off;
2. build: compiles the NMS kernel (``vidsgg_torch/ops/csrc/nms.cu``) with
   nvcc and prints what ``-Xptxas -v`` says;
3. the kernel against its plain PyTorch version on the card, bit for bit:
   on the real RPN inputs of a served video (16 frames x 6000 presorted
   boxes, max_keep 100, IoU 0.7), on the (frame, class) grid [16, 36, 100]
   at 0.4, and on edge cases; then times both call shapes;
4. serving: the default ``tempura_test --mode sgdet`` configuration with
   seeded random weights (ResNet-101 + RPN 6000/100, 16 dets per frame,
   TEMPURA d=1936) answers one warm-up and three timed 16x608x1008 videos
   through ``SgdetFrontend`` -> ``EvalPipeline("sgdet")``; every video must
   launch the kernel exactly twice;
5. reference: a small configuration served on the card and on the CPU
   (plain kernels) in float64 must agree;
6. a ``kernels`` JSON line, then the result line.

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


def nms_bound_ms(keep_sorted: torch.Tensor, valid_sorted: torch.Tensor,
                 max_keep: int | None, presorted: bool) -> tuple[float, str, list]:
    """Least time for the work this call's data needs. Per problem, in rank
    order, only the first L boxes can change the result: L is one past the
    max_keep-th keep (all N without max_keep, or with fewer keeps).
    Bytes: the valid flags of those L boxes and the coordinates of the valid
    ones among them (the scores and flags of all N when the call must rank
    them), and the N-byte keep mask written once. Operations: each kept
    box's IoU with every later valid box below L. Returns (ms, what bounds
    it, L per problem)."""
    g, n = keep_sorted.shape
    pos = torch.arange(n, device=keep_sorted.device)
    if max_keep:
        hit = keep_sorted & (torch.cumsum(keep_sorted, 1) == max_keep)
        first_len = torch.where(hit, pos + 1, torch.full_like(pos, n)).min(1).values
    else:
        first_len = torch.full((g,), n, device=keep_sorted.device)
    inside = pos < first_len[:, None]
    v = valid_sorted & inside
    later_valid = v.sum(1, keepdim=True) - torch.cumsum(v, 1)
    ious = int((later_valid * (keep_sorted & inside)).sum())
    ranked = int(inside.sum()) if presorted else 5 * g * n
    nbytes = ranked + 16 * int(v.sum()) + g * n
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
    """Largest |kernel - plain| over the keep mask (0 or 1); raises on 1."""
    err = int((got.to(torch.int8) - want.to(torch.int8)).abs().max()) if got.numel() else 0
    if err or got.shape != want.shape:
        raise AssertionError(f"NMS kernel differs from the plain version: {what}")
    return err


def kernel_phase(det, frames0, hw):
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
    torch.cuda.synchronize()

    records = []
    max_err = 0
    # the RPN call: presorted, max_keep
    got = tnms.nms_mask_batched(rpn_b, top_scores, rpn_v, cfg.nms_thresh,
                                max_keep=cfg.post_nms_top_n, presorted=True)
    want = tnms.nms_mask_batched_plain(rpn_b, top_scores, rpn_v, cfg.nms_thresh,
                                       max_keep=cfg.post_nms_top_n, presorted=True)
    k = cfg.post_nms_top_n
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
    records.append(("rpn", got, rpn_v, rpn_b, top_scores, rpn_v,
                    dict(max_keep=k, presorted=True), cfg.nms_thresh))

    # the (frame, class) grid: not presorted, validity masks
    got = tnms.nms_mask_batched(grid_b, grid_s, grid_v, 0.4)
    want = tnms.nms_mask_batched_plain(grid_b, grid_s, grid_v, 0.4)
    max_err = max(max_err, mask_err(got, want, "class grid"))
    log(f"[kernel] class grid {tuple(grid_v.shape)} at 0.4: bit-equal, "
        f"{int(grid_v.sum())} valid, {int(got.sum())} kept")
    order = torch.sort(torch.where(grid_v, grid_s.float(), torch.finfo(torch.float32).min)
                       .reshape(-1, grid_v.shape[-1]), dim=1, descending=True,
                       stable=True).indices
    grid_sorted_keep = torch.gather(got.reshape(-1, grid_v.shape[-1]), 1, order)
    grid_sorted_valid = torch.gather(grid_v.reshape(-1, grid_v.shape[-1]), 1, order)
    records.append(("grid", grid_sorted_keep, grid_sorted_valid, grid_b, grid_s, grid_v,
                     {}, 0.4))

    # edge cases
    dev = rpn_b.device
    flat_grid = grid_b.reshape(-1, grid_b.shape[-2], 4)[:72].float().contiguous()
    same = torch.tensor([[0.0, 0.0, 10.0, 10.0]], device=dev).expand(1, 40, 4).contiguous()
    cases = {
        "all-invalid": (flat_grid, torch.zeros(flat_grid.shape[:2], dtype=torch.bool, device=dev)),
        "identical": (same, torch.ones((1, 40), dtype=torch.bool, device=dev)),
        "n=1": (rpn_b[:3, :1].contiguous(), torch.ones((3, 1), dtype=torch.bool, device=dev)),
        "n=257": (rpn_b[:4, :257].contiguous(), torch.rand((4, 257), device=dev) > 0.3),
    }
    for name, (b, v) in cases.items():
        s = torch.linspace(1.0, 0.0, b.shape[1], device=dev).expand(b.shape[0], -1)
        got = tnms.nms_mask_batched(b, s, v, 0.5)
        want = tnms.nms_mask_batched_plain(b, s, v, 0.5)
        max_err = max(max_err, mask_err(got, want, name))
        if name == "all-invalid" and got.any():
            raise AssertionError("all-invalid problem kept a box")
        if name == "identical" and int(got.sum()) != 1:
            raise AssertionError("identical boxes kept more than one")
    log(f"[kernel] edge cases bit-equal: {', '.join(cases)}")
    torch.cuda.synchronize()

    # times at both call shapes
    timings = {}
    for name, keep_sorted, valid_sorted, b, s, v, kw, thresh in records:
        ms = cuda_ms(lambda: tnms.nms_mask_batched(b, s, v, thresh, **kw), iters=20)
        plain_ms = cuda_ms(lambda: tnms.nms_mask_batched_plain(b, s, v, thresh, **kw),
                           iters=1, warmup=1)
        bound, bound_by, first_len = nms_bound_ms(keep_sorted, valid_sorted,
                                                  kw.get("max_keep"), kw.get("presorted", False))
        timings[name] = dict(shape=list(v.shape), ms=ms, plain_ms=plain_ms,
                             bound_ms=bound, bound_by=bound_by)
        log(f"[kernel] time {name} {list(v.shape)}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"bound {bound:.6f} ms ({bound_by}; ranks that matter per problem "
            f"{min(first_len)}-{max(first_len)})")
    return timings, max_err


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
        NMS_KERNEL.launches = 0
        t0 = time.perf_counter()
        entry, fmaps = front(frames, hw, 1.0, video_size=video_size)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pred = pipe(state, entry, fmaps)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = NMS_KERNEL.launches
        n, p = check_pred(pred, video_size)
        tag = "warm-up" if i == 0 else f"video {i}"
        log(f"[serve] {tag}: {1e3 * (t2 - t0):.1f} ms (detect {1e3 * (t1 - t0):.1f}, "
            f"relation {1e3 * (t2 - t1):.1f}), objects {n}, pairs {p}, "
            f"route {pipe.last_route}, nms launches {launches}")
        if launches != 2:
            raise AssertionError(f"{tag}: {launches} NMS kernel launches, want 2")
        if i > 0:
            rows.append(dict(ms=1e3 * (t2 - t0), detect_ms=1e3 * (t1 - t0),
                             relation_ms=1e3 * (t2 - t1), objects=n, pairs=p,
                             route=pipe.last_route, launches=launches))
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
        preds[dev] = pipe(create_serving_state(r), entry, fmaps)
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
    log(f"[reference] small float64 video: card (kernel) == CPU (plain) on every "
        f"discrete output ({len(b['pred_labels'])} objects, {len(b['pair_idx'])} pairs); "
        f"max float difference {worst:.3e}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs on the card only", file=sys.stderr)
        return 2
    name, count, _ = device_phase()
    build_phase()

    from vidsgg_torch.ops.nms import NMS_KERNEL

    t0 = time.perf_counter()
    det, rel = build_models()
    torch.cuda.synchronize()
    log(f"[models] FasterRCNN ResNet-101 (3, 4, 23) + head 3, RPN 6000/100@0.7; "
        f"TEMPURA {rel.cfg}; built and calibrated in {time.perf_counter() - t0:.1f} s")
    hw = (float(H), float(W))
    videos = [make_frames(100 + i, FRAMES, H, W, "cuda") for i in range(N_VIDEOS + 1)]

    timings, max_err = kernel_phase(det, videos[0], hw)
    rows, peak = serve_phase(det, rel, videos, hw)
    reference_phase()

    per_video = {k: sum(r[k] for r in rows) / len(rows) for k in ("ms", "detect_ms", "relation_ms")}
    log("[serve] mean over timed videos: " + json.dumps(per_video))
    launches = sum(r["launches"] for r in rows)
    kernel = {
        "name": "nms_scan",
        "route": "cuda",
        "source": "vidsgg_torch/ops/csrc/nms.cu",
        "replaces": "vidsgg/ops/pallas_nms.py:206",
        "launches": launches,
        "max_abs_err": max_err,
        # per served video: the RPN call plus the class-grid call
        "ms": timings["rpn"]["ms"] + timings["grid"]["ms"],
        "plain_ms": timings["rpn"]["plain_ms"] + timings["grid"]["plain_ms"],
        "bound_ms": timings["rpn"]["bound_ms"] + timings["grid"]["bound_ms"],
        "bound_by": ("bytes" if all(t["bound_by"] == "bytes" for t in timings.values())
                     else "operations"),
        "library_ms": None,
        "calls": timings,
    }
    NMS_KERNEL.launches = 0
    log("[serve] " + json.dumps({"videos": rows, "peak_memory_bytes": peak,
                                 "frames": [FRAMES, H, W]}))
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
