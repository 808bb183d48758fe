#!/usr/bin/env python3
"""Where one served sgdet video spends its time in the PyTorch/CUDA port.

    python3 scripts/profile_torch_sgdet.py [--videos N] [--model teatgt] [--bf16]

Builds the serving configuration of ``chip_smoke.py``
(``vidsgg_torch.serving_setup``: ResNet-101 Faster R-CNN + TEMPURA, or
TEAT-GT with ``--model teatgt``, seeded random weights, 16x608x1008
frames, float32, TF32 off; with ``--bf16`` the bfloat16 detector and the
bfloat16 relation stack, ``bench.py``'s serving precision) on the CUDA card,
serves one warm-up video, then traces N videos with ``torch.profiler`` and
prints, per video:

1. each stage: the ``vidsgg.*`` ranges the package opens around its stages,
   with the host time spent inside the range and the device time of the
   kernels launched from it;
2. the device time by kernel name, and the device's busy share (kernel
   time over wall time); the port's own NMS kernel on lines of its own;
3. the peak memory the backbone and the RPN head allocate beyond their
   input, from one direct call of each.

Prints one JSON line at the end. Needs one card; imports no JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vidsgg_torch.serving_setup import (  # noqa: E402
    FRAMES,
    H,
    W,
    bf16_detector,
    build_models,
    build_pipeline,
    build_teatgt,
    make_frames,
)

RANGE_PREFIX = "vidsgg."
OWN_KERNEL = "nms_tile_kernel"


def stage_times(events, videos: int) -> dict:
    """{range name: (host ms, device ms)} per video, in first-seen order."""
    out = collections.OrderedDict()
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith(RANGE_PREFIX):
            host, dev = out.get(e.name, (0.0, 0.0))
            out[e.name] = (host + e.cpu_time_total / 1e3, dev + e.device_time_total / 1e3)
    return {k: (h / videos, d / videos) for k, (h, d) in out.items()}


def kernel_times(events, videos: int) -> list:
    """[(kernel name, device ms per video, launches per video)], largest first."""
    agg = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith(RANGE_PREFIX):
            agg[e.name][0] += e.device_time_total / 1e3
            agg[e.name][1] += 1
    rows = [(k, ms / videos, n / videos) for k, (ms, n) in agg.items()]
    return sorted(rows, key=lambda r: -r[1])


def serve(front, pipe, state, frames):
    entry, fmaps = front(frames, (float(H), float(W)), 1.0, video_size=(float(W), float(H)))
    return pipe(state, entry, fmaps)


def peak_extra_bytes(fn, *args):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--videos", type=int, default=2, help="videos in the trace")
    ap.add_argument("--model", choices=("tempura", "teatgt"), default="tempura",
                    help="the relation model")
    ap.add_argument("--bf16", action="store_true",
                    help="the bfloat16 detector and relation stack")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[device] {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    det, rel = build_models()
    if args.model == "teatgt":
        rel = build_teatgt("sgdet", det.device)
    dtype = torch.bfloat16 if args.bf16 else None
    if args.bf16:
        det = bf16_detector(det)
    front, pipe, state = build_pipeline(det, rel, compute_dtype=dtype)
    videos = [make_frames(100 + i, FRAMES, H, W, "cuda") for i in range(args.videos + 1)]
    serve(front, pipe, state, videos[0])  # warm-up
    torch.cuda.synchronize()

    with torch.inference_mode():
        base, backbone_peak = peak_extra_bytes(det.base_features, videos[0])
        _, rpn_peak = peak_extra_bytes(det.RCNN_rpn, base)
        del base
    print(f"[memory] peak beyond input: backbone {backbone_peak} bytes, "
          f"RPN head {rpn_peak} bytes", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for frames in videos[1:]:
            serve(front, pipe, state, frames)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / args.videos
    events = prof.events()
    stages = stage_times(events, args.videos)
    kernels = kernel_times(events, args.videos)
    device_ms = sum(ms for _, ms, _ in kernels)
    print(f"[trace] per video: wall {wall_ms:.1f} ms, device kernel time {device_ms:.1f} ms, "
          f"busy share {device_ms / wall_ms:.3f}", flush=True)
    for name, (host, dev) in stages.items():
        print(f"[stage] host {host:9.2f} ms  device {dev:9.2f} ms  {name}", flush=True)
    for name, ms, count in kernels[:15]:
        print(f"[kernel] {ms:9.3f} ms  x{count:<7g} {name[:110]}", flush=True)
    # the port's own kernels are launched through ctypes, outside the
    # dispatcher, so the stage ranges above do not count their device time
    own = [(k, ms, c) for k, ms, c in kernels if OWN_KERNEL in k]
    for name, ms, count in own:
        print(f"[own kernel] {ms:9.4f} ms  x{count:<7g} {name[:110]}", flush=True)
    print(json.dumps({
        "device": smi, "model": args.model, "bf16": args.bf16, "videos": args.videos,
        "wall_ms": wall_ms,
        "device_kernel_ms": device_ms, "busy_share": device_ms / wall_ms,
        "stages_ms": {k: dict(host=h, device=d) for k, (h, d) in stages.items()},
        "top_kernels": [dict(name=k[:200], ms=ms, count=c) for k, ms, c in kernels[:15]],
        "own_kernels": [dict(name=k[:200], ms=ms, count=c) for k, ms, c in own],
        "peak_extra_bytes": {"backbone": backbone_peak, "rpn_head": rpn_peak},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
