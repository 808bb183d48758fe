"""TEMPURA evaluation CLI (the reference's TEMPURA_test.py; the port's
counterpart of ``vidsgg/cli/tempura_test.py``).

    python -m vidsgg_torch.cli.tempura_test --mode sgdet --data_path AG/

Runs the Action Genome test split (or ``--synthetic N`` videos) through the
mode-aware EvalPipeline and prints the full R@K/mR@K grid under the three
constraint regimes plus the temporal-consistency score. It runs on the CUDA
card, and raises without one; ``--device cpu`` runs the plain CPU versions.
NOTE: the reference test scripts truncate after 10 videos (``if b >= 10:
break``, TEMPURA_test.py:72) — full-split evaluation here is the default;
pass --max_videos 10 to reproduce the truncation.

``--max_videos``, ``--pair_detect`` and ``--data_parallel`` behave as in
``vidsgg`` wherever it serves on one device (the same NOTEs); paired or
sharded sgdet serving, and the other flags whose machinery is not ported
yet, exit with a message naming the ``ROADMAP.md`` item that brings it.
``--bf16`` serves the relation stack in bfloat16 (``EvalPipeline(
compute_dtype=torch.bfloat16)``) behind the float32 detector, as
``vidsgg``'s does. ``--ckpt DIR [--ckpt_name NAME]`` serves the model and
both memory banks of ``DIR/NAME.pt`` (default ``best_recall``), a
checkpoint of the port's train CLI.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from vidsgg_torch.cli import data_source
from vidsgg_torch.cli.flags import refuse_unported, take_flag, take_switch
from vidsgg_torch.configs.tempura import TempuraRunConfig
from vidsgg_torch.data.action_genome import ActionGenome
from vidsgg_torch.data.entry import EntryCapacity
from vidsgg_torch.detector import SgdetCaps, SgdetFrontend
from vidsgg_torch.device import resolve_device
from vidsgg_torch.eval import (
    evaluate_temporal_consistency,
    get_ag_evaluators,
    temporal_consistency_summary,
)
from vidsgg_torch.models import Tempura
from vidsgg_torch.train import EvalPipeline, ServingState, create_serving_state
from vidsgg_torch.train.checkpoint import load_payload, restore_serving

SURFACE = "ROADMAP.md queue 1 item 7b"


def build_relation_state(cfg: TempuraRunConfig, device) -> ServingState:
    """TEMPURA for ``cfg`` with random weights from seed 0 and empty memory
    banks (``--ckpt`` then restores a checkpoint into it)."""
    model = Tempura(cfg.model_config(), device=device,
                    generator=torch.Generator().manual_seed(0))
    return create_serving_state(model)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    device_flag = take_flag(argv, "--device")
    bf16 = take_switch(argv, "--bf16")
    synthetic = take_flag(argv, "--synthetic", int, 0)
    max_videos = take_flag(argv, "--max_videos", int)
    ckpt = take_flag(argv, "--ckpt")
    ckpt_name = take_flag(argv, "--ckpt_name", str, "best_recall")
    profile_dir = take_flag(argv, "--profile")
    cfg = TempuraRunConfig.from_args(argv)
    refuse_unported("tempura_test", [
        (cfg.int8, "--int8", f"{SURFACE} (int8 serving)"),
        (profile_dir is not None, "--profile", f"{SURFACE} (profiling)"),
    ])
    device = resolve_device(device_flag)
    data_source.resolve_serving_flags(cfg, max_videos, device, "tempura_test")
    print(f">>> TEMPURA test: mode={cfg.mode}")

    cap = EntryCapacity(max_frames=16, max_objs=48, max_pairs=32)
    if synthetic:
        src = data_source.make_synthetic_source(synthetic, cap, seed=99, shuffle=False,
                                                  stable=True, device=device)
    else:
        buckets = data_source.default_buckets(max_frames=cfg.bucket_frames)
        cap = buckets[-1]
        ds = ActionGenome("test", cfg.datasize, cfg.data_path,
                          filter_small_box=cfg.mode != "predcls",
                          target_min_side=cfg.frame_size)
        det, canvases = data_source.build_detector(
            cfg.model_path, tiny=cfg.tiny_detector, frame_size=cfg.frame_size, device=device)
        if cfg.mode == "sgdet":
            frontend = SgdetFrontend(det, SgdetCaps(), cap, device=device)
            src = data_source.make_sgdet_source(ds, cap, frontend, shuffle=False,
                                                max_videos=max_videos,
                                                canvases=canvases)
        else:
            src = data_source.make_ag_source(ds, buckets, det, shuffle=False,
                                             max_videos=max_videos,
                                             canvases=canvases)

    state = build_relation_state(cfg, device)
    if ckpt:
        state = restore_serving(state, load_payload(ckpt, ckpt_name, device))
        print(f"restored checkpoint {ckpt_name} from {ckpt} (incl. memory banks)")
    # one pipeline at the largest bucket serves every bucket: its stages
    # take their sizes from the entry they are given. sgdet's device
    # postprocess doubles the object axis, so pairs per frame are bounded
    # by 2 * dets_per_frame = 32 (the grouped union pooling).
    pipeline = EvalPipeline(cfg.mode, cap, union_pairs_per_frame=32, device=device,
                            compute_dtype=torch.bfloat16 if bf16 else None)
    # per-class recall pickles land in output_path (the reference dumps
    # them from print_stats, evaluation_recall.py:79-83)
    evs = get_ag_evaluators(cfg.mode, output_dir=cfg.output_path)
    tc_s, tc_c = [], []
    t0 = time.time()
    n = 0
    for entry, fmaps, gt in src():
        if max_videos is not None and n >= max_videos:
            break
        pred = pipeline(state, entry, fmaps, gt_entry=entry)
        for ev in evs:
            ev.evaluate_scene_graph(gt, pred)
        if cfg.mode != "sgdet":
            s, c = evaluate_temporal_consistency(pred, cfg.mode)
            if s is not None:
                tc_s.extend(s)
                tc_c.extend(c)
        n += 1
    dt = time.time() - t0
    print(f"evaluated {n} videos in {dt:.3f}s")
    for name, ev in zip(("with", "semi", "no"), evs):
        ev.print_stats(metric=name)
    if tc_s:
        tc = temporal_consistency_summary(np.array(tc_s), np.array(tc_c))
        print(
            f"Temporal Consistency: spatial={tc['spatial']:.4f} "
            f"contacting={tc['contacting']:.4f} combined={tc['combined']:.4f}"
        )
    return evs


if __name__ == "__main__":
    main()
