"""TEAT-GT evaluation CLI (the reference's TEATGT_test.py; the port's
counterpart of ``vidsgg/cli/teatgt_test.py``).

    python -m vidsgg_torch.cli.teatgt_test --mode predcls --data_path AG/

Runs the Action Genome test split (or ``--synthetic N`` videos) through
``EvalPipeline(mode, cap, needs_union=False)`` and prints the R@K/mR@K grid
under the three constraint regimes plus the temporal-consistency score. It
runs on the CUDA card, and raises without one; ``--device cpu`` runs the
plain CPU versions. The reference's 10-video truncation is opt-in via
``--max_videos``. ``--rand_node_id`` and ``--orf_node_id`` give TokenGT
random node identifiers (drawn from a fixed torch seed: not ``vidsgg``'s
values). ``--ckpt DIR [--ckpt_name NAME]`` serves the model of a
``teatgt_train`` checkpoint (``DIR/NAME.pt``, ``best_recall`` by default);
give it the run's model flags (``--use_cons_*_loss`` among them: the
regularizer's parameters are part of the checkpoint).

``--max_videos``, ``--pair_detect`` and ``--data_parallel`` behave as in
``vidsgg`` wherever it serves on one device; paired or sharded sgdet
serving, and the other flags whose machinery is not ported yet, exit with a
message naming the ``ROADMAP.md`` item that brings it.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from vidsgg_torch.cli import data_source
from vidsgg_torch.cli.flags import refuse_unported, take_flag
from vidsgg_torch.configs.teatgt import TeatGTRunConfig
from vidsgg_torch.data.action_genome import ActionGenome
from vidsgg_torch.data.entry import EntryCapacity
from vidsgg_torch.detector import SgdetCaps, SgdetFrontend
from vidsgg_torch.device import resolve_device
from vidsgg_torch.eval import (
    evaluate_temporal_consistency,
    get_ag_evaluators,
    temporal_consistency_summary,
)
from vidsgg_torch.models import TeatGT
from vidsgg_torch.models.graph_build import ClipCaps
from vidsgg_torch.train import EvalPipeline, ServingState, create_serving_state
from vidsgg_torch.train.checkpoint import load_payload, restore_serving
from vidsgg_torch.train.state import TEATGT_OBJ_DIM

SURFACE = "ROADMAP.md queue 1 item 7b"


# clip capacities: the synthetic source's videos (6 frames of 3 tokens)
SYNTHETIC_CLIPS = ClipCaps(clip_size=5, n_clips=4, tokens_per_clip=32, edges_per_clip=160,
                           tokens_per_frame=8)


def ag_clip_caps(max_frames: int) -> ClipCaps:
    """Clip capacities for an Action Genome bucket of ``max_frames``: 5-frame
    clips of up to 8 tokens a frame."""
    return ClipCaps(clip_size=5, n_clips=-(-max_frames // 5), tokens_per_clip=5 * 8,
                    edges_per_clip=320, tokens_per_frame=8)


def build_relation_state(cfg: TeatGTRunConfig, clips: ClipCaps, device) -> ServingState:
    """TEAT-GT for ``cfg`` with random weights from seed 0 and ``vidsgg``'s
    [36, 1024] object bank (``--ckpt`` then restores a checkpoint into
    it)."""
    model = TeatGT(cfg.model_config(clips), device=device,
                   generator=torch.Generator().manual_seed(0))
    return create_serving_state(model, obj_dim=TEATGT_OBJ_DIM)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    device_flag = take_flag(argv, "--device")
    synthetic = take_flag(argv, "--synthetic", int, 0)
    max_videos = take_flag(argv, "--max_videos", int)
    ckpt = take_flag(argv, "--ckpt")
    ckpt_name = take_flag(argv, "--ckpt_name", str, "best_recall")
    profile_dir = take_flag(argv, "--profile")
    cfg = TeatGTRunConfig.from_args(argv)
    refuse_unported("teatgt_test", [
        (cfg.int8, "--int8", f"{SURFACE} (int8 serving)"),
        (profile_dir is not None, "--profile", f"{SURFACE} (profiling)"),
    ])
    device = resolve_device(device_flag)
    data_source.resolve_serving_flags(cfg, max_videos, device, "teatgt_test")
    print(f">>> TEAT-GT test: mode={cfg.mode}")

    cap = EntryCapacity(max_frames=16, max_objs=48, max_pairs=32)
    clips = SYNTHETIC_CLIPS
    if synthetic:
        src = data_source.make_synthetic_source(synthetic, cap, seed=99, shuffle=False,
                                                  stable=True, device=device)
    else:
        buckets = data_source.default_buckets(max_frames=cfg.bucket_frames)
        cap = buckets[-1]
        clips = ag_clip_caps(cap.max_frames)
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

    state = build_relation_state(cfg, clips, device)
    if ckpt:
        state = restore_serving(state, load_payload(ckpt, ckpt_name, device))
    pipeline = EvalPipeline(cfg.mode, cap, needs_union=False, device=device)
    evs = get_ag_evaluators(cfg.mode)
    tc_s, tc_c = [], []
    t0, n = time.time(), 0
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
    print(f"evaluated {n} videos in {time.time() - t0:.3f}s")
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
