"""TEAT-GT training CLI (the reference's TEATGT_train.py; the port's
counterpart of ``vidsgg/cli/teatgt_train.py``).

    python -m vidsgg_torch.cli.teatgt_train --mode predcls --data_path AG/ \\
        --use_cons_str_loss --use_cons_sem_loss --use_ctl_loss

Trains TEAT-GT in predcls, sgcls or sgdet on the Action Genome train
split (predcls and sgcls: GT boxes through the frozen detector; sgdet:
the detector's boxes, assigned to the GT, plus SUPPLY rows for the GT
boxes it missed; ``--model_path`` loads a jwyang Faster R-CNN checkpoint)
or on ``--synthetic N`` GT-box videos in every mode, validating on the
test split every epoch, and writes the port's checkpoints to
``--save_path`` (TEAT-GT reads no memory: the loop runs with memory off,
as ``vidsgg``'s, and the state's object bank is [36, 1024] in every mode,
as ``vidsgg``'s). ``--rand_node_id`` and ``--orf_node_id`` give TokenGT
random node identifiers. ``--resume DIR`` restores ``DIR/best_recall.pt``
(model, optimizer, step) first, as the port's ``tempura_train`` does. It
runs on the CUDA card, and raises without one; ``--device cpu`` runs on
the CPU. ``--data_parallel > 1``, ``--int8``, ``--profile`` and sgdet's
``--pair_detect > 1`` exit naming the ``ROADMAP.md`` item that brings
them.
"""

from __future__ import annotations

import os
import sys

import torch

from vidsgg_torch.cli import data_source
from vidsgg_torch.cli.flags import refuse_unported, take_flag
from vidsgg_torch.cli.teatgt_test import SYNTHETIC_CLIPS, ag_clip_caps
from vidsgg_torch.configs.teatgt import TeatGTRunConfig
from vidsgg_torch.data.action_genome import ActionGenome
from vidsgg_torch.data.entry import EntryCapacity
from vidsgg_torch.detector import SgdetCaps, SgdetFrontend
from vidsgg_torch.device import resolve_device
from vidsgg_torch.models import TeatGT
from vidsgg_torch.models.embeddings import word_vectors_available
from vidsgg_torch.models.noise import Noise
from vidsgg_torch.runtime.prefetch import prefetch
from vidsgg_torch.train import create_train_state
from vidsgg_torch.train.checkpoint import restore_checkpoint
from vidsgg_torch.train.loop import TrainLoopConfig, run_training
from vidsgg_torch.train.metrics import MetricsWriter
from vidsgg_torch.train.state import TEATGT_OBJ_DIM

SURFACE = "ROADMAP.md queue 1 item 7b"


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    device_flag = take_flag(argv, "--device")
    synthetic = take_flag(argv, "--synthetic", int, 0)
    resume = take_flag(argv, "--resume")
    profile_dir = take_flag(argv, "--profile")
    word_vectors = take_flag(argv, "--word_vectors")
    if word_vectors:  # models resolve the asset through the env var
        os.environ["VIDSGG_WORD_VECTORS"] = word_vectors
    cfg = TeatGTRunConfig.from_args(argv)
    refuse_unported("teatgt_train", [
        (cfg.data_parallel > 1, "--data_parallel", f"{SURFACE} (data-parallel training)"),
        (cfg.mode == "sgdet" and cfg.pair_detect > 1, "--pair_detect",
         f"{SURFACE} (paired sgdet training)"),
        (cfg.int8, "--int8", f"{SURFACE} (int8)"),
        (profile_dir is not None, "--profile", f"{SURFACE} (profiling)"),
    ])
    device = resolve_device(device_flag)
    print(f">>> TEAT-GT train: mode={cfg.mode} synthetic={synthetic or 'off'}")

    wv_ok, wv_path = word_vectors_available()
    if wv_ok:
        print(f"word vectors: {wv_path}")
    else:
        print("WARNING: no GloVe word-vector asset (--word_vectors / "
              "VIDSGG_WORD_VECTORS unset); label-embedding tables "
              "pseudo-init — from-scratch training differs from the "
              "reference's glove.6B.200d init")

    cap = EntryCapacity(max_frames=16, max_objs=48, max_pairs=32)
    clips = SYNTHETIC_CLIPS
    if synthetic:
        train_src = data_source.make_synthetic_source(synthetic, cap, seed=cfg.seed,
                                                      device=device)
        val_src = data_source.make_synthetic_source(max(4, synthetic // 4), cap,
                                                    seed=cfg.seed + 1, shuffle=False,
                                                    device=device)
        steps_per_epoch = synthetic
    else:
        # bucket the data pipeline; the clip buffers are sized for the
        # largest bucket
        buckets = data_source.default_buckets(max_frames=cfg.bucket_frames)
        cap = buckets[-1]
        clips = ag_clip_caps(cap.max_frames)
        train_ds = ActionGenome("train", cfg.datasize, cfg.data_path,
                                filter_small_box=cfg.mode != "predcls",
                                target_min_side=cfg.frame_size)
        test_ds = ActionGenome("test", cfg.datasize, cfg.data_path,
                               filter_small_box=cfg.mode != "predcls",
                               target_min_side=cfg.frame_size)
        det, canvases = data_source.build_detector(
            cfg.model_path, tiny=cfg.tiny_detector, frame_size=cfg.frame_size, device=device)
        if cfg.mode == "sgdet":
            # full-detection training: the detector's boxes, GT assignment
            # and SUPPLY, not the GT-box featurization
            frontend = SgdetFrontend(det, SgdetCaps(), cap, device=device)
            train_src = data_source.make_sgdet_source(train_ds, cap, frontend, is_train=True,
                                                      seed=cfg.seed, canvases=canvases)
            val_src = data_source.make_sgdet_source(test_ds, cap, frontend, shuffle=False,
                                                    canvases=canvases)
        else:
            train_src = data_source.make_ag_source(train_ds, buckets, det, seed=cfg.seed,
                                                   canvases=canvases)
            val_src = data_source.make_ag_source(test_ds, buckets, det, shuffle=False,
                                                 canvases=canvases)
        steps_per_epoch = len(train_ds)

    model = TeatGT(cfg.model_config(clips), device=device,
                   generator=torch.Generator().manual_seed(cfg.seed))
    # the schedule is epoch-indexed: one update per video on one device
    steps_per_epoch = max(1, steps_per_epoch)
    # vidsgg probes the first training video for its state's shapes; the
    # probe draws the source's first order (a shuffle), so the port makes
    # it too and every epoch sees vidsgg's order
    next(iter(train_src()))
    state = create_train_state(model, obj_dim=TEATGT_OBJ_DIM, base_lr=cfg.lr,
                               warmup_period=cfg.warmup, steps_per_epoch=steps_per_epoch)
    if resume:
        # restores the parameters, the optimizer and the step
        state = restore_checkpoint(resume, state, "best_recall")
        print(f"resumed from {resume} at step {int(state.step)}")
    train_src = prefetch(train_src, depth=2)
    writer = MetricsWriter(cfg.save_path)
    loop_cfg = TrainLoopConfig(mode=cfg.mode, nepoch=cfg.nepoch, log_iter=cfg.log_iter,
                               save_path=cfg.save_path, mem_enabled=False,
                               data_parallel=cfg.data_parallel)
    state = run_training(state, cfg.loss_flags(), loop_cfg, train_src, val_src, cap, writer,
                         Noise.seeded(cfg.seed + 1, device))
    writer.close()
    print(">>> TEAT-GT train complete")
    return state


if __name__ == "__main__":
    main()
