"""Epoch-level training on one device (counterpart of
``vidsgg/train/loop.py``; the reference's skeleton, TEMPURA_train.py:132-379).

* per video: one train step (:func:`~vidsgg_torch.train.steps.make_train_step`);
  with memory enabled, one test-phase ``unc=True`` forward whose outputs
  fold into the device-resident memory accumulator;
* per epoch: validation through ``EvalPipeline(mode)`` and the three
  evaluators plus the temporal score; checkpoints every 5 epochs and on the
  best R@20 / mR@20; then the epoch-end memory banks go into the state (so
  an epoch's checkpoints hold the banks of the epoch before, as the
  reference's do); ``checkpoint_final`` after the last epoch.

The metrics stay on the device: one batched transfer per log window of
``log_iter`` steps, as ``vidsgg``'s. The log lines are ``vidsgg``'s. One
device only: ``data_parallel > 1`` exits naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable, Iterable

import numpy as np
import torch
from torch.profiler import record_function

from vidsgg_torch.data.entry import EntryCapacity
from vidsgg_torch.debias import MemoryAccumulator, accumulate_memory, finalize_memory
from vidsgg_torch.eval import (
    evaluate_temporal_consistency,
    get_ag_evaluators,
    temporal_consistency_summary,
)
from vidsgg_torch.train.checkpoint import save_checkpoint
from vidsgg_torch.train.eval_pipeline import EvalPipeline
from vidsgg_torch.train.metrics import MetricsWriter
from vidsgg_torch.train.state import TrainState
from vidsgg_torch.train.steps import LossFlags, eval_step, make_train_step

DATA_PARALLEL = "ROADMAP.md queue 1 item 7b (data-parallel training)"


class MetricWindow(list):
    """Sliding window of per-step metric dicts (device scalars), bounded to
    the last ``size`` entries: only those are read at log time."""

    def __init__(self, size: int):
        super().__init__()
        self.size = max(int(size), 1)

    def push(self, metrics: dict):
        self.append(metrics)
        del self[: -self.size]


@dataclasses.dataclass
class TrainLoopConfig:
    mode: str = "predcls"
    nepoch: int = 10
    log_iter: int = 100
    save_path: str = "checkpoint/"
    rel_mem_weight_type: str = "simple"
    obj_mem_weight_type: str = "simple"
    obj_mem_compute: bool = False
    mem_enabled: bool = True
    compute_temporal_consistency: bool = True
    data_parallel: int = 1


def fetch_window(window: list[dict]) -> list[dict]:
    """The window's metrics on the host, in one transfer."""
    keys = list(window[-1])
    host = torch.stack([torch.stack([m[k] for k in keys]) for m in window]).cpu().numpy()
    return [dict(zip(keys, row)) for row in host]


def run_training(
    state: TrainState,
    flags: LossFlags,
    loop_cfg: TrainLoopConfig,
    train_data: Callable[[], Iterable],
    val_data: Callable[[], Iterable],
    cap: EntryCapacity,
    writer: MetricsWriter,
    noise,
) -> TrainState:
    """``train_data``/``val_data``: factories of (entry, fmaps, gt) streams;
    ``noise``: the run's noise source (``models/noise.py``). The object
    memory's accumulator takes the width of the state's object bank."""
    if loop_cfg.data_parallel > 1:
        sys.exit(f"--data_parallel {loop_cfg.data_parallel}: data-parallel training is "
                 f"not ported to vidsgg_torch yet: {DATA_PARALLEL}")
    device = state.rel_memory.device
    train_step = make_train_step(flags)
    pipeline = EvalPipeline(loop_cfg.mode, cap, device=device)
    best_recall, best_mrecall = 0.0, 0.0
    obj_dim = state.obj_memory.shape[-1]

    step_i = 0
    for epoch in range(loop_cfg.nepoch):
        acc = MemoryAccumulator.zeros(obj_dim=obj_dim, dtype=state.rel_memory.dtype,
                                      device=device)
        window = MetricWindow(loop_cfg.log_iter)
        videos_seen = 0
        t0 = time.time()

        for entry, _fmaps, _gt in train_data():
            with record_function("vidsgg.train_step"):
                metrics = train_step(state, entry, noise)
            if loop_cfg.mem_enabled:
                with record_function("vidsgg.memory_fold"), torch.no_grad():
                    out_unc = eval_step(state, entry, True)
                    acc = accumulate_memory(acc, entry, out_unc, loop_cfg.rel_mem_weight_type,
                                            loop_cfg.obj_mem_weight_type,
                                            loop_cfg.obj_mem_compute)
            window.push(metrics)
            step_i += 1
            videos_seen += 1
            if step_i % loop_cfg.log_iter == 0:
                recent = fetch_window(window[-loop_cfg.log_iter:])
                mean = {k: float(np.mean([w[k] for w in recent])) for k in recent[-1]}
                dt = (time.time() - t0) / max(videos_seen, 1)
                writer.text(
                    f"epoch {epoch} step {step_i}  {dt:.3f}s/video  "
                    + "  ".join(f"{k}={v:.4f}" for k, v in mean.items())
                )
                writer.scalars(
                    {
                        "att_loss": mean.get("attention_relation_loss", 0.0),
                        "spatial_loss": mean.get("spatial_relation_loss", 0.0),
                        "contact_loss": mean.get("contacting_relation_loss", 0.0),
                        "total_loss": mean.get("total_loss", 0.0),
                    },
                    step_i,
                )

        # skip accounting (over-capacity videos dropped by the source)
        stats = getattr(train_data, "stats", None)
        if stats is not None and (stats.yielded or stats.skipped):
            writer.scalar("skipped_videos", stats.skipped, epoch)
            writer.scalar("skip_rate", stats.skip_rate, epoch)
            if stats.bucket_counts:
                writer.text(
                    f"epoch {epoch} buckets: "
                    + ", ".join(f"{k}f={v}" for k, v in sorted(stats.bucket_counts.items()))
                    + f"  skipped={stats.skipped}"
                )

        # ---- validation ----
        ev_with, ev_semi, ev_no = get_ag_evaluators(loop_cfg.mode)
        tc_s, tc_c = [], []
        with record_function("vidsgg.validation"):
            for entry, fmaps, gt in val_data():
                pred = pipeline(state, entry, fmaps, gt_entry=entry)
                for ev in (ev_with, ev_semi, ev_no):
                    ev.evaluate_scene_graph(gt, pred)
                if loop_cfg.compute_temporal_consistency and loop_cfg.mode != "sgdet":
                    s, c = evaluate_temporal_consistency(pred, loop_cfg.mode)
                    if s is not None:
                        tc_s.extend(s)
                        tc_c.extend(c)
        recall = ev_with.recall_at(20)
        mrecall = ev_with.calc_mrecall()[20]
        writer.text(
            f"epoch {epoch} val: R@20={recall:.4f} mR@20={mrecall:.4f} "
            f"(semi R@20={ev_semi.recall_at(20):.4f}, no R@20={ev_no.recall_at(20):.4f})",
            val=True,
        )
        for name, ev in (("with", ev_with), ("semi", ev_semi), ("no", ev_no)):
            for k in ev.KS:
                writer.scalar(f"{name}_R@{k}", ev.recall_at(k), epoch)
                writer.scalar(f"{name}_MR@{k}", ev.mean_recall_at(k), epoch)
        if tc_s:
            tc = temporal_consistency_summary(np.array(tc_s), np.array(tc_c))
            writer.scalar("temporal_consistency", tc["combined"], epoch)

        # ---- checkpoints (every 5 epochs + best R/mR, ref :296-349) ----
        if epoch % 5 == 0:
            save_checkpoint(loop_cfg.save_path, state, f"checkpoint_{epoch}")
        if recall > best_recall:
            best_recall = recall
            writer.text(f"new best recall {recall:.4f} at epoch {epoch}", val=True)
            save_checkpoint(loop_cfg.save_path, state, "best_recall")
        if mrecall > best_mrecall:
            best_mrecall = mrecall
            writer.text(f"new best Mrecall {mrecall:.4f} at epoch {epoch}", val=True)
            save_checkpoint(loop_cfg.save_path, state, "best_Mrecall")

        # ---- epoch-end memory computation (ref :360-379) ----
        if loop_cfg.mem_enabled:
            with record_function("vidsgg.memory_finalize"):
                rel_mem, obj_mem = finalize_memory(acc, loop_cfg.rel_mem_weight_type,
                                                   loop_cfg.obj_mem_weight_type)
            state = state.with_memory(rel_mem, obj_mem)

    # the reference computes the banks after its epoch checkpoints, so the
    # last epoch's banks are on no checkpoint of its; persist them here
    save_checkpoint(loop_cfg.save_path, state, "checkpoint_final")
    return state
