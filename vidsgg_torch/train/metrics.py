"""Metrics and logging (counterpart of ``vidsgg/train/metrics.py``).

Replaces the reference's TensorBoard writers and plain-text logs
(TEMPURA_train.py:119-128, env.py:15-36): a JSONL scalar stream (machine
readable, survives without TensorBoard) plus the same ``log_train.txt`` /
``log_val.txt`` text logs; TensorBoard is attached when importable. Scalar
names follow the reference layout (att_loss, spatial_loss, contact_loss,
total_loss, R@K / MR@K, lr).
"""

from __future__ import annotations

import json
import os
import time


class MetricsWriter:
    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self._jsonl = open(os.path.join(out_dir, "metrics.jsonl"), "a")
        self.log_train = open(os.path.join(out_dir, "log_train.txt"), "a")
        self.log_val = open(os.path.join(out_dir, "log_val.txt"), "a")
        self._tb = None
        try:  # optional TensorBoard
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(os.path.join(out_dir, "tb"))
        except Exception:
            pass

    def scalar(self, name: str, value: float, step: int):
        self._jsonl.write(
            json.dumps(
                {"t": time.time(), "name": name, "value": float(value), "step": step}
            )
            + "\n"
        )
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(name, float(value), step)

    def scalars(self, values: dict, step: int):
        for k, v in values.items():
            self.scalar(k, v, step)

    def text(self, line: str, val: bool = False):
        f = self.log_val if val else self.log_train
        f.write(line + "\n")
        f.flush()
        print(line, flush=True)

    def close(self):
        self._jsonl.close()
        self.log_train.close()
        self.log_val.close()
        if self._tb is not None:
            self._tb.close()
