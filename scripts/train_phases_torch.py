#!/usr/bin/env python3
"""The training phases of ``chip_smoke.py`` alone, on one CUDA card.

    python3 scripts/train_phases_torch.py [sgdet] [sgcls] [predcls] [cli] [teatgt]
        [teatgt-sgcls] [teatgt-sgdet] [node-ids]

Runs the device and build phases, builds the calibrated ResNet-101
detector of the serving configuration, then the named training phases
(all eight by default, in this order): ``sgdet_train_phase`` (TEMPURA
sgdet through the train frontend), ``train_phase`` in sgcls and in
predcls, ``train_cli_phase`` (``tempura_train``, ``--resume`` and
``tempura_test --ckpt`` in all three modes), ``teatgt_train_phase`` in
predcls, sgcls and sgdet (TEAT-GT training, then ``teatgt_train``,
``--resume`` and ``teatgt_test --ckpt`` in the mode) and
``node_id_phase`` (random node identifiers and the Performer). Each phase makes its own checks, as in
``chip_smoke.py``; its time and JSON result are printed after it. Needs
one card; imports no JAX.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        print("train_phases_torch: no CUDA device", file=sys.stderr)
        return 2
    cs.device_phase()
    cs.build_phase()
    t0 = time.perf_counter()
    det, rel = cs.build_models()
    del rel
    torch.cuda.empty_cache()
    cs.log(f"[models] built in {time.perf_counter() - t0:.1f} s")
    phases = {"sgdet": lambda: cs.sgdet_train_phase(det),
              "sgcls": lambda: cs.train_phase(det, "sgcls"),
              "predcls": lambda: cs.train_phase(det, "predcls"),
              "cli": lambda: cs.train_cli_phase(det),
              "teatgt": lambda: cs.teatgt_train_phase(det),
              "teatgt-sgcls": lambda: cs.teatgt_train_phase(det, "sgcls"),
              "teatgt-sgdet": lambda: cs.teatgt_train_phase(det, "sgdet"),
              "node-ids": lambda: cs.node_id_phase(det)}
    for name in argv or list(phases):
        t0 = time.perf_counter()
        out = phases[name]()
        cs.log(f"[phase {name}] {time.perf_counter() - t0:.1f} s")
        cs.log(f"[phase {name} result] " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
