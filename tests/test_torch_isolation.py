"""The port stands alone: ``vidsgg_torch`` and ``chip_smoke.py`` import
neither JAX, Flax nor ``vidsgg``, and entry points default to the CUDA card
(raising without one) unless the caller asks for the CPU."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "vidsgg")

_IMPORT_ALL = f"""
import pkgutil, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None            # any import of these now raises
import vidsgg_torch
mods = [m.name for m in pkgutil.walk_packages(vidsgg_torch.__path__, "vidsgg_torch.")]
for m in mods:
    __import__(m)
import chip_smoke
leaked = sorted(k for k in sys.modules if k.split(".")[0] in {BLOCKED!r}
                and sys.modules[k] is not None)
assert not leaked, leaked
print(len(mods))
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_every_module_imports_without_jax_or_vidsgg():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 20


def test_no_source_line_imports_jax_or_vidsgg():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|vidsgg)\b", re.M)
    files = sorted((REPO / "vidsgg_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = [str(f.relative_to(REPO)) for f in files if pattern.search(f.read_text())]
    assert not bad


def test_entry_points_default_to_the_card():
    from vidsgg_torch.data.entry import Entry, EntryCapacity
    from vidsgg_torch.detector import FasterRCNN, RPNConfig, SgdetCaps, SgdetFrontend
    from vidsgg_torch.models import Tempura, TempuraConfig
    from vidsgg_torch.train import EvalPipeline

    cap = EntryCapacity(2, 4, 4)
    if torch.cuda.is_available():
        assert Entry.zeros(cap).boxes.is_cuda
        assert EvalPipeline("sgdet", cap).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        FasterRCNN(base_blocks=(1, 1, 1), head_blocks=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        Tempura(TempuraConfig.for_mode("sgdet"))
    with pytest.raises(RuntimeError, match="CUDA"):
        Entry.zeros(cap)
    with pytest.raises(RuntimeError, match="CUDA"):
        EvalPipeline("sgdet", cap)
    det = FasterRCNN(rpn_cfg=RPNConfig(pre_nms_top_n=64, post_nms_top_n=8),
                     base_blocks=(1, 1, 1), head_blocks=1, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        SgdetFrontend(det, SgdetCaps(), cap)
    # the CPU only when asked for
    assert SgdetFrontend(det, SgdetCaps(), cap, device="cpu").device.type == "cpu"


def test_chip_smoke_fails_without_a_card_or_alone(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where there is no card")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
