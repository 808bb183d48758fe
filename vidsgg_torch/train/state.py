"""Serving state: the relation model plus its memory banks.

Counterpart of the serving fields of ``vidsgg/train/state.py``: the
relation model (TEMPURA, or TEAT-GT, which reads no memory), the relation
memory (``rel_memory`` [26, 1936], [attention; spatial;
contacting] rows), the object memory (``obj_memory`` [C-1, D]) and
``mem_active``, which gates the hallucinators until the banks are filled.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn

from vidsgg_torch import constants as C
from vidsgg_torch.models.ospu import OBJ_FEAT_DIM

REL_FEATURE_DIM = 1936


def obj_memory_dim(cfg) -> int:
    """2376 when tracking (memory attends pre-intermediate features), else 1024."""
    return OBJ_FEAT_DIM if cfg.tracking else 1024


@dataclasses.dataclass
class ServingState:
    model: nn.Module            # Tempura or TeatGT
    rel_memory: torch.Tensor
    obj_memory: torch.Tensor
    mem_active: torch.Tensor   # [] bool


def cast_state_for_serving(state: ServingState, dtype: torch.dtype) -> ServingState:
    """The serving-precision copy (``vidsgg``'s ``cast_state_for_serving``):
    a copy of the model with its floating parameters and buffers (the
    batch-norm statistics, the position table) in ``dtype``, and the two
    memory banks in ``dtype``. ``state`` itself is left as it is."""
    return ServingState(
        model=copy.deepcopy(state.model).to(dtype),
        rel_memory=state.rel_memory.to(dtype),
        obj_memory=state.obj_memory.to(dtype),
        mem_active=state.mem_active,
    )


def create_serving_state(model: nn.Module) -> ServingState:
    """Empty banks (zeros) and ``mem_active`` False, on the model's device
    and in its dtype."""
    w = model.subj_fc.weight
    cfg = model.cfg
    return ServingState(
        model=model,
        rel_memory=torch.zeros((C.NUM_PREDICATES, REL_FEATURE_DIM), dtype=w.dtype,
                               device=w.device),
        obj_memory=torch.zeros((cfg.num_classes - 1, obj_memory_dim(cfg)),
                               dtype=w.dtype, device=w.device),
        mem_active=torch.zeros((), dtype=torch.bool, device=w.device),
    )
