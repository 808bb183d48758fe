"""Serving and train states: the relation model plus its memory banks.

Counterpart of ``vidsgg/train/state.py``: the relation model (TEMPURA, or
TEAT-GT, which reads no memory), the relation memory (``rel_memory`` [26,
1936], [attention; spatial; contacting] rows), the object memory
(``obj_memory`` [C-1, D]) and ``mem_active``, which gates the
hallucinators until the first epoch-end bank computation fills them.
:class:`TrainState` adds the optimizer and the step count; the model's
parameters and batch-norm statistics live in the model itself.
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


# TEAT-GT's object bank: vidsgg builds its states from a memory config
# without tracking (``_MemCfg`` of its TEAT-GT CLIs), so [36, 1024] in every
# mode; TEAT-GT reads no memory, but its checkpoints hold the bank
TEATGT_OBJ_DIM = 1024


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


def _empty_banks(model: nn.Module, obj_dim: int | None):
    """(rel_memory, obj_memory, mem_active): zero banks and False, on the
    model's device and in its dtype; the object bank ``obj_dim`` wide
    (None: :func:`obj_memory_dim` of the model's config)."""
    w = model.subj_fc.weight
    cfg = model.cfg
    obj_dim = obj_memory_dim(cfg) if obj_dim is None else obj_dim
    return (torch.zeros((C.NUM_PREDICATES, REL_FEATURE_DIM), dtype=w.dtype, device=w.device),
            torch.zeros((cfg.num_classes - 1, obj_dim), dtype=w.dtype, device=w.device),
            torch.zeros((), dtype=torch.bool, device=w.device))


def create_serving_state(model: nn.Module, obj_dim: int | None = None) -> ServingState:
    """Empty banks (zeros; the object bank ``obj_dim`` wide, by default
    the model config's :func:`obj_memory_dim`) and ``mem_active`` False, on
    the model's device and in its dtype."""
    return ServingState(model, *_empty_banks(model, obj_dim))


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer   # ReferenceAdamW over the model's parameters
    step: int
    rel_memory: torch.Tensor
    obj_memory: torch.Tensor
    mem_active: torch.Tensor   # [] bool

    def with_memory(self, rel_memory, obj_memory) -> "TrainState":
        return dataclasses.replace(
            self, rel_memory=rel_memory, obj_memory=obj_memory,
            mem_active=torch.ones((), dtype=torch.bool, device=rel_memory.device))

    def serving(self) -> ServingState:
        """The serving view: the same model and banks."""
        return ServingState(self.model, self.rel_memory, self.obj_memory, self.mem_active)


# the reference's packed attention projections: q, k and v, which are
# three tensors in vidsgg and so to its optimizer
PACKED_QKV = ("in_proj_weight", "in_proj_bias")


def create_train_state(model: nn.Module, obj_dim: int | None = None,
                       **optim_kw) -> TrainState:
    """Empty banks (the object bank ``obj_dim`` wide, by default the model
    config's :func:`obj_memory_dim`; TEAT-GT's is :data:`TEATGT_OBJ_DIM`),
    step 0, and :class:`ReferenceAdamW` over every parameter of ``model``
    (``optim_kw``: its schedule, e.g. ``steps_per_epoch``), each packed
    q/k/v projection as three tensors."""
    from vidsgg_torch.train.optim import ReferenceAdamW

    names, params = zip(*model.named_parameters())
    segments = [3 if n.rsplit(".", 1)[-1] in PACKED_QKV else 1 for n in names]
    return TrainState(model, ReferenceAdamW(params, segments=segments, **optim_kw), 0,
                      *_empty_banks(model, obj_dim))
