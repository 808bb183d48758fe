"""Checkpoints of a train state (the port's counterpart of
``vidsgg/train/checkpoint.py``, in its own format: ``torch.save``).

The reference saves every 5 epochs and on the best R@20 and mR@20
(TEMPURA_train.py:296-349), its checkpoints carrying the model weights and
the memory banks. One payload here holds everything a resumed run or a
test run needs: the model's ``state_dict`` (parameters and batch-norm
statistics), the optimizer's state (the update count, per-tensor step
counts and moments), ``step``, both memory banks and ``mem_active``.
Restoring is strict and complete.

:func:`checkpoint_payload` and :func:`restore_payload` are pure, so a
payload round-trips through any file-like object; :func:`save_checkpoint`
and :func:`restore_checkpoint` write and read ``<path>/<name>.pt``.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from vidsgg_torch.train.state import ServingState, TrainState

FORMAT = "vidsgg_torch.tempura_train_state/1"


def checkpoint_payload(state: TrainState) -> dict:
    return {
        "format": FORMAT,
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "rel_memory": state.rel_memory,
        "obj_memory": state.obj_memory,
        "mem_active": state.mem_active,
    }


def _check_format(payload: dict):
    if payload.get("format") != FORMAT:
        raise ValueError(f"not a {FORMAT} checkpoint: format {payload.get('format')!r}")


def _bank(have: torch.Tensor, got: torch.Tensor, name: str) -> torch.Tensor:
    if got.shape != have.shape:
        raise ValueError(f"checkpoint {name} has shape {tuple(got.shape)}, "
                         f"the state {tuple(have.shape)}")
    return got.to(device=have.device, dtype=have.dtype)


def _restore_banks(state, payload: dict) -> dict:
    return dict(
        rel_memory=_bank(state.rel_memory, payload["rel_memory"], "rel_memory"),
        obj_memory=_bank(state.obj_memory, payload["obj_memory"], "obj_memory"),
        mem_active=payload["mem_active"].to(device=state.mem_active.device, dtype=torch.bool),
    )


def restore_payload(state: TrainState, payload: dict) -> TrainState:
    """``state`` with everything the payload holds (the model and the
    optimizer restored in place; strict)."""
    _check_format(payload)
    state.model.load_state_dict(payload["model"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    return dataclasses.replace(state, step=int(payload["step"]),
                               **_restore_banks(state, payload))


def restore_serving(state: ServingState, payload: dict) -> ServingState:
    """A serving state with the payload's model weights and banks (the test
    CLIs' ``--ckpt``; the optimizer's part is not read)."""
    _check_format(payload)
    state.model.load_state_dict(payload["model"], strict=True)
    return dataclasses.replace(state, **_restore_banks(state, payload))


def checkpoint_file(path: str, name: str) -> str:
    return os.path.join(path, f"{name}.pt")


def save_checkpoint(path: str, state: TrainState, name: str = "checkpoint"):
    os.makedirs(path, exist_ok=True)
    torch.save(checkpoint_payload(state), checkpoint_file(path, name))


def load_payload(path: str, name: str, device=None) -> dict:
    return torch.load(checkpoint_file(path, name), map_location=device, weights_only=True)


def restore_checkpoint(path: str, state: TrainState, name: str = "checkpoint") -> TrainState:
    """Restore into an existing (template) state."""
    return restore_payload(state, load_payload(path, name, state.rel_memory.device))
