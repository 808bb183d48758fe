"""JAX's type promotion at the layers of the port (``vidsgg``'s is the rule).

A Flax layer computes in the promotion of its input's and its parameters'
types: a float32 input through bfloat16 parameters runs in float32, a
bfloat16 input in bfloat16, float64 wins over both. torch's layers and
products take one type, so the port promotes first, with these helpers.
In float32 (and in float64) serving every operand already has the one
type, and the helpers change nothing.

A Python float in JAX takes the type of the array it meets (a weak type),
so ``x_bf16 + 1e-5`` adds bfloat16(1e-5); torch computes with the scalar
at the operation's working precision instead. Where the constant is not a
bfloat16 value, :func:`weak` gives it the array's type first.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn


def result_type(*tensors) -> torch.dtype:
    """The promoted type of the tensors (None entries are skipped)."""
    return functools.reduce(torch.promote_types,
                            (t.dtype for t in tensors if t is not None))


def weak(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as JAX's weak-typed scalar meeting ``like``: a 0-dim CPU
    tensor of ``like``'s type (torch takes it as a scalar on any device)."""
    return torch.tensor(value, dtype=like.dtype)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None):
    """``F.linear`` in the promotion of input, weight and bias."""
    dt = result_type(x, weight, bias)
    return F.linear(x.to(dt), weight.to(dt), None if bias is None else bias.to(dt))


def dense(mod: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``mod(x)`` as a Flax ``nn.Dense``: promoted."""
    return linear(x, mod.weight, mod.bias)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dt = result_type(a, b)
    return torch.matmul(a.to(dt), b.to(dt))


def conv2d(mod: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``mod(x)`` (NCHW) as a Flax ``nn.Conv``: promoted."""
    dt = result_type(x, mod.weight, mod.bias)
    bias = None if mod.bias is None else mod.bias.to(dt)
    return F.conv2d(x.to(dt), mod.weight.to(dt), bias, mod.stride, mod.padding)


def layer_norm(mod: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``mod(x)`` as a Flax ``nn.LayerNorm``: in the promotion of the input
    and the parameters (its statistics are float32 or wider either way)."""
    dt = result_type(x, mod.weight, mod.bias)
    return F.layer_norm(x.to(dt), mod.normalized_shape, mod.weight.to(dt),
                        mod.bias.to(dt), mod.eps)
