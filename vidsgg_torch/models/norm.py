"""Masked batch normalization, eval mode (counterpart of ``vidsgg/models/norm.py``).

In eval mode the running statistics are used, so the validity mask does not
enter: ``y = (x - mean) / sqrt(var + eps) * weight + bias`` over the channel
axis, in the promotion of the input's and the statistics' types (a float32
input through bfloat16 statistics runs in float32, as in ``vidsgg``).
Names are ``nn.BatchNorm``'s. Training (masked batch moments) comes with
the training slice.
"""

from __future__ import annotations

import torch
from torch import nn

from vidsgg_torch.models.promote import result_type, weak


class MaskedBatchNorm(nn.Module):
    def __init__(self, channels: int, eps: float = 1e-5, channel_dim: int = -1):
        super().__init__()
        self.eps = eps
        self.channel_dim = channel_dim
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        dim = self.channel_dim % x.dim()
        shape = [1] * x.dim()
        shape[dim] = -1
        dt = result_type(x, self.weight)
        mean, var, w, b = (t.to(dt).reshape(shape) for t in (
            self.running_mean, self.running_var, self.weight, self.bias))
        y = (x.to(dt) - mean) / torch.sqrt(var + weak(self.eps, var))
        return y * w + b
