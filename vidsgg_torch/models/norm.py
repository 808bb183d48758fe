"""Masked batch normalization, eval mode (counterpart of ``vidsgg/models/norm.py``).

In eval mode the running statistics are used, so the validity mask does not
enter: ``y = (x - mean) / sqrt(var + eps) * weight + bias`` over the channel
axis. Names are ``nn.BatchNorm``'s. Training (masked batch moments) comes
with the training slice.
"""

from __future__ import annotations

import torch
from torch import nn


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
        x = x.to(self.weight.dtype)
        y = (x - self.running_mean.reshape(shape)) / torch.sqrt(
            self.running_var.reshape(shape) + self.eps)
        return y * self.weight.reshape(shape) + self.bias.reshape(shape)
