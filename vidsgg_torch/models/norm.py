"""Masked batch normalization (counterpart of ``vidsgg/models/norm.py``).

Batch norm over a channel axis (``channel_dim``) with an element validity
mask, in the promotion of the input's and the parameters' types (a float32
input through bfloat16 statistics runs in float32, as in ``vidsgg``).
Names are ``nn.BatchNorm``'s.

* eval (``use_running_average=True``): the running statistics; the mask
  does not enter.
* train: the moments of the *valid* elements only (padding rows would
  pollute plain batch statistics), in the input's type as ``vidsgg``'s
  (a float32 input's moments are float32 even beside float64
  parameters): the biased masked variance normalises, and the unbiased
  one, ``var * cnt / max(cnt - 1, 1)``, goes into the running variance,
  as torch's BatchNorm tracks it, at ``momentum``.
"""

from __future__ import annotations

import torch
from torch import nn

from vidsgg_torch.models.promote import result_type, weak


class MaskedBatchNorm(nn.Module):
    def __init__(self, channels: int, eps: float = 1e-5, channel_dim: int = -1,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.channel_dim = channel_dim
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x, mask=None, use_running_average: bool = True):
        """x [..., C, ...]; ``mask`` (train only): x's shape without the
        channel axis, True where valid."""
        dim = self.channel_dim % x.dim()
        shape = [1] * x.dim()
        shape[dim] = -1
        dt = result_type(x, self.weight)
        w, b = (t.to(dt).reshape(shape) for t in (self.weight, self.bias))
        if use_running_average:
            mean, var = (t.to(dt).reshape(shape) for t in (self.running_mean, self.running_var))
            x = x.to(dt)
        else:
            axes = tuple(a for a in range(x.dim()) if a != dim)
            m = mask.unsqueeze(dim).expand(x.shape).to(x.dtype)
            cnt = torch.clamp(m.sum(dim=axes, keepdim=True), min=1.0)
            mean = (x * m).sum(dim=axes, keepdim=True) / cnt
            var = ((x - mean) ** 2 * m).sum(dim=axes, keepdim=True) / cnt
            with torch.no_grad():
                mom = self.momentum
                unbiased = var * cnt / torch.clamp(cnt - 1.0, min=1.0)
                self.running_mean.copy_(((1 - mom) * self.running_mean
                                         + mom * mean.reshape(-1)))
                self.running_var.copy_(((1 - mom) * self.running_var
                                        + mom * unbiased.reshape(-1)))
        y = (x - mean) / torch.sqrt(var + weak(self.eps, var))
        return y.to(dt) * w + b
