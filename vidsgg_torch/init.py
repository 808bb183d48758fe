"""Seeded weight initialisation for the port's modules.

No trained checkpoint ships with the repository, so models start from
random weights drawn from an explicit ``torch.Generator`` (on the CPU, so a
seed gives the same weights on every device). Convolution and linear
weights are normal with std 1/sqrt(fan_in), biases zero; norms stay at
identity (weight 1, bias 0, mean 0, var 1); embedding tables are standard
normal. Trained weights load with ``load_state_dict`` (see
:mod:`vidsgg_torch.convert`).
"""

from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator | None = None):
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    for mod in module.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen)
                             / math.sqrt(fan_in))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen))
    for name, p in module.named_parameters():
        if name.endswith("in_proj_weight"):
            p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(p.shape[1]))
        elif name.endswith("in_proj_bias"):
            p.zero_()
    return module
