"""ResNet-101 backbone + R-CNN head (counterpart of ``vidsgg/detector/resnet.py``).

NCHW inside. The module tree is named like the jwyang faster-rcnn.pytorch
checkpoint the reference loads: ``RCNN_base`` is the Sequential
``[conv1, bn1, relu, maxpool, layer1, layer2, layer3]`` and ``RCNN_top`` the
Sequential ``[layer4]``, so their ``state_dict`` keys are the reference's.
The detector is frozen: BatchNorm always uses its running statistics.

Details follow ``vidsgg`` (which the port is held against): the stride sits
on the 3x3 ``conv2``; the max-pool is 3x3/2 with padding 1; BN is
``(x - mean) * reciprocal(sqrt(var + eps)) * scale + bias``; every layer's
first block has a projection shortcut; the base and head outputs are
float32 whatever the compute dtype.

The compute dtype (``compute_dtype``, set through
:func:`set_compute_dtype`; None: the parameters' dtype) is the
convolutions' as ``vidsgg``'s ``conv_ctor(quant="off", dtype)`` makes them:
a convolution casts its input and its float32 weight to it. FrozenBatchNorm
keeps its float32 parameters, so a bfloat16 input promotes to float32;
``bn1`` and ``bn2`` are cast back to the compute dtype, ``bn3`` and the
projection shortcut stay float32, and the residual add and ReLU run in
float32 before the block's output is cast.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class FrozenBatchNorm(nn.Module):
    """Inference-only BN over the channel axis (dim 1)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(channels), requires_grad=False)
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        inv = torch.reciprocal(torch.sqrt(self.running_var + self.eps))
        return ((x - self.running_mean.reshape(shape)) * inv.reshape(shape)
                * self.weight.reshape(shape) + self.bias.reshape(shape))


def _conv(cin, cout, k, stride=1, padding=0):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=False)


def _conv_in(conv: nn.Conv2d, x, dtype):
    """``conv`` with its input and weight cast to ``dtype``."""
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), None, conv.stride, conv.padding)


class _ComputeDtype:
    """The compute dtype of a backbone module; None: the parameters'."""

    compute_dtype: torch.dtype | None = None

    def _dtype(self, conv: nn.Conv2d) -> torch.dtype:
        return self.compute_dtype or conv.weight.dtype


def set_compute_dtype(module: nn.Module, dtype: torch.dtype | None):
    """Set the compute dtype of every backbone module under ``module``."""
    for m in module.modules():
        if isinstance(m, _ComputeDtype):
            m.compute_dtype = dtype


class Bottleneck(_ComputeDtype, nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, stride=stride, padding=1)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.downsample = (
            nn.Sequential(_conv(inplanes, planes * 4, 1, stride=stride),
                          FrozenBatchNorm(planes * 4))
            if downsample else None
        )

    def forward(self, x):
        dt = self._dtype(self.conv1)
        h = torch.relu(self.bn1(_conv_in(self.conv1, x, dt)).to(dt))
        h = torch.relu(self.bn2(_conv_in(self.conv2, h, dt)).to(dt))
        h = self.bn3(_conv_in(self.conv3, h, dt))
        if self.downsample is None:
            identity = x
        else:
            identity = self.downsample[1](_conv_in(self.downsample[0], x, dt))
        return torch.relu(h + identity).to(dt)


def _layer(inplanes: int, planes: int, blocks: int, stride: int) -> nn.Sequential:
    mods = [Bottleneck(inplanes, planes, stride=stride, downsample=True)]
    mods += [Bottleneck(planes * 4, planes) for _ in range(1, blocks)]
    return nn.Sequential(*mods)


class ResNet101Base(_ComputeDtype, nn.Sequential):
    """conv1..layer3: [B, 3, H, W] -> [B, 1024, H/16, W/16] float32.

    ``blocks`` defaults to ResNet-101's (3, 4, 23); tests may shrink it.
    """

    def __init__(self, blocks: tuple = (3, 4, 23)):
        super().__init__(
            _conv(3, 64, 7, stride=2, padding=3),
            FrozenBatchNorm(64),
            nn.ReLU(),
            nn.MaxPool2d(3, stride=2, padding=1),
            _layer(64, 64, blocks[0], 1),
            _layer(256, 128, blocks[1], 2),
            _layer(512, 256, blocks[2], 2),
        )

    def forward(self, x):
        conv1, bn1, relu, maxpool, *layers = self
        dt = self._dtype(conv1)
        h = maxpool(relu(bn1(_conv_in(conv1, x, dt)).to(dt)))
        for layer in layers:
            h = layer(h)
        return h.float()


class ResNetHead(nn.Sequential):
    """layer4 + spatial mean: [N, 1024, 7, 7] -> [N, 2048] float32
    (the jwyang ``_head_to_tail``)."""

    def __init__(self, blocks: int = 3):
        super().__init__(_layer(1024, 512, blocks, 2))

    def forward(self, pooled):
        return super().forward(pooled).mean(dim=(2, 3)).float()
