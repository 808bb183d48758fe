"""Gaussian-mixture classification head (counterpart of ``vidsgg/models/gmm_head.py``).

The reference's ``GMM_head`` keeps K per-component linears named
``heads.{mu,var,pi}_{1..K}``; the port keeps those names (so reference
checkpoints load) and fuses them into one product per quantity at call
time, k-major as ``vidsgg``'s fused Dense.

* var = sigmoid(linear); pi = softmax over components;
* train: logits_k = mu_k + sqrt(var_k) * eps, eps ~ N(0, 1) of shape
  [B, K, C] from the noise source (``noise.py``), activation over every
  column;
* test: logits_k = mu_k; the object head (``rel_type`` None) drops the
  background column before activation; output = sum_k pi_k * act(logits_k);
* ``unc=True``: (aleatoric, epistemic) = (sum_k pi_k var_k,
  sum_k pi_k (act(mu_k) - mean)^2), over every column;
* activation: softmax for attention/object, sigmoid for spatial/contact.
"""

from __future__ import annotations

import torch
from torch import nn

from vidsgg_torch.models.promote import linear


class GMMHead(nn.Module):
    def __init__(self, in_features: int, num_classes: int, k: int = 4,
                 rel_type: str | None = None):
        super().__init__()
        self.num_classes = num_classes
        self.k = k
        self.rel_type = rel_type
        heads = {}
        for i in range(1, k + 1):
            heads[f"mu_{i}"] = nn.Linear(in_features, num_classes)
            heads[f"pi_{i}"] = nn.Linear(in_features, 1)
            heads[f"var_{i}"] = nn.Linear(in_features, num_classes)
        self.heads = nn.ModuleDict(heads)

    def _activation(self, x):
        if self.rel_type is None or self.rel_type == "attention":
            return torch.softmax(x, dim=-1)
        return torch.sigmoid(x)

    def _fused(self, quant, x):
        mods = [self.heads[f"{quant}_{i}"] for i in range(1, self.k + 1)]
        w = torch.cat([m.weight for m in mods], dim=0)
        b = torch.cat([m.bias for m in mods], dim=0)
        return linear(x, w, b)

    def forward(self, x, phase: str = "test", unc: bool = False, noise=None):
        b = x.shape[0]
        mu = self._fused("mu", x).reshape(b, self.k, self.num_classes)
        pi = torch.softmax(self._fused("pi", x), dim=-1)    # [B, K]
        if unc or phase == "train":
            var = torch.sigmoid(self._fused("var", x)).reshape(b, self.k, self.num_classes)
        if unc:
            probs = self._activation(mu)
            mean = (probs * pi[:, :, None]).sum(1)
            al_uc = (var * pi[:, :, None]).sum(1)
            ep_uc = (((probs - mean[:, None, :]) ** 2) * pi[:, :, None]).sum(1)
            return al_uc, ep_uc
        if phase == "train":
            if noise is None:
                raise ValueError("the train phase needs a noise source")
            logits = mu + torch.sqrt(var) * noise.normal(mu.shape, mu.dtype, mu.device)
        else:
            logits = mu if self.rel_type is not None else mu[:, :, 1:]
        return (self._activation(logits) * pi[:, :, None]).sum(1)
