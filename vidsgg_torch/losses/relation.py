"""Classification losses over padded axes (counterpart of
``vidsgg/losses/relation.py``).

The reference's loss assembly (TEMPURA_train.py:190-218) with its quirks:
cross entropy is applied to whatever the head emits (the GMM heads emit
*probabilities*, which the reference feeds to CE as if they were logits),
BCE runs on probabilities elementwise. Means are taken over valid entries
only, which on unpadded data equals the reference exactly.

Where ``vidsgg`` takes ``jnp.maximum`` of a differentiable value, the port
takes ``torch.maximum``: both split the gradient in half at a tie, where
``torch.clamp`` passes all of it.
"""

from __future__ import annotations

import torch

from vidsgg_torch.models.promote import weak

_LOG_CLAMP = -100.0  # torch BCELoss clamps log terms at -100


def masked_ce(inputs: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
              class_weights: torch.Tensor | None = None) -> torch.Tensor:
    """Cross entropy (inputs treated as logits), mean over valid rows.
    ``class_weights`` is the eos_coef-weighted object CE; as torch's
    reduction='none' + .mean(), the mean is NOT renormalised by the weights."""
    logp = torch.log_softmax(inputs, dim=-1)
    labels = labels.long()
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    if class_weights is not None:
        nll = nll * class_weights[labels]
    m = mask.to(nll.dtype)
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)


def _clamped_log(x: torch.Tensor) -> torch.Tensor:
    """max(log(x), -100) with a finite gradient at x == 0 (double where).
    Only the log term is clamped, the probability is not clipped: log(1e-40)
    = -92.1 passes through."""
    ok = x > torch.exp(weak(_LOG_CLAMP, x))  # e^-100
    return torch.where(ok, torch.log(torch.where(ok, x, torch.ones_like(x))),
                       torch.full_like(x, _LOG_CLAMP))


def masked_bce(probs: torch.Tensor, targets: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross entropy on probabilities, mean over the
    valid rows x classes: -(t max(log p, -100) + (1-t) max(log(1-p), -100)),
    finite in value and gradient at p == 0 and p == 1 exactly."""
    one_ok = probs < 1.0
    log1m = torch.where(one_ok, torch.log1p(-torch.where(one_ok, probs, torch.zeros_like(probs))),
                        torch.full_like(probs, _LOG_CLAMP))
    ll = (targets * _clamped_log(probs)
          + (1.0 - targets) * torch.maximum(log1m, weak(_LOG_CLAMP, log1m)))
    m = mask[:, None].expand(ll.shape).to(ll.dtype)
    return (-ll * m).sum() / torch.clamp(m.sum(), min=1.0)
