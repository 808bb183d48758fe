"""Contrastive losses (counterpart of ``vidsgg/losses/contrastive.py``).

* :func:`contrastive_loss`: pytorch_metric_learning's
  ``ContrastiveLoss(pos_margin=0, neg_margin=1)``, which the train scripts
  use (TEMPURA_train.py:103, :198): L2-normalised embeddings, euclidean
  distances, per-pair hinge, averaged over the *non-zero* positive and
  negative pair losses separately, then summed (AvgNonZeroReducer).
* :func:`supcon_loss` / :func:`euc_norm_loss`: the reference's own
  ``SupConLoss`` / ``EucNormLoss`` options (tools/utils/infoNCE.py).

All take a validity mask over the padded row axis. ``jnp.clip``/``maximum``
of a differentiable value becomes ``torch.maximum`` (the same half-and-half
gradient at a tie), ``jnp.max`` becomes ``amax`` (the gradient shared among
tied maxima).
"""

from __future__ import annotations

import torch

from vidsgg_torch.models.promote import weak


def _normalize(x, eps=1e-12):
    # smooth at x = 0 (zero-padded rows): rsqrt(sum(x^2) + eps)
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + eps)


def _pair_masks(labels, valid):
    same = labels[:, None] == labels[None, :]
    vv = valid[:, None] & valid[None, :]
    eye = torch.eye(labels.shape[0], dtype=torch.bool, device=labels.device)
    return same & vv & ~eye, ~same & vv


def _relu(x):
    return torch.maximum(x, weak(0.0, x))


def _cdist(a, b):
    d2 = (a ** 2).sum(-1)[:, None] + (b ** 2).sum(-1)[None, :] - 2.0 * a @ b.T
    # the +1e-12 keeps sqrt's gradient finite on self and duplicate pairs
    return torch.sqrt(_relu(d2) + 1e-12)


def contrastive_loss(features: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
                     pos_margin: float = 0.0, neg_margin: float = 1.0) -> torch.Tensor:
    f = _normalize(features)
    d = _cdist(f, f)
    pos, neg = _pair_masks(labels, valid)
    pos_l = _relu(d - pos_margin) * pos
    neg_l = _relu(neg_margin - d) * neg

    def avg_nonzero(x):
        nz = (x > 0).to(x.dtype)
        return x.sum() / torch.clamp(nz.sum(), min=1.0)

    return avg_nonzero(pos_l) + avg_nonzero(neg_l)


def euc_norm_loss(features, labels, valid):
    """Same-class pairwise L2 pull (EucNormLoss: row mean over same-label
    distances including self, then mean)."""
    f = _normalize(features)
    d = _cdist(f, f)
    same = (labels[:, None] == labels[None, :]) & valid[:, None] & valid[None, :]
    samef = same.to(d.dtype)
    row = (d * samef).sum(1) / torch.clamp(samef.sum(1), min=1.0)
    v = valid.to(d.dtype)
    return (row * v).sum() / torch.clamp(v.sum(), min=1.0)


def supcon_loss(features, labels, valid, temperature=0.1):
    """Supervised contrastive loss (SupConLoss semantics). As in ``vidsgg``,
    a row with no valid key (a padding row) makes the loss NaN."""
    contrast = _normalize(features)
    logits = contrast @ contrast.T / temperature
    vv = valid[:, None] & valid[None, :]
    eye = torch.eye(features.shape[0], dtype=torch.bool, device=features.device)
    logits_mask = vv & ~eye
    lbl_mask = (labels[:, None] == labels[None, :]) & vv
    pos_mask = lbl_mask & ~eye

    neg_inf = torch.full_like(logits, float("-inf"))
    logits = logits - torch.where(logits_mask, logits, neg_inf).amax(dim=1, keepdim=True)
    exp = torch.where(logits_mask, torch.exp(logits), torch.zeros_like(logits))
    logprob = logits - torch.log(exp.sum(1, keepdim=True) + 1e-12)
    mean_logprob_pos = (pos_mask * logprob).sum(1) / torch.clamp(
        lbl_mask.to(logits.dtype).sum(1), min=1.0)
    v = valid.to(logits.dtype)
    return -(mean_logprob_pos * v).sum() / torch.clamp(v.sum(), min=1.0)
