"""The reference training recipe's optimizer, clip and schedule
(counterpart of ``vidsgg/train/optim.py``).

Reference: its own AdamW (tools/utils/AdamW.py: lr 1e-5, betas (0.9,
0.999), eps 1e-8, weight decay 0.1), ExponentialLR(gamma=0.8) stepped per
epoch under an ExponentialWarmup(period 3), and ``clip_grad_norm_`` at 5.0
(TEMPURA_train.py:111-113, :224, :353-358). :class:`ReferenceAdamW` does
all three in one ``step()``, as ``vidsgg``'s optax chain does, and differs
from ``torch.optim.AdamW`` where the reference does:

* eps is added to the *uncorrected* sqrt(v), the bias correction folded
  into the step size: ``p -= lr * (sqrt(1 - b2^t) / (1 - b1^t) * m /
  (sqrt(v) + eps) + wd * p)``;
* the step count ``t`` is per tensor, and a tensor whose gradient is None
  or all zero gets no moment update, no decay and no count (the
  reference's ``if p.grad is None: continue``; the memory hallucinator's
  gradients are zero until its banks are filled);
* the gradients are first scaled by ``min(1, 5 / (global_norm + 1e-6))``;
* the learning rate of the n-th update (n counted from 0 before it) is
  :func:`reference_lr` at epoch ``n // steps_per_epoch``.

"Per tensor" means ``vidsgg``'s tensors. The port keeps the reference's
packed attention projections (``in_proj_weight``/``in_proj_bias``: q, k
and v stacked along dim 0), where ``vidsgg`` has three Dense layers, so
such a parameter is given as ``segments=3``: three tensors to the
optimizer, each with its own count and skip. It matters: the key bias's
gradient is zero in exact arithmetic (softmax ignores a per-row constant)
and often exactly zero in floating point, so ``vidsgg`` skips it, decay
included, while q and v train.

Everything stays on the device: the skip is a 0-d boolean per tensor that
selects coefficients, never a host branch, and the updates run as
multi-tensor (``torch._foreach_*``) operations in ``vidsgg``'s operation
order. The bias correction is computed in the parameters' type (``vidsgg``
takes the widest enabled float: float64 under x64, float32 otherwise).
"""

from __future__ import annotations

import math

import torch


def reference_lr(update: int, base_lr: float = 1e-5, gamma: float = 0.8,
                 warmup_period: int = 3, steps_per_epoch: int = 1) -> float:
    """The learning rate of the ``update``-th update (0-based): per-epoch
    exponential decay under the exponential warmup's damping."""
    epoch = update // steps_per_epoch
    warm = min(1.0, math.exp((epoch + 1.0) / warmup_period - 1.0))
    return base_lr * gamma ** epoch * warm


class ReferenceAdamW(torch.optim.Optimizer):
    """Clip, the reference's AdamW and the per-epoch schedule in one step.

    ``segments``: per parameter (in ``params``' order), the number of
    equal dim-0 blocks that are separate tensors to the optimizer (default
    1 each). State: ``updates`` (the count of ``step()`` calls, which
    indexes the schedule) and, per parameter, ``step`` (one int64 count per
    segment), ``exp_avg`` and ``exp_avg_sq``.
    """

    def __init__(self, params, base_lr: float = 1e-5, gamma: float = 0.8,
                 warmup_period: int = 3, steps_per_epoch: int = 1,
                 betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 5.0,
                 segments: list[int] | None = None):
        params = list(params)
        defaults = dict(base_lr=base_lr, gamma=gamma, warmup_period=warmup_period,
                        steps_per_epoch=steps_per_epoch, betas=betas, eps=eps,
                        weight_decay=weight_decay, clip_norm=clip_norm)
        super().__init__(params, defaults)
        self.updates = 0
        segments = [1] * len(params) if segments is None else list(segments)
        if len(segments) != len(params):
            raise ValueError(f"{len(segments)} segment counts for {len(params)} parameters")
        for p, n in zip(params, segments):
            if p.shape[0] % n:
                raise ValueError(f"a parameter of shape {tuple(p.shape)} has no {n} equal blocks")
            self.state[p] = dict(
                step=torch.zeros((n,), dtype=torch.int64, device=p.device),
                exp_avg=torch.zeros_like(p, memory_format=torch.preserve_format),
                exp_avg_sq=torch.zeros_like(p, memory_format=torch.preserve_format),
            )

    def state_dict(self):
        sd = super().state_dict()
        sd["updates"] = self.updates
        return sd

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self.updates = int(state_dict.pop("updates"))
        super().load_state_dict(state_dict)
        for p, st in self.state.items():  # torch leaves "step" where it was saved
            st["step"] = st["step"].to(p.device)

    @torch.no_grad()
    def global_grad_norm(self) -> torch.Tensor:
        """The global L2 norm of every gradient (None counts as zero), a
        0-d device tensor."""
        grads = [p.grad for g in self.param_groups for p in g["params"] if p.grad is not None]
        if not grads:
            return torch.zeros(())
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))

    @torch.no_grad()
    def step(self, closure=None, grad_norm: torch.Tensor | None = None):
        """One clipped update. ``grad_norm``: the global gradient norm if
        the caller has it already (:meth:`global_grad_norm`)."""
        if closure is not None:
            raise ValueError("ReferenceAdamW takes no closure")
        if grad_norm is None:
            grad_norm = self.global_grad_norm()
        clip_norm = self.param_groups[0]["clip_norm"]
        scale = torch.clamp(clip_norm / (grad_norm + 1e-6), max=1.0)
        for group in self.param_groups:
            self._update_group(group, scale)
        self.updates += 1

    def _update_group(self, group, scale):
        params = [p for p in group["params"] if p.grad is not None]
        if not params:
            return
        b1, b2 = group["betas"]
        eps, wd = group["eps"], group["weight_decay"]
        lr = reference_lr(self.updates, group["base_lr"], group["gamma"],
                          group["warmup_period"], group["steps_per_epoch"])
        states = [self.state[p] for p in params]
        steps = [s["step"] for s in states]
        sizes = [len(c) for c in steps]

        def units(tensors):  # each parameter's segments, as views
            return [u for t, n in zip(tensors, sizes) for u in t.chunk(n)]

        m = units([s["exp_avg"] for s in states])
        v = units([s["exp_avg_sq"] for s in states])
        dtype = params[0].dtype

        grads = torch._foreach_mul(units([p.grad for p in params]), scale.to(dtype))
        # per tensor: was it touched (any nonzero gradient element)?
        touched = torch.stack(torch._foreach_norm(grads, ord=float("inf"))) != 0
        count = torch.cat(steps) + touched.to(torch.int64)
        torch._foreach_copy_(steps, list(count.split(sizes)))
        params = units(params)

        def per_tensor(value, otherwise):
            full = torch.full(touched.shape, value, dtype=dtype, device=touched.device)
            return list(full.where(touched, otherwise).unbind())

        # m = b1 m + (1 - b1) g and v = b2 v + (1 - b2) g g where touched;
        # coefficients 1 and 0 leave an untouched (all-zero) tensor's as is
        new_m = torch._foreach_mul(m, per_tensor(b1, 1.0))
        torch._foreach_add_(new_m, torch._foreach_mul(grads, per_tensor(1 - b1, 0.0)))
        new_v = torch._foreach_mul(v, per_tensor(b2, 1.0))
        gg = torch._foreach_mul(grads, per_tensor(1 - b2, 0.0))
        torch._foreach_mul_(gg, grads)
        torch._foreach_add_(new_v, gg)
        torch._foreach_copy_(m, new_m)
        torch._foreach_copy_(v, new_v)

        tt = torch.clamp(count, min=1).to(dtype)
        step_size = torch.sqrt(1.0 - torch.pow(b2, tt)) / (1.0 - torch.pow(b1, tt))
        delta = torch._foreach_mul(m, list(step_size.unbind()))
        denom = torch._foreach_sqrt(v)
        torch._foreach_add_(denom, eps)
        torch._foreach_div_(delta, denom)
        if wd:
            torch._foreach_add_(delta, torch._foreach_mul(params, wd))
        # p += -lr * delta where touched, + 0 elsewhere
        torch._foreach_mul_(delta, per_tensor(-lr, 0.0))
        torch._foreach_add_(params, delta)
