"""Train and eval steps with the reference's loss assembly (counterpart of
``vidsgg/train/steps.py``).

Loss set (TEMPURA_train.py:190-218, TEATGT_train.py:176-185): attention
CE + spatial/contacting BCE; for sgcls/sgdet the object CE (class 0
weighted by ``eos_coef``) and, under ``obj_con_loss``, the object
contrastive loss at ``lambda_con``; the relation contrastive ('ctl')
losses under ``--use_ctl_loss``, TEMPURA's at 0.2x spatial and contact,
TEAT-GT's (``ctl_variant="teatgt"``) at 0.25x with the attention term
too; TEAT-GT's temporal-consistency terms x ``cons_weight`` (2500), each
where its flag is on and the model returned it.

The Performer's projections (TEAT-GT with ``performer=True``) come from
their own draws, :func:`performer_noise`: a generator seeded from the
step's redraw interval, the port's form of ``vidsgg``'s ``performer_rng``
(a fixed key folded with ``step // performer_redraw_interval``), so that
the projections stay for ``performer_redraw_interval`` steps and then are
drawn anew.

:func:`make_train_step` gives one step of ``vidsgg``'s: the train-phase
forward (dropout and GMM noise from the run's noise source, batch
statistics, running statistics updated), the loss sum, backward, the clip
and the reference AdamW (:class:`~vidsgg_torch.train.optim.ReferenceAdamW`),
returning ``vidsgg``'s metrics dict (its keys sorted, as JAX returns it)
as 0-d device tensors: no host transfer. It refuses to run under ``torch.inference_mode``.
"""

from __future__ import annotations

import dataclasses

import torch

from vidsgg_torch.data.entry import Entry
from vidsgg_torch.losses import contrastive_loss, masked_bce, masked_ce
from vidsgg_torch.models.noise import Noise


@dataclasses.dataclass(frozen=True)
class LossFlags:
    mode: str = "predcls"
    use_ctl_loss: bool = False
    obj_con_loss: str | None = None
    lambda_con: float = 1.0
    eos_coef: float = 1.0
    num_classes: int = 37
    use_cons_str_loss: bool = False
    use_cons_sem_loss: bool = False
    cons_weight: float = 2500.0
    # TEMPURA: 0.2x spatial + contact; TEAT-GT: 0.25x with attention
    ctl_variant: str = "tempura"
    # the Performer's projections are drawn anew every N steps
    performer_redraw_interval: int = 1000


# the Performer draws' base seed (vidsgg's performer_rng: PRNGKey(1123))
PERFORMER_SEED = 1123


def performer_noise(step: int, interval: int) -> Noise:
    """The Performer's draws for ``step``: a CPU generator seeded from
    :data:`PERFORMER_SEED` and ``step // interval``, the same draws on
    every device and for every step of one interval."""
    return Noise.seeded((PERFORMER_SEED << 32) + step // interval, "cpu")


def assemble_losses(out: dict, entry: Entry, flags: LossFlags) -> dict:
    pm = entry.pair_mask
    losses = {}
    if flags.mode in ("sgcls", "sgdet"):
        dist = out["distribution"]
        w = torch.ones(flags.num_classes, dtype=dist.dtype, device=dist.device)
        w[0] = flags.eos_coef
        losses["object_loss"] = masked_ce(dist, entry.labels, entry.obj_mask, w)
        if flags.obj_con_loss:
            losses["object_contrastive_loss"] = flags.lambda_con * contrastive_loss(
                out["object_mem_features"], entry.labels, entry.obj_mask)
    losses["attention_relation_loss"] = masked_ce(out["attention_distribution"],
                                                  entry.attention_gt, pm)
    losses["spatial_relation_loss"] = masked_bce(out["spatial_distribution"],
                                                 entry.spatial_gt, pm)
    losses["contacting_relation_loss"] = masked_bce(out["contacting_distribution"],
                                                    entry.contacting_gt, pm)
    if flags.use_ctl_loss:
        w = 0.25 if flags.ctl_variant == "teatgt" else 0.2
        if flags.ctl_variant == "teatgt":
            # TEATGT_train.py:177: the attention term, keyed on the class index
            losses["attention_con_loss"] = w * contrastive_loss(
                out["attention_distribution"], entry.attention_gt, pm)
        losses["spatial_con_loss"] = w * contrastive_loss(
            out["spatial_distribution"], torch.argmax(entry.spatial_gt, 1), pm)
        losses["contact_con_loss"] = w * contrastive_loss(
            out["contacting_distribution"], torch.argmax(entry.contacting_gt, 1), pm)
    if flags.use_cons_str_loss and "structure_temp_loss" in out:
        losses["structure_temp_loss"] = out["structure_temp_loss"] * flags.cons_weight
    if flags.use_cons_sem_loss and "semantic_temp_loss" in out:
        losses["semantic_temp_loss"] = out["semantic_temp_loss"] * flags.cons_weight
    return losses


def make_train_step(flags: LossFlags):
    """-> ``train_step(state, entry, noise) -> metrics``, which updates
    ``state`` in place (parameters, batch-norm statistics, optimizer,
    ``step``)."""

    def train_step(state, entry: Entry, noise) -> dict:
        if torch.is_inference_mode_enabled():
            raise RuntimeError("the train step cannot run under torch.inference_mode")
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            out = state.model(entry, rel_memory=state.rel_memory, obj_memory=state.obj_memory,
                              mem_active=state.mem_active, phase="train", unc=False,
                              noise=noise,
                              performer=performer_noise(state.step,
                                                        flags.performer_redraw_interval))
            losses = assemble_losses(out, entry, flags)
            total = sum(losses.values())
            total.backward()
        grad_norm = opt.global_grad_norm()
        opt.step(grad_norm=grad_norm)
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        metrics["grad_norm"] = grad_norm
        # vidsgg's jitted step returns its dict in JAX's pytree order (sorted
        # keys), the order of its log lines
        return dict(sorted(metrics.items()))

    return train_step


@torch.no_grad()
def eval_step(state, entry: Entry, unc: bool = False) -> dict:
    """The test-phase forward (deterministic, running batch-norm
    statistics); ``unc`` gives the GMM heads' uncertainties."""
    return state.model(entry, rel_memory=state.rel_memory, obj_memory=state.obj_memory,
                       mem_active=state.mem_active, phase="test", unc=unc)
