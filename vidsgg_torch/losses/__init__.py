"""Loss functions: masked relation CE/BCE and the contrastive losses
(counterpart of ``vidsgg/losses``)."""

from vidsgg_torch.losses.contrastive import contrastive_loss, euc_norm_loss, supcon_loss
from vidsgg_torch.losses.relation import masked_bce, masked_ce

__all__ = ["contrastive_loss", "euc_norm_loss", "masked_bce", "masked_ce", "supcon_loss"]
