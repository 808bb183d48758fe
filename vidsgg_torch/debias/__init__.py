"""Debiasing: uncertainty-weighted memory banks computed on the device."""

from vidsgg_torch.debias.memory import (
    MemoryAccumulator,
    accumulate_memory,
    finalize_memory,
    uncertainty_stats,
)

__all__ = ["MemoryAccumulator", "accumulate_memory", "finalize_memory", "uncertainty_stats"]
