"""Device resolution shared by every entry point."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card and raises when there is none; any other
    value is taken as given (``"cpu"`` runs the plain kernel versions)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "vidsgg_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain CPU versions"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
