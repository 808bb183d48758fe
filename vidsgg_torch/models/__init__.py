from vidsgg_torch.models.tempura import Tempura, TempuraConfig

__all__ = ["Tempura", "TempuraConfig"]
