from vidsgg_torch.models.teatgt import TeatGT, TeatGTConfig
from vidsgg_torch.models.tempura import Tempura, TempuraConfig

__all__ = ["TeatGT", "TeatGTConfig", "Tempura", "TempuraConfig"]
