from vidsgg_torch.configs.teatgt import TeatGTRunConfig
from vidsgg_torch.configs.tempura import TempuraRunConfig

__all__ = ["TeatGTRunConfig", "TempuraRunConfig"]
