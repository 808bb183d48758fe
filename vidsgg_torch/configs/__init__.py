from vidsgg_torch.configs.tempura import TempuraRunConfig

__all__ = ["TempuraRunConfig"]
