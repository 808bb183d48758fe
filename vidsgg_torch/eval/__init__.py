from vidsgg_torch.eval.adapter import to_eval_pred

__all__ = ["to_eval_pred"]
