from vidsgg_torch.eval.adapter import to_eval_pred
from vidsgg_torch.eval.evaluator import SceneGraphEvaluator, get_ag_evaluators
from vidsgg_torch.eval.temporal import (
    evaluate_temporal_consistency,
    temporal_consistency_summary,
)

__all__ = [
    "SceneGraphEvaluator", "evaluate_temporal_consistency", "get_ag_evaluators",
    "temporal_consistency_summary", "to_eval_pred",
]
