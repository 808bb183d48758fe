from vidsgg_torch.train.eval_pipeline import EvalPipeline
from vidsgg_torch.train.state import ServingState, create_serving_state

__all__ = ["EvalPipeline", "ServingState", "create_serving_state"]
