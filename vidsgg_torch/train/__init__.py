from vidsgg_torch.train.eval_pipeline import EvalPipeline
from vidsgg_torch.train.optim import ReferenceAdamW, reference_lr
from vidsgg_torch.train.state import (
    ServingState,
    TrainState,
    create_serving_state,
    create_train_state,
)
from vidsgg_torch.train.steps import LossFlags, eval_step, make_train_step

__all__ = ["EvalPipeline", "LossFlags", "ReferenceAdamW", "ServingState", "TrainState",
           "create_serving_state", "create_train_state", "eval_step", "make_train_step",
           "reference_lr"]
