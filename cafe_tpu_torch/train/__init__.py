from .loop import build_all, get_dataset, model_arch
from .step import TrainState, build_eval_step, build_train_step, init_state

__all__ = ["TrainState", "build_all", "build_eval_step", "build_train_step",
           "get_dataset", "init_state", "model_arch"]
