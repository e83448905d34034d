from .loop import build_all, get_dataset, inference, model_arch, run
from .step import (TrainState, build_eval_step, build_multi_step,
                   build_quantized_eval_step, build_train_step, init_state)

__all__ = ["TrainState", "build_all", "build_eval_step", "build_multi_step",
           "build_quantized_eval_step", "build_train_step", "get_dataset", "inference", "init_state",
           "model_arch", "run"]
