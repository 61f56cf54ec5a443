from repro_torch.train.steps import (TrainState, init_train_state,
                                     make_measured_train_step,
                                     make_train_step)

__all__ = ["TrainState", "make_train_step", "make_measured_train_step",
           "init_train_state"]
