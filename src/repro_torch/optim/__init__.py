from repro_torch.optim.optimizers import (OptState, OptimizerConfig,
                                          adafactor, adamw,
                                          clip_by_global_norm, global_norm,
                                          make_optimizer, wsd_schedule)

__all__ = ["OptimizerConfig", "OptState", "adamw", "adafactor",
           "make_optimizer", "clip_by_global_norm", "global_norm",
           "wsd_schedule"]
