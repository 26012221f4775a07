"""The trainer of the port: `optimizer` (AdamW, the cosine schedule) and
`loop` (the train step); the counterpart of `repro.train`."""
from .loop import TrainCfg, TrainState, init_state, make_train_step
from .optimizer import (AdamWState, adamw_init, adamw_update,
                        clip_by_global_norm, cosine_schedule)

__all__ = ["AdamWState", "TrainCfg", "TrainState", "adamw_init",
           "adamw_update", "clip_by_global_norm", "cosine_schedule",
           "init_state", "make_train_step"]
