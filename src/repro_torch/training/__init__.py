"""Training: optimizer, data, checkpointing, train step (on one device
or sharded over a mesh). The counterpart of ``src/repro/training``. As
there, gradient compression (``training.grad_comp``) and GPipe
(``training.pipeline``) are modules of their own, not exported here and
not wired into the train step."""

from .optimizer import AdamWConfig, adamw_update, init_opt_state, lr_at
from .train_loop import make_eval_step, make_train_step
from .checkpoint import Checkpointer
from .data import DataConfig, PrefetchLoader, SyntheticPackedDataset

__all__ = ["AdamWConfig", "adamw_update", "init_opt_state", "lr_at",
           "make_eval_step", "make_train_step", "Checkpointer",
           "DataConfig", "PrefetchLoader", "SyntheticPackedDataset"]
