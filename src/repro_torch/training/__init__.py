"""Training on one device: optimizer, data, checkpointing, train step.
The counterpart of ``src/repro/training`` (its gradient compression and
pipeline parallelism are not ported yet)."""

from .optimizer import AdamWConfig, adamw_update, init_opt_state, lr_at
from .train_loop import make_eval_step, make_train_step
from .checkpoint import Checkpointer
from .data import DataConfig, PrefetchLoader, SyntheticPackedDataset

__all__ = ["AdamWConfig", "adamw_update", "init_opt_state", "lr_at",
           "make_eval_step", "make_train_step", "Checkpointer",
           "DataConfig", "PrefetchLoader", "SyntheticPackedDataset"]
