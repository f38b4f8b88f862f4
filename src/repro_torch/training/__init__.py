"""The training substrate of the port: AdamW, LR schedules, the synthetic
data pipeline, checkpoints and the train step, copies of the JAX
package's ``repro.training`` on tensors."""
from repro_torch.training.data import DataConfig, batches
from repro_torch.training.optimizer import (AdamWConfig, OptState,
                                            adamw_update, init_opt_state)
from repro_torch.training.schedules import SCHEDULES, cosine, wsd
from repro_torch.training.train_step import (cross_entropy, loss_fn,
                                             make_train_step, train_step)

__all__ = [
    "AdamWConfig", "OptState", "init_opt_state", "adamw_update",
    "cosine", "wsd", "SCHEDULES", "DataConfig", "batches",
    "cross_entropy", "loss_fn", "train_step", "make_train_step",
]
