from pmhc_tpu_torch.train.checkpoints import CheckpointManager
from pmhc_tpu_torch.train.metrics import MetricsRecord
from pmhc_tpu_torch.train.trainer import (
    Adam,
    TrainConfig,
    Trainer,
    eval_step,
    make_learning_rate,
    save_state_dict,
    train_step,
)

__all__ = [
    "Adam",
    "CheckpointManager",
    "MetricsRecord",
    "TrainConfig",
    "Trainer",
    "eval_step",
    "make_learning_rate",
    "save_state_dict",
    "train_step",
]
