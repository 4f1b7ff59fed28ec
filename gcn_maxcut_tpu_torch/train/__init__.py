"""train: see the counterpart in gcn_maxcut_tpu/train/."""

from gcn_maxcut_tpu_torch.train.checkpoint import (
    checkpoint_name,
    load_checkpoint,
    save_checkpoint,
)
from gcn_maxcut_tpu_torch.train.config import TrainingConfig
from gcn_maxcut_tpu_torch.train.loop import (
    TrainState,
    evaluate_model,
    init_early_stop_state,
    make_epoch_fn,
    make_monitored_epoch_fn,
    setup_train_state,
    train_dataset,
    train_from_files,
    train_model,
)
from gcn_maxcut_tpu_torch.train.torch_compat import (
    config_from_torch,
    load_torch_checkpoint,
    save_torch_checkpoint,
)

__all__ = [
    "TrainingConfig",
    "TrainState",
    "setup_train_state",
    "make_epoch_fn",
    "make_monitored_epoch_fn",
    "init_early_stop_state",
    "train_model",
    "train_dataset",
    "train_from_files",
    "evaluate_model",
    "save_checkpoint",
    "load_checkpoint",
    "checkpoint_name",
    "load_torch_checkpoint",
    "save_torch_checkpoint",
    "config_from_torch",
]
