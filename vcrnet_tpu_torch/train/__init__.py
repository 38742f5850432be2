from vcrnet_tpu_torch.train.engine import Trainer
from vcrnet_tpu_torch.train.optim import (
    EARLY_STOP_LR, MultiStepLR, ReduceLROnPlateau, initial_lr, make_optimizer, set_lr,
)

__all__ = [
    "Trainer", "EARLY_STOP_LR", "MultiStepLR", "ReduceLROnPlateau", "initial_lr",
    "make_optimizer", "set_lr",
]
