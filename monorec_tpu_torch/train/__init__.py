"""Training of the port (``monorec_tpu/train``): the stage-1 trainer, the
stage 2-4 trainer, their optimizers and schedules, logs and checkpoints."""

from monorec_tpu_torch.train.monorec_trainer import MonoRecTrainer
from monorec_tpu_torch.train.state import Adam, make_optimizer, make_schedule
from monorec_tpu_torch.train.trainer import Trainer, apply_gradients_guarded

__all__ = ["Adam", "MonoRecTrainer", "Trainer", "apply_gradients_guarded", "make_optimizer",
           "make_schedule"]
