"""The training path: train steps, the fault-tolerant LM trainer,
checkpoints and the fault-tolerant GAN trainer. Mirrors
``repro/train/__init__.py``."""
from repro_torch.train.checkpoint import (
    latest_step,
    place_like,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.train.gan_trainer import GanTrainer, GanTrainerConfig
from repro_torch.train.train_step import TrainConfig, make_eval_step, make_train_step
from repro_torch.train.trainer import Trainer

__all__ = ["TrainConfig", "make_train_step", "make_eval_step", "Trainer",
           "save_checkpoint", "restore_checkpoint", "latest_step", "place_like",
           "GanTrainer", "GanTrainerConfig"]
