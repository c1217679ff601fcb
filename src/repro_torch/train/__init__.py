"""Training loop of the port (``repro/train`` in PyTorch) and its
checkpoints in JAX's byte format."""

from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.train.loop import (
    TrainConfig,
    lm_loss,
    make_train_step,
    train,
    value_and_grad,
)

__all__ = ["TrainConfig", "lm_loss", "load_checkpoint", "make_train_step",
           "save_checkpoint", "train", "value_and_grad"]
