"""Training loop of the port (``repro/train`` in PyTorch; checkpoints
come with ROADMAP item 21)."""

from repro_torch.train.loop import (
    TrainConfig,
    lm_loss,
    make_train_step,
    train,
    value_and_grad,
)

__all__ = ["TrainConfig", "lm_loss", "make_train_step", "train",
           "value_and_grad"]
