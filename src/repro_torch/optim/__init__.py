"""Optimizers and schedules of the port (``repro/optim`` in PyTorch)."""

from repro_torch.optim.adam import (
    AdamState,
    adam_init,
    adam_update,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
    tree_leaves,
    tree_map,
    warmup_cosine_schedule,
)

__all__ = [
    "AdamState",
    "adam_init",
    "adam_update",
    "clip_by_global_norm",
    "cosine_schedule",
    "global_norm",
    "tree_leaves",
    "tree_map",
    "warmup_cosine_schedule",
]
