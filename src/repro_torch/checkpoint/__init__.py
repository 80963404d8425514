"""Atomic checkpoints of the port (counterpart of ``repro/checkpoint``)."""

from .ckpt import (  # noqa: F401
    CheckpointManager, all_steps, latest_step, restore_checkpoint,
    save_checkpoint,
)
