"""Checkpoints of the port: trees <-> the reference's npz format, with
integrity checks and asynchronous saves (checkpoint/store.py)."""
from repro_torch.checkpoint.store import (
    CheckpointCorruptError,
    CheckpointManager,
    checkpoint_steps,
    latest_step,
    load_pytree,
    save_pytree,
    verify_checkpoint,
)

__all__ = [
    "CheckpointCorruptError",
    "CheckpointManager",
    "checkpoint_steps",
    "latest_step",
    "load_pytree",
    "save_pytree",
    "verify_checkpoint",
]
