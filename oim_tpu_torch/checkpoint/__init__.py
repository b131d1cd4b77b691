"""Checkpoints with exact resume, and params-only exports for serving."""

from oim_tpu_torch.checkpoint.manager import (
    Checkpointer,
    CheckpointerOptions,
    directory_bytes,
    load_params,
)

__all__ = ["Checkpointer", "CheckpointerOptions", "directory_bytes",
           "load_params"]
