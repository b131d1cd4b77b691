"""Checkpoints with exact resume, and params-only exports for serving."""

from oim_tpu_torch.checkpoint.manager import (
    Checkpointer,
    CheckpointerOptions,
    directory_bytes,
    load_params,
    load_params_from_peer,
)

__all__ = ["Checkpointer", "CheckpointerOptions", "directory_bytes",
           "load_params", "load_params_from_peer"]
