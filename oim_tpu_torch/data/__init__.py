"""The training input pipeline: deterministic token batches and their
background copy onto the device."""
