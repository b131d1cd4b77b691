"""Tensor ops of the port: RoPE, RMSNorm, KV quantization, the paged
KV layout, and the paged-attention kernel wrappers."""
