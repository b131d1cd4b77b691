"""Int8 quantization for the KV cache (plain PyTorch).

Symmetric per-(token, head) max-abs scaling, one f32 scale per stored
[head_dim] int8 vector — the exact formula of
``oim_tpu/ops/quant.py::quantize_int8``: ``scale = max(amax / 127,
1e-8)`` and ``q = round(x / scale)`` with a true division and
round-half-to-even (``torch.round`` and ``jnp.round`` both round ties to
even), so the bytes the port stores equal the reference's bit for bit.
int4 KV waits for packed nibbles in the CUDA kernels (ROADMAP Queue A).
"""

from __future__ import annotations

import torch

# Symmetric int8 range; -128 is unused so the scale inverts exactly.
_INT8_MAX = 127.0
_EPS = 1e-8


def quantize_int8(x):
    """[..., d] float → (int8 values [..., d], f32 scales [...])."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1)
    # Divide by a device tensor, not a Python number: PyTorch's CUDA
    # division multiplies by the reciprocal of a scalar divisor, which
    # rounds differently from the true division of the reference and of
    # the K2 kernel.
    scale = torch.clamp_min(amax / amax.new_tensor(_INT8_MAX), _EPS)
    q = torch.round(xf / scale[..., None]).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    """Inverse of ``quantize_int8``: int8 [..., d] × f32 [...] → f32."""
    return q.to(torch.float32) * scale[..., None]


def make_kv_buffers(shape, compute_dtype, quantized, device=None):
    """Zeroed (k, v, k_scale, v_scale) cache buffers for ``shape``
    [..., rows, kv_heads, head_dim]: int8 payloads with distinct f32
    scale planes (ones) when ``quantized`` is truthy (``True`` or
    ``"int8"``), else ``compute_dtype`` payloads and None scales."""
    if quantized == "int4":
        raise ValueError(
            "int4 KV is not ported yet: it needs packed nibbles in both "
            "paged-attention kernels (ROADMAP Queue A, kv_int4)"
        )
    dt = torch.int8 if quantized else compute_dtype

    def scale():
        if not quantized:
            return None
        return torch.ones(shape[:-1], dtype=torch.float32, device=device)

    return (
        torch.zeros(shape, dtype=dt, device=device),
        torch.zeros(shape, dtype=dt, device=device),
        scale(),
        scale(),
    )
