"""Rotary position embeddings (plain PyTorch: elementwise work beside the
projections, no kernel of its own)."""

from __future__ import annotations

import math

import torch


def rope_frequencies(
    head_dim: int, theta: float = 10000.0, scaling: tuple = (),
    device=None,
) -> torch.Tensor:
    """Inverse frequencies for the rotated half-pairs: [head_dim // 2] f32.

    ``scaling`` is the Llama-3.1 long-context remap as a 4-tuple
    ``(factor, low_freq_factor, high_freq_factor, original_max_position)``
    (empty = plain RoPE): wavelengths shorter than ``original/high`` keep
    their frequency, longer than ``original/low`` divide by ``factor``,
    and the band between interpolates smoothly.
    """
    exponent = (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim
    )
    inv_freq = 1.0 / (theta**exponent)
    if not scaling:
        return inv_freq
    factor, low_fac, high_fac, original_max = scaling
    low_wavelen = original_max / low_fac
    high_wavelen = original_max / high_fac
    wavelen = 2.0 * math.pi / inv_freq
    # smooth in [0, 1]: 0 at the long-wavelength edge, 1 at the short.
    smooth = (original_max / wavelen - low_fac) / (high_fac - low_fac)
    smooth = smooth.clamp(0.0, 1.0)
    blended = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
    return torch.where(
        wavelen < high_wavelen,
        inv_freq,
        torch.where(wavelen > low_wavelen, inv_freq / factor, blended),
    )


def apply_rope(x, positions, theta: float = 10000.0, scaling: tuple = ()):
    """Rotate [..., T, H, D] by per-token ``positions`` [..., T] (global
    sequence positions; the engine passes [B, t]).  Interleaved pairs
    (x[..., 0::2], x[..., 1::2]) rotate in f32; the result keeps x's
    dtype."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, scaling, device=x.device)
    angles = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., :, None, :]  # [..., T, 1, D/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1 = x[..., 0::2].to(torch.float32)
    x2 = x[..., 1::2].to(torch.float32)
    rotated = torch.stack(
        (x1 * cos - x2 * sin, x1 * sin + x2 * cos), dim=-1
    ).reshape(x.shape)
    return rotated.to(x.dtype)
