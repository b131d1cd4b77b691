"""The quantization ladder (plain PyTorch): int8 and int4 for the KV
cache, weight-only int8 and int4 for the serving weights.

The formulas are ``oim_tpu/ops/quant.py``'s, so the values the port
stores equal the reference's bit for bit:

- KV (``quantize_int8``/``quantize_int4``): symmetric per-(token, head)
  max-abs scaling, one f32 scale per stored [head_dim] vector: ``scale =
  max(amax / 127, 1e-8)`` (int4: ``amax / 7``) and ``q = round(x /
  scale)`` (int4: clipped to ±7) with a true division and
  round-half-to-even (``torch.round`` and ``jnp.round`` both round ties
  to even).
- Weights (``quantize_weight_int8``): per output channel, the max-abs
  over the reduction axis ``din``, scales ``[..., dout]``;
  ``quantize_weight_int4``: group-wise along ``din`` (groups of
  ``_int4_group(din, group)`` rows, the gcd clamp), scales ``[...,
  din/g, dout]``.

Every division is by a device tensor, never a Python number: PyTorch's
CUDA division multiplies by the reciprocal of a scalar divisor, which
rounds differently from the true division of the reference and of the
kernels.

torch has no int4 dtype, so int4 values are stored as packed nibbles,
two a byte, in ``torch.uint8`` tensors (``pack_int4``): the dtype alone
tells a packed int4 payload from an int8 one everywhere downstream, as
``jnp.int4`` does in the reference.  A KV pool packs along ``head_dim``
(byte j holds dims 2j and 2j + 1, the lower in the low nibble); a weight
packs along its reduction axis ``din`` (byte row j holds rows 2j and 2j
+ 1), padded by one zero row when ``din`` is odd — the product knows
``din`` from its input, and ``dequantize_weight_int4`` infers it from
the scale's groups (pass it for an odd ``din`` quantized as one group).

Weight quantization is inference-only, as in the reference: the
training path never sees quantized params.  A quantized tree keeps each
target weight's name for its payload and adds a ``<name>_wscale``
companion; ``dequantize_named`` is the one definition of that rule.
"""

from __future__ import annotations

import math

import torch

# Symmetric ranges; -128 and -8 are unused so the scales invert exactly.
_INT8_MAX = 127.0
_INT4_MAX = 7.0
_EPS = 1e-8

# The matmul weights that weight-only quantization replaces; the
# embedding (a gather), the norms and the MoE router (small, f32 on
# purpose) pass through.
WEIGHT_QUANT_TARGETS = (
    "wq", "wk", "wv", "wo", "w_gate", "w_in", "w_out", "wlm",
)
# The payload dtype of packed int4 values.
INT4_DTYPE = torch.uint8


def _scale(amax, qmax: float):
    """``max(amax / qmax, 1e-8)``, dividing by a device tensor."""
    return torch.clamp_min(amax / amax.new_tensor(qmax), _EPS)


# ---------------------------------------------------------------------------
# Packed nibbles


def pack_int4(q, dim: int = -1):
    """int4 values (any integer dtype, in [-8, 7]) → ``torch.uint8``
    with two values a byte along ``dim``, whose length must be even:
    byte j holds value 2j in its low nibble and 2j + 1 in its high one."""
    q = q.movedim(dim, -1).to(torch.int16)
    if q.shape[-1] % 2:
        raise ValueError(f"pack_int4 needs an even length along dim {dim}, "
                         f"got {q.shape[-1]}")
    lo, hi = q[..., 0::2] & 0xF, q[..., 1::2] & 0xF
    return (lo | (hi << 4)).to(torch.uint8).movedim(-1, dim)


def unpack_int4(p, dim: int = -1):
    """Inverse of ``pack_int4``: ``torch.uint8`` [..., n] along ``dim``
    → int8 values [..., 2n], sign-extended from the nibbles."""
    p = p.movedim(dim, -1).to(torch.int16)
    nib = torch.stack((p & 0xF, p >> 4), dim=-1).flatten(-2)
    return ((nib ^ 8) - 8).to(torch.int8).movedim(-1, dim)


# ---------------------------------------------------------------------------
# KV cache


def quantize_int8(x):
    """[..., d] float → (int8 values [..., d], f32 scales [...])."""
    xf = x.to(torch.float32)
    scale = _scale(torch.amax(torch.abs(xf), dim=-1), _INT8_MAX)
    q = torch.round(xf / scale[..., None]).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    """Inverse of ``quantize_int8``: int8 [..., d] × f32 [...] → f32.
    The values' dtype is free (int4 values widened to int8 too): the one
    dequant of the KV ladder."""
    return q.to(torch.float32) * scale[..., None]


def quantize_int4(x):
    """[..., d] float → (int4 values as int8 [..., d] in [-7, 7], f32
    scales [...]): ``quantize_int8`` with the int4 range, clipped.  The
    values are unpacked; a pool stores ``pack_int4`` of them."""
    xf = x.to(torch.float32)
    scale = _scale(torch.amax(torch.abs(xf), dim=-1), _INT4_MAX)
    q = torch.clamp(torch.round(xf / scale[..., None]), -_INT4_MAX,
                    _INT4_MAX).to(torch.int8)
    return q, scale


def kv_values(payload):
    """A KV payload's values as a dtype ``dequantize_int8`` reads: packed
    int4 unpacked along ``head_dim``, anything else as it is."""
    return unpack_int4(payload) if payload.dtype == INT4_DTYPE else payload


def make_kv_buffers(shape, compute_dtype, quantized, device=None):
    """Zeroed (k, v, k_scale, v_scale) cache buffers for ``shape``
    [..., rows, kv_heads, head_dim]: ``quantized`` falsy gives
    ``compute_dtype`` payloads and None scales; truthy (``True`` or
    ``"int8"``) int8 payloads, ``"int4"`` packed int4 payloads
    ``[..., head_dim / 2]`` of ``torch.uint8``, each with distinct f32
    scale planes (ones)."""
    if quantized == "int4":
        if shape[-1] % 2:
            raise ValueError(
                f"int4 KV packs two values a byte along head_dim: "
                f"head_dim {shape[-1]} must be even")
        dt, payload = INT4_DTYPE, (*shape[:-1], shape[-1] // 2)
    else:
        dt = torch.int8 if quantized else compute_dtype
        payload = tuple(shape)

    def scale():
        if not quantized:
            return None
        return torch.ones(shape[:-1], dtype=torch.float32, device=device)

    return (
        torch.zeros(payload, dtype=dt, device=device),
        torch.zeros(payload, dtype=dt, device=device),
        scale(),
        scale(),
    )


# ---------------------------------------------------------------------------
# Weights


def quantize_weight_int8(w):
    """Weight-only int8, per output channel: ``w [..., din, dout]`` →
    (int8 [..., din, dout], f32 scales [..., dout])."""
    wf = w.to(torch.float32)
    scale = _scale(torch.amax(torch.abs(wf), dim=-2), _INT8_MAX)
    q = torch.round(wf / scale[..., None, :]).to(torch.int8)
    return q, scale


def dequantize_weight_int8(q, scale):
    """Inverse of ``quantize_weight_int8``: f32 [..., din, dout]."""
    return q.to(torch.float32) * scale[..., None, :]


def _int4_group(din: int, group: int) -> int:
    """The effective group: the largest divisor of ``din`` that divides
    the requested group (their gcd), so any layer quantizes."""
    return max(1, math.gcd(din, group))


def pack_weight_int4(values):
    """int4 values [..., din, dout] → packed ``torch.uint8`` [...,
    ceil(din / 2), dout], one zero row padded after an odd ``din``."""
    if values.shape[-2] % 2:
        pad = values.new_zeros((*values.shape[:-2], 1, values.shape[-1]))
        values = torch.cat((values, pad), dim=-2)
    return pack_int4(values, dim=-2)


def quantize_weight_int4(w, group: int = 64):
    """Weight-only int4 with group-wise scales along ``din``: ``w [...,
    din, dout]`` → (packed uint8 [..., ceil(din/2), dout], f32 scales
    [..., din/g, dout]), g = ``_int4_group(din, group)``."""
    wf = w.to(torch.float32)
    din, dout = wf.shape[-2], wf.shape[-1]
    g = _int4_group(din, group)
    grouped = wf.reshape(*wf.shape[:-2], din // g, g, dout)
    scale = _scale(torch.amax(torch.abs(grouped), dim=-2), _INT4_MAX)
    q = torch.clamp(torch.round(grouped / scale[..., None, :]), -_INT4_MAX,
                    _INT4_MAX).to(torch.int8)
    return pack_weight_int4(q.reshape(wf.shape)), scale


def int4_din(packed, scale, din: int | None = None) -> int:
    """The reduction length of a packed int4 weight: ``din`` when given,
    else twice its byte rows, less the padding row when that length does
    not split into the scale's groups."""
    if din is not None:
        if -(-din // 2) != packed.shape[-2]:
            raise ValueError(f"din {din} does not fit {packed.shape[-2]} "
                             f"packed rows")
        return din
    din = 2 * packed.shape[-2]
    return din if din % scale.shape[-2] == 0 else din - 1


def dequantize_weight_int4(packed, scale, din: int | None = None):
    """Inverse of ``quantize_weight_int4``: f32 [..., din, dout] (``din``
    as ``int4_din`` finds it)."""
    din = int4_din(packed, scale, din)
    q = unpack_int4(packed, dim=-2)[..., :din, :]
    n_groups, dout = scale.shape[-2], scale.shape[-1]
    grouped = q.to(torch.float32).reshape(*q.shape[:-2], n_groups,
                                          din // n_groups, dout)
    return (grouped * scale[..., None, :]).reshape(q.shape)


def dequantize_weight(q, scale, din: int | None = None):
    """A quantized weight as f32: the payload's dtype selects the scheme
    (packed int4 group-wise, int8 per output channel)."""
    if q.dtype == INT4_DTYPE:
        return dequantize_weight_int4(q, scale, din)
    return dequantize_weight_int8(q, scale)


def _quantize_tree(tree: dict, quantize) -> dict:
    """Each ``WEIGHT_QUANT_TARGETS`` entry of ``tree`` (a layer dict, or
    the port's params with their ``layers`` list) replaced by
    ``quantize``'s payload plus a ``<name>_wscale`` companion."""
    out = {}
    for name, value in tree.items():
        if name == "layers":
            out[name] = [_quantize_tree(lp, quantize) for lp in value]
        elif name in WEIGHT_QUANT_TARGETS:
            out[name], out[f"{name}_wscale"] = quantize(value)
        else:
            out[name] = value
    return out


def quantize_params_int8(params: dict) -> dict:
    """Weight-only int8 for inference params (the port's layout or one
    layer's dict): every target weight int8 with its per-channel
    ``_wscale``; everything else passes through."""
    return _quantize_tree(params, quantize_weight_int8)


def quantize_params_int4(params: dict, group: int = 64) -> dict:
    """Weight-only int4 (group-wise) for inference params: the int8
    scheme's layout with packed int4 payloads."""
    return _quantize_tree(params,
                          lambda w: quantize_weight_int4(w, group))


def quantize_weight(w, mode: str, group: int = 64):
    """(payload, scale) of ``w`` under ``mode`` ("int8" or "int4")."""
    if mode == "int8":
        return quantize_weight_int8(w)
    if mode == "int4":
        return quantize_weight_int4(w, group)
    raise ValueError(f"unknown weight quant mode {mode!r}")


def dequantize_named(tree: dict, name: str, dtype=None):
    """``tree[name]`` dequantized iff its ``_wscale`` companion exists —
    the one definition of the companion rule — cast to ``dtype`` when
    given (the compute dtype the product reads)."""
    value = tree[name]
    scale = tree.get(f"{name}_wscale")
    if scale is None:
        return value
    deq = dequantize_weight(value, scale)
    return deq if dtype is None else deq.to(dtype)


def weight_quant_mode(params: dict) -> str:
    """'' (unquantized) | 'int8' | 'int4', from the payload dtype of any
    scaled weight (the port's layout or a flat dict)."""
    trees = [params, *params.get("layers", ())]
    for tree in trees:
        for name in tree:
            if name.endswith("_wscale"):
                value = tree[name[: -len("_wscale")]]
                return "int4" if value.dtype == INT4_DTYPE else "int8"
    return ""


def maybe_dequantize_weights(tree: dict, dtype=None) -> dict:
    """Undo ``quantize_params_int8``/``_int4`` on a dict holding
    quantized weights (the port's params or one layer's); everything
    else passes through.  The same dict when nothing is quantized."""
    if "layers" in tree:
        if not weight_quant_mode(tree):
            return tree
        top = {name: v for name, v in tree.items() if name != "layers"}
        return {**maybe_dequantize_weights(top, dtype),
                "layers": [maybe_dequantize_weights(lp, dtype)
                           for lp in tree["layers"]]}
    if not any(name.endswith("_wscale") for name in tree):
        return tree
    return {
        name: dequantize_named(tree, name, dtype)
        for name in tree
        if not name.endswith("_wscale")
    }
