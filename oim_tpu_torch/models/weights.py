"""Parameter layout conversions.

The reference keeps parameters as one dict of stacked arrays
(``[n_stages, layers_per_stage, ...]`` for layer weights); the port keeps
``{"wte", "final_norm", "wlm", "layers": [per-layer dict]}`` with every
tensor already in the dtype the forward reads (``prepare_param``), or
with every tensor f32 as training's masters.  ``from_jax_params`` maps
the first onto the second (``from_jax_lora`` does the same for LoRA
adapters) — it is how the parity tests make both
packages compute (and train) the same function, and how a replica loads
weights streamed from a sibling of either package — and
``to_jax_params`` maps back (``jax_leaves`` lazily, one part of a leaf
at a time: what ``GET /v1/weights`` streams).  ``recast`` re-prepares a
port dict for another compute dtype (the f32 reference forward over a
bf16 model's weights).  Weight-quantized trees (``ops/quant.py``: int8
or packed int4 payloads with ``<name>_wscale`` companions) carry their
payloads and f32 scales unchanged; on the reference's side an int4
payload is one value a byte (``jnp.int4``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable

import numpy as np
import torch

from oim_tpu_torch.models.decode import _LAYER_ENTRIES
from oim_tpu_torch.models.train import named_parameters
from oim_tpu_torch.models.transformer import TransformerConfig, prepare_param
from oim_tpu_torch.ops.quant import (
    INT4_DTYPE,
    WEIGHT_QUANT_TARGETS,
    _int4_group,
    int4_din,
    pack_weight_int4,
    unpack_int4,
    weight_quant_mode,
)
from oim_tpu_torch.serve.disagg import dtype_name

_TOP = ("wte", "final_norm", "wlm", "wlm_wscale")


def _torch_leaf(value, dtype: torch.dtype) -> torch.Tensor:
    """A reference leaf as a torch tensor of ``dtype``: a numpy array
    (JAX's ``int4`` widened as ``astype(np.int8)``), or a torch tensor —
    host or device, as ``load_params_from_peer`` reads them — cast where
    it stands."""
    if isinstance(value, torch.Tensor):
        return value.to(dtype)
    arr = np.asarray(value)
    if dtype == torch.int8:
        return torch.from_numpy(np.ascontiguousarray(arr.astype(np.int8)))
    return torch.tensor(np.asarray(arr, dtype=np.float32))


def _int4_payload(value, scale) -> bool:
    """Whether a scaled payload holds int4 values: JAX's ``int4`` dtype,
    or int8 values whose group-wise scale has as many dimensions as the
    payload (a per-channel int8 scale has one fewer)."""
    return str(value.dtype) == "int4" or np.ndim(scale) == np.ndim(value)


def _flat_layers(tree: dict, cfg: TransformerConfig) -> dict:
    """The stacked ``[n_stages, layers_per_stage, ...]`` layer entries
    collapsed to ``[n_layers, ...]`` (numpy arrays or torch tensors)."""
    def flat(value):
        if isinstance(value, torch.Tensor):
            return value.reshape(cfg.n_layers, *value.shape[2:])
        return np.asarray(value).reshape(cfg.n_layers, *np.shape(value)[2:])

    return {name: flat(tree[name]) for name in _LAYER_ENTRIES
            if name in tree}


def from_jax_params(tree: dict, cfg: TransformerConfig, device=None,
                    master: bool = False) -> dict:
    """Reference parameter dict (layer weights stacked ``[n_stages,
    layers_per_stage, ...]``; numpy arrays, or torch tensors as
    ``load_params_from_peer`` reads them, bf16 included) → the port's
    serving layout on ``device``, or, when ``master``, every tensor f32
    as training's masters (the reference's ``param_dtype``).  MoE trees
    carry ``router`` and ``[E, ...]`` experts per layer.  A
    weight-quantized tree (``quantize_params_int8``/``_int4``'s:
    ``<name>_wscale`` companions) keeps its int8 payloads and f32 scales
    as they are; int4 payloads (``jnp.int4`` arrays, or int8 values) are
    widened to int8 and packed (``pack_weight_int4``).  Serving only:
    ``master`` refuses them."""
    quantized = any(name.endswith("_wscale") for name in tree)
    if quantized and master:
        raise ValueError("training masters are never weight-quantized")

    def tensor(source, name, value):
        if f"{name}_wscale" in source:
            values = _torch_leaf(value, torch.int8)
            if _int4_payload(source[name], source[f"{name}_wscale"]):
                return pack_weight_int4(values.to(device))
            return values.to(device)
        arr = _torch_leaf(value, torch.float32).to(device)
        if master or name.endswith("_wscale"):
            return arr
        return prepare_param(name, arr, cfg)

    params = {name: tensor(tree, name, tree[name]) for name in _TOP
              if name in tree}
    stacked = _flat_layers(tree, cfg)
    params["layers"] = [
        {name: tensor(stacked, name, value[i])
         for name, value in stacked.items()}
        for i in range(cfg.n_layers)
    ]
    return params


def from_jax_lora(adapters: dict, cfg: TransformerConfig,
                  device=None) -> dict:
    """Reference LoRA adapters (numpy arrays ``{<target>_a, <target>_b}``
    stacked ``[n_stages, layers_per_stage, ...]``) → the port's
    ``{"layers": [per-layer dict]}`` of f32 tensors on ``device``."""
    stacked = {name: np.asarray(value, dtype=np.float32).reshape(
                   cfg.n_layers, *np.shape(value)[2:])
               for name, value in adapters.items()}
    return {"layers": [
        {name: torch.tensor(value[i], device=device)
         for name, value in stacked.items()}
        for i in range(cfg.n_layers)
    ]}


@dataclass
class JaxLeaf:
    """One leaf of the reference's flat parameter dict, as the port
    holds it: its name, the reference's dtype name (``"int4"`` for an
    int4 payload, one value a byte), its shape, and the parts whose
    C-order bytes, concatenated, are the leaf's — callables returning
    tensors where the port's tensors lie (one per layer of a stacked
    leaf), each made only when called (``wlm`` narrowed to the compute
    dtype, an int4 payload unpacked)."""

    name: str
    dtype: str
    shape: tuple[int, ...]
    parts: list[Callable[[], torch.Tensor]]


def int4_values(raw: torch.Tensor) -> torch.Tensor:
    """int8 values of int4 leaf bytes (one value a byte, in its low
    nibble as ``jnp.int4`` stores it; a sign-extended byte reads the
    same)."""
    return (raw.view(torch.int8) << 4) >> 4


def _jax_part(tree: dict, name: str, cfg: TransformerConfig):
    """(the reference's dtype name, shape, part) of one port tensor."""
    t = tree[name]
    if t.dtype == INT4_DTYPE and f"{name}_wscale" in tree:
        din = int4_din(t, tree[f"{name}_wscale"])
        shape = (*t.shape[:-2], din, t.shape[-1])
        return "int4", shape, (
            lambda: (unpack_int4(t, dim=-2)[..., :din, :] & 0xF).to(
                torch.uint8))
    if name == "wlm" and "wlm_wscale" not in tree:
        # The forward's widened copy of compute-dtype values: exact back.
        return dtype_name(cfg.compute_dtype), tuple(t.shape), (
            lambda: t.to(cfg.compute_dtype))
    return dtype_name(t.dtype), tuple(t.shape), (lambda: t)


def jax_leaves(params: dict, cfg: TransformerConfig) -> list[JaxLeaf]:
    """The reference's flat parameter dict of ``params`` as lazy
    ``JaxLeaf``s sorted by name (the order ``GET /v1/weights`` streams
    them): layer entries stacked ``[1, n_layers, ...]`` (one stage, as
    the reference serves), every leaf in the dtype the port serves it in
    (``wlm`` in the compute dtype), int4 payloads as one value a byte:
    its low nibble, a ``torch.uint8`` part."""
    leaves = []
    for name in [n for n in _TOP if n in params]:
        dtype, shape, part = _jax_part(params, name, cfg)
        leaves.append(JaxLeaf(name, dtype, shape, [part]))
    layers = params["layers"]
    for name in layers[0]:
        parts = [_jax_part(lp, name, cfg) for lp in layers]
        dtype, shape, _ = parts[0]
        leaves.append(JaxLeaf(name, dtype, (1, cfg.n_layers, *shape),
                              [part for _, _, part in parts]))
    return sorted(leaves, key=lambda leaf: leaf.name)


def to_jax_params(params: dict, cfg: TransformerConfig) -> dict:
    """The inverse of ``from_jax_params`` on a serving tree: the
    reference's flat dict (``jax_leaves``' names, shapes and dtypes) of
    host torch tensors, an int4 payload as its int8 values."""
    out = {}
    for leaf in jax_leaves(params, cfg):
        flat = torch.cat([part().reshape(-1).cpu() for part in leaf.parts])
        if leaf.dtype == "int4":
            flat = int4_values(flat)
        out[leaf.name] = flat.reshape(leaf.shape)
    return out


def recast(params: dict, cfg: TransformerConfig, dtype: str) -> tuple:
    """(params, cfg) with the compute dtype switched to ``dtype`` — a
    copy of every tensor (the f32 reference forward reads the served
    bf16 values widened to f32); weight-quantized payloads and their
    scales are kept as they are (the product rounds them to the new
    compute dtype)."""
    new_cfg = replace(cfg, dtype=dtype)

    def cast(tree, name):
        t = tree[name]
        if name.endswith("_wscale") or f"{name}_wscale" in tree:
            return t.clone()
        return prepare_param(name, t, new_cfg)

    out = {name: cast(params, name) for name in params if name != "layers"}
    out["layers"] = [{name: cast(lp, name) for name in lp}
                     for lp in params["layers"]]
    return out, new_cfg


def _quant_shapes(name: str, shape: tuple, mode: str,
                  int4_group: int) -> dict:
    """``{name: payload shape, name_wscale: scale shape}`` of a weight
    of ``shape`` [..., din, dout] under weight quant ``mode``."""
    *lead, din, dout = shape
    if mode == "int8":
        return {name: shape, f"{name}_wscale": (*lead, dout)}
    g = _int4_group(din, int4_group)
    return {name: (*lead, -(-din // 2), dout),
            f"{name}_wscale": (*lead, din // g, dout)}


def param_shapes(cfg: TransformerConfig, weight_quant: str = "",
                 int4_group: int = 64) -> dict:
    """``{dotted name: shape}`` of every parameter ``init_params`` makes
    for ``cfg`` (layers as ``layers.<i>.<name>``): under ``weight_quant``
    ("int8" or "int4") each target weight's payload and its
    ``_wscale``."""
    d, v, f = cfg.d_model, cfg.vocab_size, cfg.ff_dim
    n, kvn = cfg.n_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim
    e = (cfg.n_experts,) if cfg.n_experts else ()
    layer = {"attn_norm": (d,), "wq": (d, n), "wk": (d, kvn),
             "wv": (d, kvn), "wo": (n, d), "mlp_norm": (d,),
             "w_gate": (*e, d, f), "w_in": (*e, d, f), "w_out": (*e, f, d)}
    if cfg.n_experts:
        layer["router"] = (d, cfg.n_experts)
    if cfg.attn_bias:
        layer.update(bq=(n,), bk=(kvn,), bv=(kvn,))
    shapes = {"wte": (v, d), "final_norm": (d,), "wlm": (d, v)}
    if weight_quant:
        for tree in (shapes, layer):
            for name in [n for n in tree if n in WEIGHT_QUANT_TARGETS]:
                tree.update(_quant_shapes(name, tree[name], weight_quant,
                                          int4_group))
    for i in range(cfg.n_layers):
        shapes.update({f"layers.{i}.{k}": s for k, s in layer.items()})
    return shapes


def check_params(params: dict, cfg: TransformerConfig, what: str,
                 int4_group: int = 64) -> None:
    """Raise unless ``params`` (loaded from ``what``) hold exactly the
    parameters ``cfg`` describes, at their shapes (weight-quantized ones
    as ``param_shapes`` lays them out, int4 in groups of
    ``int4_group``)."""
    got = {name: tuple(t.shape) for name, t in named_parameters(params)}
    want = param_shapes(cfg, weight_quant_mode(params), int4_group)
    if got != want:
        bad = sorted(name for name in set(got) | set(want)
                     if got.get(name) != want.get(name))
        raise ValueError(
            f"{what} does not match the model flags at {bad[:6]}: "
            f"{[(got.get(b), want.get(b)) for b in bad[:6]]}")


def _count(tree: dict) -> int:
    """Weights in ``tree``, each at its logical size (a packed int4
    payload counts its values, ``_wscale`` scales are not counted)."""
    total = 0
    for name, t in tree.items():
        if name == "layers" or name.endswith("_wscale"):
            continue
        if t.dtype == INT4_DTYPE and f"{name}_wscale" in tree:
            scale = tree[f"{name}_wscale"]
            total += t.numel() // t.shape[-2] * int4_din(t, scale)
        else:
            total += t.numel()
    return total


def n_params(params: dict) -> int:
    """Parameter count of a port parameter dict (the reference's: a
    quantized weight counts its values, its scales not at all)."""
    return _count(params) + sum(_count(lp) for lp in params["layers"])


def to_device(params: dict, device) -> dict:
    """The same parameters on ``device`` (tensors already there are
    reused, not copied)."""
    out = {name: t.to(device) for name, t in params.items()
           if name != "layers"}
    out["layers"] = [
        {name: t.to(device) for name, t in lp.items()}
        for lp in params["layers"]
    ]
    return out
