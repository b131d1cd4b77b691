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

Over a mesh, ``serve_specs`` says how each served parameter shards (the
counterpart of the reference engine's ``serve_param_shardings``),
``shard_params`` keeps one rank's blocks of a tree and ``rank_config``
describes the model that rank runs (``ShardedConfig``); ``gather_leaf``
and ``gather_params`` are ``shard_params``' exact inverse (the whole
tensors ``GET /v1/weights`` streams from a mesh's leader), and
``port_tensor`` lays out one reference leaf, so that a peer's stream is
cut to a rank's shard a leaf at a time.

Trained over a mesh, the f32 masters shard by the same layout
(``serve_specs`` with no weight quant: ``param_pspecs``' logical axes,
the reference's ``logical_axes``): ``init_rank_params`` draws them as
one device draws them and keeps this rank's blocks, and
``train_config`` is the model a rank trains.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable

import numpy as np
import torch

from oim_tpu_torch.models.decode import _LAYER_ENTRIES
from oim_tpu_torch.models.transformer import (
    ShardedConfig,
    TransformerConfig,
    init_params,
    named_parameters,
    param_pspecs,
    prepare_param,
)
from oim_tpu_torch.ops.quant import (
    INT4_DTYPE,
    WEIGHT_QUANT_TARGETS,
    _int4_group,
    int4_din,
    pack_weight_int4,
    unpack_int4,
    weight_quant_mode,
)
from oim_tpu_torch.parallel.sharding import PartitionSpec, fitted, shard
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
        payload = ""
        if f"{name}_wscale" in source:
            payload = ("int4" if _int4_payload(
                source[name], source[f"{name}_wscale"]) else "int8")
        return port_tensor(name, value, cfg, device, payload, master)

    params = {name: tensor(tree, name, tree[name]) for name in _TOP
              if name in tree}
    stacked = _flat_layers(tree, cfg)
    params["layers"] = [
        {name: tensor(stacked, name, value[i])
         for name, value in stacked.items()}
        for i in range(cfg.n_layers)
    ]
    return params


def port_tensor(name: str, value, cfg: TransformerConfig, device=None,
                payload: str = "", master: bool = False) -> torch.Tensor:
    """One reference leaf (one layer's part of a stacked one) as the
    port serves it on ``device``: ``payload`` "int8" or "int4" for a
    weight-quantized payload (int4 values packed), else a float leaf
    prepared for the compute dtype (a ``_wscale`` scale, or every leaf
    when ``master``, stays f32)."""
    if payload:
        values = _torch_leaf(value, torch.int8).to(device)
        return pack_weight_int4(values) if payload == "int4" else values
    arr = _torch_leaf(value, torch.float32).to(device)
    if master or name.endswith("_wscale"):
        return arr
    return prepare_param(name, arr, cfg)


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


def _jax_part(tree: dict, name: str, cfg: TransformerConfig, get=None):
    """(the reference's dtype name, shape, part) of one port tensor;
    ``get`` (when given) returns the tensor the part reads, ``tree``
    then only describing it."""
    t = tree[name]
    get = get or (lambda: t)
    if t.dtype == INT4_DTYPE and f"{name}_wscale" in tree:
        din = int4_din(t, tree[f"{name}_wscale"])
        shape = (*t.shape[:-2], din, t.shape[-1])
        return "int4", shape, (
            lambda: (unpack_int4(get(), dim=-2)[..., :din, :] & 0xF).to(
                torch.uint8))
    if name == "wlm" and "wlm_wscale" not in tree:
        # The forward's widened copy of compute-dtype values: exact back.
        return dtype_name(cfg.compute_dtype), tuple(t.shape), (
            lambda: get().to(cfg.compute_dtype))
    return dtype_name(t.dtype), tuple(t.shape), get


def jax_leaves(params: dict, cfg: TransformerConfig,
               fetch=None) -> list[JaxLeaf]:
    """The reference's flat parameter dict of ``params`` as lazy
    ``JaxLeaf``s sorted by name (the order ``GET /v1/weights`` streams
    them): layer entries stacked ``[1, n_layers, ...]`` (one stage, as
    the reference serves), every leaf in the dtype the port serves it in
    (``wlm`` in the compute dtype), int4 payloads as one value a byte:
    its low nibble, a ``torch.uint8`` part.  With ``fetch`` (a mesh's
    leader: ``fetch(layer index or None, name)`` returns the whole
    tensor, gathered from the ranks' shards when its part is made)
    ``params`` only describes the whole tensors (``whole_meta``)."""

    def get(layer, name):
        return None if fetch is None else (lambda: fetch(layer, name))

    leaves = []
    for name in [n for n in _TOP if n in params]:
        dtype, shape, part = _jax_part(params, name, cfg, get(None, name))
        leaves.append(JaxLeaf(name, dtype, shape, [part]))
    layers = params["layers"]
    for name in layers[0]:
        parts = [_jax_part(lp, name, cfg, get(i, name))
                 for i, lp in enumerate(layers)]
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


# ---------------------------------------------------------------------------
# Sharded serving


def serve_specs(cfg: TransformerConfig, mesh, weight_quant: str = "",
                int4_group: int = 64) -> dict:
    """``{name: PartitionSpec}`` of every served parameter name (the
    port's layout: a layer's names without the reference's stacked
    ``[stages, layers]`` dims), by ``param_pspecs``' logical axes
    (heads, mlp, vocab → ``tp``; experts → ``ep``), fitted to the full
    shapes as the reference's ``serve_param_shardings`` fits them: an
    axis that does not divide a dimension replicates it.  Two rules of
    the port's own.  A packed int4 weight sharded along its reduction
    axis keeps whole groups of an even row count a rank (its bytes hold
    row pairs), else that axis replicates.  The MLP's three weights
    shard their ``mlp`` axis together or not at all, so a replicated
    ``w_out`` never meets sharded columns.  Weight-quant companions
    follow their weight: an int8 ``_wscale`` drops the reduction axis's
    entry, an int4 one shards its groups as the weight's rows shard.
    LoRA adapters and anything else unnamed replicate."""
    shapes = param_shapes(replace(cfg, n_layers=1))
    base = {}
    for name, spec in param_pspecs(cfg).items():
        if len(spec) > 1 and spec[0] == "pp":
            spec = spec[2:]  # [stages, layers, ...] → one layer's dims
        key = name if name in shapes else f"layers.0.{name}"
        base[name] = fitted(shapes[key], spec, mesh)
    if weight_quant == "int4":
        for name in WEIGHT_QUANT_TARGETS:
            spec = base.get(name)
            if spec is None or spec[-2] is None:
                continue
            din = shapes.get(name, shapes.get(f"layers.0.{name}"))[-2]
            rows = din // mesh.axis_size(spec[-2])
            if rows % _int4_group(din, int4_group) or rows % 2:
                base[name] = PartitionSpec(*spec[:-2], None, spec[-1])
    mlp = [base[n] for n in ("w_gate", "w_in")] + [base["w_out"]]
    if any(s[-1] is None for s in mlp[:2]) or mlp[2][-2] is None:
        for name in ("w_gate", "w_in"):
            base[name] = PartitionSpec(*base[name][:-1], None)
        base["w_out"] = PartitionSpec(*base["w_out"][:-2], None,
                                      base["w_out"][-1])
    specs = dict(base)
    for name in WEIGHT_QUANT_TARGETS:
        spec = base.get(name)
        if spec is None or not weight_quant:
            continue
        if weight_quant == "int8":
            specs[f"{name}_wscale"] = PartitionSpec(*spec[:-2], spec[-1])
        else:
            specs[f"{name}_wscale"] = spec
    return specs


def _quant_args(params: dict, cfg: TransformerConfig) -> tuple:
    """(weight quant mode, int4 group) of ``params``: the group read off
    ``wq``'s scale, ``din`` over its groups."""
    mode = weight_quant_mode(params)
    if mode != "int4":
        return mode, 64
    return mode, cfg.d_model // params["layers"][0]["wq_wscale"].shape[-2]


def specs_of(params: dict, cfg: TransformerConfig, mesh) -> dict:
    """``serve_specs`` for the weight quantization ``params`` carry."""
    return serve_specs(cfg, mesh, *_quant_args(params, cfg))


def shard_tensor(name: str, value: torch.Tensor, specs: dict,
                 mesh) -> torch.Tensor:
    """This rank's block of one whole served tensor ``name`` under
    ``specs`` (``serve_specs``), copied so that the whole can be freed;
    a name with no spec (replicated) as it is."""
    spec = specs.get(name)
    if spec is None:
        return value
    return shard(value, spec, mesh).contiguous()


def _block(value: torch.Tensor, spec, full_shape, mesh) -> torch.Tensor:
    """This rank's block of one parameter: the full one sliced and
    copied, so that the rest can be freed; one already at its block's
    shape (a tree loaded sharded) as it is."""
    full_shape = tuple(full_shape)
    block = tuple(shard(torch.empty(full_shape, device="meta"), spec, mesh)
                  .shape)
    if tuple(value.shape) == full_shape:
        return shard(value, spec, mesh).contiguous()
    if tuple(value.shape) == block:
        return value
    raise ValueError(f"a parameter of {tuple(value.shape)} is neither the "
                     f"whole {full_shape} nor this rank's block {block}")


def shard_params(params: dict, cfg: TransformerConfig, mesh) -> dict:
    """This rank's shard of the port's serving params (``serve_specs``):
    the counterpart of the reference engine's ``jax.device_put(params,
    serve_param_shardings(...))``.  Entries already at a block's shape
    are kept (a tree loaded sharded); a packed int4 payload shards its
    byte rows, whole row pairs a rank.  The tensors stay where they
    are."""
    specs = specs_of(params, cfg, mesh)

    def tree(source: dict, prefix: str) -> dict:
        out = {}
        for name, value in source.items():
            spec = specs.get(name)
            if spec is None:
                out[name] = value
                continue
            full = full_shapes.get(prefix + name)
            if full is None:
                raise ValueError(f"unexpected served parameter {name!r}")
            out[name] = _block(value, spec, full, mesh)
        return out

    full_shapes = param_shapes(replace(cfg, n_layers=1),
                               *_quant_args(params, cfg))
    top = tree({n: v for n, v in params.items() if n != "layers"}, "")
    top["layers"] = [tree(lp, "layers.0.") for lp in params["layers"]]
    return top


def rank_config(cfg: TransformerConfig, mesh, specs: dict) -> ShardedConfig:
    """The model one rank of ``mesh`` runs on its shard (``specs`` from
    ``serve_specs``): local heads, kv heads and MLP width, and where the
    collectives go (``ShardedConfig``)."""
    tp = mesh.shape["tp"]
    mlp_axis = specs["w_gate"][-1]
    local_ff = cfg.ff_dim // mesh.axis_size(mlp_axis) if mlp_axis else (
        cfg.ff_dim)
    fields = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}
    fields.update(n_heads=cfg.n_heads // tp, n_kv_heads=cfg.kv_heads // tp,
                  d_ff=local_ff)
    row_psum = {"wo"} if specs["wo"][-2] is not None else set()
    if not cfg.n_experts and specs["w_out"][-2] is not None:
        row_psum.add("w_out")
    moe = {}
    if cfg.n_experts:
        ep = mesh.shape["ep"]
        axes = ("tp", "ep") if mlp_axis else ("ep",)
        moe = dict(expert_lo=mesh.axis_index("ep") * cfg.n_experts // ep,
                   local_experts=cfg.n_experts // ep, moe_axes=axes)
    return ShardedConfig(
        **fields, full=cfg, mesh=mesh,
        vocab_shard=specs["wte"][0] is not None,
        row_psum=frozenset(row_psum),
        row_gather=frozenset() if "wo" in row_psum else frozenset({"wo"}),
        **moe)


def whole_shape(block_shape, spec, mesh) -> tuple[int, ...]:
    """The whole tensor's shape of a block of ``block_shape`` under
    ``spec`` (None: replicated, the block is the whole)."""
    shape = list(block_shape)
    for dim, entry in enumerate(spec or ()):
        if entry is not None:
            shape[dim] *= mesh.axis_size(entry)
    return tuple(shape)


def gather_leaf(blocks: list, spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's block (``blocks[r]``: rank
    r's, all on one device), the inverse of ``shard``: each block lands
    at its rank's index over each sharded dimension's axes.  A tensor
    that ``spec`` replicates (None, or no axis) is rank 0's block alone:
    nothing is concatenated."""
    if spec is None or all(entry is None for entry in spec):
        return blocks[0]
    first = blocks[0]
    whole = torch.empty(whole_shape(first.shape, spec, mesh),
                        dtype=first.dtype, device=first.device)
    for rank, block in enumerate(blocks):
        view = whole
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            size = block.shape[dim]
            view = view.narrow(dim, mesh.axis_index(entry, rank) * size,
                               size)
        view.copy_(block)
    return whole


def gather_params(shards: list, cfg: TransformerConfig, mesh) -> dict:
    """The whole serving params from every rank's ``shard_params`` shard
    (``shards[r]``: rank r's tree), tensor by tensor through
    ``gather_leaf``: the exact inverse of ``shard_params`` under
    ``serve_specs`` — column, row, vocab and expert shards, int8 scales
    that dropped the reduction axis, int4 scales and packed nibbles, and
    the leaves ``fitted`` replicates (rank 0's)."""
    specs = specs_of(shards[0], cfg, mesh)

    def tree(sources: list) -> dict:
        return {name: gather_leaf([s[name] for s in sources],
                                  specs.get(name), mesh)
                for name in sources[0] if name != "layers"}

    out = tree(shards)
    out["layers"] = [tree([s["layers"][i] for s in shards])
                     for i in range(len(shards[0]["layers"]))]
    return out


def whole_meta(params: dict, cfg: TransformerConfig, mesh) -> dict:
    """A rank's shard ``params`` described whole: each tensor a ``meta``
    tensor of the whole one's shape and dtype (``jax_leaves``' ``fetch``
    form)."""
    specs = specs_of(params, cfg, mesh)

    def tree(source: dict) -> dict:
        return {name: torch.empty(whole_shape(t.shape, specs.get(name), mesh),
                                  dtype=t.dtype, device="meta")
                for name, t in source.items() if name != "layers"}

    out = tree(params)
    out["layers"] = [tree(lp) for lp in params["layers"]]
    return out


# ---------------------------------------------------------------------------
# Sharded training


def spec_of(specs: dict, name: str):
    """The spec of dotted parameter ``name`` (a layer's by its leaf name;
    None for a replicated one, LoRA's adapters among them)."""
    return specs.get(name.rsplit(".", 1)[-1])


def train_config(cfg: TransformerConfig, mesh) -> TransformerConfig:
    """The model one rank of a training ``mesh`` runs.  With ``tp`` and
    ``ep`` both 1 (data parallelism) it is ``cfg`` itself: the one-device
    model, kernels and all.  Otherwise ``rank_config``'s ``ShardedConfig``
    (the collectives of axes of size 1 dropped) with ``use_pallas`` off:
    the reference's ``_manual_setup`` turns its kernels off whenever
    ``tp`` or ``ep`` is above 1, so the port runs the same plain math.
    Heads, kv heads and the MLP width must divide over ``tp`` and the
    experts over ``ep`` (a rank trains whole heads, columns and experts);
    an odd vocab replicates ``wte``/``wlm`` as ``fitted`` does."""
    tp, ep = mesh.shape["tp"], mesh.shape["ep"]
    if tp == ep == 1:
        return cfg
    bad = [f"{what}={n} over {axis}={mesh.shape[axis]}"
           for what, n, axis in (("n_heads", cfg.n_heads, "tp"),
                                 ("n_kv_heads", cfg.kv_heads, "tp"),
                                 ("d_ff", cfg.ff_dim, "tp"),
                                 ("n_experts", cfg.n_experts, "ep"))
           if n % mesh.shape[axis]]
    if bad:
        raise ValueError(f"the mesh does not divide the model: {bad}")
    sharded = rank_config(cfg, mesh, serve_specs(cfg, mesh))
    return replace(
        sharded, use_pallas=False,
        vocab_shard=sharded.vocab_shard and tp > 1,
        row_psum=sharded.row_psum if tp > 1 else frozenset(),
        row_gather=frozenset(),
        moe_axes=tuple(a for a in sharded.moe_axes if mesh.shape[a] > 1))


def init_rank_params(seed: int, cfg: TransformerConfig, mesh,
                     device=None) -> dict:
    """This rank's f32 master blocks on ``mesh``: every tensor drawn
    whole from ``init_params(seed, cfg, master=True)``'s generator in its
    order, cut to the rank's block (``serve_specs``) and the rest freed
    before the next is drawn — the one-device initialisation cut up, bit
    for bit, with no more than one whole tensor on the card."""
    specs = serve_specs(cfg, mesh)
    return init_params(seed, cfg, device=device, master=True,
                       place=lambda name, t: shard_tensor(name, t, specs,
                                                          mesh))


def block_bytes(params: dict) -> int:
    """Bytes of every tensor of a (rank's) parameter dict."""
    return sum(t.numel() * t.element_size()
               for _, t in named_parameters(params))
