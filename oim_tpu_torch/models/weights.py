"""Parameter layout conversions.

The reference keeps parameters as one dict of stacked arrays
(``[n_stages, layers_per_stage, ...]`` for layer weights); the port keeps
``{"wte", "final_norm", "wlm", "layers": [per-layer dict]}`` with every
tensor already in the dtype the forward reads (``prepare_param``), or
with every tensor f32 as training's masters.  ``from_jax_params`` maps
the first onto the second (``from_jax_lora`` does the same for LoRA
adapters) — it is how the parity tests make both
packages compute (and train) the same function — and
``recast`` re-prepares a port dict for another compute dtype (the f32
reference forward over a bf16 model's weights).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from oim_tpu_torch.models.decode import _flat_layer_params
from oim_tpu_torch.models.train import named_parameters
from oim_tpu_torch.models.transformer import TransformerConfig, prepare_param


def from_jax_params(tree: dict, cfg: TransformerConfig, device=None,
                    master: bool = False) -> dict:
    """Reference parameter dict (numpy arrays, layer weights stacked
    ``[n_stages, layers_per_stage, ...]``) → the port's serving layout on
    ``device``, or, when ``master``, every tensor f32 as training's
    masters (the reference's ``param_dtype``).  MoE trees carry
    ``router`` and ``[E, ...]`` experts per layer.  Weight-quantized
    trees (``*_wscale``) are refused."""
    if any(name.endswith("_wscale") for name in tree):
        raise ValueError(
            "weight-quantized parameters are not ported yet; pass the "
            "float tree"
        )

    def tensor(name, value):
        arr = torch.tensor(np.asarray(value, dtype=np.float32), device=device)
        return arr if master else prepare_param(name, arr, cfg)

    params = {
        name: tensor(name, tree[name])
        for name in ("wte", "final_norm", "wlm")
    }
    stacked = _flat_layer_params(tree, cfg)
    params["layers"] = [
        {name: tensor(name, value[i]) for name, value in stacked.items()}
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


def recast(params: dict, cfg: TransformerConfig, dtype: str) -> tuple:
    """(params, cfg) with the compute dtype switched to ``dtype`` — a
    copy of every tensor (the f32 reference forward reads the served
    bf16 values widened to f32)."""
    new_cfg = replace(cfg, dtype=dtype)

    def cast(name, t):
        return prepare_param(name, t, new_cfg)

    out = {name: cast(name, params[name])
           for name in ("wte", "final_norm", "wlm")}
    out["layers"] = [
        {name: cast(name, t) for name, t in lp.items()}
        for lp in params["layers"]
    ]
    return out, new_cfg


def param_shapes(cfg: TransformerConfig) -> dict:
    """``{dotted name: shape}`` of every parameter ``init_params`` makes
    for ``cfg`` (layers as ``layers.<i>.<name>``)."""
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
    for i in range(cfg.n_layers):
        shapes.update({f"layers.{i}.{k}": s for k, s in layer.items()})
    return shapes


def check_params(params: dict, cfg: TransformerConfig, what: str) -> None:
    """Raise unless ``params`` (loaded from ``what``) hold exactly the
    parameters ``cfg`` describes, at their shapes."""
    got = {name: tuple(t.shape) for name, t in named_parameters(params)}
    want = param_shapes(cfg)
    if got != want:
        bad = sorted(name for name in set(got) | set(want)
                     if got.get(name) != want.get(name))
        raise ValueError(
            f"{what} does not match the model flags at {bad[:6]}: "
            f"{[(got.get(b), want.get(b)) for b in bad[:6]]}")


def n_params(params: dict) -> int:
    """Parameter count of a port parameter dict."""
    total = sum(params[name].numel() for name in ("wte", "final_norm", "wlm"))
    for lp in params["layers"]:
        total += sum(t.numel() for t in lp.values())
    return total


def to_device(params: dict, device) -> dict:
    """The same parameters on ``device`` (tensors already there are
    reused, not copied)."""
    out = {name: params[name].to(device)
           for name in ("wte", "final_norm", "wlm")}
    out["layers"] = [
        {name: t.to(device) for name, t in lp.items()}
        for lp in params["layers"]
    ]
    return out
