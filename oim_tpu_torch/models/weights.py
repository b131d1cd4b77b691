"""Parameter layout conversions.

The reference keeps parameters as one dict of stacked arrays
(``[n_stages, layers_per_stage, ...]`` for layer weights); the port keeps
``{"wte", "final_norm", "wlm", "layers": [per-layer dict]}`` with every
tensor already in the dtype the forward reads (``prepare_param``), or
with every tensor f32 as training's masters.  ``from_jax_params`` maps
the first onto the second — it is how the parity tests make both
packages compute (and train) the same function — and
``recast`` re-prepares a port dict for another compute dtype (the f32
reference forward over a bf16 model's weights).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from oim_tpu_torch.models.decode import _flat_layer_params
from oim_tpu_torch.models.transformer import (
    TransformerConfig,
    prepare_param,
    require_dense,
)


def from_jax_params(tree: dict, cfg: TransformerConfig, device=None,
                    master: bool = False) -> dict:
    """Reference parameter dict (numpy arrays, layer weights stacked
    ``[n_stages, layers_per_stage, ...]``) → the port's serving layout on
    ``device``, or, when ``master``, every tensor f32 as training's
    masters (the reference's ``param_dtype``).  Weight-quantized trees
    (``*_wscale``) are refused."""
    require_dense(cfg)
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
