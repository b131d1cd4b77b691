"""LoRA fine-tuning: low-rank adapters over the attention projections.

The counterpart of ``oim_tpu/models/lora.py``.  For each target weight
``W [din, dout]`` of every layer the trainable state is ``A [din, r]``
(truncated normal over sqrt(din)) and ``B [r, dout]`` (zeros, so step 0
is the base model exactly); the effective weight is
``W + (alpha / r) · A @ B``.  The adapters live as ``{"layers":
[{"wq_a", "wq_b", ...}]}``, the base parameters' per-layer layout, so
the trainer's ``TrainState``, optimizer (every adapter decayed: none is
named ``*_norm``, the reference's mask) and checkpoints take them as
they take the model.

The step merges the adapters into the frozen base and runs the full
training objective on the merged weights; autograd through
``W + s·A@B`` gives ``dA = s·dW@Bᵀ`` and ``dB = s·Aᵀ@dW``, the
reference's merge-then-chain-rule (``_adapter_grads`` spells it out).
The base needs no gradient, so the fused-CE backward skips ``dw`` of
the unembedding, and only the adapters carry optimizer state.
``merge_lora`` produces plain parameters for export and serving.
"""

from __future__ import annotations

import math

import torch

from oim_tpu_torch.models.train import make_train_step
from oim_tpu_torch.models.transformer import TransformerConfig

LORA_TARGETS = ("wq", "wk", "wv", "wo")


def _target_shapes(cfg: TransformerConfig) -> dict:
    """``{target: (din, dout)}`` of the LoRA targets."""
    d, n = cfg.d_model, cfg.n_heads * cfg.head_dim
    kvn = cfg.kv_heads * cfg.head_dim
    return {"wq": (d, n), "wk": (d, kvn), "wv": (d, kvn), "wo": (n, d)}


def init_lora(seed: int, cfg: TransformerConfig, rank: int,
              device=None) -> dict:
    """Adapters for every layer from ``torch.Generator(device)
    .manual_seed(seed)``: ``A`` truncated normal (±2 sigma) over
    sqrt(din), ``B`` zeros, all f32."""
    if rank < 1:
        raise ValueError(f"lora rank must be >= 1, got {rank}")
    gen = torch.Generator(device=device).manual_seed(seed)
    lo = 0.5 * math.erfc(2.0 / math.sqrt(2.0))  # standard normal CDF at -2
    layers = []
    for _ in range(cfg.n_layers):
        lp = {}
        for name, (din, dout) in _target_shapes(cfg).items():
            a = torch.empty((din, rank), dtype=torch.float32, device=device)
            a.uniform_(lo, 1.0 - lo, generator=gen)
            a.mul_(2.0).sub_(1.0).erfinv_().mul_(math.sqrt(2.0))
            lp[f"{name}_a"] = a.clamp_(-2.0, 2.0).div_(math.sqrt(din))
            lp[f"{name}_b"] = torch.zeros((rank, dout), dtype=torch.float32,
                                          device=device)
        layers.append(lp)
    return {"layers": layers}


def merge_lora(params: dict, adapters: dict, alpha: float,
               rank: int) -> dict:
    """Plain parameters with the adapters folded in: ``W + (alpha /
    rank)·A@B`` per target in W's dtype (everything else passes
    through, shared).  Differentiable in the adapters."""
    scale = alpha / rank
    merged = {name: value for name, value in params.items()
              if name != "layers"}
    merged["layers"] = []
    for lp, ad in zip(params["layers"], adapters["layers"]):
        out = dict(lp)
        for name in LORA_TARGETS:
            delta = ad[f"{name}_a"] @ ad[f"{name}_b"]
            out[name] = (lp[name] + scale * delta).to(lp[name].dtype)
        merged["layers"].append(out)
    return merged


def _adapter_grads(grads_w: dict, adapters: dict, alpha: float,
                   rank: int) -> dict:
    """The chain rule from merged-weight gradients (``{"layers":
    [{target: dW}]}``) to adapter gradients: ``dA = s·dW@Bᵀ``, ``dB =
    s·Aᵀ@dW``."""
    scale = alpha / rank
    layers = []
    for gw, ad in zip(grads_w["layers"], adapters["layers"]):
        out = {}
        for name in LORA_TARGETS:
            dw = gw[name].float()
            out[f"{name}_a"] = scale * (dw @ ad[f"{name}_b"].T)
            out[f"{name}_b"] = scale * (ad[f"{name}_a"].T @ dw)
        layers.append(out)
    return {"layers": layers}


def make_lora_train_step(cfg: TransformerConfig, alpha: float, rank: int):
    """``step(state, base_params, tokens) -> (state, metrics)``:
    ``state.params`` are the adapters (the only thing optimized or
    checkpointed); ``base_params`` stay frozen.  The full train step
    runs on the merged weights."""
    step = make_train_step(
        cfg, model_params=lambda adapters, base: merge_lora(
            base, adapters, alpha, rank))

    def lora_step(state, base_params, tokens):
        return step(state, tokens, base_params)

    return lora_step
