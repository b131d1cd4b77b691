"""Flagship decoder-only transformer LM: the serving forward's pieces
and the single-device training forward.

Architecture as in ``oim_tpu/models/transformer.py``: pre-RMSNorm,
rotary positions, SwiGLU (or GeGLU) MLP, optional q/k/v biases (the
Qwen2 family), an untied ``wlm`` unembedding, f32 logits.  The layer
loop is a Python loop (``lax.scan`` has no counterpart to carry over).
Parameters are a plain dict ``{"wte", "final_norm", "wlm", "layers":
[per-layer dict]}`` in one of two layouts (``models/weights.py``):
serving's, every tensor already in the dtype the forward reads (cast
once at load), and training's f32 masters (``master=True``), which
``_cast_matmul_weights`` casts per step as the reference does.

The training forward (``forward_hidden``/``forward_local``) is one
pipeline stage on one device: ``use_pallas`` routes RMSNorm and
attention through the Hopper kernels' differentiable wrappers
(``ops/rmsnorm.py``, ``ops/flash_attention.py``), ``remat`` recomputes
each layer in the backward (``torch.utils.checkpoint``).  The serving
paths force ``use_pallas=False``, as the reference's engine does.

MoE layers (``n_experts > 0``) keep ``router [d, E]`` and the expert
weights ``w_gate``/``w_in [E, d, f]``, ``w_out [E, f, d]`` under the
dense MLP's names.  Training routes with capacity (``_switch_moe``:
``_router_gates``, ``_capacity_dispatch``, the load-balance aux and the
router z-loss); inference routes every token drop-free
(``models/decode.py::_moe_exact``).  Pipeline stages are refused with
the ROADMAP item that ports them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from oim_tpu_torch.ops.flash_attention import (
    flash_attention,
    reference_attention,
)
from oim_tpu_torch.ops.rmsnorm import reference_rmsnorm, rmsnorm
from oim_tpu_torch.ops.rope import apply_rope

# Weight on the MoE auxiliary channel in the train objective (the
# reference's AUX_LOSS_WEIGHT); dense layers add 0 to the channel.
AUX_LOSS_WEIGHT = 0.01

# The compute dtypes the port's kernels take.
_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


@dataclass(frozen=True)
class TransformerConfig:
    """The reference ``TransformerConfig``: same field names, defaults
    and validation, so a config moves between the packages unchanged.
    ``use_pallas`` selects the Hopper kernels in the training forward,
    and with ``fused_ce`` the loss runs the fused unembed+CE kernels
    (``models/train.py``); pipeline and sequence-parallel fields are
    carried for parity and refused where they would take effect."""

    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 0
    attn_bias: bool = False
    mlp_act: str = "silu"
    norm_offset: bool = False
    embed_scale: bool = False
    d_ff: int = 0
    n_experts: int = 0
    moe_top_k: int = 1
    expert_capacity_factor: float = 1.25
    router_z_loss: float = 0.0
    rope_theta: float = 10000.0
    rope_scaling: tuple = ()
    norm_eps: float = 1e-6
    n_stages: int = 1
    n_microbatches: int = 1
    grad_accum: int = 1
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    use_pallas: bool = True
    fused_ce: bool = True
    attn_impl: str = "ring"
    pp_schedule: str = "gpipe"
    sliding_window: int = 0
    doc_sep_id: int = -1

    def __post_init__(self):
        if self.mlp_act not in ("silu", "gelu_tanh"):
            raise ValueError(
                f"unknown mlp_act {self.mlp_act!r}; "
                "expected 'silu' or 'gelu_tanh'"
            )
        if self.attn_impl not in ("ring", "ulysses"):
            raise ValueError(
                f"unknown attn_impl {self.attn_impl!r}; "
                "expected 'ring' or 'ulysses'"
            )
        if self.pp_schedule not in ("gpipe", "1f1b"):
            raise ValueError(
                f"unknown pp_schedule {self.pp_schedule!r}; "
                "expected 'gpipe' or '1f1b'"
            )
        if self.n_kv_heads and (
            self.n_kv_heads < 1 or self.n_heads % self.n_kv_heads
        ):
            raise ValueError(
                f"n_kv_heads={self.n_kv_heads} must be a positive divisor "
                f"of n_heads={self.n_heads}"
            )
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum={self.grad_accum} must be >= 1")
        if self.rope_scaling:
            if len(self.rope_scaling) != 4:
                raise ValueError(
                    "rope_scaling must be empty or (factor, low_freq_factor, "
                    f"high_freq_factor, original_max_position); "
                    f"got {self.rope_scaling!r}"
                )
            factor, low, high, orig = self.rope_scaling
            if factor <= 0 or low <= 0 or orig <= 0 or low >= high:
                raise ValueError(
                    "rope_scaling needs factor>0, 0<low_freq_factor"
                    f"<high_freq_factor, original_max>0; got "
                    f"{self.rope_scaling!r}"
                )
        if self.moe_top_k < 1 or (
            self.n_experts and self.moe_top_k > self.n_experts
        ):
            raise ValueError(
                f"moe_top_k={self.moe_top_k} must be in "
                f"[1, n_experts={self.n_experts}]"
            )
        if self.sliding_window < 0:
            raise ValueError(
                f"sliding_window={self.sliding_window} must be >= 0"
            )
        if self.doc_sep_id >= self.vocab_size:
            raise ValueError(
                f"doc_sep_id={self.doc_sep_id} outside vocab "
                f"{self.vocab_size}"
            )
        if self.dtype not in _DTYPES:
            raise ValueError(
                f"dtype {self.dtype!r} not one of {sorted(_DTYPES)}"
            )

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def ff_dim(self) -> int:
        return self.d_ff or 4 * self.d_model

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


def require_trainable(cfg: TransformerConfig) -> None:
    """Refuse configs the port does not train yet: pipeline stages."""
    if cfg.n_stages != 1:
        raise ValueError(
            f"n_stages={cfg.n_stages}: pipeline parallelism is not ported "
            "yet (ROADMAP Queue A: parallelism, parallel/pipeline.py)"
        )


# ---------------------------------------------------------------------------
# Parameters

LAYER_NAMES = (
    "attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "router", "w_gate",
    "w_in", "w_out", "bq", "bk", "bv",
)
# Kept in f32 wherever they are read: the norm scales, and the MoE
# router, whose logits, softmax and top-k the reference computes in f32
# on purpose (a bf16 router flips expert choices near ties).
_F32 = ("attn_norm", "mlp_norm", "final_norm", "router")
_EXPERTS = ("w_gate", "w_in", "w_out")


def prepare_param(name: str, value, cfg: TransformerConfig):
    """One parameter in the layout the forward reads: norm scales and
    the router f32, ``wlm`` as compute-dtype values widened to f32 (see
    ``_unembed``), every other weight in the compute dtype.
    Differentiable, so the training forward casts its f32 masters
    through it."""
    if name in _F32:
        return value.float()
    if name == "wlm":
        return value.to(cfg.compute_dtype).float()
    return value.to(cfg.compute_dtype)


def init_params(seed: int, cfg: TransformerConfig, device=None,
                master: bool = False) -> dict:
    """Truncated-normal init (±2 sigma, scaled by 1/sqrt(fan_in)) drawn
    from ``torch.Generator(device).manual_seed(seed)``, one tensor at a
    time so the peak is one f32 tensor beyond the model.  Returns
    ``{"wte", "final_norm", "wlm", "layers": [per-layer dict]}`` in
    serving's layout, or as f32 training masters when ``master``.  MoE
    layers draw the router ``[d, E]`` and the experts ``[E, d, f]`` /
    ``[E, f, d]`` (the reference's shapes and fan-ins)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    d, n = cfg.d_model, cfg.n_heads * cfg.head_dim
    kvn, f = cfg.kv_heads * cfg.head_dim, cfg.ff_dim
    lo = 0.5 * math.erfc(2.0 / math.sqrt(2.0))  # standard normal CDF at -2

    def dense(name, *shape, fan_in):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        t.uniform_(lo, 1.0 - lo, generator=gen)
        t.mul_(2.0).sub_(1.0).erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
        t.div_(math.sqrt(fan_in))
        return t if master else prepare_param(name, t, cfg)

    def const(name, fill, *shape):
        t = torch.full(shape, fill, dtype=torch.float32, device=device)
        return t if master else prepare_param(name, t, cfg)

    params = {
        "wte": dense("wte", cfg.vocab_size, d, fan_in=d),
        "final_norm": const("final_norm", 1.0, d),
        "wlm": dense("wlm", d, cfg.vocab_size, fan_in=d),
        "layers": [],
    }
    e = (cfg.n_experts,) if cfg.n_experts else ()
    for _ in range(cfg.n_layers):
        lp = {
            "attn_norm": const("attn_norm", 1.0, d),
            "wq": dense("wq", d, n, fan_in=d),
            "wk": dense("wk", d, kvn, fan_in=d),
            "wv": dense("wv", d, kvn, fan_in=d),
            "wo": dense("wo", n, d, fan_in=n),
            "mlp_norm": const("mlp_norm", 1.0, d),
        }
        if cfg.n_experts:
            lp["router"] = dense("router", d, cfg.n_experts, fan_in=d)
        lp.update(
            w_gate=dense("w_gate", *e, d, f, fan_in=d),
            w_in=dense("w_in", *e, d, f, fan_in=d),
            w_out=dense("w_out", *e, f, d, fan_in=f),
        )
        if cfg.attn_bias:
            lp.update(
                bq=const("bq", 0.0, n),
                bk=const("bk", 0.0, kvn),
                bv=const("bv", 0.0, kvn),
            )
        params["layers"].append(lp)
    return params


# ---------------------------------------------------------------------------
# Forward pieces


def _rmsnorm(x, w, cfg: TransformerConfig):
    if cfg.norm_offset:
        # Gemma convention: the learned scale is a residual around 1,
        # formed and kept in f32.
        w = 1.0 + w.float()
    if cfg.use_pallas:
        return rmsnorm(x, w, cfg.norm_eps)
    return reference_rmsnorm(x, w, cfg.norm_eps)


def embed_lookup(wte, tokens, cfg: TransformerConfig):
    """The token-embedding lookup (training, solo decode and the engine
    all route here) in the compute dtype; Gemma's sqrt(d_model) scale
    rounds through it.  The rows are gathered, then cast (the reference
    casts the table, then gathers: the same values; the gradient of a
    repeated token then sums in f32 where the reference sums in the
    compute dtype)."""
    x = F.embedding(tokens, wte).to(cfg.compute_dtype)
    if cfg.embed_scale:
        # A fill on the device, not a copy from the host: the serving
        # engine captures this in a CUDA graph.
        x = x * torch.full(
            (), math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device
        )
    return x


def _mlp_act(x, cfg: TransformerConfig):
    """The gate activation: silu, or Gemma's tanh-approximated gelu."""
    if cfg.mlp_act == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def _dense_mlp(x, lp, cfg: TransformerConfig):
    """Pre-norm gated MLP with its residual."""
    normed = _rmsnorm(x, lp["mlp_norm"], cfg)
    gate = _mlp_act(normed @ lp["w_gate"], cfg)
    up = normed @ lp["w_in"]
    return x + ((gate * up) @ lp["w_out"]).to(x.dtype)


def _router_probs(normed, router):
    """f32 router logits and their softmax [G, E] of normed tokens [G, D]
    (the reference's deliberate f32 routing)."""
    logits = normed.float() @ router.float()
    return logits, torch.softmax(logits, dim=-1)


def _router_gates(probs, top_k: int):
    """(top-k probs [G, K], indices [G, K], gates [G, K]) of router probs
    [G, E].  Equal probs rank the lower expert index first, as
    ``jax.lax.top_k`` does (a stable descending sort; ``torch.topk``
    promises no order among ties).  k = 1: the gate is the raw prob
    (switch transformer); k >= 2: the gates renormalised over the
    chosen experts (GShard, Mixtral)."""
    top_probs, top_idx = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    top_probs, top_idx = top_probs[..., :top_k], top_idx[..., :top_k]
    if top_k == 1:
        return top_probs, top_idx, top_probs
    return top_probs, top_idx, top_probs / torch.sum(
        top_probs, dim=-1, keepdim=True)


def _expert_mask(idx, e: int):
    """``idx == arange(e)`` as f32 over a new last axis: a one-hot built
    by comparison, so an index of -1 gives a zero row and nothing checks
    its range on the device (capturable in a CUDA graph)."""
    return (idx[..., None] == torch.arange(e, device=idx.device)).float()


def _capacity_dispatch(top_idx, gates, e: int, capacity: int):
    """Queue tokens into expert slots with choice-rank priority, as the
    reference does: top_idx/gates [G, K] → (dispatch, combine), both
    [G, E, capacity] f32.  Rank r tokens queue after every rank < r
    assignment to the same expert (first choices never lose a slot to
    second choices); an assignment past the capacity is dropped (an
    all-zero row: the token keeps its residual)."""
    k = top_idx.shape[1]
    dispatch = combine = 0.0
    prior = torch.zeros(e, device=top_idx.device)  # per-expert count so far
    for rank in range(k):
        assign = _expert_mask(top_idx[:, rank], e)  # [G, E]
        position = (torch.cumsum(assign, dim=0) - 1.0 + prior) * assign
        position = torch.where(assign > 0, position, -1.0)
        prior = prior + torch.sum(assign, dim=0)
        keep = (position >= 0) & (position < capacity)
        d_rank = _expert_mask(torch.where(keep, position, -1.0).long(),
                              capacity)  # [G, E, C]
        dispatch = dispatch + d_rank
        combine = combine + d_rank * gates[:, rank, None, None]
    return dispatch, combine


def _switch_moe(x, lp, cfg: TransformerConfig):
    """Top-k expert routing with capacity (the reference's training MoE):
    tokens are queued into ``max(int(factor·k·g/e), 1)`` slots per expert
    by ``_capacity_dispatch``, each expert's SwiGLU runs over its slots
    in f32 (the experts' f32 masters, as the reference keeps them), and
    the combine weights each slot's output by its gate.  Returns ``(x +
    out, aux)``: the load-balance loss over first choices, ``e ·
    Σ density · mean prob``, plus the router z-loss ``mean(lse²)``
    pre-divided by ``AUX_LOSS_WEIGHT`` (the objective multiplies it
    back, so the term is exactly ``router_z_loss · mean(z²)``)."""
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    g = b * t
    capacity = max(int(cfg.expert_capacity_factor * k * g / e), 1)
    normed = _rmsnorm(x, lp["mlp_norm"], cfg).reshape(g, d).float()
    logits, probs = _router_probs(normed, lp["router"])
    _, top_idx, gates = _router_gates(probs, k)
    dispatch, combine = _capacity_dispatch(top_idx, gates, e, capacity)
    expert_in = torch.einsum("gec,gd->ecd", dispatch, normed)
    gate = _mlp_act(expert_in @ lp["w_gate"], cfg)
    up = expert_in @ lp["w_in"]
    expert_out = (gate * up) @ lp["w_out"]
    out = torch.einsum("gec,ecd->gd", combine, expert_out).reshape(b, t, d)
    density = torch.mean(_expert_mask(top_idx[:, 0], e), dim=0)
    aux = e * torch.sum(density * torch.mean(probs, dim=0))
    if cfg.router_z_loss:
        z = torch.logsumexp(logits, dim=-1)
        aux = aux + (cfg.router_z_loss / AUX_LOSS_WEIGHT) * torch.mean(z * z)
    return x + out.to(x.dtype), aux


def _qkv(x, lp, cfg: TransformerConfig):
    """Pre-norm q/k/v projections (plus the Qwen biases) reshaped to
    [b, t, heads, head_dim] — shared by solo decode and the engine."""
    b, t, _ = x.shape
    normed = _rmsnorm(x, lp["attn_norm"], cfg)
    q = normed @ lp["wq"]
    k = normed @ lp["wk"]
    v = normed @ lp["wv"]
    if "bq" in lp:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    hd, kvh = cfg.head_dim, cfg.kv_heads
    return (
        q.reshape(b, t, cfg.n_heads, hd),
        k.reshape(b, t, kvh, hd),
        v.reshape(b, t, kvh, hd),
    )


def _unembed(x, wlm, cfg: TransformerConfig):
    """f32 logits from compute-dtype hidden states.  ``wlm`` holds the
    compute-dtype weight values widened to f32 once at load, so this f32
    product is the reference's bf16 x bf16 einsum with an f32
    accumulator and f32 output — which a bf16 matmul here, rounding its
    output to bf16, would not be."""
    return x.to(cfg.compute_dtype).float() @ wlm


# ---------------------------------------------------------------------------
# Training forward (one stage, one device)


def _cast_matmul_weights(lp: dict, cfg: TransformerConfig) -> dict:
    """A layer's f32 masters as the forward reads them: matmul weights
    and biases in the compute dtype, norm scales and the router f32
    (``prepare_param``, differentiable, so gradients reach the masters).
    Under MoE the expert weights stay f32 masters too, as in the
    reference: ``_switch_moe`` feeds them f32 slots."""
    return {name: value if cfg.n_experts and name in _EXPERTS
            else prepare_param(name, value, cfg)
            for name, value in lp.items()}


def _attention(x, lp, positions, cfg: TransformerConfig, segments=None):
    """Pre-norm causal self-attention with its residual: flash attention
    when ``use_pallas``, else the reference formula."""
    b, t, _ = x.shape
    q, k, v = _qkv(x, lp, cfg)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
    if cfg.use_pallas:
        out = flash_attention(q, k, v, True, cfg.sliding_window, segments)
    else:
        out = reference_attention(q, k, v, True, segments,
                                  cfg.sliding_window)
    out = out.reshape(b, t, cfg.n_heads * cfg.head_dim)
    return x + (out @ lp["wo"]).to(x.dtype)


def _layer(x, lp, positions, cfg: TransformerConfig, segments=None):
    """One layer over f32 master weights → (x, its aux loss): a dense
    MLP adds 0 to the aux channel, an MoE layer its ``_switch_moe``
    aux."""
    lp = _cast_matmul_weights(lp, cfg)
    x = _attention(x, lp, positions, cfg, segments)
    if cfg.n_experts:
        return _switch_moe(x, lp, cfg)
    return _dense_mlp(x, lp, cfg), torch.zeros((), device=x.device)


def _doc_segments(tokens, cfg: TransformerConfig):
    """Document ids of a packed [b, t] batch: the inclusive running count
    of separators (a separator opens the document it precedes)."""
    sep = (tokens == cfg.doc_sep_id).to(torch.int32)
    return torch.cumsum(sep, dim=1, dtype=torch.int32)


def forward_hidden(params: dict, tokens, cfg: TransformerConfig):
    """tokens [b, t] → (final-norm hidden [b, t, D] in the compute
    dtype, the layers' summed aux loss, f32) over f32 master ``params``;
    each layer is recomputed in the backward when ``cfg.remat``."""
    require_trainable(cfg)
    t = tokens.shape[1]
    x = embed_lookup(params["wte"], tokens, cfg)
    positions = torch.arange(t, device=tokens.device)
    segments = _doc_segments(tokens, cfg) if cfg.doc_sep_id >= 0 else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params["layers"]:
        if cfg.remat:
            x, layer_aux = checkpoint(_layer, x, lp, positions, cfg,
                                      segments, use_reentrant=False)
        else:
            x, layer_aux = _layer(x, lp, positions, cfg, segments)
        aux = aux + layer_aux
    return _rmsnorm(x, params["final_norm"], cfg), aux


def forward_local(params: dict, tokens, cfg: TransformerConfig):
    """tokens [b, t] → (f32 logits [b, t, V], aux loss) over f32 master
    ``params``: ``forward_hidden`` then ``_unembed`` of the compute-dtype
    rounding of ``wlm``, as the reference's bf16 x bf16 einsum with an
    f32 accumulator."""
    x, aux = forward_hidden(params, tokens, cfg)
    wlm = prepare_param("wlm", params["wlm"], cfg)
    return _unembed(x, wlm, cfg), aux
