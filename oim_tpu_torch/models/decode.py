"""Solo autoregressive inference: prefill + dense KV-cache decode +
sampling, in plain PyTorch with no kernels.

The port's oracle: the engine's tokens are held against ``generate``
here (greedy and sampled alike), and its greedy tokens against the
reference ``oim_tpu.models.decode.generate``.  The cache is one
``[n_layers, batch, max_len, kv_heads, head_dim]`` region per row,
updated in place (int8 with per-(token, head) f32 scales when
``kv_int8``); attention reads the whole region under a causal mask, the
reference's arithmetic.

Sampling: the reference draws token ``i`` of a request from
``fold_in(PRNGKey(seed), i)`` (threefry), whose bits torch cannot
reproduce.  The port draws it from ``sampling_noise(seed, i)`` — Gumbel
noise from a generator seeded by a hash of ``(seed, i)`` alone — so a
sampled stream depends only on the request, never on its slot, batch or
chunk size, the property the engine relies on.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from oim_tpu_torch.models.transformer import (
    LAYER_NAMES,
    TransformerConfig,
    _dense_mlp,
    _expert_mask,
    _mlp_act,
    _qkv,
    _rmsnorm,
    _EXPERTS,
    _router_gates,
    _router_probs,
    embed_lookup,
    linear,
    row_linear,
    unembed,
)
from oim_tpu_torch.parallel import collectives
from oim_tpu_torch.ops.quant import (
    WEIGHT_QUANT_TARGETS,
    dequantize_int8,
    make_kv_buffers,
    quantize_int8,
)
from oim_tpu_torch.ops.rope import apply_rope
from oim_tpu_torch.ops.wquant import GEMV_ROWS, dequantize_weights

NEG_BIG = -1e30
_MASK64 = (1 << 64) - 1
# Tokens per pass through the experts in ``_moe_exact``: bounds its
# [E, tokens, d_ff] transients (at Mixtral's widths 0.12 GB each in
# bf16) when an admission brings thousands of tokens, and so what an
# admission graph's pool keeps.  Routing is per token, so the split
# changes no token's result.
MOE_TOKENS = 512


@dataclass
class KVCache:
    """Per-layer key/value cache: ``k``/``v`` [n_layers, batch, max_len,
    heads, head_dim]; ``length`` valid positions (a host int, the same
    on every layer); int8 ``k``/``v`` carry f32 ``k_scale``/``v_scale``
    [n_layers, batch, max_len, heads], else None."""

    k: torch.Tensor
    v: torch.Tensor
    length: int
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @classmethod
    def create(cls, cfg: TransformerConfig, batch: int, max_len: int,
               quantized: bool = False, device=None) -> "KVCache":
        shape = (cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
        k, v, ks, vs = make_kv_buffers(
            shape, cfg.compute_dtype, quantized, device=device
        )
        return cls(k=k, v=v, length=0, k_scale=ks, v_scale=vs)

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


# Layer entries: the weights, and the weight-only quantization scales of
# the quantizable ones.
_LAYER_ENTRIES = LAYER_NAMES + tuple(
    f"{name}_wscale" for name in LAYER_NAMES if name in WEIGHT_QUANT_TARGETS
)


def _store_kv(cache, scale, new, start: int) -> None:
    """Write ``new`` [B, t, KVH, hd] at position ``start``, in place —
    quantizing when the cache is int8 (scale is not None)."""
    t = new.shape[1]
    if scale is None:
        cache[:, start:start + t] = new.to(cache.dtype)
        return
    q, s = quantize_int8(new)
    cache[:, start:start + t] = q
    scale[:, start:start + t] = s


def _load_kv(cache, scale):
    """Cache rows as f32, dequantizing when int8."""
    if scale is None:
        return cache.float()
    return dequantize_int8(cache, scale)


def _cached_attention(x, lp, k_cache, v_cache, k_scale, v_scale, start: int,
                      cfg: TransformerConfig):
    """Attend x's tokens (positions start..start+t) against the cache
    prefix plus themselves, writing their K/V into the one-layer cache
    [B, max_len, KVH, hd] in place; returns x plus the attention block."""
    b, t, _ = x.shape
    h, hd, kvh = cfg.n_heads, cfg.head_dim, cfg.kv_heads
    group = h // kvh
    max_len = k_cache.shape[1]
    q, k, v = _qkv(x, lp, cfg)
    positions = start + torch.arange(t, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
    _store_kv(k_cache, k_scale, k, start)
    _store_kv(v_cache, v_scale, v, start)
    q_g = q.reshape(b, t, kvh, group, hd)
    scores = torch.einsum(
        "bqhgd,bkhd->bhgqk", q_g.float(), _load_kv(k_cache, k_scale)
    ) / (hd**0.5)
    q_pos = positions[:, None]
    k_pos = torch.arange(max_len, device=x.device)[None, :]
    keep = k_pos <= q_pos
    if cfg.sliding_window:
        keep &= q_pos - k_pos < cfg.sliding_window
    scores = torch.where(keep, scores, NEG_BIG)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "bhgqk,bkhd->bqhgd", probs, _load_kv(v_cache, v_scale)
    ).to(x.dtype)
    out = out.reshape(b, t, h * hd)
    return x + row_linear(out, lp, "wo", cfg).to(x.dtype)


def _moe_exact(x, lp, cfg: TransformerConfig):
    """Drop-free MoE for the whole inference path (prefill and decode),
    as the reference's: every token runs through its top-k experts with
    no capacity, so results never depend on batch packing, padding or
    prompt length.  Routing is f32 (``_router_probs``, ``_router_gates``);
    each token's weight per expert is the gate of the choice that picked
    it (0 for the rest).  Every token goes through all E experts (E/k
    times the routed work, but no data-dependent shape: a decode chunk
    stays one CUDA graph) as batched products over the experts on the
    compute-dtype weights, like ``_dense_mlp``'s (weight-quantized
    experts through ``linear``; for more than ``GEMV_ROWS`` tokens
    dequantized once for all passes), in passes of at most
    ``MOE_TOKENS`` tokens; the weighted combine is f32.

    On a rank of a mesh (``ShardedConfig``) the router stays whole, so
    every rank routes every token alike; the rank runs its own
    ``local_experts`` (over ``ep``) on its MLP columns (over ``tp``) for
    every token, weighted by the router's probabilities, and the f32
    combine is summed over ``moe_axes``."""
    b, t, d = x.shape
    g = b * t
    normed = _rmsnorm(x, lp["mlp_norm"], cfg).reshape(g, d)
    _, probs = _router_probs(normed, lp["router"])
    _, top_idx, gates = _router_gates(probs, cfg.moe_top_k)
    weights = torch.sum(
        _expert_mask(top_idx, cfg.n_experts) * gates[..., None], dim=1
    )  # [G, E]
    moe_axes = getattr(cfg, "moe_axes", ())
    if moe_axes:
        weights = weights[:, cfg.expert_lo:cfg.expert_lo + cfg.local_experts]
    if g > GEMV_ROWS:
        # Weight-quantized experts meet tall inputs (an admission's tokens)
        # as dequantized weights: dequantize each once for every pass.
        lp = dequantize_weights(lp, _EXPERTS, cfg.compute_dtype)
    out = []
    for lo in range(0, g, MOE_TOKENS):
        h = normed[lo:lo + MOE_TOKENS]
        gate = _mlp_act(linear(h, lp, "w_gate", cfg), cfg)  # [E, n, F]
        up = linear(h, lp, "w_in", cfg)
        down = linear(gate * up, lp, "w_out", cfg)  # [E, n, D]
        out.append(torch.einsum("egd,ge->gd", down.float(),
                                weights[lo:lo + MOE_TOKENS]))
    out = out[0] if len(out) == 1 else torch.cat(out)
    if moe_axes:
        out = collectives.psum(out, cfg.mesh, moe_axes)
    return x + out.reshape(b, t, d).to(x.dtype)


def _mlp(x, lp, cfg: TransformerConfig):
    """An inference layer's MLP block: ``_moe_exact`` for MoE layers,
    else the dense MLP."""
    if cfg.n_experts:
        return _moe_exact(x, lp, cfg)
    return _dense_mlp(x, lp, cfg)


def _hidden_cached(params, tokens, cache: KVCache, cfg: TransformerConfig):
    """Run ``tokens`` (positions cache.length..+t) through every layer,
    extending the cache in place; returns the final-norm hidden states
    [b, t, d].  The Pallas switch is off here, as in the reference's
    decode: inference normalizes with the plain formula."""
    cfg = replace(cfg, use_pallas=False)
    t = tokens.shape[1]
    if cache.length + t > cache.max_len:
        raise ValueError(
            f"cache overflow: length {cache.length} + {t} new tokens > "
            f"max_len {cache.max_len}"
        )
    x = embed_lookup(params["wte"], tokens, cfg)
    start = cache.length
    for layer, lp in enumerate(params["layers"]):
        x = _cached_attention(
            x, lp, cache.k[layer], cache.v[layer],
            None if cache.k_scale is None else cache.k_scale[layer],
            None if cache.v_scale is None else cache.v_scale[layer],
            start, cfg,
        )
        x = _mlp(x, lp, cfg)
    cache.length = start + t
    return _rmsnorm(x, params["final_norm"], cfg)


def prefill(params, tokens, cfg: TransformerConfig, max_len: int,
            kv_int8: bool = False):
    """Process the whole prompt in one pass: tokens [batch, prompt_len]
    → (logits [batch, prompt_len, vocab] f32, cache of capacity
    ``max_len`` holding the prompt's K/V)."""
    b, t = tokens.shape
    if t > max_len:
        raise ValueError(f"prompt length {t} exceeds max_len {max_len}")
    cache = KVCache.create(cfg, b, max_len, quantized=kv_int8,
                           device=tokens.device)
    x = _hidden_cached(params, tokens, cache, cfg)
    return unembed(x, params, cfg), cache


def decode_step(params, cache: KVCache, tokens, cfg: TransformerConfig):
    """One autoregressive step: tokens [batch, 1] → logits [batch, vocab]
    (the cache grows by one position, in place)."""
    x = _hidden_cached(params, tokens, cache, cfg)
    return unembed(x, params, cfg)[:, -1, :], cache


def embed_tokens(params, tokens, true_lens, cfg: TransformerConfig):
    """Mean-pooled, L2-normalized final hidden states: an embeddings
    surface over the causal LM (last-layer mean pooling).  tokens [b, t]
    right-padded, true_lens [b] valid lengths: the pads sit after the
    valid positions, so causal attention keeps every valid hidden state
    independent of them and the masked mean is exact at any padding
    bucket.  Returns f32 [b, d_model] rows of unit norm."""
    b, t = tokens.shape
    cache = KVCache.create(cfg, b, t, device=tokens.device)
    x = _hidden_cached(params, tokens, cache, cfg)
    mask = (torch.arange(t, device=tokens.device)[None, :]
            < true_lens.to(tokens.device)[:, None]).float()[..., None]
    pooled = torch.sum(x.float() * mask, dim=1) / torch.clamp_min(
        torch.sum(mask, dim=1), 1.0)
    return pooled / torch.clamp_min(
        torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), 1e-9)


# ---------------------------------------------------------------------------
# Sampling


def _validate_truncation(top_k: int, top_p: float, vocab: int,
                         min_p: float = 0.0) -> None:
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if top_k < 0 or top_k > vocab:
        raise ValueError(f"top_k must be in [0, vocab={vocab}], got {top_k}")
    if not 0.0 <= min_p < 1.0:
        raise ValueError(f"min_p must be in [0, 1), got {min_p}")


def _per_row(value, logits):
    """A scalar or per-row parameter as a [..., 1] tensor over
    ``logits``' leading axes."""
    t = torch.as_tensor(value, dtype=logits.dtype, device=logits.device)
    return torch.broadcast_to(t, logits.shape[:-1])[..., None]


def nucleus_min_p_mask(logits, top_p, min_p):
    """Top-p (nucleus) + min-p masking with per-row ``top_p``/``min_p``
    (scalars or tensors over the leading axes).  The argmax token always
    survives both masks, so the kept set is never empty."""
    top_p = _per_row(top_p, logits)
    min_p = _per_row(min_p, logits)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    sp = torch.softmax(sorted_desc, dim=-1)
    # Exclusive cumulative mass: a token is cut iff the mass BEFORE it
    # already reaches top_p (the boundary token is kept).
    exclusive = torch.cumsum(sp, dim=-1) - sp
    cut = exclusive >= top_p
    threshold = torch.where(cut, torch.inf, sorted_desc).amin(
        dim=-1, keepdim=True
    )
    probs = torch.softmax(logits, dim=-1)
    keep = (logits >= threshold) & (
        probs >= min_p * probs.amax(dim=-1, keepdim=True)
    )
    return torch.where(keep, logits, NEG_BIG)


def truncate_logits(logits, top_k: int = 0, top_p: float = 1.0,
                    min_p: float = 0.0):
    """Mask logits outside the top-k tokens, the top-p mass, or below
    min-p (all static here; the engine routes per-request top-p/min-p
    through ``nucleus_min_p_mask``)."""
    _validate_truncation(top_k, top_p, logits.shape[-1], min_p)
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, NEG_BIG, logits)
    if top_p < 1.0 or min_p > 0.0:
        logits = nucleus_min_p_mask(logits, top_p, min_p)
    return logits


def apply_penalties(logits, tok_counts, gen_counts, repetition_penalty=1.0,
                    presence_penalty=0.0, frequency_penalty=0.0):
    """Sampling penalties over [..., V] logits: repetition (HF: tokens
    seen in prompt or generation divide positive / multiply negative
    logits) and presence / frequency (OpenAI: subtract for generated
    tokens).  ``tok_counts`` counts prompt+generated, ``gen_counts``
    generated only.  Neutral values leave the logits bit-for-bit
    unchanged."""
    rep = _per_row(repetition_penalty, logits)
    pres = _per_row(presence_penalty, logits)
    freq = _per_row(frequency_penalty, logits)
    adjusted = torch.where(logits > 0, logits / rep, logits * rep)
    logits = torch.where(tok_counts > 0, adjusted, logits)
    return (
        logits
        - pres * (gen_counts > 0).to(logits.dtype)
        - freq * gen_counts.to(logits.dtype)
    )


def token_counts(tokens, vocab: int):
    """Occurrence counts per vocab id: [..., T] int tokens → [..., V]
    int32 (a scatter-add, never a [..., T, V] one-hot)."""
    lead = tokens.shape[:-1]
    flat = tokens.reshape(-1, tokens.shape[-1]).long()
    counts = torch.zeros(
        (flat.shape[0], vocab), dtype=torch.int32, device=tokens.device
    )
    counts.scatter_add_(
        1, flat, torch.ones_like(flat, dtype=torch.int32)
    )
    return counts.reshape(*lead, vocab)


def _mix64(x: int) -> int:
    """splitmix64's finalizer: a bijective 64-bit mix."""
    x &= _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def sample_key(seed: int, index: int) -> int:
    """The generator seed for token ``index`` of a request seeded
    ``seed`` — a function of the pair alone."""
    return _mix64(_mix64(seed) ^ (index & _MASK64)) >> 1


def sampling_noise(seed: int, index: int, vocab: int, device=None):
    """Gumbel noise [vocab] f32 for token ``index`` of request ``seed``:
    ``argmax(logits + noise)`` draws from ``softmax(logits)``."""
    gen = torch.Generator(device=device).manual_seed(sample_key(seed, index))
    u = torch.rand(vocab, generator=gen, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_token(logits, temperature: float, noise=None, top_k: int = 0,
                 top_p: float = 1.0, min_p: float = 0.0):
    """Greedy at temperature 0 (or without noise); else the Gumbel-max
    draw over the temperature-scaled logits truncated by
    ``truncate_logits``."""
    if temperature == 0.0 or noise is None:
        _validate_truncation(top_k, top_p, logits.shape[-1], min_p)
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = truncate_logits(logits / temperature, top_k, top_p, min_p)
    return torch.argmax(logits + noise, dim=-1).to(torch.int32)


@torch.no_grad()
def generate(params, prompt, cfg: TransformerConfig, max_new_tokens: int,
             temperature: float = 0.0, seed: int | None = None,
             top_k: int = 0, top_p: float = 1.0, kv_int8: bool = False,
             min_p: float = 0.0, repetition_penalty: float = 1.0,
             presence_penalty: float = 0.0, frequency_penalty: float = 0.0):
    """Generate ``max_new_tokens`` continuations of ``prompt`` [batch,
    prompt_len] (int) → [batch, prompt_len + max_new_tokens] int32.
    Sampled token ``i`` draws ``sampling_noise(seed, i)`` (the same
    noise for every row); the penalties apply before each draw."""
    if max_new_tokens <= 0:
        return prompt
    if temperature != 0.0 and seed is None:
        raise ValueError(
            "temperature > 0 requires an explicit seed; a silent default "
            "would make every call return identical samples"
        )
    b, t = prompt.shape
    vocab = cfg.vocab_size
    device = prompt.device
    logits, cache = prefill(params, prompt, cfg, t + max_new_tokens,
                            kv_int8=kv_int8)
    tok_counts = token_counts(prompt, vocab)
    gen_counts = torch.zeros_like(tok_counts)
    penals = (repetition_penalty, presence_penalty, frequency_penalty)

    def draw(step_logits, index):
        noise = (
            None if temperature == 0.0
            else sampling_noise(seed, index, vocab, device)
        )
        return sample_token(
            apply_penalties(step_logits, tok_counts, gen_counts, *penals),
            temperature, noise, top_k, top_p, min_p,
        )

    rows = torch.arange(b, device=device)
    out = []
    token = draw(logits[:, -1, :], 0)
    for index in range(1, max_new_tokens + 1):
        out.append(token)
        tok_counts[rows, token.long()] += 1
        gen_counts[rows, token.long()] += 1
        if index == max_new_tokens:
            break
        step_logits, cache = decode_step(params, cache, token[:, None], cfg)
        token = draw(step_logits, index)
    return torch.cat([prompt.to(torch.int32), torch.stack(out, dim=1)], dim=1)
