"""Speculative decoding with prompt-lookup drafting (greedy, batch 1).

The counterpart of ``oim_tpu/models/speculative.py``.  Sequential greedy
decode runs one bandwidth-bound forward per token; speculation verifies
``draft_len`` guessed tokens in ONE forward over ``draft_len + 1``
positions, so an accepted guess costs a fraction of a step and the worst
case is sequential decode (one real token a forward), never a wrong
token:

- **Drafting is assistant-free** (prompt lookup): the draft is whatever
  followed the most recent earlier occurrence of the last ``ngram``
  tokens of the prompt and the generation.
- **Exactly greedy.**  An accepted token is argmax given a fully
  verified prefix, so it is what sequential greedy decode emits;
  rejected drafts roll the cache length back, and their rows past it are
  masked by the causal mask until overwritten.

The reference runs the loop as one ``lax.while_loop``; here it is a
Python loop over the plain solo path (``models/decode.py``), the oracle
the serving engine's speculative chunks are held against, as
``generate`` is for its plain ones.
"""

from __future__ import annotations

import torch

from oim_tpu_torch.models.decode import KVCache, _hidden_cached
from oim_tpu_torch.models.transformer import TransformerConfig, unembed


def _draft_ngram(history, length: int, draft_len: int, ngram: int):
    """Prompt-lookup draft: the ``draft_len`` tokens that followed the
    most recent earlier occurrence of the last ``ngram`` tokens.
    history [T] (the first ``length`` decided).  Returns (draft
    [draft_len], found); no match drafts zeros, which simply fail
    verification.

    The most recent match whose continuation lies inside the decided
    region ``[0, length)`` wins; without one, the freshest match whose
    continuation runs into the undecided (zero) rows."""
    t = history.shape[0]
    dev = history.device
    q0 = min(max(length - ngram, 0), t - ngram)  # dynamic_slice's clamp
    query = history[q0:q0 + ngram]
    idx = (torch.arange(t, device=dev)[:, None]
           + torch.arange(ngram, device=dev)[None, :]).clamp_max(t - 1)
    matches = torch.all(history[idx] == query[None, :], dim=1)
    positions = torch.arange(t, device=dev)
    ok = matches & (positions + ngram < length - ngram + 1)
    none = torch.full_like(positions, -1)
    best_full = int(torch.where(
        ok & (positions + ngram + draft_len <= length), positions, none
    ).max())
    best_edge = int(torch.where(ok, positions, none).max())
    best = best_full if best_full >= 0 else best_edge
    found = best_edge >= 0
    start = min(max(best + ngram, 0), t - draft_len)
    draft = history[start:start + draft_len]
    return (draft if found else torch.zeros_like(draft)), found


@torch.no_grad()
def _speculative(params, prompt, cfg: TransformerConfig, max_new_tokens: int,
                 draft_len: int, ngram: int):
    b, t = prompt.shape
    if b != 1:
        raise ValueError("speculative decoding is batch-1 (latency mode)")
    dev = prompt.device
    # History: prompt + generated, with headroom for the last verify's
    # overshoot of up to draft_len accepted tokens.
    t_buf = t + max_new_tokens + draft_len + 1
    cache = KVCache.create(cfg, 1, t_buf, device=dev)
    history = torch.zeros(t_buf, dtype=torch.int64, device=dev)
    history[:t] = prompt[0]
    # Prefill decides the first token, not yet fed: the cache holds every
    # decided token but the newest (cache.length == length - 1).
    logits = unembed(_hidden_cached(params, prompt, cache, cfg), params, cfg)
    history[t] = torch.argmax(logits[0, -1])
    length = t + 1
    iterations = accepted_total = 0
    while length - t < max_new_tokens:
        draft, _ = _draft_ngram(history, length, draft_len, ngram)
        # Verify [newest token, draft...] at the cache frontier: logits i
        # are the distribution after consuming input i.
        inputs = torch.cat([history[length - 1:length], draft])[None]
        x = _hidden_cached(params, inputs, cache, cfg)
        greedy = torch.argmax(unembed(x, params, cfg)[0], dim=-1)
        # draft[i] survives iff every earlier draft matched too.
        accepted = int(torch.cumprod(
            (draft == greedy[:draft_len]).to(torch.int64), dim=0).sum())
        emitted = accepted + 1
        history[length:length + emitted] = greedy[:emitted]
        length += emitted
        # Roll back past the verified prefix: the rejected inputs' rows
        # are stale, masked until overwritten.
        cache.length = length - 1
        iterations += 1
        accepted_total += accepted
    out = history[: t + max_new_tokens].to(torch.int32)
    return out[None], {"iterations": iterations,
                       "drafts_accepted": accepted_total,
                       "tokens": max_new_tokens}


def make_speculative_fn(cfg: TransformerConfig, draft_len: int = 4,
                        ngram: int = 2):
    """Greedy ``(params, prompt [1, t], max_new_tokens) -> (tokens [1, t +
    max_new], stats)`` with prompt-lookup speculation.
    ``stats['iterations']`` counts verify forwards: sequential decode
    would take ``max_new_tokens - 1`` (prefill decides the first token),
    so fewer means speculation paid."""
    if draft_len < 1 or ngram < 1:
        raise ValueError(
            f"need draft_len>=1, ngram>=1; got {draft_len}, {ngram}"
        )

    def fn(params, prompt, max_new_tokens: int):
        return _speculative(params, prompt, cfg, max_new_tokens, draft_len,
                            ngram)

    return fn
