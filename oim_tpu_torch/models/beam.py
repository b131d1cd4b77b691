"""Beam search decoding (batch 1).

The counterpart of ``oim_tpu/models/beam.py``: keep the ``beam_size``
highest-scoring hypotheses, expanding all of them in one batched forward
a step (the beams are the batch; the step's reorder is a gather on the
cache's batch axis), over the plain solo path of ``models/decode.py``.

EOS-aware: a beam that emits ``eos_id`` freezes (its score stops
accumulating; it keeps competing in the running top-k), and the final
pick applies GNMT length normalization ``score / ((5 + len) / 6) **
alpha`` so that longer finished hypotheses are not unfairly penalized.
The top-k is a stable descending sort, so ties break toward the lower
index as ``lax.top_k``'s do.
"""

from __future__ import annotations

import torch

from oim_tpu_torch.models.decode import NEG_BIG, KVCache, decode_step, prefill
from oim_tpu_torch.models.transformer import TransformerConfig


def _gather_cache(cache: KVCache, parents) -> KVCache:
    """Reorder the beam (batch) axis by ``parents`` [k]."""
    def take(a):
        return None if a is None else a.index_select(1, parents)

    return KVCache(k=take(cache.k), v=take(cache.v), length=cache.length,
                   k_scale=take(cache.k_scale), v_scale=take(cache.v_scale))


def _top_k(values, k: int):
    """``lax.top_k`` over the last axis: the k largest, descending, ties
    toward the lower index."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.no_grad()
def beam_steps(params, prompt, cfg: TransformerConfig, max_new_tokens: int,
               beam_size: int, alpha: float, eos_id: int | None) -> tuple:
    """The search itself, left on the device: (the beams' generated
    tokens [k, max_new], their scores [k], lengths [k] and normalized
    scores [k]).  Reads nothing back, so a follower rank of a mesh runs
    it as the leader does."""
    b, t = prompt.shape
    if b != 1:
        raise ValueError("beam search is batch-1 (the beams are the batch)")
    k = beam_size
    vocab = cfg.vocab_size
    dev = prompt.device
    logits, cache = prefill(params, prompt, cfg, t + max_new_tokens)
    logp0 = torch.log_softmax(logits[0, -1].float(), dim=-1)
    # Seed: the top-k first tokens of the single prompt hypothesis, its
    # cache replicated across the beam axis.
    scores, first = _top_k(logp0, k)
    cache = _gather_cache(cache, torch.zeros(k, dtype=torch.long,
                                             device=dev))
    seqs = torch.zeros((k, max_new_tokens), dtype=torch.int64, device=dev)
    seqs[:, 0] = first
    finished = (first == eos_id if eos_id is not None
                else torch.zeros(k, dtype=torch.bool, device=dev))
    lengths = torch.ones(k, dtype=torch.int32, device=dev)
    pad_row = None
    if eos_id is not None:
        # A frozen beam proposes exactly one continuation (token 0) at no
        # cost, so it keeps competing without growing.
        pad_row = torch.full((vocab,), NEG_BIG, device=dev)
        pad_row[0] = 0.0
    for i in range(1, max_new_tokens):
        step_logits, cache = decode_step(params, cache, seqs[:, i - 1:i], cfg)
        logp = torch.log_softmax(step_logits.float(), dim=-1)  # [k, V]
        if pad_row is not None:
            logp = torch.where(finished[:, None], pad_row[None, :], logp)
        total = scores[:, None] + logp
        scores, flat = _top_k(total.reshape(-1), k)
        parents = torch.div(flat, vocab, rounding_mode="floor")
        tokens = flat % vocab
        cache = _gather_cache(cache, parents)
        seqs = seqs.index_select(0, parents)
        if eos_id is not None:
            finished = finished.index_select(0, parents)
            lengths = lengths.index_select(0, parents)
            tokens = torch.where(finished, 0, tokens)
            lengths = lengths + (~finished).to(torch.int32)
        else:
            lengths = lengths + 1
        seqs[:, i] = tokens
        if eos_id is not None:
            finished = finished | (tokens == eos_id)
    # GNMT length normalization over the generated length.
    norm = ((5.0 + lengths.float()) / 6.0) ** alpha
    return seqs, scores, lengths, scores / norm


def best_hypothesis(seqs, scores, lengths, normalized) -> tuple:
    """The winner of ``beam_steps``' beams (the highest normalized
    score): (its generated tokens [max_new] on the device, stats)."""
    best = int(torch.argmax(normalized))
    return seqs[best], {"score": float(scores[best]),
                        "normalized_score": float(normalized[best]),
                        "length": int(lengths[best])}


@torch.no_grad()
def _beam(params, prompt, cfg: TransformerConfig, max_new_tokens: int,
          beam_size: int, alpha: float, eos_id: int | None):
    generated, stats = best_hypothesis(*beam_steps(
        params, prompt, cfg, max_new_tokens, beam_size, alpha, eos_id))
    out = torch.cat([prompt[0].to(torch.int64), generated])[None]
    return out.to(torch.int32), stats


def make_beam_search_fn(cfg: TransformerConfig, beam_size: int = 4,
                        alpha: float = 0.6, eos_id: int | None = None):
    """``(params, prompt [1, t], max_new_tokens) -> (tokens [1, t +
    max_new], stats)``.  ``stats['score']`` is the best hypothesis's total
    logprob; with ``eos_id`` set, tokens after a beam's EOS are 0-padding
    and ``stats['length']`` bounds the real generation."""
    if not 1 <= beam_size <= cfg.vocab_size:
        raise ValueError(
            f"beam_size must be in [1, vocab_size={cfg.vocab_size}], "
            f"got {beam_size}"
        )

    def fn(params, prompt, max_new_tokens: int):
        return _beam(params, prompt, cfg, max_new_tokens, beam_size, alpha,
                     eos_id)

    return fn
