"""Continuous-batching inference engine over a dense or a paged KV cache.

The counterpart of ``oim_tpu/serve/engine.py`` on its dense and paged
paths:

- **Two cache layouts, one pair of kernels.**  The dense ``SlotCache``
  (``kv_block=0``, the default) keeps one ``max_len`` region per slot,
  ``[n_layers, n_slots, max_len, kv_heads, head_dim]``.  The paged
  ``PagedCache`` keeps one pool of fixed-size blocks ``[n_layers,
  n_blocks, block_size, kv_heads, head_dim]`` plus a host-side allocator
  and per-slot block table; sentinel entries (``n_blocks``) mark
  unallocated blocks, and an admission reserves its worst case
  (bucketed prompt vs prompt + budget), block-rounded and
  all-or-nothing.  The kernels see a dense layer's regions as a pool of
  blocks too (a reshape, no copy) through a fixed identity table, so
  both layouts run the same kernels.
- **Attention in the Hopper kernels.**  Every layer of every admission
  and decode step stores the new K/V rows into the cache and attends
  straight off it through ``paged_flash_prefill`` — kernel K2 (store,
  fused int8 quant) then kernel K1 (flash decode) on the GPU, their
  plain versions on the CPU.
- **Continuous batching, chunked decode, a two-deep pipeline.**
  Admissions are prefilled in one dispatch per prompt bucket; every
  slot's row advances ``chunk`` tokens per decode dispatch with one
  readback per chunk.  At ``pipeline_depth=2`` (the default) chunk N+1
  is dispatched before chunk N is read back: it takes its tokens from
  chunk N's device-side carry, and its positions and sampling keys from
  the host, ``chunk`` further on.  Admissions join at pipeline
  boundaries.  EOS lags by at most one chunk (two at depth 2): bounded
  waste, never wrong tokens, since the host truncates.
- **One CUDA graph per decode chunk.**  On the GPU a decode chunk — its
  ``chunk`` passes through every layer and the sampling — is one
  ``torch.cuda.CUDAGraph`` replay over inputs and outputs at fixed
  device addresses, fed from and read into pinned host buffers without
  a synchronising copy.  Admission runs eagerly.
- **Exactness.**  Each slot attends only its own positions and each
  sampled token draws noise keyed by ``(request seed, token index)``
  (``models/decode.py``), so results never depend on the slot, the
  batch, the chunk size or the pipeline depth: greedy streams equal the
  solo ``generate`` and the reference's, sampled streams the port's solo
  ``generate``.

Features of the reference engine this slice does not port are refused
at construction or submission with the ROADMAP item that will bring
them.
"""

from __future__ import annotations

import statistics
import threading
import time
from collections import deque
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from oim_tpu_torch.models.decode import (
    _mlp,
    _validate_truncation,
    apply_penalties,
    nucleus_min_p_mask,
    sampling_noise,
    truncate_logits,
)
from oim_tpu_torch.models.transformer import (
    TransformerConfig,
    _qkv,
    _rmsnorm,
    _unembed,
    embed_lookup,
)
from oim_tpu_torch.models.weights import n_params, to_device
from oim_tpu_torch.ops import paged_attention
from oim_tpu_torch.ops.paged_attention import (
    MAX_BLOCK_SIZE,
    paged_flash_prefill,
    supported_block_size,
)
from oim_tpu_torch.ops.quant import make_kv_buffers
from oim_tpu_torch.ops.rope import apply_rope


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for the CPU.  No GPU and no explicit ``cpu`` is an error, never a
    quiet CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' (--device cpu) "
            "to run the plain PyTorch path on the CPU"
        )
    return dev


def _not_ported(option: str, item: str) -> ValueError:
    return ValueError(
        f"{option} is not ported to oim_tpu_torch yet (ROADMAP Queue A: "
        f"{item})"
    )


# ---------------------------------------------------------------------------
# Caches and allocator


@dataclass
class PagedCache:
    """Paged KV pool: ``k``/``v`` [n_layers, n_blocks, block_size,
    kv_heads, head_dim]; ``k_scale``/``v_scale`` [n_layers, n_blocks,
    block_size, kv_heads] f32 for int8 payloads, else None.  Which
    blocks belong to which slot lives outside, in the engine's block
    table.  The kernels write into these tensors in place."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @classmethod
    def create(cls, cfg: TransformerConfig, n_blocks: int, block_size: int,
               quantized: bool = False, device=None) -> "PagedCache":
        shape = (
            cfg.n_layers, n_blocks, block_size, cfg.kv_heads, cfg.head_dim
        )
        k, v, ks, vs = make_kv_buffers(
            shape, cfg.compute_dtype, quantized, device=device
        )
        return cls(k=k, v=v, k_scale=ks, v_scale=vs)

    def layer(self, i: int) -> tuple:
        """Layer ``i``'s (k, v, k_scale, v_scale) pool views."""
        ks = None if self.k_scale is None else self.k_scale[i]
        vs = None if self.v_scale is None else self.v_scale[i]
        return self.k[i], self.v[i], ks, vs


def dense_block_size(max_len: int) -> int:
    """The block size the kernels see a dense region in: the largest
    that divides ``max_len`` and one step of K1's ring holds."""
    return max(b for b in range(1, MAX_BLOCK_SIZE + 1) if max_len % b == 0)


@dataclass
class SlotCache:
    """Dense KV cache, one region per slot (the reference's layout):
    ``k``/``v`` [n_layers, n_slots, max_len, kv_heads, head_dim];
    ``k_scale``/``v_scale`` [n_layers, n_slots, max_len, kv_heads] f32
    for int8 payloads, else None.  ``layer`` hands the kernels each
    layer's regions as a pool of ``n_slots · max_len / block_size``
    blocks of ``block_size`` rows (a reshape, no copy): slot ``s``'s
    region is blocks ``s · n_tables … (s + 1) · n_tables − 1``, the
    engine's fixed table row for it.  K1 stops at each row's causal
    frontier, so a slot's attention reads its live rows only."""

    k: torch.Tensor
    v: torch.Tensor
    block_size: int
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @classmethod
    def create(cls, cfg: TransformerConfig, n_slots: int, max_len: int,
               block_size: int, quantized: bool = False,
               device=None) -> "SlotCache":
        shape = (cfg.n_layers, n_slots, max_len, cfg.kv_heads, cfg.head_dim)
        k, v, ks, vs = make_kv_buffers(
            shape, cfg.compute_dtype, quantized, device=device
        )
        return cls(k=k, v=v, block_size=block_size, k_scale=ks, v_scale=vs)

    def layer(self, i: int) -> tuple:
        """Layer ``i``'s (k, v, k_scale, v_scale) as pool views."""
        n_slots, max_len = self.k.shape[1:3]
        blocks = n_slots * max_len // self.block_size

        def pool(t):
            if t is None:
                return None
            return t[i].reshape(blocks, self.block_size, *t.shape[3:])

        return (pool(self.k), pool(self.v), pool(self.k_scale),
                pool(self.v_scale))


class BlockAllocator:
    """Host-side refcounted allocator over the pool's block ids.  Pure
    bookkeeping under the engine's lock; ``alloc`` is all-or-nothing
    (a shortage is queue backpressure, never a partial slot)."""

    def __init__(self, n_blocks: int):
        if n_blocks < 1:
            raise ValueError(f"need n_blocks >= 1, got {n_blocks}")
        self.n_blocks = n_blocks
        self._free: list[int] = list(range(n_blocks - 1, -1, -1))
        self._refs = np.zeros((n_blocks,), np.int64)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.n_blocks - len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """``n`` fresh blocks at ref 1, or None (all-or-nothing)."""
        if n < 0:
            raise ValueError(f"need n >= 0, got {n}")
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        self._refs[ids] += 1
        return ids

    def decref(self, ids) -> int:
        """Drop one ref per id; blocks reaching zero return to the free
        list.  Returns how many were freed."""
        freed = 0
        for b in ids:
            if self._refs[b] <= 0:
                raise ValueError(f"decref of free block {b}")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                self._free.append(int(b))
                freed += 1
        return freed


# ---------------------------------------------------------------------------
# Device functions


def _slot_attention(x, lp, cache, layer: int, starts, tables,
                    cfg: TransformerConfig):
    """Cached attention for rows at per-slot positions through the
    cache's pool views: x [B, t, D]; starts [B] int32 (row b's token i
    sits at ``starts[b] + i``); tables [B, n_tables] int32.  The new K/V
    rows land in the cache in place (sentinel entries drop) and the rows
    attend off the updated cache — one kernel pair per layer, for a
    prompt segment and a decode step alike.  The attention output comes
    back f32 and is cast to the compute dtype before ``wo``, as in the
    reference."""
    b, t, _ = x.shape
    q, k, v = _qkv(x, lp, cfg)
    positions = starts.long()[:, None] + torch.arange(t, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
    k_pool, v_pool, k_scale, v_scale = cache.layer(layer)
    out, *_ = paged_flash_prefill(
        q, k, v, k_pool, v_pool, k_scale, v_scale, tables, starts,
        window=cfg.sliding_window,
    )
    out = out.to(x.dtype).reshape(b, t, cfg.n_heads * cfg.head_dim)
    return x + (out @ lp["wo"]).to(x.dtype)


def _hidden_slots(params, tokens, cache, starts, tables,
                  cfg: TransformerConfig):
    """tokens [B, t] at per-slot positions ``starts`` → final-norm hidden
    states [B, t, D], extending the cache in place (a Python loop over
    layers; no unembedding, so prefill unembeds one position per row).
    MoE layers route every token drop-free (``_moe_exact``), so a row's
    result never depends on its batchmates or its padding.  The Pallas
    switch is off here, as in the reference's engine: serving
    normalizes with the plain formula."""
    cfg = replace(cfg, use_pallas=False)
    x = embed_lookup(params["wte"], tokens, cfg)
    for layer, lp in enumerate(params["layers"]):
        x = _slot_attention(x, lp, cache, layer, starts, tables, cfg)
        x = _mlp(x, lp, cfg)
    return _rmsnorm(x, params["final_norm"], cfg)


# A dispatch's per-row sampling columns, in this order, and each one's
# value for a row with no request (neutral: no truncation, no penalty).
_COLUMNS = ("temperature", "top_p", "min_p", "repetition_penalty",
            "presence_penalty", "frequency_penalty")
_NEUTRAL = np.asarray([0.0, 1.0, 0.0, 1.0, 0.0, 0.0], np.float32)


def _columns(reqs, default_top_p: float) -> np.ndarray:
    """The sampling columns [6, len(reqs)] f32 of ``reqs``."""
    cols = np.empty((len(_COLUMNS), len(reqs)), np.float32)
    for r, req in enumerate(reqs):
        cols[:, r] = (
            req.temperature,
            default_top_p if req.top_p is None else req.top_p,
            req.min_p, req.repetition_penalty, req.presence_penalty,
            req.frequency_penalty,
        )
    return cols


def _sampling_key(cols: np.ndarray) -> tuple[bool, bool]:
    """(some row samples, some sampled row truncates by top-p or min-p):
    the host-side facts that decide which sampling work runs at all, and
    the key of a decode chunk's graph."""
    sampled = cols[0] > 0.0
    truncates = (cols[1] < 1.0) | (cols[2] > 0.0)
    return bool(sampled.any()), bool((sampled & truncates).any())


@dataclass
class _Sampling:
    """Per-row sampling inputs of one dispatch: the columns as a device
    tensor [6, S] (``_COLUMNS``' order) and the ``_sampling_key`` facts
    (no device sync on the decision)."""

    cols: torch.Tensor
    sampled: bool
    truncate_p: bool


def _noise(seeds, indices, sampled, steps: int, vocab: int, device,
           out=None):
    """Gumbel noise [steps, S, V] f32: row r of step i is the noise of
    token ``indices[r] + i`` of row r's request (an index counted from
    its ``sample_base``) for each ``sampled`` row.  ``out`` is filled in
    place when given (other rows keep what they hold: greedy rows never
    read theirs), else a new tensor of zeros."""
    if out is None:
        out = torch.zeros((steps, len(seeds), vocab), dtype=torch.float32,
                          device=device)
    for r in np.flatnonzero(sampled):
        for i in range(steps):
            out[i, r] = sampling_noise(int(seeds[r]), int(indices[r]) + i,
                                       vocab, device)
    return out


def _sample_batched(logits, s: _Sampling, noise, top_k: int, counts):
    """Per-row sampling over f32 logits [S, V]: greedy where temperature
    is 0, else the Gumbel-max draw over the temperature-scaled logits
    truncated by the engine-static top-k and the per-row top-p/min-p.
    ``counts`` = (tok_counts, gen_counts) [S, V] feed the penalties,
    applied first (neutral rows are exact no-ops; None: the engine runs
    without penalties).  Returns ``(tokens [S] int64, logprobs [S])`` —
    the logprob under the penalty-adjusted, temperature-1, untruncated
    distribution."""
    temps, top_ps, min_ps, reps, press, freqs = s.cols
    if counts is not None:
        logits = apply_penalties(logits, counts[0], counts[1], reps, press,
                                 freqs)
    tokens = torch.argmax(logits, dim=-1)
    if noise is not None:
        scaled = truncate_logits(
            logits / torch.clamp_min(temps, 1e-6)[:, None], top_k
        )
        if s.truncate_p:
            scaled = nucleus_min_p_mask(scaled, top_ps, min_ps)
        sampled = torch.argmax(scaled + noise, dim=-1)
        tokens = torch.where(temps > 0, sampled, tokens)
    chosen = torch.gather(logits, 1, tokens[:, None])[:, 0]
    return tokens, chosen - torch.logsumexp(logits, dim=-1)


def _admit_batch(params, cache, row_tables, prompts, starts, true_tails,
                 s: _Sampling, noise, cfg: TransformerConfig, top_k: int,
                 counts):
    """Prefill a group of admissions sharing a prompt bucket in one
    dispatch and sample each one's first token.  prompts [S, bucket]
    (each row's prompt, zero-padded); starts [S] int32; true_tails [S]
    valid lengths; row_tables [S, n_tables] int32; noise [S, V] (each
    request's token 0, offset by its ``sample_base``) or None.  Padding
    positions past a row's true length are written into the slot's own
    rows and masked until decode overwrites them.  Returns (tokens [S],
    logprobs [S])."""
    x = _hidden_slots(params, prompts, cache, starts, row_tables, cfg)
    rows = torch.arange(x.shape[0], device=x.device)
    last = x[rows, true_tails.long() - 1]
    logits = _unembed(last, params["wlm"], cfg)
    return _sample_batched(logits, s, noise, top_k, counts)


def _decode_chunk(params, cache, tables, tokens, starts, live,
                  s: _Sampling, noise, cfg: TransformerConfig, *,
                  chunk: int, top_k: int, max_len: int, counts):
    """Advance every row ``chunk`` tokens: tokens [S] int64 (each row's
    latest token), starts [S] int32 (where it is written), live [S]
    int32 (1 for a row with a request), noise [chunk, S, V] or None.  A
    row that is not live keeps its token, its position and its counts;
    a live row past its budget keeps computing and its position clamps
    at the cache edge (the host truncates).  ``counts`` (tok_counts,
    gen_counts) [S, V] are updated in place.  Returns (tokens [S, chunk],
    logprobs [S, chunk], the last tokens [S]) on the device."""
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    active = live > 0
    outs, lps = [], []
    for i in range(chunk):
        x = _hidden_slots(params, tokens[:, None], cache, starts, tables, cfg)
        logits = _unembed(x[:, -1], params["wlm"], cfg)
        nxt, lp = _sample_batched(
            logits, s, None if noise is None else noise[i], top_k, counts
        )
        nxt = torch.where(active, nxt, tokens)
        if counts is not None:
            for c in counts:
                c[rows, nxt] += live
        starts = torch.clamp_max(starts + live, max_len - 1)
        tokens = nxt
        outs.append(nxt)
        lps.append(lp)
    return torch.stack(outs, dim=1), torch.stack(lps, dim=1), tokens


# The keys of a decode chunk's graphs: (some row samples, some sampled
# row truncates).  Truncation matters only to sampled rows.
_GRAPH_KEYS = ((False, False), (True, False), (True, True))


class _ChunkBuffers:
    """A decode chunk's inputs and outputs at fixed device addresses —
    what a captured graph reads and writes — and the host buffers around
    them.  Inputs: ``tokens`` [S] int64 (also the carry: the chunk's last
    tokens are written back), ``meta`` [2, S] int32 (starts, live),
    ``cols`` [6, S], ``tables`` [S, n_tables], ``noise`` [chunk, S, V];
    outputs ``out`` [S, chunk] and ``lps`` [S, chunk].  Two sets of host
    staging for the inputs and two of host outputs, taken in turn, one
    per chunk in flight: pinned on the GPU, so copies between them and
    the device do not wait for the device, and a staging set is not
    rewritten before the copies from it are done (``staged``)."""

    _STAGED = ("tokens", "meta", "cols", "tables")

    def __init__(self, n_slots: int, n_tables: int, chunk: int, vocab: int,
                 device):
        def dev(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.tokens = dev((n_slots,), torch.int64)
        self.meta = dev((2, n_slots), torch.int32)
        self.cols = dev((len(_COLUMNS), n_slots), torch.float32)
        self.tables = dev((n_slots, n_tables), torch.int32)
        self.noise = dev((chunk, n_slots, vocab), torch.float32)
        self.out = dev((n_slots, chunk), torch.int64)
        self.lps = dev((n_slots, chunk), torch.float32)
        pin = torch.device(device).type == "cuda"

        def host(t):
            return torch.zeros(t.shape, dtype=t.dtype, pin_memory=pin)

        self.stages = [{name: host(getattr(self, name))
                        for name in self._STAGED} for _ in range(2)]
        self.staged: list = [None, None]
        self.results = [(host(self.out), host(self.lps)) for _ in range(2)]
        self.turn = 0


@dataclass
class _ChunkInputs:
    """The host side of a fresh dispatch, reused verbatim by the chained
    dispatches after it: which rows are live, their sampling columns,
    seeds and graph key."""

    live: np.ndarray  # [S] int32
    cols: np.ndarray  # [6, S] f32
    seeds: list[int]
    key: tuple[bool, bool]


@dataclass
class _InFlightChunk:
    """One dispatched decode chunk, read back by ``_process_chunk`` or
    dropped unread (``abort``, the all-slots-finished tail).
    ``snapshot`` maps slot → the state that owned it at dispatch, so
    processing never gives a chunk's tokens to a later occupant;
    ``starts`` and ``indices`` [S] are this dispatch's positions and
    sampling keys, from which a chained dispatch takes its own
    (``+ chunk``); ``out``/``lps`` are the host buffers its results land
    in once ``done`` (a CUDA event; None on the CPU) has passed."""

    snapshot: dict
    inputs: _ChunkInputs
    starts: np.ndarray
    indices: np.ndarray
    out: torch.Tensor
    lps: torch.Tensor
    done: object
    t_dispatch: float


# ---------------------------------------------------------------------------
# Host engine


@dataclass
class GenRequest:
    """One generation request.  ``tokens`` are prompt token ids;
    sampling parameters are per request except top-k, which is
    engine-static.  ``deadline`` is an absolute ``time.monotonic()``
    instant (None = none).  ``sample_base`` offsets every sampled
    token's noise index: a continuation that resends the prompt plus the
    k tokens a client already holds, with ``sample_base = k``, draws the
    uninterrupted stream's noise from token k on.  ``cache_prefix``,
    ``hold_kv`` and ``kv_import`` belong to features not ported yet and
    are refused at submission when set."""

    tokens: list[int]
    max_new_tokens: int
    temperature: float = 0.0
    seed: int = 0
    eos_id: int | None = None
    stop_ids: tuple[int, ...] = ()
    top_p: float | None = None
    min_p: float = 0.0
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    cache_prefix: bool = False
    deadline: float | None = None
    hold_kv: bool = False
    kv_import: int | None = None
    sample_base: int = 0


class QueueFullError(RuntimeError):
    """Admission queue at capacity — back off and retry (HTTP 429)."""


class DrainingError(RuntimeError):
    """Engine is draining for shutdown — no new admissions (HTTP 503)."""


class DeadlineExpiredError(RuntimeError):
    """Request deadline already expired at submission (HTTP 429)."""


class EngineFailedError(RuntimeError):
    """The engine latched a crash in ``step`` — no new work is accepted
    until the process restarts (HTTP 503)."""


_KIND_TEXT = {
    "aborted": "aborted",
    "cancelled": "cancelled",
    "deadline": "deadline exceeded",
    "deadline_queue": "shed (deadline expired in queue)",
}


class RequestFailedError(RuntimeError):
    """One request failed without a result; ``kind`` tells the HTTP
    layer which status to answer: "aborted" (500), "cancelled",
    "deadline" (504), "deadline_queue" (429)."""

    def __init__(self, rid: int, kind: str, message: str):
        super().__init__(
            f"request {rid} {_KIND_TEXT.get(kind, kind)}: {message}"
        )
        self.rid = rid
        self.kind = kind


@dataclass
class _SlotState:
    rid: int
    req: GenRequest
    t_submit: float
    length: int  # cache frontier: where the next token's K/V is written
    emitted: list[int] = field(default_factory=list)
    logprobs: list[float] = field(default_factory=list)
    last_token: int = 0


class Engine:
    """Continuous-batching engine: submit → step/run → result.

    Thread-safe for one step thread calling ``step``/``run`` while any
    number of threads call ``submit``/``result`` (the HTTP server's
    usage).  ``device`` defaults to CUDA; without a GPU the caller must
    ask for ``"cpu"``, where the kernel wrappers run their plain
    versions.  On the GPU each decode chunk replays a CUDA graph,
    captured at ``warmup`` (or at the first decode dispatch);
    ``cuda_graphs=False`` dispatches the same chunk eagerly instead, the
    A/B control for measurements.  A capture or replay that fails
    raises: the engine never falls back to eager dispatch by itself.
    """

    def __init__(
        self,
        params,
        cfg: TransformerConfig,
        *,
        n_slots: int = 4,
        max_len: int = 1024,
        chunk: int = 8,
        prompt_buckets: tuple[int, ...] | None = None,
        top_k: int = 0,
        top_p: float = 1.0,
        kv_int8: bool = False,
        kv_int4: bool = False,
        prefix_cache_size: int = 0,
        spec_decode: int = 0,
        penalties: bool = True,
        max_queue: int = 0,
        prefill_chunk: int = 0,
        pipeline_depth: int = 2,
        kv_block: int = 0,
        kv_blocks: int = 0,
        kv_host_bytes: int = 0,
        qos=None,
        device=None,
        cuda_graphs: bool = True,
    ):
        self.device = resolve_device(device)
        if pipeline_depth not in (1, 2):
            raise ValueError(
                f"pipeline_depth must be 1 (serial) or 2 (dispatch-ahead "
                f"double buffering), got {pipeline_depth}"
            )
        if kv_block < 0 or kv_blocks < 0:
            raise ValueError(
                f"need kv_block>=0 and kv_blocks>=0; got {kv_block}, "
                f"{kv_blocks}"
            )
        self.paged = kv_block > 0
        if not self.paged and kv_blocks:
            raise ValueError("kv_blocks needs kv_block > 0")
        if kv_int8 and kv_int4:
            raise ValueError("kv_int8 and kv_int4 are mutually exclusive")
        if kv_int4 and not self.paged:
            raise ValueError(
                "kv_int4 needs the paged cache (kv_block > 0): only the "
                "block pool carries the per-block scales the fused "
                "dequant reads"
            )
        if kv_int4:
            raise _not_ported("kv_int4", "kv_int4 with packed nibbles")
        if prefix_cache_size:
            raise _not_ported("the prefix cache", "prefix cache/CoW")
        if spec_decode:
            raise _not_ported("spec_decode", "spec decode")
        if prefill_chunk:
            raise _not_ported("prefill_chunk", "prefill_chunk segments")
        if kv_host_bytes:
            raise _not_ported(
                "the host-RAM KV tier", "lifecycle surfaces (host tier)"
            )
        if qos is not None:
            raise _not_ported("QoS policies", "lifecycle surfaces (QoS)")
        if n_slots < 1 or max_len < 2 or chunk < 1:
            raise ValueError(
                f"need n_slots>=1, max_len>=2, chunk>=1; got {n_slots}, "
                f"{max_len}, {chunk}"
            )
        if self.paged and max_len % kv_block:
            raise ValueError(
                f"kv_block={kv_block} must divide max_len={max_len} "
                f"(the block table covers the region exactly)"
            )
        block_size = kv_block if self.paged else dense_block_size(max_len)
        if self.device.type == "cuda" and not supported_block_size(
                block_size, cfg.head_dim):
            # Fail here, with the constraint named, rather than in the
            # first launch on the step thread.
            raise ValueError(
                f"the paged-attention kernels need head_dim in (64, 128) "
                f"and blocks of 1 to 64 rows; got head_dim={cfg.head_dim}, "
                f"{'kv_block' if self.paged else 'a dense block'}="
                f"{block_size}"
            )
        if max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {max_queue}")
        _validate_truncation(top_k, top_p, cfg.vocab_size)
        self.cfg = cfg
        self.params = to_device(params, self.device)
        self.n_params = n_params(self.params)
        self.n_slots = n_slots
        self.max_len = max_len
        self.chunk = chunk
        self.top_k = top_k
        self.default_top_p = top_p
        self.kv_int8 = kv_int8
        self.penalties = penalties
        self.max_queue = max_queue
        self.pipeline_depth = pipeline_depth
        self.kv_block = kv_block
        self._n_tables = max_len // block_size
        if prompt_buckets is None:
            prompt_buckets, b = [], 16
            while b < max_len:
                prompt_buckets.append(b)
                b *= 2
            prompt_buckets.append(max_len - 1)
        self.prompt_buckets = tuple(sorted(set(prompt_buckets)))
        bad = [b for b in self.prompt_buckets if not 1 <= b <= max_len - 1]
        if bad:
            raise ValueError(
                f"prompt_buckets must fit 1..{max_len - 1} (each admitted "
                f"prompt needs >= 1 generated token): {bad}"
            )
        if self.paged:
            self.kv_blocks = kv_blocks or n_slots * self._n_tables
            self._cache = PagedCache.create(
                cfg, self.kv_blocks, kv_block, quantized=kv_int8,
                device=self.device,
            )
            self._alloc = BlockAllocator(self.kv_blocks)
            # Sentinel rows until an admission reserves blocks.
            self._sentinel = self.kv_blocks
            self._tables_host = np.full(
                (n_slots, self._n_tables), self._sentinel, np.int32
            )
        else:
            self.kv_blocks = 0
            self._cache = SlotCache.create(
                cfg, n_slots, max_len, block_size, quantized=kv_int8,
                device=self.device,
            )
            self._alloc = None
            # The identity table: slot s's region is its own blocks.
            self._sentinel = n_slots * self._n_tables
            self._tables_host = np.arange(
                self._sentinel, dtype=np.int32
            ).reshape(n_slots, self._n_tables)
        # Per-slot token counts for the penalties: prompt + generated,
        # and generated only (none without penalties).
        self._tok_counts = self._gen_counts = None
        if penalties:
            self._tok_counts = torch.zeros(
                (n_slots, cfg.vocab_size), dtype=torch.int32,
                device=self.device,
            )
            self._gen_counts = torch.zeros_like(self._tok_counts)
        self._buf = _ChunkBuffers(n_slots, self._n_tables, chunk,
                                  cfg.vocab_size, self.device)
        self.cuda_graphs = cuda_graphs and self.device.type == "cuda"
        self._graphs: dict | None = None
        self._graph_counts: dict = {}
        self._inflight: _InFlightChunk | None = None
        self._lock = threading.Lock()
        self._queue: deque = deque()  # (rid, req, t_submit)
        self._free: list[int] = list(range(n_slots))
        self._slots: dict[int, _SlotState] = {}
        self._admitting: dict[int, int] = {}  # rid → slot, mid-admission
        self._events: dict[int, threading.Event] = {}
        self._results: dict[int, tuple[list[int], list[float]]] = {}
        self._errors: dict[int, tuple[str, str]] = {}
        self._cancelled: set[int] = set()
        self._forgotten: set[int] = set()
        self._next_rid = 0
        self._draining = False
        self._fatal: str | None = None
        self._warming = False
        # Host-side accounting (stats()); warmup's dummies are not
        # counted.
        self.steps = 0
        self.tokens_generated = 0
        self.kv_admit_deferrals = 0
        self.prefill_seconds = 0.0
        # Decode wall: each processed chunk's from its dispatch, or from
        # the previous chunk's readback when it overlapped it, to its
        # own readback.
        self.decode_seconds = 0.0
        self.decode_tokens = 0
        # Forward passes through the layer stack: one per admission
        # group and one per decode step dispatched (each runs both
        # kernels once per layer) — a chunk dropped unread included.
        self.prefill_dispatches = 0
        self.decode_passes = 0
        self.decode_dispatches = 0
        self.graph_replays = 0
        self.readbacks = 0
        # The pipeline's split of step() walls, under the reference's
        # names: readback_seconds is the wall blocked on a chunk's
        # results, overlap_seconds the part of it spent while the next
        # chunk was already dispatched, dispatch_seconds the wall
        # enqueueing chunks, device_idle_seconds the wall between a
        # readback with nothing dispatched behind it and the next
        # dispatch.
        self.readback_seconds = 0.0
        self.overlap_seconds = 0.0
        self.dispatch_seconds = 0.0
        self.device_idle_seconds = 0.0
        # Chained dispatches skipped because the chunk in flight already
        # covers every slot's remaining budget.
        self.tail_elisions = 0
        # Host walls of warmup() (its graph capture included) and of the
        # capture alone.
        self.warmup_seconds = 0.0
        self.graph_capture_seconds = 0.0
        self._t_device_free: float | None = None
        self._t_last_chunk_done: float | None = None
        self._ttfts: deque[float] = deque(maxlen=256)

    # -- submission and results ---------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.prompt_buckets:
            if n <= b:
                return b
        raise AssertionError("submit() bounds prompt length")

    def _worst_case_rows(self, n_tokens: int, max_new: int) -> int:
        """The most slot rows a request can touch: its bucketed prefill
        window or prompt + budget, whichever is larger — the one bound
        the submit-time fit check, warmup and admission share."""
        return min(self.max_len, max(self._bucket(n_tokens),
                                     n_tokens + max_new))

    def _pool_blocks_needed(self, n_tokens: int, max_new: int) -> int:
        """Pool blocks a request reserves (0 on the dense layout, whose
        slots own their regions)."""
        if not self.paged:
            return 0
        return -(-self._worst_case_rows(n_tokens, max_new) // self.kv_block)

    def _validate(self, req: GenRequest) -> None:
        if req.cache_prefix:
            raise _not_ported("cache_prefix", "prefix cache/CoW")
        if req.hold_kv or req.kv_import is not None:
            raise _not_ported(
                "KV shipping (hold_kv/kv_import)",
                "lifecycle surfaces (disaggregation)",
            )
        if not req.tokens:
            raise ValueError("empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if req.sample_base < 0:
            raise ValueError("sample_base must be >= 0")
        if len(req.tokens) > self.prompt_buckets[-1]:
            raise ValueError(
                f"prompt length {len(req.tokens)} exceeds largest bucket "
                f"{self.prompt_buckets[-1]}"
            )
        if len(req.tokens) + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {len(req.tokens)} + max_new_tokens "
                f"{req.max_new_tokens} exceeds max_len {self.max_len}"
            )
        need = self._pool_blocks_needed(len(req.tokens), req.max_new_tokens)
        if need > self.kv_blocks:
            # Queued, it could never be admitted and would wedge the
            # queue behind it.
            raise ValueError(
                f"request needs {need} KV blocks worst-case but the pool "
                f"holds only {self.kv_blocks} blocks of {self.kv_block}"
            )
        if req.top_p is not None and not 0.0 < req.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {req.top_p}")
        if not 0.0 <= req.min_p < 1.0:
            raise ValueError(f"min_p must be in [0, 1), got {req.min_p}")
        if req.repetition_penalty <= 0:
            raise ValueError(
                f"repetition_penalty must be > 0, got "
                f"{req.repetition_penalty}"
            )
        wants_penalties = (
            req.repetition_penalty != 1.0
            or req.presence_penalty != 0.0
            or req.frequency_penalty != 0.0
        )
        if not self.penalties and wants_penalties:
            raise ValueError(
                "this engine was built with penalties=False "
                "(oim-serve --no-penalties); restart without it"
            )
        bad = [t for t in req.tokens if not 0 <= t < self.cfg.vocab_size]
        if bad:
            raise ValueError(
                f"token ids out of range [0, {self.cfg.vocab_size}): "
                f"{bad[:5]}"
            )

    def submit(self, req: GenRequest) -> int:
        """Queue a request; returns its id."""
        self._validate(req)
        now = time.monotonic()
        if req.deadline is not None and now >= req.deadline:
            raise DeadlineExpiredError(
                "request deadline already expired at submission"
            )
        with self._lock:
            if self._fatal is not None:
                raise EngineFailedError(f"engine failed: {self._fatal}")
            if self._draining:
                raise DrainingError("engine is draining; not admitting")
            if self.max_queue and len(self._queue) >= self.max_queue:
                raise QueueFullError(
                    f"admission queue full ({self.max_queue}); retry later"
                )
            rid = self._next_rid
            self._next_rid += 1
            self._queue.append((rid, req, now))
            self._events[rid] = threading.Event()
        return rid

    def result(self, rid: int, timeout: float | None = None) -> list[int]:
        """Block until request ``rid`` completes; returns its generated
        tokens (truncated at EOS/stop).  Fetching consumes the result."""
        return self.result_full(rid, timeout)[0]

    def result_full(self, rid: int, timeout: float | None = None):
        """Like ``result`` but returns ``(tokens, logprobs)``."""
        try:
            event = self._events[rid]
        except KeyError:
            raise KeyError(f"request {rid} unknown or already fetched")
        if not event.wait(timeout):
            raise TimeoutError(f"request {rid} not done")
        with self._lock:
            del self._events[rid]
            if rid in self._errors:
                kind, message = self._errors.pop(rid)
                raise RequestFailedError(rid, kind, message)
            return self._results.pop(rid)

    def forget(self, rid: int) -> None:
        """Drop a request's future result (the caller gave up)."""
        with self._lock:
            if rid in self._results or rid in self._errors:
                self._events.pop(rid, None)
                self._results.pop(rid, None)
                self._errors.pop(rid, None)
            elif rid in self._events:
                self._forgotten.add(rid)

    def cancel(self, rid: int, message: str = "cancelled by client") -> bool:
        """Cancel one request: a queued one fails now, an admitting or
        active one at the next step.  False when unknown or done."""
        with self._lock:
            if rid in self._results or rid in self._errors:
                return False
            for i, (qrid, _, _) in enumerate(self._queue):
                if qrid == rid:
                    del self._queue[i]
                    self._fail_locked(rid, "cancelled", message)
                    return True
            if rid in self._admitting or any(
                s.rid == rid for s in self._slots.values()
            ):
                self._cancelled.add(rid)
                return True
            return False

    def _fail_locked(self, rid: int, kind: str, message: str) -> None:
        self._cancelled.discard(rid)
        if rid in self._forgotten:
            self._forgotten.discard(rid)
            self._events.pop(rid, None)
            return
        self._errors[rid] = (kind, message)
        if rid in self._events:
            self._events[rid].set()

    def abort(self, message: str) -> None:
        """Fail every queued, admitting and active request and reclaim
        their slots and blocks (the crash path of ``step``).  A chunk in
        flight is dropped unread: it references only the requests failed
        here, and the device finishes it before any later work."""
        with self._lock:
            self._inflight = None
            self._t_device_free = None
            rids = [rid for rid, _, _ in self._queue]
            rids += list(self._admitting)
            rids += [s.rid for s in self._slots.values()]
            for slot in sorted(set(self._slots) | set(
                    self._admitting.values())):
                self._release_slot_locked(slot)
            self._queue.clear()
            self._slots.clear()
            self._admitting.clear()
            for rid in rids:
                self._fail_locked(rid, "aborted", message)
            self._cancelled.clear()

    def drain(self) -> None:
        """Stop admitting; queued and active requests, and a chunk in
        flight, run to the end."""
        with self._lock:
            self._draining = True

    def in_flight(self) -> int:
        with self._lock:
            return len(self._queue) + len(self._admitting) + len(self._slots)

    def pending(self) -> bool:
        with self._lock:
            return bool(self._queue or self._slots)

    def set_pipeline_depth(self, depth: int) -> None:
        """Switch between serial (1) and dispatch-ahead (2) decode on a
        warm engine: the same graphs, only the step loop's overlap
        changes.  Legal only with no chunk in flight (an idle engine)."""
        if depth not in (1, 2):
            raise ValueError(f"pipeline_depth must be 1 or 2, got {depth}")
        with self._lock:
            if self._inflight is not None:
                raise RuntimeError(
                    "set_pipeline_depth needs an idle engine (a decode "
                    "chunk is in flight; drain or finish run() first)"
                )
            self.pipeline_depth = depth

    # -- introspection ------------------------------------------------------

    def info(self) -> dict:
        """Static model/engine description (GET /v1/info)."""
        cfg = self.cfg
        return {
            "model": {
                "vocab_size": cfg.vocab_size,
                "d_model": cfg.d_model,
                "n_layers": cfg.n_layers,
                "n_heads": cfg.n_heads,
                "n_kv_heads": cfg.kv_heads,
                "d_ff": cfg.ff_dim,
                "n_experts": cfg.n_experts,
                "moe_top_k": cfg.moe_top_k if cfg.n_experts else 0,
                "rope_theta": cfg.rope_theta,
                "rope_scaling": list(cfg.rope_scaling),
                "sliding_window": cfg.sliding_window,
                "norm_eps": cfg.norm_eps,
                "attn_bias": cfg.attn_bias,
                "dtype": cfg.dtype,
                "n_params": self.n_params,
            },
            "engine": {
                "n_slots": self.n_slots,
                "max_len": self.max_len,
                "chunk": self.chunk,
                "prompt_buckets": list(self.prompt_buckets),
                "max_queue": self.max_queue,
                "top_k": self.top_k,
                "default_top_p": self.default_top_p,
                "kv_int8": self.kv_int8,
                "penalties": self.penalties,
                "pipeline_depth": self.pipeline_depth,
                "paged": self.paged,
                "kv_block": self.kv_block,
                "kv_blocks": self.kv_blocks,
                "device": str(self.device),
                "attention": (
                    "cuda-kernels" if self.device.type == "cuda" else "plain"
                ),
                "cuda_graphs": self.cuda_graphs,
            },
        }

    def stats(self) -> dict:
        with self._lock:
            ttfts = list(self._ttfts)
            return {
                "active_slots": len(self._slots),
                "free_slots": len(self._free),
                "queued": len(self._queue),
                "steps": self.steps,
                "tokens_generated": self.tokens_generated,
                "kv_block_size": self.kv_block,
                "kv_blocks_total": self.kv_blocks,
                "kv_blocks_free": (
                    self._alloc.free_blocks if self.paged else 0
                ),
                "kv_blocks_used": (
                    self._alloc.used_blocks if self.paged else 0
                ),
                "kv_admit_deferrals": self.kv_admit_deferrals,
                "kv_quant": "int8" if self.kv_int8 else "",
                # Host clock around work that ends in a device readback,
                # so these are device-inclusive walls.
                "prefill_seconds": self.prefill_seconds,
                "decode_seconds": self.decode_seconds,
                "decode_tokens": self.decode_tokens,
                "prefill_dispatches": self.prefill_dispatches,
                "decode_passes": self.decode_passes,
                "decode_dispatches": self.decode_dispatches,
                "graph_replays": self.graph_replays,
                "readbacks": self.readbacks,
                "readback_seconds": self.readback_seconds,
                "dispatch_seconds": self.dispatch_seconds,
                "overlap_seconds": self.overlap_seconds,
                "overlap_ratio": (
                    self.overlap_seconds / self.readback_seconds
                    if self.readback_seconds > 0 else 0.0
                ),
                "device_idle_seconds": self.device_idle_seconds,
                "tail_elisions": self.tail_elisions,
                "warmup_seconds": self.warmup_seconds,
                "graph_capture_seconds": self.graph_capture_seconds,
                "pipeline_depth": self.pipeline_depth,
                "inflight_dispatches": int(self._inflight is not None),
                "ttft_p50_s": statistics.median(ttfts) if ttfts else 0.0,
                "kernel_counts": paged_attention.counters(),
                "fatal": self._fatal,
            }

    # -- engine loop (one step thread) --------------------------------------

    def step(self) -> None:
        """Reconcile the pipeline, reap, admit, dispatch and emit (see
        ``_step_inner``).  A crash latches the engine and fails every
        waiter before re-raising."""
        acc = [0.0, 0.0, 0.0]  # readback wait, dispatch wall, overlapped
        try:
            self._step_inner(acc)
            if not self._warming:
                self.steps += 1
        except Exception as exc:
            message = f"engine step failed: {type(exc).__name__}: {exc}"
            with self._lock:
                if self._fatal is None:
                    self._fatal = message
            self.abort(message)
            raise
        finally:
            if not self._warming:
                with self._lock:
                    self.readback_seconds += acc[0]
                    self.dispatch_seconds += acc[1]
                    self.overlap_seconds += acc[2]

    def run(self) -> dict[int, list[int]]:
        """Drain the queue and all active slots; returns {rid: tokens}
        for results not yet fetched."""
        while self.pending():
            self.step()
        with self._lock:
            return {rid: list(t) for rid, (t, _) in self._results.items()}

    @torch.no_grad()
    def warmup(self) -> "Engine":
        """Run one dummy request per prompt bucket (each that fits the
        pool): builds the kernels on first use and touches every prefill
        shape once before live traffic; on the GPU, captures the decode
        chunk's graphs."""
        t0 = time.monotonic()
        self._warming = True
        try:
            rids = []
            for b in self.prompt_buckets:
                max_new = min(2 * self.chunk, self.max_len - b)
                if self._pool_blocks_needed(b, max_new) > self.kv_blocks:
                    continue
                rids.append(self.submit(
                    GenRequest(tokens=[0] * b, max_new_tokens=max_new)
                ))
            self.run()
            for rid in rids:
                self.result(rid, timeout=0)
            if self.cuda_graphs and self._graphs is None:
                self._capture_graphs()
        finally:
            self._warming = False
        self.warmup_seconds = time.monotonic() - t0
        return self

    def _release_slot_locked(self, slot: int) -> None:
        """Return ``slot`` and, paged, its blocks, resetting its table
        row to the sentinel (lock held).  A dispatch copies the table
        into its own staging, so a chunk already queued keeps the row it
        was given."""
        if self.paged:
            row = self._tables_host[slot]
            live = row[row < self.kv_blocks]
            if live.size:
                self._alloc.decref(live.tolist())
            row[:] = self.kv_blocks
        self._free.append(slot)

    def _finish_locked(self, slot: int, state: _SlotState) -> None:
        self._slots.pop(slot, None)
        self._release_slot_locked(slot)
        self._cancelled.discard(state.rid)
        if state.rid in self._forgotten:
            self._forgotten.discard(state.rid)
            self._events.pop(state.rid, None)
            return
        self._results[state.rid] = (state.emitted, state.logprobs)
        self._events[state.rid].set()

    def _emit(self, state: _SlotState, token: int, logprob: float) -> bool:
        """Record one generated token; True when the request is done."""
        if not state.emitted and not self._warming:
            self._ttfts.append(time.monotonic() - state.t_submit)
        state.emitted.append(token)
        state.logprobs.append(logprob)
        if not self._warming:
            self.tokens_generated += 1
        if token == state.req.eos_id or token in state.req.stop_ids:
            return True
        state.last_token = token
        return len(state.emitted) >= state.req.max_new_tokens

    def _reap(self) -> None:
        """Fail cancelled and deadline-expired requests: queued ones
        before they touch a slot, active ones at this step (a chunk in
        flight skips their rows when it is read back)."""
        now = time.monotonic()
        with self._lock:
            if not self._cancelled and not any(
                r.deadline is not None for _, r, _ in self._queue
            ) and not any(
                s.req.deadline is not None for s in self._slots.values()
            ):
                return
            keep = deque()
            for rid, req, t_sub in self._queue:
                if rid in self._cancelled:
                    self._fail_locked(rid, "cancelled", "client went away")
                elif req.deadline is not None and now >= req.deadline:
                    self._fail_locked(
                        rid, "deadline_queue",
                        f"expired after {now - t_sub:.1f}s queued",
                    )
                else:
                    keep.append((rid, req, t_sub))
            self._queue = keep
            for slot, state in list(self._slots.items()):
                if state.rid in self._cancelled:
                    kind, msg = "cancelled", "client went away mid-decode"
                elif (state.req.deadline is not None
                      and now >= state.req.deadline):
                    kind = "deadline"
                    msg = f"expired after {len(state.emitted)} tokens"
                else:
                    continue
                self._slots.pop(slot)
                self._release_slot_locked(slot)
                self._fail_locked(state.rid, kind, msg)

    @torch.no_grad()
    def _step_inner(self, acc: list) -> None:
        """One step: reap, reconcile the pipeline, admit, dispatch, emit.

        At ``pipeline_depth`` 2 the step dispatches chunk N+1 before
        reading back chunk N, so the device computes while the host reads
        back and emits.  Admissions join at pipeline boundaries: a step
        with queued work and a free slot first completes the chunk in
        flight (it still references every slot), then admits; queued
        work with no free slot forces no boundary.  Tail elision: when
        the chunk in flight already covers every slot's remaining
        budget, a chained dispatch would be pure waste, so the step
        takes a boundary instead.  Depth 1 is the serial loop (every
        step is a boundary), token for token equal to depth 2."""
        self._reap()
        with self._lock:
            elide_tail = (
                self._inflight is not None
                and self.pipeline_depth >= 2
                and all(st.req.max_new_tokens - len(st.emitted) <= self.chunk
                        for st in self._slots.values())
            )
            admit_boundary = bool(self._queue) and bool(self._free)
            boundary = admit_boundary or self.pipeline_depth < 2 or elide_tail
            if elide_tail and not admit_boundary and not self._warming:
                self.tail_elisions += 1
        if boundary and self._inflight is not None:
            prev, self._inflight = self._inflight, None
            self._process_chunk(prev, acc)
        self._admit_wave()
        with self._lock:
            have_slots = bool(self._slots)
        if not have_slots:
            # Every request finished while a chunk was in flight: it
            # references finished slots only, so it is dropped unread.
            self._inflight = None
            self._clear_idle_clock_if_drained()
            return
        prev = self._inflight
        handle = self._dispatch_chunk(acc, prev)
        if self.pipeline_depth >= 2:
            self._inflight = handle
            if prev is not None:
                self._process_chunk(prev, acc)
            with self._lock:
                empty = not self._slots
            if empty:
                self._inflight = None  # the tail chunk: dead slots only
        else:
            self._process_chunk(handle, acc)
        self._clear_idle_clock_if_drained()

    def _clear_idle_clock_if_drained(self) -> None:
        """With no work at all the device is idle for want of it, not
        because the host held it up: stop the device-idle clock."""
        if self._inflight is not None:
            return
        with self._lock:
            if not self._slots and not self._queue:
                self._t_device_free = None

    def _admit_wave(self) -> None:
        """Admit whatever fits into free slots — only with no chunk in
        flight (the pipeline-boundary rule): paged, reserve each
        request's worst case from the pool (head-of-line: a shortage
        leaves it queued); then prefill one dispatch per prompt bucket
        and read every first token back at once."""
        if self._inflight is not None:
            return
        with self._lock:
            admissions = []
            while self._queue and self._free:
                rid, req, t_submit = self._queue[0]
                if self.paged:
                    blocks = self._alloc.alloc(self._pool_blocks_needed(
                        len(req.tokens), req.max_new_tokens
                    ))
                    if blocks is None:
                        if not self._warming:
                            self.kv_admit_deferrals += 1
                        break
                self._queue.popleft()
                slot = self._free.pop(0)
                if self.paged:
                    self._tables_host[slot, : len(blocks)] = blocks
                self._admitting[rid] = slot
                admissions.append((slot, rid, req, t_submit))
        if not admissions:
            return
        t0 = time.monotonic()
        dev = self.device
        vocab = self.cfg.vocab_size
        groups = []  # (rows, tokens, logprobs) per bucket
        for bucket in sorted({self._bucket(len(a[2].tokens))
                              for a in admissions}):
            rows = [a for a in admissions
                    if self._bucket(len(a[2].tokens)) == bucket]
            reqs = [req for _, _, req, _ in rows]
            prompts = np.zeros((len(rows), bucket), np.int64)
            for i, req in enumerate(reqs):
                prompts[i, : len(req.tokens)] = req.tokens
            slot_ids = [slot for slot, _, _, _ in rows]
            cols = _columns(reqs, self.default_top_p)
            s = _Sampling(torch.from_numpy(cols).to(dev),
                          *_sampling_key(cols))
            noise = None
            if s.sampled:
                noise = _noise([r.seed for r in reqs],
                               [r.sample_base for r in reqs], cols[0] > 0,
                               1, vocab, dev)[0]
            counts = None
            if self.penalties:
                prompt_counts = torch.from_numpy(np.stack([
                    np.bincount(req.tokens, minlength=vocab)
                    for req in reqs
                ]).astype(np.int32)).to(dev)
                counts = (prompt_counts, torch.zeros_like(prompt_counts))
            tokens, lps = _admit_batch(
                self.params, self._cache,
                torch.from_numpy(self._tables_host[slot_ids]).to(dev),
                torch.from_numpy(prompts).to(dev),
                torch.zeros(len(rows), dtype=torch.int32, device=dev),
                torch.tensor([len(r.tokens) for r in reqs], device=dev),
                s, noise, self.cfg, self.top_k, counts,
            )
            if self.penalties:
                idx = torch.tensor(slot_ids, device=dev)
                onehot = torch.zeros_like(prompt_counts)
                onehot[torch.arange(len(rows), device=dev), tokens] = 1
                self._tok_counts[idx] = prompt_counts + onehot
                self._gen_counts[idx] = onehot
            groups.append((rows, tokens, lps))
        # One readback for every admission of the wave.
        fetched = torch.cat(
            [torch.stack([t.double(), lp.double()]) for _, t, lp in groups],
            dim=1,
        ).cpu().numpy()
        if not self._warming:
            self.prefill_seconds += time.monotonic() - t0
            self.prefill_dispatches += len(groups)
        with self._lock:
            col = 0
            for rows, _, _ in groups:
                for slot, rid, req, t_submit in rows:
                    token = int(fetched[0, col])
                    lp = float(fetched[1, col])
                    col += 1
                    if self._admitting.pop(rid, None) is None:
                        continue  # abort() already failed it
                    state = _SlotState(
                        rid=rid, req=req, t_submit=t_submit,
                        length=len(req.tokens),
                    )
                    if rid in self._cancelled:
                        self._release_slot_locked(slot)
                        self._fail_locked(
                            rid, "cancelled",
                            "client went away during admission",
                        )
                        continue
                    if self._emit(state, token, lp):
                        self._finish_locked(slot, state)
                    else:
                        self._slots[slot] = state

    # -- decode chunks --------------------------------------------------------

    def _fresh_inputs(self, slots: dict):
        """A fresh dispatch's host inputs from the slots' states:
        (``_ChunkInputs``, tokens, starts, indices), every array over all
        ``n_slots`` rows.  A row with no request is not live, keeps the
        neutral columns and starts at 0, so that K1 walks none of a
        stale region."""
        n = self.n_slots
        live = np.zeros(n, np.int32)
        tokens = np.zeros(n, np.int64)
        starts = np.zeros(n, np.int32)
        indices = np.zeros(n, np.int64)
        cols = np.repeat(_NEUTRAL[:, None], n, axis=1)
        seeds = [0] * n
        for slot, st in slots.items():
            live[slot] = 1
            tokens[slot] = st.last_token
            starts[slot] = st.length
            # The global emission index: a continuation's sample_base
            # offsets every key to where the uninterrupted stream's was.
            indices[slot] = len(st.emitted) + st.req.sample_base
            cols[:, slot] = _columns([st.req], self.default_top_p)[:, 0]
            seeds[slot] = st.req.seed
        inputs = _ChunkInputs(live=live, cols=cols, seeds=seeds,
                              key=_sampling_key(cols))
        return inputs, tokens, starts, indices

    def _run_chunk(self, key: tuple[bool, bool]) -> None:
        """One decode chunk over the static buffers, eagerly — or, under
        a capture, the work that graph ``key`` replays: outputs into
        ``out``/``lps``, the last tokens back into ``tokens``."""
        b = self._buf
        counts = None
        if self.penalties:
            counts = (self._tok_counts, self._gen_counts)
        out, lps, last = _decode_chunk(
            self.params, self._cache, b.tables, b.tokens, b.meta[0],
            b.meta[1], _Sampling(b.cols, *key), b.noise if key[0] else None,
            self.cfg, chunk=self.chunk, top_k=self.top_k,
            max_len=self.max_len, counts=counts,
        )
        b.out.copy_(out)
        b.lps.copy_(lps)
        b.tokens.copy_(last)

    def _capture_graphs(self) -> None:
        """Capture one CUDA graph of ``_run_chunk`` per ``_GRAPH_KEYS``
        key, into one memory pool (replays never overlap: one stream).
        The static inputs are made harmless first — every table entry
        the sentinel (K2 writes nothing, K1 reads nothing) and no row
        live (no count moves) — so that the eager chunk run before each
        capture, which builds the kernels and sets their attributes
        outside it, changes nothing a slot owns.  The launch counts each
        capture records are what its replays add (``recording``)."""
        t0 = time.monotonic()
        b = self._buf
        b.tables.fill_(self._sentinel)
        b.meta.zero_()
        b.tokens.zero_()
        b.cols.copy_(torch.from_numpy(
            np.repeat(_NEUTRAL[:, None], self.n_slots, axis=1)))
        b.noise.zero_()
        pool = torch.cuda.graph_pool_handle()
        side = torch.cuda.Stream(self.device)
        graphs, counts = {}, {}
        for key in _GRAPH_KEYS:
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._run_chunk(key)
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with paged_attention.recording() as delta, torch.cuda.graph(
                    graph, pool=pool, capture_error_mode="thread_local"):
                self._run_chunk(key)
            graphs[key], counts[key] = graph, delta
        torch.cuda.synchronize(self.device)
        self._graphs, self._graph_counts = graphs, counts
        self.graph_capture_seconds = time.monotonic() - t0

    def _enqueue_chunk(self, inputs: _ChunkInputs, tokens, starts, indices,
                       graph: bool):
        """Stage one chunk's inputs into the device buffers (``tokens``
        None: keep the device-side carry), fill its noise, run it — by
        its graph's replay or eagerly — and queue the copy of its
        results to host buffers.  Returns (host out, host lps, the event
        that marks them done or None on the CPU).  Nothing here waits
        for the device."""
        b = self._buf
        turn = b.turn
        b.turn ^= 1
        if b.staged[turn] is not None:
            b.staged[turn].synchronize()  # its last copies are done
        stage = b.stages[turn]
        stage["meta"][0] = torch.from_numpy(starts)
        stage["meta"][1] = torch.from_numpy(inputs.live)
        stage["tables"].copy_(torch.from_numpy(self._tables_host))
        names = ["meta", "tables"]
        if tokens is not None:
            stage["tokens"].copy_(torch.from_numpy(tokens))
            stage["cols"].copy_(torch.from_numpy(inputs.cols))
            names += ["tokens", "cols"]
        for name in names:
            getattr(b, name).copy_(stage[name], non_blocking=True)
        cuda = self.device.type == "cuda"
        if cuda:
            b.staged[turn] = torch.cuda.Event()
            b.staged[turn].record()
        if inputs.key[0]:
            _noise(inputs.seeds, indices, inputs.cols[0] > 0, self.chunk,
                   self.cfg.vocab_size, self.device, out=b.noise)
        if graph:
            self._graphs[inputs.key].replay()
            paged_attention.replay_counts(self._graph_counts[inputs.key])
        else:
            self._run_chunk(inputs.key)
        out, lps = b.results[turn]
        out.copy_(b.out, non_blocking=True)
        lps.copy_(b.lps, non_blocking=True)
        done = None
        if cuda:
            done = torch.cuda.Event()
            done.record()
        return out, lps, done

    def _dispatch_chunk(self, acc: list,
                        chained: _InFlightChunk | None) -> _InFlightChunk:
        """Dispatch one decode chunk over all ``n_slots`` rows; returns
        its in-flight handle without reading anything back.

        Fresh (``chained`` None, always the dispatch after a boundary):
        every input comes from the slots' host states.  Chained: the
        tokens are the previous chunk's device-side carry, the positions
        and sampling keys the previous dispatch's ``+ chunk`` (clamped at
        the cache edge, live rows only), and the live rows and sampling
        columns are reused verbatim — a slot that finished meanwhile
        keeps computing inside its own rows (dense) or into dropped
        writes (paged: its table row is the sentinel by now) and is
        skipped at readback.  The table is the current one either way."""
        with self._lock:
            slots = dict(self._slots)
        t0 = time.monotonic()
        if chained is None:
            if self.cuda_graphs and self._graphs is None:
                self._capture_graphs()
            inputs, tokens, starts, indices = self._fresh_inputs(slots)
        else:
            inputs, tokens = chained.inputs, None
            starts = np.minimum(
                chained.starts + self.chunk * inputs.live, self.max_len - 1
            ).astype(np.int32)
            indices = chained.indices + self.chunk
        out, lps, done = self._enqueue_chunk(
            inputs, tokens, starts, indices, graph=self.cuda_graphs
        )
        self._mark_dispatch(t0, acc)
        if not self._warming:
            self.decode_passes += self.chunk
            self.decode_dispatches += 1
            self.graph_replays += int(self.cuda_graphs)
        return _InFlightChunk(
            snapshot=slots, inputs=inputs, starts=starts, indices=indices,
            out=out, lps=lps, done=done, t_dispatch=t0,
        )

    def _mark_dispatch(self, t0: float, acc: list) -> None:
        """Close one dispatch window: its wall is dispatch time, and an
        open device-idle window ends at ``t0``."""
        acc[1] += time.monotonic() - t0
        if self._t_device_free is not None:
            if not self._warming:
                self.device_idle_seconds += max(
                    0.0, t0 - self._t_device_free)
            self._t_device_free = None

    def _process_chunk(self, handle: _InFlightChunk, acc: list) -> None:
        """Wait for one dispatched chunk's results (its event only, not
        the chunk dispatched behind it) and emit them with EOS, stop and
        budget truncation."""
        overlapped = self._inflight is not None
        t0 = time.monotonic()
        if handle.done is not None:
            handle.done.synchronize()
        out = handle.out.numpy()
        lps = handle.lps.numpy()
        t1 = time.monotonic()
        acc[0] += t1 - t0
        if overlapped:
            acc[2] += t1 - t0
        else:
            self._t_device_free = t1
        emitted = 0
        with self._lock:
            for slot, state in handle.snapshot.items():
                if self._slots.get(slot) is not state:
                    continue  # finished, failed or aborted meanwhile
                state.length = min(state.length + self.chunk,
                                   self.max_len - 1)
                for i in range(self.chunk):
                    emitted += 1
                    if self._emit(state, int(out[slot, i]),
                                  float(lps[slot, i])):
                        self._finish_locked(slot, state)
                        break
            if not self._warming:
                self.readbacks += 1
                start = handle.t_dispatch
                if self._t_last_chunk_done is not None:
                    start = max(start, self._t_last_chunk_done)
                self.decode_seconds += t1 - start
                self.decode_tokens += emitted
        self._t_last_chunk_done = t1

    @torch.no_grad()
    def chunk_twice(self) -> list[dict]:
        """For checks on the card: one decode chunk for the seated slots
        (as a fresh dispatch would make it), run from the same state
        twice — eagerly, then by its graph's replay — returning what each
        left: ``out``, ``lps``, the token carry, the cache and the
        penalty counts, as tensors.  Needs the graphs and no chunk in
        flight; afterwards the cache and counts are as they were before
        either run."""
        if self._graphs is None or self._inflight is not None:
            raise RuntimeError("chunk_twice needs captured graphs and no "
                               "chunk in flight")
        with self._lock:
            slots = dict(self._slots)
        inputs, tokens, starts, indices = self._fresh_inputs(slots)
        cache = self._cache
        state = [t for t in (cache.k, cache.v, cache.k_scale, cache.v_scale,
                             self._tok_counts, self._gen_counts)
                 if t is not None]
        saved = [t.clone() for t in state]
        runs = []
        for graph in (False, True):
            for t, s in zip(state, saved):
                t.copy_(s)
            _, _, done = self._enqueue_chunk(inputs, tokens, starts,
                                             indices, graph)
            if done is not None:
                done.synchronize()
            b = self._buf
            runs.append({"out": b.out.clone(), "lps": b.lps.clone(),
                         "carry": b.tokens.clone(),
                         "state": [t.clone() for t in state]})
        for t, s in zip(state, saved):
            t.copy_(s)
        return runs
