"""Continuous-batching inference engine over the paged KV pool.

The counterpart of ``oim_tpu/serve/engine.py`` on its paged path:

- **Paged cache.**  One global pool of fixed-size blocks
  ``[n_layers, n_blocks, block_size, kv_heads, head_dim]`` (``PagedCache``)
  plus a host-side allocator and per-slot block table; sentinel entries
  (``n_blocks``) mark unallocated blocks.  An admission reserves its
  worst case (bucketed prompt vs prompt + budget), block-rounded and
  all-or-nothing: a pool that cannot cover the head of the queue leaves
  it queued.
- **Attention in the Hopper kernels.**  Every layer of every admission
  and decode step stores the new K/V rows into the pool and attends
  straight off it through ``paged_flash_prefill`` — kernel K2 (store,
  fused int8 quant) then kernel K1 (flash decode) on the GPU, their
  plain versions on the CPU.
- **Continuous batching, chunked decode.**  Admissions are prefilled in
  one dispatch per prompt bucket; active slots advance ``chunk`` tokens
  per dispatch with one host readback per chunk.  EOS lags by at most
  one chunk (bounded waste, never wrong tokens: the host truncates).
- **Exactness.**  Each slot attends only its own positions and each
  sampled token draws noise keyed by ``(request seed, token index)``
  (``models/decode.py``), so results never depend on the slot, the
  batch or the chunk size: greedy streams equal the solo ``generate``
  and the reference's, sampled streams the port's solo ``generate``.

The engine is host-side Python driving eager PyTorch; it runs serially
(pipeline depth 1).  Features of the reference engine this slice does
not port are refused at construction or submission with the ROADMAP
item that will bring them.
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
    _validate_truncation,
    apply_penalties,
    nucleus_min_p_mask,
    sampling_noise,
    truncate_logits,
)
from oim_tpu_torch.models.transformer import (
    TransformerConfig,
    _dense_mlp,
    _qkv,
    _rmsnorm,
    _unembed,
    embed_lookup,
    require_dense,
)
from oim_tpu_torch.models.weights import n_params, to_device
from oim_tpu_torch.ops import paged_attention
from oim_tpu_torch.ops.paged_attention import (
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
# Cache and allocator


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


def _slot_attention(x, lp, cache: PagedCache, layer: int, starts, tables,
                    cfg: TransformerConfig):
    """Cached attention for rows at per-slot positions through the paged
    pool: x [B, t, D]; starts [B] int32 (row b's token i sits at
    ``starts[b] + i``); tables [B, n_tables] int32.  The new K/V rows
    land in the pool in place (sentinel entries drop) and the rows
    attend off the updated pool — one kernel pair per layer, for a
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


def _hidden_slots(params, tokens, cache: PagedCache, starts, tables,
                  cfg: TransformerConfig):
    """tokens [B, t] at per-slot positions ``starts`` → final-norm hidden
    states [B, t, D], extending the pool in place (a Python loop over
    layers; no unembedding, so prefill unembeds one position per row).
    The Pallas switch is off here, as in the reference's engine: serving
    normalizes with the plain formula."""
    cfg = replace(cfg, use_pallas=False)
    x = embed_lookup(params["wte"], tokens, cfg)
    for layer, lp in enumerate(params["layers"]):
        x = _slot_attention(x, lp, cache, layer, starts, tables, cfg)
        x = _dense_mlp(x, lp, cfg)
    return _rmsnorm(x, params["final_norm"], cfg)


@dataclass
class _Sampling:
    """Per-row sampling inputs of one dispatch: device tensors [S] plus
    the host-side facts that decide which work runs at all (no device
    sync on the decision)."""

    temps: torch.Tensor
    top_ps: torch.Tensor
    min_ps: torch.Tensor
    reps: torch.Tensor
    press: torch.Tensor
    freqs: torch.Tensor
    seeds: list[int]
    bases: list[int]  # sample_base: the offset of every noise index
    sampled: list[bool]  # temperature > 0, per row
    truncate_p: bool  # some row has top_p < 1 or min_p > 0

    @classmethod
    def build(cls, reqs, default_top_p: float, device) -> "_Sampling":
        def col(values):
            return torch.tensor(values, dtype=torch.float32, device=device)

        top_ps = [default_top_p if r.top_p is None else r.top_p for r in reqs]
        min_ps = [r.min_p for r in reqs]
        return cls(
            temps=col([r.temperature for r in reqs]),
            top_ps=col(top_ps),
            min_ps=col(min_ps),
            reps=col([r.repetition_penalty for r in reqs]),
            press=col([r.presence_penalty for r in reqs]),
            freqs=col([r.frequency_penalty for r in reqs]),
            seeds=[r.seed for r in reqs],
            bases=[r.sample_base for r in reqs],
            sampled=[r.temperature > 0.0 for r in reqs],
            truncate_p=any(p < 1.0 for p in top_ps) or any(
                m > 0.0 for m in min_ps
            ),
        )

    def noise(self, indices, vocab: int, device):
        """Gumbel noise [S, V] for token ``indices[r]`` of each sampled
        row, counted from its request's ``sample_base`` (zeros for greedy
        rows), or None when every row is greedy."""
        if not any(self.sampled):
            return None
        noise = torch.zeros(
            (len(self.seeds), vocab), dtype=torch.float32, device=device
        )
        for r, (seed, base, index) in enumerate(
                zip(self.seeds, self.bases, indices)):
            if self.sampled[r]:
                noise[r] = sampling_noise(seed, base + index, vocab, device)
        return noise


def _sample_batched(logits, s: _Sampling, noise, top_k: int, counts):
    """Per-row sampling over f32 logits [S, V]: greedy where temperature
    is 0, else the Gumbel-max draw over the temperature-scaled logits
    truncated by the engine-static top-k and the per-row top-p/min-p.
    ``counts`` = (tok_counts, gen_counts) [S, V] feed the penalties,
    applied first (neutral rows are exact no-ops).  Returns ``(tokens [S] int64,
    logprobs [S])`` — the logprob under the penalty-adjusted,
    temperature-1, untruncated distribution."""
    logits = apply_penalties(
        logits, counts[0], counts[1], s.reps, s.press, s.freqs
    )
    tokens = torch.argmax(logits, dim=-1)
    if noise is not None:
        scaled = truncate_logits(
            logits / torch.clamp_min(s.temps, 1e-6)[:, None], top_k
        )
        if s.truncate_p:
            scaled = nucleus_min_p_mask(scaled, s.top_ps, s.min_ps)
        sampled = torch.argmax(scaled + noise, dim=-1)
        tokens = torch.where(s.temps > 0, sampled, tokens)
    chosen = torch.gather(logits, 1, tokens[:, None])[:, 0]
    return tokens, chosen - torch.logsumexp(logits, dim=-1)


def _admit_batch(params, cache: PagedCache, row_tables, prompts, starts,
                 true_tails, s: _Sampling, cfg: TransformerConfig,
                 top_k: int, counts):
    """Prefill a group of admissions sharing a prompt bucket in one
    dispatch and sample each one's first token.  prompts [S, bucket]
    (each row's prompt, zero-padded); starts [S] int32; true_tails [S]
    valid lengths; row_tables [S, n_tables] int32.  The first token is
    each request's token 0 (its sampling key, offset by its
    ``sample_base``).  Padding positions past a row's true length are
    written into its own reserved blocks and masked until decode
    overwrites them.  Returns (tokens [S], logprobs [S])."""
    x = _hidden_slots(params, prompts, cache, starts, row_tables, cfg)
    rows = torch.arange(x.shape[0], device=x.device)
    last = x[rows, true_tails.long() - 1]
    logits = _unembed(last, params["wlm"], cfg)
    noise = s.noise([0] * x.shape[0], cfg.vocab_size, x.device)
    return _sample_batched(logits, s, noise, top_k, counts)


def _decode_chunk(params, cache: PagedCache, tables, tokens, starts,
                  s: _Sampling, indices, cfg: TransformerConfig, *,
                  chunk: int, top_k: int, max_len: int, counts):
    """Advance every row ``chunk`` tokens: tokens [S] (each row's latest
    token), starts [S] int32 (where it is written), indices [S] the
    emission index of the step's token (the sampling key, which
    ``s.noise`` offsets by each request's ``sample_base``).
    ``counts`` (tok_counts, gen_counts) [S, V] are updated in place.
    Returns (tokens [S, chunk], logprobs [S, chunk]) on the device; a
    row past its budget keeps computing and its position clamps at the
    cache edge (the host truncates)."""
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    outs, lps = [], []
    for i in range(chunk):
        x = _hidden_slots(params, tokens[:, None], cache, starts, tables, cfg)
        logits = _unembed(x[:, -1], params["wlm"], cfg)
        noise = s.noise([n + i for n in indices], cfg.vocab_size, x.device)
        nxt, lp = _sample_batched(logits, s, noise, top_k, counts)
        counts[0][rows, nxt] += 1
        counts[1][rows, nxt] += 1
        starts = torch.clamp_max(starts + 1, max_len - 1)
        tokens = nxt
        outs.append(nxt)
        lps.append(lp)
    return torch.stack(outs, dim=1), torch.stack(lps, dim=1)


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
    versions."""

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
        max_queue: int = 0,
        prefill_chunk: int = 0,
        pipeline_depth: int = 1,
        kv_block: int = 16,
        kv_blocks: int = 0,
        kv_host_bytes: int = 0,
        qos=None,
        device=None,
    ):
        self.device = resolve_device(device)
        require_dense(cfg)
        if kv_block <= 0:
            raise _not_ported(
                "the dense SlotCache (kv_block=0)", "dense SlotCache"
            )
        if kv_int4:
            raise _not_ported("kv_int4", "kv_int4 with packed nibbles")
        if prefix_cache_size:
            raise _not_ported("the prefix cache", "prefix cache/CoW")
        if spec_decode:
            raise _not_ported("spec_decode", "spec decode")
        if prefill_chunk:
            raise _not_ported("prefill_chunk", "prefill_chunk segments")
        if pipeline_depth != 1:
            raise _not_ported(
                f"pipeline_depth={pipeline_depth}", "pipeline depth 2"
            )
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
        if max_len % kv_block:
            raise ValueError(
                f"kv_block={kv_block} must divide max_len={max_len} "
                f"(the block table covers the region exactly)"
            )
        if self.device.type == "cuda" and not supported_block_size(
                kv_block, cfg.head_dim):
            # Fail here, with the constraint named, rather than in the
            # first launch on the step thread.
            raise ValueError(
                f"the paged-attention kernels need head_dim in (64, 128) "
                f"and kv_block in [1, 64]; got head_dim={cfg.head_dim}, "
                f"kv_block={kv_block}"
            )
        if kv_blocks < 0:
            raise ValueError(f"need kv_blocks >= 0, got {kv_blocks}")
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
        self.max_queue = max_queue
        self.kv_block = kv_block
        self._n_tables = max_len // kv_block
        self.kv_blocks = kv_blocks or n_slots * self._n_tables
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
        self._cache = PagedCache.create(
            cfg, self.kv_blocks, kv_block, quantized=kv_int8,
            device=self.device,
        )
        self._alloc = BlockAllocator(self.kv_blocks)
        self._tables_host = np.full(
            (n_slots, self._n_tables), self.kv_blocks, np.int32
        )
        # Per-slot token counts for the penalties: prompt + generated,
        # and generated only.
        self._tok_counts = torch.zeros(
            (n_slots, cfg.vocab_size), dtype=torch.int32, device=self.device
        )
        self._gen_counts = torch.zeros_like(self._tok_counts)
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
        self.decode_seconds = 0.0
        self.decode_tokens = 0
        # Forward passes through the layer stack: one per admission
        # group and one per decode step (each runs both kernels once
        # per layer).
        self.prefill_dispatches = 0
        self.decode_passes = 0
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
        their slots and blocks (the crash path of ``step``)."""
        with self._lock:
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
        """Stop admitting; queued and active requests run to the end."""
        with self._lock:
            self._draining = True

    def in_flight(self) -> int:
        with self._lock:
            return len(self._queue) + len(self._admitting) + len(self._slots)

    def pending(self) -> bool:
        with self._lock:
            return bool(self._queue or self._slots)

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
                "penalties": True,
                "pipeline_depth": 1,
                "paged": True,
                "kv_block": self.kv_block,
                "kv_blocks": self.kv_blocks,
                "device": str(self.device),
                "attention": (
                    "cuda-kernels" if self.device.type == "cuda" else "plain"
                ),
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
                "kv_blocks_free": self._alloc.free_blocks,
                "kv_blocks_used": self._alloc.used_blocks,
                "kv_admit_deferrals": self.kv_admit_deferrals,
                "kv_quant": "int8" if self.kv_int8 else "",
                # Host clock around work that ends in a device readback,
                # so these are device-inclusive walls.
                "prefill_seconds": self.prefill_seconds,
                "decode_seconds": self.decode_seconds,
                "decode_tokens": self.decode_tokens,
                "prefill_dispatches": self.prefill_dispatches,
                "decode_passes": self.decode_passes,
                "ttft_p50_s": statistics.median(ttfts) if ttfts else 0.0,
                "kernel_counts": paged_attention.counters(),
                "fatal": self._fatal,
            }

    # -- engine loop (one step thread) --------------------------------------

    def step(self) -> None:
        """Reap, admit whatever fits, then decode one chunk for the
        active slots.  A crash latches the engine and fails every
        waiter before re-raising."""
        try:
            self._reap()
            self._admit_wave()
            with self._lock:
                active = bool(self._slots)
            if active:
                self._decode_round()
            if not self._warming:
                self.steps += 1
        except Exception as exc:
            message = f"engine step failed: {type(exc).__name__}: {exc}"
            with self._lock:
                if self._fatal is None:
                    self._fatal = message
            self.abort(message)
            raise

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
        shape once before live traffic."""
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
        finally:
            self._warming = False
        return self

    def _release_slot_locked(self, slot: int) -> None:
        """Return ``slot`` and its blocks, and reset its table row to the
        sentinel (lock held)."""
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
        before they touch a slot, active ones at this chunk boundary."""
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
    def _admit_wave(self) -> None:
        """Admit whatever fits into free slots: reserve each request's
        worst case from the pool (head-of-line: a shortage leaves it
        queued), then prefill one dispatch per prompt bucket and read
        every first token back at once."""
        with self._lock:
            admissions = []
            while self._queue and self._free:
                rid, req, t_submit = self._queue[0]
                blocks = self._alloc.alloc(self._pool_blocks_needed(
                    len(req.tokens), req.max_new_tokens
                ))
                if blocks is None:
                    if not self._warming:
                        self.kv_admit_deferrals += 1
                    break
                self._queue.popleft()
                slot = self._free.pop(0)
                self._tables_host[slot, : len(blocks)] = blocks
                self._admitting[rid] = slot
                admissions.append((slot, rid, req, t_submit))
        if not admissions:
            return
        t0 = time.monotonic()
        dev = self.device
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
            s = _Sampling.build(reqs, self.default_top_p, dev)
            prompt_counts = torch.from_numpy(np.stack([
                np.bincount(req.tokens, minlength=self.cfg.vocab_size)
                for req in reqs
            ]).astype(np.int32)).to(dev)
            counts = (prompt_counts, torch.zeros_like(prompt_counts))
            tokens, lps = _admit_batch(
                self.params, self._cache,
                torch.from_numpy(self._tables_host[slot_ids]).to(dev),
                torch.from_numpy(prompts).to(dev),
                torch.zeros(len(rows), dtype=torch.int32, device=dev),
                torch.tensor([len(r.tokens) for r in reqs], device=dev),
                s, self.cfg, self.top_k, counts,
            )
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

    @torch.no_grad()
    def _decode_round(self) -> None:
        """Decode one chunk for every active slot (one dispatch, one
        readback), then emit with EOS/stop/budget truncation."""
        with self._lock:
            snapshot = sorted(self._slots.items())
        dev = self.device
        slot_ids = [slot for slot, _ in snapshot]
        states = [state for _, state in snapshot]
        reqs = [state.req for state in states]
        s = _Sampling.build(reqs, self.default_top_p, dev)
        idx = torch.tensor(slot_ids, device=dev)
        counts = (self._tok_counts[idx], self._gen_counts[idx])
        t0 = time.monotonic()
        out, lps = _decode_chunk(
            self.params, self._cache,
            torch.from_numpy(self._tables_host[slot_ids]).to(dev),
            torch.tensor([st.last_token for st in states], device=dev),
            torch.tensor([st.length for st in states], dtype=torch.int32,
                         device=dev),
            s,
            [len(st.emitted) for st in states],
            self.cfg, chunk=self.chunk, top_k=self.top_k,
            max_len=self.max_len, counts=counts,
        )
        self._tok_counts[idx] = counts[0]
        self._gen_counts[idx] = counts[1]
        out_host = out.cpu().numpy()
        lps_host = lps.cpu().numpy()
        emitted = 0
        with self._lock:
            for r, (slot, state) in enumerate(snapshot):
                state.length = min(state.length + self.chunk,
                                   self.max_len - 1)
                if self._slots.get(slot) is not state:
                    continue  # failed by abort/reap meanwhile
                for i in range(self.chunk):
                    emitted += 1
                    if self._emit(state, int(out_host[r, i]),
                                  float(lps_host[r, i])):
                        self._finish_locked(slot, state)
                        break
            if not self._warming:
                self.decode_seconds += time.monotonic() - t0
                self.decode_tokens += emitted
                self.decode_passes += self.chunk
