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
  fused int8 or packed int4 quant) then kernel K1 (flash decode) on the
  GPU, their plain versions on the CPU.  ``paged_kernel`` (every decode
  pass: decode chunks, a verify's rows, the draft's decode) and
  ``prefill_kernel`` (admissions and prompt segments) are the
  reference's A/B switch: None (auto) runs the kernels where the engine
  runs on the card, True the kernel wrappers anywhere, False the plain
  versions (``paged_kv_store_plain``, ``paged_flash_decode_plain``) on
  whatever device the engine runs on — graphed on the card too.  Unlike
  the reference's, the switch applies to the dense cache as well, whose
  regions the kernels read as blocks.  Weight-quantized params (int8
  or packed int4, ``ops/quant.py``) are read through
  ``ops/wquant.py::quant_matmul`` (``models/transformer.py::linear``).
- **Continuous batching, chunked decode, a two-deep pipeline.**
  Admissions are prefilled in one dispatch per prompt bucket; every
  slot's row advances ``chunk`` tokens per decode dispatch with one
  readback per chunk.  At ``pipeline_depth=2`` (the default) chunk N+1
  is dispatched before chunk N is read back: it takes its tokens from
  chunk N's device-side carry, and its positions and sampling keys from
  the host, ``chunk`` further on.  Admissions join at pipeline
  boundaries.  EOS lags by at most one chunk (two at depth 2): bounded
  waste, never wrong tokens, since the host truncates.
- **A prefix cache and chunked prefill.**  ``prefix_cache_size`` keeps
  the prompt KV of requests marked ``cache_prefix`` (LRU): a later
  prompt sharing one starts its prefill at the shared length — on the
  dense layout from a copy of the entry's rows, on the paged pool by
  aliasing the entry's full blocks (refcounts) and copying the one
  block a hit ends inside (copy-on-write).  ``prefill_chunk`` writes a
  long prompt's KV in segments of that many tokens, one a wave, so
  decode chunks of the live slots run between them.  A row that is not
  live in a decode chunk reads and writes no KV (its table row is the
  sentinel), so a pending prefill's rows and a shared block stay as
  they were.
- **Decode chunks and admissions as CUDA graphs.**  On the GPU a decode
  chunk — its ``chunk`` passes through every layer and the sampling — is
  one ``torch.cuda.CUDAGraph`` replay over inputs and outputs at fixed
  device addresses, fed from and read into pinned host buffers without
  a synchronising copy.  So is each admission dispatch (the reference
  compiles its admission once per prompt bucket): a group sharing a
  bucket is padded to a row class — a power of two up to ``n_slots`` —
  with inert rows (the sentinel table row, start 0, tail 1), split into
  several dispatches past ``ADMIT_TOKENS`` tokens, and its prefill up to
  the last real position's logits replays the (bucket, class) graph;
  the first tokens are sampled eagerly from those logits.  A segment of
  a chunked prefill replays the (``prefill_chunk``, 1) graph.  Every
  graph is captured at warmup; the eager route (``cuda_graphs=False``,
  and the CPU) pads the same way, so it runs the same shapes.
- **Speculative decoding.**  ``spec_decode = L`` drafts L tokens a slot
  each decode step — by prompt lookup over a device-side token history,
  or from a small draft model with its own dense cache — and verifies
  all L+1 positions in one target forward (K2 then K1 per layer at t =
  L+1), emitting the longest accepted prefix plus the bonus token for
  greedy rows and one token for sampled ones.  A chunk's rows advance by
  counts only the device knows, so a chained dispatch takes positions,
  like tokens, from the chunk before it, and the host learns each row's
  advance from ``n_emit`` at readback.  Its chunks and the draft's
  prefill are graph replays too.
- **KV blocks leave the pool and come back.**  With ``kv_host_bytes``
  a pinned host pool of the device pool's layout takes prefix entries
  that would be evicted (demotion) and hands them back on a later hit
  (promotion), and an admission that cannot fit parks the coldest
  slot's blocks there and restores them, exactly, when blocks free.
  ``hold_kv``/``export_kv``/``import_kv``/``kv_import``,
  ``export_kv_prefix``/``import_kv_prefix`` and
  ``begin_migrate_out``/``export_slot``/``import_slot`` ship held KV,
  prefix entries and live slots on the reference's wire
  (``serve/disagg.py``).  Blocks go down as one gather a leaf and a
  non-blocking copy into pinned memory, and come up as one copy a leaf
  and one scatter, all on the stream every replay runs on, so stream
  order does what the reference's XLA order does; a restored, imported
  or promoted slot admits through the prefix-hit route's graphs.
- **Tenants and overload.**  Under a QoS policy (``qos``,
  ``set_qos_policy``) admission is weighted fair share by stride
  scheduling over tenants' virtual times, and a higher tier's head with
  no free slot parks a strictly lower tier's slot (the host tier's
  parking) and admits; premium prefix entries demote last.  Brownout
  clamps budgets under sustained queue pressure, and ``retry_after_s``
  estimates when the backlog drains.
- **Request observation.**  Each request keeps a phase clock on host
  instants the step loop already takes (queue, admit, prefill, one
  record a decode chunk, stream); at its end it becomes an
  ``engine.request`` span tree under the caller's ``span``, an entry of
  the completed-request ring (``requests``), per-tenant histograms and,
  when slow, a capture in the flight dir.  ``load()`` is the live
  pressure snapshot and ``watchdog_state()`` the step thread's current
  device wait beside the typical chunk wall.  None of it reads the
  device.
- **Slot-free work.**  ``embed`` and ``beam`` run the plain solo path
  (``models/decode.py::embed_tokens``, ``models/beam.py``) on the
  caller's thread, refused while draining.
- **Exactness.**  Each slot attends only its own positions and each
  sampled token draws noise keyed by ``(request seed, token index)``
  (``models/decode.py``), so results never depend on the slot, the
  batch, the chunk size, the pipeline depth or speculation: greedy
  streams equal the solo ``generate`` and the reference's, sampled
  streams the port's solo ``generate``.

- **Recompile sentinel.**  ``warmup`` runs inside the sentinel's
  warmup bracket and arms the engine at its end
  (``serve/sentinel.py``); every graph capture reports its wall time
  there, and a capture after warmup adds to ``recompiles`` with the
  request context the step thread keeps in ``_sentinel_ctx``.

- **Tensor- and expert-parallel serving.**  ``mesh=`` (a
  ``parallel/mesh.py::Mesh`` over ``tp`` and, for MoE, ``ep``; one
  process a device) shards the params by their logical axes
  (``models/weights.py::shard_params``) and the cache over kv heads, and
  each rank runs its shard under a ``ShardedConfig`` whose layers call
  the collectives (``models/transformer.py``).  Rank 0 is the engine
  callers see: it owns the queue, the slots, the scheduler and every
  host decision.  Each device dispatch it makes — an admission, a first
  token's sampling, a prompt segment, a decode chunk, a draft prefill, a
  prefix copy, the graph capture — is first sent as a record of its
  staged host inputs over the mesh's gloo ``control`` group, and every
  other rank runs the same dispatch on its shard (``follow``), by replay
  or eagerly; a follower's decode path reads nothing back.  The logits
  every rank sees after the collectives are bitwise the same, and
  sampling noise is keyed by (seed, token index), so the tokens a chunk
  feeds back on the device stay in lockstep without a broadcast a
  token.  On NCCL the collectives are captured inside the graphs; gloo
  cannot be captured, so a gloo mesh on the card runs eagerly
  (``cuda_graphs=False``).
- **Block I/O, weights, beam and embed under a mesh.**  Everything that
  moves KV blocks or runs slot-free work is a record too, from whichever
  thread starts it (``_MeshLink.turn``: a record and the leader's own
  half, atomically).  Each rank keeps its kv-head slice: a demotion or
  park copies the same block ids down into the rank's own host tier at
  the leader's host block ids, a promotion, restore or landing writes
  them back (``_restore_parked`` rebuilds the replicated history and
  penalty rows on every rank).  Exports gather the ranks' slices to rank
  0, which joins them on the kv-head axis (``_export_payload``); imports
  cut the whole heads and scatter the parts (``_stage_payload``), staged
  under a tag until the blocks are written — so the wire stays the
  reference's, and a mesh, one device and the reference engine ship to
  one another.  ``GET /v1/weights`` gathers each tensor whole
  (``weight_leaves``); ``beam`` and ``embed`` run the solo pass on every
  shard.  Counters and the host tier's budget count whole blocks.
"""

from __future__ import annotations

import copy
import itertools
import json
import math
import os
import statistics
import threading
import time
from collections import OrderedDict, deque
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field, replace

import numpy as np
import torch
import torch.distributed as dist

from oim_tpu_torch.common import events as _events
from oim_tpu_torch.common import metrics as _metrics
from oim_tpu_torch.common import tracing as _tracing
from oim_tpu_torch.models.beam import (
    beam_steps,
    best_hypothesis,
    make_beam_search_fn,
)
from oim_tpu_torch.models.decode import (
    _mlp,
    _validate_truncation,
    apply_penalties,
    embed_tokens,
    nucleus_min_p_mask,
    sampling_noise,
    truncate_logits,
)
from oim_tpu_torch.models.transformer import (
    TransformerConfig,
    _qkv,
    _rmsnorm,
    embed_lookup,
    row_linear,
    unembed,
)
from oim_tpu_torch.models.weights import (
    gather_leaf,
    jax_leaves,
    n_params,
    param_shapes,
    rank_config,
    shard_params,
    specs_of,
    to_device,
    whole_meta,
)
from oim_tpu_torch.ops import counts as kernel_counts
from oim_tpu_torch.ops import paged_attention
from oim_tpu_torch.ops.paged import copy_block, read_blocks, write_blocks
from oim_tpu_torch.ops.paged_attention import (
    MAX_BLOCK_SIZE,
    paged_flash_decode_plain,
    paged_flash_prefill,
    paged_kv_store_plain,
    supported_block_size,
)
from oim_tpu_torch.ops.quant import make_kv_buffers, weight_quant_mode
from oim_tpu_torch.ops.rope import apply_rope
from oim_tpu_torch.qos.policy import DEFAULT_POLICY as _QOS_DEFAULT
from oim_tpu_torch.qos.policy import TIER_PRIORITY as _QOS_TIER_PRIORITY
from oim_tpu_torch.serve import sentinel as _sentinel
from oim_tpu_torch.serve.disagg import (
    KV_HOLD_MAX,
    KV_HOLD_TTL_S,
    KV_IMPORT_MAX,
    KV_IMPORT_TTL_S,
    MIGRATE_TTL_S,
    PREFIX_DIGEST_CAP,
    PREFIX_IMPORT_MAX,
    PREFIX_IMPORT_TTL_S,
    KvCapacityError,
    KvGeometryError,
    KvHold,
    KvImport,
    KvIneligibleError,
    SlotRecord,
    build_manifest,
    dtype_name,
    leaf_table,
    prefix_digest,
    validate_geometry,
)


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


# Beam search's bounds on client-chosen state (``Engine.beam``): the beam
# width (the cache replicates across the beams), the search functions
# kept, one per (beam_size, alpha, eos_id), and the (configuration,
# prompt length, max_new) shapes seen before both are cleared.
_MAX_BEAM_SIZE = 32
_MAX_BEAM_PROGRAMS = 8
_MAX_BEAM_TRACES = 64


# Tenant accounting rows kept before the least recently touched goes
# (advisory accounting must not become a cardinality leak).
_MAX_TENANT_ROWS = 256


# ---------------------------------------------------------------------------
# Caches and allocator


@dataclass
class PagedCache:
    """Paged KV pool: ``k``/``v`` [n_layers, n_blocks, block_size,
    kv_heads, head_dim] (packed int4: ``torch.uint8`` of head_dim / 2
    bytes); ``k_scale``/``v_scale`` [n_layers, n_blocks, block_size,
    kv_heads] f32 for int8 and int4 payloads, else None.  Which
    blocks belong to which slot lives outside, in the engine's block
    table.  The kernels write into these tensors in place."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @classmethod
    def create(cls, cfg: TransformerConfig, n_blocks: int, block_size: int,
               quantized: bool | str = False, device=None) -> "PagedCache":
        """``quantized``: falsy, truthy or "int8" (int8), or "int4"
        (packed int4, ``ops/quant.py::make_kv_buffers``)."""
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

    def leaves(self) -> list[tuple[str, torch.Tensor]]:
        """(leaf name, pool) pairs, the scale planes included when the
        pool has them: the one leaf order every block movement shares."""
        out = [("k", self.k), ("v", self.v)]
        if self.k_scale is not None:
            out += [("k_scale", self.k_scale), ("v_scale", self.v_scale)]
        return out


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
    (a shortage is queue backpressure, never a partial slot).  A prefix
    entry and every slot aliasing it each hold one ref on the shared
    blocks; the last ``decref`` frees a block, so a shared block (ref >
    1) is never on the free list.  Copy-on-write is the engine's."""

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

    @property
    def shared_blocks(self) -> int:
        """Blocks with more than one owner."""
        return int(np.sum(self._refs > 1))

    def exclusive(self, ids) -> int:
        """How many of ``ids`` have exactly one owner: what one decref
        of them would return to the pool."""
        return int(sum(1 for b in ids if self._refs[b] == 1))

    def incref(self, ids) -> None:
        for b in ids:
            if self._refs[b] <= 0:
                raise ValueError(f"incref of free block {b}")
            self._refs[b] += 1

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


class HostBlockPool:
    """The host-RAM tier of the paged pool: one host tensor per pool leaf
    of the device pool's layout ``[n_layers, n_blocks, block_size, ...]``
    (a packed int4 pool's ``uint8`` bytes and the f32 scale planes
    included), allocated once, pinned on the GPU, plus its own
    refcounted allocator.  A block's bytes here are a copy of the device
    block's, so demote then promote, and park then restore, are exact by
    construction.  Its rows are written only by the step thread
    (``Engine._complete_host_writes``) into blocks a pending write owns,
    and its allocator is used under the engine's lock."""

    def __init__(self, cache: PagedCache, n_blocks: int, pin: bool):
        if n_blocks < 1:
            raise ValueError(f"need n_blocks >= 1, got {n_blocks}")
        self._leaves = [
            (name, torch.zeros((pool.shape[0], n_blocks, *pool.shape[2:]),
                               dtype=pool.dtype, pin_memory=pin))
            for name, pool in cache.leaves()
        ]
        self.alloc = BlockAllocator(n_blocks)

    @property
    def n_blocks(self) -> int:
        return self._leaves[0][1].shape[1]

    def pools(self) -> list[tuple[str, torch.Tensor]]:
        """(leaf name, host tensor) pairs in ``PagedCache.leaves``'
        order."""
        return list(self._leaves)

    def gather(self, blocks, pin: bool) -> list[torch.Tensor]:
        """Host blocks ``blocks`` of every leaf as new tensors [n_layers,
        N, ...] (pinned when ``pin``, so a copy to the device from them
        does not wait for it)."""
        idx = torch.as_tensor(list(blocks), dtype=torch.int64)
        out = []
        for _, pool in self._leaves:
            rows = torch.empty((pool.shape[0], len(idx), *pool.shape[2:]),
                               dtype=pool.dtype, pin_memory=pin)
            out.append(torch.index_select(pool, 1, idx, out=rows))
        return out


@dataclass
class _HostWrite:
    """One dispatched demotion: the pinned host tensors its blocks' bytes
    land in (``HostBlockPool.pools``' order), the event that marks the
    copies done (None on the CPU), and where the bytes go in the host
    pool.  ``kind`` "prefix" registers a host prefix entry once done;
    "park" marks the parked slot restorable.  The copies were enqueued
    on the step thread's stream BEFORE the source blocks were decref'd, so
    whatever reuses those blocks is enqueued after them and cannot
    overtake them."""

    kind: str  # "prefix" | "park"
    host_blocks: tuple[int, ...]
    staged: list
    done: object
    key: tuple = ()  # prefix: the covered-token entry key
    rows: int = 0  # prefix: covered rows
    meta: dict | None = None  # prefix: the residency record it carries
    rid: int = -1  # park: the parked request


@dataclass
class _ParkedSlot:
    """A mid-stream request swapped out to the host tier: its host slot
    state and the host blocks holding its KV through the frontier.
    ``ready`` flips when the demotion's copies are done; ``n_live`` is
    the original reservation's block count, which restore re-reserves;
    ``restoring`` is set while ``_unpark_wave`` writes the payload back
    with the lock released (the record stays in ``_parked``, visible to
    cancel, reap, abort and ``in_flight``, and whoever pops it owns the
    host-block decref)."""

    state: "_SlotState"
    host_blocks: tuple[int, ...]
    n_cov: int  # leading blocks that carry live rows (the payload)
    n_live: int  # total blocks the original plan reserved
    rows: int  # valid KV rows (len(prompt) + len(emitted) - 1)
    ready: bool = False
    restoring: bool = False
    t_parked: float = field(default_factory=time.monotonic)


# ---------------------------------------------------------------------------
# Device functions


def _slot_attention(x, lp, cache, layer: int, starts, tables,
                    cfg: TransformerConfig, kernel: bool = True):
    """Cached attention for rows at per-slot positions through the
    cache's pool views: x [B, t, D]; starts [B] int32 (row b's token i
    sits at ``starts[b] + i``); tables [B, n_tables] int32.  The new K/V
    rows land in the cache in place (sentinel entries drop) and the rows
    attend off the updated cache — one kernel pair per layer, for a
    prompt segment and a decode step alike, or with ``kernel`` False
    their plain versions on the same device.  The attention output comes
    back f32 and is cast to the compute dtype before ``wo``, as in the
    reference."""
    b, t, _ = x.shape
    q, k, v = _qkv(x, lp, cfg)
    positions = starts.long()[:, None] + torch.arange(t, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
    k_pool, v_pool, k_scale, v_scale = cache.layer(layer)
    if kernel:
        out, *_ = paged_flash_prefill(
            q, k, v, k_pool, v_pool, k_scale, v_scale, tables, starts,
            window=cfg.sliding_window,
        )
    else:
        paged_kv_store_plain(k, v, k_pool, v_pool, k_scale, v_scale,
                             tables, starts)
        out = paged_flash_decode_plain(
            q, k_pool, v_pool, k_scale, v_scale, tables, starts,
            window=cfg.sliding_window,
        )
    out = out.to(x.dtype).reshape(b, t, cfg.n_heads * cfg.head_dim)
    return x + row_linear(out, lp, "wo", cfg).to(x.dtype)


def _hidden_slots(params, tokens, cache, starts, tables,
                  cfg: TransformerConfig, kernel: bool = True):
    """tokens [B, t] at per-slot positions ``starts`` → final-norm hidden
    states [B, t, D], extending the cache in place (a Python loop over
    layers; no unembedding, so prefill unembeds one position per row).
    MoE layers route every token drop-free (``_moe_exact``), so a row's
    result never depends on its batchmates or its padding.  The Pallas
    switch is off here, as in the reference's engine: serving
    normalizes with the plain formula.  ``kernel`` picks the attention's
    path (``_slot_attention``)."""
    cfg = replace(cfg, use_pallas=False)
    x = embed_lookup(params["wte"], tokens, cfg)
    for layer, lp in enumerate(params["layers"]):
        x = _slot_attention(x, lp, cache, layer, starts, tables, cfg,
                            kernel)
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


def _sampling(req) -> dict:
    """The sampling state a shipped manifest carries for ``req``."""
    return {"seed": req.seed, "temperature": req.temperature,
            "top_p": req.top_p, "min_p": req.min_p}


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


def _admit_logits(params, cache, row_tables, prompts, starts, true_tails,
                  cfg: TransformerConfig, kernel: bool = True):
    """Prefill a group of admissions sharing a prompt bucket in one
    dispatch: prompts [R, bucket] (each row's prompt tail, zero-padded)
    from starts [R] int32, true_tails [R] valid lengths, row_tables [R,
    n_tables] int32.  Padding positions past a row's true length are
    written into the slot's own rows and masked until decode overwrites
    them.  Returns the f32 logits [R, V] of each row's last real
    position, from which its first token is sampled (or nothing, for a
    segment of a chunked prefill)."""
    x = _hidden_slots(params, prompts, cache, starts, row_tables, cfg,
                      kernel)
    rows = torch.arange(x.shape[0], device=x.device)
    last = x[rows, true_tails.long() - 1]
    return unembed(last, params, cfg)


def _decode_chunk(params, cache, tables, tokens, starts, live,
                  s: _Sampling, noise, cfg: TransformerConfig, *,
                  chunk: int, top_k: int, max_len: int, counts,
                  kernel: bool = True):
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
        x = _hidden_slots(params, tokens[:, None], cache, starts, tables, cfg,
                          kernel)
        logits = unembed(x[:, -1], params, cfg)
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


def _draft_lookup(hist, lengths, draft_len: int, ngram: int, max_len: int):
    """Prompt-lookup drafting for every slot at once, with no host sync:
    hist [S, max_len] (each slot's token history, its newest decided
    token just written at position ``lengths``), lengths [S] → drafts
    [S, draft_len], the tokens that followed the most recent earlier
    occurrence of each slot's last ``ngram`` decided tokens.  No match
    drafts zeros: a wrong draft is rejection-safe (the verify emits the
    true token), so it costs acceptance, never a token.

    The most recent match whose continuation lies wholly inside the
    decided region ``[0, length]`` wins: rows past ``length`` hold the
    previous sub-step's rejected drafts, and a slot in a repetition cycle
    that matched at the edge would draft ``[real, stale, stale, ...]``.
    Without such a match (early in a short history), the freshest edge
    match drafts with its undecided positions masked to 0."""
    dev = hist.device
    lengths = lengths.long()[:, None]  # [S, 1]
    steps = torch.arange(ngram, device=dev)
    query_start = lengths - ngram + 1
    query = torch.gather(hist, 1, (query_start + steps).clamp(0, max_len - 1))
    positions = torch.arange(max_len, device=dev)
    idx = (positions[:, None] + steps[None, :]).clamp_max(max_len - 1)
    windows = hist[:, idx]  # [S, max_len, ngram]
    ok = torch.all(windows == query[:, None, :], dim=2) & (query_start >= 0)
    window_end = positions[None, :] + ngram - 1
    none = torch.full_like(ok, -1, dtype=torch.long)
    w_full = torch.where(ok & (window_end + draft_len <= lengths),
                         positions, none).amax(dim=1)
    w_edge = torch.where(ok & (window_end < lengths), positions,
                         none).amax(dim=1)
    w = torch.where(w_full >= 0, w_full, w_edge)[:, None]
    cont = w + ngram + torch.arange(draft_len, device=dev)
    drafts = torch.gather(hist, 1, cont.clamp(0, max_len - 1))
    drafts = torch.where(cont <= lengths, drafts, 0)
    return torch.where(w >= 0, drafts, 0)


def _verify_logits(params, cache, tables, lengths, tokens, drafts,
                   cfg: TransformerConfig, kernel: bool = True):
    """A verify's forward: one (L+1)-row target forward over [tokens,
    drafts] from ``lengths`` (K2 then K1 per layer, each slot's L+1 rows
    at once) → f32 logits [S, L+1, V]."""
    inputs = torch.cat([tokens[:, None], drafts], dim=1)
    x = _hidden_slots(params, inputs, cache, lengths, tables, cfg, kernel)
    return unembed(x, params, cfg)


def _accept(logits, lengths, tokens, drafts, live, s: _Sampling, noise, *,
            top_k: int, max_len: int):
    """A verify's emission from its logits: the longest accepted prefix
    plus the bonus token for greedy rows (``cumprod`` of draft ==
    argmax), exactly one token for sampled rows, drawn from the
    position-0 logits with ``noise`` (the plain chunk's noise of this
    sub-step, keyed by the same token index).  Logprobs as the plain path
    takes them.  Lengths advance by the emitted count, clamped at
    ``max_len - 1 - L`` so that the next verify's L+1 writes stay inside
    the slot's rows.  Returns (lengths, the next tokens, emitted [S,
    L+1], logprobs [S, L+1], n_emit [S])."""
    n_drafts = drafts.shape[1]
    greedy = torch.argmax(logits, dim=-1)
    accepted = torch.cumprod((drafts == greedy[:, :n_drafts]).to(torch.int32),
                             dim=1).sum(dim=1)
    first, first_lp = _sample_batched(logits[:, 0], s, noise, top_k, None)
    emitted = torch.cat([first[:, None], greedy[:, 1:]], dim=1)
    lps = (torch.gather(logits, 2, emitted[..., None])[..., 0]
           - torch.logsumexp(logits, dim=-1))
    lps = torch.cat([first_lp[:, None], lps[:, 1:]], dim=1)
    active = live > 0
    n_emit = torch.where(active, torch.where(s.cols[0] <= 0.0, accepted + 1,
                                             1), 0).to(torch.int32)
    last = torch.gather(emitted, 1, torch.clamp_min(n_emit - 1, 0).long()
                        [:, None])[:, 0]
    tokens = torch.where(active, last, tokens)
    lengths = torch.clamp_max(lengths + n_emit, max_len - 1 - n_drafts)
    return lengths, tokens, emitted, lps, n_emit


def _verify_emit(params, cache, tables, lengths, tokens, drafts, live,
                 s: _Sampling, noise, cfg: TransformerConfig, *, top_k: int,
                 max_len: int, kernel: bool = True):
    """The exactness-critical verify-and-emit core of both drafting
    sources: ``_verify_logits`` then ``_accept``."""
    logits = _verify_logits(params, cache, tables, lengths, tokens, drafts,
                            cfg, kernel)
    return _accept(logits, lengths, tokens, drafts, live, s, noise,
                   top_k=top_k, max_len=max_len)


def _model_drafts(draft, tokens, lengths, draft_len: int,
                  kernel: bool = True):
    """``draft_len`` greedy tokens a slot from the draft model: ``draft``
    = (params, cfg, cache, tables).  ``draft_len + 1`` sequential t = 1
    forwards from ``tokens`` at ``lengths`` write the draft cache's rows
    at ``lengths … lengths + L``, exactly the rows the verify writes in
    the target's, so a fully accepted sub-step leaves no gap; the last
    forward exists only for its row (nothing is unembedded for it)."""
    dparams, dcfg, dcache, dtables = draft
    cur, drafted = tokens, []
    for j in range(draft_len + 1):
        x = _hidden_slots(dparams, cur[:, None], dcache, lengths + j,
                          dtables, dcfg, kernel)
        if j == draft_len:
            break
        cur = torch.argmax(unembed(x[:, -1], dparams, dcfg), dim=-1)
        drafted.append(cur)
    return torch.stack(drafted, dim=1)


def _decode_chunk_spec(params, cache, tables, tokens, starts, live,
                       s: _Sampling, noise, cfg: TransformerConfig, *,
                       chunk: int, draft_len: int, top_k: int, max_len: int,
                       history=None, ngram: int = 2, draft=None,
                       kernel: bool = True):
    """``_decode_chunk`` with speculative decoding: each of ``chunk``
    sub-steps drafts ``draft_len`` tokens a slot — by prompt lookup over
    ``history`` [S, max_len] (updated in place: the newest decided token
    at its position, then the drafts after it), or from the draft model
    ``draft`` (``_model_drafts``, its cache dense, its lengths the
    target's) — and verifies all ``draft_len + 1`` positions in one
    forward (``_verify_emit``).  Decode is bound by reading the cache and
    the weights, so the (L+1)-row forward costs about one step while it
    emits up to L+1 tokens.

    Exactness: greedy emission is unchanged by construction (position
    j's logits condition on a draft prefix that is only consumed when it
    equals the true greedy continuation); sampled rows emit one token a
    sub-step with the plain chunk's noise, so they are the plain path's
    tokens too.  Rejected rows (KV and history) sit past the slot's
    length, dead until overwritten.  No penalty counts are read or
    moved: a speculative engine refuses penalised requests.  Returns
    (tokens [S, chunk, L+1], logprobs [S, chunk, L+1], n_emit [S, chunk]
    — the host consumes ``n_emit[s, i]`` tokens of sub-step i — the last
    tokens [S] and the lengths [S]), all on the device."""
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    offsets = torch.arange(draft_len, device=tokens.device)
    lengths = starts
    outs, lps, n_emits = [], [], []
    for i in range(chunk):
        if draft is None:
            history[rows, torch.clamp_max(lengths, max_len - 1).long()] = (
                tokens)
            drafts = _draft_lookup(history, lengths, draft_len, ngram,
                                   max_len)
            at = torch.clamp_max(lengths + 1, max_len - draft_len).long()
            history[rows[:, None], at[:, None] + offsets] = drafts
        else:
            drafts = _model_drafts(draft, tokens, lengths, draft_len, kernel)
        lengths, tokens, out, lp, n_emit = _verify_emit(
            params, cache, tables, lengths, tokens, drafts, live, s,
            None if noise is None else noise[i], cfg, top_k=top_k,
            max_len=max_len, kernel=kernel,
        )
        outs.append(out)
        lps.append(lp)
        n_emits.append(n_emit)
    return (torch.stack(outs, dim=1), torch.stack(lps, dim=1),
            torch.stack(n_emits, dim=1), tokens, lengths)


def _restore_slot(history, tok_counts, gen_counts, slot: int, hist_row,
                  tok_row, gen_row) -> None:
    """The device half of un-parking: put one slot's per-slot device
    state back, in place — prompt lookup's token history row and the
    penalty occurrence rows (None where the engine keeps none), each
    rebuilt from host truth (prompt + emitted tokens), so the restored
    slot is indistinguishable from one that never left.  The cache
    frontier and the sampling index are host state (``_SlotState``)."""
    if history is not None:
        history[slot] = hist_row
    if tok_counts is not None:
        tok_counts[slot] = tok_row
        gen_counts[slot] = gen_row


# The keys of a decode chunk's graphs: (some row samples, some sampled
# row truncates).  Truncation matters only to sampled rows.
_GRAPH_KEYS = ((False, False), (True, False), (True, True))


class _ChunkBuffers:
    """A decode chunk's inputs and outputs at fixed device addresses —
    what a captured graph reads and writes — and the host buffers around
    them.  Inputs: ``tokens`` [S] int64 (also the carry: the chunk's last
    tokens are written back), ``meta`` [2, S] int32 (starts, live; on a
    speculative engine the starts are a carry too, the chunk's final
    lengths written back), ``cols`` [6, S], ``tables`` [S, n_tables],
    ``noise`` [chunk, S, V]; outputs ``out`` and ``lps`` [S, chunk], or
    on a speculative engine [S, chunk, spec + 1] with ``n_emit`` [S,
    chunk] int32 (``outputs`` lists them).  Two sets of host staging for
    the inputs and two of host outputs, taken in turn, one per chunk in
    flight: pinned on the GPU, so copies between them and the device do
    not wait for the device, and a staging set is not rewritten before
    the copies from it are done (``staged``)."""

    _STAGED = ("tokens", "meta", "cols", "tables")

    def __init__(self, n_slots: int, n_tables: int, chunk: int, vocab: int,
                 device, spec: int = 0):
        def dev(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        rows = (n_slots, chunk, spec + 1) if spec else (n_slots, chunk)
        self.tokens = dev((n_slots,), torch.int64)
        self.meta = dev((2, n_slots), torch.int32)
        self.cols = dev((len(_COLUMNS), n_slots), torch.float32)
        self.tables = dev((n_slots, n_tables), torch.int32)
        self.noise = dev((chunk, n_slots, vocab), torch.float32)
        self.out = dev(rows, torch.int64)
        self.lps = dev(rows, torch.float32)
        self.outputs = [self.out, self.lps]
        if spec:
            self.n_emit = dev((n_slots, chunk), torch.int32)
            self.outputs.append(self.n_emit)
        pin = torch.device(device).type == "cuda"

        def host(t):
            return torch.zeros(t.shape, dtype=t.dtype, pin_memory=pin)

        self.stages = [{name: host(getattr(self, name))
                        for name in self._STAGED} for _ in range(2)]
        self.staged: list = [None, None]
        self.results = [tuple(host(t) for t in self.outputs)
                        for _ in range(2)]
        self.turn = 0


# The cap on an admission dispatch's tokens (row class × bucket): a group
# past it runs as several dispatches of fewer rows.  It bounds the
# transients of one dispatch, which a graph pool keeps for good: at
# Mixtral-8x7B's widths served at 24 layers on an 80 GB H100 the pool
# is most of what stands between the card and the 8 GiB free at the
# serving peak that ``chip_smoke.py`` requires (PERF.md §6).
ADMIT_TOKENS = 4096


def _row_classes(n_slots: int) -> tuple[int, ...]:
    """The row counts an admission dispatch is padded to: the powers of
    two below ``n_slots``, then ``n_slots``."""
    classes, c = [], 1
    while c < n_slots:
        classes.append(c)
        c *= 2
    return (*classes, n_slots)


class _AdmitBuffers:
    """An admission dispatch's inputs and output at fixed device
    addresses — what an admission graph reads and writes.  For ``rows``
    rows at ``bucket`` (``views``): ``prompts`` [rows, bucket] int64
    (each row's prompt tail, zero-padded), ``meta`` [2, rows] int32
    (starts, true tails) and ``tables`` [rows, n_tables] int32, views at
    the head of two flat buffers, staged as one int64 and one int32 copy
    (``pack``); ``logits`` [rows, V] f32, each row's last real position
    unembedded."""

    def __init__(self, max_tokens: int, max_rows: int, n_tables: int,
                 vocab: int, device):
        def dev(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.n_tables = n_tables
        self.prompts = dev((max_tokens,), torch.int64)
        self.ints = dev((max_rows * (2 + n_tables),), torch.int32)
        # A draft model's prefill unembeds nothing: vocab 0.
        self.logits = dev((max_rows, vocab), torch.float32)

    def views(self, bucket: int, rows: int) -> tuple:
        """(prompts, meta, tables) of a dispatch of ``rows`` at
        ``bucket``."""
        n = rows * (2 + self.n_tables)
        return (self.prompts[: rows * bucket].view(rows, bucket),
                self.ints[: 2 * rows].view(2, rows),
                self.ints[2 * rows: n].view(rows, self.n_tables))

    def stage(self, prompts: np.ndarray, ints: np.ndarray) -> None:
        """Copy one dispatch's host inputs (``pack``) into the buffers'
        heads without waiting for the device."""
        _stage(prompts.reshape(-1), self.prompts[: prompts.size])
        _stage(ints, self.ints[: ints.size])

    @staticmethod
    def pack(meta: np.ndarray, tables: np.ndarray) -> np.ndarray:
        """The int32 buffer's head for meta [2, rows] and tables [rows,
        n_tables]."""
        return np.concatenate([meta.ravel(), tables.ravel()]).astype(np.int32)


def _pinned(host: np.ndarray, cuda: bool) -> torch.Tensor:
    """``host`` as a CPU tensor to copy to the device from: on the GPU a
    pinned copy, which the host allocator holds until a non-blocking
    transfer from it is done, so the host does not wait for the device
    (a pageable copy would)."""
    src = torch.from_numpy(np.ascontiguousarray(host))
    return src.pin_memory() if cuda else src


def _stage(host: np.ndarray, dst: torch.Tensor) -> None:
    """Copy ``host`` into ``dst`` without waiting for the device."""
    dst.copy_(_pinned(host, dst.is_cuda), non_blocking=dst.is_cuda)


def _to_device(host: np.ndarray, device) -> torch.Tensor:
    """``host`` as a new tensor on ``device``, copied as ``_stage``
    does."""
    cuda = torch.device(device).type == "cuda"
    return _pinned(host, cuda).to(device, non_blocking=cuda)


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
    (``+ chunk``; a speculative chunk advances each row by a count only
    the device knows, so its chained dispatch takes the positions from
    the device-side carry and ``starts`` is None there); ``results`` are
    the host buffers its outputs land in (``_ChunkBuffers.outputs``'
    order) once ``done`` (a CUDA event; None on the CPU) has passed.
    ``seq`` numbers the engine's dispatches, and ``dispatch_wall`` is
    the host wall its enqueue took (a decode span's attributes)."""

    snapshot: dict
    inputs: _ChunkInputs
    starts: np.ndarray | None
    indices: np.ndarray
    results: tuple
    done: object
    t_dispatch: float
    seq: int = 0
    dispatch_wall: float = 0.0


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
    uninterrupted stream's noise from token k on.  ``cache_prefix``
    stores the prompt's KV in the prefix cache (ignored when the engine
    has none).  ``hold_kv`` retains the finished request's KV blocks for
    ``export_kv`` (one ref each, TTL'd; a no-op on a dense engine).
    ``kv_import`` admits from a staged ``import_kv``/``import_slot``: the
    prompt must start with the import's token record, and decode resumes
    at its frontier (an expired import falls back to the recompute
    prefill).  ``tenant`` is the caller's identity ("" is "anon"): its
    QoS tier orders admission and park victims, labels the per-tenant
    histograms and ring entries, and stamps a migrated slot's manifest.
    ``span`` is the caller's span context: the engine records the
    request's phase spans as its children (None mints a fresh trace)."""

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
    tenant: str = ""
    span: "_tracing.SpanContext | None" = None


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
    "migrated": "suspended for migration (resume on a sibling)",
}


class RequestFailedError(RuntimeError):
    """One request failed without a result; ``kind`` tells the HTTP
    layer which status to answer: "aborted" (500), "cancelled",
    "deadline" (504), "deadline_queue" (429), "migrated" (503: suspended
    by ``begin_migrate_out``, its state in ``export_slot``)."""

    def __init__(self, rid: int, kind: str, message: str):
        super().__init__(
            f"request {rid} {_KIND_TEXT.get(kind, kind)}: {message}"
        )
        self.rid = rid
        self.kind = kind


@dataclass
class _PhaseTrace:
    """One request's phase clock, on host instants the step loop already
    takes: the substrate of its spans, its ring entry and the per-tenant
    histograms.  Recording never touches the device.

    The boundaries partition the request's life: queue = [t_submit,
    t_admitted], admit = [t_admitted, t_prefill] (the wave's scheduling
    slice before its first device work), prefill = [t_prefill, t_first]
    (to the first-token readback; a chunked prefill's segments fall
    inside it), decode = one interval per chunk the request took tokens
    from (clipped to the previous chunk's completion, so the pipeline's
    dispatch-ahead lag is not counted twice), stream = [last chunk done,
    finalize].  A parked slot's time in the host tier is in none of
    them."""

    t_submit: float
    t_admitted: float = 0.0
    t_prefill: float = 0.0
    t_first: float = 0.0
    # Which path produced the leading KV rows: a "local" or "fetched"
    # prefix entry, or a "recomputed" prefill.
    prefix_source: str = "recomputed"
    # Prompt segment dispatches (1 = one shot) and the host wall of each
    # non-final one.
    prefill_segments: int = 0
    segment_walls: list[float] = field(default_factory=list)
    # (chunk seq, span start, done, tokens, dispatch wall, fetch wall)
    # per decode chunk the request took tokens from.
    chunks: list[tuple] = field(default_factory=list)


@dataclass
class _PendingPrefill:
    """A long prompt mid-way through chunked prefill: its slot is
    assigned and, paged, its blocks committed; ``segs`` are the
    segments still to write, one an admission wave, and ``tail`` is the
    final one, which joins a wave's group dispatch for the first token.
    Its rid stays in ``_admitting`` throughout, so ``abort`` reclaims
    the slot as for a one-shot admission."""

    rid: int
    req: GenRequest
    slot: int
    segs: list
    tail: list
    start: int  # the next segment's first position
    t_submit: float
    trace: _PhaseTrace


@dataclass
class _SlotState:
    rid: int
    req: GenRequest
    t_submit: float
    length: int  # cache frontier: where the next token's K/V is written
    emitted: list[int] = field(default_factory=list)
    logprobs: list[float] = field(default_factory=list)
    last_token: int = 0
    # Set when the slot was just restored from the host tier, cleared at
    # its next emitted token: a restored slot makes progress before it
    # can be parked again, or a saturated queue ping-pongs one victim.
    park_immune: bool = False
    phases: _PhaseTrace | None = None


def _pack(tensors) -> torch.Tensor:
    """Host tensors' C-order bytes, one after another, as one uint8
    tensor (what a gather or scatter over gloo moves; one tensor's own
    bytes, viewed, not copied)."""
    if not tensors:
        return torch.empty(0, dtype=torch.uint8)
    if len(tensors) == 1:
        return tensors[0].contiguous().reshape(-1).view(torch.uint8)
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors])


def _unpack(flat: torch.Tensor, like) -> list[torch.Tensor]:
    """``_pack``'s inverse: tensors of ``like``'s shapes and dtypes,
    views of ``flat``."""
    out, at = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(flat[at:at + n].view(t.dtype).reshape(t.shape))
        at += n
    return out


class _MeshLink:
    """The leader's device work, as records, to the other ranks of a
    mesh: each record is a batch of (method name, host arguments),
    broadcast from rank 0 over the mesh's gloo ``control`` group, so host
    metadata never rides a device stream.  Records ``defer``red by the
    leader under the engine lock (a dense prefix entry dropped, a
    demotion's or a park's copy down, a promotion's host gather, a staged
    payload dropped) go out ahead of its next one.

    Any thread of the leader may start device work (the step thread's
    dispatches, and the HTTP handlers' KV exports and imports, weight
    gathers, beam and embed): it sends the record and does its own half
    — its device work and any ``gather`` or ``scatter`` — inside
    ``turn``, one reentrant lock, so that the followers, which run the
    records strictly in arrival order, issue their collectives in the
    leader's order.  Nothing takes ``turn`` while holding the engine
    lock (that work is deferred instead).

    ``gather`` and ``scatter`` move host tensors to and from rank 0 over
    the same ``control`` group, never a ``tp``/``ep`` group, so these
    bytes never enter a dispatch's collectives or a captured graph.
    They carry the block reads of a KV export (held KV, a prefix entry,
    a suspended slot's device or host blocks) to rank 0, a shipped
    payload's kv-head parts out to the ranks at its import, and each
    weight tensor's blocks to rank 0 for ``GET /v1/weights``: the one
    place a follower reads the device back."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.leader = mesh.rank == 0
        self._deferred: list = []
        self._lock = threading.Lock()
        self.turn = threading.RLock()

    def defer(self, *record) -> None:
        with self._lock:
            self._deferred.append(record)

    def send(self, *record) -> None:
        with self.turn:
            with self._lock:
                batch, self._deferred = self._deferred + [record], []
            dist.broadcast_object_list([batch], src=0,
                                       group=self.mesh.control)

    def recv(self) -> list:
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.mesh.control)
        return box[0]

    def gather(self, tensors) -> list | None:
        """Every rank's host ``tensors`` (the same shapes and dtypes on
        each rank) at rank 0: ``[rank][i]`` there, None on the others."""
        flat = _pack(tensors)
        if not self.leader:
            dist.gather(flat, dst=0, group=self.mesh.control)
            return None
        bufs = [torch.empty_like(flat) for _ in range(self.mesh.size)]
        dist.gather(flat, bufs, dst=0, group=self.mesh.control)
        return [_unpack(buf, tensors) for buf in bufs]

    def scatter(self, parts=None, like=None) -> list:
        """Rank 0's ``parts`` (one list of host tensors a rank, the same
        sizes on each) out to the ranks: rank 0 keeps ``parts[0]``; a
        follower passes ``like`` (tensors of its part's shapes and
        dtypes) and gets its part."""
        if self.leader:
            out = torch.empty_like(_pack(parts[0]))
            dist.scatter(out, [_pack(p) for p in parts], src=0,
                         group=self.mesh.control)
            return parts[0]
        out = _pack(like)
        dist.scatter(out, src=0, group=self.mesh.control)
        return _unpack(out, like)


class Engine:
    """Continuous-batching engine: submit → step/run → result.

    Thread-safe for one step thread calling ``step``/``run`` while any
    number of threads call ``submit``/``result`` (the HTTP server's
    usage).  ``device`` defaults to CUDA; without a GPU the caller must
    ask for ``"cpu"``, where the kernel wrappers run their plain
    versions.  On the GPU each decode chunk and each admission dispatch
    replays a CUDA graph, all captured at ``warmup`` (or at the first
    dispatch); ``cuda_graphs=False`` dispatches the same work eagerly
    instead, the A/B control for measurements.  A capture or replay that
    fails, or an admission shape with no graph, raises: the engine never
    falls back to eager dispatch by itself.  With ``mesh`` every rank
    builds its engine with the same arguments; rank 0 serves and the
    others ``follow`` (module docstring).
    """

    _instance_lock = threading.Lock()
    _instance_count = 0

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
        spec_ngram: int = 2,
        draft_params=None,
        draft_cfg: TransformerConfig | None = None,
        penalties: bool = True,
        max_queue: int = 0,
        prefill_chunk: int = 0,
        pipeline_depth: int = 2,
        brownout_max_tokens: int = 0,
        brownout_queue_fraction: float = 0.75,
        brownout_hold_s: float = 1.0,
        request_ring: int = 256,
        kv_block: int = 0,
        kv_blocks: int = 0,
        kv_host_bytes: int = 0,
        kv_park: bool = True,
        qos=None,
        slow_capture_e2e_s: float = 0.0,
        slow_capture_tpot_mult: float = 0.0,
        slow_capture_interval_s: float = 60.0,
        device=None,
        cuda_graphs: bool = True,
        paged_kernel: bool | None = None,
        prefill_kernel: bool | None = None,
        mesh=None,
    ):
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not this rank's mesh "
                                 f"device {mesh.device}")
            device = mesh.device
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
        if spec_decode < 0 or (spec_decode and spec_ngram < 1):
            raise ValueError(
                f"need spec_decode>=0 and spec_ngram>=1; got "
                f"{spec_decode}, {spec_ngram}"
            )
        if (draft_params is None) != (draft_cfg is None):
            raise ValueError(
                "draft_params and draft_cfg come together or not at all"
            )
        if draft_cfg is not None:
            if not spec_decode:
                raise ValueError(
                    "a draft model needs spec_decode >= 1 (draft length)"
                )
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {draft_cfg.vocab_size} != target "
                    f"vocab {cfg.vocab_size}"
                )
        # A speculative engine reserves spec_decode + 1 rows a slot, so
        # that a verify's L+1 writes always fit inside the region, even
        # past EOS (a clamped start never slides back over live rows).
        self._usable_len = max_len - (spec_decode + 1 if spec_decode else 0)
        if self._usable_len < 2:
            raise ValueError(
                f"max_len={max_len} leaves no usable room after the "
                f"spec_decode={spec_decode} headroom reserve"
            )
        if kv_host_bytes < 0:
            raise ValueError(
                f"kv_host_bytes must be >= 0, got {kv_host_bytes}"
            )
        if kv_host_bytes and not self.paged:
            raise ValueError(
                "kv_host_bytes needs the paged cache (kv_block > 0): "
                "only the block pool has a block-granular unit to "
                "demote/promote"
            )
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
        # The kernel switch (the reference's A/B control): None = the
        # kernels wherever the engine runs on the card; True = the kernel
        # wrappers (their plain versions on CPU tensors); False = the plain
        # versions on this device.  Only the caller's argument picks.
        cuda = self.device.type == "cuda"
        self.paged_kernel = cuda if paged_kernel is None else bool(
            paged_kernel)
        self.prefill_kernel = cuda if prefill_kernel is None else bool(
            prefill_kernel)
        block_size = kv_block if self.paged else dense_block_size(max_len)
        geometries = [(cfg.head_dim, block_size,
                       "kv_block" if self.paged else "a dense block")]
        if draft_cfg is not None:
            geometries.append((draft_cfg.head_dim, dense_block_size(max_len),
                               "the draft's dense block"))
        for name, on in (("paged_kernel", self.paged_kernel),
                         ("prefill_kernel", self.prefill_kernel)):
            for head_dim, block, what in geometries:
                if on and not supported_block_size(block, head_dim):
                    # Fail here, with the constraint named, rather than
                    # in the first launch on the step thread.
                    flag = name.replace("_", "-")
                    raise ValueError(
                        f"{name} needs head_dim in (64, 128) and blocks of "
                        f"1 to 64 rows; got {what}={block}, head_dim="
                        f"{head_dim} — run this geometry with the gather "
                        f"path ({name}=False / --{flag} off)"
                    )
        if max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {max_queue}")
        if (brownout_max_tokens < 0
                or not 0.0 < brownout_queue_fraction <= 1.0):
            raise ValueError(
                f"need brownout_max_tokens>=0 and brownout_queue_fraction "
                f"in (0, 1]; got {brownout_max_tokens}, "
                f"{brownout_queue_fraction}"
            )
        if request_ring < 0:
            raise ValueError(
                f"request_ring must be >= 0, got {request_ring}"
            )
        if (slow_capture_e2e_s < 0 or slow_capture_tpot_mult < 0
                or slow_capture_interval_s < 0):
            raise ValueError(
                "slow-capture knobs must be >= 0; got "
                f"e2e={slow_capture_e2e_s}, mult={slow_capture_tpot_mult}, "
                f"interval={slow_capture_interval_s}"
            )
        if prefix_cache_size < 0:
            raise ValueError(
                f"prefix_cache_size must be >= 0, got {prefix_cache_size}"
            )
        if prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be >= 0, got {prefill_chunk}"
            )
        _validate_truncation(top_k, top_p, cfg.vocab_size)
        self.mesh = mesh
        self._link = None
        self._specs = None
        # The config the device functions run: the model, or this rank's
        # share of it under a mesh (``cfg`` stays the whole model's).
        self._run_cfg = cfg
        if mesh is not None:
            tp = mesh.shape.get("tp", 1)
            if cfg.n_heads % tp or cfg.kv_heads % tp:
                raise ValueError(
                    f"n_heads={cfg.n_heads} and kv_heads={cfg.kv_heads} "
                    f"must divide by mesh tp={tp}"
                )
            ep = mesh.shape.get("ep", 1)
            if ep > 1 and (not cfg.n_experts or cfg.n_experts % ep):
                raise ValueError(
                    f"n_experts={cfg.n_experts} must be a positive "
                    f"multiple of mesh ep={ep}"
                )
            if (cuda_graphs and self.device.type == "cuda"
                    and mesh.backend != "nccl"):
                raise ValueError(
                    f"cuda_graphs needs an NCCL mesh: {mesh.backend} "
                    f"collectives cannot be captured in a CUDA graph; pass "
                    f"cuda_graphs=False")
            # The whole model's count (the reference's, over the global
            # arrays), before this rank keeps its shard.
            self.n_params = sum(math.prod(shape) for shape in
                                param_shapes(cfg).values())
            self._specs = specs_of(params, cfg, mesh)
            self._run_cfg = rank_config(cfg, mesh, self._specs)
            params = shard_params(params, cfg, mesh)
            self._link = _MeshLink(mesh)
            if mesh.backend == "nccl":
                mesh.warm()  # communicators exist before any capture
        self.cfg = cfg
        self.params = to_device(params, self.device)
        if mesh is None:
            self.n_params = n_params(self.params)
        self.n_slots = n_slots
        self.max_len = max_len
        self.chunk = chunk
        self.top_k = top_k
        self.default_top_p = top_p
        self.kv_int8 = kv_int8
        self.kv_int4 = kv_int4
        # The KV quant ladder's rung, and the served weights' (from the
        # params: a `_wscale` companion's payload dtype).
        self.kv_quant = "int4" if kv_int4 else ("int8" if kv_int8 else "")
        self.weight_quant = weight_quant_mode(self.params)
        self.weights_int8 = self.weight_quant == "int8"
        self.penalties = penalties
        self.max_queue = max_queue
        # Brownout: under sustained queue pressure (the queue at or above
        # a fraction of max_queue for brownout_hold_s), clamp incoming
        # budgets to brownout_max_tokens instead of letting the backlog
        # grow to the hard 429 (0 = off; pressure needs max_queue).
        self.brownout_max_tokens = brownout_max_tokens
        self.brownout_hold_s = brownout_hold_s
        self._brownout_at = max(
            1, int(round(max_queue * brownout_queue_fraction))
        ) if max_queue else 0
        self._pressure_since: float | None = None
        self.pipeline_depth = pipeline_depth
        self.kv_block = kv_block
        self._n_tables = max_len // block_size
        if prompt_buckets is None:
            prompt_buckets, b = [], 16
            while b < self._usable_len:
                prompt_buckets.append(b)
                b *= 2
            prompt_buckets.append(self._usable_len - 1)
        self.prompt_buckets = tuple(sorted(set(prompt_buckets)))
        bad = [b for b in self.prompt_buckets
               if not 1 <= b <= self._usable_len - 1]
        if bad:
            raise ValueError(
                f"prompt_buckets must fit 1..{self._usable_len - 1} (each "
                f"admitted prompt needs >= 1 generated token, and "
                f"speculative mode reserves spec_decode+1 rows): {bad}"
            )
        if prefill_chunk and prefill_chunk not in self.prompt_buckets:
            # A bucket-exact chunk keeps every non-final segment's window
            # exactly [p, p + chunk): only the final one is padded.
            raise ValueError(
                f"prefill_chunk={prefill_chunk} must be one of the "
                f"prompt buckets {self.prompt_buckets}"
            )
        self.prefix_cache_size = prefix_cache_size
        self.prefill_chunk = prefill_chunk
        if self.paged:
            self.kv_blocks = kv_blocks or n_slots * self._n_tables
            self._cache = PagedCache.create(
                self._run_cfg, self.kv_blocks, kv_block,
                quantized=self.kv_quant,
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
                self._run_cfg, n_slots, max_len, block_size,
                quantized=kv_int8,
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
        # Bytes of one cached row over every layer (K, V and scales), of
        # the whole model's kv heads: under a mesh a rank holds 1/tp of
        # them, but the host tier's budget, the block counters and the
        # byte counters are the reference's, over the global arrays.
        self._kv_row_bytes = sum(
            t[0, 0, 0].numel() * t.element_size() * cfg.n_layers
            for t in (self._cache.k, self._cache.v, self._cache.k_scale,
                      self._cache.v_scale) if t is not None
        ) * (cfg.kv_heads // self._run_cfg.kv_heads)
        # Bytes in one pool block (0 on dense): the tier-flow and ship
        # byte counters are blocks times this.
        self._block_bytes = self._kv_row_bytes * kv_block
        # The host-RAM tier: a second block pool under a byte budget.
        # Prefix shortfalls demote idle entries to it instead of
        # destroying them, a later hit promotes them back (a staged
        # install, landed at the next admission boundary), and an
        # admission that cannot fit can park the coldest slot there and
        # restore it exactly when blocks free.
        self.kv_host_bytes = kv_host_bytes
        self._host = None
        if kv_host_bytes:
            n_host = kv_host_bytes // self._block_bytes
            if n_host < 1:
                raise ValueError(
                    f"kv_host_bytes={kv_host_bytes} holds no block "
                    f"(one {kv_block}-token block is {self._block_bytes} "
                    f"bytes here)"
                )
            # Under a mesh each rank pins its kv-head share of each
            # block; the leader's allocator picks the ids every rank uses.
            self._host = HostBlockPool(self._cache, n_host,
                                       pin=self.device.type == "cuda")
        # Parking needs a per-slot state that host truth rebuilds: a
        # draft model's dense cache is device state a restore cannot
        # rebuild without a draft prefill, so a draft engine does not
        # park (it still demotes and promotes prefix entries).
        self.kv_park = bool(
            self._host is not None and kv_park and draft_cfg is None
        )
        # Host-tier state, under self._lock like the device allocator:
        # demoted prefix entries (covered-token key → (host block ids,
        # rows)) and their residency records, parked slots (rid →
        # _ParkedSlot, restored oldest first), demotions dispatched but
        # not landed, and promotions planned whose payload copy runs off
        # the lock.  _h2d holds the pinned sources of the copies up to
        # the device, each beside the event after which it may go.
        self._host_prefix: OrderedDict = OrderedDict()
        self._host_meta: dict[tuple, dict] = {}
        self._parked: OrderedDict = OrderedDict()
        self._pending_host_writes: list[_HostWrite] = []
        self._promote_staging: set[tuple] = set()
        self._h2d: deque = deque()
        # Held KV (rid → KvHold, one extra ref a block) and staged
        # imports (import id → KvImport, reserved blocks and the host
        # payload the step thread writes at admission), both TTL'd and
        # count-capped; staged prefix installs (digest, KvImport,
        # promote key — the host entry a promotion clears, or None for
        # a shipped entry); migrated-slot records (rid → SlotRecord).
        self._kv_holds: dict[int, KvHold] = {}
        self._kv_imports: dict[int, KvImport] = {}
        self._next_import_id = 0
        self._prefix_installs: list[tuple] = []
        self._migrated: dict[int, SlotRecord] = {}
        self._migrate_out = False
        # Under a mesh: a staged payload's tag (a promotion's or an
        # import's, ``KvImport.tag``) names each rank's part of it, held
        # in ``_stash`` until its blocks are written; a follower's
        # demotions and parks wait in ``_follow_writes`` until they land
        # in its host pool; ``_twice_saved`` is chunk_twice/admit_twice's
        # device state on every rank.
        self._tags = itertools.count()
        self._stash: dict[int, list] = {}
        self._follow_writes: list = []
        self._twice_saved = None
        # Prompt tokens → (entry, rows it covers), least recently used
        # first.  Dense: copies (k, v, k_scale, v_scale) of a slot's first
        # rows, [n_layers, rows, ...]; paged: the ids of the blocks the
        # prompt fully covers, one ref each.
        self._prefix_cache: OrderedDict = OrderedDict()
        # One residency record an entry (same key): the digest of the
        # covered tokens (its fleet identity), covered rows, hits, last
        # hit, origin ("local", or "fetched" for an installed ship) and
        # its owner's tenant and tier.
        self._prefix_meta: dict[tuple, dict] = {}
        self._prefilling: dict[int, _PendingPrefill] = {}
        self.spec_decode = spec_decode
        self.spec_ngram = spec_ngram
        self.draft_cfg = draft_cfg
        self.draft_params = None
        self._history = None
        self._draft_cache = None
        if draft_cfg is not None:
            # Model-drafted speculation: the draft keeps its own dense,
            # unquantized slot cache (it is small) in lockstep with the
            # target's lengths, behind the identity table of its regions
            # (a decode chunk's row with no request gets the sentinel).
            self.draft_params = to_device(draft_params, self.device)
            dbs = dense_block_size(max_len)
            self._draft_cache = SlotCache.create(
                draft_cfg, n_slots, max_len, dbs, device=self.device)
            self._draft_n_tables = max_len // dbs
            self._draft_sentinel = n_slots * self._draft_n_tables
            self._draft_identity_host = np.arange(
                self._draft_sentinel, dtype=np.int32,
            ).reshape(n_slots, self._draft_n_tables)
            self._draft_identity = torch.from_numpy(
                self._draft_identity_host).to(self.device)
        elif spec_decode:
            # Prompt lookup's draft source: each slot's tokens (admission
            # writes the whole prompt, decode the decided tokens and the
            # drafts after them).
            self._history = torch.zeros((n_slots, max_len),
                                        dtype=torch.int64,
                                        device=self.device)
        self._buf = _ChunkBuffers(n_slots, self._n_tables, chunk,
                                  cfg.vocab_size, self.device,
                                  spec=spec_decode)
        # Each bucket's admission row classes within the token cap (one
        # row always: a prompt is never split).
        self._admit_classes = {
            b: tuple(c for c in _row_classes(n_slots)
                     if c == 1 or c * b <= ADMIT_TOKENS)
            for b in self.prompt_buckets
        }
        self._adm = _AdmitBuffers(
            max(b * c[-1] for b, c in self._admit_classes.items()),
            max(c[-1] for c in self._admit_classes.values()),
            self._n_tables, cfg.vocab_size, self.device,
        )
        self._admit_graphs: dict = {}  # (bucket, rows) → (graph, counts)
        # A draft engine's draft prefill: its own dispatches over the full
        # prompts, keyed by the full prompt's bucket and a row class.
        self._dadm = None
        self._draft_graphs: dict = {}
        if draft_cfg is not None:
            self._dadm = _AdmitBuffers(
                max(b * c[-1] for b, c in self._admit_classes.items()),
                max(c[-1] for c in self._admit_classes.values()),
                self._draft_n_tables, 0, self.device,
            )
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
        # Slot-free work (embed, beam) running on handler threads, and
        # beam's bounded per-configuration state: (beam_size, alpha,
        # eos_id) → search function, FIFO-evicted past
        # _MAX_BEAM_PROGRAMS; (config, prompt length, max_new) shapes
        # seen, all cleared past _MAX_BEAM_TRACES.
        self._aux_active = 0
        self._beam_lock = threading.Lock()
        self._beam_fns: dict = {}
        self._beam_traces: set = set()
        # Host-side accounting (stats()); warmup's dummies are not
        # counted.
        self.steps = 0
        self.tokens_generated = 0
        self.kv_admit_deferrals = 0
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_injects = 0
        self.prefix_evictions = 0
        self.prefix_bytes_saved = 0
        # The host tier's movements: blocks and bytes each way, the
        # step thread's walls for them (a demotion's copy to the host overlaps
        # decode, so its wall is the landing in the host pool; a
        # promotion's or restore's is its copies up and scatter
        # enqueued), slots parked and restored, and the prefix
        # shortfall's split: moved to the host tier (demotions) or
        # destroyed (evictions).
        self.kv_demotions = 0
        self.kv_promotions = 0
        self.kv_demote_bytes = 0
        self.kv_promote_bytes = 0
        self.kv_demote_seconds = 0.0
        self.kv_promote_seconds = 0.0
        self._promote_walls: deque[float] = deque(maxlen=64)
        self.kv_parks = 0
        self.kv_unparks = 0
        self.prefix_demotions = 0
        # KV shipping: exports served, imports staged, bytes both ways;
        # prefix entries exported and shipped entries installed; slots
        # exported and imported.
        self.kv_exports = 0
        self.kv_imports_total = 0
        self.kv_ship_bytes = 0
        self.prefix_exports = 0
        self.prefix_fetch_installs = 0
        self.slot_exports = 0
        self.slot_imports = 0
        # Prompt segments dispatched: one for a one-shot admission, one
        # per segment of a chunked one.
        self.prefill_segments = 0
        self.prefill_seconds = 0.0
        # Decode wall: each processed chunk's from its dispatch, or from
        # the previous chunk's readback when it overlapped it, to its
        # own readback.
        self.decode_seconds = 0.0
        self.decode_tokens = 0
        # Forward passes through the layer stack: one per first-token
        # admission dispatch (a group past the token cap makes several)
        # and one per decode step dispatched (each runs both kernels
        # once per layer) — a chunk dropped unread included.
        self.prefill_dispatches = 0
        self.decode_passes = 0
        self.decode_dispatches = 0
        self.graph_replays = 0  # decode chunks replayed
        # Admission dispatches (first-token groups and non-final
        # segments) replayed from their graphs.
        self.admission_replays = 0
        # A draft engine's draft forwards: the prefill dispatches of its
        # admissions (each through the whole draft stack) and their
        # replays, and the t = 1 passes of its decode chunks, spec_decode
        # + 1 a sub-step.
        self.draft_prefill_dispatches = 0
        self.draft_admission_replays = 0
        self.draft_passes = 0
        # Greedy rows' drafts: spec_decode a sub-step consumed, and the
        # accepted ones consumed.
        self.spec_drafted = 0
        self.spec_accepted = 0
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
        # Host walls of warmup() (its graph capture included), of the
        # capture of every graph, and of the admission graphs' share.
        self.warmup_seconds = 0.0
        self.graph_capture_seconds = 0.0
        # The recompile sentinel (serve/sentinel.py): the request context
        # a capture is charged to, replaced wholesale (never mutated) by
        # the step thread at phase boundaries and read there without a
        # lock; and the captures charged to this engine after its warmup.
        self._sentinel_ctx: dict = {"phase": "idle"}
        self.recompiles = 0
        self.admission_capture_seconds = 0.0
        self._t_device_free: float | None = None
        self._t_last_chunk_done: float | None = None
        self._ttfts: deque[float] = deque(maxlen=256)
        self._step_count = 0  # decode dispatches, numbering their spans
        # The recently completed request ring: one record a finished or
        # failed request (phases, tokens, outcome), drop-oldest with the
        # drops counted; under its own lock, which never nests inside
        # the engine's.  Failures are recorded under the engine lock
        # into _fail_obs and finalized after it drops
        # (_drain_fail_obs): spans and histograms run off the lock.
        self._ring: deque[dict] = deque(maxlen=request_ring)
        self.ring_dropped = 0
        self._ring_lock = threading.Lock()
        self._fail_obs: list[tuple] = []
        # Token streams: rid → on_token, called on the step thread as
        # on_token(token, logprob) for each token in order and once as
        # (None, None) at the end.  A failed request's callback is queued
        # in _ended under the engine lock and called once it drops, by
        # _drain_fail_obs.
        self._callbacks: dict[int, object] = {}
        self._ended: list = []
        # The stall watchdog's read surface: the instant the step thread
        # began its current wait on the device (None when not waiting),
        # and the typical chunk wall, dispatch to readback.  Beside it,
        # the marginal token rate (tokens/s over processed chunks) that
        # Retry-After hints divide the backlog by.
        self._device_wait_since: float | None = None
        self._chunk_wall_ewma: float | None = None
        self._token_rate_ewma: float | None = None
        # This engine's own shed totals (the shared counter cannot be
        # read back per engine).
        self._shed_counts = {"queue_full": 0, "deadline": 0, "brownout": 0}
        # Multi-tenant QoS: a ``qos/policy.py::QosPolicy``, or None for
        # none (FIFO admission, no preemption).  Tenant accounting (the
        # fair-share virtual times, admissions, preemptions, tokens)
        # runs either way, under self._lock.
        self._qos_policy = qos
        self._tenants: dict[str, dict] = {}
        self.qos_preemptions = 0  # admissions that parked a victim
        # Tail-latency auto-capture: an absolute e2e threshold and/or a
        # multiple of the marginal token rate EWMA (0 = that trigger
        # off), at most one artifact an interval.
        self._slow_e2e_s = float(slow_capture_e2e_s)
        self._slow_tpot_mult = float(slow_capture_tpot_mult)
        self._slow_interval_s = float(slow_capture_interval_s)
        self._slow_last_capture = 0.0  # monotonic; 0 = never
        self.slow_captures = 0
        # Shared instruments (``common/metrics.py``): cumulative counters
        # and histograms shared by every engine of the process, gauges
        # per engine under its index.
        with Engine._instance_lock:
            self._engine_label = str(Engine._instance_count)
            Engine._instance_count += 1

    # -- submission and results ---------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.prompt_buckets:
            if n <= b:
                return b
        raise AssertionError("submit() bounds prompt length")

    def _worst_case_rows(self, n_tokens: int, max_new: int,
                         start: int = 0) -> int:
        """The most slot rows a request can touch: its bucketed prefill
        window from ``start`` (0 with no prefix hit) or prompt + budget +
        the speculative headroom (a verify's rows), whichever is larger —
        the one bound the submit-time fit check, warmup and the admission
        planner share."""
        headroom = self.spec_decode + 1 if self.spec_decode else 0
        return min(self.max_len, max(start + self._bucket(n_tokens - start),
                                     n_tokens + max_new + headroom))

    def _pool_blocks_needed(self, n_tokens: int, max_new: int) -> int:
        """Pool blocks a request reserves with no prefix hit (0 on the
        dense layout, whose slots own their regions)."""
        if not self.paged:
            return 0
        return -(-self._worst_case_rows(n_tokens, max_new) // self.kv_block)

    def _validate(self, req: GenRequest) -> None:
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
        if len(req.tokens) + req.max_new_tokens > self._usable_len:
            raise ValueError(
                f"prompt {len(req.tokens)} + max_new_tokens "
                f"{req.max_new_tokens} exceeds max_len {self.max_len}"
                + (f" minus the spec_decode+1={self.spec_decode + 1} "
                   f"headroom reserve" if self.spec_decode else "")
            )
        need = self._pool_blocks_needed(len(req.tokens), req.max_new_tokens)
        if need > self.kv_blocks:
            # Queued, it could never be admitted and would wedge the
            # queue behind it.
            raise ValueError(
                f"request needs {need} KV blocks worst-case but the pool "
                f"holds only {self.kv_blocks} blocks of {self.kv_block}"
            )
        if req.kv_import is not None:
            if not self.paged:
                raise ValueError(
                    "kv_import needs a paged engine (oim-serve "
                    "--kv-block); this engine runs the dense cache"
                )
            with self._lock:
                imp = self._kv_imports.get(req.kv_import)
            # The import may expire before admission (the planner then
            # falls back to the recompute prefill), but a present import
            # whose token record does not start this prompt would decode
            # against another request's KV.
            if imp is not None and (
                len(imp.tokens) > len(req.tokens)
                or list(req.tokens[: len(imp.tokens)]) != list(imp.tokens)
            ):
                raise ValueError(
                    f"kv_import {req.kv_import} token record does not "
                    f"prefix this request's prompt"
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
        if self.spec_decode and wants_penalties:
            # A verify samples L+1 positions from one forward; penalties
            # move the counts within that block, so exactness would need
            # a per-position count replay.  Refuse rather than approximate.
            raise ValueError(
                "sampling penalties are not supported on a speculative "
                "engine (start oim-serve without --spec-decode)"
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

    def submit(self, req: GenRequest, on_token=None) -> int:
        """Queue a request; returns its id.  ``on_token`` (optional)
        streams the generation: called as ``on_token(token, logprob)``
        once per emitted token, in order, then once with ``(None, None)``
        at the end, whatever the end (finish, EOS or stop id, cancel,
        abort, deadline, migration).  Callbacks run on the step thread
        (or the thread that failed the request) and must not block: hand
        off to a queue, as the HTTP stream does."""
        if self._link is not None and not self._link.leader:
            raise RuntimeError("a follower rank runs the leader's records "
                               "(follow); submit to rank 0")
        try:
            self._validate(req)
        except ValueError:
            if not self._warming:
                _metrics.SERVE_REQUESTS.inc("rejected")
            raise
        now = time.monotonic()
        if req.deadline is not None and now >= req.deadline:
            # Dead on arrival: shed before it costs anything.
            if not self._warming:
                _metrics.SERVE_REQUESTS.inc("rejected")
                _metrics.SERVE_SHED.inc("deadline")
                _metrics.SERVE_DEADLINE_EXPIRED.inc()
                with self._lock:
                    self._shed_counts["deadline"] += 1
            raise DeadlineExpiredError(
                "request deadline already expired at submission"
            )
        with self._lock:
            if self._fatal is not None:
                if not self._warming:
                    _metrics.SERVE_REQUESTS.inc("rejected")
                raise EngineFailedError(f"engine failed: {self._fatal}")
            if self._draining:
                if not self._warming:
                    _metrics.SERVE_REQUESTS.inc("rejected")
                raise DrainingError("engine is draining; not admitting")
            if (self.max_queue and not self._warming
                    and len(self._queue) >= self.max_queue):
                _metrics.SERVE_REQUESTS.inc("rejected")
                _metrics.SERVE_SHED.inc("queue_full")
                self._shed_counts["queue_full"] += 1
                raise QueueFullError(
                    f"admission queue full ({self.max_queue}); retry later"
                )
            if self.max_queue and not self._warming:
                # Brownout: pressure is the queue at or above its
                # threshold, sustained across submissions; clamp only
                # once it has held for brownout_hold_s.
                if len(self._queue) >= self._brownout_at:
                    if self._pressure_since is None:
                        self._pressure_since = now
                else:
                    self._pressure_since = None
                if (self.brownout_max_tokens
                        and self._pressure_since is not None
                        and now - self._pressure_since >= self.brownout_hold_s
                        and req.max_new_tokens > self.brownout_max_tokens):
                    req = replace(req,
                                  max_new_tokens=self.brownout_max_tokens)
                    _metrics.SERVE_SHED.inc("brownout")
                    self._shed_counts["brownout"] += 1
            rid = self._next_rid
            self._next_rid += 1
            self._queue.append((rid, req, now))
            self._events[rid] = threading.Event()
            if on_token is not None:
                self._callbacks[rid] = on_token
            # A demoted entry that covers this prompt better than any
            # resident one: reserve its promotion now, copy its payload
            # once the lock drops, and the step thread lands it at this
            # request's admission boundary (recompute is the fallback).
            promote = (self._plan_promote_locked(req)
                       if self._host is not None and not self._warming
                       else None)
        if promote is not None:
            self._stage_promote(promote)
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
            self._callbacks.pop(rid, None)  # the stream's reader left

    def cancel(self, rid: int, message: str = "cancelled by client") -> bool:
        """Cancel one request: a queued one fails now, an admitting or
        active one at the next step.  False when unknown or done."""
        with self._lock:
            if rid in self._results or rid in self._errors:
                return False
            for i, (qrid, qreq, qt) in enumerate(self._queue):
                if qrid == rid:
                    del self._queue[i]
                    self._fail_locked(rid, "cancelled", message, req=qreq,
                                      t_submit=qt)
                    break
            else:
                if not (rid in self._admitting or rid in self._parked or any(
                        s.rid == rid for s in self._slots.values())):
                    return False
                self._cancelled.add(rid)  # reaped at the next step
        self._drain_fail_obs()
        return True

    def _fail_locked(self, rid: int, kind: str, message: str, *,
                     req: GenRequest | None = None,
                     t_submit: float | None = None,
                     state: _SlotState | None = None) -> None:
        """Record a failed request's error and wake its waiter (lock
        held).  ``req`` and ``t_submit`` (a queued or mid-prefill
        request) or ``state`` (a seated or parked one) carry what the
        caller knows of it, so that its ring entry, spans and e2e
        observation exist for failures too; the caller finalizes them
        with ``_drain_fail_obs`` once the lock is dropped, which also
        ends the request's token stream."""
        ended = self._callbacks.pop(rid, None)
        if ended is not None:
            self._ended.append(ended)
        if not self._warming:
            _metrics.SERVE_REQUESTS.inc(kind)
            if state is not None:
                req = state.req
                phases = state.phases or _PhaseTrace(t_submit=state.t_submit)
                tokens_out = len(state.emitted)
            else:
                phases = (_PhaseTrace(t_submit=t_submit)
                          if t_submit is not None else None)
                tokens_out = 0
            self._fail_obs.append((rid, req, phases, kind, tokens_out))
        self._cancelled.discard(rid)
        if rid in self._forgotten:
            self._forgotten.discard(rid)
            self._events.pop(rid, None)
            return
        self._errors[rid] = (kind, message)
        if rid in self._events:
            self._events[rid].set()

    def abort(self, message: str, *, kind: str = "aborted") -> None:
        """Fail every queued, admitting, active and parked request with
        ``kind`` and reclaim their slots and blocks in both tiers (the
        crash path of ``step``; the stall watchdog's verdict passes
        "stalled", which the server answers 503, retryable elsewhere).
        A chunk in flight is dropped unread: it references only the
        requests failed here, and the device finishes it before any
        later work.  A park whose copy to the host is still in
        flight returns its host blocks when the copy lands."""
        with self._lock:
            self._inflight = None
            self._t_device_free = None
            # (rid, req, t_submit, state): what is known of each request,
            # for its ring entry.  Mid-prefill rids are in _admitting too.
            pending = [(rid, req, t, None) for rid, req, t in self._queue]
            pending += [(rid, None, None, None) for rid in self._admitting
                        if rid not in self._prefilling]
            pending += [(p.rid, p.req, p.t_submit, None)
                        for p in self._prefilling.values()]
            pending += [(s.rid, None, None, s) for s in self._slots.values()]
            pending += [(p.state.rid, None, None, p.state)
                        for p in self._parked.values()]
            self._prefilling.clear()
            for rid in list(self._parked):
                self._drop_parked_locked(rid)
            for slot in sorted(set(self._slots) | set(
                    self._admitting.values())):
                self._release_slot_locked(slot)
            self._queue.clear()
            self._slots.clear()
            self._admitting.clear()
            for rid, req, t_sub, state in pending:
                self._fail_locked(rid, kind, message, req=req,
                                  t_submit=t_sub, state=state)
            self._cancelled.clear()
        self._drain_fail_obs()

    def drain(self) -> None:
        """Stop admitting; queued and active requests, and a chunk in
        flight, run to the end."""
        with self._lock:
            self._draining = True

    def in_flight(self) -> int:
        """Queued + admitting + active + parked + slot-free requests: what
        a drain waits on (a parked request still owes its client
        tokens)."""
        with self._lock:
            return (len(self._queue) + len(self._admitting) + len(self._slots)
                    + len(self._parked) + self._aux_active)

    def pending(self) -> bool:
        with self._lock:
            # A prompt mid-way through chunked prefill keeps the loop
            # stepping (its segments dispatch from admission waves), as
            # do staged prefix installs, parked slots and demotions in
            # flight: the step lands installs, completes demotions and
            # restores parked slots.
            return bool(self._queue or self._slots or self._prefilling
                        or self._prefix_installs or self._parked
                        or self._pending_host_writes)

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

    # -- slot-free work: embeddings and beam search ---------------------------

    @contextmanager
    def _aux_request(self):
        """Drain-aware guard for slot-free work (embed, beam): refused
        while draining or after a crash, counted in ``in_flight`` while
        it runs."""
        with self._lock:
            if self._fatal is not None:
                raise EngineFailedError(f"engine failed: {self._fatal}")
            if self._draining:
                raise DrainingError("engine is draining; not admitting")
            self._aux_active += 1
        try:
            yield
        finally:
            with self._lock:
                self._aux_active -= 1

    def _fetch_aux(self, tensor: torch.Tensor) -> np.ndarray:
        """One readback of slot-free work, counted with the chunks'."""
        host = tensor.cpu().numpy()
        if not self._warming:
            with self._lock:
                self.readbacks += 1
        return host

    @torch.no_grad()
    def embed(self, tokens: list[int]) -> list[float]:
        """Mean-pooled, L2-normalized final hidden state of ``tokens``
        (``models/decode.py::embed_tokens``), padded to its prompt
        bucket.  Stateless and slot-free: it touches neither the cache
        nor the queue, so any thread may call it while the step thread
        runs; it runs the plain solo path, as the reference's does.  Under
        a mesh every rank runs the pass on its shard (a record) and the
        leader reads the result; the step loop's dispatches wait for it."""
        with self._aux_request():
            self._validate(GenRequest(tokens=tokens, max_new_tokens=1))
            padded = np.zeros((1, self._bucket(len(tokens))), np.int64)
            padded[0, : len(tokens)] = tokens
            vec = self._dev("_embed_pass", padded, len(tokens))
            return [float(x) for x in self._fetch_aux(vec[0])]

    def _embed_pass(self, padded: np.ndarray, n: int) -> torch.Tensor:
        """``embed``'s device half, from host inputs: the pooled vector
        [1, d_model] on the device."""
        return embed_tokens(
            self.params, _to_device(padded, self.device),
            torch.tensor([n], device=self.device), self._run_cfg)

    def beam(self, tokens: list[int], max_new_tokens: int,
             beam_size: int = 4, alpha: float = 0.6,
             eos_id: int | None = None) -> tuple[list[int], float]:
        """Latency-mode beam search on the engine's model: (generated
        tokens of the best hypothesis, its normalized score).  Beam-k
        keeps k interdependent hypotheses whose cache rows reorder every
        step, so it runs ``models/beam.py`` on the plain solo path, not
        the slot machinery; like ``embed`` it is stateless and slot-free.
        Beam-1 is the engine's greedy output.

        Validation is beam-specific: the slot engine's prompt buckets
        and speculative headroom do not apply (beam builds its own cache
        of ``len(tokens) + max_new_tokens`` rows), but ``max_len`` still
        bounds the total as the server's memory policy, ``beam_size`` is
        capped (the cache replicates across the beams), and the
        per-configuration state is bounded as the reference bounds its
        compiled programs: a FIFO of ``_MAX_BEAM_PROGRAMS`` search
        functions over client-chosen (beam_size, alpha, eos_id), and a
        budget of ``_MAX_BEAM_TRACES`` (configuration, prompt length,
        max_new) shapes, past which both are cleared.  Under a mesh every
        rank runs the search on its shard (a record): the top-k over the
        gathered logits is the same on every rank, so they stay in
        lockstep with no traffic, and the leader alone reads the winner;
        the step loop's dispatches wait for the whole search."""
        with self._aux_request():
            return self._beam_inner(tokens, max_new_tokens, beam_size,
                                    alpha, eos_id)

    def _beam_inner(self, tokens, max_new_tokens, beam_size, alpha,
                    eos_id) -> tuple[list[int], float]:
        if not tokens:
            raise ValueError("prompt must be non-empty")
        if max_new_tokens < 1:
            raise ValueError(
                f"need max_new_tokens >= 1, got {max_new_tokens}"
            )
        bad = [t for t in tokens if not 0 <= t < self.cfg.vocab_size]
        if bad:
            raise ValueError(
                f"token ids out of range [0, {self.cfg.vocab_size}): "
                f"{bad[:5]}"
            )
        if len(tokens) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {len(tokens)} + max_new_tokens {max_new_tokens} "
                f"exceeds max_len {self.max_len}"
            )
        if not 1 <= beam_size <= _MAX_BEAM_SIZE:
            raise ValueError(
                f"beam_size must be in [1, {_MAX_BEAM_SIZE}], "
                f"got {beam_size}"
            )
        alpha = float(alpha)
        if not math.isfinite(alpha):
            # NaN would also poison the cache key (nan != nan).
            raise ValueError(f"alpha must be finite, got {alpha}")
        self._beam_fn(beam_size, alpha, eos_id, len(tokens), max_new_tokens)
        best, stats = best_hypothesis(*self._dev(
            "_beam_pass", tokens, max_new_tokens, beam_size, alpha, eos_id))
        generated = [int(t) for t in self._fetch_aux(best)]
        if eos_id is not None:
            # Past the winner's EOS come 0-pads: trim to the generation,
            # the EOS included (GenRequest's eos semantics).
            generated = generated[: stats["length"]]
        return generated, stats["normalized_score"]

    def _beam_fn(self, beam_size: int, alpha: float, eos_id, n_prompt: int,
                 max_new_tokens: int) -> None:
        """Check the search configuration (beam_size, alpha, eos_id) and
        keep it under the bounds ``beam`` states, as the reference keeps
        its compiled programs; every rank runs the search itself through
        ``_beam_pass``."""
        key = (beam_size, alpha, eos_id)
        with self._beam_lock:
            if len(self._beam_traces) >= _MAX_BEAM_TRACES:
                self._beam_fns.clear()
                self._beam_traces.clear()
            if key not in self._beam_fns:
                while len(self._beam_fns) >= _MAX_BEAM_PROGRAMS:
                    evicted = next(iter(self._beam_fns))
                    self._beam_fns.pop(evicted)
                    self._beam_traces = {t for t in self._beam_traces
                                         if t[0] != evicted}
                self._beam_fns[key] = make_beam_search_fn(
                    self._run_cfg, beam_size=beam_size, alpha=alpha,
                    eos_id=eos_id,
                )
            self._beam_traces.add((key, n_prompt, max_new_tokens))

    def _beam_pass(self, tokens, max_new_tokens, beam_size, alpha,
                   eos_id) -> tuple:
        """``beam``'s device half, from host inputs: the search on this
        rank's shard, its beams left on the device (``beam_steps``; a
        follower reads nothing back)."""
        return beam_steps(
            self.params, torch.as_tensor([tokens], device=self.device),
            self._run_cfg, max_new_tokens, beam_size, alpha, eos_id)

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
                "usable_len": self._usable_len,
                "chunk": self.chunk,
                "prompt_buckets": list(self.prompt_buckets),
                "max_queue": self.max_queue,
                "top_k": self.top_k,
                "default_top_p": self.default_top_p,
                "kv_int8": self.kv_int8,
                "kv_int4": self.kv_int4,
                "kv_quant": self.kv_quant,
                "weights_int8": self.weights_int8,
                "weight_quant": self.weight_quant,
                "spec_decode": self.spec_decode,
                "spec_draft_model": self.draft_cfg is not None,
                "draft_n_layers": (
                    self.draft_cfg.n_layers if self.draft_cfg else 0
                ),
                "draft_d_model": (
                    self.draft_cfg.d_model if self.draft_cfg else 0
                ),
                "penalties": self.penalties,
                "prefix_cache_size": self.prefix_cache_size,
                "prefill_chunk": self.prefill_chunk,
                "pipeline_depth": self.pipeline_depth,
                "paged": self.paged,
                "kv_block": self.kv_block,
                "kv_blocks": self.kv_blocks,
                "kv_host_bytes": self.kv_host_bytes,
                "kv_host_blocks": (
                    self._host.n_blocks if self._host else 0
                ),
                "kv_park": self.kv_park,
                # Whether a tenant policy is loaded: without one,
                # admission is FIFO and nothing preempts.
                "qos": self._qos_policy is not None,
                "device": str(self.device),
                "attention": self._attention_path(),
                "paged_kernel": self.paged_kernel,
                "prefill_kernel": self.prefill_kernel,
                "cuda_graphs": self.cuda_graphs,
                "tp": self.mesh.shape.get("tp", 1) if self.mesh else 1,
                "ep": self.mesh.shape.get("ep", 1) if self.mesh else 1,
            },
        }

    def _attention_path(self) -> str:
        """What attends: "cuda-kernels" (K1/K2 on every pass), "plain"
        (no kernel launches: the CPU, or both switches off) or "mixed"."""
        on = {self.paged_kernel, self.prefill_kernel}
        if self.device.type != "cuda" or on == {False}:
            return "plain"
        return "cuda-kernels" if on == {True} else "mixed"

    def stats(self) -> dict:
        with self._lock:
            ttfts = list(self._ttfts)
            return {
                "active_slots": len(self._slots),
                "free_slots": len(self._free),
                "queued": len(self._queue),
                "steps": self.steps,
                "tokens_generated": self.tokens_generated,
                "prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses,
                "prefix_injects": self.prefix_injects,
                "prefix_entries": len(self._prefix_cache),
                "prefix_evictions": self.prefix_evictions,
                # KV bytes of the aliased full blocks (paged hits): what a
                # dense engine copies into the slot.  0 on a dense engine.
                "prefix_bytes_saved": self.prefix_bytes_saved,
                "kv_block_size": self.kv_block,
                "kv_blocks_total": self.kv_blocks,
                "kv_blocks_free": (
                    self._alloc.free_blocks if self.paged else 0
                ),
                "kv_blocks_used": (
                    self._alloc.used_blocks if self.paged else 0
                ),
                "kv_blocks_shared": (
                    self._alloc.shared_blocks if self.paged else 0
                ),
                "kv_admit_deferrals": self.kv_admit_deferrals,
                # Fleet prefix residency: the resident digests (hottest
                # first, capped), entries installed from shipped
                # exports, exports served, installs still staged.
                "prefix_digests": self._prefix_digest_summary_locked(
                    PREFIX_DIGEST_CAP
                ),
                "prefix_fetch_installs": self.prefix_fetch_installs,
                "prefix_exports": self.prefix_exports,
                "prefix_installs_staged": len(self._prefix_installs),
                # The host-RAM tier (zeros without kv_host_bytes): its
                # occupancy, movements each way in blocks, bytes and
                # walls, parks and restores, and the prefix shortfall's
                # demote-or-evict split.
                "kv_host_bytes": self.kv_host_bytes,
                "kv_host_blocks_total": (
                    self._host.n_blocks if self._host else 0
                ),
                "kv_host_blocks_free": (
                    self._host.alloc.free_blocks if self._host else 0
                ),
                "kv_host_blocks_used": (
                    self._host.alloc.used_blocks if self._host else 0
                ),
                "kv_host_fragmentation": (
                    self._kv_host_fragmentation_locked()
                ),
                "host_prefix_entries": len(self._host_prefix),
                "parked_slots": len(self._parked),
                "kv_park": self.kv_park,
                "kv_demotions": self.kv_demotions,
                "kv_promotions": self.kv_promotions,
                "kv_parks": self.kv_parks,
                "kv_unparks": self.kv_unparks,
                "kv_demote_bytes": self.kv_demote_bytes,
                "kv_promote_bytes": self.kv_promote_bytes,
                "kv_demote_seconds": self.kv_demote_seconds,
                "kv_promote_seconds": self.kv_promote_seconds,
                "kv_promote_wall_p50": (
                    statistics.median(self._promote_walls)
                    if self._promote_walls else 0.0
                ),
                "prefix_demotions": self.prefix_demotions,
                # KV shipping (zeros on a dense engine) and live-slot
                # migration: records awaiting export pin their blocks
                # until shipped, released or swept.
                "kv_holds": len(self._kv_holds),
                "kv_imports_staged": len(self._kv_imports),
                "kv_exports": self.kv_exports,
                "kv_imports": self.kv_imports_total,
                "kv_ship_bytes": self.kv_ship_bytes,
                "migrated_slots": len(self._migrated),
                "slot_exports": self.slot_exports,
                "slot_imports": self.slot_imports,
                "kv_quant": self.kv_quant,
                # Host clock around work that ends in a device readback,
                # so these are device-inclusive walls (but for a wave
                # that only writes segments, which reads nothing back).
                "prefill_seconds": self.prefill_seconds,
                "decode_seconds": self.decode_seconds,
                "decode_tokens": self.decode_tokens,
                "prefill_dispatches": self.prefill_dispatches,
                "prefill_chunk": self.prefill_chunk,
                "prefill_segments": self.prefill_segments,
                "prefilling": len(self._prefilling),
                "decode_passes": self.decode_passes,
                "decode_dispatches": self.decode_dispatches,
                "graph_replays": self.graph_replays,
                "admission_replays": self.admission_replays,
                "admission_graphs": len(self._admit_graphs),
                "spec_drafted": self.spec_drafted,
                "spec_accepted": self.spec_accepted,
                "draft_passes": self.draft_passes,
                "draft_prefill_dispatches": self.draft_prefill_dispatches,
                "draft_admission_replays": self.draft_admission_replays,
                "draft_admission_graphs": len(self._draft_graphs),
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
                # Captures after warmup the recompile sentinel charged
                # to this engine, and the attention path of each kind.
                "recompiles": self.recompiles,
                "paged_kernel": self.paged_kernel,
                "prefill_kernel": self.prefill_kernel,
                "admission_capture_seconds": self.admission_capture_seconds,
                "pipeline_depth": self.pipeline_depth,
                "inflight_dispatches": int(self._inflight is not None),
                "ttft_p50_s": statistics.median(ttfts) if ttfts else 0.0,
                "kernel_counts": paged_attention.counters(),
                # Overload forensics: the watchdog's baseline, the
                # Retry-After denominator, the sheds by reason and the
                # live brownout state (with traffic stopped the pressure
                # clock resets only at the next submit, so the queue is
                # read here too).
                "chunk_wall_ewma": round(self._chunk_wall_ewma or 0.0, 6),
                "token_rate": round(self._token_rate_ewma or 0.0, 2),
                "shed_queue_full": self._shed_counts["queue_full"],
                "shed_deadline": self._shed_counts["deadline"],
                "shed_brownout": self._shed_counts["brownout"],
                "brownout_active": self._brownout_locked(),
                "ring_dropped": self.ring_dropped,
                "slow_captures": self.slow_captures,
                "kv_fragmentation": self._kv_fragmentation_locked(),
                # Multi-tenant QoS: whether a policy is enforced, the
                # admissions that parked a victim, and the per-tenant
                # live and cumulative rows.
                "qos": self._qos_policy is not None,
                "qos_preemptions": self.qos_preemptions,
                "tenants": self._tenant_snapshot_locked(),
                "fatal": self._fatal,
            }

    def _brownout_locked(self) -> bool:
        """Whether brownout clamps submissions now (lock held)."""
        return bool(self.brownout_max_tokens
                    and self._pressure_since is not None
                    and len(self._queue) >= self._brownout_at)

    def _kv_fragmentation_locked(self) -> float:
        """Allocated-but-idle share of the used pool rows (lock held):
        0.0 when every used block row holds live KV, 1.0 when all are
        padding.  Approximate under sharing (an aliased row counts once a
        reader); a block-size tuning signal."""
        if not self.paged or not self._alloc.used_blocks:
            return 0.0
        live = sum(len(s.req.tokens) + len(s.emitted)
                   for s in self._slots.values()) + sum(
            rows for _, rows in self._prefix_cache.values())
        used_rows = self._alloc.used_blocks * self.kv_block
        return round(max(0.0, 1.0 - live / used_rows), 4)

    def load(self) -> dict:
        """The live-pressure snapshot under the reference's keys (its
        ``load/<id>`` registry value and ``/v1/info``'s ``load``): busy
        work is ``queue_depth + active_slots`` over ``total_slots``, the
        ``kv_blocks_*`` the pool's headroom (zeros on the dense cache),
        then the host tier's, the ships', the prefix residency, the sheds,
        the tenants and the drain and brownout states."""
        with self._lock:
            return {
                "queue_depth": len(self._queue),
                "active_slots": len(self._slots),
                "total_slots": self.n_slots,
                "kv_blocks_total": self.kv_blocks,
                "kv_blocks_free": (
                    self._alloc.free_blocks if self.paged else 0
                ),
                "kv_blocks_shared": (
                    self._alloc.shared_blocks if self.paged else 0
                ),
                "kv_fragmentation": self._kv_fragmentation_locked(),
                "kv_host_blocks_total": (
                    self._host.n_blocks if self._host else 0
                ),
                "kv_host_blocks_free": (
                    self._host.alloc.free_blocks if self._host else 0
                ),
                "kv_host_fragmentation": (
                    self._kv_host_fragmentation_locked()
                ),
                "kv_demotions": self.kv_demotions,
                "kv_promotions": self.kv_promotions,
                "parked_slots": len(self._parked),
                "prefix_demotions": self.prefix_demotions,
                "prefix_evictions": self.prefix_evictions,
                "kv_parks": self.kv_parks,
                "kv_unparks": self.kv_unparks,
                "kv_demote_seconds": round(self.kv_demote_seconds, 6),
                "kv_promote_seconds": round(self.kv_promote_seconds, 6),
                "kv_demote_bytes": self.kv_demote_bytes,
                "kv_promote_bytes": self.kv_promote_bytes,
                # Whether the decode passes and the admissions take the
                # kernel wrappers (the caller's switch, resolved).
                "paged_kernel": self.paged_kernel,
                "kv_int4": self.kv_int4,
                "prefill_kernel": self.prefill_kernel,
                "prefill_chunk": self.prefill_chunk,
                "prefill_segments": self.prefill_segments,
                "kv_exports": self.kv_exports,
                "kv_imports": self.kv_imports_total,
                "kv_ship_bytes": self.kv_ship_bytes,
                "prefix_digests": self._prefix_digest_summary_locked(
                    PREFIX_DIGEST_CAP
                ),
                "prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses,
                "token_rate": round(self._token_rate_ewma or 0.0, 2),
                "shed_queue_full": self._shed_counts["queue_full"],
                "shed_deadline": self._shed_counts["deadline"],
                "shed_brownout": self._shed_counts["brownout"],
                "tenants": self._tenant_snapshot_locked(),
                "qos_preemptions": self.qos_preemptions,
                "draining": bool(self._draining),
                "brownout": self._brownout_locked(),
                "ts": time.time(),
            }

    def _update_load_gauges_locked(self) -> None:
        """The per-engine load gauges from ground truth (lock held):
        active slots, queue depth and, paged, the pool by block state."""
        label = self._engine_label
        _metrics.SERVE_ACTIVE_SLOTS.set(float(len(self._slots)), label)
        _metrics.SERVE_QUEUE_DEPTH.set(float(len(self._queue)), label)
        if self.paged:
            for state, n in (("free", self._alloc.free_blocks),
                             ("used", self._alloc.used_blocks),
                             ("shared", self._alloc.shared_blocks)):
                _metrics.SERVE_KV_BLOCKS.set(float(n), label, state)
            if self._host is not None:
                _metrics.SERVE_KV_BLOCKS.set(
                    float(self._host.alloc.used_blocks), label, "host")

    # -- request observation --------------------------------------------------

    def requests(self) -> dict:
        """The recently completed request ring, oldest first, each entry
        with its phase durations, and the drop-oldest eviction count."""
        with self._ring_lock:
            return {
                "requests": [dict(e) for e in self._ring],
                "dropped": self.ring_dropped,
            }

    def _finalize_request(self, rid: int, req: GenRequest | None,
                          phases: _PhaseTrace | None, outcome: str,
                          tokens_out: int, t_end: float) -> None:
        """Record one request's story: the ``engine.request`` span (a
        child of ``req.span``) with a child a phase and one
        ``engine.decode`` span a chunk, the ring entry, the per-tenant
        histograms and tokens, and a slow capture where due.  Never with
        the engine lock held; host clock arithmetic only, nothing of the
        device.  ``t_end`` is the last chunk's completion (the stream
        phase runs from it to now)."""
        if self._warming:
            return
        t_fin = time.monotonic()
        tenant = (req.tenant if req is not None else "") or "anon"
        parent = req.span if req is not None else None
        # Phase instants ride the monotonic clock; one offset converts
        # them to the wall-clock nanoseconds spans carry.
        off = time.time_ns() - int(time.monotonic() * 1e9)

        def ns(t: float) -> int:
            return int(t * 1e9) + off

        t0 = phases.t_submit if phases is not None else t_fin
        root = _tracing.record_span(
            "engine.request",
            component="engine",
            trace_id=parent.trace_id if parent else "",
            parent_id=parent.span_id if parent else "",
            start_ns=ns(t0),
            end_ns=ns(t_fin),
            status="ok" if outcome == "ok" else f"error: {outcome}",
            rid=rid,
            tenant=tenant,
            outcome=outcome,
            tokens_in=len(req.tokens) if req is not None else 0,
            tokens_out=tokens_out,
        )

        def child(name: str, a: float, b: float, **attrs) -> None:
            _tracing.record_span(
                name, component="engine", trace_id=root.trace_id,
                parent_id=root.span_id, start_ns=ns(a), end_ns=ns(b),
                **attrs,
            )

        queue_s = admit_s = prefill_s = decode_s = stream_s = 0.0
        chunk_count = 0
        if phases is not None:
            t_admit = phases.t_admitted or t_fin
            queue_s = max(0.0, t_admit - phases.t_submit)
            child("engine.queue", phases.t_submit, t_admit)
            if phases.t_admitted and phases.t_prefill:
                admit_s = max(0.0, phases.t_prefill - phases.t_admitted)
                child("engine.admit", phases.t_admitted, phases.t_prefill)
            if phases.t_prefill and phases.t_first:
                prefill_s = max(0.0, phases.t_first - phases.t_prefill)
                child("engine.prefill", phases.t_prefill, phases.t_first)
            for seq, a, b, ntok, disp, fetch in phases.chunks:
                decode_s += max(0.0, b - a)
                child("engine.decode", a, b, chunk=seq, tokens=ntok,
                      dispatch_wait_s=round(disp, 6),
                      fetch_wait_s=round(fetch, 6))
            chunk_count = len(phases.chunks)
            if outcome == "ok" and phases.t_first:
                stream_s = max(0.0, t_fin - t_end)
                child("engine.stream", t_end, t_fin)
        e2e_s = max(0.0, t_fin - t0)
        entry = {
            "rid": rid,
            "tenant": tenant,
            "tier": self._qos_lookup(tenant).tier,
            "trace": root.trace_id,
            "outcome": outcome,
            "queue_s": round(queue_s, 6),
            "admit_s": round(admit_s, 6),
            "prefill_s": round(prefill_s, 6),
            "decode_s": round(decode_s, 6),
            "stream_s": round(stream_s, 6),
            "e2e_s": round(e2e_s, 6),
            "chunks": chunk_count,
            "tokens_in": len(req.tokens) if req is not None else 0,
            "tokens_out": tokens_out,
            "prefix": (phases.prefix_source if phases is not None
                       else "recomputed"),
            "prefill_segments": (phases.prefill_segments
                                 if phases is not None else 0),
            "segment_walls": ([round(w, 6) for w in phases.segment_walls]
                              if phases is not None else []),
            "ts": time.time(),
        }
        with self._ring_lock:
            if self._ring.maxlen == 0 or len(self._ring) == self._ring.maxlen:
                self.ring_dropped += 1
                _metrics.SERVE_REQUEST_RING_DROPPED.inc(self._engine_label)
            if self._ring.maxlen:
                self._ring.append(entry)
        _metrics.SERVE_E2E.observe(e2e_s, tenant, outcome)
        if tokens_out:
            _metrics.SERVE_TENANT_TOKENS.inc(tenant, by=float(tokens_out))
        with self._lock:
            row = self._tenant_row_locked(tenant)
            row["requests"] += 1
            row["tokens_out"] += tokens_out
            row["ts"] = time.time()
        if phases is not None and phases.t_admitted:
            _metrics.SERVE_QUEUE_WAIT.observe(queue_s, tenant)
        if prefill_s > 0.0:
            _metrics.SERVE_PREFILL.observe(prefill_s, tenant)
        if chunk_count and tokens_out > 1:
            _metrics.SERVE_TPOT.observe(decode_s / (tokens_out - 1), tenant)
        self._maybe_slow_capture(entry, phases)

    def _maybe_slow_capture(self, entry: dict,
                            phases: _PhaseTrace | None) -> None:
        """Dump a slow request's story to the flight dir before anyone
        asks: its ring entry, per-chunk phase records, a ``stats()``
        snapshot and the ring it finished among.  Triggers: the e2e
        threshold, or a marginal TPOT past a multiple of the token-rate
        EWMA.  At most one artifact an interval, and best-effort: a full
        disk never fails a request that was merely slow."""
        trigger = ""
        if self._slow_e2e_s and entry["e2e_s"] >= self._slow_e2e_s:
            trigger = "e2e"
        elif self._slow_tpot_mult and entry["chunks"]:
            tokens_out = entry["tokens_out"]
            rate = self._token_rate_ewma or 0.0
            if tokens_out > 1 and rate > 0.0:
                tpot = entry["decode_s"] / (tokens_out - 1)
                if tpot * rate >= self._slow_tpot_mult:
                    trigger = "tpot"
        if not trigger:
            return
        now = time.monotonic()
        if (self._slow_last_capture
                and now - self._slow_last_capture < self._slow_interval_s):
            return
        self._slow_last_capture = now
        with self._ring_lock:
            neighborhood = list(self._ring)[-16:]
        artifact = {
            "kind": "slow_capture",
            "trigger": trigger,
            "thresholds": {
                "e2e_s": self._slow_e2e_s,
                "tpot_mult": self._slow_tpot_mult,
                "token_rate_ewma": round(self._token_rate_ewma or 0.0, 2),
            },
            "entry": entry,
            "chunks": [
                {"seq": seq, "wall_s": round(max(0.0, b - a), 6),
                 "tokens": ntok, "dispatch_wait_s": round(disp, 6),
                 "fetch_wait_s": round(fetch, 6)}
                for seq, a, b, ntok, disp, fetch in (
                    phases.chunks if phases is not None else ())
            ],
            "stats": self.stats(),
            "ring": neighborhood,
        }
        path = os.path.join(
            _events.flight_dir(),
            f"oim-slowcap-{os.getpid()}-{entry['rid']}-"
            f"{int(time.time())}.json",
        )
        try:
            tmp = f"{path}.tmp"
            with open(tmp, "w") as f:
                json.dump(artifact, f, indent=1)
            os.replace(tmp, path)
        except OSError:
            return
        self.slow_captures += 1
        _metrics.SERVE_SLOW_CAPTURES.inc(self._engine_label, trigger)
        _events.emit(
            "serve.slow_capture",
            component="serve",
            severity=_events.WARNING,
            subject=str(entry["rid"]),
            trigger=trigger,
            tenant=entry["tenant"],
            e2e_s=entry["e2e_s"],
            decode_s=entry["decode_s"],
            tokens_out=entry["tokens_out"],
            path=path,
        )

    def _drain_fail_obs(self) -> None:
        """Finalize the failures ``_fail_locked`` queued: every failure
        site calls this right after it drops the engine lock."""
        with self._lock:
            if not (self._fail_obs or self._ended):
                return
            pending, self._fail_obs = self._fail_obs, []
            ended, self._ended = self._ended, []
        now = time.monotonic()
        for rid, req, phases, kind, tokens_out in pending:
            self._finalize_request(rid, req, phases, kind, tokens_out, now)
        for on_token in ended:  # the end of each failed request's stream
            on_token(None, None)

    @staticmethod
    def _deliver(notices) -> None:
        """Stream emitted tokens, off the lock: ``notices`` holds
        (on_token, [(token, logprob), ...], done) in emission order; a
        done stream's end follows its last token."""
        for on_token, fresh, done in notices:
            for token, logprob in fresh:
                on_token(token, logprob)
            if done:
                on_token(None, None)

    def _finalize_done(self, finished: list[_SlotState]) -> None:
        """Finalize this step's completed requests (off the lock, after
        their results were published)."""
        for state in finished:
            phases = state.phases
            t_end = 0.0
            if phases is not None:
                t_end = (phases.chunks[-1][2] if phases.chunks
                         else phases.t_first) or phases.t_submit
            self._finalize_request(state.rid, state.req, phases, "ok",
                                   len(state.emitted), t_end)

    def _watch_begin(self) -> None:
        """Open a device-wait window: the step thread is about to block
        on the device (a chunk's or an admission's readback)."""
        with self._lock:
            self._device_wait_since = time.monotonic()

    def _watch_end(self) -> None:
        with self._lock:
            self._device_wait_since = None

    def watchdog_state(self) -> tuple[float | None, float | None]:
        """(seconds the step thread has waited on the device in its
        current wait, None when not waiting; the typical chunk wall EWMA,
        None before the first chunk).  The stall watchdog's read
        surface; any thread."""
        now = time.monotonic()
        with self._lock:
            since = self._device_wait_since
            return (None if since is None else max(0.0, now - since),
                    self._chunk_wall_ewma)

    def retry_after_s(self) -> int:
        """Back-off hint for 429 and 503 answers: seconds until the
        backlog (queued budgets and the active and parked slots'
        remaining ones) drains at the observed marginal token rate; 5
        before any chunk, clamped to [1, 120]."""
        with self._lock:
            backlog = sum(req.max_new_tokens for _, req, _ in self._queue)
            backlog += sum(max(0, s.req.max_new_tokens - len(s.emitted))
                           for s in self._slots.values())
            backlog += sum(max(0, p.state.req.max_new_tokens
                               - len(p.state.emitted))
                           for p in self._parked.values())
            rate = self._token_rate_ewma
        if rate is None or rate <= 0.0:
            return 5
        return max(1, min(120, int(backlog / rate) + 1))

    # -- multi-tenant QoS -----------------------------------------------------

    def set_qos_policy(self, policy) -> None:
        """Swap the tenant policy (None turns QoS off).  Accounting rows
        take their new tier and weight; virtual times carry over, so a
        reload does not reset the fairness ledger mid-backlog."""
        with self._lock:
            self._qos_policy = policy
            for name, row in self._tenants.items():
                pol = self._qos_lookup(name)
                row["tier"] = pol.tier
                row["weight"] = pol.effective_weight

    def _qos_lookup(self, tenant: str):
        return (self._qos_policy or _QOS_DEFAULT).lookup(tenant)

    def _tenant_row_locked(self, tenant: str) -> dict:
        """``tenant``'s accounting row (lock held), made on first
        contact at the lowest virtual time there is (starting at zero
        would give a tenant that stayed idle unbounded credit)."""
        row = self._tenants.get(tenant)
        if row is None:
            pol = self._qos_lookup(tenant)
            floor = min((r["vtime"] for r in self._tenants.values()),
                        default=0.0)
            if len(self._tenants) >= _MAX_TENANT_ROWS:
                stale = min(self._tenants,
                            key=lambda t: self._tenants[t]["ts"])
                del self._tenants[stale]
            row = {
                "tier": pol.tier,
                "weight": pol.effective_weight,
                "vtime": floor,
                "admitted": 0,
                "preempted": 0,
                "parked_victim": 0,
                "requests": 0,
                "tokens_out": 0,
                "ts": time.time(),
            }
            self._tenants[tenant] = row
        return row

    def _qos_head_locked(self) -> int:
        """Index in ``self._queue`` of the next admission candidate: 0
        with no policy (FIFO); with one, stride scheduling — each
        tenant's requests stay FIFO among themselves, and the tenant
        whose virtual time lags most admits next (ties to arrival).  The
        admission loop keeps head-of-line backpressure on the head it
        picks.  Warmup's dummies (all anon) admit FIFO and touch no
        accounting row: the reference's head pick makes an anon row at
        virtual time 0 there, which then floors every newcomer's."""
        if (self._qos_policy is None or self._warming
                or len(self._queue) < 2):
            return 0
        best_i, best_key = 0, None
        seen: set[str] = set()
        for i, (rid, req, t_sub) in enumerate(self._queue):
            tenant = req.tenant or "anon"
            if tenant in seen:
                continue  # only each tenant's own head competes
            seen.add(tenant)
            row = self._tenant_row_locked(tenant)
            key = (row["vtime"], t_sub, rid)
            if best_key is None or key < best_key:
                best_i, best_key = i, key
        return best_i

    def _qos_charge_locked(self, req: GenRequest) -> None:
        """Account one granted admission (lock held, the request off the
        queue): its worst-case tokens over its tenant's weight advance
        the tenant's virtual time, from no lower than the backlog's
        lowest (an idle tenant banks no credit, carries no debt).
        Warmup's dummies touch nothing."""
        if self._warming:
            return
        tenant = req.tenant or "anon"
        row = self._tenant_row_locked(tenant)
        if self._qos_policy is not None:
            backlog = {r.tenant or "anon" for _, r, _ in self._queue}
            floor = min((self._tenants[t]["vtime"] for t in backlog
                         if t in self._tenants), default=row["vtime"])
            charge = float(max(1, len(req.tokens) + req.max_new_tokens))
            row["vtime"] = (max(row["vtime"], floor)
                            + charge / max(row["weight"], 1e-9))
        row["admitted"] += 1
        row["ts"] = time.time()
        _metrics.SERVE_QOS.inc(row["tier"], "admitted")

    def _qos_preempt_pending_locked(self) -> bool:
        """Would the slot-shortage preemption act now (lock held)?  The
        pipeline-boundary predicate asks: queued work with no free slot
        forces no boundary, except when the fair-share head could park a
        lower-priority slot — else a saturated engine pipelines past
        every preemption and premium waits out the flood.  A pure read:
        ``_qos_preempt_locked``'s checks without the park."""
        if self._qos_policy is None or not self._queue or self._free:
            return False
        if not self.kv_park:
            return False
        _, req, _ = self._queue[self._qos_head_locked()]
        prio = self._qos_lookup(req.tenant or "anon").priority
        if prio <= 0:
            return False
        return self._pick_park_victim_locked(prio) is not None

    def _qos_preempt_locked(self) -> bool:
        """Slot-shortage priority preemption (lock held, admission
        boundary, no free slot): park one slot of strictly lower priority
        than the fair-share head's tenant, so that the admission loop can
        run.  Equal tiers never preempt each other.  True when a victim
        was parked."""
        if not self._queue or self._free:
            return False
        _, req, _ = self._queue[self._qos_head_locked()]
        prio = self._qos_lookup(req.tenant or "anon").priority
        if prio <= 0:
            return False
        return self._try_park_locked(req, below_priority=prio)

    def _tenant_snapshot_locked(self) -> dict:
        """Per-tenant live and cumulative rows (lock held): queued,
        active and parked counted from the queue, the slots and the
        parked set, the counters from the accounting rows."""
        queued: dict[str, int] = {}
        for _, req, _ in self._queue:
            t = req.tenant or "anon"
            queued[t] = queued.get(t, 0) + 1
        active: dict[str, int] = {}
        for state in self._slots.values():
            t = state.req.tenant or "anon"
            active[t] = active.get(t, 0) + 1
        parked: dict[str, int] = {}
        for rec in self._parked.values():
            t = rec.state.req.tenant or "anon"
            parked[t] = parked.get(t, 0) + 1
        out: dict[str, dict] = {}
        for name in set(self._tenants) | set(queued) | set(active) | set(
                parked):
            row = self._tenants.get(name, {})
            pol = self._qos_lookup(name)
            out[name] = {
                "tier": pol.tier,
                "weight": pol.effective_weight,
                "queued": queued.get(name, 0),
                "active": active.get(name, 0),
                "parked": parked.get(name, 0),
                "admitted": row.get("admitted", 0),
                "preempted": row.get("preempted", 0),
                "parked_victim": row.get("parked_victim", 0),
                "requests": row.get("requests", 0),
                "tokens_out": row.get("tokens_out", 0),
            }
        return out

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
            # The raise may have left a device-wait window open: close
            # it, or the watchdog would read a wait that already ended.
            self._watch_end()
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
                    self._update_load_gauges_locked()

    def run(self) -> dict[int, list[int]]:
        """Drain the queue and all active slots; returns {rid: tokens}
        for results not yet fetched."""
        while self.pending():
            self.step()
        with self._lock:
            return {rid: list(t) for rid, (t, _) in self._results.items()}

    @torch.no_grad()
    def warmup(self, embed: bool = False) -> "Engine":
        """Run one dummy request per prompt bucket (each that fits the
        pool): builds the kernels on first use and touches every prefill
        shape once before live traffic; on the GPU, captures every graph
        first (``_capture_graphs``: the decode chunk's, and admission's
        for every bucket and row class), so that no graph is captured
        after it.  ``embed`` also runs ``/v1/embed``'s forward once per
        bucket.  The body runs inside the recompile sentinel's warmup
        bracket, and the warmed engine arms itself there at the end: from
        then on a capture is a recompile (``serve/sentinel.py``)."""
        t0 = time.monotonic()
        self._warming = True
        _sentinel.begin_warmup()
        try:
            rids = []
            for b in self.prompt_buckets:
                max_new = min(2 * self.chunk, self._usable_len - b)
                if self._pool_blocks_needed(b, max_new) > self.kv_blocks:
                    continue
                rids.append(self.submit(
                    GenRequest(tokens=[0] * b, max_new_tokens=max_new)
                ))
            self.run()
            for rid in rids:
                self.result(rid, timeout=0)
            if embed:
                for b in self.prompt_buckets:
                    if b < self._usable_len:
                        self.embed([0] * b)
            self._ensure_graphs()
            with self._lock:  # nothing of the dummies stays in the tier
                self._flush_host_tier_locked()
        finally:
            self._warming = False
            _sentinel.end_warmup()
        self.warmup_seconds = time.monotonic() - t0
        _sentinel.arm(self)
        return self

    def _release_slot_locked(self, slot: int) -> None:
        """Return ``slot`` and, paged, its refs on its blocks (an aliased
        prefix block stays with its other owners), resetting its table
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
        # A hold_kv request's blocks are retained for export BEFORE the
        # release decrefs them: the hold's own ref keeps them alive.
        if state.req.hold_kv and self.paged and not self._warming:
            self._hold_kv_locked(slot, state)
        self._release_slot_locked(slot)
        self._cancelled.discard(state.rid)
        if not self._warming:
            _metrics.SERVE_REQUESTS.inc("completed")
            _metrics.SERVE_TOKENS.inc(by=float(len(state.emitted)))
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
        state.park_immune = False  # progress made: parkable again
        if not self._warming:
            self.tokens_generated += 1
        if token == state.req.eos_id or token in state.req.stop_ids:
            return True
        state.last_token = token
        return len(state.emitted) >= state.req.max_new_tokens

    def _reap(self) -> None:
        """Fail cancelled and deadline-expired requests: queued ones
        before they touch a slot, active ones at this step (a chunk in
        flight skips their rows when it is read back), parked ones with
        their host blocks returned.  The KV-transfer TTLs are swept here
        too, so a ship whose orchestrator died returns its blocks without
        waiting for the next export or import."""
        now = time.monotonic()
        with self._lock:
            if self.paged and (self._kv_holds or self._kv_imports
                               or self._prefix_installs or self._migrated):
                self._sweep_kv_holds_locked(now)
                self._sweep_kv_imports_locked(now)
                self._sweep_prefix_installs_locked(now)
                self._sweep_migrated_locked(now)
            if not self._cancelled and not any(
                r.deadline is not None for _, r, _ in self._queue
            ) and not any(
                s.req.deadline is not None for s in self._slots.values()
            ) and not any(
                p.state.req.deadline is not None
                for p in self._parked.values()
            ):
                return
            keep = deque()
            for rid, req, t_sub in self._queue:
                if rid in self._cancelled:
                    self._fail_locked(rid, "cancelled", "client went away",
                                      req=req, t_submit=t_sub)
                elif req.deadline is not None and now >= req.deadline:
                    if not self._warming:
                        _metrics.SERVE_SHED.inc("deadline")
                        _metrics.SERVE_DEADLINE_EXPIRED.inc()
                        self._shed_counts["deadline"] += 1
                    self._fail_locked(
                        rid, "deadline_queue",
                        f"expired after {now - t_sub:.1f}s queued",
                        req=req, t_submit=t_sub,
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
                    if not self._warming:
                        _metrics.SERVE_DEADLINE_EXPIRED.inc()
                else:
                    continue
                self._slots.pop(slot)
                self._release_slot_locked(slot)
                self._fail_locked(state.rid, kind, msg, state=state)
            # A parked request keeps its deadline and can be cancelled:
            # a swap-out is invisible to the failure taxonomy.
            for rid in list(self._parked):
                state = self._parked[rid].state
                if rid in self._cancelled:
                    kind, msg = "cancelled", "client went away while parked"
                elif (state.req.deadline is not None
                      and now >= state.req.deadline):
                    kind = "deadline"
                    msg = (f"expired after {len(state.emitted)} tokens "
                           f"(parked in the host tier)")
                    if not self._warming:
                        _metrics.SERVE_DEADLINE_EXPIRED.inc()
                else:
                    continue
                self._drop_parked_locked(rid)
                self._fail_locked(rid, kind, msg, state=state)
        self._drain_fail_obs()

    @torch.no_grad()
    def _step_inner(self, acc: list) -> None:
        """One step: reap, reconcile the pipeline, admit, dispatch, emit.

        At ``pipeline_depth`` 2 the step dispatches chunk N+1 before
        reading back chunk N, so the device computes while the host reads
        back and emits.  Admissions join at pipeline boundaries: a step
        with queued work and a free slot first completes the chunk in
        flight (it still references every slot), then admits; queued
        work with no free slot forces no boundary, unless the fair-share
        head could preempt a lower-tier slot.  Tail elision: when
        the chunk in flight already covers every slot's remaining
        budget, a chained dispatch would be pure waste, so the step
        takes a boundary instead.  Depth 1 is the serial loop (every
        step is a boundary), token for token equal to depth 2.  First
        the demotions whose copies have landed become promotable entries
        and restorable parked slots; after the reap, a migrate-out drain
        suspends everything (``_migrate_wave``)."""
        self._complete_host_writes()
        self._reap()
        self._migrate_wave()
        with self._lock:
            elide_tail = (
                self._inflight is not None
                and self.pipeline_depth >= 2
                and all(st.req.max_new_tokens - len(st.emitted) <= self.chunk
                        for st in self._slots.values())
            )
            # A prompt mid-way through chunked prefill forces a boundary
            # too: its next segment dispatches only from an admission
            # wave, which never runs with a chunk in flight.
            # A pending priority preemption is an admission opportunity
            # too: the wave parks a lower-tier slot to make the free one.
            admit_boundary = (
                bool(self._queue) and (bool(self._free)
                                       or self._qos_preempt_pending_locked())
                or bool(self._prefilling))
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
            # A pending prefill advances at the next step's wave.
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

    # -- prefix cache ---------------------------------------------------------

    def _best_match_locked(self, entries, req: GenRequest) -> tuple:
        """THE prefix matching rule (lock held): the longest of
        ``entries`` — (key, (payload, rows)) pairs — usable for ``req``,
        as (key, usable rows) or (None, 0).  Usable is the entry's rows
        capped at ``len(req.tokens) - 1`` (one token must be prefilled to
        sample from), and the tail, bucketed, must still fit the slot's
        region.  One rule for both tiers, so promotion and aliasing hit
        on the same traffic."""
        best_key, best_usable = None, 0
        for key, (_, rows) in entries:
            usable = min(rows, len(req.tokens) - 1)
            if usable <= best_usable:
                continue
            if tuple(req.tokens[:usable]) == key[:usable]:
                tail_bucket = self._bucket(len(req.tokens) - usable)
                if usable + tail_bucket <= self.max_len:
                    best_key, best_usable = key, usable
        return best_key, best_usable

    def _best_prefix_locked(self, req: GenRequest) -> tuple:
        """The longest device-resident entry usable for ``req``."""
        return self._best_match_locked(self._prefix_cache.items(), req)

    def _count_prefix_locked(self, usable: int) -> None:
        """Count one admission's lookup as a hit or a miss."""
        if self._warming or not self.prefix_cache_size:
            return
        if usable:
            self.prefix_hits += 1
        else:
            self.prefix_misses += 1

    def _try_prefix_inject(self, slot: int, req: GenRequest) -> tuple:
        """Dense: copy the longest usable entry's rows into the head of
        ``slot``'s region; returns (where the tail prefill starts, the
        rows' source): (0, "recomputed") with no hit, else the entry's
        origin.  Exact, for MoE too: a KV row depends only on the tokens
        before it, and ``_moe_exact`` routes each token alone."""
        if not self.prefix_cache_size:
            return 0, "recomputed"
        with self._lock:
            key, usable = self._best_prefix_locked(req)
            self._count_prefix_locked(usable)
            if key is None:
                return 0, "recomputed"
            self._prefix_cache.move_to_end(key)  # LRU touch
            source = self._touch_prefix_meta_locked(key)
        self._dev("_inject_rows", slot, key)
        return usable, source

    def _inject_rows(self, slot: int, key: tuple) -> None:
        """Dense: copy prefix entry ``key``'s rows into the head of
        ``slot``'s region (step thread, the only one that retires dense
        entries)."""
        entry, _ = self._prefix_cache[key]
        cache = self._cache
        for dst, src in zip((cache.k, cache.v, cache.k_scale, cache.v_scale),
                            entry):
            if src is not None:
                dst[:, slot, : src.shape[1]].copy_(src)

    def _store_prefix(self, slot: int, req: GenRequest) -> None:
        """Cache ``slot``'s freshly prefilled prompt KV under
        ``req.tokens``.  Dense: a copy of the slot's bucketed rows (only
        the first ``len(tokens)`` are ever used).  Paged: one more ref on
        the blocks the prompt fully covers, no copy; never the partial
        last block, which this slot's decode writes next."""
        tokens = req.tokens
        tenant = req.tenant or "anon"
        key = tuple(tokens)
        if self.paged:
            full = len(tokens) // self.kv_block
            if full == 0:
                return  # nothing block-aligned to share
            with self._lock:
                blocks = tuple(int(b) for b in self._tables_host[slot][:full])
                if any(b >= self.kv_blocks for b in blocks):
                    return  # the slot was reclaimed meanwhile
                old = self._prefix_cache.pop(key, None)
                if old is not None:
                    self._alloc.decref(old[0])
                self._alloc.incref(blocks)
                self._prefix_cache[key] = (blocks, full * self.kv_block)
                self._set_prefix_meta_locked(key, full * self.kv_block,
                                             "local", tenant)
                self._trim_prefix_cache_locked()
            return
        rows = self._bucket(len(tokens))
        with self._turn():
            self._lead("_follow_store", slot, key, rows)
            entry = self._slot_rows(slot, rows)
        with self._lock:
            self._prefix_cache[key] = (entry, len(tokens))
            self._prefix_cache.move_to_end(key)
            self._set_prefix_meta_locked(key, len(tokens), "local", tenant)
            self._trim_prefix_cache_locked()

    def _slot_rows(self, slot: int, rows: int) -> tuple:
        """Dense: a copy of ``slot``'s first ``rows`` cache rows, one
        tensor a cache leaf (None where the leaf is)."""
        cache = self._cache
        return tuple(None if t is None else t[:, slot, :rows].clone()
                     for t in (cache.k, cache.v, cache.k_scale,
                               cache.v_scale))

    def _follow_store(self, slot: int, key: tuple, rows: int) -> None:
        """A follower's half of a dense prefix store: the same copy under
        the same key (the leader keeps the entry's host records)."""
        self._prefix_cache[key] = (self._slot_rows(slot, rows), rows)

    def _follow_drop(self, key: tuple) -> None:
        self._prefix_cache.pop(key, None)

    def _trim_prefix_cache_locked(self) -> None:
        """Count a store and retire least recently used entries past the
        size cap (lock held): demoted to the host tier where there is
        one, so a cache sized for hot entries keeps its warm tail
        promotable."""
        if not self._warming:
            self.prefix_injects += 1
        self._trim_to_size_locked()

    def _trim_to_size_locked(self) -> None:
        while len(self._prefix_cache) > self.prefix_cache_size:
            self._retire_prefix_entry_locked(next(iter(self._prefix_cache)))

    def _retire_prefix_entry_locked(self, key: tuple,
                                    demote: bool = True) -> None:
        """Drop one entry (lock held): paged, its blocks are first
        demoted to the host tier when ``demote`` and the tier can take
        them (the copies enqueued before the refs drop), and destroyed
        otherwise.  The one retirement path of the shortfall planners,
        the size cap and the flushes, so the demotion/eviction counts
        cannot drift between them."""
        entry, rows = self._prefix_cache[key]
        demoted = False
        if self.paged:
            demoted = demote and self._demote_entry_locked(key, entry, rows)
            self._alloc.decref(entry)
        del self._prefix_cache[key]
        self._prefix_meta.pop(key, None)
        if self._link is not None and not self.paged:
            self._link.defer("_follow_drop", key)
        if not self._warming:
            if demoted:
                self.prefix_demotions += 1
            else:
                self.prefix_evictions += 1

    def _clear_prefix_cache_locked(self, demote: bool = False) -> None:
        """Drop every entry (lock held); ``demote`` (the planners' idle
        fallback) moves each to the host tier first where it can, so the
        flush pages the cache's prefill out instead of burning it."""
        for key in list(self._prefix_cache):
            self._retire_prefix_entry_locked(key, demote)

    def _set_prefix_meta_locked(self, key: tuple, covered: int, origin: str,
                                tenant: str = "") -> None:
        """Create or refresh one entry's residency record (lock held).
        The digest hashes the covered tokens only: for a paged entry the
        block-aligned prefix, which is what an export ships.  The owner's
        tier decides the entry's demotion rank; an entry whose owner is
        unknown (fetched or promoted) ranks at the policy's default
        tier."""
        policy = self._qos_policy or _QOS_DEFAULT
        self._prefix_meta[key] = {
            "digest": prefix_digest(key[:covered]),
            "covered": covered,
            "hits": 0,
            "last_hit": time.monotonic(),
            "origin": origin,
            "tenant": tenant,
            "tier": (policy.lookup(tenant).tier if tenant
                     else policy.default_tier),
        }

    def _touch_prefix_meta_locked(self, key: tuple) -> str:
        """Record one hit on an entry (lock held); returns its origin."""
        meta = self._prefix_meta.get(key)
        if meta is None:
            return "local"
        meta["hits"] += 1
        meta["last_hit"] = time.monotonic()
        return meta["origin"]

    def prefix_digest_summary(self, cap: int = PREFIX_DIGEST_CAP) -> list:
        """The ``cap`` hottest resident entries (most recent hit first),
        each as {digest, tokens covered, blocks, age since last hit,
        hits, origin}: what a fleet publishes of its prefix residency."""
        with self._lock:
            return self._prefix_digest_summary_locked(cap)

    def _prefix_digest_summary_locked(self, cap: int) -> list:
        now = time.monotonic()
        entries = []
        for key, (entry, _) in self._prefix_cache.items():
            meta = self._prefix_meta.get(key)
            if meta is None:
                continue
            entries.append((meta["last_hit"], meta["hits"], {
                "digest": meta["digest"],
                "tokens": meta["covered"],
                # Dense entries report 0 blocks: routable, but export is
                # paged-only.
                "blocks": len(entry) if self.paged else 0,
                "age_s": round(now - meta["last_hit"], 1),
                "hits": meta["hits"],
                "origin": meta["origin"],
            }))
        # Hottest first on the raw instant (rounded ages tie), hits
        # breaking exact ties.
        entries.sort(key=lambda e: (-e[0], -e[1]))
        return [doc for _, _, doc in entries[: max(0, cap)]]

    def _evict_prefix_for_locked(self, fresh_needed: int,
                                 keep_key=None) -> None:
        """Retire idle entries least recently used first (never
        ``keep_key``) until ``fresh_needed`` blocks are free — but only
        when that can cover the shortfall now: entries whose blocks
        running slots or other entries still hold free nothing, and
        flushing them would trade future hits for no admission.  Each
        victim is demoted to the host tier where it can be
        (``_retire_prefix_entry_locked``).  Shared by the prefix,
        import and restore planners and the prefix ingest.  Under a QoS
        policy the order is tier, then LRU: best-effort entries go first,
        premium last — a soft pin, since with only premium entries left
        they retire too (an unadmittable queue serves no tier)."""
        victims = [key for key in self._prefix_cache if key != keep_key]
        if self._qos_policy is not None and len(victims) > 1:
            victims.sort(key=lambda key: _QOS_TIER_PRIORITY.get(
                (self._prefix_meta.get(key) or {}).get("tier", "standard"),
                0))  # stable: LRU order kept within a tier
        reclaimable = self._alloc.free_blocks + sum(
            self._alloc.exclusive(self._prefix_cache[key][0])
            for key in victims
        )
        if reclaimable < fresh_needed:
            return
        for key in victims:
            if fresh_needed <= self._alloc.free_blocks:
                break
            if self._alloc.exclusive(self._prefix_cache[key][0]):
                self._retire_prefix_entry_locked(key)

    def _plan_paged_admission_locked(self, req: GenRequest, idle: bool):
        """Reserve what ``req``'s admission needs from the pool (lock
        held): alias the longest usable entry's full blocks (one ref
        each), plan a copy-on-write of the entry block a hit ends inside
        (the tail prefill writes into it) into the first fresh block, and
        allocate fresh blocks for the rest of the worst case.
        All-or-nothing: None when the pool cannot cover it after evicting
        idle entries, and the request stays queued.  ``idle`` (no slot
        running or admitting) means only prefix entries can ever free a
        block: then a plan that still does not fit flushes the whole
        cache and re-plans prefix-free, which the submit-time fit check
        guarantees fits, so cached prompts never wedge the queue."""
        bs = self.kv_block
        key, usable = (None, 0)
        if self.prefix_cache_size:
            key, usable = self._best_prefix_locked(req)
        aliased: list[int] = []
        cow_src = None
        if key is not None:
            entry_blocks, _ = self._prefix_cache[key]
            full = usable // bs
            aliased = list(entry_blocks[:full])
            if usable % bs:
                cow_src = entry_blocks[full]
        rows = self._worst_case_rows(len(req.tokens), req.max_new_tokens,
                                     usable)
        fresh_needed = -(-rows // bs) - len(aliased)
        if fresh_needed > self._alloc.free_blocks:
            self._evict_prefix_for_locked(fresh_needed, keep_key=key)
        fresh = self._alloc.alloc(fresh_needed)
        if fresh is None and idle and self._prefix_cache:
            # With the host tier on, the flush demotes what it can: the
            # shortage clears either way, but the prefill survives.
            self._clear_prefix_cache_locked(demote=True)
            key, usable, aliased, cow_src = None, 0, [], None
            fresh = self._alloc.alloc(self._pool_blocks_needed(
                len(req.tokens), req.max_new_tokens))
        if fresh is None:
            if not self._warming:
                self.kv_admit_deferrals += 1
            return None
        self._alloc.incref(aliased)
        source = "recomputed"
        if key is not None:
            self._prefix_cache.move_to_end(key)  # LRU touch
            if usable:
                source = self._touch_prefix_meta_locked(key)
        self._count_prefix_locked(usable)
        if usable and not self._warming:
            self.prefix_bytes_saved += len(aliased) * bs * self._kv_row_bytes
        # Table order is the position map: the copy of the partly
        # covered entry block goes right after the aliased run.
        return {"start": usable, "blocks": aliased + fresh,
                "cow": None if cow_src is None else (cow_src, fresh[0]),
                "source": source}

    # -- block I/O: the host tier, KV shipping, migration ---------------------

    @contextmanager
    def _step_stream(self):
        """Run block I/O on the stream every replay and eager dispatch of
        the step thread runs on: the device's default stream (the step
        thread never leaves it; graphs are captured on side streams at
        warmup only).  Handler threads (``export_*``, an ingest's
        shortfall demotion) enter it too, so their copies are ordered
        with the step thread's work by the time they were enqueued: a copy
        down sees every row that a replay enqueued before it wrote, and
        anything enqueued after it (a reuse of the blocks) cannot
        overtake it."""
        if self.device.type != "cuda":
            yield
            return
        with torch.cuda.stream(torch.cuda.default_stream(self.device)):
            yield

    def _read_blocks_dispatch(self, blocks) -> tuple[list, object]:
        """Enqueue the copy of pool blocks ``blocks`` of every leaf to the
        host (any thread, lock held or not): one gather a leaf, then one
        non-blocking copy into pinned memory, on the step thread's stream.
        Returns (host tensors [n_layers, N, ...] in ``PagedCache.leaves``'
        order, the event recorded after the copies — None on the CPU,
        where they are done).  Every later write to these blocks is
        enqueued behind the copies, so they read the blocks as they are
        now and the caller may decref the blocks as soon as this returns;
        the host tensors are complete once the event has passed."""
        cuda = self.device.type == "cuda"
        staged, done = [], None
        with self._step_stream():
            ids = _to_device(np.asarray(blocks, np.int64), self.device)
            for _, pool in self._cache.leaves():
                rows = read_blocks(pool, ids)
                if cuda:
                    host = torch.empty(rows.shape, dtype=rows.dtype,
                                       pin_memory=True)
                    host.copy_(rows, non_blocking=True)
                    rows = host
                staged.append(rows)
            if cuda:
                done = torch.cuda.Event()
                done.record()
        return staged, done

    def _write_blocks(self, blocks, leaves) -> None:
        """Land ``leaves`` (host tensors [n_layers, N, ...] in
        ``PagedCache.leaves``' order) in pool blocks ``blocks`` (step
        thread): one copy up a leaf from pinned memory, then one scatter,
        on the step thread's stream, so the admission replay or decode chunk
        that reads the blocks is enqueued behind them.  Nothing waits for
        the device: each pinned source stays referenced in ``_h2d`` until
        an event recorded after its copy has passed."""
        cuda = self.device.type == "cuda"
        with self._step_stream():
            ids = _to_device(np.asarray(blocks, np.int64), self.device)
            sources = []
            for (_, pool), rows in zip(self._cache.leaves(), leaves):
                src = rows.pin_memory() if cuda and not rows.is_pinned() \
                    else rows
                write_blocks(pool, src.to(self.device, non_blocking=cuda),
                             ids)
                sources.append(src)
            if cuda:
                done = torch.cuda.Event()
                done.record()
                self._h2d.append((done, sources))

    def _demote_entry_locked(self, key: tuple, blocks, rows: int) -> bool:
        """Move one idle prefix entry's blocks to the host tier (lock
        held): allocate host blocks (host-LRU entries go under budget
        pressure), enqueue the copies down, and queue the landing for
        ``_complete_host_writes`` — the entry is promotable only once its
        bytes are there.  False (the caller destroys the entry) when there
        is no tier or it cannot make room."""
        if self._host is None or not blocks:
            return False
        n = len(blocks)
        if n > self._host.alloc.free_blocks:
            self._evict_host_for_locked(n)
        host_blocks = self._host.alloc.alloc(n)
        if host_blocks is None:
            return False
        staged, done = self._read_blocks_dispatch(blocks)
        self._defer("_follow_demote", tuple(blocks), tuple(host_blocks))
        meta = self._prefix_meta.get(key)
        self._pending_host_writes.append(_HostWrite(
            kind="prefix", host_blocks=tuple(host_blocks), staged=staged,
            done=done, key=tuple(key[:rows]), rows=rows,
            meta=dict(meta) if meta else None,
        ))
        if not self._warming:
            self.kv_demotions += n
            self.kv_demote_bytes += n * self._block_bytes
        return True

    def _evict_host_for_locked(self, need: int) -> None:
        """Drop demoted entries host-LRU first until ``need`` host blocks
        are free (lock held), but only when that can cover the need: an
        entry pinned by a promotion's payload copy frees nothing and is
        neither counted nor dropped.  A host eviction is prefill lost for
        good, counted with the device-side evictions."""
        victims = list(self._host_prefix.items())
        reclaimable = self._host.alloc.free_blocks + sum(
            self._host.alloc.exclusive(blocks) for _, (blocks, _) in victims
        )
        if reclaimable < need:
            return
        for key, (blocks, _) in victims:
            if self._host.alloc.free_blocks >= need:
                break
            if not self._host.alloc.exclusive(blocks):
                continue  # pinned by a promotion's copy
            self._host_prefix.pop(key)
            self._host_meta.pop(key, None)
            self._host.alloc.decref(blocks)
            if not self._warming:
                self.prefix_evictions += 1

    def _flush_host_tier_locked(self) -> None:
        """Drop every demoted entry (lock held, counter-silent): warmup's
        cleanup and a measurement's reset.  Blocks pinned by a promotion's
        copy free when the copy is done."""
        if self._host is None:
            return
        for blocks, _ in self._host_prefix.values():
            self._host.alloc.decref(blocks)
        self._host_prefix.clear()
        self._host_meta.clear()

    def _kv_host_fragmentation_locked(self) -> float:
        """Allocated-but-idle share of the host tier's block rows (lock
        held): live rows are demoted entries' rows and parked frontiers."""
        if self._host is None or not self._host.alloc.used_blocks:
            return 0.0
        live = sum(rows for _, rows in self._host_prefix.values()) + sum(
            p.rows for p in self._parked.values())
        used_rows = self._host.alloc.used_blocks * self.kv_block
        return round(max(0.0, 1.0 - live / used_rows), 4)

    def _complete_host_writes(self) -> None:
        """Land the demotions whose copies are done in the host pool,
        oldest first, and make them visible: prefix entries promotable,
        parked slots restorable (step thread, step start).  Never waits
        for the device: a demotion whose event has not passed lands at a
        later step.  Also lets go of the pinned sources of copies up that
        are done."""
        while self._h2d and self._h2d[0][0].query():
            self._h2d.popleft()
        with self._lock:
            ready = []
            pending = self._pending_host_writes
            while pending and (pending[0].done is None
                               or pending[0].done.query()):
                ready.append(pending.pop(0))
        if not ready:
            return
        t0 = time.monotonic()
        # The pool rows a pending write owns are written by nobody else
        # and read by nobody before it registers, so no lock is needed.
        pools = self._host.pools()
        for w in ready:
            ids = torch.as_tensor(w.host_blocks, dtype=torch.int64)
            for (_, pool), rows in zip(pools, w.staged):
                pool.index_copy_(1, ids, rows)
        with self._lock:
            for w in ready:
                if w.kind == "prefix":
                    old = self._host_prefix.pop(w.key, None)
                    if old is not None:  # re-demoted: keep the fresh copy
                        self._host.alloc.decref(old[0])
                    self._host_prefix[w.key] = (w.host_blocks, w.rows)
                    self._host_meta[w.key] = w.meta or {
                        "digest": prefix_digest(w.key), "covered": w.rows,
                        "hits": 0, "last_hit": time.monotonic(),
                        "origin": "local",
                    }
                elif w.rid in self._parked:
                    self._parked[w.rid].ready = True
                else:
                    # Reaped, cancelled or aborted while its copy was in
                    # flight: nothing to restore, the blocks go home.
                    self._host.alloc.decref(w.host_blocks)
            if not self._warming:
                self.kv_demote_seconds += time.monotonic() - t0

    def _plan_promote_locked(self, req: GenRequest) -> dict | None:
        """If a demoted entry covers more of ``req`` than any resident
        one, reserve its promotion (lock held, submit path, any thread):
        device blocks from free space only (a tier under enough pressure
        to demote must not thrash; a shortfall degrades to recompute) and
        one pin ref on the host blocks, so ``_stage_promote`` can copy
        the payload off the lock."""
        if not self.prefix_cache_size or not self._host_prefix:
            return None
        host_key, host_usable = self._best_match_locked(
            self._host_prefix.items(), req)
        if host_key is None:
            return None
        _, dev_usable = self._best_prefix_locked(req)
        if host_usable <= dev_usable:
            return None  # the device tier already covers as much
        if (host_key in self._prefix_cache
                or host_key in self._promote_staging
                or any(tuple(st.tokens) == host_key
                       for _, st, _ in self._prefix_installs)):
            return None  # already resident or staged
        blocks, rows = self._host_prefix[host_key]
        self._sweep_prefix_installs_locked(time.monotonic())
        if (len(self._prefix_installs) >= PREFIX_IMPORT_MAX
                or len(blocks) > self._alloc.free_blocks):
            return None
        dev_blocks = self._alloc.alloc(len(blocks))
        self._host.alloc.incref(blocks)
        self._promote_staging.add(host_key)
        return {
            "key": host_key,
            "digest": self._host_meta.get(host_key, {}).get(
                "digest", prefix_digest(host_key)),
            "host_blocks": tuple(blocks),
            "dev_blocks": tuple(dev_blocks),
            "rows": rows,
        }

    def _stage_promote(self, plan: dict) -> None:
        """Copy a planned promotion's payload out of the host pool into
        pinned staging (lock not held: the copy is the expensive part)
        and stage it as a prefix install for the step thread's next admission
        boundary.  The host entry stays resident and evictable while the
        install is staged."""
        try:
            leaves = self._host.gather(plan["host_blocks"],
                                       pin=self.device.type == "cuda")
        except BaseException:
            with self._lock:
                self._promote_staging.discard(plan["key"])
                self._host.alloc.decref(plan["host_blocks"])
                self._alloc.decref(plan["dev_blocks"])
            raise
        data = {name: rows for (name, _), rows in
                zip(self._host.pools(), leaves)}
        tag = -1 if self._link is None else next(self._tags)
        with self._lock:
            if tag >= 0:
                # Each follower stages its part of the same host blocks
                # before the pin below drops and the blocks can be reused.
                self._defer("_follow_stage", tag, plan["host_blocks"])
            self._promote_staging.discard(plan["key"])
            self._host.alloc.decref(plan["host_blocks"])
            self._prefix_installs.append((plan["digest"], KvImport(
                import_id=-1, blocks=plan["dev_blocks"], rows=plan["rows"],
                tokens=list(plan["key"]), data=data,
                t_created=time.monotonic(), tag=tag,
            ), plan["key"]))

    def _pick_park_victim_locked(self, below_priority: int | None = None):
        """The park victim (lock held, admission boundary: no chunk in
        flight): the lowest preemption priority of its tenant's tier
        (with no policy loaded, the default policy's), then the largest
        remaining budget, ties to the youngest stream — the slot that
        would pin its blocks longest.  ``below_priority`` (the
        slot-shortage preemption) admits only victims of strictly lower
        priority.  A slot that has not emitted since its own restore is
        immune.  Returns (slot, rid, state) or None."""
        best, best_key = None, None
        for slot, state in self._slots.items():
            if state.park_immune:
                continue
            rem = state.req.max_new_tokens - len(state.emitted)
            if rem < 1:
                continue  # finishing anyway
            prio = self._qos_lookup(state.req.tenant or "anon").priority
            if below_priority is not None and prio >= below_priority:
                continue
            key = (-prio, rem, state.t_submit)
            if best_key is None or key > best_key:
                best, best_key = (slot, state.rid, state), key
        return best

    def _try_park_locked(self, req: GenRequest,
                         below_priority: int | None = None) -> bool:
        """Park the coldest slot to make room for ``req``'s admission
        (lock held, step thread): copy its live blocks to the host tier,
        free its device blocks and its slot, and keep what a restore
        needs.  True when a victim was parked (the caller re-plans).  The
        victim's stream pauses: its waiter stays, its deadline runs, and
        restore is exact (block bytes are copies, every other per-slot
        input is rebuilt from host truth).  Under a policy every park is
        a QoS decision, counted on both tenants' rows."""
        if not self.kv_park:
            return False
        pick = self._pick_park_victim_locked(below_priority)
        if pick is None:
            return False
        slot, rid, state = pick
        rows = len(state.req.tokens) + len(state.emitted) - 1
        if rows < 1:
            return False
        n_cov = -(-rows // self.kv_block)
        row = self._tables_host[slot]
        n_live = int(np.sum(row < self.kv_blocks))
        if n_cov > n_live:
            return False
        if n_cov > self._host.alloc.free_blocks:
            self._evict_host_for_locked(n_cov)
        host_blocks = self._host.alloc.alloc(n_cov)
        if host_blocks is None:
            return False
        pool_blocks = tuple(int(b) for b in row[:n_cov])
        staged, done = self._read_blocks_dispatch(pool_blocks)
        self._defer("_follow_demote", pool_blocks, tuple(host_blocks))
        self._pending_host_writes.append(_HostWrite(
            kind="park", host_blocks=tuple(host_blocks), staged=staged,
            done=done, rid=rid,
        ))
        self._parked[rid] = _ParkedSlot(
            state=state, host_blocks=tuple(host_blocks), n_cov=n_cov,
            n_live=n_live, rows=rows,
        )
        self._slots.pop(slot)
        self._release_slot_locked(slot)
        if not self._warming:
            self.kv_parks += 1
            self.kv_demotions += n_cov
            self.kv_demote_bytes += n_cov * self._block_bytes
            if self._qos_policy is not None:
                preemptor = req.tenant or "anon"
                victim = state.req.tenant or "anon"
                prow = self._tenant_row_locked(preemptor)
                vrow = self._tenant_row_locked(victim)
                prow["preempted"] += 1
                vrow["parked_victim"] += 1
                self.qos_preemptions += 1
                _metrics.SERVE_QOS.inc(prow["tier"], "preempted")
                _metrics.SERVE_QOS.inc(vrow["tier"], "parked_victim")
                _events.emit(
                    "qos.preempt",
                    component="oim-serve",
                    severity=_events.WARNING,
                    subject=victim,
                    preemptor=preemptor,
                    preemptor_tier=prow["tier"],
                    victim_tier=vrow["tier"],
                    victim_rid=rid,
                    blocks=n_cov,
                )
        return True

    def _drop_parked_locked(self, rid: int) -> "_ParkedSlot | None":
        """Forget one parked request and return its host blocks (lock
        held): the reap, cancel and abort path.  While its copy down is in
        flight the landing owns the blocks and returns them itself."""
        parked = self._parked.pop(rid, None)
        if parked is not None and parked.ready:
            self._host.alloc.decref(parked.host_blocks)
        return parked

    def _unpark_wave(self) -> None:
        """Restore parked slots whose KV fits the pool again (step
        thread, admission boundary, lock not held for the device writes):
        oldest first, stopping at the first that does not fit.  Restores
        park nothing; they only retire idle prefix entries, so a restore
        cannot cascade."""
        while True:
            with self._lock:
                target = next(iter(self._parked.items()), None)
                if target is None or not target[1].ready or not self._free:
                    return
                rid, parked = target
                if parked.n_live > self._alloc.free_blocks:
                    self._evict_prefix_for_locked(parked.n_live)
                blocks = self._alloc.alloc(parked.n_live)
                if blocks is None and not (self._slots or self._admitting
                                           or self._queue):
                    # Otherwise idle: only prefix entries hold blocks.
                    # The parked reservation fit this pool once, so an
                    # emptied pool covers it.
                    self._clear_prefix_cache_locked(demote=True)
                    blocks = self._alloc.alloc(parked.n_live)
                if blocks is None:
                    return
                parked.restoring = True
                slot = self._free.pop(0)
                state = parked.state
            t0 = time.monotonic()
            self._dev("_restore_parked", parked.host_blocks,
                      tuple(blocks[: parked.n_cov]), slot,
                      list(state.req.tokens), list(state.emitted))
            with self._lock:
                if self._parked.pop(rid, None) is None:
                    # Aborted during the writes: the request is failed
                    # and its host blocks returned; undo the reservation.
                    self._alloc.decref(blocks)
                    self._free.append(slot)
                    continue
                row = self._tables_host[slot]
                row[:] = self.kv_blocks
                row[: parked.n_live] = blocks
                self._host.alloc.decref(parked.host_blocks)
                state.park_immune = True
                self._slots[slot] = state
                if not self._warming:
                    dt = time.monotonic() - t0
                    self.kv_unparks += 1
                    self.kv_promotions += parked.n_cov
                    self.kv_promote_bytes += parked.n_cov * self._block_bytes
                    self.kv_promote_seconds += dt
                    self._promote_walls.append(dt)

    def _restore_parked(self, host_blocks, dev_blocks, slot: int, prompt,
                        emitted) -> None:
        """Write a parked slot's host-tier blocks back into pool
        ``dev_blocks`` and rebuild its per-slot device state (step
        thread; on a follower after its own demotions have landed)."""
        self._land_host(wait=True)
        self._write_host_payload(host_blocks, dev_blocks)
        self._restore_slot_state(slot, prompt, emitted)

    def _write_host_payload(self, host_blocks, dev_blocks) -> None:
        """Write host-tier blocks back into the device pool (step
        thread): a gather into pinned staging, then ``_write_blocks``."""
        self._write_blocks(dev_blocks, self._host.gather(
            host_blocks, pin=self.device.type == "cuda"))

    def _restore_slot_state(self, slot: int, prompt, emitted) -> None:
        """Rebuild a restored slot's per-slot device state from host truth
        (its ``prompt`` and ``emitted`` tokens; stream-ordered before the
        next dispatch): prompt lookup's history row and the penalty
        occurrence rows, on every rank of a mesh.  Sampling needs
        nothing: the noise key is (seed, sample_base + emitted count), all
        host state."""
        tokens = list(prompt) + list(emitted)
        vocab = self.cfg.vocab_size
        with self._step_stream():
            hist_row = tok_row = gen_row = None
            if self._history is not None:
                hist = np.zeros((self.max_len,), np.int64)
                hist[: len(tokens)] = tokens
                hist_row = _to_device(hist, self.device)
            if self.penalties:
                tok_row = _to_device(np.bincount(
                    tokens, minlength=vocab).astype(np.int32), self.device)
                gen_row = _to_device(np.bincount(
                    emitted, minlength=vocab).astype(np.int32),
                    self.device)
            _restore_slot(self._history, self._tok_counts, self._gen_counts,
                          slot, hist_row, tok_row, gen_row)

    # -- KV shipping: held KV, imports, prefix entries ------------------------

    def kv_geometry(self) -> dict:
        """The geometry a ship must match exactly, under the reference's
        names (``validate_geometry``): refused at the manifest, before
        any payload moves."""
        return {
            "n_layers": self.cfg.n_layers,
            "kv_heads": self.cfg.kv_heads,
            "head_dim": self.cfg.head_dim,
            "block_size": self.kv_block,
            "kv_int8": self.kv_int8,
            "dtype": "int4" if self.kv_int4 else dtype_name(
                self._cache.k.dtype),
        }

    def _hold_kv_locked(self, slot: int, state: _SlotState) -> None:
        """Retain a finishing ``hold_kv`` request's KV for export (lock
        held, before the slot's blocks are released): one extra ref on
        every block its valid rows cover, under its rid, with a TTL.  The
        frontier is ``tokens - 1`` rows: the last emitted token has no
        row yet, which is what a continuation's prefill extends.  A
        chained chunk still in flight writes only at or past it."""
        if self.kv_int4:
            return  # packed int4 pools do not ship
        tokens = list(state.req.tokens) + list(state.emitted)
        rows = len(tokens) - 1
        if rows < 1:
            return
        blocks = tuple(int(b) for b in
                       self._tables_host[slot][: -(-rows // self.kv_block)])
        if any(b >= self.kv_blocks for b in blocks):
            return  # abort() reclaimed the row meanwhile
        now = time.monotonic()
        self._sweep_kv_holds_locked(now)
        while len(self._kv_holds) >= KV_HOLD_MAX:
            old = min(self._kv_holds.values(), key=lambda h: h.t_created)
            self._release_kv_hold_locked(old.rid)
        self._alloc.incref(blocks)
        req = state.req
        self._kv_holds[state.rid] = KvHold(
            rid=state.rid, blocks=blocks, rows=rows,
            prompt_tokens=list(req.tokens), tokens=list(state.emitted),
            sampling=_sampling(req), t_created=now,
        )

    def _release_kv_hold_locked(self, rid: int) -> bool:
        hold = self._kv_holds.pop(rid, None)
        if hold is None:
            return False
        self._alloc.decref(hold.blocks)
        return True

    def _sweep_kv_holds_locked(self, now: float) -> None:
        for rid in [r for r, h in self._kv_holds.items()
                    if now - h.t_created > KV_HOLD_TTL_S]:
            self._release_kv_hold_locked(rid)

    def _sweep_kv_imports_locked(self, now: float) -> None:
        for iid in [i for i, imp in self._kv_imports.items()
                    if now - imp.t_created > KV_IMPORT_TTL_S]:
            self._release_kv_import_locked(iid)

    def _release_kv_import_locked(self, import_id: int) -> bool:
        imp = self._kv_imports.pop(import_id, None)
        if imp is None:
            return False
        self._alloc.decref(imp.blocks)
        self._drop_tag_locked(imp.tag)
        return True

    def release_kv_hold(self, rid: int) -> bool:
        """Drop a held export (after the ship, or never shipped);
        idempotent."""
        if not self.paged:
            return False
        with self._lock:
            return self._release_kv_hold_locked(rid)

    def release_kv_import(self, import_id: int) -> bool:
        """Drop a staged import nobody will consume; idempotent."""
        if not self.paged:
            return False
        with self._lock:
            return self._release_kv_import_locked(import_id)

    def _gather_blocks(self, blocks) -> tuple[list, list]:
        """Read pool ``blocks`` to the host: (leaf names, tensors
        [n_layers, N, ...]), the payload of every device-side export.  Any
        thread: the caller holds a ref on the blocks and nothing writes
        their valid rows.  The copies run on the step thread's stream
        (``_step_stream``), so they see every row written by a replay
        enqueued before them; this waits for them on their event with no
        lock held, and counts one readback as ``_fetch_aux`` does."""
        staged, done = self._read_blocks_dispatch(blocks)
        if done is not None:
            done.synchronize()
        if not self._warming:
            with self._lock:
                self.readbacks += 1
        return [name for name, _ in self._cache.leaves()], staged

    def _refuse_ship(self, what: str) -> None:
        """The ship-ineligible guard: dense and packed-int4 engines."""
        if not self.paged:
            raise KvIneligibleError(
                f"{what} needs a paged engine (oim-serve --kv-block)")
        if self.kv_int4:
            raise KvIneligibleError(f"{what} unsupported on kv_int4")

    def _manifest(self, rows: int, prompt_tokens, tokens, sampling,
                  names, arrays) -> dict:
        return build_manifest(
            geometry=self.kv_geometry(), rows=rows,
            prompt_tokens=prompt_tokens, tokens=tokens, sampling=sampling,
            leaves=leaf_table(names, arrays),
        )

    def export_kv(self, rid: int):
        """One held request's KV as (manifest, leaf tensors in manifest
        order), the reference's wire (``disagg.pack_transfer``).  Any
        thread: held blocks belong to no slot and their valid rows are
        never written again.  ``KvIneligibleError`` on a dense or
        packed-int4 engine, or an unknown or expired rid."""
        self._refuse_ship("KV export")
        with self._lock:
            self._sweep_kv_holds_locked(time.monotonic())
            hold = self._kv_holds.get(rid)
            if hold is None:
                raise KvIneligibleError(f"no held KV for request {rid}")
        names, arrays = self._export_payload(hold.blocks)
        manifest = self._manifest(hold.rows, hold.prompt_tokens, hold.tokens,
                                  hold.sampling, names, arrays)
        with self._lock:
            self.kv_exports += 1
            self.kv_ship_bytes += sum(a.nbytes for a in arrays)
        return manifest, arrays

    def import_kv(self, manifest: dict, data: dict) -> tuple[int, int]:
        """Stage one shipped KV state for a continuation: validate the
        manifest's geometry and every leaf's shape and dtype, reserve the
        shipped blocks (all-or-nothing: ``KvCapacityError`` is
        backpressure), and keep the host payload for the step thread to write
        at the continuation's admission.  Returns (import_id, rows).  Any
        thread: nothing here touches the device (under a mesh each rank
        takes its kv-head part of the payload here, ``_stage_payload``)."""
        self._refuse_ship("KV ingest")
        validate_geometry(manifest, self.kv_geometry())
        rows = int(manifest["rows"])
        tokens = [int(t) for t in manifest["prompt_tokens"]] + [
            int(t) for t in manifest["tokens"]]
        if rows >= self.max_len:
            raise KvGeometryError(
                f"shipped rows {rows} exceed max_len {self.max_len}")
        leaves = self._validate_ship_leaves(data, -(-rows // self.kv_block))
        total = sum(t.nbytes for t in leaves.values())
        tag, leaves = self._stage_payload(leaves)
        with self._lock:
            now = time.monotonic()
            self._sweep_kv_imports_locked(now)
            while len(self._kv_imports) >= KV_IMPORT_MAX:
                old = min(self._kv_imports.values(),
                          key=lambda imp: imp.t_created)
                self._release_kv_import_locked(old.import_id)
            n_ship = -(-rows // self.kv_block)
            blocks = self._alloc.alloc(n_ship)
            if blocks is None:
                self._drop_tag_locked(tag)
                raise KvCapacityError(
                    f"pool cannot reserve {n_ship} blocks for the shipped "
                    f"KV ({self._alloc.free_blocks} free) — retry or fall "
                    f"back to recompute")
            import_id = self._next_import_id
            self._next_import_id += 1
            self._kv_imports[import_id] = KvImport(
                import_id=import_id, blocks=tuple(blocks), rows=rows,
                tokens=tokens, data=leaves, t_created=now, tag=tag,
            )
            self.kv_imports_total += 1
            self.kv_ship_bytes += total
        return import_id, rows

    def _validate_ship_leaves(self, data: dict, n_ship: int) -> dict:
        """Every leaf of a shipped payload, checked for exact shape and
        dtype, as host tensors in manifest order: a bad transfer dies
        here as the 409 the protocol promises, never in the step
        thread's write."""
        cfg = self.cfg
        kv_shape = (cfg.n_layers, n_ship, self.kv_block, cfg.kv_heads,
                    cfg.head_dim)
        want = {"k": (kv_shape, self._cache.k.dtype),
                "v": (kv_shape, self._cache.v.dtype)}
        if self.kv_int8:
            want["k_scale"] = (kv_shape[:-1], torch.float32)
            want["v_scale"] = (kv_shape[:-1], torch.float32)
        out = {}
        for name, (shape, dtype) in want.items():
            leaf = data.get(name)
            if (not isinstance(leaf, torch.Tensor)
                    or tuple(leaf.shape) != shape or leaf.dtype != dtype):
                got = ("nothing" if leaf is None else
                       f"{tuple(leaf.shape)} {leaf.dtype}")
                raise KvGeometryError(
                    f"leaf {name} missing or mis-shaped/typed: want "
                    f"{shape} {dtype_name(dtype)}, got {got}")
            out[name] = leaf
        return out

    def export_kv_prefix(self, digest: str):
        """One resident prefix entry's KV as (manifest, leaf tensors):
        the block-aligned entry a sibling installs without recomputing
        its prefill.  The entry's blocks are pinned by a ref for the
        read.  ``KvIneligibleError`` on dense or packed-int4 engines or
        an unknown digest."""
        self._refuse_ship("prefix export")
        with self._lock:
            for key, (blocks, _) in self._prefix_cache.items():
                meta = self._prefix_meta.get(key)
                if meta is not None and meta["digest"] == digest:
                    covered = meta["covered"]
                    entry_blocks = tuple(blocks)
                    tokens = [int(t) for t in key[:covered]]
                    break
            else:
                raise KvIneligibleError(f"no resident prefix {digest!r}")
            self._alloc.incref(entry_blocks)  # pinned for the read
        try:
            names, arrays = self._export_payload(entry_blocks)
        finally:
            with self._lock:
                self._alloc.decref(entry_blocks)
        manifest = self._manifest(covered, tokens, [], {}, names, arrays)
        manifest["prefix"] = digest
        with self._lock:
            self.prefix_exports += 1
            self.kv_ship_bytes += sum(a.nbytes for a in arrays)
        return manifest, arrays

    def import_kv_prefix(self, manifest: dict,
                         data: dict) -> tuple[str, int]:
        """Stage one shipped prefix entry for installation: validate,
        reserve its blocks all-or-nothing (idle entries retired first),
        and keep the payload for the step thread to land at the next admission
        boundary (``install_prefix_imports``).  Returns (digest, rows);
        rows 0 when the entry is already resident or staged."""
        self._refuse_ship("prefix ingest")
        if not self.prefix_cache_size:
            raise KvIneligibleError(
                "no prefix cache on this backend (oim-serve --prefix-cache)")
        digest = manifest.get("prefix")
        if not digest:
            raise KvGeometryError("manifest is not a prefix transfer")
        validate_geometry(manifest, self.kv_geometry())
        rows = int(manifest["rows"])
        if rows % self.kv_block:
            raise KvGeometryError(
                f"prefix rows {rows} not block-aligned "
                f"(block_size {self.kv_block})")
        if rows >= self.max_len:
            raise KvGeometryError(
                f"shipped rows {rows} exceed max_len {self.max_len}")
        tokens = [int(t) for t in manifest["prompt_tokens"]]
        n_ship = rows // self.kv_block
        leaves = self._validate_ship_leaves(data, n_ship)
        total = sum(t.nbytes for t in leaves.values())
        key = tuple(tokens)
        with self._lock:
            if self._prefix_staged_locked(key):
                return digest, 0
        tag, leaves = self._stage_payload(leaves)
        with self._lock:
            if self._prefix_staged_locked(key):
                self._drop_tag_locked(tag)
                return digest, 0
            now = time.monotonic()
            self._sweep_prefix_installs_locked(now)
            while len(self._prefix_installs) >= PREFIX_IMPORT_MAX:
                _, old, _ = self._prefix_installs.pop(0)
                self._alloc.decref(old.blocks)
                self._drop_tag_locked(old.tag)
            if n_ship > self._alloc.free_blocks:
                self._evict_prefix_for_locked(n_ship)
            blocks = self._alloc.alloc(n_ship)
            if blocks is None:
                self._drop_tag_locked(tag)
                raise KvCapacityError(
                    f"pool cannot reserve {n_ship} blocks for the shipped "
                    f"prefix ({self._alloc.free_blocks} free) — retry or "
                    f"fall back to recompute")
            self._prefix_installs.append((digest, KvImport(
                import_id=-1, blocks=tuple(blocks), rows=rows,
                tokens=tokens, data=leaves, t_created=now, tag=tag,
            ), None))
            self.kv_ship_bytes += total
        return digest, rows

    def _prefix_staged_locked(self, key: tuple) -> bool:
        """Whether prefix ``key`` is resident or staged (lock held)."""
        return key in self._prefix_cache or any(
            tuple(st.tokens) == key for _, st, _ in self._prefix_installs)

    def _sweep_prefix_installs_locked(self, now: float) -> None:
        """TTL the staged prefix installs (lock held).  A swept promotion
        loses only its staged copy; the entry stays in the host tier."""
        keep = []
        for item in self._prefix_installs:
            if now - item[1].t_created > PREFIX_IMPORT_TTL_S:
                self._alloc.decref(item[1].blocks)
                self._drop_tag_locked(item[1].tag)
            else:
                keep.append(item)
        self._prefix_installs = keep

    def install_prefix_imports(self) -> int:
        """Land every staged prefix payload in the pool and make the
        entries visible; returns how many were installed.  On the thread
        that owns the device cache: the step thread's admission boundary, or
        before the step loop starts.  The writes are stream-ordered
        before any later prefill that aliases the entry."""
        if not self.paged:
            return 0
        with self._lock:
            if not self._prefix_installs:
                return 0
            staged, self._prefix_installs = self._prefix_installs, []
        installed = 0
        for digest, st, promote_key in staged:
            t0 = time.monotonic()
            self._write_import_blocks(st)
            with self._lock:
                key = tuple(st.tokens)
                if key in self._prefix_cache:
                    # A local store of the same prompt won the race.
                    self._alloc.decref(st.blocks)
                else:
                    self._prefix_cache[key] = (tuple(st.blocks), st.rows)
                    origin = "fetched"
                    if promote_key is not None:  # a promotion keeps its
                        origin = self._host_meta.get(  # entry's origin
                            promote_key, {}).get("origin", "local")
                    self._set_prefix_meta_locked(key, st.rows, origin)
                    self._trim_to_size_locked()
                    if promote_key is None:
                        self.prefix_fetch_installs += 1
                    installed += 1
                if promote_key is not None:
                    # The prefix is device-resident: the host copy frees
                    # its budget for the next demotion.
                    host = self._host_prefix.pop(promote_key, None)
                    if host is not None:
                        self._host_meta.pop(promote_key, None)
                        self._host.alloc.decref(host[0])
                    if not self._warming:
                        dt = time.monotonic() - t0
                        n = len(st.blocks)
                        self.kv_promotions += n
                        self.kv_promote_bytes += n * self._block_bytes
                        self.kv_promote_seconds += dt
                        self._promote_walls.append(dt)
        return installed

    def _write_import_blocks(self, imp: KvImport) -> None:
        """Land a consumed import's or install's payload in its blocks
        (step thread), stream-ordered before the admission that reads
        them: ship ingests carry k, v and int8's scales; promotions every
        leaf of the pool, a packed int4 one's included.  Under a mesh
        every rank writes its part (``_write_stash``)."""
        with self._turn():
            if imp.tag >= 0:
                self._lead("_write_stash", imp.tag, imp.blocks)
            self._write_blocks(imp.blocks, [imp.data[name] for name, _ in
                                            self._cache.leaves()])

    def _plan_import_admission_locked(self, req: GenRequest,
                                      imp: KvImport):
        """The admission plan of an import's continuation (lock held):
        the shipped blocks become the slot's leading table entries (their
        refs move to the slot: no aliasing, no copy-on-write), the tail
        prefill starts at the shipped frontier, and fresh blocks cover
        the rest of the worst case.  All-or-nothing: a shortfall leaves
        the request queued and the import staged (its TTL bounds the
        wait)."""
        bs = self.kv_block
        start = imp.rows
        rows = self._worst_case_rows(len(req.tokens), req.max_new_tokens,
                                     start)
        fresh_needed = max(0, -(-rows // bs) - len(imp.blocks))
        if fresh_needed > self._alloc.free_blocks:
            self._evict_prefix_for_locked(fresh_needed)
        fresh = self._alloc.alloc(fresh_needed)
        if fresh is None:
            if not self._warming:
                self.kv_admit_deferrals += 1
            return None
        self._kv_imports.pop(imp.import_id, None)
        return {"start": start, "blocks": list(imp.blocks) + fresh,
                "cow": None, "ingest": imp}

    # -- live-slot migration ----------------------------------------------------

    def begin_migrate_out(self) -> None:
        """Enter migrate-out drain: stop admitting (``submit`` raises
        DrainingError) and have the step thread suspend every queued, active
        and parked request at its next step into "migrated" failures,
        active and parked ones leaving a record for ``export_slot``.
        Idempotent; any thread."""
        with self._lock:
            self._draining = True
            self._migrate_out = True

    def _slot_meta_locked(self, state: _SlotState, now: float) -> dict:
        """The manifest's ``"slot"`` branch (lock held): the global
        sampling offset (this backend's emitted count on top of the
        request's own base), the deadline remainder in ms, tenant and
        tier, and the caller's trace context as a ``traceparent`` (None
        without one).  Prompt lookup's history needs no field: admission
        rebuilds it from the token record."""
        req = state.req
        tenant = req.tenant or "anon"
        return {
            "sample_base": len(state.emitted) + req.sample_base,
            "deadline_ms": (int(max(0.0, req.deadline - now) * 1000)
                            if req.deadline is not None else None),
            "tenant": tenant,
            "tier": self._qos_lookup(tenant).tier,
            "trace": req.span.traceparent() if req.span else None,
        }

    def _capture_slot_locked(self, slot: int, state: _SlotState,
                             now: float) -> bool:
        """Mint one active slot's migration record (lock held, step
        thread, before the slot's blocks are released): one extra ref on
        every block its valid rows cover — the hold's frontier and its
        argument: a chained chunk in flight writes only at or past the
        frontier, the refs keep the blocks from reuse, and the importer
        overwrites what lies past ``rows``.  False when ineligible (dense,
        packed int4, a reclaimed table row, nothing decoded)."""
        if not self.paged or self.kv_int4:
            return False
        rows = len(state.req.tokens) + len(state.emitted) - 1
        if rows < 1:
            return False
        blocks = tuple(int(b) for b in
                       self._tables_host[slot][: -(-rows // self.kv_block)])
        if any(b >= self.kv_blocks for b in blocks):
            return False
        self._alloc.incref(blocks)
        self._migrated[state.rid] = SlotRecord(
            rid=state.rid, blocks=blocks, host_blocks=(), rows=rows,
            prompt_tokens=list(state.req.tokens),
            tokens=list(state.emitted), sampling=_sampling(state.req),
            meta=self._slot_meta_locked(state, now), t_created=now,
        )
        return True

    def _migrate_wave(self) -> None:
        """Suspend everything for migrate-out (step thread, step start,
        right after ``_reap``).  Queued and mid-prefill requests fail
        "migrated" with no record (a sibling recomputes them exactly).
        Active slots are captured, oldest first by tier, then freed and
        failed.  Ready parked slots hand their host payload to a record
        with no device traffic; one whose copy down is still in flight
        stays parked until a later step."""
        now = time.monotonic()
        with self._lock:
            if not self._migrate_out or not (
                    self._queue or self._slots or self._parked
                    or self._prefilling):
                return
            for rid, req, t_sub in self._queue:
                self._fail_locked(rid, "migrated",
                                  "backend draining before admission",
                                  req=req, t_submit=t_sub)
            self._queue.clear()
            for rid in list(self._prefilling):
                pend = self._prefilling.pop(rid)
                self._admitting.pop(rid, None)
                self._release_slot_locked(pend.slot)
                self._fail_locked(
                    rid, "migrated",
                    f"backend draining mid-prefill "
                    f"({pend.trace.prefill_segments} segments written; "
                    f"recompute on a sibling)",
                    req=pend.req, t_submit=pend.t_submit)
            # Premium first: a router sees premium markers first and
            # ships them first.
            order = sorted(self._slots.items(), key=lambda kv: (
                -self._qos_lookup(kv[1].req.tenant or "anon").priority,
                kv[1].t_submit))
            for slot, state in order:
                captured = self._capture_slot_locked(slot, state, now)
                self._slots.pop(slot)
                self._release_slot_locked(slot)
                self._fail_locked(
                    state.rid, "migrated",
                    f"suspended after {len(state.emitted)} tokens "
                    + ("(KV captured for export_slot)" if captured else
                       "(no capture: recompute on a sibling)"),
                    state=state)
            for rid in [r for r, p in self._parked.items()
                        if p.ready and not p.restoring]:
                parked = self._parked.pop(rid)
                state = parked.state
                if not self.kv_int4:
                    # The record takes over the parked host blocks and
                    # their refs: export reads them off the host pool.
                    self._migrated[rid] = SlotRecord(
                        rid=rid, blocks=(), host_blocks=parked.host_blocks,
                        rows=parked.rows,
                        prompt_tokens=list(state.req.tokens),
                        tokens=list(state.emitted),
                        sampling=_sampling(state.req),
                        meta=self._slot_meta_locked(state, now),
                        t_created=now,
                    )
                    msg = (f"suspended while parked ({len(state.emitted)} "
                           f"tokens; host payload captured for export_slot)")
                else:
                    self._host.alloc.decref(parked.host_blocks)
                    msg = (f"suspended while parked ({len(state.emitted)} "
                           f"tokens; packed int4 payload not shippable)")
                self._fail_locked(rid, "migrated", msg, state=state)
        self._drain_fail_obs()

    def _sweep_migrated_locked(self, now: float) -> None:
        for rid in [r for r, rec in self._migrated.items()
                    if now - rec.t_created > MIGRATE_TTL_S]:
            self._release_migrated_locked(rid)

    def _release_migrated_locked(self, rid: int) -> bool:
        rec = self._migrated.pop(rid, None)
        if rec is None:
            return False
        if rec.blocks:
            self._alloc.decref(rec.blocks)
        if rec.host_blocks and self._host is not None:
            self._host.alloc.decref(rec.host_blocks)
        return True

    def release_migrated(self, rid: int) -> bool:
        """Drop a suspended-slot record (after the ship, or never
        shipped); idempotent."""
        if not self.paged:
            return False
        with self._lock:
            return self._release_migrated_locked(rid)

    def export_slot(self, rid: int):
        """One suspended slot's state as (manifest, leaf tensors): the KV
        wire plus the manifest's ``"slot"`` branch.  A captured record
        reads its device blocks (``_gather_blocks``); a parked one reads
        the host pool, with no device traffic.  ``KvIneligibleError`` on
        a dense or packed-int4 engine, or an unknown or expired rid."""
        self._refuse_ship("slot export")
        with self._lock:
            self._sweep_migrated_locked(time.monotonic())
            rec = self._migrated.get(rid)
            if rec is None:
                raise KvIneligibleError(f"no migrated slot for request {rid}")
        names, arrays = self._export_payload(rec.blocks, rec.host_blocks)
        manifest = self._manifest(rec.rows, rec.prompt_tokens, rec.tokens,
                                  rec.sampling, names, arrays)
        manifest["slot"] = dict(rec.meta)
        with self._lock:
            self.slot_exports += 1
            self.kv_ship_bytes += sum(a.nbytes for a in arrays)
        return manifest, arrays

    def import_slot(self, manifest: dict, data: dict):
        """Stage one shipped slot: ``import_kv`` plus the slot branch's
        check; the continuation admits through ``kv_import`` with the
        branch's ``sample_base``.  Returns (import_id, rows, slot
        branch)."""
        slot_meta = manifest.get("slot")
        if not isinstance(slot_meta, dict):
            raise KvGeometryError("not a slot manifest (no slot branch)")
        import_id, rows = self.import_kv(manifest, data)
        with self._lock:
            self.slot_imports += 1
        return import_id, rows, slot_meta

    # -- mesh: the leader's records and the followers ---------------------

    # What a follower runs: the device work the leader records.
    _FOLLOWED = frozenset((
        "_dispatch_admission", "_first_tokens", "_seat_history",
        "_dispatch_draft", "_copy_block", "_inject_rows", "_follow_store",
        "_follow_drop", "_stage_chunk", "_ensure_graphs", "_follow_demote",
        "_follow_stage", "_follow_recv", "_follow_unstash", "_write_stash",
        "_restore_parked", "_follow_export", "_send_param", "_embed_pass",
        "_beam_pass", "_twice_state", "_set_graphs",
    ))

    def _turn(self):
        """The leader's ``_MeshLink.turn`` (a record and its own half of
        the work, atomically), or nothing off a mesh's leader."""
        if self._link is not None and self._link.leader:
            return self._link.turn
        return nullcontext()

    def _lead(self, name: str, *args) -> None:
        """On a mesh's leader, send the record of device work ``name``
        to the followers (nothing elsewhere)."""
        if self._link is not None and self._link.leader:
            self._link.send(name, *args)

    def _dev(self, name: str, *args):
        """Run device work ``name`` from host inputs here, after sending
        its record to a mesh's followers, both inside the turn."""
        with self._turn():
            self._lead(name, *args)
            return getattr(self, name)(*args)

    @torch.no_grad()
    def follow(self) -> None:
        """A follower rank's loop: run each piece of device work the
        leader records, on this rank's shard, until the leader's stop
        record.  A decode or admission reads nothing back; a KV export or
        a weight gather reads this rank's part to the host for the leader
        (``_MeshLink.gather``), after the work already queued on its
        stream."""
        if self._link is None or self._link.leader:
            raise RuntimeError("follow() runs on a mesh rank other than 0")
        while True:
            for name, *args in self._link.recv():
                if name == "stop":
                    self._land_host(wait=True)
                    return
                if name not in self._FOLLOWED:
                    raise RuntimeError(f"unknown record {name!r}")
                getattr(self, name)(*args)
            self._land_host(wait=False)

    def stop_followers(self) -> None:
        """The leader's stop record: every follower's ``follow`` returns.
        Call from the step thread's side (no step running)."""
        self._lead("stop")

    # -- mesh: block I/O's records -----------------------------------------

    def _defer(self, *record) -> None:
        """Queue a record made under the engine lock (a mesh's leader
        only), to go out ahead of the leader's next one."""
        if self._link is not None:
            self._link.defer(*record)

    def _follow_demote(self, blocks, host_blocks) -> None:
        """A follower's half of a demotion or a park: the same copy of
        pool ``blocks`` down, landed in host blocks ``host_blocks`` of its
        own tier once done (``_land_host``)."""
        staged, done = self._read_blocks_dispatch(blocks)
        self._follow_writes.append((host_blocks, staged, done))

    def _land_host(self, wait: bool) -> None:
        """A follower's demotions whose copies are done, oldest first,
        into its host pool at the leader's host block ids; ``wait`` lands
        them all (before anything reads the host pool)."""
        pending = self._follow_writes
        while pending and (wait or pending[0][2] is None
                           or pending[0][2].query()):
            host_blocks, staged, done = pending.pop(0)
            if done is not None:
                done.synchronize()
            ids = torch.as_tensor(host_blocks, dtype=torch.int64)
            for (_, pool), rows in zip(self._host.pools(), staged):
                pool.index_copy_(1, ids, rows)

    def _follow_stage(self, tag: int, host_blocks) -> None:
        """A follower's half of a promotion's staging: its part of host
        blocks ``host_blocks``, kept under ``tag`` until the install."""
        self._land_host(wait=True)
        self._stash[tag] = self._host.gather(
            host_blocks, pin=self.device.type == "cuda")

    def _follow_recv(self, tag: int, n_blocks: int) -> None:
        """A follower's half of a shipped payload's import: its kv-head
        part of ``n_blocks`` blocks of every pool leaf, from rank 0,
        kept under ``tag``."""
        like = [torch.empty((pool.shape[0], n_blocks, *pool.shape[2:]),
                            dtype=pool.dtype)
                for _, pool in self._cache.leaves()]
        self._stash[tag] = self._link.scatter(like=like)

    def _follow_unstash(self, tag: int) -> None:
        self._stash.pop(tag, None)

    def _write_stash(self, tag: int, blocks) -> None:
        """A follower's half of an install or an import's landing: its
        part staged under ``tag`` into pool ``blocks``."""
        self._write_blocks(blocks, self._stash.pop(tag))

    def _drop_tag_locked(self, tag: int) -> None:
        """A staged payload dropped before its blocks were written (lock
        held): the followers drop their parts of it too."""
        if tag >= 0:
            self._defer("_follow_unstash", tag)

    def _stage_payload(self, leaves: dict) -> tuple[int, dict]:
        """A validated shipped payload (leaf name → whole kv heads, in
        ``PagedCache.leaves``' order) as this engine stages it: (-1, the
        leaves) off a mesh; on a mesh's leader each rank's kv-head part
        is sent to it and staged under a new tag, and (the tag, rank 0's
        part) come back.  Never under the engine lock."""
        if self._link is None:
            return -1, leaves
        tag = next(self._tags)
        whole = list(leaves.values())
        with self._turn():
            self._lead("_follow_recv", tag, whole[0].shape[1])
            mine = self._link.scatter(
                [self._kv_part(whole, rank) for rank in range(
                    self.mesh.size)])
        return tag, dict(zip(leaves, mine))

    def _kv_part(self, leaves: list, rank: int) -> list:
        """Rank ``rank``'s kv-head part of whole KV leaves [n_layers, N,
        block, kv_heads, ...]."""
        n = self._run_cfg.kv_heads
        at = self.mesh.axis_index("tp", rank) * n
        return [t.narrow(3, at, n).contiguous() for t in leaves]

    def _kv_whole(self, parts: list) -> list:
        """Whole KV leaves from every rank's parts (``parts[rank]``):
        concatenated on the kv-head axis in ``tp`` order, one rank of
        each ``tp`` index (the others hold the same heads)."""
        by_index = {}
        for rank in range(self.mesh.size):
            by_index.setdefault(self.mesh.axis_index("tp", rank), rank)
        ranks = [by_index[i] for i in range(len(by_index))]
        return [torch.cat([parts[r][j] for r in ranks], dim=3)
                for j in range(len(parts[0]))]

    def _export_payload(self, blocks=(), host_blocks=()) -> tuple:
        """(leaf names, whole leaves) of pool ``blocks`` or of host-tier
        ``host_blocks``: the payload of every export.  Under a mesh every
        rank reads its kv-head part (a record) and the leader gathers the
        parts and joins them, byte for byte what one device holding the
        same K/V sends."""
        with self._turn():
            self._lead("_follow_export", tuple(blocks), tuple(host_blocks))
            names, arrays = self._read_payload(blocks, host_blocks)
            if self._link is None:
                return names, arrays
            parts = self._link.gather(arrays)
        return names, self._kv_whole(parts)

    def _read_payload(self, blocks, host_blocks) -> tuple:
        if host_blocks:
            # The record's refs keep these host blocks allocated, and
            # only the step thread writes host rows, into blocks it owns.
            names = [name for name, _ in self._host.pools()]
            return names, self._host.gather(host_blocks, pin=False)
        return self._gather_blocks(blocks)

    def _follow_export(self, blocks, host_blocks) -> None:
        """A follower's half of an export: its part read to the host (a
        readback, behind the work queued on its stream) and sent to rank
        0."""
        if host_blocks:
            self._land_host(wait=True)
        self._link.gather(self._read_payload(blocks, host_blocks)[1])

    def _whole_param(self, layer, name: str) -> torch.Tensor:
        """Served tensor ``name`` (of layer ``layer``, or top-level when
        None) whole, on the host: on a mesh's leader gathered from every
        rank's block (a record), one tensor at a time."""
        tree = self.params if layer is None else self.params["layers"][layer]
        spec = self._specs.get(name) if self._specs is not None else None
        if spec is None or all(entry is None for entry in spec):
            return tree[name].cpu()
        with self._turn():
            self._lead("_send_param", layer, name)
            blocks = self._link.gather([tree[name].cpu()])
        return gather_leaf([b[0] for b in blocks], spec, self.mesh)

    def _send_param(self, layer, name: str) -> None:
        """A follower's half of ``_whole_param``: its block to rank 0."""
        tree = self.params if layer is None else self.params["layers"][layer]
        self._link.gather([tree[name].cpu()])

    def weight_leaves(self) -> list:
        """The served weights as the reference's flat dict of lazy
        ``JaxLeaf``s (``GET /v1/weights``): on a mesh's leader each part
        gathers its whole tensor from the ranks when it is made, so no
        card and no host buffer holds the whole model at once."""
        if self.mesh is None:
            return jax_leaves(self.params, self.cfg)
        return jax_leaves(whole_meta(self.params, self.cfg, self.mesh),
                          self.cfg, fetch=self._whole_param)

    def _twice_state(self, op: str) -> None:
        """chunk_twice's and admit_twice's device state on every rank:
        ``save`` a copy of it, ``restore`` the copy, ``drop`` it."""
        state = self._device_state()
        if op == "save":
            self._twice_saved = [t.clone() for t in state]
        elif op == "restore":
            for t, saved in zip(state, self._twice_saved):
                t.copy_(saved)
        else:
            self._twice_saved = None

    def _set_graphs(self, on: bool) -> None:
        """admit_twice's switch between eager dispatch and replays."""
        self.cuda_graphs = on

    # -- admission ----------------------------------------------------------

    def _admission_inputs(self, bucket: int, rows: int, entries,
                          draft: bool = False) -> tuple:
        """Host inputs of one admission dispatch of ``rows`` rows at
        ``bucket`` (``_AdmitBuffers.stage``'s arguments): row i from
        ``entries[i]`` = (prompt tail, start, table row); every row past
        them pads, inert as the reference's padding rows are — start 0,
        tail 1 and the sentinel table row, so that K2 drops its writes and
        K1 reads nothing — and its logits are discarded.  ``draft``: the
        draft model's cache tables."""
        n_tables, sentinel = self._n_tables, self._sentinel
        if draft:
            n_tables, sentinel = self._draft_n_tables, self._draft_sentinel
        prompts = np.zeros((rows, bucket), np.int64)
        meta = np.zeros((2, rows), np.int32)
        meta[1] = 1
        tables = np.full((rows, n_tables), sentinel, np.int32)
        for i, (tail, start, table) in enumerate(entries):
            prompts[i, : len(tail)] = tail
            meta[:, i] = start, len(tail)
            tables[i] = table
        return prompts, _AdmitBuffers.pack(meta, tables)

    def _pieces(self, n: int, bucket: int) -> list[tuple[int, int]]:
        """(rows taken, row class) of each dispatch of an ``n``-row group
        at ``bucket``: as many rows as the largest class within the token
        cap, the last dispatch padded to the smallest class that holds
        its rows."""
        classes = self._admit_classes[bucket]
        pieces = []
        while n > 0:
            take = min(n, classes[-1])
            pieces.append((take, next(c for c in classes if c >= take)))
            n -= take
        return pieces

    def _run_admission(self, bucket: int, rows: int) -> None:
        """One admission dispatch over the static buffers' ``rows`` rows
        at ``bucket``, eagerly — or, under a capture, the work that graph
        (bucket, rows) replays: the logits into ``_adm.logits[:rows]``."""
        prompts, meta, tables = self._adm.views(bucket, rows)
        self._adm.logits[:rows].copy_(_admit_logits(
            self.params, self._cache, tables, prompts, meta[0], meta[1],
            self._run_cfg, self.prefill_kernel,
        ))

    def _dispatch_admission(self, bucket: int, rows: int, prompts,
                            ints) -> None:
        """Stage one admission dispatch's host inputs
        (``_admission_inputs``) and run it — by its graph's replay, or
        eagerly with graphs off.  Nothing here waits for the device.  On
        graphs a (bucket, rows) with no graph raises: admission never
        runs eagerly by itself."""
        self._ensure_graphs()
        self._adm.stage(prompts, ints)
        if not self.cuda_graphs:
            self._run_admission(bucket, rows)
            return
        if (bucket, rows) not in self._admit_graphs:
            raise RuntimeError(
                f"no admission graph for bucket {bucket} x {rows} rows "
                f"(captured: {sorted(self._admit_graphs)})"
            )
        graph, delta = self._admit_graphs[bucket, rows]
        graph.replay()
        kernel_counts.replay_counts(delta)
        if not self._warming:
            self.admission_replays += 1

    def _run_draft_admission(self, bucket: int, rows: int) -> None:
        """The draft model's prefill of ``rows`` full prompts at
        ``bucket`` from position 0 over the draft buffers, eagerly or
        under a capture: it writes the draft cache's rows and unembeds
        nothing."""
        prompts, meta, tables = self._dadm.views(bucket, rows)
        _hidden_slots(self.draft_params, prompts, self._draft_cache, meta[0],
                      tables, self.draft_cfg, self.prefill_kernel)

    def _seat_drafting(self, rows) -> None:
        """The speculative half of an admission wave, for the ``rows``
        (slot, rid, req, ...) given their first token: prompt lookup's
        history rows get each whole prompt (a prefix-cache hit's injected
        part included), zero-padded; a draft model's cache is prefilled
        from position 0 over each whole prompt (the prefix cache holds
        target rows only), grouped by the full prompt's bucket — its own
        dispatches, graph replays on graphs as the target's are."""
        if not rows:
            return
        if self._history is not None:
            full = np.zeros((len(rows), self.max_len), np.int64)
            for i, r in enumerate(rows):
                full[i, : len(r[2].tokens)] = r[2].tokens
            slots = np.asarray([r[0] for r in rows], np.int64)
            self._dev("_seat_history", slots, full)
            return
        identity = self._draft_identity_host
        for bucket in sorted({self._bucket(len(r[2].tokens)) for r in rows}):
            group = [r for r in rows if self._bucket(len(r[2].tokens))
                     == bucket]
            for take, cls in self._pieces(len(group), bucket):
                piece, group = group[:take], group[take:]
                self._dev("_dispatch_draft", bucket, cls,
                          *self._admission_inputs(
                              bucket, cls, [(r[2].tokens, 0, identity[r[0]])
                                            for r in piece], draft=True))
                if not self._warming:
                    self.draft_prefill_dispatches += 1
                    self.draft_admission_replays += int(self.cuda_graphs)

    def _seat_history(self, slots: np.ndarray, full: np.ndarray) -> None:
        """Prompt lookup's history rows ``slots`` ← ``full`` [n, max_len]
        (each whole prompt, zero-padded)."""
        self._history[_to_device(slots, self.device)] = _to_device(
            full, self.device)

    def _dispatch_draft(self, bucket: int, rows: int, prompts, ints) -> None:
        """Stage one draft prefill dispatch and run it: its graph's
        replay, or eagerly with graphs off."""
        self._dadm.stage(prompts, ints)
        if not self.cuda_graphs:
            self._run_draft_admission(bucket, rows)
            return
        if (bucket, rows) not in self._draft_graphs:
            raise RuntimeError(
                f"no draft admission graph for bucket {bucket} x {rows} "
                f"rows (captured: {sorted(self._draft_graphs)})")
        graph, delta = self._draft_graphs[bucket, rows]
        graph.replay()
        kernel_counts.replay_counts(delta)

    def _copy_block(self, src: int, dst: int) -> None:
        """Copy-on-write: pool block ``src`` into ``dst`` on every leaf,
        stream-ordered before the tail's writes into ``dst``."""
        cache = self._cache
        for pool in (cache.k, cache.v, cache.k_scale, cache.v_scale):
            if pool is not None:
                copy_block(pool, src, dst)

    def _sample_first(self, piece) -> tuple:
        """Sample the first token of each real row of the admission
        dispatch just run (its logits at the head of ``_adm.logits``),
        eagerly, and seat the rows' penalty counts.  ``piece`` is its
        rows' (slot, rid, req, ...) tuples.  Returns (tokens, logprobs)
        [len(piece)] on the device."""
        reqs = [r[2] for r in piece]
        return self._dev(
            "_first_tokens", np.asarray([r[0] for r in piece], np.int64),
            _columns(reqs, self.default_top_p), [r.seed for r in reqs],
            [r.sample_base for r in reqs],
            [req.tokens for req in reqs] if self.penalties else None)

    def _first_tokens(self, slot_ids, cols, seeds, bases, prompts) -> tuple:
        """``_sample_first``'s device half, from host inputs: the first
        tokens of the ``len(slot_ids)`` rows at the head of
        ``_adm.logits`` and, with penalties, each slot's counts seated
        from its prompt (``prompts``) and first token."""
        dev, vocab, n = self.device, self.cfg.vocab_size, len(slot_ids)
        s = _Sampling(_to_device(cols, dev), *_sampling_key(cols))
        noise = None
        if s.sampled:
            noise = _noise(seeds, bases, cols[0] > 0, 1, vocab, dev)[0]
        counts = None
        if prompts is not None:
            prompt_counts = _to_device(np.stack([
                np.bincount(p, minlength=vocab) for p in prompts
            ]).astype(np.int32), dev)
            counts = (prompt_counts, torch.zeros_like(prompt_counts))
        tokens, lps = _sample_batched(self._adm.logits[:n], s, noise,
                                      self.top_k, counts)
        if prompts is not None:
            idx = _to_device(slot_ids, dev)
            onehot = torch.zeros_like(prompt_counts)
            onehot[torch.arange(n, device=dev), tokens] = 1
            self._tok_counts[idx] = prompt_counts + onehot
            self._gen_counts[idx] = onehot
        return tokens, lps

    def _prefill_segment(self, slot: int, seg: list[int], start: int) -> None:
        """One non-final segment of a chunked prefill: write ``seg``'s KV
        rows into ``slot`` from position ``start`` — one dispatch of the
        (``prefill_chunk``, 1) admission, whose logits nobody reads.  The
        segment is ``prefill_chunk`` long, a bucket, so nothing is
        padded."""
        bucket = len(seg)
        self._dev("_dispatch_admission", bucket, 1, *self._admission_inputs(
            bucket, 1, [(seg, start, self._tables_host[slot])]))
        if not self._warming:
            self.prefill_segments += 1

    def _split_segments(self, tail: list[int], start: int) -> tuple:
        """(segments, final tail) of a prompt tail written from
        ``start``: ``prefill_chunk``-token segments while the tail is
        longer than one, then un-chunked from the back until the final
        bucketed window fits the region."""
        segs = []
        chunk = self.prefill_chunk
        if not chunk:
            return segs, tail
        while len(tail) > chunk:
            segs.append(tail[:chunk])
            tail = tail[chunk:]
        while segs and (start + len(segs) * chunk + self._bucket(len(tail))
                        > self.max_len):
            tail = segs.pop() + tail
        return segs, tail

    def _advance_prefills(self) -> list[_PendingPrefill]:
        """One admission wave's step of every pending prefill: fail the
        cancelled and deadline-expired ones (slot and blocks freed), then
        dispatch ONE further segment of each — the unit that bounds how
        much prefill lands between two decode chunks.  Returns the
        pendings with no segment left: they join this wave's group
        dispatch for their first token (and stay in ``_admitting`` until
        then)."""
        now = time.monotonic()
        with self._lock:
            for rid in list(self._prefilling):
                pend = self._prefilling[rid]
                if rid in self._cancelled:
                    kind, msg = "cancelled", "client went away mid-prefill"
                elif (pend.req.deadline is not None
                      and now >= pend.req.deadline):
                    kind = "deadline"
                    msg = (f"expired mid-prefill "
                           f"({pend.trace.prefill_segments} segments "
                           f"written)")
                    if not self._warming:
                        _metrics.SERVE_DEADLINE_EXPIRED.inc()
                else:
                    continue
                del self._prefilling[rid]
                del self._admitting[rid]
                self._release_slot_locked(pend.slot)
                self._fail_locked(rid, kind, msg, req=pend.req,
                                  t_submit=pend.t_submit)
            advancing = list(self._prefilling.values())
        self._drain_fail_obs()
        joining = []
        for pend in advancing:
            if not pend.segs:
                joining.append(pend)
                continue
            seg = pend.segs.pop(0)
            self._sentinel_ctx = {"phase": "admit", "rids": (pend.rid,)}
            t0 = time.monotonic()
            self._prefill_segment(pend.slot, seg, pend.start)
            pend.trace.segment_walls.append(time.monotonic() - t0)
            pend.trace.prefill_segments += 1
            pend.start += len(seg)
        with self._lock:
            for pend in joining:
                self._prefilling.pop(pend.rid, None)
        return joining

    def _admit_wave(self) -> None:
        """Admit whatever fits into free slots — only with no chunk in
        flight (the pipeline-boundary rule).  Pending chunked prefills
        advance one segment first.  With every slot busy, a QoS head may
        first park one strictly-lower-priority slot.  The queue's head
        (FIFO, or the fair-share pick under a policy) admits next.
        Paged, each request's plan reserves its worst case from the pool,
        aliasing a cached prefix (head-of-line: a shortage leaves it
        queued); dense, a cached prefix is copied in.  A tail longer than
        ``prefill_chunk`` dispatches its first segment and waits; the
        rest, and the pendings whose last segment is written, prefill one
        dispatch per tail bucket, prefixes marked ``cache_prefix`` are
        stored, and every first token is read back at once."""
        if self._inflight is not None:
            return
        t0 = time.monotonic()
        # The admission boundary is the device-write window: staged
        # prefix installs (shipped entries and promotions) land first, so
        # a request of this wave can alias them; then parked slots come
        # back, before new admissions, since they were admitted first.
        self.install_prefix_imports()
        if self._parked:
            self._unpark_wave()
        advanced = bool(self._prefilling)
        joins = self._advance_prefills() if advanced else []
        with self._lock:
            admissions = []
            if self._qos_policy is not None and self._queue and not self._free:
                # Slot-shortage preemption: one victim a wave.
                self._qos_preempt_locked()
            while self._queue and self._free:
                qi = self._qos_head_locked()
                rid, req, t_submit = self._queue[qi]
                plan = None
                if self.paged:
                    imp = (self._kv_imports.get(req.kv_import)
                           if req.kv_import is not None else None)
                    if imp is not None:
                        # A shipped continuation resumes at the shipped
                        # frontier; an expired import falls through to
                        # the recompute plan.
                        plan = self._plan_import_admission_locked(req, imp)
                    else:
                        plan = self._plan_paged_admission_locked(
                            req, idle=not (self._slots or self._admitting
                                           or admissions))
                        if plan is None and self._try_park_locked(req):
                            # The coldest slot went to the host tier,
                            # freeing its blocks and its slot: re-plan
                            # once (one victim a wave keeps it gradual).
                            plan = self._plan_paged_admission_locked(
                                req, idle=False)
                    if plan is None:
                        break
                del self._queue[qi]
                self._qos_charge_locked(req)
                slot = self._free.pop(0)
                if plan is not None:
                    self._tables_host[slot, : len(plan["blocks"])] = (
                        plan["blocks"])
                self._admitting[rid] = slot
                admissions.append((slot, rid, req, t_submit, plan))
        if not admissions and not joins:
            if advanced and not self._warming:
                self.prefill_seconds += time.monotonic() - t0
            return
        self._sentinel_ctx = {
            "phase": "admit",
            "rids": tuple(a[1] for a in admissions)
            + tuple(p.rid for p in joins),
        }
        # One boundary instant for the wave: every admission left the
        # queue at the pop above, and its prefill work starts here.
        t_admitted = t_pf = time.monotonic()
        # (slot, rid, req, t_submit, start, tail, trace) of each final
        # dispatch; a joining pending keeps its first wave's trace.
        rows = []
        for p in joins:
            p.trace.prefill_segments += 1
            rows.append((p.slot, p.rid, p.req, p.t_submit, p.start, p.tail,
                         p.trace))
        for slot, rid, req, t_submit, plan in admissions:
            if plan is None:
                start, source = self._try_prefix_inject(slot, req)
            else:
                start, source = plan["start"], plan.get("source",
                                                        "recomputed")
                ingest = plan.pop("ingest", None)
                if ingest is not None:
                    # A continuation's imported blocks land before its
                    # tail prefill, which reads them, on the same stream.
                    self._write_import_blocks(ingest)
                if plan["cow"] is not None:
                    # Stream-ordered before the tail writes into it; the
                    # shared source block is never written.
                    self._dev("_copy_block", *plan["cow"])
            trace = _PhaseTrace(t_submit=t_submit, t_admitted=t_admitted,
                                t_prefill=t_pf, prefix_source=source,
                                prefill_segments=1)
            segs, tail = self._split_segments(req.tokens[start:], start)
            if segs:
                seg = segs.pop(0)
                t_seg = time.monotonic()
                self._prefill_segment(slot, seg, start)
                trace.segment_walls.append(time.monotonic() - t_seg)
                with self._lock:
                    self._prefilling[rid] = _PendingPrefill(
                        rid=rid, req=req, slot=slot, segs=segs, tail=tail,
                        start=start + len(seg), t_submit=t_submit,
                        trace=trace,
                    )
                continue
            rows.append((slot, rid, req, t_submit, start, tail, trace))
        if not self._warming:
            self.prefill_segments += len(rows)
        groups = []  # (rows, tokens, logprobs) per dispatch
        for bucket in sorted({self._bucket(len(r[5])) for r in rows}):
            group = [r for r in rows if self._bucket(len(r[5])) == bucket]
            for take, cls in self._pieces(len(group), bucket):
                piece, group = group[:take], group[take:]
                self._dev("_dispatch_admission", bucket, cls,
                          *self._admission_inputs(
                              bucket, cls,
                              [(r[5], r[4], self._tables_host[r[0]])
                               for r in piece]))
                groups.append((piece, *self._sample_first(piece)))
        if self.spec_decode:
            self._seat_drafting(rows)
        if self.prefix_cache_size:
            for slot, _, req, *_ in rows:
                if req.cache_prefix:
                    self._store_prefix(slot, req)
        fetched = None
        if groups:  # one readback for every first token of the wave
            self._watch_begin()
            fetched = torch.cat(
                [torch.stack([t.double(), lp.double()])
                 for _, t, lp in groups], dim=1,
            ).cpu().numpy()
            self._watch_end()
        # The combined readback is every admission's first token.
        t_first = time.monotonic()
        if not self._warming:
            self.prefill_seconds += t_first - t0
            self.prefill_dispatches += len(groups)
        finished, notices = [], []
        with self._lock:
            col = 0
            for group, _, _ in groups:
                for slot, rid, req, t_submit, _, _, trace in group:
                    token = int(fetched[0, col])
                    lp = float(fetched[1, col])
                    col += 1
                    if self._admitting.pop(rid, None) is None:
                        continue  # abort() already failed it
                    trace.t_first = t_first
                    state = _SlotState(
                        rid=rid, req=req, t_submit=t_submit,
                        length=len(req.tokens), phases=trace,
                    )
                    if rid in self._cancelled:
                        self._release_slot_locked(slot)
                        self._fail_locked(
                            rid, "cancelled",
                            "client went away during admission",
                            state=state,
                        )
                        continue
                    done = self._emit(state, token, lp)
                    if done:
                        self._finish_locked(slot, state)
                        finished.append(state)
                    else:
                        self._slots[slot] = state
                    on_token = (self._callbacks.pop(rid, None) if done
                                else self._callbacks.get(rid))
                    if on_token is not None:
                        notices.append((on_token, [(token, lp)], done))
        self._deliver(notices)
        self._finalize_done(finished)
        self._drain_fail_obs()

    # -- decode chunks --------------------------------------------------------

    def _fresh_inputs(self, slots: dict):
        """A fresh dispatch's host inputs from the slots' states:
        (``_ChunkInputs``, tokens, starts, indices), every array over all
        ``n_slots`` rows.  A row with no request is not live, keeps the
        neutral columns and starts at 0, and its staged table row is the
        sentinel (``_enqueue_chunk``), so that it reads and writes no KV:
        a pending prefill's rows and a shared prefix block stay as they
        were."""
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
        ``out``/``lps``, the last tokens back into ``tokens``; on a
        speculative engine (``_decode_chunk_spec``) also ``n_emit``, and
        the lengths back into the starts (a draft model's rows with no
        request get its cache's sentinel table row)."""
        b = self._buf
        s = _Sampling(b.cols, *key)
        noise = b.noise if key[0] else None
        if self.spec_decode:
            draft = None
            if self._draft_cache is not None:
                tables = torch.where(b.meta[1][:, None] > 0,
                                     self._draft_identity,
                                     self._draft_sentinel)
                draft = (self.draft_params, self.draft_cfg,
                         self._draft_cache, tables)
            out, lps, n_emit, last, lengths = _decode_chunk_spec(
                self.params, self._cache, b.tables, b.tokens, b.meta[0],
                b.meta[1], s, noise, self._run_cfg, chunk=self.chunk,
                draft_len=self.spec_decode, top_k=self.top_k,
                max_len=self.max_len, history=self._history,
                ngram=self.spec_ngram, draft=draft, kernel=self.paged_kernel,
            )
            b.n_emit.copy_(n_emit)
            b.meta[0].copy_(lengths)
        else:
            counts = None
            if self.penalties:
                counts = (self._tok_counts, self._gen_counts)
            out, lps, last = _decode_chunk(
                self.params, self._cache, b.tables, b.tokens, b.meta[0],
                b.meta[1], s, noise, self._run_cfg, chunk=self.chunk,
                top_k=self.top_k, max_len=self.max_len, counts=counts,
                kernel=self.paged_kernel,
            )
        b.out.copy_(out)
        b.lps.copy_(lps)
        b.tokens.copy_(last)

    def _ensure_graphs(self) -> None:
        """On graphs, capture them all at the first dispatch of either
        kind (``warmup``'s first, on a warmed engine)."""
        if self.cuda_graphs and self._graphs is None:
            with self._turn():
                self._lead("_ensure_graphs")
                self._capture_graphs()

    def _capture_graphs(self) -> None:
        """Capture one CUDA graph of ``_run_chunk`` per ``_GRAPH_KEYS``
        key and one of ``_run_admission`` per bucket and row class within
        the token cap, all into one memory pool (replays never overlap:
        one stream; every graph's inputs and outputs live outside it).
        First each decode key and each bucket at one row runs eagerly on
        inert inputs — every table entry the sentinel (K2 writes nothing,
        K1 reads nothing), no decode row live (no count moves) — which
        builds the kernels and sets their attributes outside a capture
        and changes nothing a slot owns (a row class changes only the
        products' row count).  All eager runs come before the first
        capture, and their cached memory goes back to the card before
        it, so their share and the pool's never add up; the largest
        dispatch is captured first, so that the smaller ones reuse its
        pool blocks and the pool holds about one dispatch's transients.
        The launch counts each capture records are what its replays add
        (``recording``; a path switched off records its plain versions'
        runs, captured on the device like any other op), and each
        capture reports its wall time to the recompile sentinel."""
        t0 = time.monotonic()
        b = self._buf
        b.tables.fill_(self._sentinel)
        b.meta.zero_()
        b.tokens.zero_()
        b.cols.copy_(torch.from_numpy(
            np.repeat(_NEUTRAL[:, None], self.n_slots, axis=1)))
        b.noise.zero_()
        keys = sorted(((bucket, rows) for bucket, classes in
                       self._admit_classes.items() for rows in classes),
                      key=lambda key: -key[0] * key[1])
        draft = self._dadm is not None
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for key in _GRAPH_KEYS:
                self._run_chunk(key)
            for bucket in self.prompt_buckets:
                self._adm.stage(*self._admission_inputs(bucket, 1, []))
                self._run_admission(bucket, 1)
                if draft:
                    self._dadm.stage(*self._admission_inputs(
                        bucket, 1, [], draft=True))
                    self._run_draft_admission(bucket, 1)
        current.wait_stream(side)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        pool = torch.cuda.graph_pool_handle()

        def capture(run, kernel, *key):
            graph = torch.cuda.CUDAGraph()
            t = time.monotonic()
            with kernel_counts.recording(plain=not kernel) as delta, \
                    torch.cuda.graph(graph, pool=pool,
                                     capture_error_mode="thread_local"):
                run(*key)
            _sentinel.report(time.monotonic() - t)
            return graph, delta

        t1 = time.monotonic()
        prefill = self.prefill_kernel
        self._admit_graphs = {key: capture(self._run_admission, prefill,
                                           *key) for key in keys}
        if draft:
            self._draft_graphs = {key: capture(self._run_draft_admission,
                                               prefill, *key)
                                  for key in keys}
        t2 = time.monotonic()
        graphs, counts = {}, {}
        for key in _GRAPH_KEYS:
            graphs[key], counts[key] = capture(self._run_chunk,
                                               self.paged_kernel, key)
        torch.cuda.synchronize(self.device)
        self._graphs, self._graph_counts = graphs, counts
        self.graph_capture_seconds = time.monotonic() - t0
        self.admission_capture_seconds = t2 - t1

    def _enqueue_chunk(self, inputs: _ChunkInputs, tokens, starts, indices,
                       graph: bool):
        """Stage one chunk's inputs into the device buffers (``tokens``
        None: keep the device-side carry; ``starts`` None too, on a
        speculative engine, whose chained chunk takes its positions from
        the carry), fill its noise, run it — by its graph's replay or
        eagerly — and queue the copy of its results to host buffers.
        Returns (the host results in ``_ChunkBuffers.outputs``' order,
        the event that marks them done or None on the CPU).  Nothing here
        waits for the device."""
        tables = self._tables_host.copy()
        tables[inputs.live == 0] = self._sentinel  # K2 drops, K1 skips
        turn = self._dev("_stage_chunk", inputs.key, tables, starts,
                         inputs.live, tokens, inputs.cols, inputs.seeds,
                         indices, graph)
        results = self._buf.results[turn]
        for host, dev in zip(results, self._buf.outputs):
            host.copy_(dev, non_blocking=True)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return results, done

    def _stage_chunk(self, key, tables, starts, live, tokens, cols, seeds,
                     indices, graph: bool) -> int:
        """``_enqueue_chunk``'s device half, from host inputs: stage them
        into the chunk buffers (``starts`` and ``tokens`` None keep the
        device-side carry, as there), fill the noise, run the chunk — by
        graph ``key``'s replay or eagerly.  Returns the staging turn the
        results belong to."""
        b = self._buf
        turn = b.turn
        b.turn ^= 1
        if b.staged[turn] is not None:
            b.staged[turn].synchronize()  # its last copies are done
        stage = b.stages[turn]
        stage["tables"].copy_(torch.from_numpy(tables))
        names = ["tables"]
        if starts is not None:
            # The live rows are reused verbatim by a chained dispatch, so
            # a speculative one leaves the meta (its starts the carry) as
            # the chunk before it left it.
            stage["meta"][0] = torch.from_numpy(starts)
            stage["meta"][1] = torch.from_numpy(live)
            names.append("meta")
        if tokens is not None:
            stage["tokens"].copy_(torch.from_numpy(tokens))
            stage["cols"].copy_(torch.from_numpy(cols))
            names += ["tokens", "cols"]
        for name in names:
            getattr(b, name).copy_(stage[name], non_blocking=True)
        if self.device.type == "cuda":
            b.staged[turn] = torch.cuda.Event()
            b.staged[turn].record()
        if key[0]:
            _noise(seeds, indices, cols[0] > 0, self.chunk,
                   self.cfg.vocab_size, self.device, out=b.noise)
        if graph:
            self._graphs[key].replay()
            kernel_counts.replay_counts(self._graph_counts[key])
        else:
            self._run_chunk(key)
        return turn

    def _dispatch_chunk(self, acc: list,
                        chained: _InFlightChunk | None) -> _InFlightChunk:
        """Dispatch one decode chunk over all ``n_slots`` rows; returns
        its in-flight handle without reading anything back.

        Fresh (``chained`` None, always the dispatch after a boundary):
        every input comes from the slots' host states.  Chained: the
        tokens are the previous chunk's device-side carry, the positions
        and sampling keys the previous dispatch's ``+ chunk`` (clamped at
        the cache edge, live rows only; a speculative chunk's positions
        are the device-side carry as its tokens are, since only the
        device knows how far each row went), and the live rows and sampling
        columns are reused verbatim — a slot that finished meanwhile
        keeps computing inside its own rows (dense) or into dropped
        writes (paged: its table row is the sentinel by now) and is
        skipped at readback.  The table is the current one either way."""
        with self._lock:
            slots = dict(self._slots)
        self._sentinel_ctx = {
            "phase": "decode",
            "rids": tuple(sorted(st.rid for st in slots.values())),
        }
        t0 = time.monotonic()
        if chained is None:
            self._ensure_graphs()
            inputs, tokens, starts, indices = self._fresh_inputs(slots)
        else:
            inputs, tokens, starts = chained.inputs, None, None
            if not self.spec_decode:
                starts = np.minimum(
                    chained.starts + self.chunk * inputs.live,
                    self.max_len - 1,
                ).astype(np.int32)
            # A speculative sampled row emits one token a sub-step, so its
            # keys advance by ``chunk`` too (greedy rows read none).
            indices = chained.indices + self.chunk
        results, done = self._enqueue_chunk(
            inputs, tokens, starts, indices, graph=self.cuda_graphs
        )
        self._mark_dispatch(t0, acc)
        self._step_count += 1
        if not self._warming:
            self.decode_passes += self.chunk
            self.decode_dispatches += 1
            self.graph_replays += int(self.cuda_graphs)
            if self._draft_cache is not None:
                self.draft_passes += self.chunk * (self.spec_decode + 1)
        return _InFlightChunk(
            snapshot=slots, inputs=inputs, starts=starts, indices=indices,
            results=results, done=done, t_dispatch=t0, seq=self._step_count,
            dispatch_wall=time.monotonic() - t0,
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
        budget truncation.  A speculative chunk's row consumes
        ``n_emit[slot, i]`` tokens of sub-step i, and its length advances
        by their sum, clamped as the device clamps it; greedy rows count
        their drafts (``spec_decode`` a sub-step consumed) and the
        accepted drafts consumed."""
        overlapped = self._inflight is not None
        t0 = time.monotonic()
        if handle.done is not None:
            self._watch_begin()
            handle.done.synchronize()
            self._watch_end()
        out, lps, *rest = (t.numpy() for t in handle.results)
        spec = self.spec_decode
        if spec:
            n_emit = rest[0]
        else:  # one token a pass: a [S, chunk, 1] view of each
            out, lps = out[..., None], lps[..., None]
            n_emit = np.ones(out.shape[:2], np.int32)
        t1 = time.monotonic()
        acc[0] += t1 - t0
        if overlapped:
            acc[2] += t1 - t0
        else:
            self._t_device_free = t1
        # Tokens taken, and tokens the chunk made for live rows (the
        # token rate's numerator, the reference's: truncation aside).
        emitted = produced = 0
        edge = self.max_len - 1 - spec  # the device's clamp
        finished, notices = [], []
        with self._lock:
            for slot, state in handle.snapshot.items():
                if self._slots.get(slot) is not state:
                    continue  # finished, failed or aborted meanwhile
                state.length = min(state.length + int(n_emit[slot].sum()),
                                   edge)
                count = bool(spec) and state.req.temperature <= 0.0 and (
                    not self._warming)
                done = False
                taken = 0
                seen = len(state.emitted)
                for i in range(self.chunk):
                    nem = int(n_emit[slot, i])
                    if count:
                        self.spec_drafted += spec
                    for j in range(nem):
                        taken += 1
                        if count and j < nem - 1:
                            self.spec_accepted += 1
                        if self._emit(state, int(out[slot, i, j]),
                                      float(lps[slot, i, j])):
                            done = True
                            break
                    if done:
                        break
                emitted += taken
                produced += int(n_emit[slot].sum())
                if state.phases is not None:
                    # One decode record a chunk the request took tokens
                    # from, clipped to its previous chunk's completion.
                    prev = (state.phases.chunks[-1][2] if state.phases.chunks
                            else state.phases.t_first)
                    state.phases.chunks.append((
                        handle.seq, max(handle.t_dispatch,
                                        prev or handle.t_dispatch),
                        t1, taken, handle.dispatch_wall, t1 - t0,
                    ))
                on_token = (self._callbacks.pop(state.rid, None) if done
                            else self._callbacks.get(state.rid))
                if on_token is not None:
                    notices.append((on_token, list(zip(
                        state.emitted[seen:], state.logprobs[seen:])), done))
                if done:
                    self._finish_locked(slot, state)
                    finished.append(state)
            start = handle.t_dispatch
            if self._t_last_chunk_done is not None:
                start = max(start, self._t_last_chunk_done)
            if not self._warming:
                self.readbacks += 1
                self.decode_seconds += t1 - start
                self.decode_tokens += emitted
                if produced:
                    # The watchdog's baseline and Retry-After's token
                    # rate.  A chunk no live request took (its slots
                    # reaped or aborted) would fold a stall's own wall
                    # into the baseline, so it does not count.
                    wall = t1 - handle.t_dispatch
                    self._chunk_wall_ewma = (
                        wall if self._chunk_wall_ewma is None
                        else 0.7 * self._chunk_wall_ewma + 0.3 * wall)
                    if t1 > start:
                        rate = produced / (t1 - start)
                        self._token_rate_ewma = (
                            rate if self._token_rate_ewma is None
                            else 0.7 * self._token_rate_ewma + 0.3 * rate)
        self._t_last_chunk_done = t1
        self._deliver(notices)
        self._finalize_done(finished)

    @torch.no_grad()
    def chunk_twice(self) -> list[dict]:
        """For checks on the card: one decode chunk for the seated slots
        (as a fresh dispatch would make it), run from the same state
        twice — eagerly, then by its graph's replay — returning what each
        left: ``out``, ``lps``, the token carry, the device state
        (``_device_state``) as tensors, and on a speculative engine
        ``n_emit`` and the lengths carry.  Needs the graphs and no chunk
        in flight; afterwards the device state is as it was before either
        run.  Under a mesh every rank runs both from its own saved state
        (records), the collectives inside the replayed graph."""
        if self._graphs is None or self._inflight is not None:
            raise RuntimeError("chunk_twice needs captured graphs and no "
                               "chunk in flight")
        with self._lock:
            slots = dict(self._slots)
        inputs, tokens, starts, indices = self._fresh_inputs(slots)
        state = self._device_state()
        self._dev("_twice_state", "save")
        runs = []
        for graph in (False, True):
            self._dev("_twice_state", "restore")
            _, done = self._enqueue_chunk(inputs, tokens, starts, indices,
                                          graph)
            if done is not None:
                done.synchronize()
            b = self._buf
            run = {"out": b.out.clone(), "lps": b.lps.clone(),
                   "carry": b.tokens.clone(),
                   "state": [t.clone() for t in state]}
            if self.spec_decode:
                run.update(n_emit=b.n_emit.clone(),
                           lengths=b.meta[0].clone())
            runs.append(run)
        self._dev("_twice_state", "restore")
        self._dev("_twice_state", "drop")
        return runs

    def _device_state(self) -> list[torch.Tensor]:
        """What a decode chunk or an admission wave changes on the
        device: the cache, the penalty counts, prompt lookup's history and
        a draft model's cache."""
        caches = [self._cache]
        if self._draft_cache is not None:
            caches.append(self._draft_cache)
        return [t for t in (
            *(t for c in caches for t in (c.k, c.v, c.k_scale, c.v_scale)),
            self._tok_counts, self._gen_counts, self._history,
        ) if t is not None]

    # What one admission wave changes on the host, restored by
    # ``admit_twice`` between its runs.
    _WAVE_STATE = ("_queue", "_free", "_slots", "_admitting", "_prefilling",
                   "_tables_host", "_alloc", "_prefix_cache", "_prefix_meta",
                   "_results", "_errors", "_cancelled", "_forgotten")

    @torch.no_grad()
    def admit_twice(self) -> list[dict]:
        """For checks on the card: the next admission wave (the queued
        requests that fit, the pending prefills' next segments) run from
        one state twice — eagerly, then by graph replays from that state
        restored — returning what each run left: ``first`` {rid: (token,
        logprob)} of the requests it seated, ``pending`` {rid: next
        segment start} of the prompts mid-prefill, and ``state``, the
        device state (``_device_state``) as tensors.  Needs the graphs and
        no chunk in flight; the engine is left as the replayed wave left
        it.  The check's work is not counted in ``stats()``.  Under a mesh
        every rank runs both from its own saved state (records)."""
        if self._graphs is None or self._inflight is not None:
            raise RuntimeError("admit_twice needs captured graphs and no "
                               "chunk in flight")
        state = self._device_state()
        self._dev("_twice_state", "save")
        with self._lock:
            host = copy.deepcopy({name: getattr(self, name)
                                  for name in self._WAVE_STATE})
        known = set(host["_results"]) | {st.rid for st in
                                         host["_slots"].values()}
        runs = []
        self._warming = True
        try:
            for graphs in (False, True):
                self._dev("_twice_state", "restore")
                with self._lock:
                    for name, value in copy.deepcopy(host).items():
                        setattr(self, name, value)
                self._dev("_set_graphs", graphs)
                self._admit_wave()
                with self._lock:
                    first = {st.rid: (st.emitted[0], st.logprobs[0])
                             for st in self._slots.values()}
                    first.update({rid: (toks[0], lps[0]) for rid, (toks, lps)
                                  in self._results.items()})
                    runs.append({
                        "first": {rid: v for rid, v in first.items()
                                  if rid not in known},
                        "pending": {rid: p.start for rid, p in
                                    self._prefilling.items()},
                        "state": [t.clone() for t in state],
                    })
        finally:
            self._dev("_set_graphs", True)
            self._dev("_twice_state", "drop")
            self._warming = False
        return runs
