"""Paged-KV store/gather primitives (the vLLM PagedAttention layout).

The serving engine's paged cache is a global pool of fixed-size blocks
``[n_layers, n_blocks, block_size, kv_heads, head_dim]`` plus a
host-managed per-slot block table: logical position ``p`` of slot ``s``
lives at pool row ``table[s, p // block_size] * block_size + p %
block_size``.  The sentinel block id ``n_blocks`` marks an unallocated
entry (padding admissions, freed slots).

JAX's ``.at[].set(mode="drop")`` silently drops writes through a
sentinel; torch indexing raises on an out-of-range index instead, so
every store here masks those rows out explicitly before it scatters.
Stores update the pool IN PLACE (the JAX versions return new arrays):
the engine owns one pool and never needs the old contents back, so a
functional copy would only cost a second pool's worth of memory.

Pool contents must stay finite: attention masks the weight of a
position, and ``0 × NaN`` would still poison the output.
"""

from __future__ import annotations

import torch

from oim_tpu_torch.ops.quant import quantize_int8


def _flat_rows(tables, starts, t: int, block_size: int, n_blocks: int):
    """(flat pool-row index [B, t], live mask [B, t]) for ``t``
    consecutive positions per row starting at ``starts`` [B].  A row is
    live when its position is not negative, its table entry exists
    (entry < n_tables) and is not the sentinel."""
    n_tables = tables.shape[1]
    pos = starts.to(torch.int64)[:, None] + torch.arange(
        t, device=tables.device
    )[None, :]
    entry = pos // block_size
    in_table = entry < n_tables
    blk = torch.gather(
        tables.to(torch.int64), 1, entry.clamp(0, n_tables - 1)
    )
    live = (pos >= 0) & in_table & (blk < n_blocks)
    return blk * block_size + pos % block_size, live


def paged_store(cache, scale, new, tables, starts):
    """Write ``new`` [B, t, KVH, hd] at logical positions ``starts``
    [B] .. ``starts + t - 1`` through ``tables`` [B, n_tables] into the
    one-layer pool ``cache`` [n_blocks, block_size, KVH, hd], in place —
    quantizing to int8 when ``scale`` [n_blocks, block_size, KVH] is not
    None.  Rows whose entry is the sentinel (or past the table) are
    dropped.  Returns ``(cache, scale)``."""
    n_blocks, block_size = cache.shape[0], cache.shape[1]
    flat, live = _flat_rows(tables, starts, new.shape[1], block_size, n_blocks)
    idx = flat[live]
    rows = cache.view(n_blocks * block_size, *cache.shape[2:])
    if scale is None:
        rows[idx] = new[live].to(cache.dtype)
        return cache, None
    q, s = quantize_int8(new)
    rows[idx] = q[live]
    scale.view(n_blocks * block_size, *scale.shape[2:])[idx] = s[live]
    return cache, scale


def paged_store_blocks(cache, scale, blocks, block_scales, ids):
    """Land whole blocks in the pool, in place: ``blocks`` [N,
    block_size, KVH, hd] (already-quantized VALUES for an int8 pool, so
    the cast is exact) at pool blocks ``ids`` [N], with ``block_scales``
    [N, block_size, KVH] landing in ``scale`` (or None for fp pools).
    Sentinel ids (``>= n_blocks``) drop.  Returns ``(cache, scale)``."""
    live = ids < cache.shape[0]
    cache[ids[live]] = blocks[live].to(cache.dtype)
    if scale is None:
        return cache, None
    scale[ids[live]] = block_scales[live].to(scale.dtype)
    return cache, scale


def paged_view(cache, scale, tables):
    """Gather each row's blocks into one contiguous per-slot view:
    cache [n_blocks, block_size, ...] + tables [B, n_tables] → [B,
    n_tables * block_size, ...] (plus the matching scale view, or None).
    Sentinel entries clamp to the last pool block, so the rows they
    produce are whatever that block holds; consumers mask them."""
    n_blocks = cache.shape[0]
    b, n_tables = tables.shape
    idx = tables.to(torch.int64).clamp(max=n_blocks - 1)
    view = cache[idx].reshape(b, n_tables * cache.shape[1], *cache.shape[2:])
    if scale is None:
        return view, None
    sview = scale[idx].reshape(b, n_tables * scale.shape[1], *scale.shape[2:])
    return view, sview
