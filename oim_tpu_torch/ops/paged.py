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

``copy_block``, ``write_block`` and ``read_block`` move whole blocks of
a stacked pool [n_layers, n_blocks, ...]: copy-on-write of a shared
prefix block.  ``read_blocks`` and ``write_blocks`` move a batch of
blocks in one gather or one scatter a leaf: the KV tier's demotions,
promotions, parks and restores, and KV shipping's exports and imports.
They move bytes, so a packed int4 pool (``torch.uint8``, ``[...,
head_dim / 2]``) and its scale planes move as any other pool does.

Pool contents must stay finite: attention masks the weight of a
position, and ``0 × NaN`` would still poison the output.
"""

from __future__ import annotations

import torch

from oim_tpu_torch.ops.quant import (
    INT4_DTYPE,
    pack_int4,
    quantize_int4,
    quantize_int8,
)


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
    quantizing when ``scale`` [n_blocks, block_size, KVH] is not None:
    the pool's dtype selects the scheme, int8, or packed int4 (a
    ``torch.uint8`` pool of ``hd / 2`` bytes a row).  Rows whose entry is
    the sentinel (or past the table) are dropped.  Returns ``(cache,
    scale)``."""
    n_blocks, block_size = cache.shape[0], cache.shape[1]
    flat, live = _flat_rows(tables, starts, new.shape[1], block_size, n_blocks)
    rows = cache.view(n_blocks * block_size, *cache.shape[2:])
    if scale is None:
        _store_rows(rows, flat, live, new.to(cache.dtype))
        return cache, None
    if cache.dtype == INT4_DTYPE:
        q, s = quantize_int4(new)
        q = pack_int4(q)
    else:
        q, s = quantize_int8(new)
    _store_rows(rows, flat, live, q)
    _store_rows(scale.view(n_blocks * block_size, *scale.shape[2:]), flat,
                live, s)
    return cache, scale


def _store_rows(rows, flat, live, values) -> None:
    """``rows[flat[live]] = values[live]`` without a boolean index, whose
    data-dependent size would wait for the device (and cannot be
    captured in a CUDA graph): every row writes, a dead one the first
    live row's value at that row's place — duplicates that carry equal
    bytes — or, when no row is live, row 0's own value back.  rows [N,
    ...]; flat, live [B, t]; values [B, t, ...]."""
    idx, keep = flat.reshape(-1), live.reshape(-1)
    vals = values.reshape(-1, *rows.shape[1:])
    # The first live row (0 when none is), taken by index_select: a 0-d
    # index tensor would be read back to the host.
    first = torch.argmax(keep.to(torch.int32)).view(1)
    any_live = keep.any()
    fill_idx = torch.where(any_live, idx.index_select(0, first), 0)
    fill = torch.where(any_live, vals.index_select(0, first), rows[:1])
    mask = keep.view(-1, *([1] * (vals.dim() - 1)))
    rows.index_put_((torch.where(keep, idx, fill_idx),),
                    torch.where(mask, vals, fill))


def paged_store_blocks(cache, scale, blocks, block_scales, ids):
    """Land whole blocks in the pool, in place: ``blocks`` [N,
    block_size, KVH, hd] (already-quantized VALUES for an int8 pool, so
    the cast is exact; packed bytes for an int4 pool) at pool blocks
    ``ids`` [N], with ``block_scales``
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


def copy_block(pool, src: int, dst: int):
    """Copy block ``src`` of a stacked pool [n_layers, n_blocks, ...] to
    block ``dst``, in place — the device half of copy-on-write: the
    allocator picks ``dst`` fresh and the engine repoints the diverging
    slot's table at it, so the shared ``src`` is never written again.
    Returns ``pool``."""
    pool[:, dst].copy_(pool[:, src])
    return pool


def write_block(pool, row, dst: int):
    """Write one block's rows ``row`` [n_layers, block_size, ...] at block
    ``dst`` of a stacked pool [n_layers, n_blocks, ...], in place.
    Returns ``pool``."""
    pool[:, dst].copy_(row)
    return pool


def read_block(pool, src: int):
    """A copy of block ``src``'s rows [n_layers, block_size, ...] of a
    stacked pool [n_layers, n_blocks, ...]."""
    return pool[:, src].clone()


def read_blocks(pool, ids):
    """Blocks ``ids`` [N] (int64, on the pool's device) of a stacked pool
    [n_layers, n_blocks, ...] as one new tensor [n_layers, N, ...]: one
    gather, the batched ``read_block``."""
    return pool.index_select(1, ids)


def write_blocks(pool, rows, ids):
    """Write ``rows`` [n_layers, N, ...] at blocks ``ids`` [N] (int64, on
    the pool's device) of a stacked pool [n_layers, n_blocks, ...], in
    place: one scatter, the batched ``write_block``.  Returns ``pool``."""
    pool.index_copy_(1, ids, rows)
    return pool
