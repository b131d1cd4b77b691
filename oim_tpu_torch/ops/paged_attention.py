"""Paged attention straight off the block pool: the Hopper kernels of
the serving path and their plain PyTorch versions.

``paged_flash_decode`` (kernel K1, ``csrc/paged_attention.cu``) replaces
``oim_tpu/ops/paged_attention.py`` ``_decode_kernel``: attention for q
rows at per-slot positions, reading K/V through each slot's block table
with no gathered view, online softmax in f32, GQA folded into the row
axis, int8 and packed int4 dequant fused where the values are consumed.
It has three routes, picked by ``decode_route`` from host-known sizes:
a decode step (at most 8 flattened q rows) takes ``paged_decode_kernel``
with 8-row tiles; a taller bf16 q (a prompt segment) takes
``paged_prefill_tc_kernel`` on the tensor cores with 64-row tiles; a
taller f32 q takes ``paged_decode_kernel`` with 16-row tiles, in exact
f32.  Each splits the slot's table into ranges of ``decode_split``
entries that run as separate blocks and merges their partial softmax
states in a fixed order (``paged_merge_kernel``).  ``paged_kv_store``
(kernel K2, ``paged_store_kernel``) replaces ``_prefill_stage_kernel``
together with its ``paged_store_blocks`` landing: a segment's fresh K/V
rows are written into the slot's blocks in place, quantized exactly as
``quantize_int8`` (an int8 pool) or ``quantize_int4`` then ``pack_int4``
(a packed int4 pool, ``torch.uint8``) do: the pool's dtype selects the
scheme, as ``jnp.int4`` does in the reference.  ``paged_flash_prefill``
is K2 then K1 over the updated pool — a prompt segment's causal prefill
is a tall decode.

Semantics the kernels and the plain versions share (the reference's
exactness contract): sentinel table entries (``>= n_blocks``) are never
read; scores are ``dot / sqrt(hd)``; masked scores take ``NEG_BIG``
(``-1e30``, not ``-inf``); the window keeps ``q_pos - k_pos < window``;
a row with no valid key outputs zeros.  The tensor-core route rounds the
softmax weights (times the v scale, for int8) to bf16 as the operand of
its product with V, as the reference's MXU rounds f32 operands at
default precision; the other routes compute in f32 throughout.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs
the plain version only for CPU tensors.  ``<wrapper>.launches`` counts
kernel launches, ``ROUTE_LAUNCHES`` K1's launches by route and
``<plain>.calls`` plain runs — plain integers that a run reads to show
which path it went through.  A CUDA graph runs the wrappers' Python once,
at capture, and none of it at replay: ``ops/counts.py::recording`` takes
back what a captured region counted and keeps it, and ``replay_counts``
adds it at each replay, so the counts stay launches on the device.
"""

from __future__ import annotations

import torch

from oim_tpu_torch.ops import _build
from oim_tpu_torch.ops.paged import paged_store, paged_view
from oim_tpu_torch.ops.quant import INT4_DTYPE, dequantize_int8, kv_values

# The reference's mask constant (oim_tpu/ops/flash_attention.py
# _NEG_BIG): a fully masked row then yields zeros, never NaN.
NEG_BIG = -1e30
# What the CUDA kernels take: head_dim is a template parameter, and a
# pool block is at most one step of K1's ring.
HEAD_DIMS = (64, 128)
MAX_BLOCK_SIZE = 64
# K1's routes and the flattened q rows (t x group) of one tile of each:
# a slot's rows fall in ceil(t·group / ROUTE_ROWS[route]) tiles, one
# block each.
ROUTE_ROWS = {"rows8": 8, "tc": 64, "rows16": 16}
# decode_split aims for ROUTE_BLOCKS_PER_SM[route] blocks an SM: two on
# the CUDA-core routes; four on the tensor-core route, whose blocks are
# latency-bound (one warp a scheduler at two blocks an SM) and whose
# causal tiles differ in length, so more, shorter blocks overlap better
# (at the smoke's 512- and 100-token prefills 3-6 and 6-8 splits time
# best; PERF.md).
DECODE_BLOCKS_PER_SM = 2
ROUTE_BLOCKS_PER_SM = {"rows8": DECODE_BLOCKS_PER_SM, "tc": 4,
                       "rows16": DECODE_BLOCKS_PER_SM}
# Wrapper launches of K1 by route (see ``decode_route``).
ROUTE_LAUNCHES = {route: 0 for route in ROUTE_ROWS}


def supported_block_size(block_size: int, head_dim: int) -> bool:
    """Whether the CUDA kernels cover this geometry: head_dim 64 or 128
    and 1 <= block_size <= 64.  The engine checks this at construction
    for a CUDA device; the plain versions take any geometry."""
    return head_dim in HEAD_DIMS and 1 <= block_size <= MAX_BLOCK_SIZE


def pool_head_dim(pool) -> int:
    """The head_dim of a pool [n_blocks, block_size, kv_heads, ...]: its
    last dimension, twice that for packed int4 (two values a byte)."""
    return pool.shape[-1] * (2 if pool.dtype == INT4_DTYPE else 1)


def _check_kernel_geometry(what: str, block_size: int,
                           head_dim: int) -> None:
    if not supported_block_size(block_size, head_dim):
        raise ValueError(
            f"{what} kernel needs head_dim in {HEAD_DIMS} and block_size in "
            f"[1, {MAX_BLOCK_SIZE}]; got head_dim={head_dim}, "
            f"block_size={block_size}"
        )


def _check_shapes(what: str, rows: int, k_pool, v_pool, k_scale, v_scale,
                  tables, starts) -> None:
    """Raise unless the operands agree: pools [n_blocks, block_size,
    kv_heads, head_dim] alike (``head_dim / 2`` bytes for packed int4),
    scales [n_blocks, block_size, kv_heads] (both or neither), tables
    [rows, n_tables], starts [rows].  The kernels index with these
    shapes, so a mismatch would read or write out of bounds."""
    if (k_pool.dim() != 4 or v_pool.shape != k_pool.shape
            or v_pool.dtype != k_pool.dtype):
        raise ValueError(
            f"{what}: pools {tuple(k_pool.shape)} {k_pool.dtype} and "
            f"{tuple(v_pool.shape)} {v_pool.dtype} must both be "
            f"[n_blocks, block_size, kv_heads, head_dim] of one dtype "
            f"(head_dim / 2 bytes for packed int4)"
        )
    if k_pool.dtype == INT4_DTYPE and k_scale is None:
        raise ValueError(f"{what}: a packed int4 pool takes f32 scales")
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{what}: pass both scale planes or neither")
    for scale in (k_scale, v_scale):
        if scale is not None and scale.shape != k_pool.shape[:3]:
            raise ValueError(
                f"{what}: scales {tuple(scale.shape)} must be "
                f"{tuple(k_pool.shape[:3])}"
            )
    if tables.dim() != 2 or tables.shape[0] != rows or tuple(
            starts.shape) != (rows,):
        raise ValueError(
            f"{what}: tables {tuple(tables.shape)} and starts "
            f"{tuple(starts.shape)} must be [{rows}, n_tables] and [{rows}]"
        )


def _check_kernel_operands(what: str, x, k_pool, v_pool, k_scale, v_scale,
                           tables, starts, v_new=None) -> None:
    """Raise unless a kernel takes these operands as they are: its
    geometry, int8 or packed int4 pools with f32 scales or fp pools of
    ``x``'s dtype (``x`` is q or the new K, ``v_new`` the new V) with
    none, int32 tables and starts, every tensor contiguous on ``x``'s
    device, and those moved in 16-byte vectors aligned to 16 bytes."""
    block_size, hd = k_pool.shape[1], pool_head_dim(k_pool)
    _check_kernel_geometry(what, block_size, hd)
    quantized = k_scale is not None
    if quantized != (k_pool.dtype in (torch.int8, INT4_DTYPE)):
        raise ValueError(f"{what}: int8 and int4 pools take f32 scales; "
                         f"fp pools take none")
    if not quantized and k_pool.dtype != x.dtype:
        raise ValueError(
            f"{what}: {x.dtype} operand and fp pool {k_pool.dtype} must "
            f"share a dtype"
        )
    if quantized and (k_scale.dtype != torch.float32
                      or v_scale.dtype != torch.float32):
        raise ValueError(f"{what}: pool scales must be float32")
    for name, t in dict(x=x, v_new=v_new, k_pool=k_pool, v_pool=v_pool,
                        k_scale=k_scale, v_scale=v_scale, tables=tables,
                        starts=starts).items():
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(
                f"{what}: {name} on {t.device}, expected {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if tables.dtype != torch.int32 or starts.dtype != torch.int32:
        raise ValueError(f"{what}: tables and starts must be int32")
    if any(t.data_ptr() % 16 for t in (x, v_new, k_pool, v_pool)
           if t is not None):
        raise ValueError(f"{what}: the kernels move q, the new rows and "
                         f"the pools in 16-byte vectors: align them")
    if k_pool.numel() // k_pool.shape[-1] >= 2**31:
        raise ValueError(f"{what}: the kernels index pool rows in 32 bits")


def _code(what: str, dtype) -> int:
    try:
        return _build.DTYPE_CODES[dtype]
    except KeyError:
        raise ValueError(f"{what}: unsupported dtype {dtype}") from None


# ---------------------------------------------------------------------------
# K1: paged flash-decode


def paged_flash_decode_plain(
    q, k_pool, v_pool, k_scale, v_scale, tables, starts, *, window: int = 0
):
    """Plain PyTorch version of ``paged_flash_decode`` (same signature):
    gather each slot's blocks into a dense view, mask positions past the
    row's frontier, outside the window or in a sentinel block, softmax
    in f32.  Rows with no valid key emit zeros, as the kernel does."""
    paged_flash_decode_plain.calls += 1
    b, t, h, hd = q.shape
    n_blocks, block_size, kvh = k_pool.shape[:3]
    group = h // kvh
    k_view, ks_view = paged_view(k_pool, k_scale, tables)
    v_view, vs_view = paged_view(v_pool, v_scale, tables)
    k = (k_view.float() if ks_view is None
         else dequantize_int8(kv_values(k_view), ks_view))
    v = (v_view.float() if vs_view is None
         else dequantize_int8(kv_values(v_view), vs_view))
    qg = q.float().reshape(b, t, kvh, group, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) / (hd**0.5)
    n_keys = k.shape[1]
    q_pos = starts.to(torch.int64)[:, None] + torch.arange(t, device=q.device)
    k_pos = torch.arange(n_keys, device=q.device)
    live = (tables < n_blocks).repeat_interleave(block_size, dim=1)
    keep = (k_pos[None, None, :] <= q_pos[:, :, None]) & live[:, None, :]
    if window:
        keep &= q_pos[:, :, None] - k_pos[None, None, :] < window
    scores = torch.where(keep[:, None, None], scores, NEG_BIG)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    out = torch.where(keep.any(-1)[:, :, None, None, None], out, 0.0)
    return out.reshape(b, t, h, hd)


paged_flash_decode_plain.calls = 0


def decode_split(batch_kv: int, tiles: int, n_tables: int, sms: int,
                 per_sm: int = DECODE_BLOCKS_PER_SM) -> int:
    """Table entries each split of K1 walks, given B·KVH, the q-row
    tiles of a slot on the route K1 launches (``ceil(t·group /
    ROUTE_ROWS[route])``), the table's entries and the card's SM count
    — host-known sizes only, so the engine's passes never sync to size
    the grid.  The fewest splits whose grid (tiles × B·KVH × splits)
    reaches ``per_sm`` blocks an SM (the route's ``ROUTE_BLOCKS_PER_SM``),
    at most one a table entry, then the entries that cut the table into
    that many ranges.  At decode a slot's walk is otherwise one serial
    chain on a near-empty card; a prefill whose tiles already fill the
    card keeps one split."""
    if n_tables < 1:
        return 1
    per_split = max(1, batch_kv * tiles)
    splits = max(1, min(n_tables, -(-per_sm * sms // per_split)))
    return -(-n_tables // splits)


def decode_route(dtype, t: int, group: int) -> str:
    """K1's route for q of ``dtype`` with ``t`` rows a slot and a GQA
    group of ``group``: ``"rows8"`` when the t·group flattened rows fit
    one 8-row tile (every decode step), else ``"tc"`` for bf16 q (the
    tensor cores) and ``"rows16"`` for f32 q (CUDA cores, exact f32)."""
    if t * group <= ROUTE_ROWS["rows8"]:
        return "rows8"
    return "tc" if dtype == torch.bfloat16 else "rows16"


def decode_plan(dtype, b: int, t: int, h: int, kvh: int, n_tables: int,
                sms: int, splits: int | None = None) -> tuple[str, int]:
    """(route, table entries a split) of one K1 launch, from host-known
    sizes only: the route by ``decode_route``; the entries by
    ``decode_split`` over that route's tiles and blocks an SM, or the
    ones that cut the table into ``splits`` ranges when the caller forces
    a count."""
    route = decode_route(dtype, t, h // kvh)
    if splits is not None:
        return route, max(1, -(-n_tables // splits))
    tiles = -(-t * (h // kvh) // ROUTE_ROWS[route])
    return route, decode_split(b * kvh, tiles, n_tables, sms,
                               ROUTE_BLOCKS_PER_SM[route])


def paged_flash_decode(
    q, k_pool, v_pool, k_scale, v_scale, tables, starts, *, window: int = 0,
    splits: int | None = None,
):
    """Attention for q rows straight off the paged pool.

    q: [B, t, H, hd] (f32 or bf16); k_pool/v_pool: [n_blocks,
    block_size, KVH, hd] (f32, bf16 or int8; packed int4: ``torch.uint8``
    of hd / 2 bytes); k_scale/v_scale: [n_blocks, block_size, KVH] f32
    for int8 and int4 pools, else None; tables:
    [B, n_tables] int32, sentinel entry ``n_blocks``; starts: [B] int32
    — q row i of slot b sits at position ``starts[b] + i`` and attends
    positions ``<=`` it (within ``window`` when > 0).  Returns [B, t, H,
    hd] float32.  ``splits`` asks K1 to cut each table into that many
    ranges of ``ceil(n_tables / splits)`` entries (None: ``decode_plan``'s
    choice); it shapes only the kernel's grid, not the result.  CUDA
    tensors launch K1 on the route ``decode_route`` picks (one launch
    counted a call, the merge of the splits included); CPU tensors run
    the plain version."""
    if splits is not None and splits < 1:
        raise ValueError(f"paged_flash_decode: splits {splits} must be >= 1")
    b, t, h, hd = q.shape
    _check_shapes("paged_flash_decode", b, k_pool, v_pool, k_scale,
                  v_scale, tables, starts)
    n_blocks, block_size, kvh = k_pool.shape[:3]
    pool_hd = pool_head_dim(k_pool)
    if h % kvh or hd != pool_hd:
        raise ValueError(
            f"paged_flash_decode: q {tuple(q.shape)} needs a multiple of "
            f"{kvh} heads of {pool_hd}"
        )
    if not q.is_cuda:
        return paged_flash_decode_plain(
            q, k_pool, v_pool, k_scale, v_scale, tables, starts,
            window=window,
        )
    q = q.contiguous()
    _check_kernel_operands("paged_flash_decode", q, k_pool, v_pool, k_scale,
                           v_scale, tables, starts)
    n_tables = tables.shape[1]
    route, entries = decode_plan(q.dtype, b, t, h, kvh, n_tables,
                                 _build.sm_count(q.device), splits)
    n_splits = max(1, -(-n_tables // entries))
    out = torch.empty((b, t, h, hd), dtype=torch.float32, device=q.device)
    partials = None
    if n_splits > 1:
        partials = torch.empty(n_splits * b * t * h * (hd + 2),
                               dtype=torch.float32, device=q.device)
    lib = _build.library()
    launch = (lib.oim_paged_prefill_tc if route == "tc"
              else lib.oim_paged_flash_decode)
    code = launch(
        _build.ptr(q), _code("q", q.dtype),
        _build.ptr(k_pool), _build.ptr(v_pool), _code("pool", k_pool.dtype),
        _build.ptr(k_scale), _build.ptr(v_scale),
        _build.ptr(tables), _build.ptr(starts), _build.ptr(out),
        _build.ptr(partials), b, t, h, kvh, hd, n_blocks, block_size,
        n_tables, int(window), entries, _build.stream_of(q),
    )
    _build.check(code, f"paged_flash_decode ({route} route)")
    paged_flash_decode.launches += 1
    ROUTE_LAUNCHES[route] += 1
    return out


paged_flash_decode.launches = 0


# ---------------------------------------------------------------------------
# K2: prefill K/V store with fused quant


def paged_kv_store_plain(
    k_new, v_new, k_pool, v_pool, k_scale, v_scale, tables, starts
):
    """Plain PyTorch version of ``paged_kv_store`` (same signature):
    ``paged_store`` of K and of V, in place."""
    paged_kv_store_plain.calls += 1
    paged_store(k_pool, k_scale, k_new, tables, starts)
    paged_store(v_pool, v_scale, v_new, tables, starts)


paged_kv_store_plain.calls = 0


def paged_kv_store(k_new, v_new, k_pool, v_pool, k_scale, v_scale, tables,
                   starts):
    """Write a segment's ``k_new``/``v_new`` [B, t, KVH, hd] at
    positions ``starts[b] .. starts[b] + t - 1`` of each slot's blocks,
    IN PLACE — int8 pools quantize each [position, kv-head] row exactly
    as ``quantize_int8`` does, packed int4 pools as ``quantize_int4``
    then ``pack_int4`` do.  Rows whose table entry is the sentinel
    or lies past the table are dropped; rows outside the window are not
    touched.  The pool bytes afterwards equal ``paged_store``'s.  CUDA
    tensors launch K2; CPU tensors run the plain version."""
    b, t, kvh, hd = k_new.shape
    _check_shapes("paged_kv_store", b, k_pool, v_pool, k_scale, v_scale,
                  tables, starts)
    if (tuple(k_new.shape[2:]) != (k_pool.shape[2], pool_head_dim(k_pool))
            or v_new.shape != k_new.shape):
        raise ValueError(
            f"paged_kv_store: new K/V {tuple(k_new.shape)} and "
            f"{tuple(v_new.shape)} must be [{b}, t, "
            f"{k_pool.shape[2]}, {pool_head_dim(k_pool)}]"
        )
    if not k_new.is_cuda:
        paged_kv_store_plain(
            k_new, v_new, k_pool, v_pool, k_scale, v_scale, tables, starts
        )
        return
    if v_new.dtype != k_new.dtype:
        raise ValueError("k_new and v_new must share a dtype")
    k_new, v_new = k_new.contiguous(), v_new.contiguous()
    _check_kernel_operands("paged_kv_store", k_new, k_pool, v_pool, k_scale,
                           v_scale, tables, starts, v_new=v_new)
    n_blocks, block_size = k_pool.shape[0], k_pool.shape[1]
    code = _build.library().oim_paged_kv_store(
        _build.ptr(k_new), _build.ptr(v_new), _code("new", k_new.dtype),
        _build.ptr(k_pool), _build.ptr(v_pool), _code("pool", k_pool.dtype),
        _build.ptr(k_scale), _build.ptr(v_scale),
        _build.ptr(tables), _build.ptr(starts),
        b, t, kvh, hd, n_blocks, block_size, tables.shape[1],
        _build.stream_of(k_new),
    )
    _build.check(code, "paged_kv_store")
    paged_kv_store.launches += 1
    if t == 1:
        paged_kv_store.decode_launches += 1


paged_kv_store.launches = 0
paged_kv_store.decode_launches = 0  # of them, t = 1 (a decode step)


def paged_flash_prefill(
    q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, tables, starts,
    *, window: int = 0,
):
    """One segment's causal attention straight off (and into) the paged
    pool: store ``k_new``/``v_new`` [B, t, KVH, hd] into the write window
    ``[starts[b], starts[b] + t)`` (``paged_kv_store``, in place), then
    attend over the updated pool (``paged_flash_decode``).  Returns
    ``(out [B, t, H, hd] float32, k_pool, v_pool, k_scale, v_scale)`` at
    the reference's signature; the pool tensors are the ones passed in,
    updated in place."""
    paged_kv_store(k_new, v_new, k_pool, v_pool, k_scale, v_scale, tables,
                   starts)
    out = paged_flash_decode(
        q, k_pool, v_pool, k_scale, v_scale, tables, starts, window=window
    )
    return out, k_pool, v_pool, k_scale, v_scale


def reset_counters() -> None:
    """Zero every launch, route and plain-call count."""
    replay_counts({name: -n for name, n in counters().items()})


def counters() -> dict:
    """Current launch, route and plain-call counts by name."""
    return {
        "paged_flash_decode": paged_flash_decode.launches,
        **{f"paged_flash_decode_{route}": n
           for route, n in ROUTE_LAUNCHES.items()},
        "paged_kv_store": paged_kv_store.launches,
        "paged_kv_store_t1": paged_kv_store.decode_launches,
        "paged_flash_decode_plain": paged_flash_decode_plain.calls,
        "paged_kv_store_plain": paged_kv_store_plain.calls,
    }


def replay_counts(delta: dict) -> None:
    """Add ``delta``'s counts under ``counters()``'s names (others are
    ignored): a replay of a captured region adds what
    ``ops/counts.py::recording`` kept for it."""
    paged_flash_decode.launches += delta["paged_flash_decode"]
    for route in ROUTE_LAUNCHES:
        ROUTE_LAUNCHES[route] += delta[f"paged_flash_decode_{route}"]
    paged_kv_store.launches += delta["paged_kv_store"]
    paged_kv_store.decode_launches += delta["paged_kv_store_t1"]
    paged_flash_decode_plain.calls += delta["paged_flash_decode_plain"]
    paged_kv_store_plain.calls += delta["paged_kv_store_plain"]
