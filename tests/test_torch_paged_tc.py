"""K1's tensor-core route, on the CPU.

A prompt segment's attention (bf16 q with more than 8 flattened t x
group rows a slot) runs on ``paged_prefill_tc_kernel``
(``csrc/paged_attention.cu``), which runs only on the card
(``tests/test_torch_kernels.py``).  This file pins what the CPU can
check around it:

- the route choice and the grid it is sized by, from host-known sizes
  only (``decode_route``, ``decode_plan``);
- the kernel's arithmetic, emulated in plain PyTorch as the kernel does
  it: 64-row tiles of the flattened rows, each tile's key range clipped
  to its causal frontier and window, 32-key steps walked from the range's
  start with a step of sentinel entries alone skipped, scores in base 2,
  int8 values kept exact and their scales out of the products (k_scale
  on a score column after Q Kᵀ, v_scale folded into P's column), P
  rounded to bf16 as the operand of P V while the row sum takes the f32
  p, the online softmax carried step by step, and the splits merged in
  split order.

The emulation is held against ``paged_flash_decode_plain`` over bf16 and
int8 pools, windows 0 and 5, starts that straddle blocks, a slot whose
table turns sentinel, an all-sentinel slot, a sentinel hole, ragged row
counts (21 and 120 rows: not multiples of the tile, and a tile boundary
inside a position's group) and every split; and against the reference's
``oim_tpu.ops.paged_attention.paged_flash_prefill``, run as the JAX
package's own tests run it here (the Pallas kernels in interpret mode).

Tolerance: rounding a weight p (int8: p times its v scale) to bf16 moves
it by at most 2**-8 of itself (8 significant bits, round to nearest), so
an output Σ p̃_j v_j / Σ p_j moves by at most 2**-8 of the largest
|v_j| (dequantized) it attends; the rest is f32 summation order over at
most 64 keys, below 1e-5.  So ``2**-8 · max|V| + 1e-5``.  A wrong range,
mask, scale or merge weight moves outputs by O(0.1) of max|V|.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oim_tpu.ops import paged_attention as jpa
from oim_tpu_torch.ops import paged_attention as tpa
from oim_tpu_torch.ops.quant import dequantize_int8

N_BLOCKS, BS, KVH, HD, H, N_TABLES = 80, 4, 2, 16, 6, 16
GROUP = H // KVH
TILE = tpa.ROUTE_ROWS["tc"]
STEP = 32  # keys a step stages (csrc/paged_attention.cu kTcKeys)
LOG2E = 1.4426950408889634
BF16_STEP = 2.0**-8


@pytest.mark.parametrize("dtype,t,group,want", [
    (torch.bfloat16, 1, 6, "rows8"),   # a decode step of the served model
    (torch.bfloat16, 1, 8, "rows8"),   # 8 rows: still one 8-row tile
    (torch.bfloat16, 1, 9, "tc"),
    (torch.bfloat16, 2, 6, "tc"),
    (torch.bfloat16, 512, 6, "tc"),    # an admission segment
    (torch.float32, 1, 6, "rows8"),
    (torch.float32, 512, 6, "rows16"),  # the f32 reference route
])
def test_decode_route_by_dtype_and_rows(dtype, t, group, want):
    assert tpa.decode_route(dtype, t, group) == want


@pytest.mark.parametrize("dtype,b,t,splits,want", [
    # The smoke's decode on an H100: one 8-row tile, 16 splits of 8.
    (torch.bfloat16, 8, 1, None, ("rows8", 8)),
    # Its 512-token prefill on the tc route: 48 tiles of 64 rows x 2
    # slots x 2 kv heads = 192 blocks, short of 4 an SM: three splits.
    (torch.bfloat16, 2, 512, None, ("tc", 43)),
    # The same rows on the f32 route: 192 tiles of 16 already fill 2 an
    # SM.
    (torch.float32, 2, 512, None, ("rows16", 128)),
    # A ragged 100-token segment over 3 slots: 10 tiles, 9 splits.
    (torch.bfloat16, 3, 100, None, ("tc", 15)),
    # A forced count cuts the table evenly, whatever the route.
    (torch.bfloat16, 2, 512, 4, ("tc", 32)),
])
def test_decode_plan_sizes_the_grid_by_its_route(dtype, b, t, splits, want):
    """The split rule counts the tiles of the route K1 launches (64 rows
    on the tensor cores, not the CUDA-core route's 16) against that
    route's blocks an SM, from host sizes only: no tensor is read."""
    assert tpa.decode_plan(dtype, b, t, 12, 2, 128, 132, splits) == want
    route, _ = want
    tiles = -(-t * 6 // tpa.ROUTE_ROWS[route])
    if splits is None:
        assert want[1] == tpa.decode_split(
            b * 2, tiles, 128, 132, tpa.ROUTE_BLOCKS_PER_SM[route])


def _case(rng, quant):
    """A pool of 4-row blocks and five slots over 16 table entries (64
    positions): fully live; live for six entries, then sentinel (whole
    steps of sentinels follow); all sentinel; a sentinel hole at entries
    2-3; live but for its last half."""
    shape = (N_BLOCKS, BS, KVH, HD)
    if quant:
        pools = [torch.from_numpy(
            rng.randint(-127, 128, shape).astype(np.int8)) for _ in range(2)]
        pools += [torch.from_numpy(
            (rng.rand(*shape[:-1]) * 0.05 + 0.01).astype(np.float32))
            for _ in range(2)]
    else:
        pools = [torch.from_numpy(rng.randn(*shape).astype(np.float32))
                 .to(torch.bfloat16) for _ in range(2)] + [None, None]
    tables = torch.from_numpy(
        rng.permutation(N_BLOCKS)[:5 * N_TABLES].reshape(5, N_TABLES)
        .astype(np.int32))
    tables[1, 6:] = N_BLOCKS
    tables[2] = N_BLOCKS
    tables[3, 2:4] = N_BLOCKS
    tables[4, 8:] = N_BLOCKS
    return pools, tables


def _starts(t):
    """Slot starts (mid-block where they can be) whose last row stays
    inside the 64 positions."""
    return torch.tensor([min(17, 64 - t), min(9, 64 - t), 3,
                         min(22, 64 - t), min(5, 64 - t)], dtype=torch.int32)


def _emulate(q, k_pool, v_pool, k_scale, v_scale, tables, starts, window,
             entries):
    """The tensor-core kernel's arithmetic in plain PyTorch (module
    docstring).  Returns (out [B, t, H, hd] f32, how many steps were
    skipped as sentinel-only, how many (tile, split) blocks had nothing
    to attend)."""
    b, t, h, hd = q.shape
    n_blocks, bs, kvh, _ = k_pool.shape
    group, n_tables = h // kvh, tables.shape[1]
    n_splits = max(1, -(-n_tables // entries))
    quant = k_scale is not None
    c2 = torch.tensor(LOG2E / math.sqrt(hd), dtype=torch.float32)
    rows = t * group
    out = torch.zeros((b, t, h, hd))
    dead_steps = empty = 0
    for slot in range(b):
        start = int(starts[slot])
        for kh in range(kvh):
            qr = q[slot, :, kh * group:(kh + 1) * group].reshape(rows, hd)
            qr = qr.float()
            o = torch.zeros((rows, hd))
            for r0 in range(0, rows, TILE):
                r1 = min(rows, r0 + TILE)
                q_pos = start + torch.arange(r0, r1) // group
                states = []
                for split in range(n_splits):
                    e_lo = split * entries
                    e_hi = min(e_lo + entries, n_tables)
                    k_lo = e_lo * bs
                    k_hi = min(e_hi * bs, int(q_pos[-1]) + 1)
                    if window:
                        k_lo = max(k_lo, int(q_pos[0]) - window + 1)
                    n_steps = -(-(k_hi - k_lo) // STEP) if k_lo < k_hi else 0
                    m = torch.full((r1 - r0,), tpa.NEG_BIG)
                    l = torch.zeros(r1 - r0)
                    acc = torch.zeros((r1 - r0, hd))
                    walked = False
                    for i in range(n_steps):
                        kb = k_lo + STEP * i
                        ents = tables[slot, kb // bs:(min(kb + STEP, k_hi)
                                                      - 1) // bs + 1]
                        if not bool((ents < n_blocks).any()):
                            dead_steps += 1
                            continue
                        walked = True
                        kp = kb + torch.arange(STEP)
                        blk = tables[slot, (kp // bs).clamp(max=n_tables - 1)]
                        valid = (kp < k_hi) & (blk < n_blocks)
                        at = (blk.long().clamp(max=n_blocks - 1), kp % bs, kh)
                        k = torch.where(valid[:, None], k_pool[at].float(), 0.0)
                        v = torch.where(valid[:, None], v_pool[at].float(), 0.0)
                        s = qr[r0:r1] @ k.T
                        if quant:
                            s = s * torch.where(valid, k_scale[at], 0.0)
                        keep = valid[None] & (kp[None] <= q_pos[:, None])
                        if window:
                            keep &= q_pos[:, None] - kp[None] < window
                        s = torch.where(keep, s * c2, tpa.NEG_BIG)
                        m_next = torch.maximum(m, s.amax(-1))
                        alpha = torch.exp2(m - m_next)
                        p = torch.where(keep, torch.exp2(s - m_next[:, None]),
                                        0.0)
                        l = l * alpha + p.sum(-1)
                        if quant:
                            p = p * torch.where(valid, v_scale[at], 0.0)
                        p = p.to(torch.bfloat16).float()
                        acc = acc * alpha[:, None] + p @ v
                        m = m_next
                    if not walked:
                        empty += 1
                        states.append((torch.full((r1 - r0,), tpa.NEG_BIG),
                                       torch.zeros(r1 - r0), None))
                        continue
                    states.append((m * math.log(2.0), l, acc))
                if n_splits == 1:
                    _, l, acc = states[0]
                    if acc is not None:
                        o[r0:r1] = acc / l.clamp_min(1e-30)[:, None]
                    continue
                # paged_merge_kernel, in split order; l = 0 skipped.
                big = torch.full((r1 - r0,), tpa.NEG_BIG)
                for m, l, _ in states:
                    big = torch.where(l > 0, torch.maximum(big, m), big)
                num = torch.zeros((r1 - r0, hd))
                den = torch.zeros(r1 - r0)
                for m, l, acc in states:
                    if acc is None:
                        continue
                    e = torch.where(l > 0, torch.exp(m - big), 0.0)
                    num += e[:, None] * acc
                    den += e * l
                o[r0:r1] = num / den.clamp_min(1e-30)[:, None]
            out[slot, :, kh * group:(kh + 1) * group] = o.reshape(
                t, group, hd)
    return out, dead_steps, empty


def _tolerance(v_pool, v_scale) -> float:
    v = v_pool.float() if v_scale is None else dequantize_int8(v_pool,
                                                               v_scale)
    return BF16_STEP * float(v.abs().max()) + 1e-5


def _q(rng, t):
    return torch.from_numpy(rng.randn(5, t, H, HD).astype(np.float32)).to(
        torch.bfloat16)


@pytest.mark.parametrize("entries", [1, 3, N_TABLES])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("t", [7, 40])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_tc_emulation_matches_plain(quant, t, window, entries):
    """Every split of the table — one entry each, three, the whole
    table — merges to the plain version's output within the bf16
    rounding of P; the all-sentinel slot emits zeros; steps of sentinel
    entries alone and ranges with nothing to attend are skipped."""
    rng = np.random.RandomState(entries + 10 * t + window + 100 * quant)
    pools, tables = _case(rng, quant)
    q, starts = _q(rng, t), _starts(t)
    got, dead, empty = _emulate(q, *pools, tables, starts, window, entries)
    want = tpa.paged_flash_decode_plain(q, *pools, tables, starts,
                                        window=window)
    assert float((got - want).abs().max()) <= _tolerance(pools[1], pools[3])
    assert not got[2].any()
    # Slot 2's tiles (one a kv head at t = 7, two at t = 40) find
    # nothing to attend in any split.
    assert empty >= KVH * -(-t * GROUP // TILE)
    if entries == N_TABLES and not window and t == 40:
        # Slot 1's walk from 9 meets whole steps of sentinel entries
        # (positions 24 on are sentinel): they are never staged.
        assert dead > 0


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_tc_emulation_matches_reference_prefill(quant, window):
    """A 40-token segment's prefill, as the serving engine runs it: the
    reference's ``paged_flash_prefill`` (store, then its flash kernel)
    against the port's store followed by the emulated tensor-core
    attend, over pools that hold the same values (bf16 data held in f32
    on the JAX side, so both store the same numbers).  Compared on the
    rows that attend at least one key: where a row's window lies wholly
    in sentinel entries (slot 1 at window 5), the reference's kernel
    emits the mean of masked V, its plain formula and the port zeros (a
    state the engine never makes: its sentinel entries lie past every
    row's position)."""
    rng = np.random.RandomState(30 + window + quant)
    pools, tables = _case(rng, quant)
    t = 40
    q, starts = _q(rng, t), _starts(t)
    k_new, v_new = (torch.from_numpy(rng.randn(5, t, KVH, HD).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    out_j, *_ = jpa.paged_flash_prefill(
        jnp.asarray(q.float().numpy()), jnp.asarray(k_new.float().numpy()),
        jnp.asarray(v_new.float().numpy()),
        *(None if p is None else jnp.asarray(p.float().numpy()
                                             if p.dtype == torch.bfloat16
                                             else p.numpy())
          for p in pools),
        jnp.asarray(tables.numpy()), jnp.asarray(starts.numpy()),
        window=window,
    )
    stored = [None if p is None else p.clone() for p in pools]
    tpa.paged_kv_store(k_new, v_new, *stored, tables, starts)
    got, _, _ = _emulate(q, *stored, tables, starts, window,
                         tpa.decode_plan(q.dtype, 5, t, H, KVH, N_TABLES,
                                         132)[1])
    want = torch.from_numpy(np.array(out_j))
    q_pos = starts.long()[:, None] + torch.arange(t)
    k_pos = torch.arange(N_TABLES * BS)
    keep = (k_pos <= q_pos[..., None]) & (
        tables < N_BLOCKS).repeat_interleave(BS, dim=1)[:, None]
    if window:
        keep &= q_pos[..., None] - k_pos < window
    attends = keep.any(-1)
    tol = _tolerance(stored[1], stored[3])
    assert float((got - want)[attends].abs().max()) <= tol
    assert not got[~attends].any()
    assert not got[2].any()
