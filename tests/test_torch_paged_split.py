"""K1's split over the block table, on the CPU.

The CUDA kernel cuts each slot's block table into ranges of
``decode_split`` entries, runs each range as its own thread block and
merges the ranges' partial softmax states in a fixed order.  The kernel
runs only on the card (``tests/test_torch_kernels.py``), so this file
pins the two things around it that the CPU can check (the tensor-core
route's own arithmetic is ``tests/test_torch_paged_tc.py``'s):

- ``decode_split``'s rule, from host-known sizes only;
- the split-and-merge arithmetic of the CUDA-core routes, emulated in
  plain PyTorch exactly as the kernel does it — per 16-row q tile (the
  f32 route's; a decode step's 8-row tile holds all its rows) and
  split, the key range
  clipped to the tile's causal frontier and window, a range wholly
  masked or wholly sentinel skipped with ``m = NEG_BIG, l = 0``, the
  others reduced to ``(m, l, acc)``, then merged in split order with
  ``M = max m_s`` and ``out = Σ e^(m_s−M) acc_s / Σ e^(m_s−M) l_s`` —
  held against ``paged_flash_decode_plain`` for bf16 and int8 pools,
  windows 0 and 5, and every split count from one range to one entry
  each.

Tolerance: both sides compute in f32 from the same (bf16 or dequantized
int8) values and differ only in summation order and in where the
softmax's maximum is taken, over at most 24 keys of unit-scale data:
1e-5 covers that, while a wrong range, mask or merge weight moves
outputs by O(0.1).
"""

import math

import numpy as np
import pytest
import torch

from oim_tpu_torch.ops import paged_attention as tpa
from oim_tpu_torch.ops.quant import dequantize_int8

ATOL = 1e-5
N_BLOCKS, BS, KVH, HD, N_TABLES, H = 16, 4, 2, 16, 6, 6


@pytest.mark.parametrize("batch_kv,tiles,n_tables,sms,want", [
    # The smoke's decode on an H100: 8 slots x 2 kv heads, one tile, a
    # 128-entry table; 2 blocks an SM of 132 asks for 17 splits, which
    # 8 entries a split makes 16 (256 blocks).
    (16, 1, 128, 132, 8),
    # A 512-token prefill on the f32 route: 2 slots x 2 kv heads x 192
    # 16-row tiles = 768 blocks already fill the card: one split over
    # the whole table.
    (4, 192, 128, 132, 128),
    # A short table: at most one split an entry.
    (16, 1, 4, 132, 1),
    # A small card and one slot: 16 blocks wanted, 8 entries each.
    (2, 1, 128, 8, 16),
    (1, 1, 0, 132, 1),  # no table: one (empty) split
])
def test_decode_split_reaches_blocks_per_sm(batch_kv, tiles, n_tables, sms,
                                            want):
    """The fewest splits whose grid reaches DECODE_BLOCKS_PER_SM blocks
    an SM (at most one an entry), as the entries that cut the table into
    that many ranges; one split fewer would leave the card short."""
    entries = tpa.decode_split(batch_kv, tiles, n_tables, sms)
    assert entries == want
    if n_tables:
        per, target = batch_kv * tiles, tpa.DECODE_BLOCKS_PER_SM * sms
        need = -(-target // per)
        assert (need - 1) * per < target <= need * per
        assert entries == -(-n_tables // min(n_tables, need))
        assert -(-n_tables // entries) <= min(n_tables, need)


def test_paged_flash_decode_checks_splits_and_ignores_them_on_the_cpu():
    """``splits`` must be at least 1; on the CPU it changes nothing (it
    only shapes the kernel's grid)."""
    rng = np.random.RandomState(0)
    pools, tables = _case(rng, False)
    q = torch.from_numpy(rng.randn(5, 1, H, HD).astype(np.float32))
    q = q.to(torch.bfloat16)
    starts = torch.tensor([23, 11, 5, 3, 19], dtype=torch.int32)
    want = tpa.paged_flash_decode(q, *pools, tables, starts)
    for splits in (1, 3, 100):
        got = tpa.paged_flash_decode(q, *pools, tables, starts,
                                     splits=splits)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="splits"):
        tpa.paged_flash_decode(q, *pools, tables, starts, splits=0)


def _case(rng, quant):
    """Five slots over a 16-block pool of 4-row blocks (6 table entries,
    24 positions): fully live; live then sentinel (its last ranges hold
    only sentinels); a short context (ranges past its frontier); all
    sentinel; a sentinel hole in the middle."""
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
    s = N_BLOCKS
    tables = torch.tensor([
        [3, 7, 0, 9, 12, 5],
        [1, 4, 10, s, s, s],
        [2, 11, s, s, s, s],
        [s, s, s, s, s, s],
        [6, 8, s, s, 13, 14],
    ], dtype=torch.int32)
    return pools, tables


def _emulate(q, k_pool, v_pool, k_scale, v_scale, tables, starts, window,
             entries):
    """K1's arithmetic in plain PyTorch: per (slot, kv head, 16-row q
    tile, split) the state (m, l, acc) of the split's key range, a
    skipped range's state (NEG_BIG, 0, -), then the merge in split
    order.  Returns (out [B, t, H, hd] f32, how many (tile, split)
    states were skipped)."""
    b, t, h, hd = q.shape
    n_blocks, bs, kvh, _ = k_pool.shape
    group, n_tables = h // kvh, tables.shape[1]
    n_splits = max(1, -(-n_tables // entries))
    rows = t * group
    out = torch.zeros((b, t, h, hd))
    skipped = 0
    for slot in range(b):
        start = int(starts[slot])
        for kh in range(kvh):
            qr = q[slot, :, kh * group:(kh + 1) * group].reshape(rows, hd)
            qr = qr.float()
            o = torch.zeros((rows, hd))
            for r0 in range(0, rows, tpa.ROUTE_ROWS["rows16"]):
                r1 = min(rows, r0 + tpa.ROUTE_ROWS["rows16"])
                q_pos = start + torch.arange(r0, r1) // group
                states = []
                for split in range(n_splits):
                    e_lo = split * entries
                    e_hi = min(e_lo + entries, n_tables)
                    k_lo = e_lo * bs
                    k_hi = min(e_hi * bs, int(q_pos[-1]) + 1)
                    if window:
                        k_lo = max(k_lo, int(q_pos[0]) - window + 1)
                    blocks = tables[slot, k_lo // bs:(k_hi - 1) // bs + 1]
                    if k_lo >= k_hi or not bool(
                            ((blocks >= 0) & (blocks < n_blocks)).any()):
                        skipped += 1
                        states.append((torch.full((r1 - r0,), tpa.NEG_BIG),
                                       torch.zeros(r1 - r0), None))
                        continue
                    kp = torch.arange(k_lo, k_hi)
                    blk = tables[slot, kp // bs].long()
                    live = (blk >= 0) & (blk < n_blocks)
                    at = (blk.clamp(0, n_blocks - 1), kp % bs, kh)
                    k = k_pool[at].float()
                    v = v_pool[at].float()
                    if k_scale is not None:
                        k = dequantize_int8(k_pool[at], k_scale[at])
                        v = dequantize_int8(v_pool[at], v_scale[at])
                    k = torch.where(live[:, None], k, 0.0)
                    v = torch.where(live[:, None], v, 0.0)
                    s = (qr[r0:r1] @ k.T) / math.sqrt(hd)
                    keep = live[None] & (kp[None] <= q_pos[:, None])
                    if window:
                        keep &= q_pos[:, None] - kp[None] < window
                    m = torch.where(keep, s, tpa.NEG_BIG).amax(-1)
                    p = torch.where(keep, torch.exp(s - m[:, None]), 0.0)
                    states.append((m, p.sum(-1), p @ v))
                # The merge, in split order; splits with l = 0 are skipped.
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
    return out, skipped


@pytest.mark.parametrize("entries", range(1, N_TABLES + 1))
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("t", [1, 7])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_split_and_merge_matches_plain(quant, t, window, entries):
    """Every split of the table merges to the plain version's output;
    the all-sentinel slot emits zeros; with one entry a split, ranges
    past a short slot's frontier and ranges of sentinels alone are
    skipped, and the merge still agrees."""
    rng = np.random.RandomState(entries + 10 * t + window)
    pools, tables = _case(rng, quant)
    qdt = torch.bfloat16
    q = torch.from_numpy(rng.randn(5, t, H, HD).astype(np.float32)).to(qdt)
    # Last positions 23 (the whole table), 11, 5, -, 19 (over the hole).
    starts = torch.tensor([24 - t, 12 - t, max(0, 6 - t), 3, 20 - t],
                          dtype=torch.int32)
    got, skipped = _emulate(q, *pools, tables, starts, window, entries)
    want = tpa.paged_flash_decode_plain(q, *pools, tables, starts,
                                        window=window)
    assert float((got - want).abs().max()) <= ATOL
    assert not got[3].any()
    if entries == 1:
        # Slot 2's later entries are past its frontier and sentinel;
        # slot 3's are all sentinel: at least their ranges are skipped.
        assert skipped >= 2 * KVH * (N_TABLES - 2) + KVH * N_TABLES
