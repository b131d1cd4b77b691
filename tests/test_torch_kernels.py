"""The Hopper kernels against their plain PyTorch versions, on the card.

The CUDA kernels have no CPU mode, so every test here needs an NVIDIA
GPU and the CUDA toolkit: each carries the ``cuda`` marker and skips
without a GPU (decided inside the test).  The file imports no JAX, so it
runs on the GPU machine as it is:

    python -m pytest --noconftest tests/test_torch_kernels.py -q -m cuda

(``--noconftest``: the suite's conftest guards the JAX package's
daemons and imports the ``tests`` package by name, which another
installed ``tests`` package can shadow; these tests need none of it.)

Tolerances: K2 writes the pool bytes ``paged_store`` writes, bit for
bit.  K1 and the plain version compute in f32 from the same (bf16, f32
or dequantized int8) values and differ only in summation order over at
most 149 keys of unit-scale data: 1e-4 covers that, while a wrong block,
mask or scale moves outputs by O(0.1).
"""

import pytest
import torch

from oim_tpu_torch.ops import paged_attention as pa

ATOL = 1e-4
N_BLOCKS, KVH, H, N_TABLES = 20, 2, 6, 6


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")


def _pools(dtype, hd, bs, gen):
    """K/V pools and their scales (int8) or None (fp) on the card, and
    the dtype of q and the new rows that go with them."""
    dev = "cuda"
    shape = (N_BLOCKS, bs, KVH, hd)
    if dtype == torch.int8:
        k, v = (torch.randint(-127, 128, shape, generator=gen, device=dev,
                              dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand(shape[:-1], generator=gen, device=dev) * 0.02
                  for _ in range(2))
        return [k, v, ks, vs], torch.bfloat16
    k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    return [k, v, None, None], dtype


def _case(dtype, hd, bs, t, seed=0):
    """A pool, tables (two live rows, one all-sentinel, one whose last
    entries are sentinel), starts, q and new K/V rows on the card."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed)
    pools, qdt = _pools(dtype, hd, bs, gen)
    perm = torch.randperm(N_BLOCKS, generator=gen, device=dev)
    tables = torch.full((4, N_TABLES), N_BLOCKS, dtype=torch.int32,
                        device=dev)
    tables[0] = perm[:N_TABLES].int()
    tables[1] = perm[N_TABLES:2 * N_TABLES].int()
    tables[3, :2] = perm[2 * N_TABLES:2 * N_TABLES + 2].int()
    # Row 0 starts mid-block, row 1 at a block edge, row 3 runs into its
    # sentinel entries (those rows drop, and attend what is live).
    starts = torch.tensor([bs + 3, 2 * bs, 1, bs - 2], dtype=torch.int32,
                          device=dev)
    q = torch.randn((4, t, H, hd), generator=gen, device=dev).to(qdt)
    kn = torch.randn((4, t, KVH, hd), generator=gen, device=dev).to(qdt)
    vn = torch.randn((4, t, KVH, hd), generator=gen, device=dev).to(qdt)
    return q, kn, vn, pools, tables, starts


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("t", [1, 21])
@pytest.mark.parametrize("bs", [16, 64])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8], ids=["f32", "bf16", "int8"])
def test_prefill_store_and_attend_match_plain(dtype, hd, bs, t, window):
    _need_gpu()
    q, kn, vn, pools, tables, starts = _case(dtype, hd, bs, t)
    ref = [None if x is None else x.clone() for x in pools]
    before = pa.counters()
    out, *_ = pa.paged_flash_prefill(q, kn, vn, *pools, tables, starts,
                                     window=window)
    pa.paged_kv_store_plain(kn, vn, *ref, tables, starts)
    want = pa.paged_flash_decode_plain(q, *ref, tables, starts,
                                       window=window)
    torch.cuda.synchronize()
    after = pa.counters()
    for got_pool, want_pool in zip(pools, ref):
        if got_pool is not None:
            assert torch.equal(got_pool, want_pool)
    assert out.dtype == torch.float32
    assert torch.isfinite(out).all()
    assert float((out - want).abs().max()) <= ATOL
    assert not out[2].any()  # the all-sentinel row emits zeros
    assert after["paged_flash_decode"] == before["paged_flash_decode"] + 1
    assert after["paged_kv_store"] == before["paged_kv_store"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8], ids=["f32", "bf16", "int8"])
def test_windowed_row_over_a_hole_emits_zeros(dtype):
    """A tile of 16 rows walks from its earliest row's window edge, so a
    later row can meet live blocks wholly left of its own window.  Here
    blocks 0-1 are live and block 2 is a sentinel hole: the rows at
    position 5 (window [4, 5], all in the hole) have no valid key and
    emit zeros, as the plain version does; the rows before them attend
    what is live."""
    _need_gpu()
    bs, t, window = 2, 6, 2
    gen = torch.Generator(device="cuda").manual_seed(0)
    pools, qdt = _pools(dtype, 128, bs, gen)
    tables = torch.full((1, N_TABLES), N_BLOCKS, dtype=torch.int32,
                        device="cuda")
    tables[0, :2] = torch.tensor([7, 3], dtype=torch.int32)
    starts = torch.zeros(1, dtype=torch.int32, device="cuda")
    q = torch.randn((1, t, H, 128), generator=gen, device="cuda").to(qdt)
    out = pa.paged_flash_decode(q, *pools, tables, starts, window=window)
    want = pa.paged_flash_decode_plain(q, *pools, tables, starts,
                                       window=window)
    torch.cuda.synchronize()
    assert not want[0, 5].any()
    assert not out[0, 5].any()
    assert out[0, :5].abs().amax(-1).min() > 0  # live rows attend
    assert float((out - want).abs().max()) <= ATOL


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take():
    _need_gpu()
    q, kn, vn, pools, tables, starts = _case(torch.bfloat16, 128, 16, 1)
    with pytest.raises(ValueError, match="share a dtype"):
        pa.paged_flash_decode(q.float(), *pools, tables, starts)
    with pytest.raises(ValueError, match="int32"):
        pa.paged_flash_decode(q, *pools, tables.long(), starts)
    bad = [p[..., :96].contiguous() for p in pools[:2]]
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_flash_decode(q[..., :96].contiguous(), *bad, None, None,
                              tables, starts)
    with pytest.raises(ValueError, match="on cpu"):
        pa.paged_kv_store(kn, vn, pools[0].cpu(), pools[1], None, None,
                          tables, starts)
