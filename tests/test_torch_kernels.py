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
bit.  On its decode and f32 routes K1 and the plain version compute in
f32 from the same (bf16, f32, or dequantized int8 or packed int4) values
and differ only in summation order (and K1 merges split and warp partial
sums by their maxima) over at most 2048 keys of unit-scale data, whose softmax weights
sum to one: 1e-4 covers that, while a wrong block, mask, split or scale
moves outputs by O(0.1).  K1's tensor-core route (bf16 q, more than 8
flattened rows a slot) rounds each softmax weight (times the v scale,
for int8) to bf16 as the operand of P V, as the flash forward rounds P:
an output then moves by at most 2**-8 of the largest V value, which the
rows attending few keys carry into the output's max; it is held, as the
flash forward is, at 2**-7 + 1e-4 of the output's max.

``quant_matmul`` (``ops/wquant.py``) and its plain version read the same
dequantized weights (rounded to x's dtype) and sum in f32 in another
order; a bf16 output is then rounded once, so they differ by one bf16
rounding step (2**-8 of a value) plus f32 order noise: 2**-7 + 1e-4 of
the output's max, and 1e-4 of it for f32 outputs (sums of up to 14336
terms), while a wrong row, group or scale moves outputs by O(1).
"""

import pytest
import torch

from oim_tpu_torch.ops import paged_attention as pa
from oim_tpu_torch.ops.quant import pack_int4

ATOL = 1e-4
TC_RTOL = 2.0**-7 + 1e-4
N_BLOCKS, KVH, H, N_TABLES = 20, 2, 6, 6


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")


def _k1_tol(q, want):
    """K1's tolerance on ``q`` (module docstring): the tensor-core
    route's share of the output's max, ATOL on the other routes."""
    if pa.decode_route(q.dtype, q.shape[1], q.shape[2] // KVH) == "tc":
        return TC_RTOL * float(want.abs().max())
    return ATOL


# Quantized pools: int8, and packed int4 (torch.uint8, two values a byte).
QUANT_KV = (torch.int8, torch.uint8)


def _payload(shape, dtype, gen):
    """A random quantized pool payload on the card: int8 values in
    [-127, 127], or int4 values in [-7, 7] packed along head_dim."""
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)
    values = torch.randint(-7, 8, shape, generator=gen, device="cuda",
                           dtype=torch.int8)
    return pack_int4(values)


def _pools(dtype, hd, bs, gen):
    """K/V pools and their scales (int8) or None (fp) on the card, and
    the dtype of q and the new rows that go with them."""
    dev = "cuda"
    shape = (N_BLOCKS, bs, KVH, hd)
    if dtype in QUANT_KV:
        k, v = (_payload(shape, dtype, gen) for _ in range(2))
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
                                   torch.int8, torch.uint8],
                         ids=["f32", "bf16", "int8", "int4"])
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
    assert not out[2].any()  # the all-sentinel row emits zeros
    assert float((out - want).abs().max()) <= _k1_tol(q, want)
    assert after["paged_flash_decode"] == before["paged_flash_decode"] + 1
    assert after["paged_kv_store"] == before["paged_kv_store"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8, torch.uint8],
                         ids=["f32", "bf16", "int8", "int4"])
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
    assert float((out - want).abs().max()) <= _k1_tol(q, want)


def _decode_case(dtype, t, seed=0, n_tables=128, bs=16):
    """The serving decode shape at a small pool: 8 slots, 12 q heads on
    2 kv heads, hd 128, 16-row blocks, 128 table entries; contexts from
    0 to the whole table, one slot whose table turns sentinel partway
    (so its later splits hold only sentinels), one all-sentinel slot.
    At t > 1 the rows run from ``starts`` on (a tall prefill)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_blocks = 8 * n_tables
    shape = (n_blocks, bs, 2, 128)
    if dtype in QUANT_KV:
        pools = [_payload(shape, dtype, gen) for _ in range(2)]
        pools += [torch.rand(shape[:-1], generator=gen, device="cuda") * 0.04
                  + 0.005 for _ in range(2)]
        qdt = torch.bfloat16
    else:
        pools = [torch.randn(shape, generator=gen, device="cuda").to(dtype)
                 for _ in range(2)] + [None, None]
        qdt = dtype
    ends = [0, 16, 299, 999, n_tables * bs - 1, 776, 1500, -1]
    perm = torch.randperm(n_blocks, generator=gen, device="cuda").int()
    tables = torch.full((8, n_tables), n_blocks, dtype=torch.int32,
                        device="cuda")
    starts = []
    for b, end in enumerate(ends):
        if end < 0:
            starts.append(5)
            continue
        start = max(0, end - t + 1)
        live = min(n_tables, (start + t - 1) // bs + 1)
        if b == 6:
            live = 40  # positions past 640 fall in sentinel entries
        tables[b, :live] = perm[b * n_tables:b * n_tables + live]
        starts.append(start)
    starts = torch.tensor(starts, dtype=torch.int32, device="cuda")
    q = torch.randn((8, t, 12, 128), generator=gen, device="cuda").to(qdt)
    return q, pools, tables, starts


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [None, 1, 2, 3, 8, 16, 128],
                         ids=lambda s: f"splits{s}")
@pytest.mark.parametrize("window", [0, 256])
@pytest.mark.parametrize("t", [1, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8, torch.uint8],
                         ids=["f32", "bf16", "int8", "int4"])
def test_decode_split_sweep_matches_plain(dtype, t, window, splits):
    """K1 at every split of the table — one range, a few, one entry
    each, and decode_split's choice — agrees with the plain version,
    the all-sentinel slot emits zeros, two launches give the same bits,
    and one wrapper call counts one launch, the merge included."""
    _need_gpu()
    q, pools, tables, starts = _decode_case(dtype, t)
    args = (q, *pools, tables, starts)
    before = pa.counters()["paged_flash_decode"]
    got = pa.paged_flash_decode(*args, window=window, splits=splits)
    again = pa.paged_flash_decode(*args, window=window, splits=splits)
    want = pa.paged_flash_decode_plain(*args, window=window)
    torch.cuda.synchronize()
    assert pa.counters()["paged_flash_decode"] == before + 2
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    assert not got[7].any()
    assert float((got - want).abs().max()) <= _k1_tol(q, want)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [None, 1, 4], ids=lambda s: f"splits{s}")
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8,
                                   torch.uint8], ids=["bf16", "int8", "int4"])
def test_tall_prefill_split_matches_plain(dtype, splits):
    """The tall route at t = 512 (the smoke's prefill bucket) over the
    same slots: every split agrees with the plain version, bit-equal
    twice."""
    _need_gpu()
    q, pools, tables, starts = _decode_case(dtype, 512, seed=1)
    args = (q, *pools, tables, starts)
    got = pa.paged_flash_decode(*args, splits=splits)
    again = pa.paged_flash_decode(*args, splits=splits)
    want = pa.paged_flash_decode_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert not got[7].any()
    assert float((got - want).abs().max()) <= _k1_tol(q, want)


def _tc_case(dtype, hd, bs, t, seed=0):
    """Four slots over a pool of ``bs``-row blocks, tables long enough
    for ``t`` rows from a start past two blocks: slot 0 fully live from a
    start mid-block; slot 1 live for its first four entries, then
    sentinel (its later rows attend only those); slot 2 all sentinel;
    slot 3 live but for a sentinel hole at entry 2.  q bf16 [4, t, 12,
    hd] on 2 kv heads (a group of 6, as the serving model)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_tables = -(-(2 * bs + t) // bs) + 1
    n_blocks = 4 * n_tables
    shape = (n_blocks, bs, KVH, hd)
    if dtype in QUANT_KV:
        pools = [_payload(shape, dtype, gen) for _ in range(2)]
        pools += [torch.rand(shape[:-1], generator=gen, device="cuda") * 0.04
                  + 0.005 for _ in range(2)]
    else:
        pools = [torch.randn(shape, generator=gen, device="cuda").to(dtype)
                 for _ in range(2)] + [None, None]
    perm = torch.randperm(n_blocks, generator=gen, device="cuda").int()
    tables = perm.reshape(4, n_tables).clone()
    tables[1, 4:] = n_blocks
    tables[2] = n_blocks
    tables[3, 2] = n_blocks
    starts = torch.tensor([bs + 3, bs + 3, 1, bs - 2], dtype=torch.int32,
                          device="cuda")
    q = torch.randn((4, t, 12, hd), generator=gen,
                    device="cuda").to(torch.bfloat16)
    return q, pools, tables, starts


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [None, 1, 2, 5], ids=lambda s: f"splits{s}")
@pytest.mark.parametrize("window", [0, 37])
@pytest.mark.parametrize("t", [7, 100])
@pytest.mark.parametrize("bs", [16, 24])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8,
                                   torch.uint8], ids=["bf16", "int8", "int4"])
def test_tc_route_matches_plain(dtype, hd, bs, t, window, splits):
    """K1's tensor-core route at both head dims, a block size that
    divides its 32-key steps and one that does not, ragged row counts
    (t·group = 42 and 600: not multiples of the 64-row tile), a window
    shorter than the segment (steps left of a tile's window skipped),
    every split from one range to one entry each: within the route's
    tolerance of the plain version, the all-sentinel slot zeros, two
    launches bit-equal, and every launch on the tc route."""
    _need_gpu()
    q, pools, tables, starts = _tc_case(dtype, hd, bs, t)
    args = (q, *pools, tables, starts)
    assert pa.decode_route(q.dtype, t, 6) == "tc"
    before = pa.counters()
    got = pa.paged_flash_decode(*args, window=window, splits=splits)
    again = pa.paged_flash_decode(*args, window=window, splits=splits)
    want = pa.paged_flash_decode_plain(*args, window=window)
    torch.cuda.synchronize()
    after = pa.counters()
    assert after["paged_flash_decode_tc"] == before["paged_flash_decode_tc"] + 2
    assert after["paged_flash_decode"] == before["paged_flash_decode"] + 2
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    assert not got[2].any()
    assert float((got - want).abs().max()) <= _k1_tol(q, want)


@pytest.mark.cuda
def test_k1_routes_by_dtype_and_rows():
    """Decode steps (t·group <= 8) take the 8-row route in either dtype,
    taller bf16 q the tensor cores, taller f32 q the CUDA-core route;
    the decode entry point refuses tall bf16 q (no route falls back to
    another)."""
    _need_gpu()
    from oim_tpu_torch.ops import _build

    q, pools, tables, starts = _tc_case(torch.bfloat16, 128, 16, 7)
    f32_pools = [p.float() for p in pools[:2]] + [None, None]
    cases = [(q[:, :1], pools, "rows8"), (q, pools, "tc"),
             (q[:, :1].float(), f32_pools, "rows8"),
             (q.float(), f32_pools, "rows16")]
    for qq, pp, route in cases:
        before = pa.counters()[f"paged_flash_decode_{route}"]
        pa.paged_flash_decode(qq.contiguous(), *pp, tables, starts)
        assert pa.counters()[f"paged_flash_decode_{route}"] == before + 1
    out = torch.empty(q.shape, dtype=torch.float32, device="cuda")
    n_blocks, bs = pools[0].shape[:2]
    code = _build.library().oim_paged_flash_decode(
        q.data_ptr(), _build.DTYPE_CODES[torch.bfloat16],
        pools[0].data_ptr(), pools[1].data_ptr(),
        _build.DTYPE_CODES[torch.bfloat16], None, None, tables.data_ptr(),
        starts.data_ptr(), out.data_ptr(), None, 4, q.shape[1], 12, KVH,
        128, n_blocks, bs, tables.shape[1], 0, tables.shape[1],
        _build.stream_of(q))
    assert code != 0


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 7, 512])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8, torch.uint8],
                         ids=["f32", "bf16", "int8", "int4"])
def test_k2_store_bit_equal_to_paged_store(dtype, hd, t):
    """K2's flat grid writes the pool bytes (and int8 scales)
    ``paged_store`` writes, bit for bit, at a decode step, a short and a
    512-row segment: slot 0's rows all land; slot 1's rows past its
    fourth entry fall in sentinel entries and drop; slot 2 (all
    sentinel) writes nothing; slot 3's rows past the table drop; no
    other pool byte moves.  At t = 1 the count of decode launches
    moves."""
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(t + hd)
    bs, n_tables = 16, 40
    n_blocks = 4 * n_tables
    shape = (n_blocks, bs, KVH, hd)
    if dtype in QUANT_KV:
        pools = [_payload(shape, dtype, gen) for _ in range(2)]
        pools += [torch.rand(shape[:-1], generator=gen, device="cuda")
                  for _ in range(2)]
        ndt = torch.bfloat16
    else:
        pools = [torch.randn(shape, generator=gen, device="cuda").to(dtype)
                 for _ in range(2)] + [None, None]
        ndt = dtype
    perm = torch.randperm(n_blocks, generator=gen, device="cuda").int()
    tables = perm.reshape(4, n_tables).clone()
    tables[1, 4:] = n_blocks
    tables[2] = n_blocks
    starts = torch.tensor([3, 2 * bs + 5, 0, n_tables * bs - t // 2 - 1],
                          dtype=torch.int32, device="cuda")
    kn = torch.randn((4, t, KVH, hd), generator=gen, device="cuda") * 3
    vn = torch.randn((4, t, KVH, hd), generator=gen, device="cuda") * 3
    kn, vn = kn.to(ndt), vn.to(ndt)
    kn[0, 0] = 0.0  # an all-zero row: the 1e-8 scale floor, zeros out
    ref = [None if x is None else x.clone() for x in pools]
    before = pa.counters()
    pa.paged_kv_store(kn, vn, *pools, tables, starts)
    pa.paged_kv_store_plain(kn, vn, *ref, tables, starts)
    torch.cuda.synchronize()
    after = pa.counters()
    for got, want in zip(pools, ref):
        if got is not None:
            assert torch.equal(got, want)
    assert after["paged_kv_store"] == before["paged_kv_store"] + 1
    assert (after["paged_kv_store_t1"]
            == before["paged_kv_store_t1"] + (t == 1))


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
    with pytest.raises(ValueError, match="splits"):
        pa.paged_flash_decode(q, *pools, tables, starts, splits=0)
    with pytest.raises(ValueError, match="on cpu"):
        pa.paged_kv_store(kn, vn, pools[0].cpu(), pools[1], None, None,
                          tables, starts)


# ---------------------------------------------------------------------------
# Training kernels: RMSNorm and flash attention forward, dq, dkv.
#
# Tolerances, as max |got - want| over max |want|: kernel and plain
# version compute in f32 from the same inputs and round once to the
# output dtype, so bf16 outputs differ by at most one rounding step
# (2**-7 of a value, at most the max) plus f32 summation-order noise,
# and f32 outputs by that noise alone (sums of at most 1000 terms of
# unit-scale data, far below 1e-5 of the max).  In bf16, dq and dkv also
# round P and dS to bf16 as operands of their products (the reference's
# MXU does the same at default precision): an f32 emulation of that on
# the CPU over these cases moves no output by more than its one rounding
# step (at most 7.6e-3 of the max).  A wrong mask, tile or head moves
# outputs by O(1) of the max.

from oim_tpu_torch.ops import flash_attention as fa  # noqa: E402
from oim_tpu_torch.ops import rmsnorm as rn  # noqa: E402

TRAIN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7 + 1e-5}


def _rel(got, want):
    err = float((got.float() - want.float()).abs().max())
    return err / max(float(want.float().abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 1536, 4096, 8192])
@pytest.mark.parametrize("rows", [1, 37, 4096])
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16],
                         ids=["w_f32", "w_bf16"])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16],
                         ids=["x_f32", "x_bf16"])
def test_rmsnorm_kernel_matches_plain(xdt, wdt, rows, d):
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(rows + d)
    x = (torch.randn((rows, d), generator=gen, device="cuda") * 3).to(xdt)
    w = (torch.rand(d, generator=gen, device="cuda") + 0.5).to(wdt)
    before = rn.counters()
    got = rn.rmsnorm_fwd(x, w, 1e-6)
    want = rn.rmsnorm_plain(x, w, 1e-6)
    torch.cuda.synchronize()
    assert got.dtype == xdt and got.shape == x.shape
    assert _rel(got, want) <= TRAIN_TOL[xdt]
    assert rn.counters()["rmsnorm"] == before["rmsnorm"] + 1


def _flash_case(dtype, hd, t, group, segmented, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, kvh = 2, 2
    h = kvh * group
    q, do = (torch.randn((b, t, h, hd), generator=gen, device="cuda")
             .to(dtype) for _ in range(2))
    k, v = (torch.randn((b, t, kvh, hd), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    seg = None
    if segmented:
        starts = torch.rand((b, t), generator=gen, device="cuda") < 0.03
        seg = torch.cumsum(starts.int(), dim=1, dtype=torch.int32)
    return q, k, v, do, seg


def _flash_matches_plain(q, k, v, do, causal, window, seg):
    tol = TRAIN_TOL[q.dtype]
    before = fa.counters()
    out, lse = fa.flash_fwd(q, k, v, causal, window, seg)
    ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, causal, window, seg)
    delta = fa.flash_delta(ref_out, do)
    bwd = (q, k, v, do, ref_lse, delta, causal, window, seg)
    dq = fa.flash_dq(*bwd)
    dk, dv = fa.flash_dkv(*bwd)
    ref_dq = fa.flash_dq_plain(*bwd)
    ref_dk, ref_dv = fa.flash_dkv_plain(*bwd)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and lse.dtype == torch.float32
    assert _rel(out, ref_out) <= tol
    assert _rel(lse, ref_lse) <= TRAIN_TOL[torch.float32]
    assert _rel(dq, ref_dq) <= tol
    assert _rel(dk, ref_dk) <= tol
    assert _rel(dv, ref_dv) <= tol
    after = fa.counters()
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        assert after[name] == before[name] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("segmented", [False, True], ids=["nosegs", "segs"])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("group", [1, 6])
@pytest.mark.parametrize("t", [128, 256, 200, 40, 1000])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernels_match_plain(dtype, hd, t, group, window, segmented):
    _need_gpu()
    q, k, v, do, seg = _flash_case(dtype, hd, t, group, segmented)
    _flash_matches_plain(q, k, v, do, True, window, seg)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernels_noncausal_match_plain(dtype):
    _need_gpu()
    q, k, v, do, seg = _flash_case(dtype, 128, 200, 6, True)
    _flash_matches_plain(q, k, v, do, False, 0, seg)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [200, 1024])
def test_flash_attention_autograd_runs_the_kernels(t):
    """The differentiable wrapper's forward and backward launch the
    three kernels and match the reference formula's autograd (in f32:
    summation order only)."""
    _need_gpu()
    q, k, v, do, seg = _flash_case(torch.float32, 128, t, 6, True)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    before = fa.counters()
    out = fa.flash_attention(*leaves, True, 64, seg)
    grads = torch.autograd.grad(out, leaves, do)
    ref_leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    ref = fa.reference_attention(*ref_leaves, True, seg, 64)
    ref_grads = torch.autograd.grad(ref, ref_leaves, do)
    assert _rel(out, ref) <= 1e-5
    for g, r in zip(grads, ref_grads):
        assert _rel(g, r) <= 1e-4
    after = fa.counters()
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        assert after[name] == before[name] + 1
        assert after[f"{name}_plain"] == before[f"{name}_plain"]


@pytest.mark.cuda
@pytest.mark.parametrize("t", [200, 1024])
def test_flash_attention_bf16_autograd_matches_f32_reference(t):
    """The bf16 route (the training path: dq and dkv on the tensor
    cores) against the reference formula's f32 autograd on the same
    bf16 values.  The output differs by its final bf16 rounding, half a
    step: 2**-8 of the max.  Each gradient differs by that rounding plus
    the bf16 roundings inside the route (the forward output that delta
    reads, and P and dS as operands of the products), which an f32
    emulation on the CPU puts at most at 4.1e-3 of the max in all: one
    bf16 step, 2**-7 of the max, leaves twice that.  A wrong mask, tile
    or head moves them by O(1) of the max."""
    _need_gpu()
    q, k, v, do, seg = _flash_case(torch.bfloat16, 128, t, 6, True)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    before = fa.counters()
    out = fa.flash_attention(*leaves, True, 64, seg)
    grads = torch.autograd.grad(out, leaves, do)
    ref_leaves = [x.detach().float().requires_grad_() for x in (q, k, v)]
    ref = fa.reference_attention(*ref_leaves, True, seg, 64)
    ref_grads = torch.autograd.grad(ref, ref_leaves, do.float())
    assert out.dtype == torch.bfloat16
    assert _rel(out, ref) <= 2.0**-8 + 1e-5
    for g, r in zip(grads, ref_grads):
        assert g.dtype == torch.bfloat16
        assert _rel(g, r) <= 2.0**-7
    after = fa.counters()
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        assert after[name] == before[name] + 1
        assert after[f"{name}_plain"] == before[f"{name}_plain"]


@pytest.mark.cuda
@pytest.mark.parametrize("split", [None, 1, 2, 3, 6],
                         ids=["chosen", "split1", "split2", "split3",
                              "split6"])
@pytest.mark.parametrize("segmented", [False, True], ids=["nosegs", "segs"])
def test_flash_backward_is_deterministic(segmented, split):
    """No float atomics and every sum in a fixed order: two launches of
    dq and dkv on the same bf16 inputs give the same bits, at the split
    the wrapper chooses and at each other one, and every split agrees
    with the plain version."""
    _need_gpu()
    q, k, v, do, seg = _flash_case(torch.bfloat16, 128, 1000, 6, segmented)
    out, lse = fa.flash_fwd_plain(q, k, v, True, 0, seg)
    bwd = (q, k, v, do, lse, fa.flash_delta(out, do), True, 0, seg)
    first = (fa.flash_dq(*bwd),) + fa.flash_dkv(*bwd, split=split)
    again = (fa.flash_dq(*bwd),) + fa.flash_dkv(*bwd, split=split)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    want = (fa.flash_dq_plain(*bwd),) + fa.flash_dkv_plain(*bwd)
    for got, ref in zip(first, want):
        assert _rel(got, ref) <= TRAIN_TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1024, 1000])
@pytest.mark.parametrize("window", [0, 256])
@pytest.mark.parametrize("segmented", [False, True], ids=["nosegs", "segs"])
def test_flash_forward_is_deterministic(segmented, window, t):
    """The bf16 forward (tensor cores) launched twice on the same inputs
    gives the same bits, output and lse, and agrees with the plain
    version."""
    _need_gpu()
    q, k, v, _, seg = _flash_case(torch.bfloat16, 128, t, 6, segmented)
    out, lse = fa.flash_fwd(q, k, v, True, window, seg)
    out2, lse2 = fa.flash_fwd(q, k, v, True, window, seg)
    ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, True, window, seg)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert _rel(out, ref_out) <= TRAIN_TOL[torch.bfloat16]
    assert _rel(lse, ref_lse) <= TRAIN_TOL[torch.float32]


@pytest.mark.cuda
def test_training_wrappers_refuse_what_the_kernels_do_not_take():
    _need_gpu()
    x = torch.randn((4, 96), device="cuda")
    with pytest.raises(ValueError, match="16-byte chunks"):
        rn.rmsnorm_fwd(x[:, :95].contiguous(), torch.ones(95, device="cuda"))
    wide = torch.randn((2, 4096), device="cuda")  # past the registers
    assert _rel(rn.rmsnorm_fwd(wide, torch.ones(4096, device="cuda")),
                rn.rmsnorm_plain(wide, torch.ones(4096, device="cuda"))
                ) <= TRAIN_TOL[torch.float32]
    with pytest.raises(ValueError, match="f32/bf16"):
        rn.rmsnorm_fwd(x.half(), torch.ones(96, device="cuda"))
    with pytest.raises(ValueError, match="expected cuda"):
        rn.rmsnorm_fwd(x, torch.ones(96))
    q, k, v, do, _ = _flash_case(torch.bfloat16, 128, 128, 1, False)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(q[..., :96].contiguous(), k[..., :96].contiguous(),
                     v[..., :96].contiguous())
    with pytest.raises(ValueError, match="f32/bf16"):
        fa.flash_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="expected"):
        fa.flash_fwd(q, k.float(), v)
    with pytest.raises(ValueError, match="sliding window"):
        fa.flash_fwd(q, k, v, False, 16)
    out, lse = fa.flash_fwd(q, k, v)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_dq(q, k, v, do, lse[:, :64], fa.flash_delta(out, do))
    q, k, v, do, _ = _flash_case(torch.float32, 128, 128, 6, False)
    out, lse = fa.flash_fwd(q, k, v)
    delta = fa.flash_delta(out, do)
    with pytest.raises(ValueError, match="takes no split"):
        fa.flash_dkv(q, k, v, do, lse, delta, split=2)
    with pytest.raises(ValueError, match="must divide"):
        fa.flash_dkv(*(x.bfloat16() for x in (q, k, v, do)), lse, delta,
                     split=4)


# ---------------------------------------------------------------------------
# Fused unembed + cross-entropy (csrc/fused_ce.cu).  Kernel and plain
# version compute the scores in f32 from the same compute-dtype products
# and differ in summation order: lse and the target within 1e-5 of
# their max (D-term dots).  Both round the dlogits to the compute dtype
# before either product: dx comes back in that dtype, so one bf16
# rounding step (2**-7 of the max) bounds it; in f32 it sums V products
# (up to 151936) in another order, within 1e-4 of the max (observed
# 2.2e-5); dw sums rows in f32, and 1e-4 of its max covers that and the
# few dlogits whose last f32 bit rounds the other way.

from oim_tpu_torch.ops import fused_ce as fc  # noqa: E402
from torch_cpu_threads import one_torch_thread  # noqa: F401

CE_TOL = {"lse": 1e-5, "target": 1e-5, "dw": 1e-4,
          "dx": {torch.float32: 1e-4, torch.bfloat16: 2.0**-7 + 1e-4}}


def _ce_case(dtype, n, d, v, seed=0):
    """x, w (cast to x's dtype), labels with the first and last vocab
    columns among them, and g with zero rows, on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((d, v), generator=gen, device="cuda")
         / d**0.5).to(dtype)
    labels = torch.randint(0, v, (n,), generator=gen, device="cuda")
    labels[0], labels[-1] = 0, v - 1
    g = torch.rand(n, generator=gen, device="cuda")
    g[::7] = 0.0
    return x, w, labels, g


@pytest.mark.cuda
@pytest.mark.parametrize("v", [384, 151936, 100])
@pytest.mark.parametrize("n", [128, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fused_ce_kernels_match_plain(dtype, n, v):
    _need_gpu()
    x, w, labels, g = _ce_case(dtype, n, 256, v)
    before = fc.counters()
    lse, target = fc.fused_ce_fwd(x, w, labels)
    ref_lse, ref_target = fc.fused_ce_fwd_plain(x, w, labels)
    dx = fc.fused_ce_dx(x, w, labels, ref_lse, g)
    dw = fc.fused_ce_dw(x, w, labels, ref_lse, g)
    ref_dx = fc.fused_ce_dx_plain(x, w, labels, ref_lse, g)
    ref_dw = fc.fused_ce_dw_plain(x, w, labels, ref_lse, g)
    torch.cuda.synchronize()
    assert dx.dtype == dtype and dw.dtype == torch.float32
    assert _rel(lse, ref_lse) <= CE_TOL["lse"]
    assert _rel(target, ref_target) <= CE_TOL["target"]
    assert _rel(dx, ref_dx) <= CE_TOL["dx"][dtype]
    assert _rel(dw, ref_dw) <= CE_TOL["dw"]
    assert not dx[::7].any()  # rows with g = 0
    after = fc.counters()
    for name in ("fused_ce_fwd", "fused_ce_dx", "fused_ce_dw"):
        assert after[name] == before[name] + 1


@pytest.mark.cuda
def test_fused_ce_kernels_are_deterministic():
    """No atomics: two runs give the same bits."""
    _need_gpu()
    x, w, labels, g = _ce_case(torch.bfloat16, 1000, 512, 20000)
    lse, _ = fc.fused_ce_fwd(x, w, labels)
    first = (fc.fused_ce_dx(x, w, labels, lse, g),
             fc.fused_ce_dw(x, w, labels, lse, g))
    again = (fc.fused_ce_dx(x, w, labels, lse, g),
             fc.fused_ce_dw(x, w, labels, lse, g))
    assert torch.equal(fc.fused_ce_fwd(x, w, labels)[0], lse)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_fused_linear_ce_autograd_runs_the_kernels():
    """The differentiable wrapper launches fwd and the joint dx and dw,
    skips dw for a frozen w, and matches the logits reference's autograd
    in f32."""
    _need_gpu()
    x, w, labels, g = _ce_case(torch.float32, 300, 128, 1000)
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = fc.counters()
    nll = fc.fused_linear_ce(xl, wl, labels)
    dx, dw = torch.autograd.grad(nll, (xl, wl), g)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    ref = fc.reference_linear_ce(xr, wr, labels)
    ref_dx, ref_dw = torch.autograd.grad(ref, (xr, wr), g)
    assert _rel(nll, ref) <= 1e-5
    assert _rel(dx, ref_dx) <= 1e-4 and _rel(dw, ref_dw) <= 1e-4
    after = fc.counters()
    for name in ("fused_ce_fwd", "fused_ce_dx", "fused_ce_dw",
                 "fused_ce_bwd"):
        launched = name in ("fused_ce_fwd", "fused_ce_bwd")
        assert after[name] == before[name] + launched
        assert after[f"{name}_plain"] == before[f"{name}_plain"]
    xl = x.clone().requires_grad_()
    fc.fused_linear_ce(xl, w, labels).backward(g)
    assert fc.counters()["fused_ce_dw"] == after["fused_ce_dw"]
    assert fc.counters()["fused_ce_dx"] == after["fused_ce_dx"] + 1


@pytest.mark.cuda
def test_fused_ce_wrappers_refuse_what_the_kernels_do_not_take():
    _need_gpu()
    x, w, labels, g = _ce_case(torch.bfloat16, 64, 32, 256)
    with pytest.raises(ValueError, match="f32/bf16"):
        fc.fused_ce_fwd(x.half(), w.half(), labels)
    with pytest.raises(ValueError, match="expected cuda"):
        fc.fused_ce_fwd(x, w.cpu(), labels)
    with pytest.raises(ValueError, match="x's"):
        fc.fused_ce_fwd(x, w.float(), labels)
    lse, _ = fc.fused_ce_fwd(x, w, labels)
    with pytest.raises(ValueError, match="lse"):
        fc.fused_ce_dw(x, w, labels, lse[:10], g)


# The wgmma route (bf16 with D and V multiples of 8): the same limits as
# the mma.sync route above, since both compute the scores in f32 from
# the same bf16 products and round the dlogits once.


def _ce_all(x, w, labels, g):
    """(lse, target, dx, dw) of the kernels: the forward, then the joint
    backward on the plain version's lse."""
    lse, target = fc.fused_ce_fwd(x, w, labels)
    ref_lse, _ = fc.fused_ce_fwd_plain(x, w, labels)
    dx, dw = fc.fused_ce_bwd(x, w, labels, ref_lse, g)
    return lse, target, dx, dw


def _chunk_width(monkeypatch, n, chunk):
    """Make the wgmma route's backward take ``chunk`` vocabulary columns
    a chunk at N = n (None: the default width)."""
    if chunk is not None:
        monkeypatch.setattr(fc, "SCRATCH_ELEMENTS", chunk * n)
        assert fc.chunk_columns(n, 10**6) == chunk


def _ce_against_plain(x, w, labels, g):
    ref_lse, ref_target = fc.fused_ce_fwd_plain(x, w, labels)
    ref_dx, ref_dw = fc.fused_ce_bwd_plain(x, w, labels, ref_lse, g)
    lse, target, dx, dw = _ce_all(x, w, labels, g)
    torch.cuda.synchronize()
    assert dx.dtype == x.dtype and dw.dtype == torch.float32
    assert _rel(lse, ref_lse) <= CE_TOL["lse"]
    assert _rel(target, ref_target) <= CE_TOL["target"]
    assert _rel(dx, ref_dx) <= CE_TOL["dx"][x.dtype]
    assert _rel(dw, ref_dw) <= CE_TOL["dw"]
    assert not dx[g == 0].any()  # masked rows
    return lse, target, dx, dw


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [None, 256, 384], ids=lambda c: f"chunk{c}")
@pytest.mark.parametrize("n", [1, 37, 128, 1000])
def test_wgmma_route_matches_plain(n, chunk, monkeypatch):
    """Ragged N (a partial 128-row tile, a single row), one and several
    vocabulary chunks (384 = three 128-column steps of a 256-wide tile),
    masked rows, and the route's own launch count."""
    _need_gpu()
    x, w, labels, g = _ce_case(torch.bfloat16, n, 256, 1288, seed=n)
    g[0] = 0.5  # a single row must carry a gradient
    assert fc.route(x, w) == "wgmma"
    _chunk_width(monkeypatch, n, chunk)
    before = fc.counters()
    _ce_against_plain(x, w, labels, g)
    after = fc.counters()
    assert after["fused_ce_wgmma"] == before["fused_ce_wgmma"] + 2
    assert after["fused_ce_mma_sync"] == before["fused_ce_mma_sync"]
    assert after["fused_ce_bwd"] == before["fused_ce_bwd"] + 1


@pytest.mark.cuda
def test_wgmma_route_labels_on_tile_and_chunk_edges(monkeypatch):
    """Labels on every 256-column tile edge and 384-column chunk edge hit
    the target once, and their dlogits subtract the one-hot once."""
    _need_gpu()
    v = 1536
    x, w, labels, g = _ce_case(torch.bfloat16, 64, 512, v)
    _chunk_width(monkeypatch, 64, 384)
    edges = sorted({e + o for e in range(0, v + 1, 128) for o in (-1, 0)
                    if 0 <= e + o < v})
    labels[: len(edges)] = torch.tensor(edges, device="cuda")
    g[: len(edges)] = 1.0
    _ce_against_plain(x, w, labels, g)


@pytest.mark.cuda
@pytest.mark.parametrize("d,v", [(8, 1288), (40, 256), (1536, 8200)])
def test_wgmma_route_odd_depths_and_widths(d, v):
    """D below one 64-deep K step or not a multiple of it, and V not a
    multiple of the 256-wide tile: the TMA boxes past the edge read
    zeros."""
    _need_gpu()
    x, w, labels, g = _ce_case(torch.bfloat16, 200, d, v)
    _ce_against_plain(x, w, labels, g)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,v", [(torch.bfloat16, 100),
                                     (torch.float32, 1288)],
                         ids=["bf16_odd_v", "f32"])
def test_other_shapes_take_the_mma_sync_route(dtype, v):
    _need_gpu()
    x, w, labels, g = _ce_case(dtype, 100, 256, v)
    assert fc.route(x, w) == "mma_sync"
    before = fc.counters()
    _ce_against_plain(x, w, labels, g)
    after = fc.counters()
    assert after["fused_ce_mma_sync"] == before["fused_ce_mma_sync"] + 2
    assert after["fused_ce_wgmma"] == before["fused_ce_wgmma"]


@pytest.mark.cuda
@pytest.mark.parametrize("v", [1288, 151936])
def test_wgmma_route_is_deterministic_and_joint_equals_apart(v):
    """Two launches give the same bits, and the joint backward gives the
    bits of dx and dw launched apart (one dlogits definition, the same
    products in the same order)."""
    _need_gpu()
    x, w, labels, g = _ce_case(torch.bfloat16, 1000, 512, v)
    first = _ce_all(x, w, labels, g)
    again = _ce_all(x, w, labels, g)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    lse = fc.fused_ce_fwd_plain(x, w, labels)[0]
    assert torch.equal(fc.fused_ce_dx(x, w, labels, lse, g), first[2])
    assert torch.equal(fc.fused_ce_dw(x, w, labels, lse, g), first[3])


@pytest.mark.cuda
def test_fused_linear_ce_full_step_runs_the_joint_backward():
    """bf16 autograd on the wgmma route: a full step launches the joint
    backward (and neither dx nor dw apart), a frozen w launches dx
    alone."""
    _need_gpu()
    x, w, labels, g = _ce_case(torch.bfloat16, 300, 128, 1000)
    w32 = w.float()
    before = fc.counters()
    xl, wl = x.clone().requires_grad_(), w32.clone().requires_grad_()
    nll = fc.fused_linear_ce(xl, wl, labels)
    dx, dw = torch.autograd.grad(nll, (xl, wl), g)
    after = fc.counters()
    assert dw.dtype == torch.float32 and dx.dtype == torch.bfloat16
    for name in ("fused_ce_fwd", "fused_ce_bwd"):
        assert after[name] == before[name] + 1
    for name in ("fused_ce_dx", "fused_ce_dw"):
        assert after[name] == before[name]
    assert after["fused_ce_wgmma"] == before["fused_ce_wgmma"] + 2
    lse = fc.fused_ce_fwd_plain(x, w, labels)[0]
    ref_dx, ref_dw = fc.fused_ce_bwd_plain(x, w, labels, lse, g)
    assert _rel(dx, ref_dx) <= CE_TOL["dx"][torch.bfloat16]
    assert _rel(dw, ref_dw) <= CE_TOL["dw"]
    xl = x.clone().requires_grad_()
    fc.fused_linear_ce(xl, w32, labels).backward(g)
    last = fc.counters()
    assert last["fused_ce_dw"] == after["fused_ce_dw"]
    assert last["fused_ce_bwd"] == after["fused_ce_bwd"]
    assert last["fused_ce_dx"] == after["fused_ce_dx"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1536, 1544, 1000, 72, 4096, 8192, 8200])
@pytest.mark.parametrize("rows", [1, 37, 4096, 9000])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16],
                         ids=["x_f32", "x_bf16"])
def test_rmsnorm_walks_rows(xdt, rows, d):
    """Widths that fill a lane's chunks exactly (1536 bf16: 6 a lane) or
    leave the last lanes a chunk short (1544, 1000, 72), and widths past
    one warp's registers on the wide route (4096 f32, 8192, and 8200,
    whose last chunks leave some threads of the block idle), rows fewer
    than the warps or many per warp: the plain version's numbers, and
    the same bits on every launch."""
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(rows + d)
    x = (torch.randn((rows, d), generator=gen, device="cuda") * 3).to(xdt)
    w = torch.rand(d, generator=gen, device="cuda") + 0.5
    want = rn.rmsnorm_plain(x, w, 1e-6)
    outs = [rn.rmsnorm_fwd(x, w, 1e-6) for _ in range(3)]
    torch.cuda.synchronize()
    assert _rel(outs[0], want) <= TRAIN_TOL[xdt]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


# ---------------------------------------------------------------------------
# The weight-quantized product


def _quant_case(mode, e, m, k, n, xdt, per_expert, group=64, seed=0):
    """x, the quantized weight and its scale on the card: x [m, k] (or
    [e, m, k] one input an expert), a weight [k, n] (or [e, k, n])."""
    from oim_tpu_torch.ops import quant as tq

    gen = torch.Generator(device="cuda").manual_seed(seed)
    lead = (e,) if e else ()
    w = torch.randn((*lead, k, n), generator=gen, device="cuda") * 0.05
    q, scale = (tq.quantize_weight_int8(w) if mode == "int8"
                else tq.quantize_weight_int4(w, group))
    xshape = (e, m, k) if per_expert else (m, k)
    x = torch.randn(xshape, generator=gen, device="cuda").to(xdt)
    return x, q.contiguous(), scale.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3, 8, 9, 17, 64, 100])
@pytest.mark.parametrize("mode,k,group", [("int8", 1536, 64),
                                          ("int4", 1536, 64),
                                          ("int4", 96, 32),
                                          ("int4", 37, 37)],
                         ids=["int8", "int4-g64", "int4-g32", "int4-odd"])
@pytest.mark.parametrize("xdt,odt", [(torch.bfloat16, None),
                                     (torch.bfloat16, torch.float32),
                                     (torch.float32, None)],
                         ids=["bf16", "bf16-f32out", "f32"])
def test_quant_matmul_matches_plain(xdt, odt, mode, k, group, m):
    """Both routes (the fused kernel for bf16 x up to 64 rows over a
    reduction and int4 groups of a multiple of 16; the dequantized weight
    and torch.matmul otherwise: f32 x, an odd reduction with int4's
    padding row, more rows) against the plain version; two launches
    bit-equal; one launch counted a call, on the route ``quant_route``
    names."""
    _need_gpu()
    from oim_tpu_torch.ops import wquant

    x, q, scale = _quant_case(mode, 0, m, k, 256, xdt, False, group)
    route = wquant.quant_route(xdt, m, k, 256, group if mode == "int4"
                               else 0)
    before = wquant.counters()
    got = wquant.quant_matmul(x, q, scale, dtype=xdt, out_dtype=odt)
    again = wquant.quant_matmul(x, q, scale, dtype=xdt, out_dtype=odt)
    want = wquant.quant_matmul_plain(x, q, scale, dtype=xdt, out_dtype=odt)
    torch.cuda.synchronize()
    after = wquant.counters()
    assert got.dtype == (odt or xdt) and got.shape == want.shape
    assert torch.equal(got, again)
    tol = (2.0**-7 + 1e-4) if got.dtype == torch.bfloat16 else 1e-4
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * float(want.float().abs().max())
    name = f"quant_matmul_{route}"
    assert after[name] == before[name] + 2
    fits = xdt == torch.bfloat16 and k % 16 == 0 and (
        mode == "int8" or group % 16 == 0)
    assert route == ("gemv" if m <= 64 and fits else "dequant")


@pytest.mark.cuda
@pytest.mark.parametrize("per_expert", [False, True], ids=["shared", "own"])
@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("m", [2, 8, 200])
def test_quant_matmul_experts_match_plain(m, mode, per_expert):
    """The expert axis as ``_moe_exact`` uses it: w_gate/w_in [E, d, f]
    over an input all experts share, w_out [E, f, d] over one input an
    expert; bf16."""
    _need_gpu()
    from oim_tpu_torch.ops import wquant

    k, n = (512, 768) if not per_expert else (768, 512)
    x, q, scale = _quant_case(mode, 4, m, k, n, torch.bfloat16, per_expert)
    got = wquant.quant_matmul(x, q, scale, dtype=torch.bfloat16)
    want = wquant.quant_matmul_plain(x, q, scale, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert got.shape == (4, m, n) == want.shape
    err = float((got.float() - want.float()).abs().max())
    assert err <= (2.0**-7 + 1e-4) * float(want.float().abs().max())


@pytest.mark.cuda
def test_quant_matmul_refuses_what_the_kernel_does_not_take():
    _need_gpu()
    from oim_tpu_torch.ops import wquant

    x, q, scale = _quant_case("int8", 0, 4, 256, 256, torch.bfloat16, False)
    with pytest.raises(ValueError, match="compute dtype"):
        wquant.quant_matmul(x, q, scale, dtype=torch.float32)
    with pytest.raises(ValueError, match="rows must be"):
        wquant.quant_matmul(x[:, :128], q, scale, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        wquant.quant_matmul(x, q.t().contiguous().t(), scale,
                            dtype=torch.bfloat16)
