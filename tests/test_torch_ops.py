"""Parity of the PyTorch port's ops with the JAX package's, on the CPU.

Inputs are drawn from a seeded numpy generator and handed to both
packages.  The JAX side runs as its own tests run it here: the Pallas
paged-attention kernels in interpret mode.  The port's side runs the
plain PyTorch versions, which its kernel wrappers take for CPU tensors;
the CUDA kernels themselves are held against those plain versions on
the card (``tests/test_torch_kernels.py`` and ``chip_smoke.py``).

Tolerances: quantization, the pool stores and the views are integer or
copy operations and must be bit-equal.  Attention differs only in f32
summation order (a two-pass softmax against the reference's online one
over at most 32 keys of unit-scale data), which stays far below 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oim_tpu.ops import paged as jpaged
from oim_tpu.ops import paged_attention as jpa
from oim_tpu.ops import quant as jquant
from oim_tpu.ops.rmsnorm import reference_rmsnorm as j_reference_rmsnorm
from oim_tpu.ops import rope as jrope

from oim_tpu_torch.ops import _build
from oim_tpu_torch.ops import paged as tpaged
from oim_tpu_torch.ops import paged_attention as tpa
from oim_tpu_torch.ops import quant as tquant
from oim_tpu_torch.ops import rmsnorm as trms
from oim_tpu_torch.ops import rope as trope
from torch_cpu_threads import one_torch_thread  # noqa: F401

ATTN_ATOL = 1e-5

# Pool geometry: 12 blocks of 8 rows, 2 kv heads of 16, 4 table entries
# per row (32 positions), GQA group 2.
N_BLOCKS, BS, KVH, HD, N_TABLES, H = 12, 8, 2, 16, 4, 4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return np.asarray(x)


def _tables():
    """Three rows: two fully live (distinct blocks), one all-sentinel
    (an inactive slot)."""
    return np.array(
        [[3, 7, 0, 9], [1, 4, 10, 2], [N_BLOCKS] * N_TABLES], np.int32
    )


def _pool(rng, quant: bool):
    """A random one-layer pool (+ scales for int8)."""
    shape = (N_BLOCKS, BS, KVH, HD)
    if not quant:
        return (rng.randn(*shape).astype(np.float32),
                rng.randn(*shape).astype(np.float32), None, None)
    return (
        rng.randint(-127, 128, shape).astype(np.int8),
        rng.randint(-127, 128, shape).astype(np.int8),
        (rng.rand(*shape[:-1]) * 0.02 + 0.001).astype(np.float32),
        (rng.rand(*shape[:-1]) * 0.02 + 0.001).astype(np.float32),
    )


def _opt(x, fn):
    return None if x is None else fn(x)


# ---------------------------------------------------------------------------
# Quantization


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_bit_equal(dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(257, 16).astype(np.float32) * 3.0
    x[0] = 0.0  # zero vector: tiny scale, zeros, no NaN
    # amax 127 makes the scale exactly 1, so these are exact .5 ties:
    # half-to-even rounding sends 0.5 → 0, 1.5 → 2, 2.5 → 2, -2.5 → -2.
    x[1] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5,
            4.5, -3.5, 100.5, -100.5, 126.5, 0.0, 1.0, -127.0]
    xj = jnp.asarray(x, dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    qj, sj = jquant.quantize_int8(xj)
    qt, st = tquant.quantize_int8(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(_np(qj), qt.numpy())
    np.testing.assert_array_equal(_np(sj), st.numpy())
    assert qt[1, 1:8].tolist() == [0, 2, 2, 0, -2, -2, 4]
    np.testing.assert_array_equal(
        _np(jquant.dequantize_int8(qj, sj)),
        tquant.dequantize_int8(qt, st).numpy(),
    )


@pytest.mark.parametrize("quantized", [False, True, "int8"])
def test_make_kv_buffers_layout(quantized):
    shape = (2, 3, 8, 2, 16)
    kj = jquant.make_kv_buffers(shape, jnp.float32, quantized)
    kt = tquant.make_kv_buffers(shape, torch.float32, quantized)
    for a, b in zip(kj, kt):
        if a is None:
            assert b is None
            continue
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(_np(a), b.numpy())


def test_make_kv_buffers_int4_layout():
    """int4 buffers: packed ``torch.uint8`` payloads of head_dim / 2
    bytes whose unpacked values are the reference's ``jnp.int4`` zeros,
    and its f32 scale planes (ones); an odd head_dim cannot pack."""
    shape = (2, 3, 8, 2, 16)
    kj = jquant.make_kv_buffers(shape, jnp.float32, "int4")
    kt = tquant.make_kv_buffers(shape, torch.float32, "int4")
    for a, b in zip(kj[:2], kt[:2]):
        assert b.dtype == torch.uint8 and tuple(b.shape) == (2, 3, 8, 2, 8)
        np.testing.assert_array_equal(_np(a).astype(np.int8),
                                      tquant.unpack_int4(b).numpy())
    for a, b in zip(kj[2:], kt[2:]):
        np.testing.assert_array_equal(_np(a), b.numpy())
    assert kt[2] is not kt[3]
    with pytest.raises(ValueError, match="even"):
        tquant.make_kv_buffers((1, 8, 2, 15), torch.float32, "int4")


# ---------------------------------------------------------------------------
# Paged store / view


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_paged_store_bit_equal(quant):
    rng = np.random.RandomState(1)
    cache, _, scale, _ = _pool(rng, quant)
    tables = _tables()
    tables[1, 3] = N_BLOCKS  # row 1's last entry is a sentinel
    # Row 0 straddles entries 1..2; row 1 runs into its sentinel entry
    # (those rows drop); row 2 is all-sentinel (everything drops).
    starts = np.array([5, 20, 3], np.int32)
    new = rng.randn(3, 9, KVH, HD).astype(np.float32)
    cj, sj = jpaged.paged_store(
        jnp.asarray(cache), _opt(scale, jnp.asarray), jnp.asarray(new),
        jnp.asarray(tables), jnp.asarray(starts),
    )
    ct, st = _t(cache).clone(), _opt(scale, lambda s: _t(s).clone())
    out_c, out_s = tpaged.paged_store(
        ct, st, _t(new), _t(tables), _t(starts)
    )
    assert out_c is ct  # in place
    np.testing.assert_array_equal(_np(cj), ct.numpy())
    if quant:
        np.testing.assert_array_equal(_np(sj), st.numpy())
    else:
        assert sj is None and out_s is None
    # The sentinel-covered rows of row 1 (positions 24..28) landed
    # nowhere: only 4 of its 9 rows changed the pool.
    changed = (ct.numpy() != cache).any(axis=(2, 3))
    assert changed[tables[1, 2], 4:].all() and changed[tables[1, 2]].sum() == 4


def test_paged_store_drops_rows_past_the_table():
    rng = np.random.RandomState(2)
    cache = rng.randn(N_BLOCKS, BS, KVH, HD).astype(np.float32)
    tables = _tables()[:1]
    starts = np.array([28], np.int32)  # rows 28..35: 32.. lie past the table
    new = rng.randn(1, 8, KVH, HD).astype(np.float32)
    ct = _t(cache).clone()
    tpaged.paged_store(ct, None, _t(new), _t(tables), _t(starts))
    want = cache.copy()
    want[tables[0, 3], 4:] = new[0, :4]
    np.testing.assert_array_equal(ct.numpy(), want)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_paged_view_bit_equal(quant):
    rng = np.random.RandomState(3)
    cache, _, scale, _ = _pool(rng, quant)
    tables = _tables()
    vj, svj = jpaged.paged_view(
        jnp.asarray(cache), _opt(scale, jnp.asarray), jnp.asarray(tables)
    )
    vt, svt = tpaged.paged_view(_t(cache), _opt(scale, _t), _t(tables))
    np.testing.assert_array_equal(_np(vj), vt.numpy())
    if quant:
        np.testing.assert_array_equal(_np(svj), svt.numpy())
    else:
        assert svj is None and svt is None


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_paged_store_blocks_bit_equal(quant):
    rng = np.random.RandomState(4)
    cache, _, scale, _ = _pool(rng, quant)
    ids = np.array([5, N_BLOCKS, 0, N_BLOCKS + 3], np.int32)  # two drop
    if quant:
        blocks = rng.randint(-127, 128, (4, BS, KVH, HD)).astype(np.float32)
        bscales = rng.rand(4, BS, KVH).astype(np.float32)
    else:
        blocks = rng.randn(4, BS, KVH, HD).astype(np.float32)
        bscales = None
    cj, sj = jpaged.paged_store_blocks(
        jnp.asarray(cache), _opt(scale, jnp.asarray), jnp.asarray(blocks),
        _opt(bscales, jnp.asarray), jnp.asarray(ids),
    )
    ct, st = _t(cache).clone(), _opt(scale, lambda s: _t(s).clone())
    tpaged.paged_store_blocks(
        ct, st, _t(blocks), _opt(bscales, _t), _t(ids).long()
    )
    np.testing.assert_array_equal(_np(cj), ct.numpy())
    if quant:
        np.testing.assert_array_equal(_np(sj), st.numpy())


# ---------------------------------------------------------------------------
# Paged attention: the plain versions against the reference kernels


def _attend_inputs(rng, quant, t):
    k, v, ks, vs = _pool(rng, quant)
    q = rng.randn(3, t, H, HD).astype(np.float32)
    # Row 0 at a block boundary, row 1 mid-block, row 2 all-sentinel.
    starts = np.array([8, 29 - t, 4], np.int32)
    return q, k, v, ks, vs, _tables(), starts


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_paged_flash_decode_plain_matches_jax(quant, t, window):
    rng = np.random.RandomState(10 + t + window)
    q, k, v, ks, vs, tables, starts = _attend_inputs(rng, quant, t)
    want = jpa.paged_flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        _opt(ks, jnp.asarray), _opt(vs, jnp.asarray),
        jnp.asarray(tables), jnp.asarray(starts), window=window,
    )
    before = tpa.counters()
    got = tpa.paged_flash_decode(
        _t(q), _t(k), _t(v), _opt(ks, _t), _opt(vs, _t), _t(tables),
        _t(starts), window=window,
    )
    after = tpa.counters()
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATTN_ATOL,
                               rtol=0)
    # The inactive row emits zeros on both sides.
    assert not got[2].any()
    # A CPU tensor took the plain version, never the kernel.
    assert after["paged_flash_decode"] == before["paged_flash_decode"]
    assert (after["paged_flash_decode_plain"]
            == before["paged_flash_decode_plain"] + 1)


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_paged_flash_prefill_plain_matches_jax(quant, window):
    rng = np.random.RandomState(20 + window)
    k, v, ks, vs = _pool(rng, quant)
    tables = _tables()
    tables[1, 3] = N_BLOCKS  # row 1's window runs into a sentinel entry
    t = 11
    starts = np.array([3, 17, 0], np.int32)  # both straddle blocks
    q = rng.randn(3, t, H, HD).astype(np.float32)
    k_new = rng.randn(3, t, KVH, HD).astype(np.float32)
    v_new = rng.randn(3, t, KVH, HD).astype(np.float32)
    out_j, kj, vj, ksj, vsj = jpa.paged_flash_prefill(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(k), jnp.asarray(v), _opt(ks, jnp.asarray),
        _opt(vs, jnp.asarray), jnp.asarray(tables), jnp.asarray(starts),
        window=window,
    )
    pools = [_t(k).clone(), _t(v).clone(), _opt(ks, lambda s: _t(s).clone()),
             _opt(vs, lambda s: _t(s).clone())]
    out_t, kt, vt, kst, vst = tpa.paged_flash_prefill(
        _t(q), _t(k_new), _t(v_new), *pools, _t(tables), _t(starts),
        window=window,
    )
    assert kt is pools[0] and vt is pools[1]  # updated in place
    np.testing.assert_array_equal(_np(kj), kt.numpy())
    np.testing.assert_array_equal(_np(vj), vt.numpy())
    if quant:
        # The scales are bit-equal to what the reference's paged_store
        # lands (quantize_int8's true division amax / 127, the contract
        # both prefill kernels name).  The reference's staging kernel
        # itself, in interpret mode, rounds a few of them one f32 ulp
        # away from that (as a multiply by 1/127 would), so against its
        # output the scales agree to one ulp and the payloads exactly.
        for pool, scale, new, got, staged in (
            (k, ks, k_new, kst, ksj), (v, vs, v_new, vst, vsj),
        ):
            _, want = jpaged.paged_store(
                jnp.asarray(pool), jnp.asarray(scale), jnp.asarray(new),
                jnp.asarray(tables), jnp.asarray(starts),
            )
            np.testing.assert_array_equal(_np(want), got.numpy())
            np.testing.assert_array_max_ulp(_np(staged), got.numpy(), 1)
    np.testing.assert_allclose(out_t.numpy(), _np(out_j), atol=ATTN_ATOL,
                               rtol=0)


@pytest.mark.parametrize("case", [
    "v_pool", "scale_pair", "scale_shape", "tables_rows", "starts",
    "q_head_dim", "new_kv_heads",
])
def test_wrappers_refuse_mismatched_shapes(case):
    """Shapes are checked before either path runs: the kernels index with
    them, so a mismatch must never reach a launch."""
    rng = np.random.RandomState(8)
    q, k, v, ks, vs, tables, starts = _attend_inputs(rng, True, 2)
    k_new = rng.randn(3, 2, KVH, HD).astype(np.float32)
    args = dict(q=_t(q), k=_t(k), v=_t(v), ks=_t(ks), vs=_t(vs),
                tables=_t(tables), starts=_t(starts), k_new=_t(k_new))
    if case == "v_pool":
        args["v"] = args["v"][:-1]
    elif case == "scale_pair":
        args["vs"] = None
    elif case == "scale_shape":
        args["ks"] = args["ks"][:, :-1]
    elif case == "tables_rows":
        args["tables"] = args["tables"][:2]
    elif case == "starts":
        args["starts"] = args["starts"][:, None]
    elif case == "q_head_dim":
        args["q"] = args["q"][..., :-1]
    elif case == "new_kv_heads":
        args["k_new"] = args["k_new"][:, :, :1]
    a = args
    with pytest.raises(ValueError):
        if case == "new_kv_heads":
            tpa.paged_kv_store(a["k_new"], a["k_new"], a["k"], a["v"],
                               a["ks"], a["vs"], a["tables"], a["starts"])
        else:
            tpa.paged_flash_decode(a["q"], a["k"], a["v"], a["ks"], a["vs"],
                                   a["tables"], a["starts"])


def test_kernel_geometry_rule():
    assert tpa.supported_block_size(16, 128)
    assert tpa.supported_block_size(64, 64)
    assert not tpa.supported_block_size(128, 128)  # > MAX_BLOCK_SIZE
    assert not tpa.supported_block_size(16, 96)    # head_dim not 64/128
    assert not tpa.supported_block_size(0, 128)


def test_reset_counters():
    rng = np.random.RandomState(5)
    q, k, v, ks, vs, tables, starts = _attend_inputs(rng, False, 1)
    tpa.paged_flash_decode(_t(q), _t(k), _t(v), None, None, _t(tables),
                           _t(starts))
    assert tpa.counters()["paged_flash_decode_plain"] > 0
    tpa.reset_counters()
    assert set(tpa.counters().values()) == {0}


def test_kernel_build_needs_nvcc(tmp_path, monkeypatch):
    """Where there is no CUDA toolkit, building the kernels raises; it
    never falls back to anything."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    # The library name keys on the sources and flags.
    assert _build.library_path().name.startswith("liboim_kernels-")


# ---------------------------------------------------------------------------
# RoPE and RMSNorm


@pytest.mark.parametrize("scaling", [(), (8.0, 1.0, 4.0, 64)],
                         ids=["plain", "llama3"])
def test_rope_matches_jax(scaling):
    rng = np.random.RandomState(6)
    x = rng.randn(2, 5, 3, 16).astype(np.float32)
    positions = np.array([[0, 1, 2, 3, 4], [40, 41, 42, 43, 44]], np.int32)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(positions), 1e6,
                            scaling)
    got = trope.apply_rope(_t(x), _t(positions), 1e6, scaling)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        trope.rope_frequencies(16, 1e6, scaling).numpy(),
        _np(jrope.rope_frequencies(16, 1e6, scaling)), rtol=1e-6,
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    rng = np.random.RandomState(7)
    x = rng.randn(4, 3, 64).astype(np.float32)
    w = rng.rand(64).astype(np.float32) + 0.5
    want = j_reference_rmsnorm(jnp.asarray(x, dtype), jnp.asarray(w),
                                  1e-6)
    got = trms.reference_rmsnorm(_t(x).to(getattr(torch, dtype)), _t(w),
                                 1e-6)
    assert got.dtype == getattr(torch, dtype)
    # f32: the same f32 arithmetic; bf16: at most one bf16 rounding step
    # (2**-8 relative) where rsqrt's last f32 bit rounds differently.
    np.testing.assert_allclose(
        got.float().numpy(), _np(want.astype(jnp.float32)),
        rtol=1e-6 if dtype == "float32" else 2.0 ** -8, atol=1e-6,
    )


@pytest.mark.parametrize("d,dtype,route", [
    (1536, torch.bfloat16, "rows"), (4096, torch.bfloat16, "rows"),
    (8192, torch.bfloat16, "wide"), (2048, torch.float32, "rows"),
    (2052, torch.float32, "wide"), (4096, torch.float32, "wide"),
    (8192, torch.float32, "wide"),
])
def test_rmsnorm_route_by_row_width(d, dtype, route):
    """Rows that fit one warp's registers (16 chunks of 16 bytes a lane)
    take the register kernel; wider ones, which the kernel used to
    refuse, the wide kernel."""
    assert trms.rmsnorm_route(d, dtype) == route


def test_rmsnorm_wide_rows_run_plain_on_the_cpu():
    """A CPU tensor of any width takes the plain version, counted as
    such, with no launch counted."""
    rng = np.random.RandomState(8)
    x = _t(rng.randn(3, 8192).astype(np.float32))
    w = _t(rng.rand(8192).astype(np.float32) + 0.5)
    trms.reset_counters()
    got = trms.rmsnorm_fwd(x, w, 1e-5)
    assert trms.counters() == {"rmsnorm": 0, "rmsnorm_wide": 0,
                               "rmsnorm_plain": 1}
    assert torch.equal(got, trms.reference_rmsnorm(x, w, 1e-5))
