"""The port's packed int4 KV cache on the CPU, against the JAX package.

torch has no int4 dtype, so the port's int4 pools are ``torch.uint8``
with two values a byte along ``head_dim`` (``ops/quant.py``
``pack_int4``); the reference's are ``jnp.int4``.  Inputs come from a
seeded numpy generator and go through both packages:

- the int4 quantizer, the paged store into an int4 pool and the paged
  view: the unpacked values and the scales bit-equal;
- the plain K1 over an int4 pool, and a segment's store-then-attend,
  against the reference kernels in interpret mode (f32 summation order
  only: 1e-5);
- the engine with ``kv_int4`` on the paged pool, at depth 1 and 2 and
  with the prefix cache and chunked prefill: greedy tokens identical to
  the JAX engine's, and the unpacked pool equal to its ``jnp.int4``
  pool after the same traffic, wherever both engines determine it:
  each block's rows below the frontier of the last request whose block
  table held it (its prompt and the tokens it emitted but the last),
  found by reading both engines' tables after every step.  Past a
  frontier, a chunk dispatched ahead writes rows past a finished
  request's budget, and the JAX engine writes those differently from
  run to run.  The engines' K/V projections differ in f32 summation
  order, so the scales agree to 1e-5 relative (a few ulps) and the
  quantized values exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oim_tpu.models import TransformerConfig as JaxConfig
from oim_tpu.models import init_params as jax_init_params
from oim_tpu.ops import paged as jpaged
from oim_tpu.ops import paged_attention as jpa
from oim_tpu.ops import quant as jquant
from oim_tpu.serve import Engine as JaxEngine
from oim_tpu.serve import GenRequest as JaxRequest

from oim_tpu_torch.models.transformer import TransformerConfig
from oim_tpu_torch.models.weights import from_jax_params
from oim_tpu_torch.ops import paged as tpaged
from oim_tpu_torch.ops import paged_attention as tpa
from oim_tpu_torch.ops import quant as tquant
from oim_tpu_torch.serve.engine import Engine, GenRequest
from torch_cpu_threads import one_torch_thread  # noqa: F401

ATTN_ATOL = 1e-5
N_BLOCKS, BS, KVH, HD, N_TABLES, H = 12, 8, 2, 16, 4, 4
CFG = dict(
    vocab_size=101, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=96, attn_bias=True, dtype="float32",
)
ENGINE = dict(n_slots=2, max_len=64, chunk=4, prompt_buckets=(8, 16, 32),
              kv_block=8, kv_int4=True)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _values(x):
    """A reference int4 array's values as int8 numpy."""
    return np.asarray(x).astype(np.int8)


def _tables():
    return np.array(
        [[3, 7, 0, 9], [1, 4, 10, 2], [N_BLOCKS] * N_TABLES], np.int32
    )


def _pool(rng):
    """A random int4 pool: (reference k, v as jnp.int4, port k, v packed,
    k and v scales)."""
    shape = (N_BLOCKS, BS, KVH, HD)
    k, v = (rng.randint(-7, 8, shape).astype(np.int8) for _ in range(2))
    ks, vs = ((rng.rand(*shape[:-1]) * 0.2 + 0.01).astype(np.float32)
              for _ in range(2))
    return (jnp.asarray(k, jnp.int4), jnp.asarray(v, jnp.int4),
            tquant.pack_int4(_t(k)), tquant.pack_int4(_t(v)), ks, vs)


def test_quantize_int4_and_packing_bit_equal():
    rng = np.random.RandomState(0)
    x = rng.randn(65, 16).astype(np.float32) * 3.0
    x[0] = 0.0  # zero vector: tiny scale, zeros
    # amax 7 makes the scale exactly 1: exact .5 ties round to even.
    x[1] = [7.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5,
            4.5, -3.5, 6.5, -6.5, 5.5, 0.0, 1.0, -7.0]
    qj, sj = jquant.quantize_int4(jnp.asarray(x))
    qt, st = tquant.quantize_int4(_t(x))
    np.testing.assert_array_equal(_values(qj), qt.numpy())
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    assert qt[1, 1:8].tolist() == [0, 2, 2, 0, -2, -2, 4]
    packed = tquant.pack_int4(qt)
    assert packed.dtype == torch.uint8 and packed.shape == (65, 8)
    # Byte j: value 2j in the low nibble, 2j + 1 in the high one.
    assert int(packed[1, 0]) == (7 & 0xF) | ((0 & 0xF) << 4)
    assert torch.equal(tquant.unpack_int4(packed), qt)
    np.testing.assert_array_equal(
        np.asarray(jquant.dequantize_int8(qj, sj)),
        tquant.dequantize_int8(tquant.kv_values(packed), st).numpy(),
    )


def test_paged_store_and_view_int4_bit_equal():
    rng = np.random.RandomState(1)
    kj, _, kt, _, ks, _ = _pool(rng)
    tables = _tables()
    tables[1, 3] = N_BLOCKS  # row 1 runs into a sentinel entry (dropped)
    starts = np.array([5, 20, 3], np.int32)
    new = rng.randn(3, 9, KVH, HD).astype(np.float32)
    cj, sj = jpaged.paged_store(kj, jnp.asarray(ks), jnp.asarray(new),
                                jnp.asarray(tables), jnp.asarray(starts))
    st = _t(ks).clone()
    tpaged.paged_store(kt, st, _t(new), _t(tables), _t(starts))
    np.testing.assert_array_equal(_values(cj), tquant.unpack_int4(kt).numpy())
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    vj, svj = jpaged.paged_view(cj, sj, jnp.asarray(tables))
    vt, svt = tpaged.paged_view(kt, st, _t(tables))
    np.testing.assert_array_equal(_values(vj), tquant.unpack_int4(vt).numpy())
    np.testing.assert_array_equal(np.asarray(svj), svt.numpy())


@pytest.mark.parametrize("t,window", [(1, 0), (3, 5)])
def test_paged_flash_decode_plain_int4_matches_jax(t, window):
    rng = np.random.RandomState(10 + t + window)
    kj, vj, kt, vt, ks, vs = _pool(rng)
    q = rng.randn(3, t, H, HD).astype(np.float32)
    tables, starts = _tables(), np.array([8, 29 - t, 4], np.int32)
    want = jpa.paged_flash_decode(
        jnp.asarray(q), kj, vj, jnp.asarray(ks), jnp.asarray(vs),
        jnp.asarray(tables), jnp.asarray(starts), window=window,
    )
    got = tpa.paged_flash_decode(_t(q), kt, vt, _t(ks), _t(vs), _t(tables),
                                 _t(starts), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATTN_ATOL, rtol=0)
    assert not got[2].any()


def test_paged_flash_prefill_plain_int4_matches_jax():
    """A segment's K2 then K1 over an int4 pool: the stored values and
    scales equal the reference's ``paged_store``'s, the output its
    prefill kernel's."""
    rng = np.random.RandomState(20)
    kj, vj, kt, vt, ks, vs = _pool(rng)
    tables = _tables()
    tables[1, 3] = N_BLOCKS
    t, starts = 11, np.array([3, 17, 0], np.int32)
    q = rng.randn(3, t, H, HD).astype(np.float32)
    k_new, v_new = (rng.randn(3, t, KVH, HD).astype(np.float32)
                    for _ in range(2))
    out_j, *_ = jpa.paged_flash_prefill(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), kj, vj,
        jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(tables),
        jnp.asarray(starts),
    )
    pools = [kt, vt, _t(ks).clone(), _t(vs).clone()]
    out_t, *_ = tpa.paged_flash_prefill(
        _t(q), _t(k_new), _t(v_new), *pools, _t(tables), _t(starts))
    for pool, scale, new, got, got_scale in (
            (kj, ks, k_new, pools[0], pools[2]),
            (vj, vs, v_new, pools[1], pools[3])):
        want, want_scale = jpaged.paged_store(
            pool, jnp.asarray(scale), jnp.asarray(new), jnp.asarray(tables),
            jnp.asarray(starts))
        np.testing.assert_array_equal(_values(want),
                                      tquant.unpack_int4(got).numpy())
        np.testing.assert_array_equal(np.asarray(want_scale),
                                      got_scale.numpy())
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               atol=ATTN_ATOL, rtol=0)


def test_wrappers_check_packed_pools():
    """A packed pool's last dimension is head_dim / 2, and it takes
    scales."""
    rng = np.random.RandomState(5)
    _, _, kt, vt, ks, vs = _pool(rng)
    q = _t(rng.randn(3, 1, H, HD).astype(np.float32))
    tables, starts = _t(_tables()), _t(np.array([8, 9, 4], np.int32))
    with pytest.raises(ValueError, match="head"):
        tpa.paged_flash_decode(q[..., :HD // 2].contiguous(), kt, vt,
                               _t(ks), _t(vs), tables, starts)
    with pytest.raises(ValueError, match="scales"):
        tpa.paged_flash_decode(q, kt, vt, None, None, tables, starts)
    new = _t(rng.randn(3, 1, KVH, HD // 2).astype(np.float32))
    with pytest.raises(ValueError, match="new K/V"):
        tpa.paged_kv_store(new, new, kt, vt, _t(ks), _t(vs), tables, starts)


# ---------------------------------------------------------------------------
# The engine


@pytest.fixture(scope="module")
def model():
    jcfg = JaxConfig(**CFG, use_pallas=False)
    jparams = dict(jax_init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.RandomState(0)
    for name in ("bq", "bk", "bv"):
        jparams[name] = jnp.asarray(
            rng.randn(*jparams[name].shape).astype(np.float32) * 0.1)
    tcfg = TransformerConfig(**CFG)
    tree = {name: np.asarray(value) for name, value in jparams.items()}
    return jcfg, jparams, tcfg, from_jax_params(tree, tcfg)


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, CFG["vocab_size"],
                                               n).tolist()


# (prompt seed, length, budget): more requests than slots, one prompt
# longer than a segment of 8, two sharing a 16-token prefix.
SHARED = _prompt(50, 16)
TRAFFIC = [(SHARED + _prompt(1, 3), 7), (_prompt(2, 20), 6),
           (SHARED + _prompt(3, 5), 8), (_prompt(4, 9), 5)]


def _serve(engine, request_cls, **kw):
    """Serve TRAFFIC; returns (each request's tokens, the pool rows the
    run determines: a bool mask [n_blocks, block_size])."""
    rids = [engine.submit(request_cls(tokens=p, max_new_tokens=m,
                                      cache_prefix=True, **kw))
            for p, m in TRAFFIC]
    owner = {}  # block → (rid, its index in the rid's table)
    while engine.pending():  # what run() does, reading tables between
        engine.step()
        with engine._lock:
            seated = [(s.rid, slot) for slot, s in engine._slots.items()]
            seated += [(p.rid, p.slot) for p in engine._prefilling.values()]
            for rid, slot in seated:
                for i, block in enumerate(engine._tables_host[slot]):
                    if block < engine.kv_blocks:
                        owner[int(block)] = (rid, i)
    tokens = [engine.result(rid) for rid in rids]
    frontier = {rid: len(p) + len(out) - 1
                for rid, (p, _), out in zip(rids, TRAFFIC, tokens)}
    bs = engine.kv_block
    mask = np.zeros((engine.kv_blocks, bs), bool)
    for block, (rid, i) in owner.items():
        mask[block] = i * bs + np.arange(bs) < frontier[rid]
    return tokens, mask


@pytest.fixture(scope="module")
def reference(model):
    """The JAX engine's greedy streams and int4 pool, per engine
    options."""
    jcfg, jparams, _, _ = model
    cache = {}

    def run(**kw):
        key = tuple(sorted(kw.items()))
        if key not in cache:
            engine = JaxEngine(jparams, jcfg, **ENGINE, **kw)
            tokens, mask = _serve(engine, JaxRequest)
            cache[key] = tokens, mask, engine._cache
        return cache[key]

    return run


@pytest.mark.parametrize("extra", [
    dict(pipeline_depth=2),
    dict(pipeline_depth=1, prefix_cache_size=2, prefill_chunk=8),
], ids=["depth2", "depth1-prefix-chunked"])
def test_engine_kv_int4_matches_jax(model, reference, extra):
    _, _, tcfg, params = model
    want, want_mask, jcache = reference(**extra)
    engine = Engine(params, tcfg, **ENGINE, **extra, device="cpu")
    got, mask = _serve(engine, GenRequest)
    assert got == want
    info = engine.info()["engine"]
    assert (info["kv_int4"], info["kv_quant"], info["kv_int8"]) == (
        True, "int4", False)
    cache = engine._cache
    assert cache.k.dtype == torch.uint8
    assert cache.k.shape[-1] == tcfg.head_dim // 2
    # The same blocks hold the same requests' rows in both engines, and
    # what they determine covers every request's prompt.
    np.testing.assert_array_equal(mask, want_mask)
    assert mask.sum() >= sum(len(p) for p, _ in TRAFFIC) - len(SHARED)
    # The pools [layers, blocks, rows, ...] there, exact.
    for mine, theirs in ((cache.k, jcache.k), (cache.v, jcache.v)):
        np.testing.assert_array_equal(
            tquant.unpack_int4(mine).numpy()[:, mask],
            _values(theirs)[:, mask])
    for mine, theirs in ((cache.k_scale, jcache.k_scale),
                         (cache.v_scale, jcache.v_scale)):
        np.testing.assert_allclose(mine.numpy()[:, mask],
                                   np.asarray(theirs)[:, mask],
                                   rtol=1e-5, atol=0)
    if "prefix_cache_size" in extra:
        assert engine.stats()["prefix_hits"] >= 1
        assert engine.stats()["prefill_segments"] > len(TRAFFIC)


def test_engine_kv_int4_refusals(model):
    """The reference's own refusals, message for message."""
    _, _, tcfg, params = model
    with pytest.raises(ValueError, match="mutually exclusive"):
        Engine(params, tcfg, **ENGINE, kv_int8=True, device="cpu")
    with pytest.raises(ValueError, match="kv_int4 needs the paged cache"):
        Engine(params, tcfg, **{**ENGINE, "kv_block": 0}, device="cpu")
