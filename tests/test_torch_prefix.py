"""The port's prefix cache on the CPU, against the JAX package.

One small Qwen2-style model (q/k/v biases, GQA 4/2, f32) is drawn by the
JAX package and handed to the port with ``from_jax_params``.  The same
traffic goes through a JAX ``oim_tpu`` engine and the port's engine with
the prefix cache on, on the dense layout and on the paged pool, fp and
int8 KV, and for an MoE model: greedy tokens are identical, logprobs
agree to 1e-4 (``tests/test_torch_serve.py``'s tolerance; both compute
in f32 and differ in summation order only), and the hit, miss and entry
counts are the reference's.  On the paged pool the port's own
bookkeeping is pinned as the reference's tests pin it: an entry's
blocks are shared once by concurrent readers and never written
(copy-on-write of the block a hit ends inside), a pool pinned by
entries is cleared rather than wedged, and a decode chunk leaves an
aliased block bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oim_tpu.models import TransformerConfig as JaxConfig
from oim_tpu.models import decode as jdecode
from oim_tpu.models import init_params as jax_init_params
from oim_tpu.serve import Engine as JaxEngine
from oim_tpu.serve import GenRequest as JaxRequest

from oim_tpu_torch.models.transformer import TransformerConfig
from oim_tpu_torch.models.weights import from_jax_params
from oim_tpu_torch.serve.engine import BlockAllocator, Engine, GenRequest
from torch_cpu_threads import one_torch_thread  # noqa: F401

CFG = dict(
    vocab_size=101, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=96, attn_bias=True, dtype="float32",
)
ENGINE = dict(n_slots=2, max_len=64, chunk=4, prompt_buckets=(8, 16, 32))
LAYOUTS = {"dense": dict(kv_block=0), "paged": dict(kv_block=8)}
LOGPROB_ATOL = 1e-4


def _port(jcfg_kw: dict, seed: int = 0):
    """(jax cfg, jax params, port cfg, port params) for ``jcfg_kw``,
    with random q/k/v biases when the config has them."""
    jcfg = JaxConfig(**jcfg_kw, use_pallas=False)
    jparams = dict(jax_init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.RandomState(seed)
    for name in ("bq", "bk", "bv"):
        if name in jparams:
            jparams[name] = jnp.asarray(
                rng.randn(*jparams[name].shape).astype(np.float32) * 0.1
            )
    tree = {name: np.asarray(value) for name, value in jparams.items()}
    tcfg = TransformerConfig(**jcfg_kw)
    return jcfg, jparams, tcfg, from_jax_params(tree, tcfg)


@pytest.fixture(scope="module")
def model():
    return _port(CFG)


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, CFG["vocab_size"],
                                               n).tolist()


def _oracle(model, tokens, n):
    """The reference's solo greedy continuation."""
    jcfg, jparams, _, _ = model
    out = jdecode.generate(jparams, jnp.asarray([tokens], jnp.int32), jcfg,
                           n)
    return np.asarray(out)[0, len(tokens):].tolist()


def _lru_traffic(engine, request_cls):
    """The reference's exact-and-LRU scenario (``tests/test_serve.py``):
    a cached 16-token system prompt, three prompts sharing it, the
    system prompt itself again, an unrelated prompt, then two more
    cached prompts past the cache's size.  Returns each phase's results
    (tokens, logprobs) and stats."""
    system = _prompt(71, 16)
    seen = []

    def serve(reqs):
        rids = [engine.submit(request_cls(**r)) for r in reqs]
        engine.run()
        results = [engine.result_full(rid) for rid in rids]
        stats = engine.stats()
        seen.append((results, {k: stats[k] for k in (
            "prefix_hits", "prefix_misses", "prefix_entries")}))

    serve([dict(tokens=system, max_new_tokens=4, cache_prefix=True)])
    serve([dict(tokens=system + _prompt(80 + i, 4 + i), max_new_tokens=6)
           for i in range(3)] + [dict(tokens=system, max_new_tokens=5)])
    serve([dict(tokens=_prompt(99, 20), max_new_tokens=3)])
    serve([dict(tokens=_prompt(s, 16), max_new_tokens=2, cache_prefix=True)
           for s in (101, 102)])
    return seen


def _assert_same(got, want):
    """Phase by phase: tokens identical, logprobs within LOGPROB_ATOL,
    stats equal."""
    assert len(got) == len(want)
    for (g_res, g_stats), (w_res, w_stats) in zip(got, want):
        assert [t for t, _ in g_res] == [t for t, _ in w_res]
        for (_, g_lp), (_, w_lp) in zip(g_res, w_res):
            np.testing.assert_allclose(g_lp, w_lp, atol=LOGPROB_ATOL,
                                       rtol=0)
        assert g_stats == w_stats


@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp", "kv8"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_prefix_cache_exact_and_lru(model, layout, kv_int8):
    """Hits reproduce the reference engine's tokens and counts, int8 KV
    included (the scales ride the entry), and the LRU evicts at the
    cache's size: three hits on the shared prompt plus the prompt
    itself, a miss, and two entries left after two more stores."""
    jcfg, jparams, tcfg, params = model
    kw = dict(**ENGINE, **LAYOUTS[layout], kv_int8=kv_int8,
              prefix_cache_size=2)
    got = _lru_traffic(Engine(params, tcfg, **kw, device="cpu"), GenRequest)
    want = _lru_traffic(JaxEngine(jparams, jcfg, **kw), JaxRequest)
    _assert_same(got, want)
    assert got[1][1]["prefix_hits"] == 4
    assert got[-1][1]["prefix_entries"] == 2
    for (tokens, _), n in zip(got[1][0], [6, 6, 6, 5]):
        assert len(tokens) == n


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_moe_prefix_cache_exact(layout):
    """Hits are exact for MoE too (``_moe_exact`` routes each token
    alone): a request sharing a cached system prompt emits the reference
    engine's tokens."""
    jcfg, jparams, tcfg, params = _port({**CFG, "n_experts": 2})
    system = _prompt(30, 16)
    tokens = system + _prompt(31, 5)
    outs = []
    for make, request_cls in (
            (lambda kw: Engine(params, tcfg, **kw, device="cpu"), GenRequest),
            (lambda kw: JaxEngine(jparams, jcfg, **kw), JaxRequest)):
        engine = make(dict(**ENGINE, **LAYOUTS[layout], prefix_cache_size=2))
        engine.submit(request_cls(tokens=system, max_new_tokens=1,
                                  cache_prefix=True))
        engine.run()
        rid = engine.submit(request_cls(tokens=tokens, max_new_tokens=6))
        engine.run()
        assert engine.stats()["prefix_hits"] == 1
        outs.append(engine.result(rid))
    assert outs[0] == outs[1]


def test_prefix_cache_off_by_default(model):
    """With no prefix cache, ``cache_prefix`` is ignored, as in the
    reference: the request is served and nothing is stored or counted."""
    _, _, tcfg, params = model
    engine = Engine(params, tcfg, **ENGINE, device="cpu")
    rid = engine.submit(GenRequest(tokens=[1, 2, 3], max_new_tokens=2,
                                   cache_prefix=True))
    engine.run()
    assert len(engine.result(rid)) == 2
    stats = engine.stats()
    assert (stats["prefix_entries"], stats["prefix_hits"],
            stats["prefix_misses"], stats["prefix_injects"]) == (0, 0, 0, 0)
    info = engine.info()["engine"]
    assert (info["prefix_cache_size"], info["prefill_chunk"]) == (0, 0)


def _paged(model, **kw):
    _, _, tcfg, params = model
    return Engine(params, tcfg, **{**ENGINE, "kv_block": 8,
                                   "prefix_cache_size": 2, **kw},
                  device="cpu")


def _blocks(engine, ids):
    """Copies of the pool's K and V at block ``ids``, every layer."""
    ids = list(ids)
    return engine._cache.k[:, ids].clone(), engine._cache.v[:, ids].clone()


def _entry(engine):
    (blocks, rows), = engine._prefix_cache.values()
    return blocks, rows


def test_prefix_blocks_shared_once_across_concurrent_readers(model):
    """Two requests admitted in one wave over one cached prefix hold its
    blocks once each (refs: entry + two slots), the shared-block gauge
    and bytes saved advance, their tokens are the reference's, and the
    shared blocks are bit-equal before and after; once the readers
    finish, the entry holds the last ref."""
    engine = _paged(model, n_slots=3)
    system = _prompt(30, 16)  # two full 8-token blocks
    engine.submit(GenRequest(tokens=system, max_new_tokens=2,
                             cache_prefix=True))
    engine.run()
    blocks, rows = _entry(engine)
    assert rows == 16 and len(blocks) == 2
    before = _blocks(engine, blocks)
    reqs = [system + _prompt(31 + i, 3) for i in range(2)]
    rids = [engine.submit(GenRequest(tokens=t, max_new_tokens=5))
            for t in reqs]
    engine.step()  # one wave admits both
    assert [int(engine._alloc._refs[b]) for b in blocks] == [3, 3]
    stats = engine.stats()
    assert stats["kv_blocks_shared"] == 2
    assert stats["prefix_bytes_saved"] == 2 * 2 * 8 * engine._kv_row_bytes
    engine.run()
    for rid, tokens in zip(rids, reqs):
        assert engine.result(rid) == _oracle(model, tokens, 5)
    after = _blocks(engine, blocks)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert [int(engine._alloc._refs[b]) for b in blocks] == [1, 1]
    assert engine.stats()["kv_blocks_used"] == 2


@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp", "kv8"])
def test_cow_divergence_never_mutates_shared_block(model, kv_int8):
    """Resubmitting the cached prompt makes the usable prefix end
    mid-block (15 of 16 rows): the tail prefill writes into the entry's
    last block, so admission copies it first.  The entry's blocks (and
    scales) stay bit-equal and the tokens are the reference engine's."""
    jcfg, jparams, _, _ = model
    engine = _paged(model, kv_int8=kv_int8)
    ref = JaxEngine(jparams, jcfg, **ENGINE, kv_block=8, kv_int8=kv_int8,
                    prefix_cache_size=2)
    system = _prompt(33, 16)
    outs = []
    for eng, request_cls in ((engine, GenRequest), (ref, JaxRequest)):
        eng.submit(request_cls(tokens=system, max_new_tokens=2,
                               cache_prefix=True))
        eng.run()
        if eng is engine:
            blocks, _ = _entry(engine)
            before = _blocks(engine, blocks)
            scales = engine._cache.k_scale
            scales_before = None if scales is None else scales.clone()
        rid = eng.submit(request_cls(tokens=system, max_new_tokens=4))
        eng.run()
        outs.append(eng.result(rid))
        assert eng.stats()["prefix_hits"] == 1
    assert outs[0] == outs[1]
    after = _blocks(engine, blocks)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    if scales is not None:
        assert torch.equal(scales[:, list(blocks)],
                           scales_before[:, list(blocks)])


def test_mutually_aliased_entries_cleared_not_deadlocked(model):
    """Two entries over the same block set leave every block at ref 2,
    so evicting either alone frees nothing: an unrelated request that
    fits the pool but not what they pin must still be admitted on an
    idle engine (the whole cache is cleared), not wedge the queue."""
    engine = _paged(model, prompt_buckets=(16, 32, 48), kv_block=16,
                    kv_blocks=4)
    base = _prompt(130, 32)  # two full blocks
    for tokens in (base, base + _prompt(131, 7)):
        engine.submit(GenRequest(tokens=tokens, max_new_tokens=2,
                                 cache_prefix=True))
        engine.run()
    sets = [tuple(b) for b, _ in engine._prefix_cache.values()]
    assert len(sets) == 2 and sets[0] == sets[1]
    assert engine.stats()["kv_blocks_shared"] == 2
    rid = engine.submit(GenRequest(tokens=_prompt(132, 20),
                                   max_new_tokens=25))
    for _ in range(100):  # bounded: a wedged queue would spin forever
        if not engine.pending():
            break
        engine.step()
    assert not engine.pending(), "queue wedged on mutually aliased entries"
    assert len(engine.result(rid)) == 25
    stats = engine.stats()
    assert (stats["prefix_entries"], stats["kv_blocks_used"]) == (0, 0)
    assert stats["prefix_evictions"] == 2


def test_matched_entry_pinning_pool_is_evicted_not_deadlocked(model):
    """An entry pins 3 of 4 blocks; a request sharing it needs 2 fresh
    blocks against 1 free on an idle engine: the planner gives up the
    matched entry and plans prefix-free."""
    engine = _paged(model, max_len=256, prompt_buckets=(64, 128, 255),
                    kv_block=64, kv_blocks=4)
    system = _prompt(120, 200)  # three full blocks
    engine.submit(GenRequest(tokens=system, max_new_tokens=2,
                             cache_prefix=True))
    engine.run()
    assert engine.stats()["kv_blocks_used"] == 3
    rid = engine.submit(GenRequest(tokens=system[:128] + [5],
                                   max_new_tokens=100))
    for _ in range(200):
        if not engine.pending():
            break
        engine.step()
    assert not engine.pending(), "queue wedged on the pinned entry"
    assert len(engine.result(rid)) == 100
    stats = engine.stats()
    assert stats["prefix_entries"] == 0 and stats["kv_blocks_used"] == 0


def test_transient_shortage_keeps_unreclaimable_entries(model):
    """With a slot running on the entry's blocks, a shortage eviction
    cannot cover defers the head of the queue without flushing the
    cache; the request is admitted once the runner frees its blocks."""
    engine = _paged(model, n_slots=3, prompt_buckets=(16, 32, 48),
                    kv_block=16, kv_blocks=4)
    system = _prompt(140, 32)
    engine.submit(GenRequest(tokens=system, max_new_tokens=2,
                             cache_prefix=True))
    engine.run()
    long_rid = engine.submit(GenRequest(tokens=system + [3],
                                        max_new_tokens=12))
    engine.step()
    short_rid = engine.submit(GenRequest(tokens=_prompt(141, 16),
                                         max_new_tokens=12))
    engine.step()
    stats = engine.stats()
    assert stats["kv_admit_deferrals"] >= 1
    assert stats["prefix_entries"] == 1, "a transient shortage flushed"
    engine.run()
    assert len(engine.result(long_rid)) == 12
    assert engine.result(short_rid) == _oracle(model, _prompt(141, 16), 12)


@pytest.mark.parametrize("depth", [1, 2])
def test_decode_chunks_leave_an_aliased_block_bit_equal(model, depth):
    """A slot decoding over an aliased prefix block, a free slot, and
    chunks that run while the entry is shared: every block the entry
    holds is bit-equal after each step."""
    engine = _paged(model, pipeline_depth=depth)
    system = _prompt(35, 24)  # three full blocks
    engine.submit(GenRequest(tokens=system, max_new_tokens=2,
                             cache_prefix=True))
    engine.run()
    blocks, _ = _entry(engine)
    before = _blocks(engine, blocks)
    rid = engine.submit(GenRequest(tokens=system + _prompt(36, 2),
                                   max_new_tokens=13))
    while engine.pending():
        engine.step()
        after = _blocks(engine, blocks)
        assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert engine.result(rid) == _oracle(model, system + _prompt(36, 2), 13)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_idle_row_writes_no_kv(model, layout):
    """A decode chunk's row with no request writes nothing: a slot that
    sits idle while another decodes keeps every row of its region (on
    the dense layout, the rows a decode pass would write at position 0
    of the idle slot's own region)."""
    _, _, tcfg, params = model
    engine = Engine(params, tcfg, **ENGINE, **LAYOUTS[layout],
                    device="cpu")
    cache = engine._cache
    for t in (cache.k, cache.v):
        t.fill_(7.0)
    before = (cache.k.clone(), cache.v.clone())
    rid = engine.submit(GenRequest(tokens=_prompt(37, 5), max_new_tokens=9))
    engine.run()
    assert engine.result(rid) == _oracle(model, _prompt(37, 5), 9)
    if layout == "dense":
        idle = (cache.k[:, 1], cache.v[:, 1])  # slot 0 served, slot 1 idle
        assert torch.equal(idle[0], before[0][:, 1])
        assert torch.equal(idle[1], before[1][:, 1])
    else:  # every block the request never held
        held = set(range(engine._pool_blocks_needed(5, 9)))
        free = [b for b in range(engine.kv_blocks) if b not in held]
        assert torch.equal(cache.k[:, free], before[0][:, free])


def test_block_allocator_refs():
    alloc = BlockAllocator(4)
    a = alloc.alloc(2)
    alloc.incref(a[:1])
    assert alloc.shared_blocks == 1 and alloc.exclusive(a) == 1
    assert alloc.decref(a) == 1 and alloc.free_blocks == 3
    assert alloc.decref(a[:1]) == 1 and alloc.free_blocks == 4
    with pytest.raises(ValueError, match="incref of free block"):
        alloc.incref(a[:1])
