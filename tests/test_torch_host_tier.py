"""The port's host-RAM KV tier on the CPU, against the JAX package.

The small Qwen2-style model of ``tests/test_torch_prefix.py`` is drawn
by the JAX package and handed to the port, and the reference's pressure
geometry (``tests/test_serve_overflow.py``: a 10-block pool of 8-token
blocks, worst cases of 5 blocks) drives both engines:

- **demote then promote**: a stored entry retired under pressure moves
  to the host tier, and a later hit promotes it back; the hit's tokens
  equal the recompute's and the JAX engine's (fp and int8), a sampled
  hit's the port's recompute, and a packed-int4 pool's bytes come back
  bit-equal;
- **park then restore**: an admission that cannot fit parks the coldest
  slot, whose stream, restored, equals its never-parked run (greedy and
  sampled with penalties, at depth 1 and 2, and prompt lookup's history)
  and, greedy, the JAX engine's;
- **cleanup**: a parked request cancelled, reaped, aborted, or cancelled
  inside its restore's window leaks no block in either tier;
- **degrade and refusals**: no tier evicts, a full host budget evicts
  host-LRU, a pinned host entry is never evicted for nothing, a promote
  that cannot reserve device blocks recomputes, bad budgets are refused,
  a draft engine does not park, and ``serve_main``'s flags build what
  they name.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oim_tpu.models import TransformerConfig as JaxConfig
from oim_tpu.models import init_params as jax_init_params
from oim_tpu.serve import Engine as JaxEngine
from oim_tpu.serve import GenRequest as JaxRequest

from oim_tpu_torch.cli import serve_main
from oim_tpu_torch.models.transformer import TransformerConfig, init_params
from oim_tpu_torch.models.weights import from_jax_params
from oim_tpu_torch.serve.engine import Engine, GenRequest, RequestFailedError
from torch_cpu_threads import one_torch_thread  # noqa: F401

CFG = dict(
    vocab_size=101, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=96, attn_bias=True, dtype="float32",
)
HOST_BYTES = 1 << 20
BASE = dict(n_slots=4, max_len=64, chunk=4, prompt_buckets=(16, 32),
            kv_block=8, kv_blocks=10, prefix_cache_size=2)
PARK = dict(BASE, kv_blocks=8, prefix_cache_size=0)


@pytest.fixture(scope="module")
def model():
    jcfg = JaxConfig(**CFG, use_pallas=False)
    jparams = dict(jax_init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.RandomState(0)
    for name in ("bq", "bk", "bv"):
        jparams[name] = jnp.asarray(
            rng.randn(*jparams[name].shape).astype(np.float32) * 0.1)
    tree = {name: np.asarray(value) for name, value in jparams.items()}
    tcfg = TransformerConfig(**CFG)
    return jcfg, jparams, tcfg, from_jax_params(tree, tcfg)


_ENGINES: dict = {}


def _engine(model, package: str = "port", **kw):
    """One engine per (package, config), with the host tier unless the
    config says otherwise, shared by the module."""
    key = (package, tuple(sorted(kw.items())))
    if key not in _ENGINES:
        jcfg, jparams, tcfg, params = model
        args = {**BASE, "kv_host_bytes": HOST_BYTES, **kw}
        _ENGINES[key] = (JaxEngine(jparams, jcfg, **args) if package == "jax"
                         else Engine(params, tcfg, **args, device="cpu"))
    return _ENGINES[key]


def _request(e):
    return JaxRequest if isinstance(e, JaxEngine) else GenRequest


def _prompt(seed: int, n: int) -> list[int]:
    return np.random.RandomState(seed).randint(0, CFG["vocab_size"],
                                               n).tolist()


def _gen(e, tokens, mn=4, **kw) -> list[int]:
    rid = e.submit(_request(e)(tokens=tokens, max_new_tokens=mn, **kw))
    e.run()
    return list(e.result(rid, timeout=0))


def _flush_tiers(e) -> None:
    """Drop every prefix entry of both tiers, counter-silent, so the next
    run of a request recomputes (the oracle reset)."""
    e._warming = True
    try:
        with e._lock:
            e._clear_prefix_cache_locked()
            e._flush_host_tier_locked()
    finally:
        e._warming = False


def _store_entry(e, tokens) -> None:
    _gen(e, tokens, mn=2, cache_prefix=True)


def _pressure(e) -> None:
    """Three concurrent 5-block worst cases against the 10-block pool:
    the resident entry's blocks are the shortfall, so it is retired."""
    rids = [e.submit(_request(e)(tokens=_prompt(100 + i, 16),
                                 max_new_tokens=24)) for i in range(3)]
    e.run()
    for rid in rids:
        e.result(rid, timeout=0)


def _no_leaks(e) -> None:
    """Device blocks are the resident entries' only; host blocks the
    demoted entries' only."""
    s = e.stats()
    assert s["active_slots"] == 0 and s["queued"] == 0
    assert s["parked_slots"] == 0
    with e._lock:
        entry_blocks = {b for blocks, _ in e._prefix_cache.values()
                        for b in blocks}
        assert e._alloc.used_blocks == len(entry_blocks)
        if e._host is not None:
            host_blocks = {b for blocks, _ in e._host_prefix.values()
                           for b in blocks}
            assert e._host.alloc.used_blocks == len(host_blocks)


def _cycle(e, hit, **gkw):
    """Seed an entry, demote it under pressure, serve ``hit`` (which
    promotes and hits): (tokens, the recompute's tokens, counts)."""
    _flush_tiers(e)
    oracle = _gen(e, hit, **gkw)
    _flush_tiers(e)
    _store_entry(e, _prompt(1, 16))
    d0 = e.stats()["prefix_demotions"]
    _pressure(e)
    s = e.stats()
    assert s["prefix_demotions"] > d0, "pressure did not demote"
    assert s["host_prefix_entries"] >= 1
    p0, h0 = s["kv_promotions"], s["prefix_hits"]
    out = _gen(e, hit, **gkw)
    s = e.stats()
    assert s["kv_promotions"] > p0, "the hit did not promote"
    assert s["prefix_hits"] > h0, "the promoted entry did not hit"
    return out, oracle, (s["kv_promotions"] - p0, s["prefix_hits"] - h0)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp", "kv8"])
def test_demote_then_promote(model, kv_int8, depth):
    """A promoted hit (block-aligned and copy-on-write extensions) emits
    the recompute's tokens and the JAX engine's, with the same promotion
    and hit counts; a sampled one the port's recompute."""
    port = _engine(model, kv_int8=kv_int8)
    ref = _engine(model, "jax", kv_int8=kv_int8)
    for tail in (_prompt(2, 8), _prompt(4, 3)):
        hit = _prompt(1, 16) + tail
        got = []
        for e in (port, ref):
            e.set_pipeline_depth(depth)
            out, oracle, counts = _cycle(e, hit)
            assert out == oracle
            got.append((out, counts))
        assert got[0] == got[1]
    out, oracle, _ = _cycle(port, _prompt(1, 16) + _prompt(3, 8),
                            temperature=0.8, seed=11)
    assert out == oracle
    for e in (port, ref):
        _no_leaks(e)


def test_int4_pool_round_trips_bit_equal(model):
    """A packed-int4 entry's payload and scale bytes go to the host and
    back unchanged, and its hit emits the recompute's tokens."""
    e = _engine(model, kv_int4=True)
    hit = _prompt(1, 16) + _prompt(2, 8)
    _flush_tiers(e)
    oracle = _gen(e, hit)
    _flush_tiers(e)
    base = _prompt(1, 16)
    _store_entry(e, base)
    (blocks, _), = e._prefix_cache.values()
    ids = torch.as_tensor(blocks)
    before = [pool[:, ids].clone() for _, pool in e._cache.leaves()]
    assert before[0].dtype == torch.uint8 and len(before) == 4
    _pressure(e)
    (host_blocks, _), = e._host_prefix.values()
    hids = torch.as_tensor(host_blocks)
    for (_, pool), want in zip(e._host.pools(), before):
        assert torch.equal(pool[:, hids], want)
    assert _gen(e, hit) == oracle
    (blocks, _), = [v for k, v in e._prefix_cache.items() if k == tuple(base)]
    ids = torch.as_tensor(blocks)
    for (_, pool), want in zip(e._cache.leaves(), before):
        assert torch.equal(pool[:, ids], want)
    _flush_tiers(e)
    _no_leaks(e)


def _parked_run(e, prompts, mn, **gkw):
    """The prompts admitted together, so the later parks the earlier."""
    rids = [e.submit(_request(e)(tokens=p, max_new_tokens=mn, seed=7 + i,
                                 **gkw)) for i, p in enumerate(prompts)]
    e.run()
    return [list(e.result(rid, timeout=0)) for rid in rids]


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "temp"])
def test_park_then_restore(model, depth, sampled):
    """Two 6-block worst cases cannot share the 8-block pool: the second
    admission parks the first, whose restored stream is its solo run —
    sampled ones too, penalties and all (the occurrence rows rebuilt
    from host truth); greedy ones are also the JAX engine's."""
    e = _engine(model, **PARK)
    e.set_pipeline_depth(depth)
    gkw = (dict(temperature=0.8, repetition_penalty=1.3,
                frequency_penalty=0.4) if sampled else {})
    prompts = [_prompt(20, 16), _prompt(21, 16)]
    solo = [_gen(e, p, mn=30, seed=7 + i, **gkw)
            for i, p in enumerate(prompts)]
    p0 = e.stats()["kv_parks"]
    got = _parked_run(e, prompts, 30, **gkw)
    s = e.stats()
    assert s["kv_parks"] > p0 and s["kv_unparks"] == s["kv_parks"]
    assert got == solo
    if not sampled:
        ref = _engine(model, "jax", **PARK)
        ref.set_pipeline_depth(depth)
        assert _parked_run(ref, prompts, 30) == got
    _no_leaks(e)


def test_park_restores_prompt_lookup_history(model):
    """A speculative engine's parked slot gets its token history row back
    from host truth: the restored stream is its solo run."""
    e = _engine(model, **PARK, spec_decode=2)
    prompts = [_prompt(22, 16), _prompt(23, 16)]
    solo = [_gen(e, p, mn=26, seed=7 + i) for i, p in enumerate(prompts)]
    assert _parked_run(e, prompts, 26) == solo
    assert e.stats()["kv_parks"] > 0
    _no_leaks(e)


def _park_one(e, seeds):
    """Submit two requests and step until the first is parked."""
    ra, rb = (e.submit(GenRequest(tokens=_prompt(s, 16), max_new_tokens=30))
              for s in seeds)
    for _ in range(8):
        e.step()
        if e.stats()["parked_slots"]:
            break
    assert e.stats()["parked_slots"] == 1
    return ra, rb


def test_parked_requests_leak_nothing(model):
    """Cancel, deadline reap, abort with the copy down still in flight,
    and a cancel inside the restore's lock-free window: each fails the
    parked request and returns its blocks in both tiers."""
    e = _engine(model, **PARK)
    e.set_pipeline_depth(2)
    # Cancel while parked.
    ra, rb = _park_one(e, (26, 27))
    assert e.cancel(ra)
    e.run()
    with pytest.raises(RequestFailedError) as err:
        e.result_full(ra, timeout=0)
    assert err.value.kind == "cancelled"
    assert len(e.result(rb, timeout=0)) == 30
    _no_leaks(e)
    # A deadline that passes while parked: the request's own deadline,
    # moved to now once it is parked (no race with the host's load).
    req_a = GenRequest(tokens=_prompt(24, 16), max_new_tokens=30,
                       deadline=time.monotonic() + 3600)
    ra = e.submit(req_a)
    rb = e.submit(GenRequest(tokens=_prompt(25, 16), max_new_tokens=30))
    for _ in range(8):
        e.step()
        if e.stats()["parked_slots"]:
            break
    assert ra in e._parked
    req_a.deadline = time.monotonic()
    e.run()
    with pytest.raises(RequestFailedError, match="parked"):
        e.result_full(ra, timeout=0)
    assert len(e.result(rb, timeout=0)) == 30
    _no_leaks(e)
    # Abort with the park's copy down not yet landed.
    ra, rb = (e.submit(GenRequest(tokens=_prompt(s, 16), max_new_tokens=30))
              for s in (28, 29))
    for _ in range(8):
        e.step()
        if e._pending_host_writes:
            break
    assert e._pending_host_writes and e.stats()["parked_slots"] == 1
    e.abort("test abort")
    for rid in (ra, rb):
        with pytest.raises(RequestFailedError):
            e.result_full(rid, timeout=0)
    assert e._fatal is None
    e.run()  # lands the orphaned copy, whose blocks go home
    _no_leaks(e)
    # A cancel inside the restore's window: the record stays visible.
    ra = e.submit(GenRequest(tokens=_prompt(33, 16), max_new_tokens=30))
    rb = e.submit(GenRequest(tokens=_prompt(34, 16), max_new_tokens=30))
    orig, cancelled = e._write_host_payload, []

    def mid_restore(host_blocks, dev_blocks):
        if not cancelled:
            cancelled.append(e.cancel(ra))
        orig(host_blocks, dev_blocks)

    e._write_host_payload = mid_restore
    try:
        e.run()
    finally:
        del e._write_host_payload
    assert cancelled == [True]
    with pytest.raises(RequestFailedError):
        e.result_full(ra, timeout=0)
    assert len(e.result(rb, timeout=0)) == 30
    _no_leaks(e)


def test_no_tier_still_evicts(model):
    _, _, tcfg, params = model
    e = Engine(params, tcfg, **BASE, device="cpu")
    _store_entry(e, _prompt(1, 16))
    ev0 = e.stats()["prefix_evictions"]
    _pressure(e)
    s = e.stats()
    assert s["prefix_evictions"] > ev0 and s["prefix_demotions"] == 0
    assert s["kv_host_blocks_total"] == 0 and not s["kv_park"]


def test_host_budget_exhausted_evicts_lru(model):
    """A two-block budget holds one demoted entry: the next demotion
    evicts it host-LRU (counted as an eviction), never leaks or
    wedges."""
    _, _, tcfg, params = model
    row_bytes = _engine(model)._kv_row_bytes
    e = Engine(params, tcfg, **BASE, kv_host_bytes=2 * 8 * row_bytes,
               device="cpu")
    assert e.stats()["kv_host_blocks_total"] == 2
    _store_entry(e, _prompt(1, 16))
    _pressure(e)
    assert e.stats()["host_prefix_entries"] == 1
    _store_entry(e, _prompt(40, 16))
    ev0 = e.stats()["prefix_evictions"]
    _pressure(e)
    s = e.stats()
    assert s["host_prefix_entries"] == 1 and s["prefix_evictions"] > ev0
    _no_leaks(e)


def test_host_evict_skips_pinned_entries(model):
    """An entry pinned by a promotion's copy frees nothing: the host
    evictor neither counts nor drops it until the pin goes."""
    e = _engine(model)
    _flush_tiers(e)
    _store_entry(e, _prompt(1, 16))
    _pressure(e)
    with e._lock:
        key, (blocks, _) = next(iter(e._host_prefix.items()))
        e._host.alloc.incref(blocks)
        free0, ev0 = e._host.alloc.free_blocks, e.prefix_evictions
        e._evict_host_for_locked(free0 + 1)
        assert key in e._host_prefix and e.prefix_evictions == ev0
        assert e._host.alloc.free_blocks == free0
        e._host.alloc.decref(blocks)
        e._evict_host_for_locked(free0 + 1)
        assert key not in e._host_prefix
        assert e.prefix_evictions == ev0 + 1
    _flush_tiers(e)
    _no_leaks(e)


def test_promote_capacity_shortfall_recomputes(model):
    """A promotion that cannot reserve device blocks is not staged: the
    hit recomputes, token for token, and the entry stays in the host
    tier."""
    e = _engine(model)
    _flush_tiers(e)
    base = _prompt(1, 16)
    hit = base + _prompt(8, 8)
    oracle = _gen(e, hit)
    _flush_tiers(e)
    _store_entry(e, base)
    _pressure(e)
    assert e.stats()["host_prefix_entries"] >= 1
    with e._lock:
        pinned = e._alloc.alloc(e._alloc.free_blocks - 1)
    p0 = e.stats()["kv_promotions"]
    try:
        rid = e.submit(GenRequest(tokens=hit, max_new_tokens=4))
        assert not e._prefix_installs
    finally:
        with e._lock:
            e._alloc.decref(pinned)
    e.run()
    assert e.result(rid, timeout=0) == oracle
    s = e.stats()
    assert s["kv_promotions"] == p0 and s["host_prefix_entries"] >= 1
    _flush_tiers(e)
    _no_leaks(e)


def test_refusals_and_surfaces(model):
    """The reference's constructor refusals, message for message; a
    draft-model engine demotes but does not park; the tier's keys in
    ``stats()`` and ``info()``."""
    _, _, tcfg, params = model
    with pytest.raises(ValueError, match="paged cache"):
        Engine(params, tcfg, n_slots=2, max_len=64, kv_host_bytes=HOST_BYTES,
               device="cpu")
    with pytest.raises(ValueError, match="holds no block"):
        Engine(params, tcfg, **BASE, kv_host_bytes=8, device="cpu")
    with pytest.raises(ValueError, match=">= 0"):
        Engine(params, tcfg, **BASE, kv_host_bytes=-1, device="cpu")
    dcfg = TransformerConfig(**{**CFG, "n_layers": 1})
    draft = Engine(params, tcfg, **BASE, kv_host_bytes=HOST_BYTES,
                   spec_decode=2, draft_params=init_params(1, dcfg),
                   draft_cfg=dcfg, device="cpu")
    assert not draft.kv_park and draft._host is not None
    e = _engine(model)
    s, info = e.stats(), e.info()["engine"]
    for key in ("kv_demotions", "kv_promotions", "kv_demote_bytes",
                "kv_promote_bytes", "kv_demote_seconds",
                "kv_promote_seconds", "kv_parks", "kv_unparks",
                "parked_slots", "kv_holds", "kv_exports", "kv_imports",
                "kv_imports_staged", "kv_ship_bytes", "prefix_demotions",
                "prefix_exports", "prefix_fetch_installs",
                "prefix_installs_staged", "prefix_digests", "slot_exports",
                "slot_imports", "migrated_slots", "kv_park",
                "kv_host_blocks_total", "kv_host_blocks_free",
                "kv_host_blocks_used", "kv_host_bytes"):
        assert key in s, key
    assert info["kv_host_bytes"] == HOST_BYTES and info["kv_park"] is True
    assert info["kv_host_blocks"] == s["kv_host_blocks_total"]


_SERVE = ["--device", "cpu", "--vocab-size", "101", "--d-model", "64",
          "--n-layers", "2", "--n-heads", "4", "--n-kv-heads", "2",
          "--d-ff", "96", "--dtype", "float32", "--max-len", "64",
          "--n-slots", "2"]


def test_serve_main_flags():
    """``--kv-host-bytes`` and ``--no-kv-park`` build the engine they name,
    and the tier without ``--kv-block`` is refused as the reference
    refuses it."""
    parse = serve_main.build_parser().parse_args
    e = serve_main.make_engine(parse(_SERVE + [
        "--kv-block", "8", "--kv-host-bytes", str(HOST_BYTES)]))
    assert e.kv_host_bytes == HOST_BYTES and e.kv_park
    assert e.stats()["kv_host_blocks_total"] > 0
    e = serve_main.make_engine(parse(_SERVE + [
        "--kv-block", "8", "--kv-host-bytes", str(HOST_BYTES),
        "--no-kv-park"]))
    assert e.kv_host_bytes == HOST_BYTES and not e.kv_park
    with pytest.raises(ValueError, match="paged cache"):
        serve_main.make_engine(parse(_SERVE + [
            "--kv-host-bytes", str(HOST_BYTES)]))
