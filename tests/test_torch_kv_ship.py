"""KV shipping between the JAX engine and the port's, on the CPU.

The small Qwen2-style model of ``tests/test_torch_prefix.py`` (q/k/v
biases, GQA 4/2, f32) is drawn by the JAX package and handed to the port
with ``from_jax_params``, so both engines compute the same function on
the paged pool.  Held KV, a prefix entry and a live slot ship in each
direction through real transfer bytes — one package's ``pack_transfer``,
the other's ``unpack_transfer``:

- held KV (fp and int8): the continuation on the importer is the
  exporter's unbroken run, greedy tokens identical and logprobs within
  1e-4; the port's manifest equals the reference's key for key (leaf
  bytes aside, which agree within 1e-5);
- a prefix entry: once installed, a hit admits with no recompute of the
  shared rows (the importer's hit and bytes-saved counters);
- a live slot suspended by ``begin_migrate_out`` at pipeline depth 1 and
  2: prefix plus continuation equals the unbroken greedy stream, and
  within the port a sampled one too (``sample_base``);
- the guards: a geometry mismatch and an unknown dtype name refuse, a
  capacity shortfall refuses whole, dense and packed-int4 engines are
  ineligible, an expired import recomputes, and the hold TTL and cap
  return their blocks.

Engines are shared per package and quant for the module, their pipeline
depth switched on the warm engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oim_tpu.models import TransformerConfig as JaxConfig
from oim_tpu.models import init_params as jax_init_params
from oim_tpu.serve import Engine as JaxEngine
from oim_tpu.serve import GenRequest as JaxRequest
from oim_tpu.serve import disagg as jdisagg
from oim_tpu.serve.engine import RequestFailedError as JaxFailed

from oim_tpu_torch.models.transformer import TransformerConfig
from oim_tpu_torch.models.weights import from_jax_params
from oim_tpu_torch.serve import disagg
from oim_tpu_torch.serve import engine as tengine
from oim_tpu_torch.serve.engine import Engine, GenRequest, RequestFailedError
from torch_cpu_threads import one_torch_thread  # noqa: F401

CFG = dict(
    vocab_size=101, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=96, attn_bias=True, dtype="float32",
)
ENGINE = dict(n_slots=2, max_len=64, chunk=4, prompt_buckets=(8, 16, 32),
              kv_block=8, prefix_cache_size=2)
LOGPROB_ATOL = 1e-4
LEAF_ATOL = 1e-5


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


class _Side:
    """One package's engine with what the tests need of its package."""

    def __init__(self, name, engine, request, wire, failed):
        self.name, self.engine, self.request = name, engine, request
        self.wire, self.failed = wire, failed


_SIDES: dict = {}


def _side(model, name: str, kv_int8: bool = False) -> _Side:
    key = (name, kv_int8)
    if key not in _SIDES:
        jcfg, jparams, tcfg, params = model
        kw = dict(ENGINE, kv_int8=kv_int8)
        if name == "jax":
            _SIDES[key] = _Side(name, JaxEngine(jparams, jcfg, **kw),
                                JaxRequest, jdisagg, JaxFailed)
        else:
            _SIDES[key] = _Side(name, Engine(params, tcfg, **kw,
                                             device="cpu"),
                                GenRequest, disagg, RequestFailedError)
    return _SIDES[key]


def _pair(model, direction: str, kv_int8: bool = False):
    src, dst = direction.split("_to_")
    return _side(model, src, kv_int8), _side(model, dst, kv_int8)


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, CFG["vocab_size"],
                                               n).tolist()


def _run(side: _Side, **req):
    rid = side.engine.submit(side.request(**req))
    side.engine.run()
    tokens, lps = side.engine.result_full(rid, timeout=0)
    return rid, list(tokens), list(lps)


def _ship(src: _Side, dst: _Side, manifest, arrays):
    """Pack with the exporter's package, unpack with the importer's."""
    return dst.wire.unpack_transfer(src.wire.pack_transfer(manifest, arrays))


def _leaves(manifest, arrays) -> dict:
    return {leaf["name"]: np.asarray(a, np.float64)
            for leaf, a in zip(manifest["leaves"], arrays)}


def _no_leaks(*sides: _Side) -> None:
    for side in sides:
        s = side.engine.stats()
        assert s["kv_blocks_used"] == sum(
            len(b) for b, _ in side.engine._prefix_cache.values()), side.name
        assert s["kv_holds"] == 0 and s["kv_imports_staged"] == 0
        assert s["migrated_slots"] == 0


def _clear_prefix(*sides: _Side) -> None:
    for side in sides:
        with side.engine._lock:
            side.engine._clear_prefix_cache_locked()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp", "kv8"])
def test_held_kv_ships_both_ways(model, direction, kv_int8):
    """Hold, export, pack, unpack, import, continue: the importer's
    continuation is the exporter's unbroken run.  Both packages hold the
    same request, and the port's manifest is the reference's."""
    src, dst = _pair(model, direction, kv_int8)
    prompt = _prompt(1 + kv_int8, 20)
    _, want, want_lps = _run(src, tokens=prompt, max_new_tokens=12)
    held = {}
    for side in (src, dst):
        rid, first, _ = _run(side, tokens=prompt, max_new_tokens=3,
                             hold_kv=True)
        assert side.engine.stats()["kv_holds"] == 1
        held[side.name] = (rid, first, *side.engine.export_kv(rid))
        assert side.engine.release_kv_hold(rid)
    (_, _, jman, jarr), (_, _, tman, tarr) = held["jax"], held["port"]
    assert tman == jman  # key for key: geometry, rows, tokens, leaves
    assert [leaf["name"] for leaf in tman["leaves"]] == (
        ["k", "v", "k_scale", "v_scale"] if kv_int8 else ["k", "v"])
    jl, tl = _leaves(jman, jarr), _leaves(tman, tarr)
    for name in jl:
        np.testing.assert_allclose(tl[name], jl[name], atol=LEAF_ATOL, rtol=0)
    rid, first, manifest, arrays = held[src.name]
    assert first == want[:3]
    # The hold was released above; the export's payload ships anyway.
    import_id, rows = dst.engine.import_kv(*_ship(src, dst, manifest,
                                                  arrays))
    assert rows == len(prompt) + len(first) - 1
    _, cont, cont_lps = _run(dst, tokens=prompt + first, max_new_tokens=9,
                             kv_import=import_id)
    assert first + cont == want
    np.testing.assert_allclose(cont_lps, want_lps[3:], atol=LOGPROB_ATOL,
                               rtol=0)
    assert dst.engine.stats()["kv_imports"] >= 1
    _no_leaks(src, dst)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_prefix_entry_ships_both_ways(model, direction):
    """A stored system prompt ships as a prefix entry: the importer
    installs it, and a prompt sharing it hits — its shared rows aliased,
    not recomputed — with the exporter's tokens."""
    src, dst = _pair(model, direction)
    _clear_prefix(src, dst)
    system = _prompt(7, 16)
    _run(src, tokens=system, max_new_tokens=2, cache_prefix=True)
    (entry,) = src.engine.prefix_digest_summary()
    assert entry["digest"] == disagg.prefix_digest(system)
    manifest, arrays = src.engine.export_kv_prefix(entry["digest"])
    assert manifest["prefix"] == entry["digest"] and manifest["rows"] == 16
    digest, rows = dst.engine.import_kv_prefix(*_ship(src, dst, manifest,
                                                      arrays))
    assert (digest, rows) == (entry["digest"], 16)
    before = dst.engine.stats()
    hit = system + _prompt(8, 5)
    _, want, want_lps = _run(src, tokens=hit, max_new_tokens=6)
    _, got, got_lps = _run(dst, tokens=hit, max_new_tokens=6)
    after = dst.engine.stats()
    assert got == want
    np.testing.assert_allclose(got_lps, want_lps, atol=LOGPROB_ATOL, rtol=0)
    assert after["prefix_fetch_installs"] == before["prefix_fetch_installs"] + 1
    assert after["prefix_hits"] == before["prefix_hits"] + 1
    assert after["prefix_misses"] == before["prefix_misses"]
    row_bytes = dst.engine._kv_row_bytes
    assert (after["prefix_bytes_saved"] - before["prefix_bytes_saved"]
            == 16 * row_bytes)
    assert after["prefix_digests"][0]["origin"] == "fetched"
    _clear_prefix(src, dst)
    _no_leaks(src, dst)


def _suspend(side: _Side, prompt, max_new, **kw):
    """Submit, decode past the first token, then migrate out: returns the
    request's record, exported, and the engine undrained again."""
    e = side.engine
    rid = e.submit(side.request(tokens=prompt, max_new_tokens=max_new, **kw))
    base = e.stats()["tokens_generated"]
    for _ in range(40):
        e.step()
        if e.stats()["tokens_generated"] - base >= 5:
            break
    e.begin_migrate_out()
    e.run()
    with pytest.raises(side.failed) as err:
        e.result(rid, timeout=0)
    assert err.value.kind == "migrated"
    manifest, arrays = e.export_slot(rid)
    assert e.release_migrated(rid)
    e._draining = e._migrate_out = False
    return manifest, arrays


def _migrate(src: _Side, dst: _Side, prompt, max_new, **kw):
    """The stream suspended on ``src`` and continued on ``dst``."""
    manifest, arrays = _suspend(src, prompt, max_new, **kw)
    prior = manifest["tokens"]
    assert 0 < len(prior) < max_new, "suspension must land mid-stream"
    assert manifest["rows"] == len(prompt) + len(prior) - 1
    assert manifest["slot"]["sample_base"] == len(prior)
    import_id, rows, slot = dst.engine.import_slot(*_ship(src, dst,
                                                          manifest, arrays))
    assert rows == manifest["rows"] and slot == manifest["slot"]
    _, cont, _ = _run(dst, tokens=prompt + prior,
                      max_new_tokens=max_new - len(prior),
                      kv_import=import_id,
                      sample_base=slot["sample_base"], **kw)
    return prior + cont


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_live_slot_migrates_both_ways(model, direction, depth):
    """A live greedy slot suspended on one engine resumes on the other:
    its prefix and continuation are the unbroken stream."""
    src, dst = _pair(model, direction)
    for side in (src, dst):
        side.engine.set_pipeline_depth(depth)
    prompt = _prompt(20 + depth, 16)
    _, want, _ = _run(dst, tokens=prompt, max_new_tokens=24)
    assert _migrate(src, dst, prompt, 24) == want
    assert dst.engine.stats()["slot_imports"] >= 1
    _no_leaks(src, dst)


@pytest.mark.parametrize("depth", [1, 2])
def test_sampled_slot_migrates_within_the_port(model, depth):
    """Within the port a sampled stream migrates exactly: the shipped
    ``sample_base`` keys the continuation's noise where the unbroken
    stream's was."""
    side = _side(model, "port")
    side.engine.set_pipeline_depth(depth)
    prompt = _prompt(30 + depth, 16)
    kw = dict(temperature=0.9, seed=5, top_p=0.9)
    _, want, _ = _run(side, tokens=prompt, max_new_tokens=24, **kw)
    assert _migrate(side, side, prompt, 24, **kw) == want
    _no_leaks(side)


def test_ship_guards(model, monkeypatch):
    """The reference's refusals: geometry and dtype mismatches, a whole
    refusal on a capacity shortfall, ineligible dense and packed-int4
    engines, the recompute fallback of an expired import, and holds
    swept by TTL and cap with their blocks returned."""
    _, _, tcfg, params = model
    side = _side(model, "port")
    e = side.engine
    prompt = _prompt(40, 20)
    rid, first, _ = _run(side, tokens=prompt, max_new_tokens=1,
                         hold_kv=True)
    manifest, arrays = e.export_kv(rid)
    leaves = dict(zip([leaf["name"] for leaf in manifest["leaves"]], arrays))
    bad = dict(manifest, geometry=dict(manifest["geometry"], block_size=16))
    with pytest.raises(disagg.KvGeometryError, match="block_size"):
        e.import_kv(bad, leaves)
    with pytest.raises(disagg.KvGeometryError, match="leaf k"):
        e.import_kv(manifest, dict(leaves, k=leaves["k"].double()))
    with pytest.raises(disagg.KvGeometryError, match="leaf v"):
        e.import_kv(manifest, dict(leaves, v=leaves["v"][:, :, :4]))
    torn = dict(manifest, leaves=[dict(manifest["leaves"][0],
                                       dtype="float99")]
                + manifest["leaves"][1:])
    with pytest.raises(disagg.KvGeometryError, match="dtype"):
        disagg.unpack_transfer(disagg.pack_transfer(torn, arrays))
    with pytest.raises(jdisagg.KvGeometryError, match="dtype"):
        jdisagg.unpack_transfer(disagg.pack_transfer(torn, arrays))
    tiny = Engine(params, tcfg, **{**ENGINE, "kv_blocks": 2}, device="cpu")
    with pytest.raises(disagg.KvCapacityError, match="fall back"):
        tiny.import_kv(manifest, leaves)
    s = tiny.stats()
    assert s["kv_blocks_used"] == 0 and s["kv_imports_staged"] == 0
    dense = Engine(params, tcfg, **{**ENGINE, "kv_block": 0}, device="cpu")
    int4 = Engine(params, tcfg, **ENGINE, kv_int4=True, device="cpu")
    for other in (dense, int4):
        with pytest.raises(disagg.KvIneligibleError):
            other.export_kv(0)
        with pytest.raises(disagg.KvIneligibleError):
            other.import_kv(manifest, leaves)
        with pytest.raises(disagg.KvIneligibleError):
            other.export_slot(0)
    # An expired import: the continuation recomputes, token for token.
    _, want, _ = _run(side, tokens=prompt, max_new_tokens=8)
    import_id, _ = e.import_kv(manifest, leaves)
    assert e.release_kv_import(import_id)
    _, cont, _ = _run(side, tokens=prompt + first, max_new_tokens=7,
                      kv_import=import_id)
    assert first + cont == want
    # The TTL sweep, then the count cap (oldest first), return blocks.
    monkeypatch.setattr(tengine, "KV_HOLD_TTL_S", 0.0)
    with e._lock:
        e._sweep_kv_holds_locked(float("inf"))
    assert e.stats()["kv_holds"] == 0
    monkeypatch.setattr(tengine, "KV_HOLD_MAX", 2)
    monkeypatch.setattr(tengine, "KV_HOLD_TTL_S", 60.0)
    rids = [_run(side, tokens=_prompt(50 + i, 12), max_new_tokens=1,
                 hold_kv=True)[0] for i in range(3)]
    assert e.stats()["kv_holds"] == 2
    assert not e.release_kv_hold(rids[0]) and e.release_kv_hold(rids[1])
    with e._lock:
        e._sweep_kv_holds_locked(float("inf"))
    _no_leaks(side)
