"""The port's request observation on the CPU, against the JAX package.

A tiny model is drawn by the JAX package and handed to the port; both
engines serve the same traffic on the paged pool with the prefix cache
and chunked prefill (a stored prefix, a hit on it, a prompt in two
segments, an anon request), stepped in lockstep:

- **the ring**: every finished request's entry has the JAX engine's
  deterministic fields — rid, tenant, outcome, tokens in and out, decode
  chunks, prefix source and prefill segments — in the same finish
  order, and its phases partition its end-to-end wall within the
  reference's tolerance (``tests/test_request_obs.py``);
- **spans**: a request under a ``traceparent`` parent gets the JAX
  engine's span tree — one ``engine.request`` child of the parent, a
  child a phase, one ``engine.decode`` a chunk;
- **the ring's bounds**: drop-oldest with ``ring_dropped`` counted, and
  cancelled and queue-shed requests leave entries;
- **slow capture**: one ``serve.slow_capture`` artifact an interval in
  ``$OIM_FLIGHT_DIR``, with the reference's keys;
- **watchdog and pool**: ``watchdog_state`` reads (None, None) fresh and
  (None, EWMA > 0) at idle after traffic, as the reference's;
  ``kv_fragmentation`` equals the JAX engine's after every step;
- **migration**: a migrated slot's manifest carries the request's trace
  context as the reference's does;
- **histograms**: the per-tenant SLO series observe once a request.
"""

import json
import time

import jax
import numpy as np
import pytest

from oim_tpu.common import events as jevents
from oim_tpu.common import tracing as jtracing
from oim_tpu.models import TransformerConfig as JaxConfig
from oim_tpu.models import init_params as jax_init_params
from oim_tpu.serve import Engine as JaxEngine
from oim_tpu.serve import GenRequest as JaxRequest

from oim_tpu_torch.common import events, metrics, tracing
from oim_tpu_torch.models.transformer import TransformerConfig
from oim_tpu_torch.models.weights import from_jax_params
from oim_tpu_torch.serve.engine import Engine, GenRequest, RequestFailedError
from torch_cpu_threads import one_torch_thread  # noqa: F401

CFG = dict(vocab_size=101, d_model=32, n_layers=2, n_heads=4, d_ff=64,
           dtype="float32")
BASE = dict(n_slots=2, max_len=64, chunk=4, prompt_buckets=(16, 32),
            kv_block=8, prefix_cache_size=2, prefill_chunk=16)
PHASE_SPANS = 5  # request + queue/admit/prefill/stream (decode: a chunk)
# The ring's deterministic fields.
FIELDS = ("tenant", "outcome", "tokens_in", "tokens_out", "chunks",
          "prefix", "prefill_segments")


@pytest.fixture(scope="module")
def model():
    jcfg = JaxConfig(**CFG, use_pallas=False)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tree = {name: np.asarray(value) for name, value in jparams.items()}
    tcfg = TransformerConfig(**CFG)
    return jcfg, jparams, tcfg, from_jax_params(tree, tcfg)


_ENGINES: dict = {}


def _engine(model, package: str, **kw):
    """One engine per (package, config), shared by the module."""
    key = (package, tuple(sorted(kw.items())))
    if key not in _ENGINES:
        jcfg, jparams, tcfg, params = model
        args = {**BASE, **kw}
        _ENGINES[key] = (JaxEngine(jparams, jcfg, **args) if package == "jax"
                         else Engine(params, tcfg, **args, device="cpu"))
    return _ENGINES[key]


def _pair(model, **kw):
    return _engine(model, "jax", **kw), _engine(model, "port", **kw)


def _request(e):
    return JaxRequest if isinstance(e, JaxEngine) else GenRequest


def _prompt(seed: int, n: int) -> list[int]:
    return np.random.RandomState(seed).randint(0, CFG["vocab_size"],
                                               n).tolist()


SHARED = _prompt(50, 16)
# (prompt, budget, tenant, cache_prefix): a stored prefix, a prompt in
# two segments, a hit on the stored prefix, an anon request.
TRAFFIC = [(SHARED + _prompt(1, 3), 7, "user.a", True),
           (_prompt(2, 30), 6, "user.b", False),
           (SHARED + _prompt(3, 5), 9, "user.a", False),
           (_prompt(4, 9), 5, "", False)]


def _submit(e, traffic=TRAFFIC, **kw):
    return [e.submit(_request(e)(tokens=p, max_new_tokens=m, tenant=t,
                                 cache_prefix=c, **kw))
            for p, m, t, c in traffic]


def _lockstep(engines, check=None):
    """Step every engine until all are idle, in lockstep; ``check`` runs
    after each step."""
    while any(e.pending() for e in engines):
        for e in engines:
            e.step()
        if check is not None:
            check()


def _entries(e, rids) -> list[dict]:
    """Ring entries of ``rids`` in finish order, their rid replaced by
    the index in ``rids``."""
    index = {rid: i for i, rid in enumerate(rids)}
    out = []
    for entry in e.requests()["requests"]:
        if entry["rid"] in index:
            out.append({**entry, "rid": index[entry["rid"]]})
    return out


def test_ring_matches_jax_and_phases_partition(model):
    jax_e, port = _pair(model)
    jrids, prids = _submit(jax_e), _submit(port)

    def same_pool():
        assert (port.load()["kv_fragmentation"]
                == jax_e.load()["kv_fragmentation"])

    _lockstep([jax_e, port], check=same_pool)
    for je, pe in ((jax_e, jrids), (port, prids)):
        for rid in pe:
            je.result(rid, timeout=0)
    want, got = _entries(jax_e, jrids), _entries(port, prids)
    assert [{k: e[k] for k in ("rid",) + FIELDS} for e in got] == [
        {k: e[k] for k in ("rid",) + FIELDS} for e in want]
    assert {e["prefix"] for e in got} == {"local", "recomputed"}
    assert max(e["prefill_segments"] for e in got) == 2
    for entry in got:
        total = sum(entry[f"{phase}_s"] for phase in (
            "queue", "admit", "prefill", "decode", "stream"))
        assert total <= entry["e2e_s"] + 1e-3, entry
        assert total >= 0.5 * entry["e2e_s"], entry
        assert entry["e2e_s"] > 0 and entry["prefill_s"] > 0
        assert entry["tier"] == ("best_effort" if entry["tenant"] == "anon"
                                 else "standard")
    segmented = next(e for e in got if e["prefill_segments"] == 2)
    assert len(segmented["segment_walls"]) == 1


def _span_tree(spans, parent):
    """(names sorted, decode count, root attrs) of the engine spans
    under ``parent``, checking the parentage on the way."""
    engine_spans = [s for s in spans if s.trace_id == parent.trace_id
                    and s.component == "engine"]
    root = next(s for s in engine_spans if s.name == "engine.request")
    assert root.parent_id == parent.span_id
    for span in engine_spans:
        if span is not root:
            assert span.parent_id == root.span_id, span.name
    decodes = [s for s in engine_spans if s.name == "engine.decode"]
    for d in decodes:
        assert d.attrs["tokens"] >= 1
        assert {"chunk", "dispatch_wait_s", "fetch_wait_s"} <= set(d.attrs)
    return (sorted(s.name for s in engine_spans), len(decodes),
            {k: root.attrs[k] for k in ("tenant", "outcome", "tokens_in",
                                        "tokens_out")})


def test_span_tree_matches_jax(model):
    jax_e, port = _pair(model)
    trees = []
    for e, trace in ((jax_e, jtracing), (port, tracing)):
        parent = trace.SpanContext(trace.new_trace_id(), "ab12cd34ef56ab78")
        rid = e.submit(_request(e)(tokens=_prompt(5, 6), max_new_tokens=9,
                                   span=parent))
        e.run()
        e.result(rid, timeout=0)
        entry = _entries(e, [rid])[0]
        assert entry["trace"] == parent.trace_id
        names, decodes, attrs = _span_tree(trace.collector().spans(), parent)
        assert decodes == entry["chunks"]
        assert len(names) <= PHASE_SPANS + entry["chunks"]
        trees.append((names, decodes, attrs))
    assert trees[1] == trees[0]
    assert {"engine.request", "engine.queue", "engine.admit",
            "engine.prefill", "engine.decode", "engine.stream"} == set(
        trees[1][0])


def test_ring_drop_oldest_and_failures(model):
    _, _, tcfg, params = model
    engine = Engine(params, tcfg, n_slots=2, max_len=64, chunk=4,
                    request_ring=2, device="cpu")
    dropped = metrics.SERVE_REQUEST_RING_DROPPED.value(engine._engine_label)
    rids = []
    for _ in range(3):
        rids.append(engine.submit(GenRequest(tokens=_prompt(3, 3),
                                             max_new_tokens=1)))
        engine.run()
    doc = engine.requests()
    assert [e["rid"] for e in doc["requests"]] == rids[1:]
    assert doc["dropped"] == 1 == engine.stats()["ring_dropped"]
    assert metrics.SERVE_REQUEST_RING_DROPPED.value(
        engine._engine_label) == dropped + 1
    # Failures leave entries too: a cancelled request and a queue shed.
    rid_c = engine.submit(GenRequest(tokens=[1, 2], max_new_tokens=4))
    assert engine.cancel(rid_c)
    rid_d = engine.submit(GenRequest(tokens=[3, 4], max_new_tokens=4,
                                     deadline=time.monotonic() + 0.05))
    time.sleep(0.1)
    engine.run()
    for rid, kind in ((rid_c, "cancelled"), (rid_d, "deadline_queue")):
        with pytest.raises(RequestFailedError) as err:
            engine.result(rid, timeout=5)
        assert err.value.kind == kind
    outcomes = {e["rid"]: e["outcome"] for e in engine.requests()["requests"]}
    assert outcomes == {rid_c: "cancelled", rid_d: "deadline_queue"}
    with pytest.raises(ValueError, match="request_ring"):
        Engine(params, tcfg, request_ring=-1, device="cpu")


def _slow_capture(e, tmp_path, monkeypatch) -> tuple[list, dict]:
    """Three requests past a tiny e2e threshold on ``e``, its flight dir
    ``tmp_path``: (the artifacts written, the first one)."""
    tmp_path.mkdir()
    monkeypatch.setenv("OIM_FLIGHT_DIR", str(tmp_path))
    rids = _submit(e, TRAFFIC[:3])
    e.run()
    for rid in rids:
        e.result(rid, timeout=0)
    files = sorted(tmp_path.glob("oim-slowcap-*.json"))
    return files, json.loads(files[0].read_text()) if files else {}


def test_slow_capture_once_an_interval(model, tmp_path, monkeypatch):
    # The module's engines, their thresholds set as the constructor's
    # slow_capture_e2e_s=1e-4, slow_capture_interval_s=3600 sets them.
    jax_e, port = _pair(model)
    for e in (jax_e, port):
        monkeypatch.setattr(e, "_slow_e2e_s", 1e-4)
        monkeypatch.setattr(e, "_slow_interval_s", 3600.0)
        monkeypatch.setattr(e, "_slow_last_capture", 0.0)
    slow = Engine(model[3], model[2], slow_capture_e2e_s=1e-4,
                  slow_capture_interval_s=3600.0, device="cpu")
    assert (slow._slow_e2e_s, slow._slow_interval_s) == (1e-4, 3600.0)

    def captures():
        return [e for e in events.snapshot()["events"]
                if e["kind"] == "serve.slow_capture"]

    before = len(captures())
    written = port.stats()["slow_captures"]
    counted = metrics.SERVE_SLOW_CAPTURES.value(port._engine_label, "e2e")
    files, doc = _slow_capture(port, tmp_path / "port", monkeypatch)
    assert len(files) == 1
    assert port.stats()["slow_captures"] == written + 1
    assert len(captures()) == before + 1
    assert captures()[-1]["fields"]["path"] == str(files[0])
    assert metrics.SERVE_SLOW_CAPTURES.value(
        port._engine_label, "e2e") == counted + 1
    # The reference resolves a crash hook's directory before
    # $OIM_FLIGHT_DIR, and a test earlier in this process may have
    # installed one.
    monkeypatch.setitem(jevents._crash_state, "dir", "")
    jfiles, jdoc = _slow_capture(jax_e, tmp_path / "jax", monkeypatch)
    assert len(jfiles) == 1
    assert set(doc) == set(jdoc)
    assert (doc["kind"], doc["trigger"]) == ("slow_capture", "e2e")
    assert set(doc["entry"]) == set(jdoc["entry"])
    assert set(doc["thresholds"]) == set(jdoc["thresholds"])
    assert set(doc["chunks"][0]) == set(jdoc["chunks"][0])
    assert f"-{doc['entry']['rid']}-" in files[0].name
    with pytest.raises(ValueError, match="slow-capture"):
        Engine(model[3], model[2], slow_capture_e2e_s=-1.0, device="cpu")


def test_watchdog_state(model):
    jcfg, jparams, tcfg, params = model
    # Before any chunk: no wait, no baseline (a JAX engine compiles
    # nothing until it serves).
    assert JaxEngine(jparams, jcfg, n_slots=2, max_len=64,
                     chunk=4).watchdog_state() == (None, None)
    assert Engine(params, tcfg, n_slots=2, max_len=64, chunk=4,
                  device="cpu").watchdog_state() == (None, None)
    pair = _pair(model)
    for e in pair:
        rid = e.submit(_request(e)(tokens=_prompt(6, 5), max_new_tokens=9))
        e.run()
        e.result(rid, timeout=0)
        waiting, ewma = e.watchdog_state()
        assert waiting is None and ewma > 0
    port = pair[1]
    port._watch_begin()
    waiting, _ = port.watchdog_state()
    port._watch_end()
    assert waiting is not None and waiting >= 0.0
    assert port.watchdog_state()[0] is None


def test_migrated_manifest_carries_the_trace(model):
    metas = []
    for e in _pair(model):
        trace = jtracing if isinstance(e, JaxEngine) else tracing
        parent = trace.SpanContext(trace.new_trace_id(), "0123456789abcdef")
        rid = e.submit(_request(e)(tokens=_prompt(7, 12), max_new_tokens=40,
                                   tenant="user.m", span=parent))
        for _ in range(3):
            e.step()
        e.begin_migrate_out()
        e.step()
        manifest, _ = e.export_slot(rid)
        meta = dict(manifest["slot"])
        assert meta.pop("trace") == parent.traceparent()
        metas.append(meta)
        e.release_migrated(rid)
        e._draining = e._migrate_out = False  # the shared engine serves on
    assert metas[1] == metas[0]


def test_tenant_histograms_observe(model):
    port = _engine(model, "port")
    tenant = "user.slo"
    e2e = metrics.SERVE_E2E.count(tenant, "ok")
    queue = metrics.SERVE_QUEUE_WAIT.count(tenant)
    prefill = metrics.SERVE_PREFILL.count(tenant)
    tpot = metrics.SERVE_TPOT.count(tenant)
    tokens = metrics.SERVE_TENANT_TOKENS.value(tenant)
    rid = port.submit(GenRequest(tokens=_prompt(8, 4), max_new_tokens=6,
                                 tenant=tenant))
    port.run()
    port.result(rid, timeout=0)
    assert metrics.SERVE_E2E.count(tenant, "ok") == e2e + 1
    assert metrics.SERVE_QUEUE_WAIT.count(tenant) == queue + 1
    assert metrics.SERVE_PREFILL.count(tenant) == prefill + 1
    assert metrics.SERVE_TPOT.count(tenant) == tpot + 1
    assert metrics.SERVE_TENANT_TOKENS.value(tenant) == tokens + 6
    text = metrics.registry().render()
    for series in ('oim_serve_e2e_seconds_bucket{tenant="user.slo",'
                   'outcome="ok"',
                   'oim_serve_queue_wait_seconds_bucket{tenant="user.slo"',
                   'oim_serve_tpot_seconds_bucket{tenant="user.slo"',
                   'oim_serve_prefill_seconds_bucket{tenant="user.slo"',
                   'oim_serve_active_slots{engine=',
                   'oim_serve_kv_blocks{engine='):
        assert series in text, series
