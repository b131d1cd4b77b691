"""The port's multi-tenant QoS on the CPU, against the JAX package.

The reference's geometry (``tests/test_serve_qos.py``): two slots, a
16-block pool of 8-token blocks, the host tier, and one policy document
decoded by both packages (user.gold premium, user.lead best-effort,
unlisted tenants standard).  A tiny model is drawn by the JAX package
and handed to the port, and both engines serve the same traffic:

- **fair share**: from a skewed backlog (user.x queues six requests,
  then user.y six) the finish order, read from the request ring, and the
  tenant rows' deltas equal the JAX engine's, each tenant among the
  first finishers; with no policy admission is FIFO;
- **preemption**: two best-effort streams fill both slots and a premium
  arrival parks one — the same victim and ``qos_preemptions`` as the
  JAX engine's; every stream equals its never-preempted run, and,
  greedy, the JAX engine's (greedy and sampled, depth 1 and 2, fp and
  kv8), with no block left in either tier; equal tiers never preempt;
- **the policy**: ``set_qos_policy`` keeps the virtual times;
- **prefixes**: under pressure the best-effort entry demotes before an
  older premium one, as the JAX engine's does;
- **migration**: a migrate-out drain captures premium slots first;
- **metrics**: ``oim_serve_qos_total`` and
  ``oim_serve_tenant_tokens_total`` move as the reference's do.
"""

import jax
import numpy as np
import pytest

from oim_tpu.common import events as jevents
from oim_tpu.common import metrics as jmetrics
from oim_tpu.models import TransformerConfig as JaxConfig
from oim_tpu.models import init_params as jax_init_params
from oim_tpu.qos import policy as jpolicy
from oim_tpu.serve import Engine as JaxEngine
from oim_tpu.serve import GenRequest as JaxRequest

from oim_tpu_torch.common import events, metrics
from oim_tpu_torch.models.transformer import TransformerConfig
from oim_tpu_torch.models.weights import from_jax_params
from oim_tpu_torch.qos import policy
from oim_tpu_torch.serve.engine import Engine, GenRequest
from torch_cpu_threads import one_torch_thread  # noqa: F401

CFG = dict(vocab_size=101, d_model=32, n_layers=2, n_heads=4, d_ff=64,
           dtype="float32")
HOST_BYTES = 1 << 20
BASE = dict(n_slots=2, max_len=64, chunk=4, prompt_buckets=(16, 32),
            kv_block=8, kv_blocks=16, prefix_cache_size=2)
POLICY = ('{"tenants": {"user.gold": {"tier": "premium"}, '
          '"user.lead": {"tier": "best_effort"}}}')
COUNTERS = ("admitted", "preempted", "parked_victim", "requests",
            "tokens_out")


@pytest.fixture(scope="module")
def model():
    jcfg = JaxConfig(**CFG, use_pallas=False)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tree = {name: np.asarray(value) for name, value in jparams.items()}
    tcfg = TransformerConfig(**CFG)
    return jcfg, jparams, tcfg, from_jax_params(tree, tcfg)


_ENGINES: dict = {}


def _engine(model, package: str, **kw):
    """One engine per (package, config) with the module's policy,
    shared by the module."""
    key = (package, tuple(sorted(kw.items())))
    if key not in _ENGINES:
        jcfg, jparams, tcfg, params = model
        args = {**BASE, "kv_host_bytes": HOST_BYTES, **kw}
        _ENGINES[key] = (
            JaxEngine(jparams, jcfg, qos=jpolicy.decode_policy(POLICY),
                      **args) if package == "jax"
            else Engine(params, tcfg, qos=policy.decode_policy(POLICY),
                        **args, device="cpu"))
    return _ENGINES[key]


def _pair(model, **kw):
    return _engine(model, "jax", **kw), _engine(model, "port", **kw)


def _is_jax(e) -> bool:
    return isinstance(e, JaxEngine)


def _prompt(seed: int, n: int) -> list[int]:
    return np.random.RandomState(seed).randint(0, CFG["vocab_size"],
                                               n).tolist()


def _submit(e, tokens, mn, **kw) -> int:
    request = JaxRequest if _is_jax(e) else GenRequest
    return e.submit(request(tokens=tokens, max_new_tokens=mn, **kw))


def _gen(e, tokens, mn, **kw) -> list[int]:
    rid = _submit(e, tokens, mn, **kw)
    e.run()
    return list(e.result(rid, timeout=0))


def _finishers(e, rids) -> list[tuple[int, str]]:
    """(index in ``rids``, tenant) of each of ``rids`` in finish order."""
    index = {rid: i for i, rid in enumerate(rids)}
    return [(index[entry["rid"]], entry["tenant"])
            for entry in e.requests()["requests"] if entry["rid"] in index]


def _rows(e) -> dict:
    return e.stats()["tenants"]


def _delta(before: dict, after: dict) -> dict:
    """Per tenant: tier, weight and how far each counter moved."""
    return {name: {"tier": row["tier"], "weight": row["weight"],
                   **{k: row[k] - before.get(name, {}).get(k, 0)
                      for k in COUNTERS}}
            for name, row in after.items()
            if any(row[k] != before.get(name, {}).get(k, 0)
                   for k in COUNTERS)}


def _qos_metrics(package) -> dict:
    m = jmetrics if package == "jax" else metrics
    return {**{(tier, action): m.SERVE_QOS.value(tier, action)
               for tier in ("premium", "standard", "best_effort")
               for action in ("admitted", "preempted", "parked_victim")},
            **{t: m.SERVE_TENANT_TOKENS.value(t)
               for t in ("user.x", "user.y", "user.gold", "user.lead")}}


def _no_leaks(e) -> None:
    """Device blocks are the resident entries' only; host blocks the
    demoted entries' only; nothing queued, seated or parked."""
    s = e.stats()
    assert s["active_slots"] == 0 and s["queued"] == 0
    assert s["parked_slots"] == 0
    with e._lock:
        entry_blocks = {b for blocks, _ in e._prefix_cache.values()
                        for b in blocks}
        assert e._alloc.used_blocks == len(entry_blocks)
        host_blocks = {b for blocks, _ in e._host_prefix.values()
                       for b in blocks}
        assert e._host.alloc.used_blocks == len(host_blocks)


def _fair_share(e) -> tuple[list, dict, dict]:
    """user.x queues six requests, then user.y six; returns the finish
    order, the tenant rows' deltas and the QoS metrics' deltas."""
    package = "jax" if _is_jax(e) else "port"
    rows, counted = _rows(e), _qos_metrics(package)
    rids = [_submit(e, _prompt(30 + i, 8), 8, tenant="user.x")
            for i in range(6)]
    rids += [_submit(e, _prompt(40 + i, 8), 8, tenant="user.y")
             for i in range(6)]
    e.run()
    for rid in rids:
        assert len(e.result(rid, timeout=0)) == 8
    after = _qos_metrics(package)
    return (_finishers(e, rids), _delta(rows, _rows(e)),
            {k: after[k] - counted[k] for k in after})


def test_fair_share_matches_jax(model):
    jax_e, port = _pair(model)
    want, want_rows, want_metrics = _fair_share(jax_e)
    got, rows, moved = _fair_share(port)
    assert got == want
    first = [tenant for _, tenant in got[:6]]
    assert first.count("user.x") >= 2 and first.count("user.y") >= 2, got
    assert rows == want_rows
    assert rows["user.x"]["admitted"] == 6
    assert rows["user.x"]["tokens_out"] == 48
    assert rows["user.x"]["weight"] == rows["user.y"]["weight"]
    assert moved == want_metrics
    assert moved[("standard", "admitted")] == 12
    assert moved["user.x"] == moved["user.y"] == 48
    # Warmup's dummies leave no accounting row behind.
    warmed = Engine(model[3], model[2], **BASE, kv_host_bytes=HOST_BYTES,
                    qos=policy.decode_policy(POLICY), device="cpu").warmup()
    assert warmed.stats()["tenants"] == {}
    _no_leaks(port)


def test_qos_off_is_fifo(model):
    """With the policy removed the engines admit FIFO: the premium
    tenant, queued last, finishes last, and nothing preempts."""
    orders = []
    for e in _pair(model):
        saved, preempts = e._qos_policy, e.qos_preemptions
        e.set_qos_policy(None)
        try:
            rids = [_submit(e, _prompt(50 + i, 8), 6, tenant="user.x")
                    for i in range(4)]
            rids.append(_submit(e, _prompt(60, 8), 6, tenant="user.gold"))
            e.run()
            assert e.stats()["qos"] is False
            orders.append(_finishers(e, rids))
        finally:
            e.set_qos_policy(saved)
        assert e.qos_preemptions == preempts
    assert orders[1] == orders[0]
    assert orders[1][-1] == (4, "user.gold")


def _preempt_events(package) -> list:
    rec = jevents if package == "jax" else events
    return [e for e in rec.all_events() if e.kind == "qos.preempt"]


def _victims(package, since: int) -> list[int]:
    """Victim rids of the ``qos.preempt`` events numbered past ``since``
    (a full ring drops its oldest events, so the numbers, not the count,
    mark where a cycle began)."""
    return [e.fields["victim_rid"] for e in _preempt_events(package)
            if e.seq > since]


def _preempt_cycle(e, depth: int, gkw: dict, oracles: bool):
    """Two best-effort streams fill both slots; once they decode, a
    premium request arrives.  Returns (streams, victims as indices of
    the three, preemptions, never-preempted runs or None)."""
    package = "jax" if _is_jax(e) else "port"
    e.set_pipeline_depth(depth)
    prompts = [_prompt(70, 16), _prompt(71, 16), _prompt(72, 16)]
    asks = [dict(mn=40, seed=7, tenant="user.lead"),
            dict(mn=40, seed=9, tenant="user.lead"),
            dict(mn=6, seed=3, tenant="user.gold")]
    solo = None
    if oracles:
        solo = [_gen(e, p, **ask, **gkw) for p, ask in zip(prompts, asks)]
    n0 = e.qos_preemptions
    seen = max((e.seq for e in _preempt_events(package)), default=0)
    rids = [_submit(e, p, **ask, **gkw)
            for p, ask in zip(prompts[:2], asks[:2])]
    for _ in range(4):
        e.step()  # both streams admitted and decoding
    rids.append(_submit(e, prompts[2], **asks[2], **gkw))
    e.run()
    streams = [list(e.result(rid, timeout=0)) for rid in rids]
    victims = [rids.index(v) for v in _victims(package, seen)]
    return streams, victims, e.qos_preemptions - n0, solo


MODES = [("greedy", {}), ("temp", dict(temperature=0.8))]


@pytest.mark.parametrize("quant", [{}, {"kv_int8": True}], ids=["fp", "kv8"])
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("mode", MODES, ids=[m[0] for m in MODES])
def test_preemption_matches_jax(model, quant, depth, mode):
    name, gkw = mode
    port = _engine(model, "port", **quant)
    rows = _rows(port)
    streams, victims, preempts, solo = _preempt_cycle(port, depth, gkw,
                                                      oracles=True)
    assert preempts >= 1, "the premium admission did not preempt"
    # A swap, not a kill: every stream is its never-preempted run.
    assert streams == solo
    moved = _delta(rows, _rows(port))
    assert moved["user.gold"]["preempted"] == preempts
    assert moved["user.lead"]["parked_victim"] == preempts
    assert (moved["user.gold"]["tier"], moved["user.lead"]["tier"]) == (
        "premium", "best_effort")
    _no_leaks(port)
    if name == "greedy":
        jax_e = _engine(model, "jax", **quant)
        want, jvictims, jpreempts, _ = _preempt_cycle(jax_e, depth, gkw,
                                                      oracles=False)
        assert streams == want
        assert (victims, preempts) == (jvictims, jpreempts)
        assert port.stats()["qos_preemptions"] == port.qos_preemptions


def test_equal_tiers_never_preempt(model):
    for e in _pair(model):
        e.set_pipeline_depth(1)
        n0 = e.qos_preemptions
        rids = [_submit(e, _prompt(75 + i, 16), 24, tenant="user.gold")
                for i in range(2)]
        for _ in range(4):
            e.step()
        rids.append(_submit(e, _prompt(77, 16), 6, tenant="user.gold"))
        e.run()
        for rid in rids:
            assert e.result(rid, timeout=0)
        assert e.qos_preemptions == n0
        _no_leaks(e)


def test_set_qos_policy_keeps_virtual_times(model):
    tiers = []
    for e in _pair(model):
        pol = jpolicy if _is_jax(e) else policy
        saved = e._qos_policy
        with e._lock:
            vtimes = {t: row["vtime"] for t, row in e._tenants.items()}
        assert vtimes
        e.set_qos_policy(pol.decode_policy(
            '{"tenants": {"user.x": {"tier": "premium"}}}'))
        try:
            with e._lock:
                assert {t: row["vtime"] for t, row in
                        e._tenants.items()} == vtimes
                tiers.append({t: (row["tier"], row["weight"])
                              for t, row in e._tenants.items()})
        finally:
            e.set_qos_policy(saved)
    assert tiers[1] == tiers[0]
    assert tiers[1]["user.x"] == ("premium", 8.0)


def _flush_prefixes(e) -> None:
    e._warming = True
    try:
        with e._lock:
            e._clear_prefix_cache_locked()
            e._flush_host_tier_locked()
    finally:
        e._warming = False


def test_premium_prefix_demotes_last(model):
    """Two resident entries, premium stored first (the LRU victim
    without QoS), best-effort second: pressure that demotes one takes
    the best-effort entry, in both engines."""
    left = []
    for e in _pair(model):
        e.set_pipeline_depth(1)
        _flush_prefixes(e)
        for tokens, tenant in ((_prompt(80, 16), "user.gold"),
                               (_prompt(81, 16), "user.lead")):
            _gen(e, tokens, 2, cache_prefix=True, tenant=tenant)
        d0 = e.stats()["prefix_demotions"]
        rids = [_submit(e, _prompt(85 + i, 16), 40) for i in range(2)]
        e.run()
        for rid in rids:
            assert len(e.result(rid, timeout=0)) == 40
        s = e.stats()
        with e._lock:
            left.append(([m["tier"] for m in e._prefix_meta.values()],
                         s["prefix_demotions"] - d0,
                         s["host_prefix_entries"]))
        _flush_prefixes(e)
        _no_leaks(e)
    assert left[1] == left[0]
    assert left[1][0] == ["premium"] and left[1][1] >= 1


def test_migration_captures_premium_first(model):
    """A migrate-out drain captures the premium slot before the
    best-effort one that was admitted first (runs last: it drains the
    shared engines)."""
    orders = []
    for e in _pair(model):
        e.set_pipeline_depth(1)
        rids = [_submit(e, _prompt(90, 16), 40, tenant="user.lead"),
                _submit(e, _prompt(91, 16), 40, tenant="user.gold")]
        for _ in range(3):
            e.step()
        e.begin_migrate_out()
        e.step()
        with e._lock:
            captured = list(e._migrated)
            tiers = [e._migrated[rid].meta["tier"] for rid in captured]
        orders.append(([rids.index(rid) for rid in captured], tiers))
        for rid in captured:
            e.release_migrated(rid)
    assert orders[1] == orders[0] == ([1, 0], ["premium", "best_effort"])
