"""The port's load shedding on the CPU, against the JAX package.

- **brownout**: under a queue held at its threshold, the same submits
  as the JAX engine's are clamped to ``brownout_max_tokens`` and the
  same one is refused with the queue full;
- **the shed counters**: ``stats()``'s and ``load()``'s shedding keys,
  and ``load()`` whole, equal the JAX engine's on the same traffic (a
  deadline dead on arrival, one expiring in the queue, a full queue);
- **Retry-After**: ``retry_after_s`` is 5 before any chunk and equals
  the reference's with the token-rate EWMA set to the same value on
  both engines, clamped to [1, 120];
- **the server**: every 429 and 503 of the port's HTTP server carries a
  ``Retry-After`` in [1, 120] (a full queue, a deadline expired in the
  queue, a draining engine, a dead step thread), ``x-oim-tenant`` sets
  the tenant and ``traceparent`` parents the spans;
- **serve_main**: the overload and observation flags parse to the
  reference's defaults and help and build what they name.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from oim_tpu.cli import serve_main as ref_serve_main
from oim_tpu.models import TransformerConfig as JaxConfig
from oim_tpu.models import init_params as jax_init_params
from oim_tpu.qos import policy as ref_policy
from oim_tpu.serve import Engine as JaxEngine
from oim_tpu.serve import GenRequest as JaxRequest
from oim_tpu.serve.engine import DeadlineExpiredError as JaxDeadlineExpired
from oim_tpu.serve.engine import QueueFullError as JaxQueueFull

from oim_tpu_torch.cli import serve_main
from oim_tpu_torch.common import tracing
from oim_tpu_torch.models.transformer import TransformerConfig
from oim_tpu_torch.models.weights import from_jax_params
from oim_tpu_torch.qos import policy
from oim_tpu_torch.serve.engine import (
    DeadlineExpiredError,
    Engine,
    GenRequest,
    QueueFullError,
)
from oim_tpu_torch.serve.server import ServeServer
from torch_cpu_threads import one_torch_thread  # noqa: F401

CFG = dict(vocab_size=101, d_model=32, n_layers=2, n_heads=4, d_ff=64,
           dtype="float32")
BASE = dict(n_slots=2, max_len=64, chunk=4, prompt_buckets=(16, 32),
            kv_block=8, max_queue=4, brownout_max_tokens=3,
            brownout_hold_s=0.0)
# load() keys whose values are walls or clocks.
TIMED = {"ts", "token_rate", "kv_demote_seconds", "kv_promote_seconds"}


@pytest.fixture(scope="module")
def model():
    jcfg = JaxConfig(**CFG, use_pallas=False)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tree = {name: np.asarray(value) for name, value in jparams.items()}
    tcfg = TransformerConfig(**CFG)
    return jcfg, jparams, tcfg, from_jax_params(tree, tcfg)


def _pair(model):
    jcfg, jparams, tcfg, params = model
    return (JaxEngine(jparams, jcfg, **BASE),
            Engine(params, tcfg, **BASE, device="cpu"))


@pytest.fixture(scope="module")
def served(model):
    """A JAX engine and the port's, each after the shedding traffic:
    (engines, the outcomes and brownout states, each (JAX, port))."""
    jax_e, port = _pair(model)
    return (jax_e, port), (_shed_traffic(jax_e), _shed_traffic(port))


def _prompt(seed: int, n: int) -> list[int]:
    return np.random.RandomState(seed).randint(0, CFG["vocab_size"],
                                               n).tolist()


def _shed_traffic(e) -> list:
    """The shedding traffic, served: a deadline dead on arrival, one
    that expires in the queue, three more queued to the brownout
    threshold (the third clamped) and one refused with the queue full.
    Returns each outcome: tokens, or the error's name."""
    request = JaxRequest if isinstance(e, JaxEngine) else GenRequest
    full = (JaxQueueFull, QueueFullError)
    doa = (JaxDeadlineExpired, DeadlineExpiredError)
    outcomes, rids = [], []
    bodies = [dict(deadline=time.monotonic() - 1.0),
              dict(deadline=time.monotonic() + 0.05), {}, {}, {}, {}]
    for i, extra in enumerate(bodies):
        try:
            rids.append(e.submit(request(tokens=_prompt(i, 6),
                                         max_new_tokens=8, **extra)))
        except full:
            outcomes.append("queue_full")
        except doa:
            outcomes.append("deadline")
    active = e.stats()["brownout_active"]
    time.sleep(0.1)
    e.run()
    for rid in rids:
        try:
            outcomes.append(len(e.result(rid, timeout=0)))
        except RuntimeError as exc:
            outcomes.append(exc.kind)
    return outcomes, active


def test_brownout_and_shed_counters_match_jax(served):
    (jax_e, port), ((want, jactive), (got, active)) = served
    assert got == want
    assert sorted(map(str, got)) == sorted(
        ["deadline", "queue_full", "deadline_queue", "8", "8", "3"])
    assert active is jactive is True
    keys = ("brownout_active", "ring_dropped", "qos", "qos_preemptions")
    stats, jstats = port.stats(), jax_e.stats()
    assert {k: stats[k] for k in keys} == {k: jstats[k] for k in keys}
    assert stats["chunk_wall_ewma"] > 0 and jstats["chunk_wall_ewma"] > 0
    # The port's stats() carries load()'s shed counts too.
    load, jload = port.load(), jax_e.load()
    assert (stats["shed_queue_full"], stats["shed_deadline"],
            stats["shed_brownout"]) == (load["shed_queue_full"],
                                        load["shed_deadline"],
                                        load["shed_brownout"]) == (1, 2, 1)
    assert set(load) == set(jload)
    assert {k: v for k, v in load.items() if k not in TIMED} == {
        k: v for k, v in jload.items() if k not in TIMED}
    assert load["token_rate"] > 0 and jload["token_rate"] > 0


def test_brownout_validation(model):
    _, _, tcfg, params = model
    for bad in (dict(brownout_max_tokens=-1),
                dict(brownout_queue_fraction=0.0),
                dict(brownout_queue_fraction=1.5)):
        with pytest.raises(ValueError, match="brownout"):
            Engine(params, tcfg, **bad, device="cpu")


def test_retry_after_matches_reference(model, served):
    # 5 before any chunk (a JAX engine compiles nothing until it serves).
    fresh = _pair(model)
    assert fresh[1].retry_after_s() == fresh[0].retry_after_s() == 5
    jax_e, port = served[0]
    for e in (jax_e, port):
        request = JaxRequest if isinstance(e, JaxEngine) else GenRequest
        for i in range(3):
            e.submit(request(tokens=_prompt(10 + i, 6),
                             max_new_tokens=20 + i))
        e.step()  # two admitted (one token each), one queued
    for rate, want in ((7.0, None), (1e-3, 120), (1e6, 1)):
        for e in (jax_e, port):
            e._token_rate_ewma = rate
        assert port.retry_after_s() == jax_e.retry_after_s()
        if want is not None:
            assert port.retry_after_s() == want
    assert port.retry_after_s() == 1
    port._token_rate_ewma = 7.0
    # (19 + 20 remaining, 22 queued) / 7 + 1
    assert port.retry_after_s() == int((19 + 20 + 22) / 7.0) + 1
    for e in (jax_e, port):
        e.run()


def _post(port: int, body: dict, headers=None, path="/v1/generate"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read()), dict(exc.headers)


def _retry_after(headers) -> int:
    value = int(headers["Retry-After"])
    assert 1 <= value <= 120
    return value


def test_server_retry_after_tenant_and_trace(model):
    _, _, tcfg, params = model
    engine = Engine(params, tcfg, n_slots=1, max_len=64, chunk=4,
                    max_queue=2, device="cpu")
    server = ServeServer(engine)
    # The step thread starts later: first the queue fills.
    server._http_thread.start()
    try:
        results = {}

        def post(name, body, headers=None):
            results[name] = _post(server.port, body, headers)

        parent = tracing.SpanContext(tracing.new_trace_id(),
                                     "1122334455667788")
        waiting = [
            threading.Thread(target=post, args=("long", {
                "tokens": _prompt(20, 5), "max_new_tokens": 8}, {
                "x-oim-tenant": "user.hdr",
                "traceparent": parent.traceparent()})),
            threading.Thread(target=post, args=("late", {
                "tokens": _prompt(21, 5), "max_new_tokens": 4,
                "deadline_ms": 50})),
        ]
        for t in waiting:
            t.start()
            deadline = time.monotonic() + 10
            while engine.stats()["queued"] < waiting.index(t) + 1:
                assert time.monotonic() < deadline
                time.sleep(0.005)
        code, body, headers = _post(server.port, {"tokens": [1, 2]})
        assert code == 429 and "queue full" in body["error"]
        assert _retry_after(headers) == 5  # no chunk yet
        time.sleep(0.1)
        server._step_thread.start()
        for t in waiting:
            t.join(60)
        code, body, _ = results["long"]
        assert code == 200 and len(body["tokens"]) == 8
        code, body, headers = results["late"]
        assert code == 429 and "deadline" in body["error"]
        _retry_after(headers)
        # The step thread finalizes a request (spans, ring entry, then
        # its tenant row) just after its reply is out: wait for the row,
        # the last of them, rather than race it.
        deadline = time.monotonic() + 10
        while engine.stats()["tenants"].get("user.hdr", {}).get(
                "tokens_out") != 8:
            assert time.monotonic() < deadline, "user.hdr never finalized"
            time.sleep(0.005)
        entry = next(e for e in engine.requests()["requests"]
                     if e["tenant"] == "user.hdr")
        assert entry["trace"] == parent.trace_id
        assert engine.stats()["tenants"]["user.hdr"]["tokens_out"] == 8
        served = [s for s in tracing.collector().spans()
                  if s.trace_id == parent.trace_id]
        generate = next(s for s in served if s.name == "serve.generate")
        assert generate.parent_id == parent.span_id
        root = next(s for s in served if s.name == "engine.request")
        assert root.parent_id == generate.span_id
        engine.drain()
        for path in ("/v1/generate", "/v1/embed"):
            code, _, headers = _post(server.port, {"tokens": [1, 2]},
                                     path=path)
            assert code == 503
            _retry_after(headers)
        server.error = "step thread died"
        code, _, headers = _post(server.port, {"tokens": [1, 2]})
        assert code == 503
        _retry_after(headers)
    finally:
        server.error = None
        server.stop()


FLAGS = {"--brownout-max-tokens": "16", "--request-ring": "32",
         "--slow-capture-e2e": "0.5", "--slow-capture-tpot-mult": "3",
         "--slow-capture-interval": "10"}


def test_serve_main_flags_match_reference(model, tmp_path):
    doc = {"tenants": {"user.gold": {"tier": "premium"},
                       "user.lead": {"tier": "best_effort", "weight": 2}}}
    path = tmp_path / "policy.json"
    path.write_text(json.dumps(doc))
    ours, theirs = serve_main.build_parser(), ref_serve_main.build_parser()
    for flag in [*FLAGS, "--qos-policy"]:
        mine = ours._option_string_actions[flag]
        ref = theirs._option_string_actions[flag]
        assert (mine.default, mine.type, mine.help) == (
            ref.default, ref.type, ref.help), flag
    argv = [*(x for kv in FLAGS.items() for x in kv),
            "--qos-policy", str(path)]
    names = [f[2:].replace("-", "_") for f in FLAGS] + ["qos_policy"]
    want = vars(theirs.parse_args(argv))
    got = vars(ours.parse_args(argv))
    assert {n: got[n] for n in names} == {n: want[n] for n in names}
    engine = serve_main.make_engine(ours.parse_args(argv + [
        "--device", "cpu", "--vocab-size", "101", "--d-model", "32",
        "--n-layers", "1", "--n-heads", "4", "--dtype", "float32",
        "--max-len", "64", "--n-slots", "2"]))
    assert (engine.brownout_max_tokens, engine._ring.maxlen,
            engine._slow_e2e_s, engine._slow_tpot_mult,
            engine._slow_interval_s) == (16, 32, 0.5, 3.0, 10.0)
    assert policy.encode_policy(engine._qos_policy) == (
        ref_policy.encode_policy(ref_policy.load_policy_file(str(path))))
    assert engine.info()["engine"]["qos"] is True
    plain = serve_main.make_engine(ours.parse_args([
        "--device", "cpu", "--vocab-size", "101", "--d-model", "32",
        "--n-layers", "1", "--n-heads", "4", "--dtype", "float32",
        "--max-len", "64"]))
    assert plain._qos_policy is None and plain.brownout_max_tokens == 0
