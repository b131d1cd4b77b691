"""Token streaming: the engine's ``on_token`` callbacks and the server's
NDJSON stream, held against the JAX package on the CPU.

- ``on_token`` sequences equal the JAX engine's for the same traffic:
  greedy at pipeline depth 1 and 2, a speculative engine (prompt lookup,
  2 drafts), EOS and stop ids; tokens in order, logprobs within 1e-4,
  then ``(None, None)`` exactly once;
- the end comes exactly once on finish, cancel, abort (and the stall
  watchdog's kind "stalled"), deadline and migration, and a stream runs
  on through a park and its restore;
- the port server's NDJSON lines equal a JAX ``ServeServer``'s for the
  same greedy bodies, token for token, logprobs within 1e-4, with the
  same headers and terminal line;
- a client that disconnects mid-stream frees its slot, and the cancel is
  counted.
"""

import json
import socket
import time

import pytest

from oim_tpu.serve import Engine as JaxEngine
from oim_tpu.serve import GenRequest as JaxRequest
from oim_tpu.serve.server import ServeServer as JaxServer

from oim_tpu_torch.common import metrics
from oim_tpu_torch.serve.engine import Engine, GenRequest, RequestFailedError
from oim_tpu_torch.serve.server import ServeServer
from torch_cpu_threads import one_torch_thread  # noqa: F401
from torch_serve_http import (
    LOGPROB_ATOL,
    jax_model,
    prompt,
    stream_lines,
    url,
)

ENGINE = dict(n_slots=2, max_len=64, chunk=4, prompt_buckets=(8, 16, 32),
              kv_block=8)
SPEC = dict(n_slots=2, max_len=64, chunk=4, prompt_buckets=(8, 16, 32),
            spec_decode=2)
PARK = dict(n_slots=4, max_len=64, chunk=4, prompt_buckets=(16, 32),
            kv_block=8, kv_blocks=8, kv_host_bytes=1 << 20)


@pytest.fixture(scope="module")
def model():
    return jax_model()


_ENGINES: dict = {}


def _engine(model, package: str, kind: str = "plain"):
    key = (package, kind)
    if key not in _ENGINES:
        jcfg, jparams, tcfg, params = model
        kw = {"plain": ENGINE, "spec": SPEC, "park": PARK}[kind]
        _ENGINES[key] = (JaxEngine(jparams, jcfg, **kw) if package == "jax"
                         else Engine(params, tcfg, **kw, device="cpu"))
    return _ENGINES[key]


def _streams(engine, bodies) -> list[list]:
    """Submit ``bodies`` together with a callback each, run the engine,
    return each stream's (token, logprob) calls."""
    request = JaxRequest if isinstance(engine, JaxEngine) else GenRequest
    seen = [[] for _ in bodies]
    rids = [engine.submit(request(**body),
                          on_token=lambda t, lp, s=s: s.append((t, lp)))
            for body, s in zip(bodies, seen)]
    engine.run()
    for rid, s in zip(rids, seen):
        tokens, _ = engine.result_full(rid, timeout=0)
        assert [t for t, _ in s[:-1]] == list(tokens)
    return seen


def _assert_same_streams(got, want) -> None:
    for g, w in zip(got, want):
        assert [t for t, _ in g] == [t for t, _ in w]
        assert g[-1] == (None, None) and [t for t, _ in g].count(None) == 1
        for (_, a), (_, b) in zip(g[:-1], w[:-1]):
            assert abs(a - b) <= LOGPROB_ATOL


TRAFFIC = [dict(tokens=prompt(1, 5), max_new_tokens=13),
           dict(tokens=prompt(2, 12), max_new_tokens=9),
           dict(tokens=prompt(3, 20), max_new_tokens=16)]


@pytest.mark.parametrize("case", ["depth1", "depth2", "spec", "eos_stop"])
def test_on_token_matches_jax(model, case):
    """The port's callbacks deliver what the JAX engine's deliver, in
    order, with one end each — at depth 2 the chunk dispatched ahead of a
    finished request adds nothing after its end."""
    kind = "spec" if case == "spec" else "plain"
    jax_e, port_e = _engine(model, "jax", kind), _engine(model, "port", kind)
    depth = 1 if case == "depth1" else 2
    if kind == "plain":
        jax_e.set_pipeline_depth(depth)
        port_e.set_pipeline_depth(depth)
    bodies = TRAFFIC
    if case == "eos_stop":
        greedy = [[t for t, _ in s[:-1]] for s in _streams(port_e, TRAFFIC)]
        bodies = [dict(TRAFFIC[0], eos_id=greedy[0][3]),
                  dict(TRAFFIC[1], stop_ids=[greedy[1][5], 0]),
                  dict(TRAFFIC[2], eos_id=greedy[2][-1])]
    got = _streams(port_e, bodies)
    _assert_same_streams(got, _streams(jax_e, bodies))
    if case == "eos_stop":  # each cut at its first EOS or stop id
        assert len(got[0]) - 1 <= 4 and len(got[1]) - 1 <= 6
        assert got[0][-2][0] == bodies[0]["eos_id"]
        assert got[1][-2][0] in bodies[1]["stop_ids"]


def _one(engine, **kw):
    seen = []
    rid = engine.submit(GenRequest(**kw), on_token=lambda t, lp: seen.append(t))
    return rid, seen


def _ended_once(engine, rid, seen, kind: str) -> None:
    with pytest.raises(RequestFailedError) as err:
        engine.result_full(rid, timeout=5)
    assert err.value.kind == kind
    assert seen[-1] is None and seen.count(None) == 1


def _step_until(engine, seen, n: int) -> None:
    for _ in range(50):
        if len(seen) >= n:
            return
        engine.step()
    raise AssertionError(f"only {len(seen)} tokens")


@pytest.mark.parametrize("depth", [1, 2])
def test_end_once_on_every_way_out(model, depth):
    """Cancel (queued and mid-decode), abort with kind "aborted" and
    "stalled", a deadline that passes mid-decode, and a migrate-out
    drain: each stream ends exactly once, after the tokens it got."""
    e = _engine(model, "port")
    e.set_pipeline_depth(depth)
    solo = [t for t, _ in _streams(e, [dict(tokens=prompt(9, 6),
                                            max_new_tokens=40)])[0][:-1]]
    # Cancel mid-decode: the tokens so far are the solo run's prefix.
    rid, seen = _one(e, tokens=prompt(9, 6), max_new_tokens=40)
    _step_until(e, seen, 4)
    assert e.cancel(rid)
    e.run()
    _ended_once(e, rid, seen, "cancelled")
    assert seen[:-1] == solo[:len(seen) - 1] and len(seen) - 1 < 40
    # Cancel while queued: just the end.
    a, sa = _one(e, tokens=prompt(10, 6), max_new_tokens=40)
    b, sb = _one(e, tokens=prompt(11, 6), max_new_tokens=40)
    c, sc = _one(e, tokens=prompt(12, 6), max_new_tokens=40)
    assert e.cancel(c)
    _ended_once(e, c, sc, "cancelled")
    assert sc == [None]
    # Abort: the stall watchdog's kind, then the crash path's.
    _step_until(e, sa, 1)
    e.abort("device wedged", kind="stalled")
    for rid, seen in ((a, sa), (b, sb)):
        _ended_once(e, rid, seen, "stalled")
    d, sd = _one(e, tokens=prompt(13, 6), max_new_tokens=40)
    e.abort("down")
    _ended_once(e, d, sd, "aborted")
    # A deadline that passes mid-decode (the request's own, moved to now
    # once it has tokens: no race with the machine's speed).
    req = GenRequest(tokens=prompt(14, 6), max_new_tokens=40,
                     deadline=time.monotonic() + 3600)
    seen = []
    rid = e.submit(req, on_token=lambda t, lp: seen.append(t))
    _step_until(e, seen, 4)
    req.deadline = time.monotonic()
    e.run()
    _ended_once(e, rid, seen, "deadline")
    # A migrate-out drain mid-decode.
    rid, seen = _one(e, tokens=prompt(15, 6), max_new_tokens=40)
    _step_until(e, seen, 4)
    e.begin_migrate_out()
    e.run()
    _ended_once(e, rid, seen, "migrated")
    assert e.release_migrated(rid)
    e._draining = e._migrate_out = False
    s = e.stats()
    assert s["active_slots"] == 0 and s["kv_blocks_used"] == 0


def test_stream_through_park_and_restore(model):
    """Two 6-block worst cases cannot share the 8-block pool: the second
    admission parks the first, whose stream goes on after its restore
    and equals its solo run, with one end each."""
    e = _engine(model, "port", "park")
    prompts = [prompt(20, 16), prompt(21, 16)]
    solo = [[t for t, _ in s[:-1]] for s in _streams(
        e, [dict(tokens=p, max_new_tokens=30) for p in prompts[:1]])]
    solo += [[t for t, _ in s[:-1]] for s in _streams(
        e, [dict(tokens=prompts[1], max_new_tokens=30)])]
    parks = e.stats()["kv_parks"]
    got = _streams(e, [dict(tokens=p, max_new_tokens=30) for p in prompts])
    assert e.stats()["kv_parks"] > parks
    assert [[t for t, _ in s[:-1]] for s in got] == solo
    assert all(s[-1] == (None, None) and s.count((None, None)) == 1
               for s in got)


@pytest.fixture(scope="module")
def servers(model):
    """A JAX ServeServer and a port ServeServer on the plain engines (the
    engine-level tests above have run: these step threads own them
    now)."""
    pair = {"jax": JaxServer(_engine(model, "jax")).start(),
            "port": ServeServer(_engine(model, "port")).start()}
    for server in pair.values():
        server.engine.set_pipeline_depth(2)
    yield pair
    for server in pair.values():
        server.stop()


def test_ndjson_lines_match_jax_server(servers):
    """The same greedy bodies streamed by both servers: the same lines,
    logprobs within 1e-4, the same headers and terminal line."""
    for i, body in enumerate(TRAFFIC):
        body = dict(body, logprobs=bool(i % 2))
        got, want = (stream_lines(url(servers[p]), body)
                     for p in ("port", "jax"))
        assert [ln.get("token") for ln in got] == [
            ln.get("token") for ln in want]
        assert [set(ln) for ln in got] == [set(ln) for ln in want]
        for g, w in zip(got, want):
            for a, b in zip(g.get("logprobs", [g.get("logprob", 0.0)]),
                            w.get("logprobs", [w.get("logprob", 0.0)])):
                assert abs(a - b) <= LOGPROB_ATOL
        assert got[-1]["done"] is True and got[-1]["tokens"] == [
            ln["token"] for ln in got[:-1]]
    import urllib.request
    req = urllib.request.Request(
        url(servers["port"]) + "/v1/generate",
        json.dumps(dict(TRAFFIC[0], stream=True)).encode())
    with urllib.request.urlopen(req, timeout=60) as resp:
        assert resp.headers["Content-Type"] == "application/x-ndjson"
        assert resp.headers["traceparent"].startswith("00-")
        resp.read()


def test_disconnect_frees_slot(model):
    """A client that hangs up mid-stream cancels its request: the slot
    and its blocks are free long before the 400-token budget, and the
    cancel is counted."""
    jcfg, jparams, tcfg, params = model
    engine = Engine(params, tcfg, n_slots=1, max_len=512, chunk=2,
                    prompt_buckets=(8,), kv_block=8, device="cpu")
    server = ServeServer(engine).start()
    cancelled = metrics.SERVE_REQUESTS.value("cancelled")
    try:
        body = json.dumps({"tokens": [1, 2, 3], "max_new_tokens": 400,
                           "stream": True}).encode()
        sock = socket.create_connection(("127.0.0.1", server.port),
                                        timeout=10)
        sock.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Type: application/json\r\nContent-Length: "
                     + str(len(body)).encode() + b"\r\n\r\n" + body)
        got = b""
        while got.count(b"token") < 8:
            got += sock.recv(4096)
        sock.close()
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            s = engine.stats()
            if s["active_slots"] == 0 and s["kv_blocks_used"] == 0:
                break
            time.sleep(0.01)
        s = engine.stats()
        assert s["active_slots"] == 0 and s["kv_blocks_used"] == 0
        assert s["tokens_generated"] < 300
        assert metrics.SERVE_REQUESTS.value("cancelled") == cancelled + 1
    finally:
        server.stop()
