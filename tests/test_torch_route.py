"""The reference's router fronting one JAX backend and one port backend,
on the CPU: a mixed fleet works as one.

- a routed generation equals a direct one, on either backend, and a
  stream passes through the router line for line;
- failover: with either backend stopped, the router serves the request
  on the other, token-identical;
- a routed drain mid-stream on either backend: the router ships the
  suspended slot (``/v1/slot``) to the other and splices its
  continuation, and the client's stream equals the unbroken greedy run;
- routed disaggregation: prefill on one package, the KV shipped
  (``/v1/kv``), decode on the other, both ways.

The drains happen with the victim's step thread held once it has made 4
tokens of the stream, never in a race with a short stream.
"""

import threading

import pytest

from oim_tpu.serve import Engine as JaxEngine
from oim_tpu.serve import Router
from oim_tpu.serve.server import ServeServer as JaxServer

from oim_tpu_torch.serve.engine import Engine
from oim_tpu_torch.serve.server import ServeServer
from torch_cpu_threads import one_torch_thread  # noqa: F401
from torch_serve_http import (
    StepGate,
    call,
    jax_model,
    prompt,
    stream_lines,
)
from torch_serve_http import url as _url

ENGINE = dict(n_slots=2, max_len=64, chunk=4, prompt_buckets=(8, 16, 32),
              kv_block=8, prefix_cache_size=2)
NAMES = ("jax", "port")


@pytest.fixture(scope="module")
def fleet():
    """{"jax": server, "port": server} on the same weights; a test that
    stops one puts a new server on the same engine back."""
    jcfg, jparams, tcfg, params = jax_model()
    servers = {"jax": JaxServer(JaxEngine(jparams, jcfg, **ENGINE)).start(),
               "port": ServeServer(Engine(params, tcfg, **ENGINE,
                                          device="cpu")).start()}
    yield servers
    for server in servers.values():
        server.stop()


def _router(fleet, **kw) -> Router:
    kw.setdefault("health_interval", 60.0)  # the tests probe explicitly
    kw.setdefault("unhealthy_after", 10_000)
    router = Router(backends=tuple(_url(fleet[n]) for n in NAMES),
                    **kw).start()
    _probe(router)
    return router


def _probe(router) -> None:
    for backend in list(router._backends.values()):
        router._probe(backend)


def _steer(router, fleet, onto: str) -> None:
    """Route the next admission onto ``onto``: the router skips a
    draining backend, so the other one is marked draining meanwhile."""
    for name in NAMES:
        fleet[name].engine._draining = name != onto
    _probe(router)


def _undrain(router, fleet) -> None:
    for name in NAMES:
        fleet[name].engine._draining = False
        fleet[name].engine._migrate_out = False
    _probe(router)


def _base(router) -> str:
    return f"http://{router.host}:{router.port}"


def _tokens(lines) -> list[int]:
    assert lines[-1].get("done"), lines[-1]
    streamed = [ln["token"] for ln in lines[:-1] if "token" in ln]
    assert streamed == lines[-1]["tokens"]
    return streamed


@pytest.mark.parametrize("onto", NAMES)
def test_routed_equals_direct(fleet, onto):
    body = {"tokens": prompt(1 + NAMES.index(onto), 12),
            "max_new_tokens": 10}
    direct = call(_url(fleet[onto]), "/v1/generate", body)[2]["tokens"]
    router = _router(fleet)
    try:
        _steer(router, fleet, onto)
        status, _, reply = call(_base(router), "/v1/generate", body)
        assert status == 200 and reply["tokens"] == direct
        _steer(router, fleet, onto)
        routed = stream_lines(_base(router), body)
        assert _tokens(routed) == direct
        assert [set(ln) for ln in routed] == [
            set(ln) for ln in stream_lines(_url(fleet[onto]), body)]
    finally:
        _undrain(router, fleet)
        router.stop()


@pytest.mark.parametrize("stopped", NAMES)
def test_failover_when_a_backend_is_stopped(fleet, stopped):
    other = NAMES[1 - NAMES.index(stopped)]
    body = {"tokens": prompt(5, 10), "max_new_tokens": 8}
    want = call(_url(fleet[other]), "/v1/generate", body)[2]["tokens"]
    router = _router(fleet, unhealthy_after=1)
    engine = fleet[stopped].engine
    fleet[stopped].stop()
    try:
        for _ in range(2):  # whichever the round robin picks first
            status, _, reply = call(_base(router), "/v1/generate", body)
            assert status == 200 and reply["tokens"] == want
        lines = stream_lines(_base(router), body)
        assert _tokens(lines) == want
    finally:
        router.stop()
        server = (JaxServer if stopped == "jax" else ServeServer)(engine)
        fleet[stopped] = server.start()


@pytest.mark.parametrize("victim", NAMES)
def test_routed_drain_midstream_token_identical(fleet, victim):
    body = {"tokens": prompt(10 + NAMES.index(victim), 8),
            "max_new_tokens": 40}
    oracle = call(_url(fleet[victim]), "/v1/generate", body)[2]["tokens"]
    router = _router(fleet)
    src = fleet[victim]
    exports = src.engine.stats()["slot_exports"]
    lines: list = []
    gate = StepGate.after_tokens(src.engine, 4)
    try:
        _steer(router, fleet, victim)
        thread = threading.Thread(target=lambda: stream_lines(
            _base(router), body, on_line=lines.append), daemon=True)
        thread.start()
        # The victim has made 4 tokens (the router forwards a stream in
        # 8 KiB reads, so the client may not have them yet).
        assert gate.held.wait(30)
        _undrain(router, fleet)  # the sibling takes the continuation
        assert call(_url(src), "/v1/drain", {})[0] == 200
        gate.release()
        thread.join(60)
        assert not thread.is_alive()
        assert _tokens(lines) == oracle
        migrations = router.stats()["migrations"]
        assert migrations["migrated"] == 1 and migrations["fell_back"] == 0
        assert src.engine.stats()["slot_exports"] == exports + 1
    finally:
        gate.remove()
        _undrain(router, fleet)
        router.stop()
    for server in fleet.values():
        s = server.engine.stats()
        assert s["migrated_slots"] == 0 and s["kv_imports_staged"] == 0


@pytest.mark.parametrize("prefill", NAMES)
def test_routed_disaggregation(fleet, prefill):
    """A long prompt's prefill runs on one package, its held KV ships to
    the other, which decodes: the stream equals the prefill backend's own
    unbroken run."""
    decode = NAMES[1 - NAMES.index(prefill)]
    body = {"tokens": prompt(20 + NAMES.index(prefill), 20),
            "max_new_tokens": 12}
    oracle = call(_url(fleet[prefill]), "/v1/generate", body)[2]["tokens"]
    fleet[prefill].pool, fleet[decode].pool = "prefill", "decode"
    router = _router(fleet, disagg_prompt_tokens=8)
    try:
        assert _tokens(stream_lines(_base(router), body)) == oracle
        disagg = router.stats()["disagg"]
        assert disagg["shipped"] == 1 and disagg["fell_back"] == 0
    finally:
        router.stop()
        for server in fleet.values():
            server.pool = "mixed"
    for server in fleet.values():
        s = server.engine.stats()
        assert s["kv_holds"] == 0 and s["kv_imports_staged"] == 0
