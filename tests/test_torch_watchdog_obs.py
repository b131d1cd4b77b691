"""The stall watchdog, the observation routes and ``serve_main``'s fleet
flags and shutdown, on the CPU.

- ``StallWatchdog``'s verdicts (the reference's logic: none before the
  first chunk, one past ``max(floor, multiplier × EWMA)``, latched, and
  cleared when the wait returns), and on a live server: a wedged device
  wait fails the in-flight request with 503, kind "stalled", and
  ``Retry-After``, ``/healthz`` reads 503 and then 200 once the wait
  returns, and ``oim_serve_stalls_total`` and a ``serve.stall`` ERROR
  event record it;
- ``/metrics``, ``/debugz``, ``/debugz/requests`` and ``/v1/info``'s
  ``load`` against a JAX server on the same traffic, as deltas and keys;
- ``serve_main``'s new flags parse to the reference's values;
- a ``serve_main`` process that gets SIGTERM mid-stream: the stream ends
  in its migrate line and the process exits 0 within ``--drain-timeout``.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from oim_tpu.cli import serve_main as jax_serve_main
from oim_tpu.serve import Engine as JaxEngine
from oim_tpu.serve.server import ServeServer as JaxServer

from oim_tpu_torch.cli import serve_main
from oim_tpu_torch.common import events, metrics
from oim_tpu_torch.serve.engine import Engine
from oim_tpu_torch.serve.server import ServeServer, StallWatchdog
from torch_cpu_threads import one_torch_thread  # noqa: F401
from torch_serve_http import call, jax_model, prompt, url, wait_until

ENGINE = dict(n_slots=2, max_len=64, chunk=4, prompt_buckets=(8, 16, 32),
              kv_block=8)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _FakeEngine:
    _engine_label = "fake-watchdog"

    def __init__(self):
        self.wait = None
        self.ewma = None

    def watchdog_state(self):
        return (self.wait, self.ewma)


def test_watchdog_verdict_logic():
    fake = _FakeEngine()
    stalls, clears = [], []
    wd = StallWatchdog(fake, on_stall=stalls.append,
                       on_clear=lambda: clears.append(1), multiplier=4.0,
                       floor_s=1.0)
    before = metrics.SERVE_STALLS.value(fake._engine_label)
    fake.wait = 100.0  # a long wait before any chunk: no verdict
    assert wd.check() is False
    fake.ewma, fake.wait = 0.1, 0.5  # under the 1 s floor
    assert wd.check() is False
    fake.wait = 1.5  # past the floor and 4 × EWMA
    assert wd.check() is True
    assert len(stalls) == 1 and "decode stall" in stalls[0]
    assert wd.check() is True and len(stalls) == 1  # latched
    assert metrics.SERVE_STALLS.value(fake._engine_label) == before + 1
    fake.wait = None  # the wedged wait returned
    assert wd.check() is False and clears == [1]
    fake.ewma, fake.wait = 10.0, 20.0  # slow but under 4 × EWMA
    assert wd.check() is False
    for bad in (dict(interval=0), dict(multiplier=0), dict(floor_s=0)):
        with pytest.raises(ValueError):
            StallWatchdog(fake, on_stall=stalls.append, **bad)


@pytest.fixture(scope="module")
def model():
    return jax_model()


def test_stall_fails_inflight_and_flips_healthz(model):
    _, _, tcfg, params = model
    engine = Engine(params, tcfg, **ENGINE, device="cpu")
    server = ServeServer(engine, watchdog_interval=0.05,
                         stall_multiplier=2.0, stall_floor_s=0.2).start()
    base = url(server)
    wedged, release = threading.Event(), threading.Event()
    begin = engine._watch_begin

    def wedge():  # the device wait that does not return
        begin()
        wedged.set()
        release.wait(30)

    try:
        # A chunk read back first: the watchdog has its EWMA.
        assert call(base, "/v1/generate", {"tokens": prompt(1, 6),
                                           "max_new_tokens": 8})[0] == 200
        stalls = metrics.SERVE_STALLS.value(engine._engine_label)
        engine._watch_begin = wedge
        result = []
        thread = threading.Thread(target=lambda: result.append(call(
            base, "/v1/generate", {"tokens": prompt(2, 6),
                                   "max_new_tokens": 8})), daemon=True)
        thread.start()
        assert wedged.wait(10)
        thread.join(10)
        status, headers, reply = result[0]
        assert status == 503 and "stall" in reply["error"]
        assert int(headers["Retry-After"]) >= 1
        assert metrics.SERVE_STALLS.value(engine._engine_label) == stalls + 1
        assert any(e["kind"] == "serve.stall" and e["severity"] == "ERROR"
                   for e in events.snapshot()["events"])
        assert call(base, "/healthz")[0] == 503
        assert call(base, "/v1/generate", {"tokens": [1]})[0] == 503
        del engine._watch_begin
        release.set()
        assert wait_until(lambda: call(base, "/healthz")[0] == 200, 10)
        status, _, reply = call(base, "/v1/generate",
                                {"tokens": prompt(3, 6), "max_new_tokens": 4})
        assert status == 200 and len(reply["tokens"]) == 4
    finally:
        release.set()
        server.stop()


def _families(text: str) -> dict:
    """Prometheus text → {series with labels: value}; every line is a
    comment or ``name{labels} value`` (the parse fails loudly
    otherwise)."""
    series = {}
    for line in text.splitlines():
        if not line or line.startswith("# HELP ") or line.startswith(
                "# TYPE "):
            continue
        match = re.fullmatch(r'([a-zA-Z_:][\w:]*(?:\{[^}]*\})?) (\S+)', line)
        assert match, f"not exposition text: {line!r}"
        series[match.group(1)] = float(match.group(2))
    return series


def _scrape(server) -> tuple[dict, str]:
    status, headers, body = call(url(server), "/metrics")
    assert status == 200 and headers["Content-Type"].startswith(
        "text/plain; version=0.0.4")
    return _families(body.decode()), body.decode()


TRAFFIC = [dict(tokens=prompt(10 + i, 6 + 4 * i), max_new_tokens=5 + i)
           for i in range(3)]


def test_observation_routes_match_jax(model):
    jcfg, jparams, tcfg, params = model
    servers = {"jax": JaxServer(JaxEngine(jparams, jcfg, **ENGINE)).start(),
               "port": ServeServer(Engine(params, tcfg, **ENGINE,
                                          device="cpu")).start()}
    try:
        before = {n: _scrape(s)[0] for n, s in servers.items()}
        rids = {n: [call(url(s), "/v1/generate", b)[2]["request_id"]
                    for b in TRAFFIC] for n, s in servers.items()}
        after = {n: _scrape(s) for n, s in servers.items()}
        for name in servers:
            done = 'oim_serve_requests_total{outcome="completed"}'
            tokens = "oim_serve_tokens_total"
            series = after[name][0]
            assert series[done] - before[name].get(done, 0.0) == 3
            assert series[tokens] - before[name].get(tokens, 0.0) == 18
        for family in ("oim_serve_requests_total", "oim_serve_shed_total",
                       "oim_serve_e2e_seconds", "oim_serve_active_slots",
                       "oim_serve_kv_blocks", "oim_serve_stalls_total",
                       "oim_checkpoint_seconds",
                       "oim_checkpoint_bytes_total"):
            assert f"# TYPE {family} " in after["port"][1], family
        for name, server in servers.items():  # finalized after the reply
            assert wait_until(lambda: set(rids[name]) <= {
                e["rid"] for e in server.engine.requests()["requests"]})
        docs = {n: {p: call(url(s), p)[2] for p in (
            "/debugz", "/debugz/requests", "/v1/info")}
            for n, s in servers.items()}
        for path in ("/debugz", "/debugz/requests", "/v1/info"):
            assert docs["port"][path].keys() == docs["jax"][path].keys(), path
        ring = {n: {e["rid"]: e for e in docs[n]["/debugz/requests"][
            "requests"]} for n in servers}
        for name in servers:
            assert all(ring[name][rid]["outcome"] == "ok"
                       for rid in rids[name])
        assert set(ring["port"][rids["port"][0]]) == set(
            ring["jax"][rids["jax"][0]])
        info = docs["port"]["/v1/info"]
        assert info["pool"] == "mixed" and info["load"]["pool"] == "mixed"
        load = dict(servers["port"].engine.load(), pool="mixed")
        assert {k: v for k, v in info["load"].items() if k != "ts"} == {
            k: v for k, v in load.items() if k != "ts"}
        assert info["load"].keys() == docs["jax"]["/v1/info"]["load"].keys()
    finally:
        for server in servers.values():
            server.stop()


NEW_FLAGS = ["--params-peer", "http://peer:1", "--prefix-prewarm", "2",
             "--pool", "decode", "--drain-timeout", "7",
             "--watchdog-interval", "0.5", "--stall-multiplier", "3",
             "--stall-floor", "4", "--no-warmup", "--warmup-embed"]
NEW_DESTS = ("params_peer", "prefix_prewarm", "pool", "drain_timeout",
             "watchdog_interval", "stall_multiplier", "stall_floor",
             "no_warmup", "warmup_embed")


@pytest.mark.parametrize("argv", [[], NEW_FLAGS], ids=["defaults", "set"])
def test_serve_main_flags_parse_like_the_reference(argv):
    port = vars(serve_main.build_parser().parse_args(argv))
    ref = vars(jax_serve_main.build_parser().parse_args(argv))
    assert {k: port[k] for k in NEW_DESTS} == {k: ref[k] for k in NEW_DESTS}


def test_serve_main_sigterm_drains_by_migration(tmp_path):
    argv = [sys.executable, "-m", "oim_tpu_torch.cli.serve_main",
            "--device", "cpu", "--vocab-size", "101", "--d-model", "32",
            "--n-layers", "1", "--n-heads", "2", "--dtype", "float32",
            "--max-len", "2048", "--n-slots", "1", "--chunk", "4",
            "--kv-block", "16", "--port", "0", "--no-warmup",
            "--drain-timeout", "5", "--watchdog-interval", "0"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(argv, cwd=tmp_path, env=env,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        port = None
        for line in proc.stderr:
            match = re.search(r"oim-serve listening .* port=(\d+)", line)
            if match:
                port = int(match.group(1))
                break
        assert port, "serve_main never listened"
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/generate",
            json.dumps({"tokens": [1, 2, 3], "max_new_tokens": 2000,
                        "stream": True}).encode())
        lines = []
        with urllib.request.urlopen(req, timeout=60) as resp:
            for raw in resp:
                lines.append(json.loads(raw))
                if len(lines) == 4:
                    t0 = time.monotonic()
                    proc.send_signal(signal.SIGTERM)
        assert lines[-1].get("migrate") is True, lines[-1]
        assert 4 <= sum("token" in ln for ln in lines) < 2000
        assert proc.wait(timeout=5 + 2 + 5) == 0
        assert time.monotonic() - t0 < 5 + 2 + 5
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        proc.stderr.close()
