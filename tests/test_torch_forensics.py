"""The operator's forensics and the daemon's init in the port, held
against the JAX package on the CPU.

- The recompile sentinel (``serve/sentinel.py``), as
  ``tests/test_perf_obs.py`` holds the reference's: silent across a warm
  engine's traffic; a capture reported in an armed process fires a
  ``serve.recompile`` WARNING with the engine's request context, and the
  compile counter, the histogram and ``stats()["recompiles"]`` move by
  it; a sibling's warmup fires nothing; an unwarmed engine armed by hand
  charges its first dispatch's captures to the request; kernel builds
  report through ``ops/_build.py``'s listeners.
- ``/debugz/profile``: 202, 409 while a capture runs, the status, a
  download whose tarball holds a Chrome trace, 404 before any capture,
  400 on a bad window, served while the error latch stands.
- ``MetricsServer`` (``/metrics``, ``/debugz``, 404, IPv6 addresses),
  ``install_process_metrics`` idempotent; the logger's levels; the crash
  hook dumps the rings and chains to the hooks it replaced.
- ``serve_main``: the new flags parse as the reference's (names,
  choices, defaults); a daemon started with ``--trace-file``,
  ``--log-level debug`` and ``--paged-kernel on`` writes spans the
  reference's ``tracing.load_jsonl`` reads (``serve.generate`` with the
  engine's phase spans under it) and serves ``oim_process_*``.
- The kernel switch: an engine with both kernels off gives the JAX
  engine's greedy tokens at depth 1 and 2 on both layouts; an
  unsupported geometry with a kernel on is refused at construction with
  the reference's message; ``info()``, ``stats()`` and ``load()`` report
  the path.
"""

import io
import json
import os
import re
import signal
import subprocess
import sys
import tarfile
import threading
import urllib.error
import urllib.request

import pytest

from oim_tpu.cli import serve_main as jax_serve_main
from oim_tpu.common import tracing as jax_tracing
from oim_tpu.serve import Engine as JaxEngine
from oim_tpu.serve import GenRequest as JaxRequest

from oim_tpu_torch import log
from oim_tpu_torch.cli import serve_main
from oim_tpu_torch.common import events, metrics
from oim_tpu_torch.ops import _build
from oim_tpu_torch.serve import sentinel
from oim_tpu_torch.serve.engine import Engine, GenRequest
from oim_tpu_torch.serve.server import ServeServer
from torch_cpu_threads import one_torch_thread  # noqa: F401
from torch_serve_http import call, jax_model, prompt, url, wait_until

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE = dict(n_slots=2, max_len=64, chunk=4, prompt_buckets=(8, 16, 32))

# Process-global, as a daemon installs it at init (idempotent).
sentinel.install()


@pytest.fixture(scope="module")
def model():
    return jax_model()


@pytest.fixture(scope="module")
def warm(model):
    """A warmed (so armed) port engine on the CPU."""
    _, _, tcfg, params = model
    engine = Engine(params, tcfg, **ENGINE, kv_block=8, device="cpu")
    return engine.warmup()


def _recompile_events(label=None) -> list:
    return [e for e in events.all_events() if e.kind == "serve.recompile"
            and (label is None or e.subject == label)]


def _traffic(engine) -> list[int]:
    rids = [engine.submit(GenRequest(tokens=prompt(s, n), max_new_tokens=6))
            for s, n in ((1, 5), (2, 12), (3, 20))]
    engine.run()
    return rids


# ---------------------------------------------------------------------------
# The recompile sentinel


def test_sentinel_silent_across_warm_traffic(warm):
    assert sentinel.installed() and sentinel.armed(warm)
    events.clear_all()
    before = warm.stats()["recompiles"]
    _traffic(warm)
    assert _recompile_events() == []
    assert warm.recompiles == warm.stats()["recompiles"] == before


def test_sentinel_fires_with_request_context(warm):
    """A capture in an armed process, after the engine's traffic left a
    decode context: the event names that phase and its requests, and
    every counter moves by one."""
    _traffic(warm)
    ctx = warm._sentinel_ctx
    assert ctx["phase"] in ("admit", "decode")
    events.clear_all()
    compiles = metrics.XLA_COMPILES.value()
    observed = metrics.XLA_COMPILE_SECONDS.count()
    before = warm.recompiles
    sentinel.report(0.25)
    (event,) = _recompile_events(warm._engine_label)
    assert event.severity == events.WARNING
    assert event.fields["phase"] == ctx["phase"]
    assert event.fields["rids"] == ctx["rids"]
    assert event.fields["duration_s"] == 0.25
    assert warm.recompiles == warm.stats()["recompiles"] == before + 1
    assert metrics.XLA_COMPILES.value() == compiles + 1
    assert metrics.XLA_COMPILE_SECONDS.count() == observed + 1


def test_kernel_builds_report_to_the_sentinel(warm):
    """``ops/_build.py::build`` hands a build's wall time to its
    listeners; the installed sentinel is one, so a build after warmup is
    a recompile too."""
    assert sentinel.report in _build.BUILD_LISTENERS
    events.clear_all()
    before = warm.recompiles
    for listener in list(_build.BUILD_LISTENERS):
        listener(1.5)
    assert warm.recompiles == before + 1
    assert _recompile_events(warm._engine_label)[0].fields[
        "duration_s"] == 1.5


def _capturing(engine, n: int) -> list:
    """Make ``engine``'s first graph capture report ``n`` captures to the
    sentinel (the CPU captures nothing), as the card's does at the first
    dispatch of an unwarmed engine; returns the reports' contexts."""
    seen = []

    def ensure():
        if not seen:
            for _ in range(n):
                seen.append(dict(engine._sentinel_ctx))
                sentinel.report(0.01)

    engine._ensure_graphs = ensure
    return seen


def test_sibling_warmup_fires_nothing(model, warm):
    """A second engine warming (and capturing) in an armed process: its
    captures are counted, charged to no one, and it arms itself."""
    _, _, tcfg, params = model
    sibling = Engine(params, tcfg, **ENGINE, device="cpu")
    seen = _capturing(sibling, 3)
    events.clear_all()
    before, compiles = warm.recompiles, metrics.XLA_COMPILES.value()
    sibling.warmup()
    assert len(seen) == 3 and sentinel.armed(sibling)
    assert _recompile_events() == [] and warm.recompiles == before
    assert metrics.XLA_COMPILES.value() == compiles + 3
    sentinel.disarm(sibling)


def test_unwarmed_engine_charges_first_dispatch_captures(model, warm):
    """An engine that skipped warmup, armed by hand, captures at its first
    dispatch: each capture fires with the request's admission context,
    and its ``recompiles`` moves by the number of captures."""
    _, _, tcfg, params = model
    cold = Engine(params, tcfg, **ENGINE, device="cpu")
    seen = _capturing(cold, 4)
    sentinel.arm(cold)
    events.clear_all()
    rid = cold.submit(GenRequest(tokens=prompt(4, 9), max_new_tokens=4))
    cold.run()
    assert cold.result(rid, timeout=0)
    fired = _recompile_events(cold._engine_label)
    assert len(fired) == len(seen) == 4 == cold.stats()["recompiles"]
    assert all(e.fields["phase"] == "admit" and e.fields["rids"] == (rid,)
               for e in fired)
    sentinel.disarm(cold)


# ---------------------------------------------------------------------------
# /debugz/profile


@pytest.fixture(scope="module")
def server(model, tmp_path_factory):
    _, _, tcfg, params = model
    flight = tmp_path_factory.mktemp("flight")
    old = os.environ.get("OIM_FLIGHT_DIR")
    os.environ["OIM_FLIGHT_DIR"] = str(flight)
    srv = ServeServer(Engine(params, tcfg, **ENGINE, device="cpu")).start()
    yield srv
    srv.stop()
    if old is None:
        os.environ.pop("OIM_FLIGHT_DIR", None)
    else:
        os.environ["OIM_FLIGHT_DIR"] = old


def _profile_doc(server) -> dict:
    return call(url(server), "/debugz/profile")[2]["profile"]


def test_profile_cycle(server):
    base = url(server)
    status, _, reply = call(base, "/debugz/profile?download=1")
    assert status == 404 and reply["profile"] is None
    assert call(base, "/debugz/profile", {"seconds": 0})[0] == 400
    status, _, reply = call(base, "/debugz/profile", {"seconds": 0.6})
    assert status == 202 and reply["profile"]["state"] == "running"
    # Traffic inside the window: the step thread's ops land in the trace.
    threading.Thread(target=call, args=(base, "/v1/generate", {
        "tokens": prompt(5, 8), "max_new_tokens": 8}), daemon=True).start()
    status, _, reply = call(base, "/debugz/profile", {"seconds": 1})
    assert status == 409 and reply["profile"]["state"] == "running"
    assert call(base, "/debugz/profile?download=1")[0] == 409
    assert wait_until(lambda: _profile_doc(server)["state"] != "running")
    doc = _profile_doc(server)
    assert doc["state"] == "done" and doc["tar_bytes"] > 0, doc
    start, end = doc["window_ts"]  # the window the tracer was on
    assert doc["init_s"] >= 0 and end - start >= 0.6 > 0 < start
    assert doc["dir"].startswith(events.flight_dir())
    status, headers, body = call(base, "/debugz/profile?download=1")
    assert status == 200 and headers["Content-Type"] == "application/gzip"
    with tarfile.open(fileobj=io.BytesIO(body), mode="r:gz") as tar:
        (member,) = [m for m in tar.getmembers()
                     if m.name.endswith("trace.json")]
        trace = json.loads(tar.extractfile(member).read())
    assert trace["traceEvents"]
    assert any(e.get("kind") == "serve.profile"
               for e in call(base, "/debugz")[2]["events"])


def test_profile_served_while_latched_and_clamped(server):
    """A standing error (a wedged backend) refuses generation but not a
    capture; a window shorter than 0.05 s is clamped up to it."""
    server.error = "stall: wedged"
    try:
        assert call(url(server), "/v1/generate",
                    {"tokens": [1, 2], "max_new_tokens": 2})[0] == 503
        status, _, reply = call(url(server), "/debugz/profile",
                                {"seconds": 0.001})
        assert status == 202 and reply["profile"]["seconds"] == 0.05
        assert wait_until(
            lambda: _profile_doc(server)["state"] == "done")
    finally:
        server.error = None


# ---------------------------------------------------------------------------
# MetricsServer, process metrics, the logger, the crash hook


def test_metrics_server_routes():
    srv = metrics.MetricsServer("127.0.0.1:0").start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        body = urllib.request.urlopen(base + "/metrics", timeout=5).read()
        assert b"oim_process_resident_bytes" in body
        assert b"oim_process_threads" in body
        assert b"oim_xla_compiles_total" in body
        doc = json.loads(urllib.request.urlopen(base + "/debugz",
                                                timeout=5).read())
        assert {"generated_at", "pid", "events"} <= doc.keys()
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(base + "/nope", timeout=5)
        assert err.value.code == 404
    finally:
        srv.stop()
    assert metrics.install_process_metrics() is False  # idempotent
    assert metrics.PROCESS_THREADS.value() >= 1
    assert metrics.PROCESS_RSS.value() > 0


def test_metrics_address_parsing_and_ipv6():
    split = metrics._split_host_port
    assert split("127.0.0.1:9090") == ("127.0.0.1", "9090")
    assert split(":9090") == ("", "9090")
    assert split("[::1]:9090") == ("::1", "9090")
    for bad in ("9090", "::1:9090", "host:port"):
        with pytest.raises(ValueError):
            split(bad)
    try:
        srv = metrics.MetricsServer("[::1]:0").start()
    except OSError:
        pytest.skip("IPv6 unavailable on this host")
    try:
        body = urllib.request.urlopen(f"http://[::1]:{srv.port}/metrics",
                                      timeout=5).read()
        assert b"# HELP" in body
    finally:
        srv.stop()


def test_logger_levels():
    out = io.StringIO()
    logger = log.SimpleLogger(threshold=log.Level.WARNING, out=out,
                              timestamps=False)
    logger.info("quiet")
    logger.with_fields(rid=3).warning("loud", n=1)
    assert out.getvalue() == "W loud n=1 rid=3\n"
    test_logger = log.TestLogger()
    with log.with_logger(test_logger), log.with_fields(req="a"):
        log.current().debug("inside")
    assert [(r.level, r.msg, r.fields) for r in test_logger.records] == [
        (log.Level.DEBUG, "inside", {"req": "a"})]
    assert log.current() is log.L()
    with pytest.raises(ValueError, match="invalid log level"):
        log.init_from_string("loud")
    with pytest.raises(SystemExit):
        log.NullLogger().fatal("bye")


def test_crash_hook_dumps_and_chains(tmp_path):
    """An uncaught exception on a thread dumps every ring into the hook's
    directory, then reaches the hook it replaced; uninstalling restores
    the old hooks."""
    chained = []
    old_sys, old_threading = sys.excepthook, threading.excepthook
    threading.excepthook = chained.append
    try:
        events.install_crash_hook(str(tmp_path))
        events.install_crash_hook(str(tmp_path))  # idempotent
        assert events.flight_dir() == str(tmp_path)

        def boom():
            raise RuntimeError("step thread died")

        thread = threading.Thread(target=boom)
        thread.start()
        thread.join(timeout=10)
        assert len(chained) == 1 and chained[0].exc_type is RuntimeError
        (dump,) = list(tmp_path.glob("oim-flight-*.json"))
        doc = json.loads(dump.read_text())
        crash = [e for e in doc["events"] if e["kind"] == "crash"]
        assert crash and "step thread died" in crash[-1]["fields"]["error"]
    finally:
        events.uninstall_crash_hook()
        threading.excepthook = old_threading
    assert sys.excepthook is old_sys
    assert events.flight_dir() != str(tmp_path)


# ---------------------------------------------------------------------------
# serve_main


NEW_FLAGS = ["--tokenizer-dir", "tok", "--http-tls", "--ca", "ca.crt",
             "--cert", "s.crt", "--key", "s.key", "--log-level", "debug",
             "--trace-file", "t.jsonl", "--paged-kernel", "off",
             "--prefill-kernel", "on"]
NEW_DESTS = ("tokenizer_dir", "http_tls", "ca", "cert", "key", "log_level",
             "trace_file", "paged_kernel", "prefill_kernel")


@pytest.mark.parametrize("argv", [[], NEW_FLAGS], ids=["defaults", "set"])
def test_new_flags_parse_like_the_reference(argv):
    parsers = (serve_main.build_parser(), jax_serve_main.build_parser())
    port, ref = (vars(p.parse_args(argv)) for p in parsers)
    assert {k: port[k] for k in NEW_DESTS} == {k: ref[k] for k in NEW_DESTS}
    actions = [{a.dest: a for a in p._actions} for p in parsers]
    for dest in NEW_DESTS:
        assert actions[0][dest].option_strings == \
            actions[1][dest].option_strings
        assert actions[0][dest].choices == actions[1][dest].choices


def test_serve_main_daemon_init(tmp_path):
    """A daemon on the CPU (heads of 64, which the kernel switch needs)
    with the reference's init: its trace file holds
    one ``serve.generate`` span a request with the engine's phase spans
    under it (read by the reference's loader), its log is at debug level,
    ``/metrics`` carries the process families, and ``/v1/info`` reports
    the kernel switch."""
    trace = tmp_path / "spans.jsonl"
    argv = [sys.executable, "-m", "oim_tpu_torch.cli.serve_main",
            "--device", "cpu", "--vocab-size", "101", "--d-model", "128",
            "--n-layers", "1", "--n-heads", "2", "--dtype", "float32",
            "--max-len", "64", "--n-slots", "2", "--chunk", "4",
            "--kv-block", "8", "--port", "0", "--watchdog-interval", "0",
            "--trace-file", str(trace), "--log-level", "debug",
            "--paged-kernel", "on", "--drain-timeout", "0"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               OIM_FLIGHT_DIR=str(tmp_path))
    proc = subprocess.Popen(argv, cwd=tmp_path, env=env,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    lines = []
    try:
        port = None
        for line in proc.stderr:
            lines.append(line)
            match = re.search(r"oim-serve listening .* port=(\d+)", line)
            if match:
                port = int(match.group(1))
                break
        assert port, "".join(lines)
        base = f"http://127.0.0.1:{port}"
        rids = []
        for seed in (1, 2):
            status, _, reply = call(base, "/v1/generate", {
                "tokens": prompt(seed, 6), "max_new_tokens": 4})
            assert status == 200
            rids.append(reply["request_id"])
        _, _, body = call(base, "/metrics")
        assert b"oim_process_resident_bytes" in body
        assert b"oim_process_gc_collections_total" in body
        _, _, info = call(base, "/v1/info")
        assert info["engine"]["paged_kernel"] is True
        assert info["engine"]["prefill_kernel"] is False  # auto on the CPU
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        lines += proc.stderr.readlines()
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        proc.stderr.close()
    text = "".join(lines)
    assert re.search(r" I warming up buckets=", text), text
    assert " I draining " in text and " I drained " in text
    spans = jax_tracing.load_jsonl([str(trace)])
    generate = [s for s in spans if s.name == "serve.generate"]
    assert len(generate) == 2
    for root in generate:
        request = [s for s in spans if s.name == "engine.request"
                   and s.parent_id == root.span_id]
        assert len(request) == 1 and request[0].trace_id == root.trace_id
        phases = {s.name for s in spans
                  if s.parent_id == request[0].span_id}
        assert {"engine.queue", "engine.prefill"} <= phases


# ---------------------------------------------------------------------------
# The kernel switch


def _greedy(engine, request) -> list:
    rids = [engine.submit(request(tokens=prompt(s, n), max_new_tokens=9))
            for s, n in ((11, 5), (12, 13), (13, 24))]
    engine.run()
    return [list(engine.result(rid, timeout=0)) for rid in rids]


_PAIRS: dict = {}


@pytest.mark.parametrize("kv_block", [0, 8], ids=["dense", "paged"])
@pytest.mark.parametrize("depth", [1, 2])
def test_kernels_off_match_jax_engine(model, kv_block, depth):
    jcfg, jparams, tcfg, params = model
    if kv_block not in _PAIRS:  # one pair a layout; depth set on both
        kw = dict(ENGINE, kv_block=kv_block)
        _PAIRS[kv_block] = (
            Engine(params, tcfg, **kw, device="cpu", paged_kernel=False,
                   prefill_kernel=False),
            JaxEngine(jparams, jcfg, **kw))
    off, ref = _PAIRS[kv_block]
    off.set_pipeline_depth(depth)
    ref.set_pipeline_depth(depth)
    assert _greedy(off, GenRequest) == _greedy(ref, JaxRequest)
    assert off.info()["engine"]["attention"] == "plain"


def test_unsupported_geometry_with_a_kernel_on_is_refused(model):
    """head_dim 16 has no kernel: with either switch on the engine is
    refused at construction, naming the switch and the way out; with
    both off it serves."""
    _, _, tcfg, params = model
    for name in ("paged_kernel", "prefill_kernel"):
        with pytest.raises(ValueError, match=re.escape(
                f"{name} needs head_dim in (64, 128)")) as err:
            Engine(params, tcfg, **ENGINE, kv_block=8, device="cpu",
                   **{name: True})
        flag = name.replace("_", "-")
        assert f"gather path ({name}=False / --{flag} off)" in str(err.value)
    Engine(params, tcfg, **ENGINE, kv_block=8, device="cpu",
           paged_kernel=False, prefill_kernel=False)


def test_the_path_is_reported(model):
    _, _, tcfg, params = model
    mixed = Engine(params, tcfg, **ENGINE, device="cpu", paged_kernel=False)
    for view in (mixed.info()["engine"], mixed.stats(), mixed.load()):
        assert view["paged_kernel"] is False
        assert view["prefill_kernel"] is False  # auto: off on the CPU
    assert mixed.stats()["recompiles"] == 0
