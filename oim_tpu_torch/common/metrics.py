"""Process metrics with Prometheus text exposition.

The port's own copy of the instrument half of ``oim_tpu/common/metrics.py``:
counters, gauges and histograms with labels, a per-process registry,
the text rendering (Prometheus exposition format 0.0.4), and the serving
families the engine and the server write, under the reference's series
names so that one scrape config and one set of queries covers both
packages.  The server's ``GET /metrics`` renders this registry
(``write_exposition``); ``MetricsServer`` is the standalone scrape
endpoint (``/metrics`` and the flight recorder's ``/debugz``), and
``install_process_metrics`` binds the ``oim_process_*`` self-telemetry.
The compile families (``oim_xla_compiles_total``,
``oim_xla_compile_seconds``) keep the reference's names and count what
stalls the port's live streams as an XLA compile stalls the
reference's: CUDA graph captures and kernel builds
(``serve/sentinel.py``).  The gRPC interceptor is the control plane's
(ROADMAP Queue A13).

Design notes:
- Metric instruments are cheap under concurrency: one lock per metric,
  plain dict of label-tuple → float.  No background threads.
- Label values are escaped per the exposition format (backslash, quote,
  newline).
- Registries are process-global: several engines in one process share
  the counters and histograms, and per-engine gauges carry an ``engine``
  label.
"""

from __future__ import annotations

import http.server
import socket
import threading
import time
from typing import Callable, Iterable

# ---------------------------------------------------------------------------
# Instruments


def _escape(value: str) -> str:
    return (
        value.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
    )


def _labels_key(
    names: tuple[str, ...], values: tuple[str, ...]
) -> tuple[str, ...]:
    if len(values) != len(names):
        raise ValueError(f"expected labels {names}, got {values}")
    return values


def _render_labels(names: tuple[str, ...], values: tuple[str, ...]) -> str:
    if not names:
        return ""
    inner = ",".join(
        f'{n}="{_escape(v)}"' for n, v in zip(names, values)
    )
    return "{" + inner + "}"


class Counter:
    """Monotonically increasing, optionally labelled."""

    kind = "counter"

    def __init__(self, name: str, help_: str, labels: tuple[str, ...] = ()):
        self.name = name
        self.help = help_
        self.label_names = labels
        self._lock = threading.Lock()
        self._values: dict[tuple[str, ...], float] = {}

    def inc(self, *label_values: str, by: float = 1.0) -> None:
        key = _labels_key(self.label_names, label_values)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + by

    def value(self, *label_values: str) -> float:
        with self._lock:
            return self._values.get(label_values, 0.0)

    def render(self) -> Iterable[str]:
        with self._lock:
            items = sorted(self._values.items())
        for values, count in items:
            yield (
                f"{self.name}{_render_labels(self.label_names, values)}"
                f" {_format_float(count)}"
            )


class Gauge:
    """Set-style instantaneous value."""

    kind = "gauge"

    def __init__(self, name: str, help_: str, labels: tuple[str, ...] = ()):
        self.name = name
        self.help = help_
        self.label_names = labels
        self._lock = threading.Lock()
        self._values: dict[tuple[str, ...], float] = {}
        self._callbacks: dict[tuple[str, ...], Callable[[], float]] = {}

    def set(self, value: float, *label_values: str) -> None:
        key = _labels_key(self.label_names, label_values)
        with self._lock:
            self._values[key] = float(value)

    def set_function(self, fn: Callable[[], float],
                     *label_values: str) -> None:
        """Read the series from ``fn()`` at each scrape."""
        key = _labels_key(self.label_names, label_values)
        with self._lock:
            self._callbacks[key] = fn

    def value(self, *label_values: str) -> float:
        with self._lock:
            cb = self._callbacks.get(label_values)
        if cb is not None:
            return float(cb())
        with self._lock:
            return self._values.get(label_values, 0.0)

    def render(self) -> Iterable[str]:
        with self._lock:
            items = dict(self._values)
            callbacks = dict(self._callbacks)
        for key, cb in callbacks.items():
            try:
                items[key] = float(cb())
            except Exception:
                continue  # a failing callback must not break the scrape
        for values, v in sorted(items.items()):
            yield (
                f"{self.name}{_render_labels(self.label_names, values)}"
                f" {_format_float(v)}"
            )


# Latency buckets suited to a control plane: 1ms .. 60s.
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 10.0, 30.0, 60.0,
)

# Sub-millisecond buckets for per-token latencies: 50µs .. 10s.
FAST_BUCKETS = (
    0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
    0.025, 0.05, 0.1, 0.25, 1.0, 2.5, 10.0,
)


class Histogram:
    """Cumulative-bucket histogram (the Prometheus shape)."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help_: str,
        labels: tuple[str, ...] = (),
        buckets: tuple[float, ...] = DEFAULT_BUCKETS,
    ):
        self.name = name
        self.help = help_
        self.label_names = labels
        self.buckets = tuple(sorted(buckets))
        self._lock = threading.Lock()
        # label values → (per-bucket counts, total count, sum)
        self._series: dict[tuple[str, ...], list] = {}

    def observe(self, value: float, *label_values: str) -> None:
        key = _labels_key(self.label_names, label_values)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = [[0] * len(self.buckets), 0, 0.0]
                self._series[key] = series
            counts, _, _ = series
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    counts[i] += 1
            series[1] += 1
            series[2] += value

    def count(self, *label_values: str) -> int:
        with self._lock:
            series = self._series.get(label_values)
            return series[1] if series else 0

    def render(self) -> Iterable[str]:
        with self._lock:
            items = sorted(
                (k, (list(v[0]), v[1], v[2])) for k, v in self._series.items()
            )
        for values, (counts, total, sum_) in items:
            for bound, count in zip(self.buckets, counts):
                labels = _render_labels(
                    self.label_names + ("le",),
                    values + (_format_float(bound),),
                )
                yield f"{self.name}_bucket{labels} {count}"
            inf_labels = _render_labels(
                self.label_names + ("le",), values + ("+Inf",)
            )
            yield f"{self.name}_bucket{inf_labels} {total}"
            plain = _render_labels(self.label_names, values)
            yield f"{self.name}_sum{plain} {_format_float(sum_)}"
            yield f"{self.name}_count{plain} {total}"


def _format_float(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


# ---------------------------------------------------------------------------
# Registry


class MetricsRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def register(self, metric):
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                return existing  # idempotent by name (shared instruments)
            self._metrics[metric.name] = metric
            return metric

    def counter(self, name, help_, labels=()):
        return self.register(Counter(name, help_, labels))

    def gauge(self, name, help_, labels=()):
        return self.register(Gauge(name, help_, labels))

    def histogram(self, name, help_, labels=(), buckets=DEFAULT_BUCKETS):
        return self.register(Histogram(name, help_, labels, buckets))

    def render(self) -> str:
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        lines: list[str] = []
        for metric in metrics:
            lines.append(f"# HELP {metric.name} {metric.help}")
            lines.append(f"# TYPE {metric.name} {metric.kind}")
            lines.extend(metric.render())
        return "\n".join(lines) + "\n"


_registry = MetricsRegistry()

# The Prometheus text exposition's content type (format 0.0.4).
EXPOSITION_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def registry() -> MetricsRegistry:
    return _registry


# ---------------------------------------------------------------------------
# Serving instruments, the engine's: shared definitions, so that every
# engine in the fleet (of either package) exports one series shape.

SERVE_REQUESTS = _registry.counter(
    "oim_serve_requests_total",
    "Generation requests by outcome: completed, rejected at submission "
    "(malformed, shed, draining or failed engine), or the kind a "
    "request failed with (cancelled, deadline, deadline_queue, "
    "migrated, aborted, stalled).",
    ("outcome",),
)
SERVE_TOKENS = _registry.counter(
    "oim_serve_tokens_total", "Tokens generated (after truncation).",
)
SERVE_STALLS = _registry.counter(
    "oim_serve_stalls_total",
    "Decode stalls detected by the driver-side watchdog: a dispatched "
    "chunk exceeded a multiple of its EWMA wall time (device hang / XLA "
    "wedge).  Each one failed the in-flight requests fast and flipped "
    "/healthz unhealthy.",
    ("engine",),
)
SERVE_SHED = _registry.counter(
    "oim_serve_shed_total",
    "Requests shed (or clamped) by overload protection, by reason: "
    "queue_full = admission queue at capacity (HTTP 429), deadline = "
    "request deadline expired before it touched a slot, brownout = "
    "max_tokens clamped under sustained queue pressure (served, not "
    "rejected), quota = router-side per-tenant rate/token bucket "
    "exhausted (HTTP 429 with a per-tenant Retry-After; the tenant "
    "breakdown lives in oim_serve_qos_total).",
    ("reason",),
)
SERVE_DEADLINE_EXPIRED = _registry.counter(
    "oim_serve_deadline_expired_total",
    "Requests failed because their deadline expired — shed from the "
    "admission queue or reaped mid-decode (slot freed at the next "
    "pipeline boundary).",
)

# Per-tenant SLO attribution: the engine's phase clock (queue → admit →
# prefill → decode → stream) keyed by the tenant the HTTP layer hands in
# with each request ("anon" without one).  The phases partition the
# request's submit-to-finalize window.

SERVE_QUEUE_WAIT = _registry.histogram(
    "oim_serve_queue_wait_seconds",
    "Submit-to-admission wait per request, by tenant CN: time spent in "
    "the admission queue before a slot opened.  The growing phase under "
    "fleet saturation — compare with oim_serve_prefill_seconds to split "
    "'engine is busy' from 'prefill is slow'.",
    ("tenant",),
)
SERVE_PREFILL = _registry.histogram(
    "oim_serve_prefill_seconds",
    "Prefill latency per request, by tenant CN: first device dispatch "
    "(prefix-cache injection / chunked-prefill segments included) to "
    "first-token readback.  Scales with prompt length; the phase the "
    "prefill/decode disaggregation split will move off decode backends.",
    ("tenant",),
)
SERVE_TPOT = _registry.histogram(
    "oim_serve_tpot_seconds",
    "Time per output token after the first, by tenant CN (decode-phase "
    "wall over tokens-1) — the streaming cadence a client experiences "
    "once tokens flow, vs oim_serve_ttft_seconds for the wait before "
    "them.  Sub-chunk-wall on a healthy chip, so FAST_BUCKETS.",
    ("tenant",),
    buckets=FAST_BUCKETS,
)
SERVE_E2E = _registry.histogram(
    "oim_serve_e2e_seconds",
    "Submit-to-finalize latency per request, by tenant CN and outcome "
    "(ok / deadline / deadline_queue / cancelled / stalled / aborted).  "
    "The per-tenant SLO series; per-phase breakdowns for any slow "
    "request live in GET /debugz/requests and `oimctl requests`.",
    ("tenant", "outcome"),
    buckets=(0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
             300.0, 600.0),
)

# Multi-tenant QoS: the enforcement actions the policy takes, labelled
# by tenant tier (bounded cardinality), and the per-tenant generated
# tokens.

SERVE_QOS = _registry.counter(
    "oim_serve_qos_total",
    "QoS enforcement actions by tenant tier: admitted = an engine "
    "admission the fair-share scheduler granted, throttled = a request "
    "shed at the router by the tenant's rate/token bucket (shed reason "
    "quota), preempted = an admission that had to park a lower-tier "
    "victim to fit (labeled with the PREEMPTOR's tier), parked_victim "
    "= the other side of that preemption (labeled with the VICTIM's "
    "tier; the slot swaps to host RAM and restores later — never "
    "killed, see oim_serve_kv_tier_moves_total).",
    ("tenant_tier", "action"),
)
SERVE_TENANT_TOKENS = _registry.counter(
    "oim_serve_tenant_tokens_total",
    "Generated (output) tokens per tenant CN, counted at request "
    "finalize.  The consumption series behind token quotas and the "
    "ground truth a fair-share convergence check compares against "
    "policy weights.",
    ("tenant",),
)

# Live load, per engine (the ``engine`` label is the engine's index in
# its process).

SERVE_ACTIVE_SLOTS = _registry.gauge(
    "oim_serve_active_slots",
    "Slots currently decoding, per serving instance (engine label = "
    "in-process engine index, or the backend id in the autoscaler's "
    "fleet view).",
    ("engine",),
)
SERVE_QUEUE_DEPTH = _registry.gauge(
    "oim_serve_queue_depth",
    "Requests waiting for a slot, per serving instance (the admission "
    "backlog the autoscaler's utilization counts as busy work).",
    ("engine",),
)
SERVE_KV_BLOCKS = _registry.gauge(
    "oim_serve_kv_blocks",
    "Paged-KV pool occupancy by block state: free = allocatable now "
    "(the engine's real admission headroom — admissions defer, not "
    "crash, when a request's worst case exceeds it), used = held by at "
    "least one slot or prefix-cache entry, shared = aliased by more "
    "than one owner (HBM the fleet would otherwise hold in duplicate), "
    "host = resident in the host-RAM overflow tier (demoted prefix "
    "entries + parked slots — KV preserved beyond HBM, promoted back "
    "on a hit instead of recomputed).  Absent on dense (non-paged) "
    "engines; the host state is absent without --kv-host-bytes.",
    ("engine", "state"),
)

# Forensics: the request ring's evictions and the slow-request captures.

SERVE_REQUEST_RING_DROPPED = _registry.counter(
    "oim_serve_request_ring_dropped_total",
    "Completed requests whose forensic ring entry displaced the "
    "oldest entry (ring full) or was dropped outright.  A steadily "
    "rising rate means the --request-ring window is shorter than the "
    "incident-response lag and slow-request forensics will be missing "
    "their neighborhood; size the ring per doc/operations.md.",
    ("engine",),
)
SERVE_SLOW_CAPTURES = _registry.counter(
    "oim_serve_slow_captures_total",
    "Tail-latency auto-captures written to the flight dir, by trigger "
    "(e2e = absolute end-to-end threshold, tpot = marginal per-token "
    "EWMA multiple).  Each increment corresponds to one "
    "serve.slow_capture event naming the artifact path; captures are "
    "rate-limited, so this undercounts slow requests — it counts "
    "dumped artifacts.",
    ("engine", "trigger"),
)


# ---------------------------------------------------------------------------
# Compiles: CUDA graph captures and kernel builds (``serve/sentinel.py``)

XLA_COMPILES = _registry.counter(
    "oim_xla_compiles_total",
    "Compilations in this process that stall the device's work while "
    "they run: in the PyTorch port, CUDA graph captures and kernel "
    "builds, counted by the recompile sentinel (serve/sentinel.py, "
    "installed at daemon init).  The count is expected to plateau "
    "after warmup; any increase on a serving daemon after an engine "
    "armed also emits a serve.recompile flight-recorder event with the "
    "active request context.",
)
XLA_COMPILE_SECONDS = _registry.histogram(
    "oim_xla_compile_seconds",
    "Wall time of each compilation oim_xla_compiles_total counts (a "
    "graph capture, a kernel build).  A post-warmup observation is a "
    "stall of the live streams, not a latency curiosity.",
)

# ---------------------------------------------------------------------------
# Process self-telemetry

PROCESS_RSS = _registry.gauge(
    "oim_process_resident_bytes",
    "Resident set size of this daemon process (from /proc/self/statm; "
    "ru_maxrss high-water fallback where /proc is unavailable).  On a "
    "serving host this is dominated by host-tier KV and the runtime "
    "heap, NOT device memory — compare with the host tier's blocks to "
    "attribute growth.",
)
PROCESS_CPU_SECONDS = _registry.gauge(
    "oim_process_cpu_seconds",
    "Cumulative user+system CPU seconds consumed by this process "
    "(os.times).  Exposed as a gauge because the value is read, not "
    "accumulated, at scrape time; rate() over it still yields CPU "
    "utilisation.",
)
PROCESS_THREADS = _registry.gauge(
    "oim_process_threads",
    "Live Python threads in this process.  A serving daemon has a "
    "small, stable set (step thread, HTTP, streamers, watchdog); "
    "unbounded growth means a leaked per-request or per-capture "
    "thread.",
)
PROCESS_GC_PAUSE_SECONDS = _registry.counter(
    "oim_process_gc_pause_seconds_total",
    "Cumulative wall time spent inside CPython garbage collections "
    "(gc.callbacks start→stop).  GC pauses on the step thread are "
    "invisible to per-phase request tracing but show up as TPOT "
    "outliers — correlate spikes here with serve.slow_capture events.",
)
PROCESS_GC_COLLECTIONS = _registry.counter(
    "oim_process_gc_collections_total",
    "CPython garbage collections observed via gc.callbacks, by "
    "generation.",
    ("generation",),
)

_process_metrics_state = {"installed": False}
_process_metrics_lock = threading.Lock()


def install_process_metrics() -> bool:
    """Bind the ``oim_process_*`` gauges and GC counters to this process
    (RSS, CPU seconds, threads, GC pauses; stdlib only).  Idempotent:
    returns False when already installed.  ``MetricsServer.start``
    calls it too."""
    with _process_metrics_lock:
        if _process_metrics_state["installed"]:
            return False
        _process_metrics_state["installed"] = True

    import gc
    import os

    try:
        page = os.sysconf("SC_PAGE_SIZE")
    except (AttributeError, ValueError, OSError):
        page = 4096

    def _rss() -> float:
        try:
            with open("/proc/self/statm") as f:
                return float(int(f.read().split()[1]) * page)
        except (OSError, ValueError, IndexError):
            import resource

            # ru_maxrss is a KiB high-water mark: a ceiling, not the
            # current size.
            return float(
                resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)

    def _cpu() -> float:
        t = os.times()
        return float(t.user + t.system)

    PROCESS_RSS.set_function(_rss)
    PROCESS_CPU_SECONDS.set_function(_cpu)
    PROCESS_THREADS.set_function(lambda: float(threading.active_count()))

    # gc.callbacks run on the collecting thread with the GIL held, and one
    # collection's start and stop never interleave with another's: one
    # shared start slot is race-free.
    gc_t0 = [0.0]

    def _gc_callback(phase: str, info: dict) -> None:
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        elif phase == "stop":
            PROCESS_GC_PAUSE_SECONDS.inc(by=time.perf_counter() - gc_t0[0])
            PROCESS_GC_COLLECTIONS.inc(str(info.get("generation", "")))

    gc.callbacks.append(_gc_callback)
    return True


# ---------------------------------------------------------------------------
# /metrics over HTTP


def write_exposition(handler, registry_: MetricsRegistry | None = None) -> None:
    """Answer an ``http.server`` request ``handler`` with the registry's
    Prometheus text: the one scrape response, for ``MetricsServer`` and
    for a server that embeds ``/metrics`` in its own routes (oim-serve)."""
    body = (registry_ or _registry).render().encode()
    handler.send_response(200)
    handler.send_header("Content-Type", EXPOSITION_CONTENT_TYPE)
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def _split_host_port(address: str) -> tuple[str, str]:
    """``host:port`` → (host, port), IPv6-bracket-aware: ``[::1]:9090``
    gives ``::1``; a bare ``9090`` is an error (not all interfaces by
    accident); ``:9090`` keeps the empty host, all interfaces."""
    host, sep, port = address.rpartition(":")
    if not sep:
        raise ValueError(
            f"metrics address {address!r} must be host:port (':{address}' "
            "for all interfaces)")
    if host.startswith("[") and host.endswith("]"):
        host = host[1:-1]
    elif ":" in host:
        raise ValueError(
            f"IPv6 metrics address must be bracketed: '[{host}]:{port}'")
    if port and not port.isdigit():
        raise ValueError(f"metrics address {address!r} has non-numeric port")
    return host, port


class _MetricsHandler(http.server.BaseHTTPRequestHandler):
    """``GET /metrics`` (or ``/``) and ``GET /debugz`` of the registry
    its server names."""

    def do_GET(self):  # noqa: N802 (stdlib API)
        path = self.path.split("?", 1)[0]
        if path == "/debugz":
            # Imported here: events imports this module.
            import json

            from oim_tpu_torch.common import events

            body = json.dumps(events.snapshot()).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if path not in ("/", "/metrics"):
            self.send_error(404)
            return
        write_exposition(self, self.server.registry)

    def log_message(self, *args):  # quiet
        pass


class _V6Server(http.server.ThreadingHTTPServer):
    address_family = socket.AF_INET6


class MetricsServer:
    """A scrape endpoint of its own: ``GET /metrics`` on ``host:port``,
    and ``GET /debugz``, the flight recorder's rings as JSON."""

    def __init__(self, address: str = "127.0.0.1:0",
                 registry_: MetricsRegistry | None = None):
        host, port = _split_host_port(address)
        server_cls = (_V6Server if ":" in host
                      else http.server.ThreadingHTTPServer)
        self._httpd = server_cls((host, int(port or 0)), _MetricsHandler)
        self._httpd.registry = registry_ or _registry
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "MetricsServer":
        install_process_metrics()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
