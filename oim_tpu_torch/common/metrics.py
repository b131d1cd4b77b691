"""Process metrics with Prometheus text exposition.

The port's own copy of the instrument half of ``oim_tpu/common/metrics.py``:
counters, gauges and histograms with labels, a per-process registry,
the text rendering (Prometheus exposition format 0.0.4), and the serving
families the engine and the server write, under the reference's series
names so that one scrape config and one set of queries covers both
packages.  The server's ``GET /metrics`` renders this registry
(``EXPOSITION_CONTENT_TYPE``).  The standalone ``MetricsServer``, the
gRPC interceptor and the process self-telemetry are not here (ROADMAP
Queue A11, second part).

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

import threading
from typing import Iterable

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

    def set(self, value: float, *label_values: str) -> None:
        key = _labels_key(self.label_names, label_values)
        with self._lock:
            self._values[key] = float(value)

    def value(self, *label_values: str) -> float:
        with self._lock:
            return self._values.get(label_values, 0.0)

    def render(self) -> Iterable[str]:
        with self._lock:
            items = dict(self._values)
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
