"""Spans and W3C trace context for the port's serving path.

The port's own copy of the span half of ``oim_tpu/common/tracing.py``:
``SpanContext`` travels as a W3C ``traceparent``
(``00-<32 hex trace-id>-<16 hex span-id>-01``), so one trace id links a
router's span, the server's and the engine's per-request phase spans;
spans land in a per-process in-memory ring and, when configured, an
append-only JSONL file in the reference's format, which ``oimctl trace``
merges across processes.  The gRPC interceptors are not here (the port
has no gRPC plane).

Python's ``contextvars`` carries the active span, so ``start_span``
blocks nest with no explicit plumbing.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import secrets
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Iterator

from oim_tpu_torch.common import metrics

TRACEPARENT_KEY = "traceparent"

# Ring evictions: a long-lived process's collector is bounded
# (drop-oldest), and the counter makes the loss visible per component.
SPANS_DROPPED = metrics.registry().counter(
    "oim_trace_spans_dropped_total",
    "Spans evicted from a full collector ring (drop-oldest).",
    ("component",),
)

# ---------------------------------------------------------------------------
# Span model + context propagation


@dataclass(frozen=True)
class SpanContext:
    trace_id: str  # 32 hex chars
    span_id: str  # 16 hex chars

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"


def parse_traceparent(value: str) -> SpanContext | None:
    """Parse a W3C traceparent; None for anything malformed (a bad peer
    header must never break the request it rode in on)."""
    parts = value.split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, _flags = parts
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return SpanContext(trace_id, span_id)


@dataclass
class Span:
    trace_id: str
    span_id: str
    parent_id: str  # "" for a root span
    name: str  # operation, e.g. "engine.request"
    component: str  # process/service, e.g. "oim-serve"
    start_ns: int
    end_ns: int = 0
    status: str = "ok"
    attrs: dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "component": self.component,
            "start_ns": self.start_ns,
            "end_ns": self.end_ns,
            "status": self.status,
            "attrs": self.attrs,
        }


_current: contextvars.ContextVar[SpanContext | None] = contextvars.ContextVar(
    "oim_tpu_torch_span", default=None
)


def current_context() -> SpanContext | None:
    return _current.get()


# ---------------------------------------------------------------------------
# Collector


class Collector:
    """Per-process span sink: bounded in-memory ring + optional JSONL file.

    The ring makes every process introspectable without configuration
    (tests, embedders); the file is the cross-process story — one file
    per process, merged offline.
    """

    def __init__(self, component: str = "", path: str | None = None,
                 capacity: int = 4096) -> None:
        self.component = component
        self._lock = threading.Lock()
        self._ring: deque[Span] = deque(maxlen=capacity)
        self._file = open(path, "a", buffering=1) if path else None

    def record(self, span: Span) -> None:
        # Serialize outside the lock: only the ring append and the write
        # need the mutex.
        line = json.dumps(span.to_json()) + "\n" if self._file else None
        with self._lock:
            dropped = len(self._ring) == self._ring.maxlen
            self._ring.append(span)
            if self._file is not None and line is not None:
                self._file.write(line)
        if dropped:
            SPANS_DROPPED.inc(self.component)

    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


_collector = Collector()


def init(component: str = "", path: str | None = None) -> Collector:
    """Configure the process collector (``$OIM_TRACE_FILE`` when no
    ``path`` is given)."""
    global _collector
    old = _collector
    path = path or os.environ.get("OIM_TRACE_FILE") or None
    _collector = Collector(component=component, path=path)
    old.close()
    return _collector


def collector() -> Collector:
    return _collector


# ---------------------------------------------------------------------------
# Span creation


def _new_trace_id() -> str:
    return secrets.token_hex(16)


def _new_span_id() -> str:
    return secrets.token_hex(8)


def new_trace_id() -> str:
    """Public id mint for callers recording spans manually."""
    return _new_trace_id()


def record_span(
    name: str,
    *,
    component: str = "",
    trace_id: str = "",
    parent_id: str = "",
    start_ns: int,
    end_ns: int,
    status: str = "ok",
    **attrs: Any,
) -> Span:
    """Record one already-measured interval as a span.

    The engine's phase spans (queue, admit, prefill, decode, stream)
    begin and end across step-loop iterations, so they are rebuilt after
    the fact from their recorded boundaries and handed in whole here.
    An empty ``trace_id`` mints a fresh trace (the span becomes a
    root)."""
    span = Span(
        trace_id=trace_id or _new_trace_id(),
        span_id=_new_span_id(),
        parent_id=parent_id,
        name=name,
        component=component or _collector.component,
        start_ns=start_ns,
        end_ns=end_ns,
        status=status,
        attrs=dict(attrs),
    )
    _collector.record(span)
    return span


@contextlib.contextmanager
def start_span(
    name: str,
    component: str = "",
    parent: SpanContext | None = None,
    **attrs: Any,
) -> Iterator[Span]:
    """Open a span as a child of ``parent`` (default: the context span,
    else a new root), make it current for the block, record on exit.
    An exception marks status=error and re-raises."""
    parent = parent if parent is not None else _current.get()
    trace_id = parent.trace_id if parent else _new_trace_id()
    span = Span(
        trace_id=trace_id,
        span_id=_new_span_id(),
        parent_id=parent.span_id if parent else "",
        name=name,
        component=component or _collector.component,
        start_ns=time.time_ns(),
        attrs=dict(attrs),
    )
    token = _current.set(SpanContext(trace_id, span.span_id))
    try:
        yield span
    except BaseException as exc:
        span.status = f"error: {type(exc).__name__}"
        raise
    finally:
        _current.reset(token)
        span.end_ns = time.time_ns()
        _collector.record(span)
