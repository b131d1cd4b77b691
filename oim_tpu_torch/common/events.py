"""Flight recorder: a structured, trace-correlated event journal.

The port's own copy of the recorder half of ``oim_tpu/common/events.py``.
Every event carries ``component`` (the emitting process), ``kind`` (a
dotted vocabulary, e.g. ``qos.preempt`` / ``serve.slow_capture``),
``severity``, ``subject`` (what it is about), the ``trace_id`` of the
active span (so events join the trace tree), a per-recorder monotonic
``seq``, wall-clock ``ts`` and free-form ``fields``.  One bounded ring
per component (drop-oldest, counted); sinks run outside the ring lock,
and a failing sink costs one log line, never the caller.  ``snapshot``
is the reference's ``/debugz`` document shape.

``install_crash_hook`` dumps every ring to a JSON file in the flight
dir on an uncaught exception on any thread (``dump``, at
``crash_dump_path``), then chains to the hooks it replaced; the
on-demand profiler and the slow captures write there too
(``flight_dir``: the hook's directory, else ``$OIM_FLIGHT_DIR``, else
the temporary directory).

Not here: the registry publisher and the volume-lifecycle helpers (the
control plane's; ROADMAP Queue A13/A16).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import tempfile
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

from oim_tpu_torch import log
from oim_tpu_torch.common import metrics, tracing

_log = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# Vocabulary

DEBUG = "DEBUG"
INFO = "INFO"
WARNING = "WARNING"
ERROR = "ERROR"

DEFAULT_CAPACITY = 512

# ---------------------------------------------------------------------------
# Instruments (process registry — every process exports identical series)

EVENTS_TOTAL = metrics.registry().counter(
    "oim_events_total",
    "Flight-recorder events emitted, by component, kind and severity.",
    ("component", "kind", "severity"),
)
EVENTS_DROPPED = metrics.registry().counter(
    "oim_events_dropped_total",
    "Events evicted from a full flight-recorder ring (drop-oldest).",
    ("component",),
)


# ---------------------------------------------------------------------------
# Event model


@dataclass(frozen=True)
class Event:
    component: str
    kind: str
    severity: str
    subject: str
    trace_id: str
    seq: int
    ts: float  # wall clock (UNIX seconds)
    fields: dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> dict[str, Any]:
        return {
            "component": self.component,
            "kind": self.kind,
            "severity": self.severity,
            "subject": self.subject,
            "trace_id": self.trace_id,
            "seq": self.seq,
            "ts": self.ts,
            "fields": self.fields,
        }


# ---------------------------------------------------------------------------
# Recorders

_sinks_lock = threading.Lock()
_sinks: list[Callable[[Event], None]] = []


class FlightRecorder:
    """Bounded per-component event ring (the "flight recorder")."""

    def __init__(self, component: str, capacity: int = DEFAULT_CAPACITY):
        self.component = component
        self._lock = threading.Lock()
        self._ring: deque[Event] = deque(maxlen=capacity)
        self._seq = 0

    def emit(
        self,
        kind: str,
        severity: str = INFO,
        subject: str = "",
        **fields: Any,
    ) -> Event:
        ctx = tracing.current_context()
        with self._lock:
            self._seq += 1
            event = Event(
                component=self.component,
                kind=kind,
                severity=severity,
                subject=subject,
                trace_id=ctx.trace_id if ctx is not None else "",
                seq=self._seq,
                ts=time.time(),
                fields=fields,
            )
            dropped = len(self._ring) == self._ring.maxlen
            self._ring.append(event)
        EVENTS_TOTAL.inc(self.component, kind, severity)
        if dropped:
            EVENTS_DROPPED.inc(self.component)
        with _sinks_lock:
            sinks = list(_sinks)
        for sink in sinks:  # outside the ring lock: sinks may do IO
            try:
                sink(event)
            except Exception as exc:
                _log.error("event sink failed: kind=%s error=%s", kind, exc)
        return event

    def events(self) -> list[Event]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


_recorders_lock = threading.Lock()
_recorders: dict[str, FlightRecorder] = {}
_default_component = [""]


def recorder(component: str = "") -> FlightRecorder:
    """The process recorder for ``component`` (created on first use).
    Empty means the process default set by ``init()``."""
    name = component or _default_component[0]
    with _recorders_lock:
        rec = _recorders.get(name)
        if rec is None:
            rec = _recorders[name] = FlightRecorder(name)
        return rec


def init(component: str) -> FlightRecorder:
    """Set the process-default component and return its recorder."""
    _default_component[0] = component
    return recorder(component)


def emit(
    kind: str,
    component: str = "",
    severity: str = INFO,
    subject: str = "",
    **fields: Any,
) -> Event:
    """Emit on the component's recorder (default: the process default)."""
    return recorder(component).emit(kind, severity=severity, subject=subject,
                                     **fields)


def add_sink(fn: Callable[[Event], None]) -> None:
    with _sinks_lock:
        if fn not in _sinks:
            _sinks.append(fn)


def remove_sink(fn: Callable[[Event], None]) -> None:
    with _sinks_lock:
        if fn in _sinks:
            _sinks.remove(fn)


def all_events() -> list[Event]:
    """Every recorder's ring, merged in wall-clock order."""
    with _recorders_lock:
        recs = list(_recorders.values())
    merged: list[Event] = []
    for rec in recs:
        merged.extend(rec.events())
    merged.sort(key=lambda e: (e.ts, e.component, e.seq))
    return merged


def clear_all() -> None:
    """Empty every ring (test isolation; recorders stay registered)."""
    with _recorders_lock:
        recs = list(_recorders.values())
    for rec in recs:
        rec.clear()


def snapshot() -> dict[str, Any]:
    """The live flight-recorder contents as one JSON document (the
    reference's ``/debugz`` shape)."""
    return {
        "generated_at": time.time(),
        "pid": os.getpid(),
        "events": [e.to_json() for e in all_events()],
    }


def dump(path: str) -> str:
    """Write the snapshot to ``path`` (a temporary file, then a rename)."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(snapshot(), f, separators=(",", ":"))
    os.replace(tmp, path)
    return path


# ---------------------------------------------------------------------------
# Crash hook

_crash_lock = threading.Lock()
_crash_state: dict[str, Any] = {"installed": False, "dir": "", "prev": None,
                                "prev_threading": None}


def flight_dir() -> str:
    """The directory for forensic artifacts (crash dumps, slow-request
    captures, profiler traces): the crash hook's directory, else
    ``$OIM_FLIGHT_DIR``, else the temporary directory."""
    return (_crash_state["dir"] or os.environ.get("OIM_FLIGHT_DIR")
            or tempfile.gettempdir())


def crash_dump_path() -> str:
    return os.path.join(
        flight_dir(), f"oim-flight-{os.getpid()}-{int(time.time())}.json")


def _dump_on_crash(exc_type, exc_value) -> str | None:
    if exc_type is not None and issubclass(
            exc_type, (KeyboardInterrupt, SystemExit)):
        return None  # an operator's stop, not a crash
    try:
        emit("crash", severity=ERROR,
             error=f"{getattr(exc_type, '__name__', exc_type)}: {exc_value}")
        path = dump(crash_dump_path())
        log.current().error("flight recorder dumped", path=path)
        return path
    except Exception:
        return None  # the dump never masks the crash itself


def install_crash_hook(directory: str = "") -> None:
    """Dump every ring to a JSON file on an uncaught exception (the main
    thread's and every other thread's), then chain to the previous
    hooks.  ``directory`` defaults to ``$OIM_FLIGHT_DIR`` or the
    temporary directory.  Idempotent."""
    with _crash_lock:
        if directory:
            _crash_state["dir"] = directory
        if _crash_state["installed"]:
            return
        prev_sys, prev_threading = sys.excepthook, threading.excepthook
        _crash_state["prev"] = prev_sys
        _crash_state["prev_threading"] = prev_threading

        def hook(exc_type, exc_value, exc_tb):
            _dump_on_crash(exc_type, exc_value)
            prev_sys(exc_type, exc_value, exc_tb)

        def thread_hook(args):
            _dump_on_crash(args.exc_type, args.exc_value)
            prev_threading(args)

        sys.excepthook = hook
        threading.excepthook = thread_hook
        _crash_state["installed"] = True


def uninstall_crash_hook() -> None:
    """Restore the hooks ``install_crash_hook`` replaced, and forget its
    directory."""
    with _crash_lock:
        _crash_state["dir"] = ""
        if not _crash_state["installed"]:
            return
        sys.excepthook = _crash_state["prev"]
        threading.excepthook = _crash_state["prev_threading"]
        _crash_state["installed"] = False
