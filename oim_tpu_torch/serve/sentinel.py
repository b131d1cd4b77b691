"""Runtime recompile sentinel: the steady-state invariant watched on a
live server.

The port's counterpart of ``oim_tpu/serve/sentinel.py``.  The reference
listens for ``jax.monitoring``'s backend-compile event, since an XLA
compile after warmup is seconds of dead air in the middle of live
streams.  What stalls the port's streams the same way are its own two
compile events, each reported here with its wall time:

- a CUDA graph capture (``Engine._capture_graphs``, one report a
  captured graph): the step thread captures while the streams wait;
- a kernel build (``ops/_build.py::build``: ``nvcc`` on the sources,
  once a process, at the kernels' first use).

Every report increments ``oim_xla_compiles_total`` and observes
``oim_xla_compile_seconds`` (warmup's included: the plateau after
warmup is the signal).  After an engine's warmup ends it **arms**
itself here (``Engine.warmup`` calls ``arm``), and from then on, while
no engine in the process is warming, each report emits a
``serve.recompile`` WARNING event carrying every armed engine's request
context and adds one to its ``recompiles``.

A capture runs on the step thread, inside the engine's dispatch: the
report must never take the engine's lock.  The context is read from
``engine._sentinel_ctx``, a small dict the step thread replaces (never
mutates) at phase boundaries, so a bare read is a consistent snapshot.

Process-global, as the reference's listener is: ``install`` is
idempotent (without it ``report`` and ``arm`` do nothing), arming is per
engine through a weak set, and a warmup anywhere in the process
silences events (a second engine warming legitimately captures; its
captures are not another engine's recompiles).
"""

from __future__ import annotations

import threading
import weakref

from oim_tpu_torch.common import events as _events
from oim_tpu_torch.common import metrics as _metrics
from oim_tpu_torch.ops import _build

_lock = threading.Lock()
_state = {"installed": False}
_armed: "weakref.WeakSet" = weakref.WeakSet()
# Engines inside warmup() anywhere in this process: while nonzero, reports
# are counted but no serve.recompile is emitted.
_warming = [0]


def install() -> bool:
    """Start counting (idempotent; False when already installed): kernel
    builds report through ``ops/_build.py``'s listeners, graph captures
    through ``report``.  oim-serve calls it at init, tests directly."""
    with _lock:
        if _state["installed"]:
            return False
        _build.BUILD_LISTENERS.append(report)
        _state["installed"] = True
        return True


def installed() -> bool:
    with _lock:
        return _state["installed"]


def arm(engine) -> None:
    """From now on a report emits ``serve.recompile`` with ``engine``'s
    request context (``Engine.warmup``'s last act); held weakly, so a
    dropped engine disarms itself."""
    with _lock:
        _armed.add(engine)


def disarm(engine) -> None:
    with _lock:
        _armed.discard(engine)


def armed(engine) -> bool:
    with _lock:
        return engine in _armed


def begin_warmup() -> None:
    """``Engine.warmup`` brackets its body with this and ``end_warmup``:
    a second engine warming in an armed process fires nothing."""
    with _lock:
        _warming[0] += 1


def end_warmup() -> None:
    with _lock:
        _warming[0] = max(0, _warming[0] - 1)


def report(seconds: float) -> None:
    """One compile of ``seconds`` wall time (a graph capture or a kernel
    build); nothing unless installed.  Takes no engine lock."""
    with _lock:
        if not _state["installed"]:
            return
    _metrics.XLA_COMPILES.inc()
    _metrics.XLA_COMPILE_SECONDS.observe(seconds)
    with _lock:
        if _warming[0] > 0:
            return
        engines = list(_armed)
    for engine in engines:
        # Lock-free: the step thread replaces _sentinel_ctx wholesale.
        ctx = getattr(engine, "_sentinel_ctx", None) or {}
        engine.recompiles += 1
        _events.emit(
            "serve.recompile",
            component="serve",
            severity=_events.WARNING,
            subject=str(getattr(engine, "_engine_label", "")),
            duration_s=round(float(seconds), 6),
            **ctx,
        )
