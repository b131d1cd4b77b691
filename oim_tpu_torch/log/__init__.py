"""Structured, leveled, context-carried logging.

The port's own copy of ``oim_tpu/log/`` (stdlib only): a small logger
interface whose instances travel with the execution context, so nested
calls inherit per-request fields, with swappable implementations
(plain text to stderr, test-capturing, null).  ``with_logger()`` and
``with_fields()`` bind a logger for a block through a
``contextvars.ContextVar``; ``current()`` returns it, else the global
logger; ``init_from_string`` sets the global threshold from a level
name (``serve_main --log-level``).
"""

from __future__ import annotations

import contextlib
import contextvars
import sys
import threading
import time
from typing import Any, Iterator

from oim_tpu_torch.log.level import Level, threshold_from_string

__all__ = [
    "Logger",
    "SimpleLogger",
    "TestLogger",
    "NullLogger",
    "Record",
    "L",
    "set_global",
    "current",
    "with_logger",
    "with_fields",
    "Level",
]


class Logger:
    """Base logger: level methods layered over one ``output`` primitive.

    Every level method funnels into ``output(level, msg, fields)``, and
    ``with_fields`` returns a child bound to extra key/values.
    """

    def __init__(self, fields: dict[str, Any] | None = None) -> None:
        self.fields: dict[str, Any] = dict(fields or {})

    # -- primitive, implemented by subclasses ------------------------------
    def output(self, level: Level, msg: str, fields: dict[str, Any]) -> None:
        raise NotImplementedError

    def child(self, fields: dict[str, Any]) -> "Logger":
        """Construct the same kind of logger with merged bound fields."""
        raise NotImplementedError

    # -- convenience surface ----------------------------------------------
    def with_fields(self, **kv: Any) -> "Logger":
        merged = dict(self.fields)
        merged.update(kv)
        return self.child(merged)

    def _log(self, level: Level, msg: str, kv: dict[str, Any]) -> None:
        fields = dict(self.fields)
        fields.update(kv)
        self.output(level, msg, fields)

    def debug(self, msg: str, **kv: Any) -> None:
        self._log(Level.DEBUG, msg, kv)

    def info(self, msg: str, **kv: Any) -> None:
        self._log(Level.INFO, msg, kv)

    def warning(self, msg: str, **kv: Any) -> None:
        self._log(Level.WARNING, msg, kv)

    def error(self, msg: str, **kv: Any) -> None:
        self._log(Level.ERROR, msg, kv)

    def fatal(self, msg: str, **kv: Any) -> None:
        self._log(Level.FATAL, msg, kv)
        raise SystemExit(msg)


def _format_fields(fields: dict[str, Any]) -> str:
    if not fields:
        return ""
    return " " + " ".join(f"{k}={fields[k]!r}" for k in sorted(fields))


class SimpleLogger(Logger):
    """Plain-text threshold-filtered logger."""

    def __init__(
        self,
        threshold: Level = Level.INFO,
        out=None,
        fields: dict[str, Any] | None = None,
        timestamps: bool = True,
    ) -> None:
        super().__init__(fields)
        self.threshold = threshold
        self.out = out if out is not None else sys.stderr
        self.timestamps = timestamps
        self._lock = threading.Lock()

    def child(self, fields: dict[str, Any]) -> "SimpleLogger":
        c = SimpleLogger(self.threshold, self.out, fields, self.timestamps)
        c._lock = self._lock
        return c

    def output(self, level: Level, msg: str, fields: dict[str, Any]) -> None:
        if level < self.threshold:
            return
        ts = (
            time.strftime("%Y-%m-%d %H:%M:%S ", time.localtime())
            if self.timestamps
            else ""
        )
        line = f"{ts}{level.name[0]} {msg}{_format_fields(fields)}\n"
        with self._lock:
            try:
                self.out.write(line)
            except (ValueError, OSError):
                # Stream closed/broken under us (interpreter teardown,
                # pytest capture ending, a consumer pipe exiting) —
                # logging must never crash the thread that called it.
                pass


class Record:
    __slots__ = ("level", "msg", "fields")

    def __init__(self, level: Level, msg: str, fields: dict[str, Any]):
        self.level, self.msg, self.fields = level, msg, fields

    def __repr__(self) -> str:
        return f"Record({self.level.name}, {self.msg!r}, {self.fields!r})"


class TestLogger(Logger):
    """Captures records for assertions."""

    def __init__(self, fields: dict[str, Any] | None = None, parent=None) -> None:
        super().__init__(fields)
        self.records: list[Record] = [] if parent is None else parent.records

    def child(self, fields: dict[str, Any]) -> "TestLogger":
        return TestLogger(fields, parent=self)

    def output(self, level: Level, msg: str, fields: dict[str, Any]) -> None:
        self.records.append(Record(level, msg, fields))

    def messages(self) -> list[str]:
        return [r.msg for r in self.records]


class NullLogger(Logger):
    def child(self, fields: dict[str, Any]) -> "NullLogger":
        return NullLogger(fields)

    def output(self, level: Level, msg: str, fields: dict[str, Any]) -> None:
        pass


_global = SimpleLogger()
_ctx: contextvars.ContextVar[Logger | None] = contextvars.ContextVar(
    "oim_tpu_torch_logger", default=None
)


def set_global(logger: Logger) -> None:
    """Replace the global logger."""
    global _global
    _global = logger


def L() -> Logger:
    """The global logger."""
    return _global


def current() -> Logger:
    """The context logger, falling back to the global one."""
    return _ctx.get() or _global


@contextlib.contextmanager
def with_logger(logger: Logger) -> Iterator[Logger]:
    """Run a block with ``logger`` as the context logger."""
    token = _ctx.set(logger)
    try:
        yield logger
    finally:
        _ctx.reset(token)


@contextlib.contextmanager
def with_fields(**kv: Any) -> Iterator[Logger]:
    """Bind fields onto the context logger for a block."""
    child = current().with_fields(**kv)
    token = _ctx.set(child)
    try:
        yield child
    finally:
        _ctx.reset(token)


def init_from_string(spec: str) -> None:
    """Make the global logger a ``SimpleLogger`` (stderr) at the level
    ``spec`` names (ValueError on an unknown name)."""
    set_global(SimpleLogger(threshold=threshold_from_string(spec)))
