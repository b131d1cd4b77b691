"""Log levels and their names (``debug``, ``info``, ``warning`` or
``warn``, ``error``, ``fatal``)."""

from __future__ import annotations

import enum


class Level(enum.IntEnum):
    DEBUG = 10
    INFO = 20
    WARNING = 30
    ERROR = 40
    FATAL = 50


_NAMES = {l.name.lower(): l for l in Level}
_NAMES["warn"] = Level.WARNING


def threshold_from_string(s: str) -> Level:
    try:
        return _NAMES[s.strip().lower()]
    except KeyError:
        raise ValueError(
            f"invalid log level {s!r}; one of {sorted(_NAMES)}"
        ) from None
