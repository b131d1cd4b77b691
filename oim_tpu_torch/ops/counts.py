"""The launch counts of every kernel wrapper as one set, and the context
that keeps them true across CUDA graph replays.

Each kernel module (``rmsnorm``, ``flash_attention``, ``fused_ce``,
``paged_attention``, ``wquant``) counts its wrappers' launches, its
routes and its plain versions' runs under names of its own
(``<module>.counters()``), and ``parallel/collectives.py`` its
collectives (``collective.<primitive>``), so that a graph's replays
count the collectives captured in it too.
A CUDA graph runs the wrappers' Python once, at capture, and none of it
at replay: ``recording`` takes back what a captured region counted and
keeps it, and ``replay_counts`` adds it again at each replay, so the
counts stay launches on the device.  The serving engine's graphs and
the trainer's step graph both go through it.
"""

from __future__ import annotations

import contextlib

from oim_tpu_torch.ops import flash_attention, fused_ce, paged_attention
from oim_tpu_torch.ops import rmsnorm, wquant
from oim_tpu_torch.parallel import collectives

MODULES = (rmsnorm, flash_attention, fused_ce, paged_attention, wquant,
           collectives)


def counters() -> dict:
    """Every module's launch, route and plain-call counts by name."""
    out: dict = {}
    for module in MODULES:
        out.update(module.counters())
    return out


def reset_counters() -> None:
    """Zero every module's counts."""
    for module in MODULES:
        module.reset_counters()


def replay_counts(delta: dict) -> None:
    """Add ``delta`` (counts by ``counters()``'s names) to every
    module's counts: a replay of a captured region adds what
    ``recording`` kept for it."""
    for module in MODULES:
        module.replay_counts(delta)


@contextlib.contextmanager
def recording(plain: bool = False):
    """Around a CUDA graph's capture: yields a dict that, on exit, holds
    the counts the region's wrappers added (the launches one replay
    makes), and takes them back off the counts, since a capture launches
    nothing.  A plain call inside the region raises, unless ``plain``
    says the region runs plain versions on the device on purpose (an
    engine with a kernel switched off): then each replay counts them as
    it counts launches."""
    before = counters()
    delta: dict = {}
    yield delta
    after = counters()
    # Counts by name that the region's first launch of a kind created
    # (``wquant``'s by shape) start from 0.
    delta.update({name: n - before.get(name, 0) for name, n in after.items()})
    replay_counts({name: -n for name, n in delta.items()})
    ran_plain = {name: n for name, n in delta.items()
                 if name.endswith("_plain") and n}
    if ran_plain and not plain:
        raise RuntimeError(f"plain versions ran in a captured region: "
                           f"{ran_plain}")
