"""Logical device meshes over ``torch.distributed`` process groups.

The port's counterpart of ``oim_tpu/parallel/mesh.py``: the canonical
logical axes, outermost first,

    dp   data parallelism        (batch)
    pp   pipeline parallelism    (layer stages)
    sp   sequence parallelism    (ring attention / context)
    tp   tensor parallelism      (heads / mlp / vocab)
    ep   expert parallelism      (MoE experts)

over one process per device.  The reference is single-controller: one
process holds every device of its ``jax.sharding.Mesh``.  PyTorch's
idiom is one process a device on an initialised default process group;
a ``Mesh`` here is that rank's view: the axis sizes (``shape``, a dict,
as the reference's ``mesh.shape``), its coordinate on each axis, its
device, and one process group per axis holding the ranks that differ
from it on that axis alone (``group``; ``group(("tp", "ep"))`` for a
group over several).  Ranks are laid out row-major over ``AXES``, so
``ep`` and then ``tp`` are innermost, as the reference keeps its tp/sp
traffic on adjacent chips.  A gloo group over every rank (``control``)
carries host records that must never ride a device stream.

``devices`` is explicit: one device a rank, by default ``cuda:0`` …
``cuda:{n-1}``.  A list may name the same card twice only on a gloo
group, where two processes can share one card; NCCL refuses that.
"""

from __future__ import annotations

import itertools
import math

import torch
import torch.distributed as dist

AXES = ("dp", "pp", "sp", "tp", "ep")


def _sizes(dp: int, pp: int, sp: int, tp: int, ep: int) -> dict[str, int]:
    sizes = {"dp": dp, "pp": pp, "sp": sp, "tp": tp, "ep": ep}
    for name, size in sizes.items():
        if size < 1:
            raise ValueError(f"{name}={size} must be >= 1")
    return sizes


def mesh_devices(n: int, devices=None) -> list[torch.device]:
    """The ``n`` devices a mesh of ``n`` ranks runs on: ``devices`` when
    given, else every local CUDA device; too few raises the reference's
    ``"need {n} devices, have {m}"`` before any work."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(have)]
    devices = [torch.device(d) for d in devices]
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    return devices[:n]


class Mesh:
    """One rank's view of a logical mesh (see the module docstring)."""

    def __init__(self, sizes: dict[str, int], devices: list[torch.device],
                 groups: dict[tuple, object], control, backend: str):
        self.shape = dict(sizes)
        self.axis_names = AXES
        self.devices = devices
        self.backend = backend
        self.rank = dist.get_rank()
        self.device = devices[self.rank]
        self.coords = dict(zip(AXES, _coords(self.rank, sizes)))
        self._groups = groups
        self.control = control

    def _key(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for axis in axes:
            if axis not in AXES:
                raise ValueError(f"unknown mesh axis {axis!r}")
        return tuple(a for a in AXES if a in axes)

    def group(self, axes):
        """This rank's process group over ``axes`` (one name or several)."""
        return self._groups[self._key(axes)]

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._key(axes))

    @property
    def size(self) -> int:
        """The number of ranks."""
        return math.prod(self.shape.values())

    def coords_of(self, rank: int) -> dict[str, int]:
        """Rank ``rank``'s coordinate on each axis."""
        return dict(zip(AXES, _coords(rank, self.shape)))

    def axis_index(self, axes, rank: int | None = None) -> int:
        """This rank's (or ``rank``'s) index inside its group over
        ``axes`` (row-major over them, as the group's ranks are
        ordered)."""
        coords = self.coords if rank is None else self.coords_of(rank)
        index = 0
        for a in self._key(axes):
            index = index * self.shape[a] + coords[a]
        return index

    def warm(self) -> None:
        """One eager collective on every group of this rank, in one order
        on every rank: NCCL makes a communicator at its first collective,
        and a CUDA graph cannot capture that."""
        for key in sorted(self._groups):
            x = torch.zeros(1, device=self.device)
            dist.all_reduce(x, group=self._groups[key])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, device={self.device}, "
                f"backend={self.backend})")


def _coords(rank: int, sizes: dict[str, int]) -> tuple[int, ...]:
    coords = []
    for axis in reversed(AXES):
        coords.append(rank % sizes[axis])
        rank //= sizes[axis]
    return tuple(reversed(coords))


def _rank_of(coords: dict[str, int], sizes: dict[str, int]) -> int:
    rank = 0
    for axis in AXES:
        rank = rank * sizes[axis] + coords[axis]
    return rank


def build_mesh(dp: int = 1, pp: int = 1, sp: int = 1, tp: int = 1,
               ep: int = 1, devices=None, per_process: bool = False) -> Mesh:
    """A mesh with the canonical five axes over the initialised default
    process group, whose world size must be the product of the sizes.
    Every rank calls it, with the same arguments: each group is made by
    every rank in one order (``dist.new_group`` is collective).
    ``per_process``: ``devices`` name each process's own cards (a
    bootstrap's processes each bound to theirs), so one name may stand
    for several cards."""
    sizes = _sizes(dp, pp, sp, tp, ep)
    n = math.prod(sizes.values())
    devices = mesh_devices(n, devices)
    if not dist.is_initialized():
        raise RuntimeError(
            "build_mesh needs an initialised default process group "
            "(parallel.initialize_distributed or dist.init_process_group)")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a mesh of {n} ranks needs a process group of {n}, "
                         f"have {world}")
    backend = dist.get_backend()
    if (backend != "gloo" and not per_process
            and len(set(devices)) < len(devices)):
        raise ValueError(f"devices {[str(d) for d in devices]} name one "
                         f"device twice: only a gloo group may share a card")
    if backend == "nccl":
        if any(d.type != "cuda" for d in devices):
            raise ValueError("an NCCL mesh needs a CUDA device a rank")
        torch.cuda.set_device(devices[dist.get_rank()])
    me = _coords(dist.get_rank(), sizes)
    groups = {}
    # Every subset of axes that the port reduces over: each axis alone,
    # and tp with ep (the MoE combine).  One group a combination of the
    # other axes' coordinates, every rank making every group.
    for key in [(a,) for a in AXES] + [("tp", "ep")]:
        others = [a for a in AXES if a not in key]
        for fixed in itertools.product(*(range(sizes[a]) for a in others)):
            base = dict(zip(others, fixed))
            ranks = [_rank_of({**base, **dict(zip(key, free))}, sizes)
                     for free in itertools.product(
                         *(range(sizes[a]) for a in key))]
            group = dist.new_group(ranks)
            if all(base[a] == me[AXES.index(a)] for a in others):
                groups[key] = group
    control = dist.new_group(backend="gloo")
    return Mesh(sizes, devices, groups, control, backend)


def mesh_from_bootstrap(bootstrap, dp: int = 0, pp: int = 1, sp: int = 1,
                        tp: int = 1, ep: int = 1, devices=None) -> Mesh:
    """The logical mesh for a CSI-provisioned slice.

    ``dp=0`` (default) absorbs the leftover: dp = n_chips //
    (pp*sp*tp*ep).  The bootstrap's ``mesh`` is the local (per-host)
    sub-slice; the global device count is local × ``num_processes``,
    one rank a device once every process has joined.  With no
    ``devices`` and several processes, each process's ranks run on its
    own visible cards in order (``cuda:0`` … on each)."""
    local = math.prod(bootstrap.mesh) if bootstrap.mesh else len(
        bootstrap.chips)
    n = local * max(1, getattr(bootstrap, "num_processes", 1))
    fixed = pp * sp * tp * ep
    if dp == 0:
        if n % fixed != 0:
            raise ValueError(
                f"slice of {n} chips not divisible by pp*sp*tp*ep={fixed}"
            )
        dp = n // fixed
    if dp * fixed != n:
        raise ValueError(
            f"dp*pp*sp*tp*ep={dp * fixed} does not match slice size {n}"
        )
    processes = max(1, getattr(bootstrap, "num_processes", 1))
    per_process = devices is None and processes > 1
    if per_process:
        devices = [torch.device("cuda", r % local) for r in range(n)]
    return build_mesh(dp=dp, pp=pp, sp=sp, tp=tp, ep=ep, devices=devices,
                      per_process=per_process)
