"""The distributed bootstrap from the CSI-staged config, on
``torch.distributed``.

The node server stages ``tpu-bootstrap.json`` next to the device files:
the control plane's whole hand-off to a workload — which chips are its
own, the slice's shape, and where its processes meet.  A workload calls
``initialize()`` first thing, as with ``oim_tpu/parallel/coordinator.py``:
bind the process to the staged cards before the first CUDA touch, join
the process group, build the logical mesh.

The card's counterpart of ``/dev/accelN`` is ``/dev/nvidiaN``: the
binding is ``CUDA_VISIBLE_DEVICES`` over the staged minors, counted in
PCI bus order (``CUDA_DEVICE_ORDER=PCI_BUS_ID``, the order of
``nvidia-smi`` and of the minors), and ``cuda:N`` paths (cards the
runtime enumerated) bind by index alone.  CUDA reads both variables
when it initialises, so binding after that is too late, and is warned
about loudly.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from oim_tpu_torch import log

DEFAULT_BOOTSTRAP_PATH = "/tpu/tpu-bootstrap.json"

_NVIDIA_RE = re.compile(r"^/dev/nvidia(\d+)$")
_CUDA_RE = re.compile(r"^cuda:(\d+)$")


@dataclass
class Bootstrap:
    volume_id: str = ""
    chips: list[dict] = field(default_factory=list)
    mesh: list[int] = field(default_factory=list)
    coordinator_address: str = ""
    num_processes: int = 1
    process_id: int = 0

    @property
    def chip_count(self) -> int:
        return len(self.chips)


def load_bootstrap(path: str = "") -> Bootstrap:
    """Read the staged bootstrap file.  Search order: explicit path, the
    ``TPU_BOOTSTRAP`` env var, the conventional pod mount point."""
    path = path or os.environ.get("TPU_BOOTSTRAP", "") or DEFAULT_BOOTSTRAP_PATH
    with open(path) as f:
        data = json.load(f)
    return Bootstrap(
        volume_id=data.get("volume_id", ""),
        chips=data.get("chips", []),
        mesh=list(data.get("mesh", [])),
        coordinator_address=data.get("coordinator_address", ""),
        num_processes=int(data.get("num_processes", 1)),
        process_id=int(data.get("process_id", 0)),
    )


def chip_binding_env(bootstrap: Bootstrap) -> dict[str, str]:
    """The env restricting a process to the volume's cards: without it,
    a pod on a multi-tenant host would initialise every card of the
    host.  Indices come from the staged device paths (``/dev/nvidiaN``,
    or ``cuda:N``); ``{}`` for fake or stub paths (CPU test fixtures),
    where there is nothing to bind — one such path poisons the set, since
    binding part of a slice would claim cards the volume does not own."""
    indices, by_bus = [], False
    for chip in bootstrap.chips:
        path = chip.get("device_path", "")
        m = _NVIDIA_RE.match(path)
        by_bus |= m is not None
        m = m or _CUDA_RE.match(path)
        if m is None:
            return {}
        indices.append(int(m.group(1)))
    if not indices:
        return {}
    env = {"CUDA_VISIBLE_DEVICES": ",".join(str(i) for i in sorted(indices))}
    if by_bus:
        env["CUDA_DEVICE_ORDER"] = "PCI_BUS_ID"
    return env


def apply_chip_binding(bootstrap: Bootstrap) -> dict[str, str]:
    """Export the binding env (before the first CUDA touch).  Returns
    what was applied ({} when the staged devices are fakes).  Binding
    after CUDA initialised is a workload bug: it is warned about, not
    hidden."""
    env = chip_binding_env(bootstrap)
    if not env:
        log.current().debug(
            "no chip binding applied (fake/stub device paths)",
            volume=bootstrap.volume_id,
        )
        return env
    if torch.cuda.is_initialized():
        log.current().warning(
            "apply_chip_binding after CUDA initialized: the process "
            "already sees every card; bind before the first device touch"
        )
    os.environ.update(env)
    log.current().info("chip binding applied", volume=bootstrap.volume_id,
                       **env)
    return env


def _init_method(address: str) -> str:
    """``host:port`` as a TCP rendezvous; a URL (``tcp://``,
    ``file://``) as it is."""
    return address if "://" in address else f"tcp://{address}"


def initialize_distributed(bootstrap: Bootstrap, backend: str = "nccl") -> None:
    """Form the process group when the slice spans processes: every
    process meets at the coordinator the controller allocated, with the
    staged ``num_processes`` and ``process_id``.  One process: nothing
    to form.  ``backend`` is the caller's choice (gloo for CPU tests)."""
    if bootstrap.num_processes <= 1:
        log.current().debug("single-process slice; no process group")
        return
    dist.init_process_group(
        backend,
        init_method=_init_method(bootstrap.coordinator_address),
        world_size=bootstrap.num_processes,
        rank=bootstrap.process_id,
    )
    log.current().info(
        "torch.distributed initialized",
        coordinator=bootstrap.coordinator_address, backend=backend,
        process=f"{bootstrap.process_id}/{bootstrap.num_processes}",
    )


def initialize(path: str = "", backend: str = "nccl", devices=None,
               **mesh_kwargs):
    """One-call workload entry: read the bootstrap, bind to the staged
    cards, join the process group (a group of one for a one-process
    slice), return the logical mesh.  ``mesh_kwargs`` are the
    pp/sp/tp/ep sizes for ``mesh_from_bootstrap``; ``devices`` one a
    rank (default: the visible cards)."""
    from oim_tpu_torch.parallel.mesh import mesh_from_bootstrap

    bootstrap = load_bootstrap(path)
    apply_chip_binding(bootstrap)
    initialize_distributed(bootstrap, backend)
    if not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return mesh_from_bootstrap(bootstrap, devices=devices, **mesh_kwargs)
