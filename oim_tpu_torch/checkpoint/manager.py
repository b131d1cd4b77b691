"""Checkpoints of a ``TrainState`` plus its data cursor, and params-only
exports for serving.

The counterpart of ``oim_tpu/checkpoint/manager.py``.  Orbax imports
JAX, so the format is the port's own, with the properties the
reference's has:

- **Layout.**  ``<dir>/<step>/`` holds each rank's blocks: ``params.pt``
  (rank 0) or ``params-<r>.pt`` (every parameter block the rank writes,
  by its dotted name, f32 CPU tensors) and ``moments.pt`` /
  ``moments-<r>.pt`` (the AdamW moments ``exp_avg`` and ``exp_avg_sq``
  of the slice the rank's optimizer owns, by the same names), beside
  ``layout.json`` (each leaf's whole shape and every saved block: its
  file, start and size along each dimension; each leaf's update count;
  ``TrainState.step``) and ``data.json`` (the data cursor, e.g.
  ``{"next_step": n}``).  A block replicated over some mesh axes is
  written once, by the rank at index 0 of each of them.  On one device
  ``params.pt`` holds every whole parameter, as an export does.  An
  export is a directory with ``params.pt`` alone: what a server reads,
  a third of a checkpoint's bytes.  The layout before sharded saves
  (``params.pt`` whole beside ``optimizer.pt``, the AdamW ``state_dict``
  keyed by index) still restores, onto one device or a mesh.
- **Placement-independent restores.**  A restore builds each rank's
  block of each leaf, one leaf at a time, from the saved blocks that
  overlap it, read through memory maps: a checkpoint written on one
  mesh, with or without ZeRO-1, restores onto another or onto one
  device (the reference's "a zero1 checkpoint restores fine either
  way").
- **Atomic saves.**  Every rank writes into one temporary sibling of the
  step (named from a token rank 0 broadcasts) and leaves a marker with
  its block records; rank 0 waits for every marker (``commit_timeout``:
  a rank that failed mid-save never leaves one, and the wait raises
  instead of hanging), writes ``layout.json`` and ``data.json`` and
  renames the directory into place.  A crash on any rank leaves no
  step; a leftover temporary directory is never a step.
- **Async saves.**  ``save`` snapshots the rank's blocks into host
  memory before it returns (training then updates the device tensors
  in place), and a background thread writes them (and, on rank 0,
  commits); ``wait`` and ``close`` join it and re-raise its error.  One
  write is in flight at a time.  ``save`` is collective on a mesh:
  every rank calls it at the same steps.
- **Retention.**  ``max_to_keep`` newest steps stay; ``save`` skips a
  step off ``save_interval_steps`` unless forced, and a step that is
  already saved (decided from this object's own history, so that every
  rank decides alike).
- **Resume.**  ``restore_or_init`` is the idempotent entry: the latest
  step when one exists, else ``init_fn()``.  A restore builds the state
  with ``init_fn`` (the restore target: names and whole shapes must
  match) and copies the saved values into it, so the optimizer keeps
  the caller's configuration (``set_moments``) and the update after a
  resume is bit for bit the one an uninterrupted run takes.

``export_params`` on a mesh gathers one whole leaf at a time onto every
rank and writes the whole ``params.pt`` from rank 0.
``load_params_from_peer`` restores a server's weights from a serving
sibling's ``GET /v1/weights`` stream (either package's: the reference's
framing and its flat parameter dict), checked against this replica's
geometry before a byte of payload moves; on a mesh each rank reads the
stream and keeps its shard, a leaf at a time.  Saves, restores and peer
restores are observed as the reference observes them:
``oim_checkpoint_seconds{op}`` and ``oim_checkpoint_bytes_total{op}``
(each rank its own).
"""

from __future__ import annotations

import json
import math
import os
import secrets
import shutil
import struct
import threading
import time
import urllib.request
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from oim_tpu_torch.common import metrics
from oim_tpu_torch.models.train import (
    TrainState,
    named_parameters,
    set_moments,
)
from oim_tpu_torch.models.transformer import TransformerConfig
from oim_tpu_torch.models.weights import (
    _quant_shapes,
    int4_values,
    param_shapes,
    port_tensor,
    serve_specs,
    shard_tensor,
    spec_of,
    whole_shape,
)
from oim_tpu_torch.ops.quant import WEIGHT_QUANT_TARGETS
from oim_tpu_torch.parallel import collectives
from oim_tpu_torch.parallel.sharding import block_slices, sharded_axes
from oim_tpu_torch.serve.disagg import torch_dtype

# Checkpoint observability, the reference's families: save latency is
# the host snapshot (the part that holds the train loop), restore the
# full read.
_CKPT_SECONDS = metrics.registry().histogram(
    "oim_checkpoint_seconds",
    "Checkpoint operation latency by op (save = async enqueue + device "
    "snapshot, i.e. the train-loop stall; restore = full read).",
    ("op",),
)
_CKPT_BYTES = metrics.registry().counter(
    "oim_checkpoint_bytes_total",
    "Array bytes moved through the checkpoint manager, by op.",
    ("op",),
)

PARAMS = "params.pt"
MOMENTS = "moments.pt"
LAYOUT = "layout.json"
DATA = "data.json"
OPTIMIZER = "optimizer.pt"  # the one-device layout before sharded saves
_TMP = ".tmp-"
_MARK = "blocks-{}.json"
_MOMENT_KEYS = ("exp_avg", "exp_avg_sq")


@dataclass(frozen=True)
class CheckpointerOptions:
    """The reference's options: keep ``max_to_keep`` newest steps, save
    every ``save_interval_steps``, write in the background when
    ``async_save``, and create the directory unless ``create`` is False
    (a read-only open, as a server makes: a mistyped path must not leave
    an empty checkpoint directory behind).  ``commit_timeout`` bounds
    rank 0's wait for the other ranks' writes of a step."""

    max_to_keep: int = 3
    save_interval_steps: int = 1
    async_save: bool = True
    create: bool = True
    commit_timeout: float = 600.0


def _host_copy(value):
    """A snapshot of ``value`` (nested dicts and lists of tensors and
    plain values) with every tensor copied into host memory."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", copy=True)
    if isinstance(value, dict):
        return {k: _host_copy(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_host_copy(v) for v in value)
    return value


def flatten_params(params: dict) -> dict:
    """``{dotted name: tensor}`` of a port parameter dict (layers as
    ``layers.<i>.<name>``)."""
    return dict(named_parameters(params))


def unflatten_params(flat: dict, device=None) -> dict:
    """The nested parameter dict from ``flatten_params``'s names, on
    ``device``."""
    params: dict = {}
    layers: dict[int, dict] = {}
    for name, value in flat.items():
        value = value.to(device)
        if name.startswith("layers."):
            _, index, leaf = name.split(".", 2)
            layers.setdefault(int(index), {})[leaf] = value
        else:
            params[name] = value
    if layers:
        if sorted(layers) != list(range(len(layers))):
            raise ValueError(f"layer indices {sorted(layers)} are not 0..n-1")
        params["layers"] = [layers[i] for i in range(len(layers))]
    return params


def _write_atomic(directory: Path, files: dict) -> None:
    """Write ``files`` (name → object for ``torch.save``, or str for
    text) into a temporary sibling of ``directory``, then rename it into
    place."""
    tmp = directory.parent / f"{_TMP}{directory.name}-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    try:
        _write_files(tmp, files)
        os.rename(tmp, directory)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _write_files(directory: Path, files: dict) -> None:
    for name, obj in files.items():
        if isinstance(obj, str):
            part = directory / f"{name}.part"
            part.write_text(obj)
            os.rename(part, directory / name)
        else:
            torch.save(obj, directory / name)


def _tensor_bytes(value) -> int:
    """Bytes of every tensor in ``value`` (nested dicts, lists, tuples)."""
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    if isinstance(value, dict):
        return sum(_tensor_bytes(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return sum(_tensor_bytes(v) for v in value)
    return 0


def _load(path: Path, mmap: bool = False):
    return torch.load(path, map_location="cpu", weights_only=True,
                      mmap=mmap)


def _rank_file(base: str, rank: int) -> str:
    """Rank ``rank``'s file of kind ``base`` (``params.pt``: rank 0's is
    ``params.pt`` itself, another's ``params-<r>.pt``)."""
    if rank == 0:
        return base
    stem, ext = os.path.splitext(base)
    return f"{stem}-{rank}{ext}"


# ---------------------------------------------------------------------------
# Blocks: what this rank holds of each leaf, and what it writes


def _region(state: TrainState, name: str, tensor) -> list:
    """``[(start, size)]`` a dimension: the region of the whole leaf
    ``name`` that this rank's block ``tensor`` holds."""
    if state.mesh is None:
        return [(0, int(n)) for n in tensor.shape]
    spec = spec_of(state.specs, name)
    return block_slices(_whole(state, name, tensor), spec, state.mesh)


def _writes(state: TrainState, axes: tuple) -> bool:
    """Whether this rank writes a block that the ranks differing from it
    only on axes outside ``axes`` hold alike: the one at index 0 of each
    of those axes does."""
    mesh = state.mesh
    return mesh is None or all(
        mesh.coords[a] == 0 for a in mesh.axis_names
        if a not in axes and mesh.shape[a] > 1)


def _moment_region(state: TrainState, owned) -> list:
    """The region of the whole leaf whose moments ``owned`` (a
    ``models/train.py::Owned``) holds: its block, narrowed to ZeRO-1's
    slice."""
    region = _region(state, owned.name, owned.param)
    if owned.dim is not None:
        start, _ = region[owned.dim]
        region[owned.dim] = (start + owned.start, owned.size)
    return region


def _whole(state: TrainState, name: str, tensor) -> list:
    """The whole shape of leaf ``name`` whose block is ``tensor``."""
    if state.mesh is None:
        return list(tensor.shape)
    return list(whole_shape(tensor.shape, spec_of(state.specs, name),
                            state.mesh))


def _entry(region: list, shape: list) -> dict:
    return {"start": [s for s, _ in region], "size": [n for _, n in region],
            "shape": shape}


def _snapshot(state: TrainState) -> tuple[dict, dict, dict]:
    """(parameter blocks, moment blocks, block records) this rank writes:
    host copies, and ``{"params": {name: {"start", "size", "shape"}},
    "moments": {name: {..., "step": its update count}}}``."""
    params, moments = {}, {}
    record = {"params": {}, "moments": {}}
    for name, value in named_parameters(state.params):
        spec = None if state.mesh is None else spec_of(state.specs, name)
        axes = () if state.mesh is None else sharded_axes(spec, state.mesh)
        if _writes(state, axes):
            params[name] = _host_copy(value)
            record["params"][name] = _entry(_region(state, name, value),
                                            _whole(state, name, value))
    for owned in state.owned:
        opt = state.optimizer.state.get(owned.tensor)
        if not opt:
            continue  # no update taken yet: no moments
        spec = None if state.mesh is None else spec_of(state.specs,
                                                      owned.name)
        axes = () if state.mesh is None else sharded_axes(spec, state.mesh)
        if owned.dim is not None:
            axes = axes + ("dp",)
        if not _writes(state, axes):
            continue
        moments[owned.name] = {k: _host_copy(opt[k]) for k in _MOMENT_KEYS}
        record["moments"][owned.name] = dict(
            _entry(_moment_region(state, owned),
                   _whole(state, owned.name, owned.param)),
            step=float(opt["step"]))
    return params, moments, record


# ---------------------------------------------------------------------------
# Sources: a saved step's blocks, read a leaf at a time


class _Source:
    """A saved step: whole shapes, blocks and update counts by name."""

    def __init__(self, path: Path):
        self.path = path
        self._files: dict = {}
        layout = path / LAYOUT
        if layout.is_file():
            meta = json.loads(layout.read_text())
            self.step = int(meta["step"])
            self.params = meta["params"]
            self.moments = meta["moments"]
            return
        # The one-device layout before sharded saves: whole tensors, the
        # moments in an index-keyed AdamW state_dict.
        saved = self._file(PARAMS)
        self.params = {name: {"shape": list(t.shape),
                              "blocks": [[PARAMS, [0] * t.dim(),
                                          list(t.shape)]]}
                       for name, t in saved.items()}
        self.moments, self.step = {}, 0
        if (path / OPTIMIZER).is_file():
            self._legacy_moments(_load(path / OPTIMIZER))

    def _legacy_moments(self, opt: dict) -> None:
        """The moments of an index-keyed ``state_dict``: its indices run
        over the groups in order, decay (every name not ``*_norm``) then
        no decay, each in ``named_parameters``' order."""
        self.step = int(opt["step"])
        names = list(self.params)
        order = ([n for n in names if not n.endswith("_norm")]
                 + [n for n in names if n.endswith("_norm")])
        state = opt["optimizer"]["state"]
        indices = [i for g in opt["optimizer"]["param_groups"]
                   for i in g["params"]]
        self._legacy = {}
        for index, name in zip(indices, order):
            entry = state.get(index)
            if not entry:
                continue
            self._legacy[name] = entry
            shape = self.params[name]["shape"]
            self.moments[name] = {"shape": shape,
                                  "step": float(entry["step"]),
                                  "blocks": [[None, [0] * len(shape),
                                              shape]]}

    def _file(self, name: str):
        if name not in self._files:
            self._files[name] = _load(self.path / name, mmap=True)
        return self._files[name]

    def _block(self, file: str | None, name: str, key: str | None):
        if file is None:
            return self._legacy[name][key]
        value = self._file(file)[name]
        return value if key is None else value[key]

    def _fill(self, entry: dict, name: str, key, out, starts) -> None:
        """Copy into ``out`` (the region of leaf ``name`` from ``starts``
        at ``out``'s shape) every saved block overlapping it."""
        covered = 0
        for file, b_start, b_size in entry["blocks"]:
            src, dst = [], []
            for s, n, bs, bn in zip(starts, out.shape, b_start, b_size):
                lo, hi = max(s, bs), min(s + n, bs + bn)
                if lo >= hi:
                    break
                src.append(slice(lo - bs, hi - bs))
                dst.append(slice(lo - s, hi - s))
            else:
                out[tuple(dst)] = self._block(file, name, key)[tuple(src)]
                covered += math.prod(d.stop - d.start for d in dst)
        if covered != out.numel():
            raise ValueError(f"checkpoint {self.path}: the saved blocks of "
                             f"{name} cover {covered} of {out.numel()} "
                             "values of this rank's block")

    def param(self, name: str, out, starts) -> None:
        self._fill(self.params[name], name, None, out, starts)

    def moment(self, name: str, key: str, out, starts) -> None:
        self._fill(self.moments[name], name, key, out, starts)

    def whole(self, name: str) -> torch.Tensor:
        """The whole saved leaf ``name`` (f32, host)."""
        shape = self.params[name]["shape"]
        out = torch.empty(shape, dtype=torch.float32)
        self.param(name, out, [0] * len(shape))
        return out


def _whole_params(path: Path, device=None) -> dict:
    """Every whole parameter of a saved step or export at ``path``."""
    source = _Source(path)
    return unflatten_params({name: source.whole(name)
                             for name in source.params}, device)


# ---------------------------------------------------------------------------
# The checkpointer


class Checkpointer:
    """Save and restore a ``TrainState`` (one device's, or one rank's of
    a mesh) with a JSON side-car for the data cursor, under one
    directory of numbered steps."""

    def __init__(self, directory, options: CheckpointerOptions | None = None):
        self._dir = Path(directory)
        self._options = options or CheckpointerOptions()
        if self._options.create:
            self._dir.mkdir(parents=True, exist_ok=True)
        elif not self._dir.is_dir():
            raise FileNotFoundError(f"no checkpoint directory: {directory}")
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        # Steps on disk at the start and steps this object saved: what
        # ``save`` skips, the same on every rank.
        self._saved = set(self.all_steps())

    # -- save ---------------------------------------------------------------

    def save(self, state: TrainState, data_state: dict | None = None,
             force: bool = False) -> bool:
        """Save at ``state.step``: snapshot this rank's blocks to host
        memory now, write in the background (or now, without
        ``async_save``).  Returns False when the interval policy skips
        the step or it is already saved.  On a mesh every rank calls it
        at the same step."""
        step = int(state.step)
        if not force and step % self._options.save_interval_steps:
            return False
        if step in self._saved:
            return False
        self.wait()  # one write in flight; surfaces the last one's error
        self._saved.add(step)
        mesh = state.mesh
        rank = 0 if mesh is None else mesh.rank
        world = 1 if mesh is None else mesh.size
        token = secrets.token_hex(4)
        if world > 1:  # one temporary directory for every rank
            box = [token]
            dist.broadcast_object_list(box, src=0, group=mesh.control)
            token = box[0]
        t0 = time.perf_counter()
        params, moments, record = _snapshot(state)
        files = {_rank_file(PARAMS, rank): params,
                 _rank_file(MOMENTS, rank): moments}
        _CKPT_SECONDS.observe(time.perf_counter() - t0, "save")
        _CKPT_BYTES.inc("save", by=float(_tensor_bytes(files)))
        record["mesh"] = None if mesh is None else mesh.shape
        job = (step, token, rank, world, files, record, data_state or {})
        if not self._options.async_save:
            self._write(*job)
            return True
        self._thread = threading.Thread(target=self._write_background,
                                        args=job, daemon=True,
                                        name=f"oim-ckpt-{step}")
        self._thread.start()
        return True

    def _write(self, step: int, token: str, rank: int, world: int,
               files: dict, record: dict, data_state: dict) -> None:
        """This rank's files and its marker into the step's temporary
        directory; on rank 0 the commit."""
        tmp = self._dir / f"{_TMP}{step}-{token}"
        tmp.mkdir(parents=True, exist_ok=True)
        _write_files(tmp, dict(files, **{_MARK.format(rank):
                                         json.dumps(record)}))
        if rank == 0:
            try:
                self._commit(tmp, step, world, data_state)
            except BaseException:
                shutil.rmtree(tmp, ignore_errors=True)
                raise

    def _commit(self, tmp: Path, step: int, world: int,
                data_state: dict) -> None:
        """Rank 0: wait for every rank's marker, merge their records into
        ``layout.json``, write ``data.json`` and rename the step into
        place; then drop the steps past retention."""
        deadline = time.monotonic() + self._options.commit_timeout
        marks = [tmp / _MARK.format(r) for r in range(world)]
        while not all(m.is_file() for m in marks):
            if time.monotonic() > deadline:
                missing = [r for r, m in enumerate(marks) if not m.is_file()]
                raise TimeoutError(
                    f"checkpoint step {step}: ranks {missing} did not finish "
                    f"writing in {self._options.commit_timeout} s; the step "
                    "is not committed")
            time.sleep(0.05)
        layout = {"format": 2, "step": step, "params": {}, "moments": {}}
        for r, mark in enumerate(marks):
            record = json.loads(mark.read_text())
            layout.setdefault("mesh", record["mesh"])
            for kind, base in (("params", PARAMS), ("moments", MOMENTS)):
                for name, rec in record[kind].items():
                    entry = layout[kind].setdefault(
                        name, {"shape": rec["shape"], "blocks": []})
                    entry["blocks"].append([_rank_file(base, r),
                                            rec["start"], rec["size"]])
                    if "step" in rec:
                        entry["step"] = rec["step"]
            mark.unlink()
        _write_files(tmp, {LAYOUT: json.dumps(layout),
                           DATA: json.dumps(data_state)})
        os.rename(tmp, self._dir / str(step))
        for old in self.all_steps()[:-self._options.max_to_keep]:
            shutil.rmtree(self._dir / str(old), ignore_errors=True)

    def _write_background(self, *job) -> None:
        try:
            self._write(*job)
        except Exception as exc:  # re-raised by wait()
            self._error = exc

    # -- restore ------------------------------------------------------------

    def all_steps(self) -> list[int]:
        """Saved steps, oldest first (temporary directories excluded)."""
        if not self._dir.is_dir():
            return []
        return sorted(int(p.name) for p in self._dir.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: int | None) -> Path:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self._dir}")
        path = self._dir / str(step)
        if not path.is_dir():
            raise FileNotFoundError(f"no checkpoint step {step} in {self._dir}")
        return path

    def restore(self, init_fn: Callable[[], TrainState],
                step: int | None = None) -> tuple[TrainState, dict]:
        """Restore ``step`` (default: the latest) into ``init_fn()``'s
        state — one device's, or this rank's of its mesh, whatever mesh
        and ZeRO-1 setting the step was saved with: every parameter
        block, the optimizer's moments and update counts, and
        ``TrainState.step``.  Returns ``(state, data_state)``."""
        path = self._step_dir(step)
        t0 = time.perf_counter()
        state = init_fn()
        source = _Source(path)
        target = flatten_params(state.params)
        if set(source.params) != set(target):
            raise ValueError(
                f"checkpoint {path} holds "
                f"{sorted(set(source.params) ^ set(target))} that the "
                "restore target does not match")
        moved = 0
        with torch.no_grad():
            for name, value in target.items():
                want = _whole(state, name, value)
                if source.params[name]["shape"] != want:
                    raise ValueError(
                        f"checkpoint {path}: {name} is "
                        f"{tuple(source.params[name]['shape'])}, the target "
                        f"{tuple(want)}")
                block = torch.empty(value.shape, dtype=torch.float32)
                source.param(name, block,
                             [s for s, _ in _region(state, name, value)])
                value.copy_(block)
                moved += block.numel() * 4
            for owned in state.owned:
                if not owned.shared:  # ZeRO-1's copied slice
                    owned.tensor.copy_(owned.param.narrow(
                        owned.dim, owned.start, owned.size))
                if owned.name not in source.moments:
                    continue
                starts = [s for s, _ in _moment_region(state, owned)]
                pair = []
                for key in _MOMENT_KEYS:
                    out = torch.empty(owned.tensor.shape, dtype=torch.float32)
                    source.moment(owned.name, key, out, starts)
                    pair.append(out)
                    moved += out.numel() * 4
                set_moments(state.optimizer, owned.tensor,
                            source.moments[owned.name]["step"], *pair)
        state.step = source.step
        _CKPT_SECONDS.observe(time.perf_counter() - t0, "restore")
        _CKPT_BYTES.inc("restore", by=float(moved))
        data = path / DATA
        return state, json.loads(data.read_text()) if data.is_file() else {}

    def restore_or_init(self, init_fn: Callable[[], TrainState]
                        ) -> tuple[TrainState, dict | None, bool]:
        """The idempotent train-loop entry: ``(state, data_state,
        resumed)`` from the latest checkpoint, or ``(init_fn(), None,
        False)`` when there is none."""
        if self.latest_step() is None:
            return init_fn(), None, False
        state, data = self.restore(init_fn)
        return state, data, True

    def restore_params(self, step: int | None = None, device=None) -> dict:
        """Only the whole parameters of a training checkpoint (f32, on
        ``device``), whatever mesh saved them: a server needs neither the
        optimizer state nor the trainer's optimizer flags."""
        return _whole_params(self._step_dir(step), device)

    # -- params-only export (serving) ---------------------------------------

    def export_params(self, state: TrainState, directory) -> None:
        """Write ``state.params`` whole to ``directory`` for
        ``load_params``/``serve_main --params-dir``, synchronously and
        atomically.  On a mesh every rank calls it: each leaf is gathered
        whole over the axes that shard it, one leaf at a time, and rank
        0 writes.  Refuses to overwrite an existing export."""
        directory = Path(directory)
        mesh = getattr(state, "mesh", None)
        exists = directory.exists()
        if mesh is not None and mesh.size > 1:  # every rank refuses alike
            box = [exists]
            dist.broadcast_object_list(box, src=0, group=mesh.control)
            exists = box[0]
        if exists:
            raise FileExistsError(f"params export target exists: {directory}")
        whole = {}
        for name, value in named_parameters(state.params):
            value = value.detach()
            if mesh is not None:
                for dim, entry in enumerate(spec_of(state.specs, name)
                                            or ()):
                    if entry is not None and mesh.axis_size(entry) > 1:
                        value = collectives.all_gather(value, mesh, entry,
                                                       dim)
            if mesh is None or mesh.rank == 0:
                whole[name] = _host_copy(value)
        if mesh is None or mesh.rank == 0:
            directory.parent.mkdir(parents=True, exist_ok=True)
            _write_atomic(directory, {PARAMS: whole})

    # -- lifecycle ----------------------------------------------------------

    def wait(self) -> None:
        """Block until the queued save is on disk (committed, on rank 0);
        re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def close(self) -> None:
        self.wait()

    def __enter__(self) -> "Checkpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def load_params(directory, device=None) -> dict:
    """A params-only export (``Checkpointer.export_params``), or a
    training step's directory, as the port's nested parameter dict of
    whole f32 tensors on ``device``."""
    path = Path(directory)
    if not (path / PARAMS).is_file() and not (path / LAYOUT).is_file():
        raise FileNotFoundError(f"no params export at {directory}")
    return _whole_params(path, device)


def directory_bytes(path) -> int:
    """Bytes of every file under ``path``."""
    return sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())


# ---------------------------------------------------------------------------
# Weights from a serving sibling

_FLOATS = ("bfloat16", "float16", "float32")


def _peer_specs(cfg: TransformerConfig, weight_quant: str,
                int4_group: int) -> dict:
    """{name: (shape, allowed dtypes, stacked)} of the reference's flat
    dict for ``cfg``: float leaves in any float dtype (a reference peer
    serves f32, a port peer its compute dtype), quantized payloads in
    ``weight_quant``'s dtype with f32 scales; a stacked layer entry's
    shape without its leading ``[n_stages, layers_per_stage]``."""
    shapes = param_shapes(cfg)
    layer = {n.split(".", 2)[2]: s for n, s in shapes.items()
             if n.startswith("layers.0.")}
    top = {n: s for n, s in shapes.items() if not n.startswith("layers.")}
    specs = {}
    for tree, stacked in ((top, False), (layer, True)):
        for name, shape in tree.items():
            if weight_quant and name in WEIGHT_QUANT_TARGETS:
                scale = _quant_shapes(name, shape, weight_quant,
                                      int4_group)[f"{name}_wscale"]
                specs[name] = (shape, (weight_quant,), stacked)
                specs[f"{name}_wscale"] = (scale, ("float32",), stacked)
            else:
                specs[name] = (shape, _FLOATS, stacked)
    return specs


def _check_manifest(manifest, specs: dict, cfg: TransformerConfig,
                    url: str) -> None:
    """Refuse a peer manifest that is not ``specs``' model: names,
    shapes (stacked layers split any way over ``n_layers``) and dtypes."""
    bad = []
    got = {entry["name"]: entry for entry in manifest}
    for name in sorted(set(got) | set(specs)):
        if name not in got or name not in specs:
            bad.append((name, "missing" if name in specs else "extra"))
            continue
        shape, dtypes, stacked = specs[name]
        have = tuple(int(d) for d in got[name]["shape"])
        ok_shape = (len(have) == len(shape) + 2
                    and have[0] * have[1] == cfg.n_layers
                    and have[2:] == shape) if stacked else have == shape
        if not ok_shape or got[name]["dtype"] not in dtypes:
            bad.append((name, have, got[name]["dtype"]))
    if bad:
        raise ValueError(f"peer {url} serves a different model geometry; "
                         f"first mismatches: {bad[:4]}")


def _read_exact(resp, n: int) -> bytearray:
    """Exactly ``n`` bytes of ``resp`` (a short read means the peer died
    mid-stream: never restore a truncated tensor)."""
    out = bytearray(n)
    view, got = memoryview(out), 0
    while got < n:
        k = resp.readinto(view[got:got + (8 << 20)])
        if not k:
            raise IOError(f"peer weight stream truncated: wanted {n} bytes, "
                          f"short by {n - got}")
        got += k
    return out


def _peer_leaf(raw: bytearray, dtype: str, shape: tuple) -> torch.Tensor:
    """One leaf's bytes as a host tensor: bf16 through its 2-byte words
    (no ``ml_dtypes``), int4 as its int8 values."""
    if dtype == "int4":
        return int4_values(torch.frombuffer(raw, dtype=torch.uint8)
                           ).reshape(shape)
    want = torch_dtype(dtype)
    wire = torch.int16 if want == torch.bfloat16 else want
    return torch.frombuffer(raw, dtype=wire).view(want).reshape(shape)


def _place_leaf(tree: dict, layers: list, entry: dict, leaf: torch.Tensor,
                peer: dict, specs: dict, cfg: TransformerConfig, device,
                mesh) -> None:
    """One peer leaf into ``tree``: each layer's tensor (or the
    top-level one) laid out on ``device`` as ``from_jax_params`` lays it
    out, and cut to this rank's block where ``specs`` shard it."""
    name = entry["name"]
    payload = entry["dtype"] if entry["dtype"] in ("int8", "int4") else ""

    def block(value):
        return shard_tensor(name, port_tensor(name, value, cfg, device,
                                              payload), specs, mesh)

    if not peer[name][2]:
        tree[name] = block(leaf)
        return
    for i, value in enumerate(leaf.reshape(cfg.n_layers, *leaf.shape[2:])):
        layers[i][name] = block(value)


def load_params_from_peer(url: str, cfg: TransformerConfig, device=None, *,
                          weight_quant: str = "", int4_group: int = 64,
                          ssl_context=None, timeout: float = 600.0,
                          mesh=None) -> dict:
    """A serving sibling's weights (``GET <url>/v1/weights``, the
    reference's framing: an 8-byte big-endian manifest length, a JSON
    manifest ``[{"name", "dtype", "shape"}...]``, each leaf's raw bytes
    in manifest order) as the port's serving params on ``device``.  The
    manifest is checked against ``cfg`` (and ``weight_quant``'s payloads,
    int4 in groups of ``int4_group``) before a byte of payload moves; each
    leaf, as it arrives, is laid out one layer's tensor at a time on
    ``device`` as ``from_jax_params`` lays it out, quantized payloads as
    they come, so the host holds one leaf at a time.  Either package's
    peer: a reference peer streams f32 leaves, a port peer its compute
    dtype, both exact in the result.  An ``https://`` peer behind mTLS
    takes ``ssl_context`` (``serve/httptls.py::client_ssl_context``).

    On a rank of ``mesh`` every rank reads the stream itself (no
    collective, so ranks load in parallel and none waits on another) and
    cuts each tensor to its block (``serve_specs``) before the next, so
    no card holds the whole model — exactly ``shard_params`` of the
    whole tree."""
    t0 = time.perf_counter()
    tree, layers, moved = {}, [{} for _ in range(cfg.n_layers)], 0
    peer = _peer_specs(cfg, weight_quant, int4_group)
    specs = ({} if mesh is None
             else serve_specs(cfg, mesh, weight_quant, int4_group))
    request = urllib.request.Request(url.rstrip("/") + "/v1/weights")
    with urllib.request.urlopen(request, timeout=timeout,
                                context=ssl_context) as resp:
        (length,) = struct.unpack(">Q", bytes(_read_exact(resp, 8)))
        manifest = json.loads(bytes(_read_exact(resp, length)))
        _check_manifest(manifest, peer, cfg, url)
        for entry in manifest:
            shape = tuple(int(d) for d in entry["shape"])
            itemsize = (1 if entry["dtype"] == "int4"
                        else torch_dtype(entry["dtype"]).itemsize)
            raw = _read_exact(resp, int(np.prod(shape)) * itemsize)
            moved += len(raw)
            _place_leaf(tree, layers, entry,
                        _peer_leaf(raw, entry["dtype"], shape), peer, specs,
                        cfg, device, mesh)
    params = dict(tree, layers=layers)
    _CKPT_SECONDS.observe(time.perf_counter() - t0, "restore-peer")
    _CKPT_BYTES.inc("restore-peer", by=float(moved))
    return params
