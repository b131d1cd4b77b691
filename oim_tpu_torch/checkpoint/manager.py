"""Checkpoints of a ``TrainState`` plus its data cursor, and params-only
exports for serving.

The counterpart of ``oim_tpu/checkpoint/manager.py`` for one device.
Orbax imports JAX, so the format is the port's own, with the properties
the reference's has:

- **Layout.** ``<dir>/<step>/`` holds ``params.pt`` (every parameter by
  its dotted name, f32 CPU tensors), ``optimizer.pt`` (the AdamW
  ``state_dict``: both moments and each parameter's ``step`` count, and
  ``TrainState.step``) and ``data.json`` (the data cursor, e.g.
  ``{"next_step": n}``).  An export is a directory with ``params.pt``
  alone: what a server reads, a third of a checkpoint's bytes.
- **Atomic saves.**  A step is written under a temporary name in the
  same directory and renamed into place, so a crash leaves no
  half-written step; a leftover temporary directory is never a step.
- **Async saves.**  ``save`` snapshots every tensor into host memory
  before it returns (training then updates the device tensors in
  place), and a background thread writes the snapshot; ``wait`` and
  ``close`` join it and re-raise its error.  One write is in flight at
  a time.
- **Retention.**  ``max_to_keep`` newest steps stay; ``save`` skips a
  step off ``save_interval_steps`` unless forced, and a step that is
  already saved.
- **Resume.**  ``restore_or_init`` is the idempotent entry: the latest
  step when one exists, else ``init_fn()``.  A restore builds the state
  with ``init_fn`` (the restore target: names and shapes must match)
  and copies the saved values into it, so the optimizer keeps the
  caller's configuration and the update after a resume is bit for bit
  the one an uninterrupted run takes.

Peer loading and the checkpoint metrics of the reference wait for the
server's peer routes and ``/metrics`` (ROADMAP Queue A 11).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import torch

from oim_tpu_torch.models.train import TrainState, named_parameters

PARAMS = "params.pt"
OPTIMIZER = "optimizer.pt"
DATA = "data.json"
_TMP = ".tmp-"


@dataclass(frozen=True)
class CheckpointerOptions:
    """The reference's options: keep ``max_to_keep`` newest steps, save
    every ``save_interval_steps``, write in the background when
    ``async_save``, and create the directory unless ``create`` is False
    (a read-only open, as a server makes: a mistyped path must not leave
    an empty checkpoint directory behind)."""

    max_to_keep: int = 3
    save_interval_steps: int = 1
    async_save: bool = True
    create: bool = True


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
        for name, obj in files.items():
            if isinstance(obj, str):
                (tmp / name).write_text(obj)
            else:
                torch.save(obj, tmp / name)
        os.rename(tmp, directory)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _load(path: Path):
    return torch.load(path, map_location="cpu", weights_only=True)


class Checkpointer:
    """Save and restore a ``TrainState`` with a JSON side-car for the
    data cursor, under one directory of numbered steps."""

    def __init__(self, directory, options: CheckpointerOptions | None = None):
        self._dir = Path(directory)
        self._options = options or CheckpointerOptions()
        if self._options.create:
            self._dir.mkdir(parents=True, exist_ok=True)
        elif not self._dir.is_dir():
            raise FileNotFoundError(f"no checkpoint directory: {directory}")
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._pending: int | None = None  # the step being written

    # -- save ---------------------------------------------------------------

    def save(self, state: TrainState, data_state: dict | None = None,
             force: bool = False) -> bool:
        """Save at ``state.step``: snapshot to host memory now, write in
        the background (or now, without ``async_save``).  Returns False
        when the interval policy skips the step or it is already saved."""
        step = int(state.step)
        if not force and step % self._options.save_interval_steps:
            return False
        if step in self.all_steps() or step == self._pending:
            return False
        self.wait()  # one write in flight; surfaces the last one's error
        files = {
            PARAMS: _host_copy(flatten_params(state.params)),
            OPTIMIZER: {"step": step,
                        "optimizer": _host_copy(state.optimizer.state_dict())},
            DATA: json.dumps(data_state or {}),
        }
        if not self._options.async_save:
            self._write(step, files)
            return True
        self._pending = step
        self._thread = threading.Thread(target=self._write_background,
                                        args=(step, files), daemon=True,
                                        name=f"oim-ckpt-{step}")
        self._thread.start()
        return True

    def _write(self, step: int, files: dict) -> None:
        _write_atomic(self._dir / str(step), files)
        for old in self.all_steps()[:-self._options.max_to_keep]:
            shutil.rmtree(self._dir / str(old), ignore_errors=True)

    def _write_background(self, step: int, files: dict) -> None:
        try:
            self._write(step, files)
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
        state: every parameter, the optimizer's moments and step counts,
        and ``TrainState.step``.  Returns ``(state, data_state)``."""
        path = self._step_dir(step)
        state = init_fn()
        saved = _load(path / PARAMS)
        target = flatten_params(state.params)
        if set(saved) != set(target):
            raise ValueError(
                f"checkpoint {path} holds {sorted(set(saved) ^ set(target))} "
                f"that the restore target does not match")
        with torch.no_grad():
            for name, value in target.items():
                if tuple(saved[name].shape) != tuple(value.shape):
                    raise ValueError(
                        f"checkpoint {path}: {name} is "
                        f"{tuple(saved[name].shape)}, the target "
                        f"{tuple(value.shape)}")
                value.copy_(saved[name])
        opt = _load(path / OPTIMIZER)
        state.optimizer.load_state_dict(opt["optimizer"])
        state.step = int(opt["step"])
        return state, json.loads((path / DATA).read_text())

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
        """Only the parameters of a training checkpoint (f32, on
        ``device``): a server needs neither the optimizer state nor the
        trainer's optimizer flags."""
        return unflatten_params(_load(self._step_dir(step) / PARAMS), device)

    # -- params-only export (serving) ---------------------------------------

    def export_params(self, state: TrainState, directory) -> None:
        """Write ``state.params`` alone to ``directory`` for
        ``load_params``/``serve_main --params-dir``, synchronously and
        atomically.  Refuses to overwrite an existing export."""
        directory = Path(directory)
        if directory.exists():
            raise FileExistsError(f"params export target exists: {directory}")
        directory.parent.mkdir(parents=True, exist_ok=True)
        _write_atomic(directory,
                      {PARAMS: _host_copy(flatten_params(state.params))})

    # -- lifecycle ----------------------------------------------------------

    def wait(self) -> None:
        """Block until the queued save is on disk; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            self._pending = None
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
    """A params-only export (``Checkpointer.export_params``) as the
    port's nested parameter dict of f32 tensors on ``device``."""
    path = Path(directory) / PARAMS
    if not path.is_file():
        raise FileNotFoundError(f"no params export at {directory}")
    return unflatten_params(_load(path), device)


def directory_bytes(path) -> int:
    """Bytes of every file under ``path``."""
    return sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())
