"""Background host→device prefetch (the port of
``oim_tpu/data/prefetch.py``'s ``device_prefetch``).

A daemon thread stays ``BUFFER`` batches ahead: it turns each numpy
batch into a tensor and, for a CUDA device, copies it from pinned host
memory on a side stream and records an event, so batch N+1 crosses
PCIe while step N runs.  The consumer makes its current stream wait on
that event before it hands the tensor out, and tells the allocator the
tensor is used there.  On the CPU the tensor is the batch itself.

An exception in the source iterator surfaces in the consumer where it
would have taken that batch; closing the generator stops the producer.
The reference's instruments: ``oim_data_prefetch_depth`` (batches ready
at the consumer's last wakeup: pinned at 0, the host cannot keep up)
and ``oim_data_batch_wait_seconds`` (what that costs the step).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterable, Iterator

import numpy as np
import torch

from oim_tpu_torch.common import metrics

_DEPTH = metrics.registry().gauge(
    "oim_data_prefetch_depth",
    "Batches ready in the host-to-device prefetch buffer at the last "
    "consumer wakeup.",
)
_WAIT = metrics.registry().histogram(
    "oim_data_batch_wait_seconds",
    "Time the consumer blocked waiting for the next prefetched batch "
    "(sustained milliseconds here = input-pipeline-bound training).",
    buckets=metrics.FAST_BUCKETS,
)

class _Stop:
    pass


_STOP = _Stop()
# Batches the producer keeps ready: one in use, one crossing PCIe.
BUFFER = 2


def _to_device(batch: np.ndarray, device: torch.device, stream):
    """(tensor on ``device``, the event that marks its copy done, or
    None on the CPU)."""
    host = torch.from_numpy(np.ascontiguousarray(batch))
    if device.type != "cuda":
        return host, None
    with torch.cuda.stream(stream):
        out = host.pin_memory().to(device, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    return out, done


def device_prefetch(batches: Iterable[np.ndarray],
                    device) -> Iterator[torch.Tensor]:
    """Yields the batches as tensors on ``device``, ``BUFFER`` ahead,
    each ready for use on the consumer's current stream."""
    device = torch.device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    buf: queue.Queue = queue.Queue(maxsize=BUFFER)
    stop = threading.Event()

    def put_or_stop(item) -> None:
        while not stop.is_set():
            try:
                buf.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def produce():
        try:
            for batch in batches:
                if stop.is_set():
                    return
                put_or_stop(_to_device(batch, device, stream))
            put_or_stop(_STOP)
        except BaseException as exc:  # surfaced in the consumer
            put_or_stop(exc)

    thread = threading.Thread(target=produce, daemon=True,
                              name="oim-prefetch")

    def consume():
        # Start only once iterated: a generator never advanced never runs
        # its finally, so an eager start would leak the thread.
        thread.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = buf.get()
                _WAIT.observe(time.perf_counter() - t0)
                _DEPTH.set(buf.qsize())
                if isinstance(item, _Stop):
                    return
                if isinstance(item, BaseException):
                    raise item
                tensor, done = item
                if done is not None:
                    current = torch.cuda.current_stream(device)
                    current.wait_event(done)
                    tensor.record_stream(current)
                yield tensor
        finally:
            stop.set()
            thread.join(timeout=5.0)

    return consume()
