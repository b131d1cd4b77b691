"""Deterministic sharded token-batch loading (numpy only).

The port's own copy of ``oim_tpu/data/loader.py``'s ``ShardSpec``,
``window_count`` and ``TokenBatches``, so both trainers cut the same
corpus into the same batches at the same steps, with the reference's
data-plane instruments: ``oim_data_batches_total`` and
``oim_data_batch_assembly_seconds``.

On a training mesh a rank feeds ``ShardSpec(dp index, dp)``: its tp
and ep peers feed the same rows, and the dp ranks' rows together are the
global batch (rank r holds rows ``r::dp``; concatenated in rank order,
as the reference's multi-process feed assembles its global array).

- **Process-sharded, deterministic.**  Every process computes the same
  global shuffle from the same seed and takes its own disjoint rows by
  ``(process_index, num_processes)``; epoch reshuffles derive from
  ``(seed, epoch)``, so any step is reproducible from (seed, step).
- **Static shapes.**  Every batch is exactly ``[batch_local, seq+1]``;
  ragged tails are dropped, never padded.
- **Memmap-friendly.**  Source reads are plain slices; a batch copies
  its windows into a fresh array.  The device copy happens in
  ``data/prefetch.py``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from oim_tpu_torch.common import metrics

# Data-plane instruments (the reference's): a host-bound feed shows here
# before step time regresses.  Assembly is sub-millisecond when healthy,
# so FAST_BUCKETS.
_BATCHES = metrics.registry().counter(
    "oim_data_batches_total",
    "Token batches assembled by the input pipeline.",
)
_ASSEMBLY = metrics.registry().histogram(
    "oim_data_batch_assembly_seconds",
    "Host-side batch gather latency (shuffled windows to one batch "
    "array), per batch.",
    buckets=metrics.FAST_BUCKETS,
)


@dataclass(frozen=True)
class ShardSpec:
    """Which slice of the global batch this process feeds."""

    process_index: int = 0
    num_processes: int = 1

    def __post_init__(self):
        if not 0 <= self.process_index < self.num_processes:
            raise ValueError(
                f"process_index {self.process_index} out of range for "
                f"{self.num_processes} processes"
            )


def window_count(n_tokens: int, seq: int) -> int:
    """Number of non-overlapping [seq+1]-token windows in a corpus."""
    return max((n_tokens - 1) // seq, 0)


class TokenBatches:
    """Iterates deterministic ``[batch_local, seq+1]`` int32 batches over a
    flat token corpus, sharded across processes.

    The corpus is cut into non-overlapping windows of ``seq+1`` tokens
    (window i covers ``[i*seq, i*seq + seq + 1)`` — adjacent windows share
    one boundary token).  Windows are shuffled per epoch, then dealt
    round-robin to the global batch; this process materializes only rows
    ``process_index::num_processes`` of each global batch.
    """

    def __init__(
        self,
        tokens: np.ndarray,
        batch_global: int,
        seq: int,
        shard: ShardSpec = ShardSpec(),
        seed: int = 0,
        epochs: int | None = None,
    ) -> None:
        tokens = np.asarray(tokens)
        if tokens.ndim != 1:
            raise ValueError(f"corpus must be 1-D, got shape {tokens.shape}")
        if batch_global % shard.num_processes:
            raise ValueError(
                f"global batch {batch_global} not divisible by "
                f"{shard.num_processes} processes"
            )
        self.tokens = tokens
        self.batch_global = batch_global
        self.batch_local = batch_global // shard.num_processes
        self.seq = seq
        self.shard = shard
        self.seed = seed
        self.epochs = epochs
        self.n_windows = window_count(len(tokens), seq)
        if self.n_windows < batch_global:
            raise ValueError(
                f"corpus has {self.n_windows} windows of seq={seq}, "
                f"need at least batch_global={batch_global}"
            )
        self.steps_per_epoch = self.n_windows // batch_global
        self._order_cache: tuple[int, np.ndarray] | None = None

    def _epoch_order(self, epoch: int) -> np.ndarray:
        # One-slot memo: sequential iteration reshuffles once per epoch.
        cached = self._order_cache
        if cached is not None and cached[0] == epoch:
            return cached[1]
        rng = np.random.default_rng((self.seed, epoch))
        order = rng.permutation(self.n_windows)
        self._order_cache = (epoch, order)
        return order

    def batch_at(self, step: int) -> np.ndarray:
        """The local batch for a global step (random access: the resume
        path needs no iterator state)."""
        t0 = time.perf_counter()
        epoch, within = divmod(step, self.steps_per_epoch)
        order = self._epoch_order(epoch)
        start = within * self.batch_global
        rows = order[
            start
            + self.shard.process_index : start
            + self.batch_global : self.shard.num_processes
        ]
        out = np.empty((self.batch_local, self.seq + 1), np.int32)
        for i, w in enumerate(rows):
            out[i] = self.tokens[w * self.seq : w * self.seq + self.seq + 1]
        _ASSEMBLY.observe(time.perf_counter() - t0)
        _BATCHES.inc()
        return out

    def __iter__(self) -> Iterator[np.ndarray]:
        step = 0
        while True:
            if (
                self.epochs is not None
                and step >= self.epochs * self.steps_per_epoch
            ):
                return
            yield self.batch_at(step)
            step += 1
