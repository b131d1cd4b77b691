"""Logical-dimension → mesh-axis sharding rules, and shard placement.

Arrays are annotated with *logical* dimension names ("batch", "seq",
"heads", ...); ``ShardingRules`` maps those to mesh axes, as in
``oim_tpu/parallel/sharding.py``, so a model names its dimensions once
and the rules decide the parallelism.

The reference then hands the arrays to GSPMD, which keeps each device's
block and inserts the collectives.  Here a rank holds its block as a
**plain local tensor**, not a ``DTensor``: ``shard(x, spec, mesh)``
returns this rank's slice, and the model code calls the collectives
itself (``parallel/collectives.py``).  Two reasons: the Hopper kernels
take plain tensors with known strides, and a CUDA graph must see fixed
addresses and no per-op ``DTensor`` dispatch on the host (a decode chunk
is one replay).

``block_slices`` names a block as a region of the whole tensor (what a
sharded checkpoint records); ``constrain`` and ``shard_pytree`` belong
to the second half of the training part of the port.
"""

from __future__ import annotations

from dataclasses import dataclass


class PartitionSpec(tuple):
    """One mesh axis (a name, a tuple of names, or None) a dimension."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclass(frozen=True)
class ShardingRules:
    batch: str | None = "dp"
    seq: str | None = "sp"
    heads: str | None = "tp"
    model: str | None = None  # d_model stays replicated by default
    mlp: str | None = "tp"  # ffn hidden
    vocab: str | None = "tp"
    experts: str | None = "ep"
    stages: str | None = "pp"  # stacked pipeline stage dimension

    def axis_for(self, logical: str | None) -> str | None:
        if logical is None:
            return None
        try:
            return getattr(self, logical)
        except AttributeError:
            raise ValueError(f"unknown logical dimension {logical!r}") from None


DEFAULT_RULES = ShardingRules()


def partition_spec(logical_dims: tuple[str | None, ...],
                   rules: ShardingRules = DEFAULT_RULES) -> PartitionSpec:
    return PartitionSpec(*(rules.axis_for(dim) for dim in logical_dims))


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def fitted(shape, spec, mesh) -> PartitionSpec:
    """``spec`` with each axis dropped from a dimension it does not
    divide (the reference's rule for serving params: an odd vocab
    replicates ``wte``/``wlm`` while heads and mlp still shard)."""
    return PartitionSpec(*(
        entry if entry is not None
        and shape[i] % mesh.axis_size(_axes(entry)) == 0 else None
        for i, entry in enumerate(spec)))


def shard(x, spec, mesh):
    """This rank's block of ``x`` under ``spec``: for each dimension
    with an axis, the slice at this rank's index over it.  A dimension
    the axis does not divide raises (``fitted`` first replicates it).
    A view where the slicing allows one; ``contiguous()`` it to own
    it."""
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} has more entries than x's "
                         f"{x.dim()} dims")
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        n = mesh.axis_size(axes)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"divide over {axes} ({n})")
        size = x.shape[dim] // n
        x = x.narrow(dim, mesh.axis_index(axes) * size, size)
    return x


def block_slices(shape, spec, mesh) -> list:
    """``[(start, size)]`` along each dimension of a whole tensor of
    ``shape``: the block that this rank holds under ``spec``, as
    ``shard`` cuts it (None: replicated, the whole)."""
    out = [(0, int(n)) for n in shape]
    for dim, entry in enumerate(spec or ()):
        axes = _axes(entry)
        if not axes:
            continue
        size = out[dim][1] // mesh.axis_size(axes)
        out[dim] = (mesh.axis_index(axes) * size, size)
    return out


def sharded_axes(spec, mesh) -> tuple:
    """The axes of size above 1 that cut some dimension under
    ``spec``."""
    return tuple(a for entry in (spec or ()) for a in _axes(entry)
                 if mesh.shape[a] > 1)
