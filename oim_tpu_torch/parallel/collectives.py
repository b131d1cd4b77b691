"""Collectives over a mesh axis, on ``torch.distributed``.

The port's counterpart of ``oim_tpu/parallel/collectives.py``'s
wrappers: ``psum``, ``pmean``, ``all_gather``, ``reduce_scatter``,
``ppermute_shift`` and ``all_to_all`` over one axis of a
``parallel/mesh.py::Mesh`` (or several: ``("tp", "ep")``), with the
reference's semantics inside ``shard_map`` — every rank of the group
calls, each with its own shard.  Each launches on torch's current
stream: NCCL orders its own stream after it and it after NCCL's, so a
CUDA graph capture records the collective (``Mesh.warm`` first makes
the communicators eagerly); gloo waits for the stream, works on the
host and copies back, so it cannot be captured.

**What runs on which backend, in this one place.**  NCCL runs each
primitive natively.  On a gloo group the primitives gloo lacks are
built exactly from one it has: ``reduce_scatter`` is a ``psum`` and
this rank's slice of it (the same sums), ``ppermute_shift`` and
``all_to_all`` an ``all_gather`` and a selection (a copy).  Gloo runs
``all_reduce`` (f32 and bf16), ``all_gather`` and ``broadcast`` on CUDA
tensors too, between processes that share one card, as the card's
probe found (``cli/dist_probe.py``; PERF.md §6); NCCL refuses
two ranks on one card.

Every wrapper counts the primitive it launches (``counters``), and a
CUDA graph's capture records them like kernel launches
(``ops/counts.py``), so replays count collectives too.

**Differentiable collectives (training).**  ``psum`` works in place,
so on a tensor autograd saved it would corrupt the backward without an
error; training goes through three ``torch.autograd.Function``s
instead, each counted through the primitive it launches:
``copy_to`` (identity forward, ``psum`` of the gradient backward: the
input of a column-parallel product, and of whatever reads a replicated
activation on each rank), ``reduce_from`` (``psum`` forward into a new
tensor, identity backward: the output of a row-parallel product and of
the expert sum) and ``gather_from`` (``all_gather`` forward, this
rank's slice backward).  A training step under tp or ep launches
``copy_to``'s and ``reduce_from``'s sums (one each a column- or
row-parallel product, the vocab-sharded lookup and loss, the expert
combine), ``pmax`` for the vocab-parallel log-sum-exp, and in-place
``psum`` only outside autograd: the gradients over ``dp`` after the
backward, the metrics and the clip's norm.  The serving path keeps its
in-place wrappers.

``allreduce_bandwidth`` and ``matmul_throughput`` belong to the
training part of the port (``bench/allreduce.py``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_PRIMITIVES = ("all_reduce", "all_gather", "reduce_scatter", "send_recv",
               "all_to_all")
_COUNTS = dict.fromkeys(_PRIMITIVES, 0)


def counters() -> dict:
    """Launches of each primitive, under ``collective.<name>``."""
    return {f"collective.{name}": n for name, n in _COUNTS.items()}


def reset_counters() -> None:
    for name in _COUNTS:
        _COUNTS[name] = 0


def replay_counts(delta: dict) -> None:
    """Add a captured region's counts (``ops/counts.py::recording``)."""
    for name in _PRIMITIVES:
        _COUNTS[name] += delta.get(f"collective.{name}", 0)


def _count(name: str) -> None:
    _COUNTS[name] += 1


def _gloo(mesh) -> bool:
    return mesh.backend == "gloo"


def psum(x, mesh, axis):
    """The sum of ``x`` over ``axis``, in place on every rank (``x`` is
    returned)."""
    _count("all_reduce")
    dist.all_reduce(x, group=mesh.group(axis))
    return x


def pmax(x, mesh, axis):
    """The elementwise maximum of ``x`` over ``axis``, in place on every
    rank (``x`` is returned)."""
    _count("all_reduce")
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.group(axis))
    return x


def pmean(x, mesh, axis):
    """The mean of ``x`` over ``axis``: ``psum`` divided by the axis
    size, in place for a floating ``x``."""
    return psum(x, mesh, axis).div_(mesh.axis_size(axis))


def all_gather(x, mesh, axis, dim: int = 0):
    """The shards of ``axis`` concatenated along ``dim`` in rank order
    (the reference's ``tiled=True``)."""
    n = mesh.axis_size(axis)
    group = mesh.group(axis)
    x = x.movedim(dim, 0).contiguous()
    if _gloo(mesh):
        parts = [torch.empty_like(x) for _ in range(n)]
        _count("all_gather")
        dist.all_gather(parts, x, group=group)
        out = torch.cat(parts)
    else:
        out = x.new_empty((n * x.shape[0], *x.shape[1:]))
        _count("all_gather")
        dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


def reduce_scatter(x, mesh, axis, dim: int = 0):
    """This rank's slice along ``dim`` of the sum of ``x`` over ``axis``
    (the reference's ``psum_scatter(..., tiled=True)``)."""
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    x = x.movedim(dim, 0).contiguous()
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter: {x.shape[0]} rows over {n} ranks")
    rows = x.shape[0] // n
    if _gloo(mesh):
        out = psum(x.clone(), mesh, axis)[i * rows:(i + 1) * rows]
    else:
        out = x.new_empty((rows, *x.shape[1:]))
        _count("reduce_scatter")
        dist.reduce_scatter_tensor(out, x, group=mesh.group(axis))
    return out.movedim(0, dim)


def ppermute_shift(x, mesh, axis, shift: int = 1):
    """Rotate shards around the ring of ``axis`` by ``shift``: rank i's
    ``x`` lands on rank ``(i + shift) % n``."""
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    if _gloo(mesh):
        return all_gather(x[None], mesh, axis)[(i - shift) % n]
    group = mesh.group(axis)
    ranks = dist.get_process_group_ranks(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    _count("send_recv")
    ops = [dist.P2POp(dist.isend, x, ranks[(i + shift) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(i - shift) % n], group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


def all_to_all(x, mesh, axis, split_axis: int, concat_axis: int):
    """Split ``x`` along ``split_axis`` into one piece a rank of
    ``axis``, send piece j to rank j, and concatenate what arrives along
    ``concat_axis`` in rank order (the reference's ``tiled=True``)."""
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: {x.shape[split_axis]} along axis "
                         f"{split_axis} over {n} ranks")
    if _gloo(mesh):
        every = all_gather(x[None], mesh, axis)  # [n, ...] by source rank
        pieces = [torch.chunk(every[j], n, dim=split_axis)[i]
                  for j in range(n)]
        return torch.cat(pieces, dim=concat_axis)
    send = torch.stack(torch.chunk(x, n, dim=split_axis)).contiguous()
    recv = torch.empty_like(send)
    _count("all_to_all")
    dist.all_to_all_single(recv, send, group=mesh.group(axis))
    return torch.cat(list(recv.unbind(0)), dim=concat_axis)


# ---------------------------------------------------------------------------
# Differentiable collectives (training): see the module docstring.


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x

    @staticmethod
    def backward(ctx, grad):
        return psum(grad.contiguous().clone(), ctx.mesh, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return psum(x.contiguous().clone(), mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ctx.size = x.shape[dim]
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.mesh.axis_index(ctx.axis) * ctx.size
        return grad.narrow(ctx.dim, start, ctx.size), None, None, None


def copy_to(x, mesh, axis):
    """Identity forward; the gradient summed over ``axis`` backward."""
    return _CopyTo.apply(x, mesh, axis)


def reduce_from(x, mesh, axis):
    """The sum of ``x`` over ``axis`` as a new tensor; the gradient
    passes through unchanged backward."""
    return _ReduceFrom.apply(x, mesh, axis)


def gather_from(x, mesh, axis, dim: int):
    """The shards of ``axis`` concatenated along ``dim`` (``all_gather``);
    backward, this rank's slice of the gradient."""
    return _GatherFrom.apply(x, mesh, axis, dim)
