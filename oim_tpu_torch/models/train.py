"""Training: next-token loss, gradients, the AdamW step, on one device
or over a ``dp``·``tp``·``ep`` mesh.

The reference (``oim_tpu/models/train.py``) differentiates a per-device
objective with static normalizers inside ``shard_map`` and psums the
gradients over the mesh.  Ported here: ``_shifted_labels``,
``_masked_ce_sum``, the objective ``_local_objective`` (static
normalizer, ``AUX_LOSS_WEIGHT`` term), gradient accumulation, and
``make_train_step``/``make_eval_step`` over a ``TrainState``.

**On a mesh** (``make_train_step(cfg, mesh=...)``; one process a
device, ``parallel/``) each rank holds its block of every f32 master
(``models/weights.py::init_rank_params``) and runs the model
``models/weights.py::train_config`` gives it: on a pure ``dp`` mesh the
one-device model with the kernels, under ``tp`` or ``ep`` the plain
layer math with differentiable collectives (``use_pallas`` off: the
reference's ``_manual_setup`` gate).  The objective is the reference's,
``ce_sum / c_global + AUX_LOSS_WEIGHT · aux / dp`` with ``c_global =
b_local · dp · (t − 1)``; no collective touches it.  After the backward
each gradient is all-reduced over ``dp`` (in place: autograd is done
with them); a replicated leaf comes out whole and equal on every tp/ep
rank through ``copy_to``/``reduce_from``'s pairing
(``models/transformer.py``), a sharded one is its block's.  Metrics are
forward-only sums over ``dp``.  ``clip_by_global_norm`` sums each
sharded leaf's squares over its axes and counts each replicated leaf
once: the norm of the whole gradient.  Under a vocab-sharded ``wlm``
the loss is a vocab-parallel log-sum-exp (``_vocab_parallel_ce_sum``):
the [b, t, V] logits are never gathered.

**ZeRO-1** (``TrainState.create(..., zero1=True)``): each rank's AdamW
owns the moments of its ``1/dp`` slice of every leaf, cut along the
reference's dimension (the first the tp/ep layout leaves whole that
``dp`` divides; a leaf with none keeps whole moments).  The gradients
are all-reduced (not reduce-scattered) and clipped whole, the fused
update runs on each slice, and the updated slices are all-gathered over
``dp`` into the masters: the math is the non-sharded update's.  A slice
whose elements are contiguous in the master is a view of it (its
gradient a view of the master's gradient); another is a copy that the
step refreshes.

The optimizer is the reference trainer's optax chain
(``oim_tpu/cli/train_main.py``): ``clip_by_global_norm`` (optional),
then ``adamw`` (b1 0.9, b2 0.999, eps 1e-8) with weight decay masked off
every ``*_norm`` parameter, and a constant, linear-warmup or
warmup-cosine learning rate with optax's count semantics (the first
update uses ``schedule(0)``).  It is ``torch.optim.AdamW`` with two
parameter groups — the same update, decoupled decay on the pre-update
value — with ``fused=True``: one pass reads each parameter, gradient and
both moments and writes the three back, and holds no temporary (the
multi-tensor update holds one the size of every parameter, 6.6 GiB at
1.78 B parameters; the per-tensor update makes ~6 passes).  Its step
counts and its learning rate are device tensors (``capturable`` on the
GPU), so the update runs inside the step's CUDA graph: the schedule is
computed on the host, as optax's, and written into the rate's tensor
before each step (``set_learning_rate``).  ``make_optimizer(...,
kind="per_tensor")`` is the capturable per-tensor update, the A/B
control.

With ``use_pallas and fused_ce`` (the configuration's default, as in
the reference) the loss takes the fused unembed+CE branch: the
final-norm hidden states go straight into ``ops/fused_ce.py``'s kernels
and the [b, t, V] logits are never built.

The reference jits its step; on the GPU ``make_train_step`` replays it
as one CUDA graph (forward, backward, clip, update and metrics), and
``make_train_loop`` is the reference's N-step loop over it.
"""

from __future__ import annotations

import collections
import functools
import math
import time
from dataclasses import dataclass, field

import torch

from oim_tpu_torch.models.transformer import (
    AUX_LOSS_WEIGHT,
    TransformerConfig,
    forward_hidden,
    forward_local,
    named_parameters,
)
from oim_tpu_torch.models.weights import spec_of, train_config
from oim_tpu_torch.ops import counts
from oim_tpu_torch.ops.fused_ce import fused_linear_ce
from oim_tpu_torch.parallel import collectives
from oim_tpu_torch.parallel.sharding import sharded_axes


def _shifted_labels(tokens, doc_sep_id: int = -1):
    """Next-token labels and validity for a [b, t] batch on one device:
    ``(labels [b, t], valid [b, t] bool, positions [t])``.  The last
    position has no next token (its label wraps to the first and is
    masked); with sequence packing, labels that are a separator drop
    out (the separator opens the next document)."""
    t = tokens.shape[1]
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    positions = torch.arange(t, device=tokens.device)
    valid = (positions < t - 1).expand(tokens.shape)
    if doc_sep_id >= 0:
        valid = valid & (labels != doc_sep_id)
    return labels, valid, positions


def _masked_ce_sum(logits, labels, valid):
    """(Σ of valid-position next-token NLL, number of valid positions):
    ``logsumexp(logits) - logits[label]`` without a log-softmax tensor."""
    lse = torch.logsumexp(logits, dim=-1)
    target = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = lse - target
    validf = valid.to(torch.float32)
    return torch.sum(nll * validf), torch.sum(validf)


def _vocab_parallel_ce_sum(logits, labels, valid, cfg):
    """``_masked_ce_sum`` of vocab-sharded logits [b, t, V/tp] (this
    rank's columns): the log-sum-exp from a max and a sum of exps over
    ``tp``, the label's logit from the rank that owns it; nothing
    gathers the [b, t, V] logits."""
    mesh, v = cfg.mesh, logits.shape[-1]
    top = collectives.pmax(logits.detach().amax(dim=-1), mesh, "tp")
    total = collectives.reduce_from(
        torch.sum(torch.exp(logits - top[..., None]), dim=-1), mesh, "tp")
    local = labels - mesh.axis_index("tp") * v
    inside = (local >= 0) & (local < v)
    picked = torch.gather(logits, -1, local.clamp(0, v - 1)[..., None])
    target = collectives.reduce_from(
        torch.where(inside, picked[..., 0], 0.0), mesh, "tp")
    nll = top + torch.log(total) - target
    validf = valid.to(torch.float32)
    return torch.sum(nll * validf), torch.sum(validf)


def _fused_ce_sum(hidden, wlm, labels, valid, cfg: TransformerConfig):
    """``_masked_ce_sum`` over the fused unembed+CE kernels: the
    final-norm hidden [b, t, D] in the compute dtype and the f32 master
    ``wlm`` (cast to the compute dtype for the kernels; its gradient
    comes back f32) instead of logits, so the [b, t, V] logits exist in
    neither pass."""
    b, t, d = hidden.shape
    nll = fused_linear_ce(
        hidden.to(cfg.compute_dtype).reshape(b * t, d),
        wlm,
        labels.reshape(b * t),
    ).reshape(b, t)
    validf = valid.to(torch.float32)
    return torch.sum(nll * validf), torch.sum(validf)


def _objective_terms(params, tokens, cfg: TransformerConfig, dp: int = 1):
    """The training objective on this rank's [b, t] batch and its terms:
    ``(obj, ce_sum, ce_count, aux)``.  ``obj`` divides by the STATIC
    count ``b·dp·(t-1)`` — with sequence packing the separator labels
    drop out of ``ce_sum`` but not of the denominator, so per-token
    weights do not depend on how many documents a batch packs — and adds
    ``AUX_LOSS_WEIGHT · aux / dp``, the MoE layers' summed aux (0 for a
    dense model): the reference's per-device objective, whose sum over
    the ``dp`` ranks is the global one (its ``sp`` is 1 here)."""
    labels, valid, _ = _shifted_labels(tokens, cfg.doc_sep_id)
    if cfg.use_pallas and cfg.fused_ce:
        hidden, aux = forward_hidden(params, tokens, cfg)
        ce_sum, ce_count = _fused_ce_sum(hidden, params["wlm"], labels,
                                         valid, cfg)
    else:
        logits, aux = forward_local(params, tokens, cfg)
        if getattr(cfg, "vocab_shard", False):
            ce_sum, ce_count = _vocab_parallel_ce_sum(logits, labels, valid,
                                                      cfg)
        else:
            ce_sum, ce_count = _masked_ce_sum(logits, labels, valid)
    b, t = tokens.shape
    obj = ce_sum / float(b * dp * (t - 1)) + AUX_LOSS_WEIGHT * aux / dp
    return obj, ce_sum, ce_count, aux


def _local_objective(params, tokens, cfg: TransformerConfig, dp: int = 1):
    """``(obj, (ce_sum, ce_count))`` of ``_objective_terms``: the
    reference's signature."""
    obj, ce_sum, ce_count, _ = _objective_terms(params, tokens, cfg, dp)
    return obj, (ce_sum, ce_count)


# ---------------------------------------------------------------------------
# Optimizer


@dataclass(frozen=True)
class OptimizerConfig:
    """The reference trainer's optimizer flags: ``lr`` peak,
    ``warmup_steps`` of linear warmup from 0, ``decay_steps`` of cosine
    decay to 0 after the warmup (0 = no decay), adamw ``weight_decay``
    on every parameter not named ``*_norm``, and ``grad_clip`` as a
    global-norm bound (0 = off)."""

    lr: float = 3e-4
    warmup_steps: int = 0
    decay_steps: int = 0
    weight_decay: float = 1e-4
    grad_clip: float = 0.0

    def __post_init__(self):
        if self.warmup_steps < 0 or self.decay_steps < 0:
            raise ValueError("warmup_steps and decay_steps must be >= 0")
        if self.decay_steps and max(self.warmup_steps, 1) >= (
                self.warmup_steps + self.decay_steps):
            # optax's cosine_decay_schedule refuses a non-positive span.
            raise ValueError(
                f"decay_steps={self.decay_steps} leaves no cosine span "
                f"after warmup_steps={max(self.warmup_steps, 1)}")

    def learning_rate(self, count: int) -> float:
        """The rate of update number ``count`` (from 0), as the reference
        builds it: ``warmup_cosine_decay_schedule(0, lr, max(warmup, 1),
        warmup + decay)``, else ``linear_schedule(0, lr, warmup)``, else
        the constant ``lr``."""
        if self.decay_steps:
            warmup = max(self.warmup_steps, 1)
            if count < warmup:
                return _linear(count, self.lr, warmup)
            span = self.warmup_steps + self.decay_steps - warmup
            done = min(float(count - warmup), float(span))
            return self.lr * 0.5 * (1.0 + math.cos(math.pi * done / span))
        if self.warmup_steps:
            return _linear(count, self.lr, self.warmup_steps)
        return self.lr


def _linear(count: int, peak: float, steps: int) -> float:
    """optax ``linear_schedule(0, peak, steps)`` at ``count``."""
    frac = 1.0 - min(max(count, 0), steps) / steps
    return (0.0 - peak) * frac + peak


# ``make_optimizer``'s constructions: the trainer's, then the control.
OPTIMIZER_KINDS = ("fused", "per_tensor")


def make_optimizer(params, opt: OptimizerConfig, kind: str = "fused"):
    """AdamW over the master ``params`` (a parameter dict, or ``(name,
    tensor)`` pairs: ZeRO-1's slices) in two groups: decay on every
    parameter, except those named ``*_norm`` (the reference's mask).
    ``kind`` "fused" is the trainer's update; "per_tensor" updates one
    tensor at a time.  The learning rate is a 0-d f32 tensor on the
    parameters' device; on the GPU both are capturable."""
    if kind not in OPTIMIZER_KINDS:
        raise ValueError(f"optimizer kind {kind!r} not in {OPTIMIZER_KINDS}")
    named = named_parameters(params) if isinstance(params, dict) else params
    decay, no_decay = [], []
    for name, value in named:
        (no_decay if name.endswith("_norm") else decay).append(value)
    device = (decay + no_decay)[0].device
    lr = torch.tensor(opt.learning_rate(0), dtype=torch.float32,
                      device=device)
    return torch.optim.AdamW(
        [dict(params=decay, weight_decay=opt.weight_decay),
         dict(params=no_decay, weight_decay=0.0)],
        lr=lr, betas=(0.9, 0.999), eps=1e-8,
        fused=kind == "fused", foreach=None if kind == "fused" else False,
        capturable=device.type == "cuda",
    )


def set_learning_rate(optimizer, lr: float) -> None:
    """Write ``lr`` into the optimizer's learning-rate tensor in place: a
    fill on its device (no copy, no sync), which the next update reads,
    a replayed one too."""
    for group in optimizer.param_groups:
        group["lr"].fill_(lr)


def set_moments(optimizer, tensor, step: float, exp_avg,
                exp_avg_sq) -> None:
    """Give the AdamW ``optimizer`` the state of its parameter ``tensor``
    (a restore): the update count and both moments, copied into tensors
    laid out as the update makes its own (a fused or capturable update
    keeps its count as an f32 tensor on the parameter's device)."""
    group = next(g for g in optimizer.param_groups
                 if any(p is tensor for p in g["params"]))
    on_device = group["fused"] or group["capturable"]
    optimizer.state[tensor] = {
        "step": torch.tensor(float(step), dtype=torch.float32,
                             device=tensor.device if on_device else "cpu"),
        "exp_avg": exp_avg.to(tensor.device, torch.float32).clone(),
        "exp_avg_sq": exp_avg_sq.to(tensor.device, torch.float32).clone()}


def clip_by_global_norm(grads: list, max_norm: float, mesh=None,
                        axes: list | None = None) -> None:
    """optax ``clip_by_global_norm``, in place: leave the gradients when
    their global norm is below ``max_norm``, else scale each to
    ``g / norm * max_norm`` (``clip_grad_norm_`` adds 1e-6 to the norm,
    so it is not the same).  On a ``mesh``, ``axes[i]`` are the axes
    ``grads[i]``'s leaf is sharded over: each group's squares are summed
    over its axes, a replicated leaf counted once — the whole
    gradient's norm on every rank."""
    if mesh is None:
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    else:
        groups: dict = {}
        for g, over in zip(grads, axes):
            groups.setdefault(tuple(over), []).append(
                torch.linalg.vector_norm(g) ** 2)
        total = torch.zeros((), device=grads[0].device)
        for over in sorted(groups):
            part = torch.sum(torch.stack(groups[over]))
            if over:
                part = collectives.psum(part, mesh, over)
            total = total + part
        norm = torch.sqrt(total)
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


@dataclass
class Owned:
    """What this rank's AdamW updates of one leaf: ``tensor``, the whole
    master ``param`` (``dim`` None) or, under ZeRO-1, its slice
    ``[start, start + size)`` along ``dim`` — a view of ``param`` when
    ``shared``, else a contiguous copy."""

    name: str
    param: torch.Tensor
    tensor: torch.Tensor
    dim: int | None = None
    start: int = 0
    size: int = 0
    shared: bool = True


def zero1_dim(shape, spec, mesh) -> int | None:
    """The dimension ZeRO-1 cuts a leaf's moments along over ``dp``: the
    first that no axis already cuts and that ``dp`` divides (the
    reference's rule, an axis of size 1 counting as no cut: the port's
    leaves have no stacked layer dimension, and a cut along dimension 0
    keeps the slice a view of the master); None when there is none (or
    ``dp`` is 1)."""
    dp = mesh.shape["dp"]
    if dp == 1:
        return None
    entries = list(spec or ()) + [None] * (len(shape) - len(spec or ()))
    for dim, (entry, n) in enumerate(zip(entries, shape)):
        cut = entry is not None and sharded_axes((entry,), mesh)
        if not cut and n % dp == 0:
            return dim
    return None


def _owned(params: dict, specs: dict, mesh, zero1: bool) -> list:
    """Every leaf's ``Owned`` (see there) on this rank."""
    out = []
    for name, value in named_parameters(params):
        dim = (zero1_dim(value.shape, spec_of(specs, name), mesh)
               if zero1 and mesh is not None else None)
        if dim is None:
            out.append(Owned(name, value, value))
            continue
        size = value.shape[dim] // mesh.shape["dp"]
        start = mesh.axis_index("dp") * size
        view = value.detach().narrow(dim, start, size)
        shared = view.is_contiguous()
        out.append(Owned(name, value, view if shared else view.clone(), dim,
                         start, size, shared))
    return out


@dataclass
class TrainState:
    """Master parameters (f32, requiring grad: this rank's blocks on a
    ``mesh``), their AdamW over ``owned`` (the leaves, or ZeRO-1's
    slices), and the number of updates taken.  ``specs`` are the
    masters' layout on the mesh (``models/weights.py::serve_specs``,
    by leaf name; replicated names absent); ``reduce_seconds`` the host
    wall of each eager step's gradient sum over ``dp``."""

    params: dict
    optimizer: torch.optim.Optimizer
    opt: OptimizerConfig
    step: int = 0
    mesh: object = None
    specs: dict = field(default_factory=dict)
    owned: list = field(default_factory=list)
    reduce_seconds: list = field(default_factory=list)

    @classmethod
    def create(cls, params: dict, opt: OptimizerConfig,
               kind: str = "fused", mesh=None, specs: dict | None = None,
               zero1: bool = False) -> "TrainState":
        for _, value in named_parameters(params):
            value.requires_grad_(True)
        specs = specs or {}
        owned = _owned(params, specs, mesh, zero1)
        return cls(params=params, optimizer=make_optimizer(
            [(o.name, o.tensor) for o in owned], opt, kind), opt=opt,
            mesh=mesh, specs=specs, owned=owned)

    @property
    def zero1(self) -> bool:
        """Whether some leaf's moments are a ``dp`` slice."""
        return any(o.dim is not None for o in self.owned)

    def moment_bytes(self) -> int:
        """Bytes of the AdamW moments this rank holds."""
        return sum(v.numel() * v.element_size()
                   for st in self.optimizer.state.values()
                   for key, v in st.items() if key != "step")


def sums_over_dp(mesh) -> bool:
    """Whether a step on ``mesh`` sums its gradients and metrics over
    ``dp``: above one rank, and on an NCCL mesh always (as the
    reference's psum, a device collective in the step's graph even over
    one rank); a one-rank gloo ``dp`` skips a host round trip that adds
    nothing."""
    return mesh is not None and (mesh.shape["dp"] > 1
                                 or mesh.backend == "nccl")


def replica_checksums(state: TrainState) -> dict:
    """``{name: int}`` over the leaves no mesh axis cuts (every rank
    holds them whole): each leaf's bits as int32 words weighted by their
    position modulo a prime and summed in int64 (wrapping), on its
    device — equal bits give equal sums, so ranks compare replicas
    without moving them."""
    out = {}
    with torch.no_grad():
        for name, value in named_parameters(state.params):
            if state.mesh is not None and sharded_axes(
                    spec_of(state.specs, name), state.mesh):
                continue
            words = value.detach().contiguous().view(torch.int32)
            words = words.reshape(-1).to(torch.int64)
            weights = torch.arange(words.numel(), device=words.device)
            out[name] = int(torch.sum(words * (weights % 65521 + 1)))
    return out


def _reduce_grads(state: TrainState, leaves: list) -> None:
    """On a mesh, after the backward: each gradient summed over ``dp``
    (in place; autograd no longer reads them), clipped whole, and handed
    to ZeRO-1's slices.  The sum's host wall is kept when the step runs
    eagerly (``TrainState.reduce_seconds``: on gloo the collective's
    whole time, the host waiting; on NCCL its launches)."""
    mesh = state.mesh
    if sums_over_dp(mesh):
        t0 = time.perf_counter()
        for value in leaves:
            if value.grad is not None:
                collectives.psum(value.grad, mesh, "dp")
        capturing = (torch.cuda.is_available()
                     and torch.cuda.is_current_stream_capturing())
        if not capturing:
            state.reduce_seconds.append(time.perf_counter() - t0)
    if state.opt.grad_clip > 0:
        axes = None if mesh is None else [
            sharded_axes(spec_of(state.specs, o.name), mesh)
            for o in state.owned]
        clip_by_global_norm([v.grad for v in leaves], state.opt.grad_clip,
                            mesh, axes)
    for o in state.owned:
        if o.dim is not None:
            grad = o.param.grad.narrow(o.dim, o.start, o.size)
            o.tensor.grad = grad if o.shared else grad.contiguous()


def _gather_slices(state: TrainState) -> None:
    """ZeRO-1: every rank's updated slices gathered over ``dp`` into the
    masters."""
    with torch.no_grad():
        for o in state.owned:
            if o.dim is not None:
                o.param.copy_(collectives.all_gather(o.tensor, state.mesh,
                                                     "dp", o.dim))


def _step_body(state: TrainState, tokens, cfg: TransformerConfig,
               model_params, extra) -> tuple:
    """One step's device work on ``tokens`` [b, t]: every microbatch's
    objective and backward (gradients summed into ``.grad``), on a mesh
    the gradients' sum over ``dp``, the optional clip, the update (and
    ZeRO-1's gather).  Returns the 0-d (loss, ce, aux), each the whole
    batch's."""
    accum = cfg.grad_accum
    b = tokens.shape[0]
    mesh = state.mesh
    dp = 1 if mesh is None else mesh.shape["dp"]
    leaves = [value for _, value in named_parameters(state.params)]
    loss = torch.zeros((), device=tokens.device)
    ce = torch.zeros((), device=tokens.device)
    aux = torch.zeros((), device=tokens.device)
    for micro in tokens.reshape(accum, b // accum, -1):
        params = (state.params if model_params is None
                  else model_params(state.params, *extra))
        obj, ce_sum, ce_count, micro_aux = _objective_terms(params, micro,
                                                            cfg, dp)
        (obj / accum).backward()
        terms = torch.stack([obj, ce_sum, ce_count, micro_aux]).detach()
        if sums_over_dp(mesh):  # forward-only: the whole batch's metrics
            collectives.psum(terms, mesh, "dp")
        loss += terms[0]
        ce += terms[1] / terms[2]
        aux += terms[3] / dp
    _reduce_grads(state, leaves)
    state.optimizer.step()
    if state.zero1:
        _gather_slices(state)
    return loss / accum, ce / accum, aux / accum


# Replays whose CUDA events a step function keeps (``replay_ms``).
REPLAY_EVENTS = 64


@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device):
    """The side stream every step function on ``device`` warms up and
    captures on.  One for all: each (cuBLAS handle, stream) pair keeps a
    workspace in the allocator for the life of the process, so a stream
    per step function would leave one more behind each."""
    return torch.cuda.Stream(device)


class _TrainStep:
    """``make_train_step``'s step function; see there."""

    def __init__(self, cfg: TransformerConfig, model_params, cuda_graph,
                 mesh=None):
        self.cfg = cfg if mesh is None else train_config(cfg, mesh)
        self.model_params, self.mesh = model_params, mesh
        # gloo's collectives cannot be captured: a gloo mesh steps eagerly.
        self.cuda_graph = cuda_graph and (mesh is None
                                          or mesh.backend == "nccl")
        self.captures = self.replays = 0
        self.capture_seconds = 0.0
        self.pool_bytes = 0  # what the capture added to the reserved memory
        self._bound = None  # (state, extra, shape, dtype, device)
        self._stream = self._graph = self._tokens = None
        self._metrics: dict = {}
        self._delta: dict = {}
        self._events = collections.deque(maxlen=REPLAY_EVENTS)

    def __call__(self, state: TrainState, tokens, *extra):
        b = tokens.shape[0]
        if b % self.cfg.grad_accum:
            raise ValueError(f"global batch {b} not divisible by "
                             f"grad_accum={self.cfg.grad_accum}")
        if state.mesh is not self.mesh:
            raise ValueError("this step function and the state are on "
                             "different meshes")
        if not (self.cuda_graph and tokens.is_cuda):
            return self._eager(state, tokens, extra)
        if self._bound is None:
            return self._first(state, tokens, extra)
        bound = self._bound
        if (state is not bound[0] or len(extra) != len(bound[1])
                or any(a is not c for a, c in zip(extra, bound[1]))
                or (tokens.shape, tokens.dtype, tokens.device) != bound[2:]):
            raise ValueError(
                "this step function's graph is bound to the state, extra "
                f"arguments and batch {tuple(bound[2])} {bound[3]} of its "
                f"first call; got {tuple(tokens.shape)} {tokens.dtype} "
                "(make another step function for another state)")
        if self._graph is None:
            self._capture(state, tokens, extra)
        self._tokens.copy_(tokens)
        set_learning_rate(state.optimizer,
                          state.opt.learning_rate(state.step))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        self._graph.replay()
        end.record()
        self._events.append((start, end))
        counts.replay_counts(self._delta)
        self.replays += 1
        state.step += 1
        # Fresh tensors: the next replay rewrites the graph's own.
        return state, {name: t.clone() for name, t in self._metrics.items()}

    def _eager(self, state: TrainState, tokens, extra):
        for _, value in named_parameters(state.params):
            value.grad = None
        set_learning_rate(state.optimizer,
                          state.opt.learning_rate(state.step))
        loss, ce, aux = _step_body(state, tokens, self.cfg,
                                   self.model_params, extra)
        state.step += 1
        return state, {"loss": loss, "ce": ce, "aux": aux}

    def _first(self, state: TrainState, tokens, extra):
        """The first step, eagerly on the side stream the graph will be
        captured on, so that what a stream sets up at first use (cuBLAS
        workspaces, the optimizer's state) exists before the capture."""
        self._bound = (state, extra, tokens.shape, tokens.dtype,
                       tokens.device)
        if self.mesh is not None:
            self.mesh.warm()  # NCCL makes its communicators eagerly
        current = torch.cuda.current_stream(tokens.device)
        self._stream = _side_stream(tokens.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            out = self._eager(state, tokens, extra)
        current.wait_stream(self._stream)
        return out

    def _capture(self, state: TrainState, tokens, extra) -> None:
        """Capture the whole step over a static token buffer, once.  The
        gradients are dropped first, so that the captured backward
        allocates them in the graph's pool; from here on nothing outside
        the graph touches them.  The allocator's cache is emptied before
        the capture, so the eager step's cached blocks do not stay
        reserved beside the pool, and what the capture reserves is the
        pool.  A failure raises: there is no eager fallback."""
        t0 = time.monotonic()
        for _, value in named_parameters(state.params):
            value.grad = None
        self._tokens = torch.empty_like(tokens)
        torch.cuda.synchronize(tokens.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(tokens.device)
        graph = torch.cuda.CUDAGraph()
        with counts.recording() as delta, torch.cuda.graph(
                graph, stream=self._stream,
                capture_error_mode="thread_local"):
            loss, ce, aux = _step_body(state, self._tokens, self.cfg,
                                       self.model_params, extra)
        self._graph, self._delta = graph, delta
        self._metrics = {"loss": loss, "ce": ce, "aux": aux}
        self.captures += 1
        self.capture_seconds = time.monotonic() - t0
        self.pool_bytes = torch.cuda.memory_reserved(tokens.device) - reserved

    def replay_ms(self) -> list:
        """Device milliseconds of the last ``REPLAY_EVENTS`` replays, by
        CUDA events around each (waits for the last one to finish)."""
        if self._events:
            self._events[-1][1].synchronize()
        return [start.elapsed_time(end) for start, end in self._events]

    def stats(self) -> dict:
        """``{"graphed": a graph exists, "captures", "replays",
        "capture_seconds", "pool_bytes", "replay_ms"}``."""
        return {"graphed": self._graph is not None,
                "captures": self.captures, "replays": self.replays,
                "capture_seconds": self.capture_seconds,
                "pool_bytes": self.pool_bytes,
                "replay_ms": self.replay_ms()}


def make_train_step(cfg: TransformerConfig, model_params=None,
                    cuda_graph: bool = True, mesh=None):
    """``step(state, tokens [b, t], *extra) -> (state, {"loss", "ce",
    "aux"})``: the objective's gradient, averaged over ``cfg.grad_accum``
    equal sequential microbatches, then one optimizer update, in place.
    ``loss``, ``ce`` and the MoE ``aux`` (each a mean over the
    microbatches) are 0-d device tensors.  The objective reads
    ``state.params``, or ``model_params(state.params, *extra)`` when
    given (LoRA: the adapters merged into a frozen base).

    On a CUDA batch with ``cuda_graph`` (the reference jits its step) the
    first call is a real step run eagerly; the second captures the whole
    step — every microbatch's forward and backward, the clip, the update
    and the metrics — as one CUDA graph, and from then on each call
    copies its batch into the graph's token buffer, writes the learning
    rate and replays it, returning the metrics as fresh tensors.  The
    graph holds the first call's state, ``extra`` and batch shape by
    address: a call with others raises, and so does a failed capture.
    The kernels' launch counts include the replays (``ops/counts.py``).
    On the CPU, or without ``cuda_graph``, every call runs eagerly.
    ``step.stats()`` reports the captures, replays and their device
    time.

    On a ``mesh`` (the state's: ``TrainState.create(..., mesh=)``) each
    rank calls the step with its own rows and runs the model
    ``models/weights.py::train_config`` gives it (see the module
    docstring): the step's collectives are in the graph on an NCCL mesh
    (``Mesh.warm`` before the first step), and a gloo mesh steps
    eagerly."""
    return _TrainStep(cfg, model_params, cuda_graph, mesh)


def make_train_loop(cfg: TransformerConfig, model_params=None,
                    cuda_graph: bool = True, mesh=None):
    """``loop(state, token_batches [n, b, t], *extra) -> (state, {"loss",
    "ce", "aux"} each [n])``: the reference's ``make_train_loop``, n
    steps of one ``make_train_step`` over the batches in order, the
    metrics stacked on the device.  On the GPU every step after the
    loop's first is a replay of the step's graph, n of them queued with
    no sync between them; on the CPU n eager steps."""
    step = make_train_step(cfg, model_params, cuda_graph, mesh)

    def loop(state: TrainState, token_batches, *extra):
        metrics = [step(state, tokens, *extra)[1] for tokens in token_batches]
        return state, {name: torch.stack([m[name] for m in metrics])
                       for name in ("loss", "ce", "aux")}

    loop.stats = step.stats
    return loop


def make_eval_step(cfg: TransformerConfig, mesh=None):
    """``eval_step(params, tokens) -> ce``: the aux-free cross entropy
    over the valid positions (perplexity = exp(ce)), no gradients.  On a
    ``mesh`` each rank passes its rows and its blocks, and the sums over
    ``dp`` make ``ce`` the whole batch's on every rank."""
    model = cfg if mesh is None else train_config(cfg, mesh)

    def eval_step(params, tokens):
        with torch.no_grad():
            _, (ce_sum, ce_count) = _local_objective(params, tokens, model)
            if sums_over_dp(mesh):
                terms = collectives.psum(torch.stack([ce_sum, ce_count]),
                                         mesh, "dp")
                ce_sum, ce_count = terms[0], terms[1]
        return ce_sum / ce_count

    return eval_step
