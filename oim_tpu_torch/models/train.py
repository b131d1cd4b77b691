"""Training on one device: next-token loss, gradients, the AdamW step.

The reference (``oim_tpu/models/train.py``) differentiates a per-device
objective with static normalizers inside ``shard_map`` and psums the
gradients over the mesh.  On one device every mesh axis has size 1, so
the psums and the sequence-shard label hop vanish and what remains is
ported here: ``_shifted_labels``, ``_masked_ce_sum``, the objective
``_local_objective`` (static normalizer, ``AUX_LOSS_WEIGHT`` term),
gradient accumulation, and ``make_train_step``/``make_eval_step`` over a
``TrainState``.

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
from dataclasses import dataclass

import torch

from oim_tpu_torch.models.transformer import (
    AUX_LOSS_WEIGHT,
    TransformerConfig,
    forward_hidden,
    forward_local,
)
from oim_tpu_torch.ops import counts
from oim_tpu_torch.ops.fused_ce import fused_linear_ce


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


def _objective_terms(params, tokens, cfg: TransformerConfig):
    """The training objective on a [b, t] batch and its terms: ``(obj,
    ce_sum, ce_count, aux)``.  ``obj`` divides by the STATIC count
    ``b·(t-1)`` — with sequence packing the separator labels drop out of
    ``ce_sum`` but not of the denominator, so per-token weights do not
    depend on how many documents a batch packs — and adds
    ``AUX_LOSS_WEIGHT · aux``, the MoE layers' summed aux (0 for a dense
    model): the reference's objective on one device, where its aux
    divisor ``dp · sp`` is 1."""
    labels, valid, _ = _shifted_labels(tokens, cfg.doc_sep_id)
    if cfg.use_pallas and cfg.fused_ce:
        hidden, aux = forward_hidden(params, tokens, cfg)
        ce_sum, ce_count = _fused_ce_sum(hidden, params["wlm"], labels,
                                         valid, cfg)
    else:
        logits, aux = forward_local(params, tokens, cfg)
        ce_sum, ce_count = _masked_ce_sum(logits, labels, valid)
    b, t = tokens.shape
    obj = ce_sum / float(b * (t - 1)) + AUX_LOSS_WEIGHT * aux
    return obj, ce_sum, ce_count, aux


def _local_objective(params, tokens, cfg: TransformerConfig):
    """``(obj, (ce_sum, ce_count))`` of ``_objective_terms``: the
    reference's signature."""
    obj, ce_sum, ce_count, _ = _objective_terms(params, tokens, cfg)
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


def named_parameters(params: dict):
    """``(name, tensor)`` over a port parameter dict in its order, layers
    as ``layers.<i>.<name>`` — the model's parameters or LoRA's
    adapters."""
    for name, value in params.items():
        if name == "layers":
            for i, lp in enumerate(value):
                for leaf, t in lp.items():
                    yield f"layers.{i}.{leaf}", t
        else:
            yield name, value


# ``make_optimizer``'s constructions: the trainer's, then the control.
OPTIMIZER_KINDS = ("fused", "per_tensor")


def make_optimizer(params: dict, opt: OptimizerConfig, kind: str = "fused"):
    """AdamW over the master ``params`` in two groups: decay on every
    parameter, except those named ``*_norm`` (the reference's mask).
    ``kind`` "fused" is the trainer's update; "per_tensor" updates one
    tensor at a time.  The learning rate is a 0-d f32 tensor on the
    parameters' device; on the GPU both are capturable."""
    if kind not in OPTIMIZER_KINDS:
        raise ValueError(f"optimizer kind {kind!r} not in {OPTIMIZER_KINDS}")
    decay, no_decay = [], []
    for name, value in named_parameters(params):
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


def load_optimizer_state(optimizer, saved: dict) -> None:
    """``optimizer.load_state_dict(saved)`` that keeps ``optimizer``'s
    own construction.  ``load_state_dict`` takes each group's settings
    from ``saved``, so a state written by another construction (the
    per-tensor update of earlier checkpoints, its step counts on the
    host) would switch the update; here the moments and step counts are
    restored, every group keeps its settings (the learning-rate tensor,
    fused, capturable), and a fused or capturable update's step counts
    move to their parameters' device in f32."""
    settings = [{k: v for k, v in group.items() if k != "params"}
                for group in optimizer.param_groups]
    optimizer.load_state_dict(saved)
    for group, kept in zip(optimizer.param_groups, settings):
        group.update(kept)
        if not (group["fused"] or group["capturable"]):
            continue
        for value in group["params"]:
            state = optimizer.state.get(value)
            if state and "step" in state:
                state["step"] = state["step"].to(device=value.device,
                                                 dtype=torch.float32)


def clip_by_global_norm(grads: list, max_norm: float) -> None:
    """optax ``clip_by_global_norm``, in place: leave the gradients when
    their global norm is below ``max_norm``, else scale each to
    ``g / norm * max_norm`` (``clip_grad_norm_`` adds 1e-6 to the norm,
    so it is not the same)."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


@dataclass
class TrainState:
    """Master parameters (f32, requiring grad), their AdamW, and the
    number of updates taken."""

    params: dict
    optimizer: torch.optim.Optimizer
    opt: OptimizerConfig
    step: int = 0

    @classmethod
    def create(cls, params: dict, opt: OptimizerConfig,
               kind: str = "fused") -> "TrainState":
        for _, value in named_parameters(params):
            value.requires_grad_(True)
        return cls(params=params,
                   optimizer=make_optimizer(params, opt, kind), opt=opt)


def _step_body(state: TrainState, tokens, cfg: TransformerConfig,
               model_params, extra) -> tuple:
    """One step's device work on ``tokens`` [b, t]: every microbatch's
    objective and backward (gradients summed into ``.grad``), the
    optional clip, the update.  Returns the 0-d (loss, ce, aux)."""
    accum = cfg.grad_accum
    b = tokens.shape[0]
    leaves = [value for _, value in named_parameters(state.params)]
    loss = torch.zeros((), device=tokens.device)
    ce = torch.zeros((), device=tokens.device)
    aux = torch.zeros((), device=tokens.device)
    for micro in tokens.reshape(accum, b // accum, -1):
        params = (state.params if model_params is None
                  else model_params(state.params, *extra))
        obj, ce_sum, ce_count, micro_aux = _objective_terms(params, micro,
                                                            cfg)
        (obj / accum).backward()
        loss += obj.detach()
        ce += ce_sum.detach() / ce_count
        aux += micro_aux.detach()
    if state.opt.grad_clip > 0:
        clip_by_global_norm([v.grad for v in leaves], state.opt.grad_clip)
    state.optimizer.step()
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

    def __init__(self, cfg: TransformerConfig, model_params, cuda_graph):
        self.cfg, self.model_params = cfg, model_params
        self.cuda_graph = cuda_graph
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
                    cuda_graph: bool = True):
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
    time."""
    return _TrainStep(cfg, model_params, cuda_graph)


def make_train_loop(cfg: TransformerConfig, model_params=None,
                    cuda_graph: bool = True):
    """``loop(state, token_batches [n, b, t], *extra) -> (state, {"loss",
    "ce", "aux"} each [n])``: the reference's ``make_train_loop``, n
    steps of one ``make_train_step`` over the batches in order, the
    metrics stacked on the device.  On the GPU every step after the
    loop's first is a replay of the step's graph, n of them queued with
    no sync between them; on the CPU n eager steps."""
    step = make_train_step(cfg, model_params, cuda_graph)

    def loop(state: TrainState, token_batches, *extra):
        metrics = [step(state, tokens, *extra)[1] for tokens in token_batches]
        return state, {name: torch.stack([m[name] for m in metrics])
                       for name in ("loss", "ce", "aux")}

    loop.stats = step.stats
    return loop


def make_eval_step(cfg: TransformerConfig):
    """``eval_step(params, tokens) -> ce``: the aux-free cross entropy
    over the valid positions (perplexity = exp(ce)), no gradients."""

    def eval_step(params, tokens):
        with torch.no_grad():
            _, (ce_sum, ce_count) = _local_objective(params, tokens, cfg)
        return ce_sum / ce_count

    return eval_step
