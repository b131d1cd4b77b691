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
value — whose learning rate is set from the schedule before each step.
It updates one tensor at a time (``foreach=False``, PyTorch's default
on the CPU): the multi-tensor update holds a temporary the size of every
parameter at once (the second moment's square root, 6.6 GiB at 1.78 B
parameters), which set the training step's peak memory on the GPU.

With ``use_pallas and fused_ce`` (the configuration's default, as in
the reference) the loss takes the fused unembed+CE branch: the
final-norm hidden states go straight into ``ops/fused_ce.py``'s kernels
and the [b, t, V] logits are never built.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from oim_tpu_torch.models.transformer import (
    AUX_LOSS_WEIGHT,
    TransformerConfig,
    forward_hidden,
    forward_local,
)
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


def make_optimizer(params: dict, opt: OptimizerConfig):
    """AdamW over the master ``params`` in two groups: decay on every
    parameter, except those named ``*_norm`` (the reference's mask)."""
    decay, no_decay = [], []
    for name, value in named_parameters(params):
        (no_decay if name.endswith("_norm") else decay).append(value)
    return torch.optim.AdamW(
        [dict(params=decay, weight_decay=opt.weight_decay),
         dict(params=no_decay, weight_decay=0.0)],
        lr=opt.learning_rate(0), betas=(0.9, 0.999), eps=1e-8,
        foreach=False,
    )


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
    def create(cls, params: dict, opt: OptimizerConfig) -> "TrainState":
        for _, value in named_parameters(params):
            value.requires_grad_(True)
        return cls(params=params, optimizer=make_optimizer(params, opt),
                   opt=opt)


def make_train_step(cfg: TransformerConfig, model_params=None):
    """``step(state, tokens [b, t], *extra) -> (state, {"loss", "ce",
    "aux"})``: the objective's gradient, averaged over ``cfg.grad_accum``
    equal sequential microbatches, then one optimizer update, in place.
    ``loss``, ``ce`` and the MoE ``aux`` (each a mean over the
    microbatches) are 0-d device tensors.  The objective reads
    ``state.params``, or ``model_params(state.params, *extra)`` when
    given (LoRA: the adapters merged into a frozen base)."""

    def step(state: TrainState, tokens, *extra):
        accum = cfg.grad_accum
        b = tokens.shape[0]
        if b % accum:
            raise ValueError(
                f"global batch {b} not divisible by grad_accum={accum}")
        leaves = [value for _, value in named_parameters(state.params)]
        for value in leaves:
            value.grad = None
        loss = torch.zeros((), device=tokens.device)
        ce = torch.zeros((), device=tokens.device)
        aux = torch.zeros((), device=tokens.device)
        for micro in tokens.reshape(accum, b // accum, -1):
            params = (state.params if model_params is None
                      else model_params(state.params, *extra))
            obj, ce_sum, ce_count, micro_aux = _objective_terms(
                params, micro, cfg)
            (obj / accum).backward()
            loss += obj.detach()
            ce += ce_sum.detach() / ce_count
            aux += micro_aux.detach()
        if state.opt.grad_clip > 0:
            clip_by_global_norm([v.grad for v in leaves], state.opt.grad_clip)
        lr = state.opt.learning_rate(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss / accum, "ce": ce / accum,
                       "aux": aux / accum}

    return step


def make_eval_step(cfg: TransformerConfig):
    """``eval_step(params, tokens) -> ce``: the aux-free cross entropy
    over the valid positions (perplexity = exp(ce)), no gradients."""

    def eval_step(params, tokens):
        with torch.no_grad():
            _, (ce_sum, ce_count) = _local_objective(params, tokens, cfg)
        return ce_sum / ce_count

    return eval_step
