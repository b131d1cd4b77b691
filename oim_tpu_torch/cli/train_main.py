"""oim-train for the port: one device, the reference trainer's flags.

Synthetic (or ``.npy``) tokens → deterministic batches
(``data/loader.py``) → a background copy onto the device
(``data/prefetch.py``) → the training step (``models/train.py``) over
f32 master weights from a seed, with RMSNorm, flash attention and the
fused unembed+CE loss in the Hopper kernels (the configuration's
defaults: no [B, T, V] logits are built).  It runs on the GPU unless
``--device cpu``.

``--checkpoint-dir`` saves every ``--save-every`` steps (asynchronously)
and resumes from the latest step with its data cursor, so re-running the
same command continues an interrupted run; a rescue save runs on the way
out.  ``--export-dir`` writes the params alone after a completed run, for
``serve_main --params-dir``.  ``--lora-rank/--lora-base`` fine-tune
low-rank adapters over a frozen params export; evaluation and the export
use the merged weights.

Usage (full-width Qwen2.5-1.5B geometry on one H100):
    python -m oim_tpu_torch.cli.train_main --synthetic 400000 \\
        --steps 5 --batch-global 4 --seq 1024 --vocab-size 151936 \\
        --d-model 1536 --n-layers 28 --n-heads 12 --n-kv-heads 2 \\
        --d-ff 8960 --attn-bias --rope-theta 1000000 --norm-eps 1e-6 \\
        --dtype bfloat16 --log-every 1

An MoE model (``--n-experts E --moe-top-k k``, optionally
``--router-z-loss``) trains with the reference's capacity routing; each
step logs its aux loss beside the loss.  Mixtral-8x7B's widths with its
depth cut to 2 layers:
    python -m oim_tpu_torch.cli.train_main --synthetic 400000 \\
        --steps 3 --batch-global 2 --seq 1024 --vocab-size 32000 \\
        --d-model 4096 --n-layers 2 --n-heads 32 --n-kv-heads 8 \\
        --d-ff 14336 --n-experts 8 --moe-top-k 2 --router-z-loss 1e-3 \\
        --rope-theta 1000000 --norm-eps 1e-5 --dtype bfloat16

Flags of the reference this slice does not port (mesh axes above 1, so
expert parallelism too; bootstrap; ZeRO-1) are accepted and refused with
the ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from oim_tpu_torch.checkpoint import (
    Checkpointer,
    CheckpointerOptions,
    load_params,
)
from oim_tpu_torch.data.loader import ShardSpec, TokenBatches, window_count
from oim_tpu_torch.data.prefetch import device_prefetch
from oim_tpu_torch.models.lora import (
    init_lora,
    make_lora_train_step,
    merge_lora,
)
from oim_tpu_torch.models.train import (
    OptimizerConfig,
    TrainState,
    make_eval_step,
    make_train_step,
)
from oim_tpu_torch.models.transformer import TransformerConfig, init_params
from oim_tpu_torch.models.weights import check_params
from oim_tpu_torch.serve.engine import resolve_device


def _positive_int(value: str) -> int:
    n = int(value)
    if n < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {n}")
    return n


def _nonneg_int(value: str) -> int:
    n = int(value)
    if n < 0:
        raise argparse.ArgumentTypeError(f"must be >= 0, got {n}")
    return n


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="oim-train-torch", description=__doc__)
    data = p.add_mutually_exclusive_group(required=True)
    data.add_argument("--corpus", help=".npy 1-D int32 token corpus")
    data.add_argument("--synthetic", type=int, metavar="N_TOKENS",
                      help="deterministic synthetic corpus")
    p.add_argument("--steps", type=int, required=True)
    p.add_argument("--batch-global", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--device", default="cuda",
        help="torch device (default cuda; 'cpu' runs the plain path)",
    )
    # Model geometry.
    p.add_argument("--vocab-size", type=int, default=32768)
    p.add_argument("--d-model", type=int, default=512)
    p.add_argument("--n-layers", type=int, default=4)
    p.add_argument("--n-heads", type=int, default=8)
    p.add_argument("--n-kv-heads", type=int, default=0)
    p.add_argument("--d-ff", type=int, default=0)
    p.add_argument("--n-experts", type=int, default=0)
    p.add_argument("--moe-top-k", type=int, default=1)
    p.add_argument(
        "--router-z-loss", type=float, default=0.0,
        help="ST-MoE router z-loss coefficient (paper value 1e-3); "
        "keeps router logits small on long MoE runs (0 = off)",
    )
    p.add_argument("--rope-theta", type=float, default=10000.0)
    p.add_argument("--sliding-window", type=int, default=0)
    p.add_argument("--doc-sep-id", type=int, default=-1)
    p.add_argument("--rope-scaling", type=float, nargs=4, default=[],
                   metavar=("FACTOR", "LOW", "HIGH", "ORIG_MAX"))
    p.add_argument("--norm-eps", type=float, default=1e-6)
    p.add_argument("--attn-bias", action="store_true")
    p.add_argument("--mlp-act", default="silu", choices=["silu", "gelu_tanh"])
    p.add_argument("--norm-offset", action="store_true")
    p.add_argument("--embed-scale", action="store_true")
    p.add_argument("--dtype", default="bfloat16")
    # Mesh flags of the reference, refused above 1 / when set; LoRA and
    # checkpoints.
    for axis in ("dp", "pp", "sp", "tp", "ep"):
        p.add_argument(f"--{axis}", type=int, default=1 if axis != "dp" else 0)
    p.add_argument("--bootstrap", default="")
    p.add_argument("--zero1", action="store_true")
    p.add_argument("--lora-rank", type=_nonneg_int, default=0)
    p.add_argument("--lora-alpha", type=float, default=16.0)
    p.add_argument("--lora-base", default="")
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--save-every", type=_positive_int, default=200,
                   help="checkpoint interval in steps (>= 1)")
    p.add_argument("--export-dir", default="",
                   help="after a completed run, export the params alone "
                   "for serve_main --params-dir")
    # Optimization.
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup-steps", type=_nonneg_int, default=0)
    p.add_argument("--decay-steps", type=_nonneg_int, default=0)
    p.add_argument("--grad-clip", type=float, default=0.0)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--grad-accum", type=_positive_int, default=1)
    # Held-out evaluation on the corpus tail.
    p.add_argument("--eval-every", type=_nonneg_int, default=0)
    p.add_argument("--eval-frac", type=float, default=0.05)
    p.add_argument("--eval-batches", type=_positive_int, default=4)
    p.add_argument("--log-every", type=int, default=10)
    return p


def _check_flags(args) -> None:
    """Raise for each reference flag this slice does not port, naming the
    ROADMAP item that does, and for flags that need another (checked
    before any work, as the reference does)."""
    parallel = "ROADMAP Queue A12: parallelism"
    for axis in ("dp", "pp", "sp", "tp", "ep"):
        if getattr(args, axis) > 1:
            raise ValueError(
                f"--{axis} {getattr(args, axis)}: multi-device training is "
                f"not ported yet ({parallel}); the port trains on one device")
    refused = [
        (args.bootstrap, "--bootstrap", f"{parallel}, coordinator.py"),
        (args.zero1, "--zero1", f"{parallel}, sharding.py"),
    ]
    for given, flag, item in refused:
        if given:
            raise ValueError(f"{flag} is not ported yet ({item})")
    if args.export_dir and not args.checkpoint_dir:
        raise ValueError("--export-dir requires --checkpoint-dir")
    if args.lora_rank and not args.lora_base:
        raise ValueError("--lora-rank requires --lora-base (a params export)")
    if args.lora_base and not args.lora_rank:
        raise ValueError("--lora-base requires --lora-rank >= 1")


def _load_corpus(args) -> np.ndarray:
    """The reference trainer's corpus: the .npy file, or its synthetic
    Markov-ish ramp from ``--seed`` (the same tokens as the reference)."""
    if args.corpus:
        return np.load(args.corpus, mmap_mode="r")
    rng = np.random.default_rng(args.seed)
    base = rng.integers(0, args.vocab_size, size=args.synthetic // 8)
    ramp = (base[:, None] + np.arange(8)[None, :]) % args.vocab_size
    return ramp.reshape(-1).astype(np.int32)


def make_config(args) -> TransformerConfig:
    """The model configuration from parsed args (``use_pallas`` and
    ``fused_ce`` at their defaults: the kernels)."""
    return TransformerConfig(
        vocab_size=args.vocab_size,
        d_model=args.d_model,
        n_layers=args.n_layers,
        n_heads=args.n_heads,
        n_kv_heads=args.n_kv_heads,
        attn_bias=args.attn_bias,
        mlp_act=args.mlp_act,
        norm_offset=args.norm_offset,
        embed_scale=args.embed_scale,
        d_ff=args.d_ff,
        n_experts=args.n_experts,
        moe_top_k=args.moe_top_k,
        router_z_loss=args.router_z_loss,
        rope_theta=args.rope_theta,
        rope_scaling=tuple(args.rope_scaling),
        norm_eps=args.norm_eps,
        sliding_window=args.sliding_window,
        doc_sep_id=args.doc_sep_id,
        grad_accum=args.grad_accum,
        dtype=args.dtype,
    )


def make_optimizer_config(args) -> OptimizerConfig:
    """The optimizer flags as an ``OptimizerConfig``."""
    return OptimizerConfig(lr=args.lr, warmup_steps=args.warmup_steps,
                           decay_steps=args.decay_steps,
                           weight_decay=args.weight_decay,
                           grad_clip=args.grad_clip)


def _log(event: str, **fields) -> None:
    text = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"oim-train {event} {text}", file=sys.stderr, flush=True)


def _eval_fn(args, cfg, tokens, device):
    """(training tokens, ``eval_fn(params) -> ce`` or None): with
    ``--eval-every`` the corpus tail is held out and averaged over
    ``--eval-batches`` distinct batches."""
    if not args.eval_every:
        return tokens, None
    if not 0.0 < args.eval_frac < 1.0:
        raise ValueError(
            f"--eval-frac must be in (0, 1), got {args.eval_frac}")
    n_eval = int(len(tokens) * args.eval_frac)
    if window_count(n_eval, args.seq) < args.batch_global:
        raise ValueError(
            f"eval split of {n_eval} tokens cannot fill one batch of "
            f"{args.batch_global}x(seq+1); raise --eval-frac")
    # Tail split: train never sees the eval tokens.
    eval_tokens = tokens[len(tokens) - n_eval:]
    eval_batches = TokenBatches(eval_tokens, args.batch_global, args.seq,
                                ShardSpec(), seed=args.seed + 1)
    n_eval_batches = min(args.eval_batches, eval_batches.steps_per_epoch)
    eval_step = make_eval_step(cfg)

    def eval_fn(params) -> float:
        ces = []
        for i in range(n_eval_batches):
            batch = torch.from_numpy(eval_batches.batch_at(i)[:, :args.seq])
            ces.append(eval_step(params, batch.long().to(device)))
        return float(torch.stack(ces).mean())

    return tokens[: len(tokens) - n_eval], eval_fn


def train(args) -> dict:
    """Run the training the args describe; returns ``{"losses": [per
    step run], "aux": [per step run], "step_seconds": [...],
    "tokens_per_step", "eval_ce": [...], "start_step", "state"}``.  Step
    times are host walls that end in a device sync (the loss
    readback)."""
    _check_flags(args)
    device = resolve_device(args.device)
    cfg = make_config(args)
    opt = make_optimizer_config(args)
    _log("start", device=device, fused_ce=cfg.fused_ce,
         use_pallas=cfg.use_pallas, remat=cfg.remat, layers=cfg.n_layers,
         d_model=cfg.d_model, vocab=cfg.vocab_size, dtype=cfg.dtype,
         batch=f"{args.batch_global}x{args.seq}")
    lora_base = None
    if args.lora_rank:
        lora_base = load_params(args.lora_base, device=device)
        check_params(lora_base, cfg, f"--lora-base {args.lora_base}")
        _log("lora", rank=args.lora_rank, alpha=args.lora_alpha,
             base=args.lora_base)

    def init_fn() -> TrainState:
        if args.lora_rank:
            return TrainState.create(
                init_lora(args.seed, cfg, args.lora_rank, device=device), opt)
        return TrainState.create(
            init_params(args.seed, cfg, device=device, master=True), opt)

    def merged(state: TrainState) -> dict:
        """The model the run trains: the params, or LoRA's merge."""
        if not args.lora_rank:
            return state.params
        with torch.no_grad():
            return merge_lora(lora_base, state.params, args.lora_alpha,
                              args.lora_rank)

    start_step = 0
    checkpointer = None
    if args.checkpoint_dir:
        checkpointer = Checkpointer(
            args.checkpoint_dir,
            CheckpointerOptions(save_interval_steps=args.save_every))
        state, data_state, resumed = checkpointer.restore_or_init(init_fn)
        if resumed:
            # The data cursor is authoritative for the token stream.
            start_step = int((data_state or {}).get("next_step", state.step))
            _log("resumed", step=start_step)
    else:
        state = init_fn()
    tokens, eval_fn = _eval_fn(args, cfg, _load_corpus(args), device)
    batches = TokenBatches(tokens, args.batch_global, args.seq, ShardSpec(),
                           seed=args.seed)
    if args.lora_rank:
        lora_step = make_lora_train_step(cfg, args.lora_alpha, args.lora_rank)

        def step_fn(state, batch):
            return lora_step(state, lora_base, batch)
    else:
        step_fn = make_train_step(cfg)

    def batch_stream():
        for step in range(start_step, args.steps):
            # The window's +1 boundary token is dropped: labels come from
            # the [b, seq] input itself, as in the reference.
            yield batches.batch_at(step)[:, : args.seq]

    out = {"losses": [], "aux": [], "step_seconds": [], "eval_ce": [],
           "tokens_per_step": args.batch_global * args.seq,
           "start_step": start_step}
    step = start_step
    t0 = time.perf_counter()
    try:
        for batch in device_prefetch(batch_stream(), device):
            state, metrics = step_fn(state, batch.long())
            step += 1
            loss = float(metrics["loss"])  # syncs: the step's wall ends here
            now = time.perf_counter()
            out["losses"].append(loss)
            out["aux"].append(float(metrics["aux"]))
            out["step_seconds"].append(now - t0)
            t0 = now
            if step % args.log_every == 0 or step == args.steps:
                _log("step", step=step, loss=f"{loss:.4f}",
                     ce=f"{float(metrics['ce']):.4f}",
                     aux=f"{out['aux'][-1]:.4f}",
                     tok_per_s=round(out["tokens_per_step"]
                                     / out["step_seconds"][-1]))
            if eval_fn is not None and (step % args.eval_every == 0
                                        or step == args.steps):
                ce = eval_fn(merged(state))
                out["eval_ce"].append(ce)
                _log("eval", step=step, eval_ce=f"{ce:.4f}",
                     eval_ppl=f"{float(np.exp(min(ce, 30.0))):.2f}")
            if checkpointer is not None and step % args.save_every == 0:
                checkpointer.save(state, {"next_step": step})
            t0 = time.perf_counter()
    finally:
        if checkpointer is not None:
            try:
                # Rescue save: an interrupted run resumes where it stopped.
                if checkpointer.latest_step() != step:
                    checkpointer.save(state, {"next_step": step}, force=True)
                if args.export_dir and step >= args.steps:
                    # Completed runs only; an existing export is a prior
                    # completed run's, so re-running stays idempotent.
                    if os.path.exists(args.export_dir):
                        _log("export exists; skipping", dir=args.export_dir)
                    else:
                        # LoRA exports the MERGED weights: serving needs
                        # no LoRA support.
                        checkpointer.export_params(
                            TrainState(params=merged(state), optimizer=None,
                                       opt=opt, step=state.step),
                            args.export_dir)
                        _log("params exported", dir=args.export_dir)
            finally:
                checkpointer.close()  # always await the queued save
    _log("done", steps=step)
    out["state"] = state
    return out


def main(argv=None) -> int:
    train(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
