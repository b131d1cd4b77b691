"""oim-train for the port: one device or a dp·tp·ep mesh, the reference
trainer's flags.

Synthetic (or ``.npy``) tokens → deterministic batches
(``data/loader.py``; on a mesh each rank its dp slice) → a background
copy onto the device (``data/prefetch.py``) → the training step
(``models/train.py``) over f32 master weights from a seed, with RMSNorm,
flash attention and the fused unembed+CE loss in the Hopper kernels (the
configuration's defaults: no [B, T, V] logits are built).  It runs on
the GPU unless ``--device cpu``; there every step after the first is one
CUDA graph replay of the whole step, as the reference jits it.

``--dp/--tp/--ep`` train over a mesh of ``dp·tp·ep`` ranks, one process
a device: this process is rank 0 and starts the others (spawned, meeting
through a file rendezvous), NCCL between cards and gloo with ``--device
cpu`` (``--backend gloo`` shares one card among the ranks, eagerly).
``--dp 0`` (the default) takes every visible GPU, with the reference's
refusal when the other axes do not divide them; with ``--device cpu``
it is one rank.  ``--bootstrap FILE`` (default ``$TPU_BOOTSTRAP``)
makes this process one rank of a CSI-staged slice instead
(``parallel/coordinator.py::initialize``, ``dp`` inferred).  A pure dp
mesh runs the one-device model, kernels and all, on each rank; under tp
or ep the plain layer math with explicit collectives (the reference's
gate: its Pallas kernels are off whenever tp or ep is above 1).
``--zero1`` shards the AdamW moments over ``dp``.  Rank 0 logs and
exports; every rank checkpoints its blocks.

``--checkpoint-dir`` saves every ``--save-every`` steps (asynchronously;
sharded on a mesh) and resumes from the latest step with its data
cursor, on whatever mesh the command asks for, so re-running the same
command continues an interrupted run; a rescue save runs on the way
out.  ``--export-dir`` writes the whole params alone after a completed
run, for ``serve_main --params-dir``.  ``--lora-rank/--lora-base``
fine-tune low-rank adapters over a frozen params export (on one device
or a dp mesh); evaluation and the export use the merged weights.

Usage (full-width Qwen2.5-1.5B geometry on one H100):
    python -m oim_tpu_torch.cli.train_main --synthetic 400000 \\
        --steps 5 --batch-global 4 --seq 1024 --vocab-size 151936 \\
        --d-model 1536 --n-layers 28 --n-heads 12 --n-kv-heads 2 \\
        --d-ff 8960 --attn-bias --rope-theta 1000000 --norm-eps 1e-6 \\
        --dtype bfloat16 --log-every 1

The same at two data-parallel ranks with ZeRO-1 and checkpoints (two
GPUs; on one, ``--backend gloo`` runs both ranks on it), or on the CPU
at a tiny width with ``--device cpu --dp 2``:
    python -m oim_tpu_torch.cli.train_main ... --dp 2 --zero1 \\
        --checkpoint-dir /tmp/ckpt

An MoE model (``--n-experts E --moe-top-k k``, optionally
``--router-z-loss``) trains with the reference's capacity routing; each
step logs its aux loss beside the loss.  Mixtral-8x7B's widths with its
depth cut to 2 layers:
    python -m oim_tpu_torch.cli.train_main --synthetic 400000 \\
        --steps 3 --batch-global 2 --seq 1024 --vocab-size 32000 \\
        --d-model 4096 --n-layers 2 --n-heads 32 --n-kv-heads 8 \\
        --d-ff 14336 --n-experts 8 --moe-top-k 2 --router-z-loss 1e-3 \\
        --rope-theta 1000000 --norm-eps 1e-5 --dtype bfloat16

Flags of the reference this slice does not port (``--pp/--sp`` above 1,
``--attn-impl``, ``--pp-schedule`` and ``--n-microbatches`` off their
defaults, LoRA under tp or ep) are accepted and refused with the
ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse
import datetime
import os
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from oim_tpu_torch import log
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
    replica_checksums,
)
from oim_tpu_torch.models.transformer import TransformerConfig, init_params
from oim_tpu_torch.ops import counts
from oim_tpu_torch.models.weights import (
    block_bytes,
    check_params,
    init_rank_params,
    serve_specs,
    train_config,
)
from oim_tpu_torch.parallel import (
    apply_chip_binding,
    build_mesh,
    initialize,
    load_bootstrap,
)
from oim_tpu_torch.parallel.mesh import mesh_devices
from oim_tpu_torch.serve.engine import resolve_device

# What refusals of the flags this slice does not port name.
SECOND_HALF = ("ROADMAP Queue A12, third part, second half: sequence and "
               "pipeline parallelism")
# How long a rank waits in a collective for its peers (a peer that died
# fails the others instead of hanging them).
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


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
    # The reference's sequence- and pipeline-parallel flags: their
    # defaults only (A12's second half).
    p.add_argument("--attn-impl", default="ring", choices=["ring", "ulysses"])
    p.add_argument("--pp-schedule", default="gpipe", choices=["gpipe", "1f1b"])
    p.add_argument("--n-microbatches", type=int, default=1)
    # Mesh: explicit axes, or inferred from the CSI-staged bootstrap.
    p.add_argument("--dp", type=int, default=0,
                   help="0 = every visible GPU left by the other axes "
                   "(one rank with --device cpu)")
    p.add_argument("--pp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--ep", type=int, default=1)
    p.add_argument(
        "--bootstrap", default="",
        help="tpu-bootstrap.json path (default: $TPU_BOOTSTRAP when set): "
        "this process is one rank of the staged slice",
    )
    p.add_argument(
        "--backend", default="", choices=["", "nccl", "gloo"],
        help="the ranks' collectives: nccl (default on the GPU) or gloo "
        "(the default with --device cpu; on the GPU it lets ranks share "
        "a card, and steps run eagerly)",
    )
    p.add_argument(
        "--zero1", action="store_true",
        help="ZeRO-1: shard adamw moments over the dp axis (optimizer "
        "memory / dp; math unchanged — the update all-gathers params)",
    )
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
    p.add_argument("--log-level", default="info")
    return p


def _check_flags(args) -> None:
    """``SystemExit`` for each reference flag this slice does not port,
    naming the ROADMAP item that does, and for flags that need another
    (the reference's messages, checked before any work)."""
    for axis in ("pp", "sp"):
        if getattr(args, axis) > 1:
            raise SystemExit(
                f"--{axis} {getattr(args, axis)} is not ported yet "
                f"({SECOND_HALF})")
    defaults = (("attn_impl", "ring"), ("pp_schedule", "gpipe"),
                ("n_microbatches", 1))
    for name, default in defaults:
        if getattr(args, name) != default:
            raise SystemExit(
                f"--{name.replace('_', '-')} {getattr(args, name)} is not "
                f"ported yet ({SECOND_HALF})")
    for axis in ("dp", "tp", "ep"):
        if getattr(args, axis) < (0 if axis == "dp" else 1):
            raise SystemExit(f"--{axis} {getattr(args, axis)} is out of "
                             "range")
    if args.export_dir and not args.checkpoint_dir:
        raise SystemExit("--export-dir requires --checkpoint-dir")
    if args.lora_rank and not args.lora_base:
        raise SystemExit("--lora-rank requires --lora-base (a params export)")
    if args.lora_base and not args.lora_rank:
        raise SystemExit("--lora-base requires --lora-rank >= 1")
    if args.lora_rank and (args.tp > 1 or args.ep > 1):
        raise SystemExit(
            f"--lora-rank under --tp {args.tp} --ep {args.ep} is not ported "
            f"yet ({SECOND_HALF}, LoRA under tp/ep); LoRA trains on one "
            "device or a dp mesh")
    if args.backend == "nccl" and torch.device(args.device).type == "cpu":
        raise SystemExit("--backend nccl needs the GPU; --device cpu runs "
                         "gloo")


def _bootstrap_path(args) -> str:
    return args.bootstrap or os.environ.get("TPU_BOOTSTRAP", "")


def mesh_sizes(args) -> dict:
    """``{"dp", "tp", "ep"}`` of the mesh the flags ask for (no
    bootstrap): ``--dp 0`` is every visible GPU the other axes leave (the
    reference's inference from its device count, and its refusal when
    they do not divide), or one rank with ``--device cpu``."""
    fixed = args.pp * args.sp * args.tp * args.ep
    dp = args.dp
    if not dp:
        if torch.device(args.device).type == "cpu":
            dp = 1
        else:
            n = torch.cuda.device_count()
            dp = n // fixed
            if dp * fixed != n:
                # Inferred dp flooring would silently idle GPUs; make the
                # operator choose.
                raise SystemExit(
                    f"{n} devices not divisible by pp*sp*tp*ep={fixed}; "
                    "pass --dp explicitly (a sub-mesh is allowed when "
                    "explicit)")
    return {"dp": dp, "tp": args.tp, "ep": args.ep}


def _backend(args) -> str:
    if torch.device(args.device).type == "cpu":
        return "gloo"
    return args.backend or "nccl"


def _devices(args, n: int) -> list:
    """One device a rank: the CPU, distinct GPUs (NCCL), or the visible
    GPUs in turn (gloo: ranks may share a card)."""
    if torch.device(args.device).type == "cpu":
        return ["cpu"] * n
    if _backend(args) == "gloo":
        have = torch.cuda.device_count()
        return [torch.device("cuda", r % have) for r in range(n)]
    return mesh_devices(n)


def join_mesh(args, rank: int, store_path: str):
    """This process's rank of the training mesh the flags ask for: the
    process group (NCCL, or gloo) through the file rendezvous at
    ``store_path``, then the mesh over one device a rank."""
    sizes = mesh_sizes(args)
    n = sizes["dp"] * sizes["tp"] * sizes["ep"]
    devices = _devices(args, n)
    store = dist.FileStore(store_path, n)
    backend = _backend(args)
    extra = ({"device_id": torch.device(devices[rank])}
             if backend == "nccl" else {})
    dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                            timeout=COLLECTIVE_TIMEOUT, **extra)
    return build_mesh(devices=devices, **sizes)


def train_rank(rank: int, store_path: str, args, cuda_graph: bool) -> None:
    """A spawned rank of ``--dp/--tp/--ep`` (rank 0 is the process that
    started it): its part of every step, checkpoint and export."""
    torch.set_num_threads(1)
    mesh = join_mesh(args, rank, store_path)
    try:
        _train(args, cuda_graph, mesh)
    finally:
        dist.destroy_process_group()


def start_mesh(args, cuda_graph: bool) -> tuple:
    """(this process's mesh, the other ranks' processes, the rendezvous
    directory): from ``--bootstrap`` (this process one rank of the
    slice, nothing started), from ``--dp/--tp/--ep`` (rank 0 here, the
    others spawned), or (None, [], None) for one device.  Too few GPUs
    fails here, before any process starts."""
    bootstrap = _bootstrap_path(args)
    if bootstrap:
        staged = load_bootstrap(bootstrap)
        local = (int(np.prod(staged.mesh)) if staged.mesh
                 else len(staged.chips))
        n = local * max(1, staged.num_processes)
        devices = (_devices(args, n) if _backend(args) == "gloo" else None)
        mesh = initialize(bootstrap, backend=_backend(args), devices=devices,
                          dp=args.dp, pp=args.pp, sp=args.sp, tp=args.tp,
                          ep=args.ep)
        log.current().info("bootstrap loaded", path=bootstrap,
                           process=f"{staged.process_id}/"
                                   f"{staged.num_processes}")
        return mesh, [], None
    sizes = mesh_sizes(args)
    n = sizes["dp"] * sizes["tp"] * sizes["ep"]
    if n == 1:
        return None, [], None
    _devices(args, n)  # too few GPUs: refused before any process starts
    rendezvous = tempfile.mkdtemp(prefix="oim-train-mesh-")
    store = os.path.join(rendezvous, "store")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=train_rank,
                         args=(rank, store, args, cuda_graph), daemon=True)
             for rank in range(1, n)]
    for p in procs:
        p.start()
    log.current().info("mesh ranks started", ranks=n, others=len(procs))
    return join_mesh(args, 0, store), procs, rendezvous


def stop_mesh(mesh, procs, rendezvous, failed: bool) -> None:
    """Leave the process group, join the other ranks (killing any left
    behind after a failure here) and remove the rendezvous; a rank that
    failed fails the run."""
    if mesh is not None and dist.is_initialized():
        dist.destroy_process_group()
    for p in procs:
        p.join(timeout=30 if failed else None)
        if p.is_alive():
            p.terminate()
            p.join()
    if rendezvous is not None:
        shutil.rmtree(rendezvous, ignore_errors=True)
    codes = [p.exitcode for p in procs]
    if procs:
        log.current().info("mesh ranks stopped", exitcodes=codes)
    if not failed and any(codes):
        raise RuntimeError(f"a training rank failed: exit codes {codes}")


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
        n_stages=args.pp,
        n_microbatches=max(args.n_microbatches, 1),
        grad_accum=args.grad_accum,
        dtype=args.dtype,
        attn_impl=args.attn_impl,
        pp_schedule=args.pp_schedule,
    )


def make_optimizer_config(args) -> OptimizerConfig:
    """The optimizer flags as an ``OptimizerConfig``."""
    return OptimizerConfig(lr=args.lr, warmup_steps=args.warmup_steps,
                           decay_steps=args.decay_steps,
                           weight_decay=args.weight_decay,
                           grad_clip=args.grad_clip)


# Whether this process logs the run (one device, or a mesh's rank 0).
_LEAD = [True]


def _log(event: str, **fields) -> None:
    if not _LEAD[0]:
        return
    text = " ".join(f"{k}={v}" for k, v in fields.items())
    log.current().info(f"oim-train {event} {text}".rstrip())


def _eval_fn(args, cfg, tokens, device, mesh):
    """(training tokens, ``eval_fn(params) -> ce`` or None): with
    ``--eval-every`` the corpus tail is held out and averaged over
    ``--eval-batches`` distinct batches (on a mesh each rank its dp
    rows; the ce is the whole batch's on every rank)."""
    if not args.eval_every:
        return tokens, None
    if not 0.0 < args.eval_frac < 1.0:
        raise SystemExit(
            f"--eval-frac must be in (0, 1), got {args.eval_frac}")
    n_eval = int(len(tokens) * args.eval_frac)
    if window_count(n_eval, args.seq) < args.batch_global:
        raise SystemExit(
            f"eval split of {n_eval} tokens cannot fill one batch of "
            f"{args.batch_global}x(seq+1); raise --eval-frac or use a "
            "larger corpus")
    # Tail split: train never sees the eval tokens.
    eval_tokens = tokens[len(tokens) - n_eval:]
    eval_batches = TokenBatches(eval_tokens, args.batch_global, args.seq,
                                _shard(mesh), seed=args.seed + 1)
    n_eval_batches = min(args.eval_batches, eval_batches.steps_per_epoch)
    eval_step = make_eval_step(cfg, mesh=mesh)

    def eval_fn(params) -> float:
        ces = []
        for i in range(n_eval_batches):
            batch = torch.from_numpy(eval_batches.batch_at(i)[:, :args.seq])
            ces.append(eval_step(params, batch.long().to(device)))
        return float(torch.stack(ces).mean())

    return tokens[: len(tokens) - n_eval], eval_fn


def _shard(mesh) -> ShardSpec:
    """The rows a rank feeds: its dp slice (its tp/ep peers feed the
    same)."""
    if mesh is None:
        return ShardSpec()
    return ShardSpec(mesh.axis_index("dp"), mesh.shape["dp"])


def train(args, cuda_graph: bool = True) -> dict:
    """Run the training the args describe; returns this process's (rank
    0's, or under ``--bootstrap`` its own rank's) ``{"losses":
    [per step run], "aux": [per step run], "step_seconds": [...],
    "tokens_per_step", "eval_ce": [...], "start_step", "graph": the step
    function's ``stats()``, "state", "mesh": the mesh's shape or None,
    "rank": this process's, "moment_bytes": the AdamW moments it
    holds, "reduce_seconds": each eager step's dp gradient sum, and on a
    mesh's rank 0 "ranks": every rank's report (``_rank_reports``)}``.  Step times are
    host walls that end in a device sync (the loss readback).  On the GPU
    every step after the first is a replay of the step's CUDA graph (as
    the reference jits its step; on an NCCL mesh the collectives inside
    it, a gloo mesh eager); ``cuda_graph=False`` runs them eagerly (the
    A/B control, no flag)."""
    log.init_from_string(args.log_level)
    _check_flags(args)
    if _bootstrap_path(args):
        # The staged cards are bound before CUDA first starts.
        apply_chip_binding(load_bootstrap(_bootstrap_path(args)))
    resolve_device(args.device)
    mesh, procs, rendezvous = start_mesh(args, cuda_graph)
    failed = True
    try:
        out = _train(args, cuda_graph, mesh)
        failed = False
    finally:
        stop_mesh(mesh, procs, rendezvous, failed)
    return out


def _train(args, cuda_graph: bool, mesh) -> dict:
    """One rank's run (or the one device's): see ``train``."""
    _LEAD[0] = mesh is None or mesh.rank == 0
    device = resolve_device(args.device) if mesh is None else mesh.device
    cfg = make_config(args)
    model = cfg if mesh is None else train_config(cfg, mesh)
    opt = make_optimizer_config(args)
    _log("start", device=device, fused_ce=model.fused_ce,
         use_pallas=model.use_pallas, remat=cfg.remat, layers=cfg.n_layers,
         d_model=cfg.d_model, vocab=cfg.vocab_size, dtype=cfg.dtype,
         batch=f"{args.batch_global}x{args.seq}",
         mesh=None if mesh is None else "x".join(
             f"{a}{n}" for a, n in mesh.shape.items() if n > 1) or "1",
         zero1=args.zero1,
         graphed=cuda_graph and device.type == "cuda" and (
             mesh is None or mesh.backend == "nccl"))
    lora_base = None
    if args.lora_rank:
        lora_base = load_params(args.lora_base, device=device)
        check_params(lora_base, cfg, f"--lora-base {args.lora_base}")
        _log("lora", rank=args.lora_rank, alpha=args.lora_alpha,
             base=args.lora_base)

    def init_fn() -> TrainState:
        if args.lora_rank:  # adapters and base whole on every rank
            return TrainState.create(
                init_lora(args.seed, cfg, args.lora_rank, device=device), opt,
                mesh=mesh, zero1=args.zero1)
        if mesh is None:
            return TrainState.create(
                init_params(args.seed, cfg, device=device, master=True), opt)
        return TrainState.create(
            init_rank_params(args.seed, cfg, mesh, device=device), opt,
            mesh=mesh, specs=serve_specs(cfg, mesh), zero1=args.zero1)

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
    tokens, eval_fn = _eval_fn(args, cfg, _load_corpus(args), device, mesh)
    batches = TokenBatches(tokens, args.batch_global, args.seq, _shard(mesh),
                           seed=args.seed)
    if args.lora_rank:
        lora_step = make_lora_train_step(cfg, args.lora_alpha,
                                         args.lora_rank, cuda_graph,
                                         mesh=mesh)

        def step_fn(state, batch):
            return lora_step(state, lora_base, batch)

        step_stats = lora_step.stats
    else:
        step_fn = (make_train_step(cfg, cuda_graph=cuda_graph) if mesh is None
                   else make_train_step(cfg, cuda_graph=cuda_graph,
                                        mesh=mesh))
        step_stats = step_fn.stats

    def batch_stream():
        for step in range(start_step, args.steps):
            # The window's +1 boundary token is dropped: labels come from
            # the [b, seq] input itself, as in the reference.
            yield batches.batch_at(step)[:, : args.seq]

    out = {"losses": [], "aux": [], "step_seconds": [], "eval_ce": [],
           "tokens_per_step": args.batch_global * args.seq,
           "start_step": start_step, "rank": 0 if mesh is None else mesh.rank,
           "mesh": None if mesh is None else dict(mesh.shape)}
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
                # Rescue save: an interrupted run resumes where it stopped
                # (skipped when this step is saved already).
                checkpointer.save(state, {"next_step": step}, force=True)
                if args.export_dir and step >= args.steps:
                    _export(args, checkpointer, state, merged, opt)
            finally:
                checkpointer.close()  # always await the queued save
    out["graph"] = step_stats()
    out["moment_bytes"] = state.moment_bytes()
    out["reduce_seconds"] = list(state.reduce_seconds)
    if mesh is not None:
        out["ranks"] = _rank_reports(state, mesh)
    _log("done", steps=step)
    out["state"] = state
    return out


def _rank_reports(state: TrainState, mesh) -> list | None:
    """Every rank's report, gathered on rank 0 (None elsewhere): its
    kernel and collective launch counts (``ops/counts.py``, since the
    process began or the caller's reset), peak device bytes, parameter
    and moment bytes, the host wall of each eager step's dp gradient
    sum, and the checksums of its replicated leaves
    (``replica_checksums``)."""
    device = mesh.device
    report = {"rank": mesh.rank, "coords": dict(mesh.coords),
              "counts": counts.counters(),
              "peak_bytes": (torch.cuda.max_memory_allocated(device)
                             if device.type == "cuda" else 0),
              "param_bytes": block_bytes(state.params),
              "moment_bytes": state.moment_bytes(),
              "reduce_seconds": list(state.reduce_seconds),
              "replicas": replica_checksums(state)}
    reports = [None] * mesh.size if mesh.rank == 0 else None
    dist.gather_object(report, reports, dst=0, group=mesh.control)
    return reports


def _export(args, checkpointer, state, merged, opt) -> None:
    """Completed runs only; an existing export is a prior completed
    run's, so re-running stays idempotent.  LoRA exports the MERGED
    weights: serving needs no LoRA support."""
    params = merged(state)
    target = state if params is state.params else TrainState(
        params=params, optimizer=None, opt=opt, step=state.step,
        mesh=state.mesh)
    try:
        checkpointer.export_params(target, args.export_dir)
    except FileExistsError:
        _log("export exists; skipping", dir=args.export_dir)
        return
    _log("params exported", dir=args.export_dir)


def main(argv=None) -> int:
    train(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
