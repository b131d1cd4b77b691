"""oim-serve for the port: weights from a params export
(``--params-dir``), a training checkpoint (``--checkpoint-dir``) or a
seed, the continuous-batching engine, and the HTTP server, on the GPU
unless ``--device cpu``.  With no engine flags it serves as the
reference's ``oim-serve`` does: the dense per-slot KV cache
(``--kv-block 0``), pipeline depth 2 (each decode chunk one CUDA graph
replay on the GPU) and sampling penalties on.

Usage (full-width Qwen2.5-1.5B geometry on one H100):
    python -m oim_tpu_torch.cli.serve_main \\
        --vocab-size 151936 --d-model 1536 --n-layers 28 --n-heads 12 \\
        --n-kv-heads 2 --d-ff 8960 --rope-theta 1000000 --norm-eps 1e-6 \\
        --attn-bias --dtype bfloat16 --n-slots 8 --max-len 2048 \\
        --chunk 8 --port 8000
Then:
    curl -s localhost:8000/v1/generate -d \\
        '{"tokens": [1,2,3], "max_new_tokens": 8}'

An MoE model (``--n-experts E --moe-top-k k``: every token drop-free
through its top-k of E experts) serves the same way, e.g. Mixtral-8x7B's
widths with 24 of its 32 layers (one H100's worth):
    python -m oim_tpu_torch.cli.serve_main \\
        --vocab-size 32000 --d-model 4096 --n-layers 24 --n-heads 32 \\
        --n-kv-heads 8 --d-ff 14336 --n-experts 8 --moe-top-k 2 \\
        --rope-theta 1000000 --norm-eps 1e-5 --dtype bfloat16 \\
        --n-slots 8 --max-len 2048 --chunk 8 --port 8000
``--tp``/``--ep`` above 1 (sharded serving) are refused.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
import time

from oim_tpu_torch.checkpoint import (
    Checkpointer,
    CheckpointerOptions,
    load_params,
)
from oim_tpu_torch.models.transformer import TransformerConfig, init_params
from oim_tpu_torch.models.weights import check_params, recast
from oim_tpu_torch.serve.engine import Engine, resolve_device
from oim_tpu_torch.serve.server import ServeServer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="oim-serve-torch", description=__doc__)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000, help="0 = ephemeral")
    p.add_argument(
        "--device", default="cuda",
        help="torch device (default cuda; 'cpu' runs the plain path)",
    )
    p.add_argument("--seed", type=int, default=0,
                   help="weight init seed (without a weights flag)")
    weights = p.add_mutually_exclusive_group()
    weights.add_argument(
        "--params-dir", default="",
        help="params-only export from train_main --export-dir",
    )
    weights.add_argument(
        "--checkpoint-dir", default="",
        help="train_main checkpoint directory: the latest step's params",
    )
    # Model geometry.
    p.add_argument("--vocab-size", type=int, default=32768)
    p.add_argument("--d-model", type=int, default=512)
    p.add_argument("--n-layers", type=int, default=4)
    p.add_argument("--n-heads", type=int, default=8)
    p.add_argument("--n-kv-heads", type=int, default=0)
    p.add_argument("--d-ff", type=int, default=0)
    p.add_argument("--n-experts", type=int, default=0,
                   help="MoE experts per layer (0 = a dense MLP)")
    p.add_argument("--moe-top-k", type=int, default=1,
                   help="experts per token (k >= 2 renormalises the gates "
                   "over the chosen experts)")
    p.add_argument("--rope-theta", type=float, default=10000.0)
    p.add_argument(
        "--sliding-window", type=int, default=0,
        help="sliding-window attention (Mistral-family); 0 = full causal",
    )
    p.add_argument(
        "--rope-scaling", type=float, nargs=4, default=[],
        metavar=("FACTOR", "LOW", "HIGH", "ORIG_MAX"),
        help="Llama-3.1 RoPE frequency remap (factor low_freq_factor "
        "high_freq_factor original_max_position); omit for plain RoPE",
    )
    p.add_argument(
        "--norm-eps", type=float, default=1e-6,
        help="RMSNorm epsilon (imported HF Llama checkpoints use 1e-5)",
    )
    p.add_argument(
        "--attn-bias", action="store_true",
        help="q/k/v projection biases (the Qwen2 family)",
    )
    p.add_argument(
        "--mlp-act", default="silu", choices=["silu", "gelu_tanh"],
        help="MLP gate activation (gelu_tanh = Gemma GeGLU)",
    )
    p.add_argument(
        "--norm-offset", action="store_true",
        help="RMSNorm scales by (1 + weight) (Gemma family)",
    )
    p.add_argument(
        "--embed-scale", action="store_true",
        help="scale embeddings by sqrt(d_model) (Gemma family)",
    )
    p.add_argument("--dtype", default="bfloat16")
    # Engine shape.
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ways (refused above 1: one device)")
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel ways for MoE serving (refused "
                   "above 1: one device)")
    p.add_argument("--n-slots", type=int, default=8)
    p.add_argument("--max-len", type=int, default=1024)
    p.add_argument("--chunk", type=int, default=8)
    p.add_argument(
        "--pipeline-depth", type=int, default=2, choices=(1, 2),
        help="decode pipeline depth: 2 (default) dispatches chunk N+1 "
        "before chunk N's readback so device compute overlaps host "
        "emission; 1 is the serial dispatch-then-readback loop",
    )
    p.add_argument(
        "--kv-block", type=int, default=0, metavar="T",
        help="paged KV cache with T-token blocks (0 = dense per-slot "
        "regions): memory is reserved per request's worst case instead "
        "of n_slots x max_len, and admission backpressures on block "
        "exhaustion; T must divide --max-len",
    )
    p.add_argument(
        "--kv-blocks", type=int, default=0, metavar="N",
        help="paged pool size in blocks (0 = the dense cache's "
        "footprint, n_slots x max_len / --kv-block)",
    )
    p.add_argument("--kv-int8", action="store_true",
                   help="int8 KV cache with per-(token, head) scales")
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument(
        "--no-penalties", action="store_true",
        help="disable sampling-penalty support (repetition/presence/"
        "frequency): skips the per-slot [n_slots, vocab] occurrence "
        "state - worth it at big vocab x many slots when no client "
        "penalizes",
    )
    p.add_argument(
        "--max-queue", type=int, default=64,
        help="admission queue bound (HTTP 429 beyond it; 0 = unbounded)",
    )
    return p


def load_weights(args, cfg: TransformerConfig, device) -> dict:
    """The served parameters in serving's layout: the export or the
    checkpoint's f32 params (checked against the flags' geometry, cast to
    the compute dtype), else random from ``--seed``.  A missing export or
    checkpoint raises: a server never quietly serves random weights."""
    if args.params_dir:
        what = f"--params-dir {args.params_dir}"
        params = load_params(args.params_dir, device=device)
    elif args.checkpoint_dir:
        what = f"--checkpoint-dir {args.checkpoint_dir}"
        with Checkpointer(args.checkpoint_dir,
                          CheckpointerOptions(create=False)) as ckpt:
            params = ckpt.restore_params(device=device)
    else:
        return init_params(args.seed, cfg, device=device)
    check_params(params, cfg, what)
    return recast(params, cfg, cfg.dtype)[0]


def make_engine(args, cuda_graphs: bool = True) -> Engine:
    """The engine from parsed args: device first (no GPU and no
    ``--device cpu`` fails before any work), then weights and engine.
    ``cuda_graphs=False`` dispatches decode chunks eagerly: a
    measurement's A/B control, deliberately not a serving flag."""
    for axis in ("tp", "ep"):
        if getattr(args, axis) > 1:
            raise ValueError(
                f"--{axis} {getattr(args, axis)}: sharded serving is not "
                "ported yet (ROADMAP Queue A12: parallelism); the port "
                "serves on one device")
    device = resolve_device(args.device)
    cfg = TransformerConfig(
        vocab_size=args.vocab_size,
        d_model=args.d_model,
        n_layers=args.n_layers,
        n_heads=args.n_heads,
        n_kv_heads=args.n_kv_heads,
        attn_bias=args.attn_bias,
        mlp_act=args.mlp_act,
        norm_offset=args.norm_offset,
        embed_scale=args.embed_scale,
        d_ff=args.d_ff or 4 * args.d_model,
        n_experts=args.n_experts,
        moe_top_k=args.moe_top_k,
        rope_theta=args.rope_theta,
        rope_scaling=tuple(args.rope_scaling),
        sliding_window=args.sliding_window,
        norm_eps=args.norm_eps,
        dtype=args.dtype,
    )
    params = load_weights(args, cfg, device)
    return Engine(
        params, cfg,
        n_slots=args.n_slots,
        max_len=args.max_len,
        chunk=args.chunk,
        top_k=args.top_k,
        top_p=args.top_p,
        kv_int8=args.kv_int8,
        penalties=not args.no_penalties,
        max_queue=args.max_queue,
        pipeline_depth=args.pipeline_depth,
        kv_block=args.kv_block,
        kv_blocks=args.kv_blocks,
        device=device,
        cuda_graphs=cuda_graphs,
    )


def start_server(args) -> ServeServer:
    """Build, warm and start the server; prints the listening line."""
    engine = make_engine(args).warmup()
    server = ServeServer(engine, host=args.host, port=args.port).start()
    print(
        f"oim-serve listening host={server.host!r} port={server.port} "
        f"n_slots={args.n_slots} max_len={args.max_len} "
        f"kv_block={args.kv_block} pipeline_depth={args.pipeline_depth} "
        f"device={engine.device}",
        file=sys.stderr, flush=True,
    )
    return server


def main(argv=None) -> int:
    server = start_server(build_parser().parse_args(argv))
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    try:
        stop.wait()
        # Graceful drain: stop admitting, let in-flight requests finish.
        server.engine.drain()
        deadline = time.monotonic() + 120.0
        while server.engine.in_flight() and time.monotonic() < deadline:
            time.sleep(0.2)
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
