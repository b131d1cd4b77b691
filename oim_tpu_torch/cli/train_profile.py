"""Where a training step's time goes on the GPU: the port's trainer at a
model's full width, profiled with ``torch.profiler``.

Builds the model, optimizer and step as ``train_main`` does (same flags,
f32 master weights from ``--seed``, the first batch of its corpus), runs
``WARMUP`` steps (the first eager, the second the graph's capture and
first replay), then ``STEPS`` steps twice, back to back: once under the
host clock (ended by a synchronise), once under the profiler, whose own
host cost would inflate a wall taken under it.  Both runs train on the
same batch from where the previous run left the weights, so they do
the same work.  Each step is one replay of the step's CUDA graph, as
``train_main`` runs it; ``--eager`` runs the same steps op by op (the
A/B control: run both in one call).  It prints the wall, the device
time summed over kernels, the device's idle share (one minus their
ratio), each replay's device time by CUDA events around it, the graph
pool's GiB and the capture's seconds, the device time by family (the
port's training kernels, cuBLAS GEMMs, the optimizer's fused updates,
the rest) and the kernels that took the most device time.  For an MoE
model it also times one layer's expert products alone
(``expert_products_ms``), as the trainer runs them (f32 masters, TF32
off) and with bf16 operands, and their share of the step.
The last line is one JSON object with those numbers.  Run on the
machine with the GPU:

    python -m oim_tpu_torch.cli.train_profile --synthetic 400000 \\
        --steps 1 --batch-global 4 --seq 1024 --vocab-size 151936 \\
        --d-model 1536 --n-layers 28 --n-heads 12 --n-kv-heads 2 \\
        --d-ff 8960 --attn-bias --rope-theta 1000000 --norm-eps 1e-6 \\
        --dtype bfloat16 [--eager]
"""

from __future__ import annotations

import json
import sys
import time

import torch

from oim_tpu_torch.cli import train_main
from oim_tpu_torch.cli.serve_profile import print_window, profiled
from oim_tpu_torch.data.loader import TokenBatches
from oim_tpu_torch.models.train import TrainState, make_train_step
from oim_tpu_torch.models.transformer import _mlp_act, init_params
from oim_tpu_torch.ops import _build
from oim_tpu_torch.serve.engine import resolve_device

WARMUP = 2  # steps before the windows (allocator and cuBLAS warm-up)
STEPS = 2  # steps in each window
FAMILIES = {
    "flash_fwd": ("flash_fwd_kernel", "flash_fwd_tc_kernel"),
    "flash_dq": ("flash_dq_kernel", "flash_dq_tc_kernel"),
    "flash_dkv": ("flash_dkv_kernel", "flash_dkv_tc_kernel", "dkv_sum_kernel"),
    "rmsnorm": ("rmsnorm_kernel",),
    # Before cuBLAS's family: "gemm" is in the fused-CE product's name.
    "fused_ce": ("ce_tc_kernel", "ce_gemm_kernel", "ce_lse_kernel"),
    "gemm (cuBLAS)": ("gemm", "nvjet", "xmma", "cutlass"),
    "optimizer (fused, multi-tensor)": ("multi_tensor",),
}


def expert_products_ms(cfg, tokens: int, dtype, runs: int = 5) -> dict:
    """Milliseconds of one layer's expert products (gate, up, SwiGLU,
    down) over a microbatch of ``tokens`` tokens at ``_switch_moe``'s
    capacity, forward alone and forward with backward, their operands in
    ``dtype``: CUDA events around ``runs`` calls after one warm call."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    capacity = max(int(cfg.expert_capacity_factor * cfg.moe_top_k * tokens
                       / e), 1)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=dtype).requires_grad_(True)

    x = draw(e, capacity, d)
    w_gate, w_in, w_out = draw(e, d, f), draw(e, d, f), draw(e, f, d)

    def forward():
        return (_mlp_act(x @ w_gate, cfg) * (x @ w_in)) @ w_out

    def both():
        forward().backward(dy)

    dy = torch.randn(e, capacity, d, generator=gen, device="cuda",
                     dtype=dtype)
    out = {}
    for name, fn in (("forward", forward), ("forward_backward", both)):
        fn()
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        end.synchronize()
        out[name] = start.elapsed_time(end) / runs
    out["capacity"] = capacity
    return out


def build_parser():
    p = train_main.build_parser()
    p.prog = "train_profile"
    p.add_argument(
        "--eager", action="store_true",
        help="run each step op by op, not as the replay of its CUDA graph "
        "(the A/B control)",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise SystemExit("train_profile measures the GPU: run it there")
    smi = _build.gpu_line()
    cfg = train_main.make_config(args)
    state = TrainState.create(
        init_params(args.seed, cfg, device=device, master=True),
        train_main.make_optimizer_config(args))
    step_fn = make_train_step(cfg, cuda_graph=not args.eager)
    batches = TokenBatches(train_main._load_corpus(args), args.batch_global,
                           args.seq, seed=args.seed)
    batch = torch.from_numpy(batches.batch_at(0)[:, :args.seq]).long()
    batch = batch.to(device)

    def step() -> None:
        step_fn(state, batch)

    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(STEPS):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3
    graph = step_fn.stats()
    window = profiled(step, STEPS, wall_ms, FAMILIES)
    tokens = args.batch_global * args.seq
    route = "eager" if args.eager else "graphed"
    print(f"{smi}; batch {args.batch_global}x{args.seq}, {route}, "
          f"{wall_ms / STEPS:.1f} ms a step, "
          f"{tokens * STEPS / wall_ms * 1e3:.0f} tokens/s")
    if graph["graphed"]:
        print(f"graph: the timed window's replays took "
              f"{[round(ms, 2) for ms in graph['replay_ms'][-STEPS:]]} ms "
              f"of device time (CUDA events) against {wall_ms / STEPS:.2f} "
              f"ms of wall a step; pool {graph['pool_bytes'] / 2**30:.2f} "
              f"GiB; capture {graph['capture_seconds']:.2f} s")
    print_window(f"train ({STEPS} steps, {route})", window)
    for family, ms in sorted((window["families_ms"] or {}).items(),
                             key=lambda kv: -kv[1]):
        print(f"  family {family}: {ms:.3f} ms "
              f"({ms / window['device_ms']:.1%} of device time)")
    experts = {}
    if cfg.n_experts:
        # Per step: each layer's products forward, again under remat, and
        # backward, once a microbatch.
        micro = args.batch_global // cfg.grad_accum
        passes = cfg.n_layers * cfg.grad_accum
        for dtype in (torch.float32, torch.bfloat16):
            ms = expert_products_ms(cfg, micro * args.seq, dtype)
            ms["step_ms"] = passes * (ms["forward_backward"]
                                      + ms["forward"] * cfg.remat)
            experts[str(dtype).removeprefix("torch.")] = ms
            print(f"expert products, {dtype}: one layer's forward "
                  f"{ms['forward']:.3f} ms, forward and backward "
                  f"{ms['forward_backward']:.3f} ms at capacity "
                  f"{ms['capacity']}; {ms['step_ms']:.1f} ms a step "
                  f"({ms['step_ms'] * STEPS / wall_ms:.1%} of its wall)")
    print(json.dumps({"device": smi, "route": route, "train": window,
                      "graph": graph,
                      "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                      "expert_products": experts}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
