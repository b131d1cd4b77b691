"""Where a training step's time goes on the GPU: the port's trainer at a
model's full width, profiled with ``torch.profiler``.

Builds the model, optimizer and step as ``train_main`` does (same flags,
f32 master weights from ``--seed``, the first batch of its corpus), runs
``WARMUP`` steps, then ``STEPS`` steps twice, back to back: once under
the host clock (ended by a synchronise), once under the profiler, whose
own host cost would inflate a wall taken under it.  Both runs train on
the same batch from where the previous run left the weights, so they do
the same work.  It prints the wall, the device time summed over kernels,
the device's idle share (one minus their ratio), the device time by
family (the port's training kernels, cuBLAS GEMMs, the optimizer's
fused multi-tensor updates, the rest) and the kernels that took the most
device time; the last line is one JSON object with those numbers.  Run
on the machine with the GPU:

    python -m oim_tpu_torch.cli.train_profile --synthetic 400000 \\
        --steps 1 --batch-global 4 --seq 1024 --vocab-size 151936 \\
        --d-model 1536 --n-layers 28 --n-heads 12 --n-kv-heads 2 \\
        --d-ff 8960 --attn-bias --rope-theta 1000000 --norm-eps 1e-6 \\
        --dtype bfloat16
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
from oim_tpu_torch.models.transformer import init_params
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
    "optimizer (multi-tensor)": ("multi_tensor",),
}


def main(argv=None) -> int:
    args = train_main.build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise SystemExit("train_profile measures the GPU: run it there")
    smi = _build.gpu_line()
    cfg = train_main.make_config(args)
    state = TrainState.create(
        init_params(args.seed, cfg, device=device, master=True),
        train_main.make_optimizer_config(args))
    step_fn = make_train_step(cfg)
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
    window = profiled(step, STEPS, wall_ms, FAMILIES)
    tokens = args.batch_global * args.seq
    print(f"{smi}; batch {args.batch_global}x{args.seq}, "
          f"{wall_ms / STEPS:.1f} ms a step, "
          f"{tokens * STEPS / wall_ms * 1e3:.0f} tokens/s")
    print_window(f"train ({STEPS} steps)", window)
    for family, ms in sorted((window["families_ms"] or {}).items(),
                             key=lambda kv: -kv[1]):
        print(f"  family {family}: {ms:.3f} ms "
              f"({ms / window['device_ms']:.1%} of device time)")
    print(json.dumps({"device": smi, "train": window,
                      "peak_memory_bytes": torch.cuda.max_memory_allocated()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
