"""Where a serving step's time goes on the GPU: the port's engine at a
served model's full width, profiled with ``torch.profiler``.

Builds the engine as ``serve_main`` does (same geometry and engine
flags — ``--kv-block``, ``--pipeline-depth``, ``--prefix-cache``,
``--prefill-chunk`` — and random weights from ``--seed``) and warms
it; ``--eager`` dispatches each decode chunk and each admission
dispatch eagerly instead of replaying its CUDA graph (the A/B control,
a switch of this tool only).  Prompt lengths are spread over the slots up to ``--max-len``.
Two windows:

- admission: one wave of one request per slot, admitted in one
  ``step()`` that also dispatches one decode chunk (at depth 2 the step
  first reads back the chunk the wave before left in flight); with
  ``--prefill-chunk T`` a prompt longer than T writes one T-token
  segment in the wave and the profiled wave also advances the timed
  wave's pending prompts by one segment each;
- decode: every slot seated, ``DECODE_STEPS`` steps, each dispatching
  one chunk of ``--chunk`` passes (at depth 2 while reading back the
  one before).

Each window runs twice, back to back: once under the host clock (ended
by a synchronise), once under the profiler, whose own host cost would
inflate a wall taken under it.  The two runs do like work, not the same
work: the admission run seats a second wave of the same prompt lengths,
and the profiled decode steps run at contexts ``DECODE_STEPS * --chunk``
tokens longer than the timed ones (at the command below, about 2 % more
K1 work), so the idle share slightly understates the device's idle
time.  It prints the wall, the device
time summed over kernels, the device's idle share (one minus their
ratio), the wall and device time per decode chunk, the device time by
family (K1 with its merge, K2, the weight-quantized product, cuBLAS
GEMMs, the rest), the kernels that took the most device time and the host ops
that took the most host time; the last line is one JSON object with
those numbers.  Run on the machine with the GPU:

    python -m oim_tpu_torch.cli.serve_profile \\
        --vocab-size 151936 --d-model 1536 --n-layers 28 --n-heads 12 \\
        --n-kv-heads 2 --d-ff 8960 --rope-theta 1000000 --attn-bias \\
        --max-len 2048 --n-slots 8 --chunk 8 [--kv-block 16] \\
        [--pipeline-depth 1] [--prefill-chunk 256] [--eager]
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from oim_tpu_torch.cli import serve_main
from oim_tpu_torch.ops import _build, paged_attention
from oim_tpu_torch.serve.engine import GenRequest

DECODE_STEPS = 3  # engine steps in the decode window
TOP = 12  # kernels listed per window
FAMILIES = {
    "K1": ("paged_decode_kernel", "paged_prefill_tc_kernel",
           "paged_merge_kernel"),
    "K2": ("paged_store_kernel",),
    "quant_matmul": ("quant_matmul_kernel", "quant_merge_kernel",
                     "dequant_kernel"),
    "gemm (cuBLAS)": ("gemm", "nvjet", "xmma", "cutlass"),
}


def _device_us(event) -> float:
    """An averaged event's own device time in microseconds."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def _annotation(event) -> bool:
    """Whether an averaged event is a user-annotated range (the
    optimizer's ``Optimizer.step#AdamW.step``): the profiler reports its
    device span, which covers kernels already counted on their own."""
    return bool(getattr(event, "is_user_annotation", False)
                or event.key.startswith("Optimizer."))


def _timed(engine, steps: int) -> float:
    """Host wall in ms of ``steps`` engine steps, unprofiled, ended by a
    synchronise (which covers a chunk the last step left in flight)."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    return (time.monotonic() - t0) * 1e3


def profiled(step, steps: int, wall_ms: float, families=None) -> dict:
    """Profile ``steps`` calls of ``step()``: their device time summed
    over kernels, the idle share it leaves of ``wall_ms`` (the same
    work's unprofiled wall), the kernels that took the most device time
    and, given ``families`` ({family: substrings of kernel names}), the
    device time per family (the first family that matches; "other" for
    none)."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    kernels = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _device_us(e) > 0
               and not _annotation(e)]
    busy_ms = sum(us for _, us, _ in kernels) / 1e3
    kernels.sort(key=lambda e: -e[1])
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU), key=lambda e: -e[1])
    by_family = {}
    for name, us, _ in kernels:
        family = next((f for f, keys in (families or {}).items()
                       if any(key in name for key in keys)), "other")
        by_family[family] = by_family.get(family, 0.0) + us / 1e3
    return {
        "steps": steps,
        "wall_ms": wall_ms,
        "device_ms": busy_ms if kernels else None,
        "idle_share": 1.0 - busy_ms / wall_ms if kernels else None,
        "top": [
            {"name": name[:90], "ms": us / 1e3, "calls": count,
             "share": us / 1e3 / busy_ms}
            for name, us, count in kernels[:TOP]
        ],
        "families_ms": by_family if families else None,
        "host_top": [{"name": name[:90], "ms": ms, "calls": count}
                     for name, ms, count in host[:TOP]],
    }


def print_window(title: str, w: dict) -> None:
    if w["device_ms"] is None:
        print(f"{title}: wall {w['wall_ms']:.2f} ms; device time not "
              f"measured (the profiler recorded no device events)")
        return
    print(f"{title}: wall {w['wall_ms']:.2f} ms over {w['steps']} steps; "
          f"device {w['device_ms']:.2f} ms; idle share "
          f"{w['idle_share']:.3f}")
    for k in w["top"]:
        print(f"  {k['ms']:9.3f} ms {k['share']:6.1%} x{k['calls']:<6} "
              f"{k['name']}")
    print("  host ops by their own host time (under the profiler, which "
          "inflates them):")
    for k in w["host_top"]:
        print(f"  {k['ms']:9.3f} ms x{k['calls']:<6} {k['name']}")


def build_parser():
    p = serve_main.build_parser()
    p.prog = "serve_profile"
    p.add_argument(
        "--eager", action="store_true",
        help="dispatch each decode chunk and admission eagerly, not as "
        "CUDA graph replays (the A/B control)",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    engine = serve_main.make_engine(args, cuda_graphs=not args.eager)
    if engine.device.type != "cuda":
        raise SystemExit("serve_profile measures the GPU: run it there")
    smi = _build.gpu_line()
    engine.warmup()
    rng = np.random.RandomState(args.seed)
    # The decode budget covers the seating step and both windows.
    budget = args.chunk * (2 * DECODE_STEPS + 2)
    lengths = np.linspace(
        16, min(engine.prompt_buckets[-1], args.max_len - budget),
        engine.n_slots,
    ).astype(int)

    def wave(max_new: int) -> None:
        for n in lengths:
            engine.submit(GenRequest(
                tokens=rng.randint(0, args.vocab_size, int(n)).tolist(),
                max_new_tokens=max_new,
            ))

    paged_attention.reset_counters()
    wave(args.chunk)
    wall_ms = _timed(engine, 1)
    wave(args.chunk)
    admit = profiled(engine.step, 1, wall_ms, FAMILIES)
    wave(budget)
    engine.step()
    wall_ms = _timed(engine, DECODE_STEPS)
    decode = profiled(engine.step, DECODE_STEPS, wall_ms, FAMILIES)
    counts = paged_attention.counters()
    config = {"kv_block": args.kv_block,
              "pipeline_depth": args.pipeline_depth,
              "prefix_cache": args.prefix_cache,
              "prefill_chunk": args.prefill_chunk,
              "cuda_graphs": engine.cuda_graphs}
    per_chunk = {"wall_ms": decode["wall_ms"] / DECODE_STEPS,
                 "device_ms": (None if decode["device_ms"] is None
                               else decode["device_ms"] / DECODE_STEPS),
                 "idle_share": decode["idle_share"]}
    print(f"{smi}; prompts {lengths.tolist()}, chunk {args.chunk}; "
          f"{config}")
    print_window("admission wave + one decode chunk", admit)
    print_window(f"decode ({DECODE_STEPS} steps of {args.chunk} "
                  f"passes)", decode)
    device_txt = ("not measured" if per_chunk["device_ms"] is None
                  else f"{per_chunk['device_ms']:.3f} ms")
    print(f"per decode chunk: wall {per_chunk['wall_ms']:.3f} ms, device "
          f"{device_txt}")
    for title, w in (("admission", admit), ("decode", decode)):
        for family, ms in sorted((w["families_ms"] or {}).items(),
                                 key=lambda kv: -kv[1]):
            print(f"  {title} family {family}: {ms:.3f} ms "
                  f"({ms / w['device_ms']:.1%} of device time)")
    print(json.dumps({"device": smi, "prompts": lengths.tolist(),
                      "config": config, "admit": admit, "decode": decode,
                      "decode_per_chunk": per_chunk,
                      "kernel_counts": counts}))
    engine.run()
    return 0

if __name__ == "__main__":
    sys.exit(main())
