"""Chip smoke for the PyTorch/CUDA port: build the Hopper kernels, hold
each against its plain PyTorch version at the shapes its path gives it,
then drive the paths through the port's own entry points at
Qwen2.5-1.5B's full width — serve six requests at ``serve_main``'s
defaults (the dense cache, pipeline depth 2, each decode chunk and each
admission dispatch one CUDA graph replay; an admission wave run eagerly
and by replays from one state must agree bit for bit) and again on the
paged engine at depth 1 (paged-attention
kernels K1 on its decode and tensor-core routes, K2, in both), train a
few steps in the trainer's usual configuration
(RMSNorm, flash attention forward, dq, dkv, and the fused unembed+CE
forward, dx and dw; every step after the first one CUDA graph replay
of the whole step, which must be bit-equal to the eager step, and the
fused AdamW held against the per-tensor update), then checkpoint,
resume by the graphed step and export,
fine-tune LoRA on the export and serve the merged weights — and check
what comes back.
Then the prefix cache and chunked prefill on both cache layouts
(``--prefix-cache 8 --prefill-chunk 256``: a cached 1008-token system
prompt, five prompts sharing it, one a copy-on-write on the paged pool,
and an 1800-token miss admitted in segments while the others decode),
each beside a control run without the flags, with K1's tall route and
K2 also timed at a segment's shape.  The quantization ladder: K1 and K2
on packed int4 pools, ``quant_matmul`` (weight-only int8 and int4) at
the served models' weight shapes, and Qwen served with ``--kv-block 16
--kv-int4 --weights-int4`` (its teacher check attends over the served
int4 K/V, each value held within one step of the f32 forward's own).
Then an exact-routing MoE model at Mixtral-8x7B's widths: served on
``serve_main``'s defaults in bf16 with its depth cut to fit the card,
then whole, all 32 layers, with ``--weights-int8``, and trained at two
layers with capacity routing and the aux and z losses, its first step
checked in bf16 and in f32 (RMSNorm's wide route, for rows past one
warp's registers).  Each graphed serve phase prints one decode chunk's
device time and its weight products' share and rate
(``decode_profile``).

Run from the repository root on a machine with one NVIDIA GPU and the
CUDA toolkit:

    python3 chip_smoke.py

``--kernel-phase-only [--package DIR]`` runs only the kernel phases
that time two builds against each other — K1/K2, then RMSNorm and the
fused-CE entries at the training shape with digests of their outputs,
the host's time to enqueue each, and a full step's fused-CE backward by
scratch width — with the port's package loaded from DIR (another
checkout, such as a parent commit unpacked beside this one), so that two
versions of the kernels are timed on the same inputs in one run of the
card (and ``quant_matmul``'s phase, where the package has it).
``--moe-phase-only`` runs only the MoE phases (K1/K2 at the MoE model's
heads, its two serve phases and its train phase).
``--route-control bf16|swap`` plants a router fault in the MoE serve
phase's engine and the MoE training's kernel path (the references kept
sound) and runs those two checks, which must fail: a control of the
routing checks' tolerance.
``--train-phase-only [--package DIR]`` likewise runs only the
training configuration's steps and prints their wall times, the
replays' device time and peak memory, and ``--serve-phase-only
[--package DIR]`` only the serve phases
(their checks, the lone 512-token prompt's time to first token, the
concurrent p50 and the decode rate; the default-configuration and int4
phases only where the package serves them); run both builds in turns (parent,
change, change, parent) to compare them in one call.
``--prefix-phase-only [--package DIR]`` runs only the prefix phase.
``--kv-phase-only`` runs only the KV block I/O phase (``kv_io_phase``):
two engines at the same width share one copy of the weights; held KV
(four prompt legs with ``hold_kv``), the 1008-token prefix entry and
eight live slots suspended by ``begin_migrate_out`` ship from A to B
through the wire's bytes, and a third engine with a small pool and the
host tier demotes and promotes the entry and parks and restores a slot;
every stream must be its unbroken run (or part from it only at a bf16
near tie of the f32 forward), every continuation on B A's own
continuation of the same bytes, K1 and K2 launched by route with no
plain call, every dispatch a graph replay, and no block left behind.
It runs in the full smoke and with ``--serve-phase-only`` too.
``--qos-phase-only`` runs only the QoS phase (``qos_phase``): an engine
with a tenant policy (one premium, one best-effort tenant) and the host
tier, whose eight slots a best-effort flood fills before two premium
requests arrive — each parks one best-effort slot, both premium first
tokens come before any best-effort stream ends, the parked streams
equal their runs alone, and premium TTFT is recorded beside the same
traffic with QoS off; two standard tenants, one with a skewed backlog,
share the first finishers; a second engine sheds through the HTTP
server (brownout clamps, a full queue and an expired deadline answer
429 with ``Retry-After``); and across them every request is in the
ring with phases that partition its wall, one span tree each, one slow
capture, and the path gates of the kv io phase, with no device wait
the engine did not already have.  It runs in the full smoke and with
``--serve-phase-only`` too.
``--http-phase-only`` runs only the HTTP phase (``http_phase``): two
port servers A and B at the served widths (``--kv-block 16
--prefix-cache 8``, a host tier; B on A's weights) and an engine C
restored from A over ``GET /v1/weights``, the smoke playing the
router's part with the port's own ship clients: streams against their
plain replies (the first line's latency beside the plain TTFT), a client
that hangs up, a drain with ``/v1/slot`` shipping (B's continuations
A's own, the spliced streams their unbroken runs or parting at a near
tie, a non-stream request 503), ``/v1/kv`` and prefix shipping with the
404, 409 and 429 faults, the weights' GB/s against a ``--params-dir``
export, a stall (503 "stalled", ``/healthz`` 503 then 200), and the
observation routes; with the kv io phase's path gates and no device
wait beyond the engines', the exports' and the weight copies'.  It runs
in the full smoke and with ``--serve-phase-only`` too.
``--front-phase-only`` runs only the front phase (``front_phase``): the
operator's front door at the served widths with ``--kv-block 16``.
Server A has a byte-level stand-in tokenizer (``ByteTokenizer``; the
card's machine serves without an HF tokenizer directory): text prompts
against their ids, NDJSON text deltas, ``/v1/completions`` (n = 2
sampled choices against ``/v1/generate`` with seed s + i, a stop string,
SSE) and ``/v1/chat/completions``; A' (A's weights) over mTLS with
certificates ``openssl`` makes (good, certless, evil-CA and non-serving
clients, the CN as the tenant, the weights over https against http);
the kernel switch's A/B, engine K (the kernels) against P (both
switches off), K then P on eight concurrent requests and a lone
512-token prompt; a 0.5 s ``/debugz/profile`` capture during four
streams; the recompile sentinel (silent after warmup, and an unwarmed
engine armed by hand charged its first dispatch's captures while a
sibling's warmup fires nothing); a mixed engine (decode on the
kernels, admissions plain); and ``serve_main`` as its own process with
``--trace-file --log-level debug --paged-kernel on``.  It runs in the
full smoke and with ``--serve-phase-only`` when the package has
``--tokenizer-dir``.
The default serve phase, the spec phase's target engines, the QoS and
front phases, training and the parallel phase's Qwen run all 28
layers; the paged, int4, prefix, KV block I/O and HTTP phases and the
self-draft engines serve the model at ``SIDE_LAYERS`` (14), any host
tier's bytes cut in proportion, the draft model runs 12 of its 24
layers and the bf16 MoE serve phase 16 of Mixtral's 32: the smoke's
time limit.
``--parallel-phase-only`` runs only the parallel phase
(``parallel_phase``): K1/K2 at the ranks' head counts (Qwen tp=2: 6 / 1;
Mixtral tp2·ep2: 16 / 4) and ``quant_matmul`` at the tp2·ep2 ranks'
int8 shapes against their plain versions; Qwen2.5-1.5B at tp=2 as two
gloo ranks sharing the card (eager, 14 of its 28 layers) against the
tp=1 engine
on the same weights (streams equal or parting at a near tie, every
rank's buffers bitwise equal, K1/K2 and the collectives once a layer a
pass), then on the same ranks the block I/O leg (``par_io``: a paged
engine with a host tier and a QoS policy — a prefix demoted and
promoted, a preemption parked and restored —, held KV and a live slot
shipped tp=1 → tp=2 and back, a tp=2 round trip bitwise, ``/v1/weights``
byte-equal to tp=1's, the ranks loading tp=1's stream as a peer into
their drawn shards bitwise, embed and a beam while streams decode; tier
and ship counters equal to tp=1's, K1/K2 at 6 / 1 heads counted on every
rank); Qwen on a one-rank NCCL mesh with CUDA graphs (the collectives
captured and counted by replay; streams equal to the engine with no
mesh; the host tier, parking and a round trip too, an admission wave
and a decode chunk eager = replay); Mixtral-8x7B's widths at tp2·ep2 as
four gloo ranks (int8, 4 layers; teacher-forced with the ranks' own
expert choices); and
``serve_main --bootstrap`` on a file staging ``/dev/nvidia0`` beside
``--tp 2`` refused on the one card.  The full smoke runs it after the
HTTP phase.
``--train-parallel-phase-only`` runs only the training-parallel phase
(``train_parallel_phase``): RMSNorm, the flash kernels and the fused-CE
forward and joint backward at a dp=2 rank's shapes against their plain
versions; ``train_main --dp 2 --backend gloo`` (two gloo ranks sharing
the card) at Qwen2.5-1.5B's widths and 4 of its 28 layers, its losses
held against one device's, every rank launching the training kernels
each step, replicated leaves bit-equal across ranks, once without and
once with ``--zero1`` (the main path: checkpointed, interrupted after
step 2, resumed by the same command bit for bit, exported; moments per
rank halved); that checkpoint restored onto one device and its export
served by ``serve_main --params-dir``; one NCCL rank with the step's
CUDA graph (4 layers), the gradient all-reduce inside it, bit-equal to
the eager steps and to no mesh; ``--tp 2`` at 4 layers and ``--ep 2`` at
Mixtral-8x7B's widths and one layer, each against one device running
the same plain math and launching none of the training kernels (the
reference's gate); and two ``train_main --bootstrap`` processes from
staged files.  The full smoke runs it after the parallel phase.

It exits non-zero without a result line when no GPU is visible, when the
port's package is not beside it, or when any phase fails.  Every number
it prints is measured in this run; the second-to-last line is the
``{"kernels": [...]}`` record and the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}

# Serving configuration: Qwen2.5-1.5B at its published widths
# (huggingface.co/Qwen/Qwen2.5-1.5B config.json), random weights, and
# serve_main's engine defaults: the dense cache, pipeline depth 2, each
# decode chunk one CUDA graph replay.
SERVE_ARGS = [
    "--vocab-size", "151936", "--d-model", "1536", "--n-layers", "28",
    "--n-heads", "12", "--n-kv-heads", "2", "--d-ff", "8960",
    "--rope-theta", "1000000", "--norm-eps", "1e-6", "--attn-bias",
    "--dtype", "bfloat16", "--n-slots", "8",
    "--max-len", "2048", "--chunk", "8", "--port", "0", "--seed", "0",
]
# The phases that serve the same model for what it does besides its
# forward (the prefix cache, KV block I/O, the HTTP surfaces) run it at
# SIDE_LAYERS of its 28 layers, the widths and traffic unchanged, and
# any host tier's byte budget cut in proportion (the same number of
# blocks): the smoke's time limit.
SIDE_LAYERS = 14


def at_depth(argv: list[str], layers: int) -> list[str]:
    """``argv`` with ``--n-layers`` set to ``layers``."""
    out = list(argv)
    out[out.index("--n-layers") + 1] = str(layers)
    return out


def side_bytes(n_bytes: int) -> int:
    """A host tier's byte budget at ``SIDE_LAYERS``: as many blocks as
    ``n_bytes`` holds at 28 layers."""
    return n_bytes * SIDE_LAYERS // 28


# The same model on the paged engine and the serial loop, eager: the
# serving path of the earlier slices, at SIDE_LAYERS.
PAGED_SERVE_ARGS = at_depth(SERVE_ARGS, SIDE_LAYERS) + [
    "--kv-block", "16", "--pipeline-depth",
                                 "1"]
# The quantization ladder's top rung on the same model: packed int4
# weights in groups of 64 and a packed int4 paged pool, at serve_main's
# default depth 2, at SIDE_LAYERS.
QUANT_SERVE_ARGS = at_depth(SERVE_ARGS, SIDE_LAYERS) + [
    "--kv-block", "16", "--kv-int4",
                                 "--weights-int4", "--int4-group", "64"]
# Speculative decoding on the same model (``--spec-decode 4``): prompt
# lookup on serve_main's defaults otherwise; the same with a draft model
# at Qwen2.5-0.5B's published widths (huggingface.co/Qwen/Qwen2.5-0.5B
# config.json: hidden 896, 24 layers, 14 / 2 kv heads of 64, MLP 4864,
# the same 151936 vocabulary — the family's usual draft), random weights
# from DRAFT_SEED written by the port's own exporter; as the reference
# builds a draft, it takes the target's vocabulary, RoPE base, norm
# epsilon and dtype, and no biases.  Its depth is cut to 12 of its 24
# layers: its prefill graphs' capture is most of the phase's wall.
SPEC = 4
SPEC_ARGS = SERVE_ARGS + ["--spec-decode", str(SPEC)]
DRAFT_FLAGS = ["--draft-n-layers", "12", "--draft-d-model", "896",
               "--draft-n-heads", "14", "--draft-n-kv-heads", "2",
               "--draft-d-ff", "4864"]
DRAFT_H, DRAFT_KVH, DRAFT_HD = 14, 2, 64
DRAFT_SEED = 1
# The self-draft engines (the draft is the target, at full width):
# (kv_block, spec_decode) — the verify shapes the two serve phases do not
# run — and the acceptance each must reach (the reference's bar,
# tests/test_serve.py).
SELF_DRAFT = ((0, 2), (16, 2), (16, 4))
SELF_ACCEPT = 0.8
# Two echo-heavy prompts beside the six: a 32-token span repeated.
ECHO_SPAN, ECHO_REPEATS = 32, (4, 8)
# /v1/beam at beam 4 against beam 1 (the same generation length, so the
# normalized scores compare): no worse, within bf16 rounding of the
# batched forward's logprobs.
BEAM_TOL = 0.01
H, KVH, HD, BS = 12, 2, 128, 16
MAX_LEN = 2048
# The dense cache's block: the largest that divides MAX_LEN and one step
# of K1's ring holds (serve/engine.py dense_block_size).
DENSE_BS = 64

# MoE configuration: Mixtral-8x7B-v0.1 at its published widths
# (huggingface.co/mistralai/Mixtral-8x7B-v0.1 config.json: hidden 4096,
# MLP 14336, 32 / 8 kv heads, head_dim 128, 8 experts, top 2, vocab
# 32000, rope_theta 1e6, RMSNorm eps 1e-5, no biases, no window), the
# repo's untied wlm, random weights from seed 0.  Served depth cut to
# 16 of 32 layers (cut from 24 for the smoke's time limit):
# in bf16 a layer is 2.90 GB (experts 2.82, attention 0.08) plus 0.067
# GB of dense cache (8 slots x 2048 rows), wte and the f32 wlm add 0.79
# GB — 71 GB (66 GiB) at 24 layers, 48 GB at 16, either leaving the 8
# GiB of headroom on an 80 GB card that ``MOE_FREE_GIB`` checks at the
# serving peak (admission transients, graph pool).  Trained at 2 layers:
# f32 masters, grads and AdamW moments of 3.2 B parameters, ~51 GB.
MOE_GEOMETRY = [
    "--vocab-size", "32000", "--d-model", "4096", "--n-heads", "32",
    "--n-kv-heads", "8", "--d-ff", "14336", "--n-experts", "8",
    "--moe-top-k", "2", "--rope-theta", "1000000", "--norm-eps", "1e-5",
    "--dtype", "bfloat16",
]
MOE_LAYERS = 16
MOE_SERVE_ARGS = MOE_GEOMETRY + [
    "--n-layers", str(MOE_LAYERS), "--n-slots", "8", "--max-len",
    str(MAX_LEN), "--chunk", "8", "--port", "0", "--seed", "0",
]
# Mixtral-8x7B whole: all 32 layers with weight-only int8 (a layer 1.45
# GB: 46.4 GB of layers, 49 GB with the embedding, the int8 unembedding
# and the dense cache), on the default engine.
MOE_INT8_LAYERS = 32
MOE_INT8_ARGS = MOE_GEOMETRY + [
    "--n-layers", str(MOE_INT8_LAYERS), "--weights-int8", "--n-slots", "8",
    "--max-len", str(MAX_LEN), "--chunk", "8", "--port", "0", "--seed", "0",
]
MOE_H, MOE_KVH, MOE_D, MOE_VOCAB = 32, 8, 4096, 32000
MOE_FREE_GIB = 8.0
MOE_TRAIN_STEPS, MOE_TRAIN_B = 3, 2
MOE_TRAIN_ARGS = MOE_GEOMETRY + [
    "--synthetic", "400000", "--steps", str(MOE_TRAIN_STEPS),
    "--batch-global", str(MOE_TRAIN_B), "--seq", "1024", "--seed", "0",
    "--n-layers", "2", "--router-z-loss", "1e-3", "--lr", "3e-4",
    "--log-every", "1",
]

# The train phases' device (the smoke needs a GPU; a constant so the
# phases can be rehearsed on the CPU at a tiny size).
DEV = "cuda"
# Training configuration: the same model, f32 masters with bf16 compute,
# a batch of 4 x 1024 synthetic tokens, a fixed learning rate.
TRAIN_STEPS = 5
TRAIN_B, TRAIN_T, D_MODEL = 4, 1024, 1536
TRAIN_ARGS = [
    "--synthetic", "400000", "--steps", str(TRAIN_STEPS),
    "--batch-global", str(TRAIN_B), "--seq", str(TRAIN_T), "--seed", "0",
    "--vocab-size", "151936", "--d-model", str(D_MODEL), "--n-layers", "28",
    "--n-heads", "12", "--n-kv-heads", "2", "--d-ff", "8960", "--attn-bias",
    "--rope-theta", "1000000", "--norm-eps", "1e-6", "--dtype", "bfloat16",
    "--lr", "3e-4", "--log-every", "1",
]

# Kernel vs plain tolerance: both sides compute in f32 from identical
# (bf16 or dequantized int8) inputs and differ only in summation order —
# 128-term dots, and an online vs a two-pass softmax over up to 2048
# keys — which bounds the gap by about n·eps·|v| = 2048 · 6e-8 · 4 ≈
# 5e-4.  A wrong block, mask or scale moves outputs by O(0.1).
KERNEL_ATOL = 1e-3
# K1's tensor-core route (bf16 q over more than 8 flattened rows: a
# prompt segment) rounds P (for int8, P times the v scale) to bf16 as the
# operand of P V, by design, as the flash forward rounds P: it is held at
# the flash forward's bf16 tolerance, TRAIN_TOL[bf16] below, as a
# fraction of the output's max: rounding P to bf16 (up to 2**-8 of a
# weight) moves an output by at most 2**-8 of the largest V value, which
# the rows attending a few keys carry into the output's max.  The decode
# and f32 routes keep KERNEL_ATOL.
# Teacher-forced check: the served model runs in bf16 (activations
# rounded to 8 mantissa bits at every projection and residual add over
# 28 layers), the reference in f32 over the same weights.  Logits have
# std ≈ 0.9 here, so a ~1% drift in the final hidden state moves them by
# a few hundredths; δ = 0.2 covers that with margin while a broken layer
# (wrong positions, wrong cache rows) moves logits by O(1).
DELTA = 0.2
LOGPROB_ATOL = 0.2
# MoE routing in that check: the served bf16 path's expert choices are
# teacher-forced into the f32 forward.  Where they differ from the f32
# router's own top-k, the f32 probability the served choice gives up
# must be a near tie's.  Measured on an H100 (``--route-control``): sound
# runs give up at most 0.0032-0.0070, and so does the router rounded to
# bf16 (0.0043-0.0074: inside the bf16 path's own noise), while one
# layer routed by another layer's router gives up 0.80-0.83.  0.02
# leaves ~3x room above the first and 40x below the second.
ROUTE_TIE = 0.02
# ``--route-control``: a router fault planted on purpose ("bf16" or
# "swap", ``plant_route_control``), which the MoE checks must catch.
ROUTE_CONTROL = None
# Training kernels vs their plain versions, as max |got - want| over
# max |want|: both sides compute in f32 from the same inputs and round
# once to the output dtype, so in bf16 they differ by at most one
# rounding step (2**-7 of a value, and values are at most the max) plus
# f32 summation-order noise; in f32 by that noise alone (sums of up to
# 1024 terms at eps 6e-8 stay below 1e-5 of the max).  A wrong mask,
# tile or head moves outputs by O(1) of the max.
TRAIN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-7 + 1e-4}
# First training step, kernel path against a plain f32 path on the same
# weights and batch.  In bf16 the kernel path rounds activations to 8
# mantissa bits at every projection over 28 layers: 0.02 on a loss of
# about 12 and 5 % of each gradient's norm leave room for that, while a
# broken kernel or layer moves the loss by O(0.1) and gradients by O(1).
# In f32 the two paths differ in summation order only: 1e-3 of each.
STEP_LOSS_ATOL = {torch.bfloat16: 0.02, torch.float32: 1e-3}
STEP_GRAD_RTOL = {torch.bfloat16: 0.05, torch.float32: 1e-3}
# Fused unembed+CE kernels vs their plain versions, as max |got - want|
# over max |want|.  Both compute the scores in f32 from the same
# compute-dtype products (exact in f32): lse and the target differ by
# summation order over D = 1536 terms and V tiles, under 1e-5 of the
# max.  Both round the dlogits to the compute dtype before either
# product: dx comes back in that dtype, so one bf16 rounding step (2**-7
# of the max) plus order noise bounds it; in f32 it sums V = 151936
# products in another order, within 1e-4 of the max; dw sums rows in f32,
# and 1e-4 of its max covers that and the few dlogits whose last f32 bit
# rounds the other way.  A wrong tile, label or lse moves them by O(1).
FUSED_CE_TOL = {"lse": 1e-5, "target": 1e-5, "dw": 1e-4,
                "dx": {torch.float32: 1e-4, torch.bfloat16: 2.0**-7 + 1e-4}}
VOCAB = 151936
# Checkpoint phase: the training model at full width, its depth cut to 2
# layers.  One checkpoint holds the f32 params and both AdamW moments:
# 12 bytes x 1.78 B parameters = 21 GB at 28 layers, 6.8 GB at 2; at
# most two exist at once.  Resume must give an uninterrupted run's
# losses to 1e-5 relative (the phase reports whether they are bit-equal).
CKPT_LAYERS = 2
RESUME_RTOL = 1e-5
LORA_RANK = 8
# K1's split sweeps: table ranges per slot at decode (the 128-entry
# table cut into 1 ... 64 ranges) and at the 512-token prefill.
DECODE_SPLITS = (1, 2, 4, 8, 16, 32, 64)
PREFILL_SPLITS = (1, 2, 4)
# Vocabulary columns per chunk at which --kernel-phase-only times a full
# step's fused-CE backward (chunk_columns gives 32768 at the training
# shape on the wgmma route).
CE_CHUNKS = (8192, 16384, 32768, 65536)
# Device sleep that every timed series queues behind: 2e8 cycles, about
# 0.1 s at the H100's clocks, covers the host's enqueue of the series.
SLEEP_CYCLES = 200_000_000
# nvidia-smi's "name, power.limit" line, printed beside every time.
SMI = ""


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, message: str) -> None:
    if not cond:
        raise SmokeFailure(message)


def time_ms(fn, runs: int = 25, warmup: int = 3) -> float:
    """Median device time of one ``fn`` call in ms over ``runs`` runs,
    by CUDA events around each run.  Every run is queued behind a long
    device sleep, so the host has enqueued them all before the first
    starts and the events time the device, not Python's launch overhead
    (a version that synchronises inside, as boolean indexing does, pays
    that overhead anyway); before each run a 128 MiB write flushes the
    50 MB L2, because the serving path meets each layer's pool cold."""
    for _ in range(warmup):
        fn()
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    events = [
        (torch.cuda.Event(enable_timing=True),
         torch.cuda.Event(enable_timing=True))
        for _ in range(runs)
    ]
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def host_ms(fn, runs: int = 10, warmup: int = 3) -> float:
    """Median host time in ms to enqueue one ``fn`` call, every call
    issued behind a long device sleep so that the host never waits for
    the device (a call that synchronises inside waits out the sleep)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    spent = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        spent.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(spent)) * 1e3


# ---------------------------------------------------------------------------
# Kernel phase


def make_tables(rng, n_rows, positions, n_blocks, reserve=2):
    """Block tables whose live entries cover [0, positions[b]] plus a few
    reserved blocks (as an admission's worst case would), the rest
    sentinel; a position of -1 gives an all-sentinel row."""
    n_tables = MAX_LEN // BS
    tables = np.full((n_rows, n_tables), n_blocks, np.int32)
    free = list(rng.permutation(n_blocks))
    for b, pos in enumerate(positions):
        if pos < 0:
            continue
        n = min(n_tables, pos // BS + 1 + reserve)
        tables[b, :n] = [free.pop() for _ in range(n)]
    return tables


def make_pool(gen, n_blocks, quant, bs=BS, kvh=KVH, hd=HD):
    """K/V pools and scales: bf16 (``quant`` falsy), int8 (truthy) or
    packed int4 (``"int4"``: values in [-7, 7], two a byte)."""
    from oim_tpu_torch.ops.quant import pack_int4

    shape = (n_blocks, bs, kvh, hd)
    if quant:
        lo, hi = (-7, 8) if quant == "int4" else (-127, 128)
        k, v = (torch.randint(lo, hi, shape, generator=gen, device="cuda",
                              dtype=torch.int8) for _ in range(2))
        if quant == "int4":
            k, v = pack_int4(k), pack_int4(v)
        ks = torch.rand(shape[:-1], generator=gen, device="cuda") * 0.04 + 0.005
        vs = torch.rand(shape[:-1], generator=gen, device="cuda") * 0.04 + 0.005
        return k, v, ks, vs
    k = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    return k, v, None, None


def row_bytes(pool, scale) -> int:
    """Bytes of one position's K (or V) row in the pool: every kv head's
    payload (hd / 2 bytes packed int4) plus, for int8 and int4, its f32
    scale."""
    kvh = pool.shape[2]
    per_row = kvh * pool.shape[-1] * pool.element_size()
    if scale is not None:
        per_row += kvh * 4
    return per_row


def attend_work(starts, t, tables, n_blocks, window, bs=BS):
    """What K1 must touch at these inputs (blocks of ``bs`` rows):
    ``pairs``, the (query position, key position) pairs its rows attend,
    and ``rows``, the distinct live key positions they read, both summed
    over slots."""
    pairs = rows = 0
    for b in range(len(starts)):
        live = np.repeat(tables[b] < n_blocks, bs)
        read = np.zeros_like(live)
        for i in range(t):
            p = int(starts[b]) + i
            lo = max(0, p - window + 1) if window else 0
            pairs += int(live[lo:p + 1].sum())
            read[lo:p + 1] = True
        rows += int((read & live).sum())
    return pairs, rows


def bound(moved: int, ops: int, dtype) -> tuple[float, str]:
    """The least time for the work: the larger of bytes over the memory
    rate and operations over the peak rate for ``dtype``."""
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS[dtype] * 1e3
    if bytes_ms >= ops_ms:
        return bytes_ms, "bytes"
    return ops_ms, "operations"


def decode_bound(q, pool, scale, tables, starts, window):
    """Least time for K1 on these inputs: q read once, each needed K and
    V row read once, the f32 output written once, the table and starts
    read once; 4·hd operations (q·k and p·v) per (query head, key)."""
    b, t, h, hd = q.shape
    pairs, rows = attend_work(starts.cpu().numpy(), t, tables.cpu().numpy(),
                              pool.shape[0], window, pool.shape[1])
    moved = (q.numel() * q.element_size() + 2 * rows * row_bytes(pool, scale)
             + b * t * h * hd * 4 + tables.numel() * 4 + b * 4)
    return bound(moved, 4 * hd * h * pairs, q.dtype)


def store_bound(k_new, pool, scale, tables, starts):
    """Least time for K2 on these inputs: k_new and v_new read once, each
    live window row of both pools (and scales) written once."""
    b, t = k_new.shape[:2]
    tab, st = tables.cpu().numpy(), starts.cpu().numpy()
    live = 0
    for r in range(b):
        pos = st[r] + np.arange(t)
        entry = pos // pool.shape[1]
        ok = entry < tab.shape[1]
        live += int((tab[r, entry[ok]] < pool.shape[0]).sum())
    moved = (2 * k_new.numel() * k_new.element_size()
             + 2 * live * row_bytes(pool, scale) + tables.numel() * 4 + b * 4)
    # int8 and int4: an abs-max, a division and a rounding per element,
    # in f32.
    ops = 3 * 2 * k_new.numel() if scale is not None else 0
    return bound(moved, ops, torch.float32)


def sdpa_yardstick(q, pool, scale, tables, starts, window):
    """One F.scaled_dot_product_attention call over the gathered,
    dequantized view with the same mask — the library time beside K1
    (timed only; the port never calls it)."""
    from oim_tpu_torch.ops.paged import paged_view
    from oim_tpu_torch.ops.quant import dequantize_int8, kv_values

    b, t, h, hd = q.shape
    view, sview = paged_view(pool, scale, tables)
    kv = (view.float() if sview is None
          else dequantize_int8(kv_values(view), sview))
    kv = kv.to(q.dtype).repeat_interleave(h // pool.shape[2],
                                          dim=2).transpose(1, 2)
    kv = kv.contiguous()
    n_keys = kv.shape[2]
    q_pos = starts.long()[:, None] + torch.arange(t, device=q.device)
    k_pos = torch.arange(n_keys, device=q.device)
    live = (tables < pool.shape[0]).repeat_interleave(pool.shape[1], dim=1)
    mask = (k_pos[None, None] <= q_pos[:, :, None]) & live[:, None]
    if window:
        mask &= q_pos[:, :, None] - k_pos[None, None] < window
    mask = mask[:, None]
    qh = q.transpose(1, 2).contiguous()
    fn = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qh, kv, kv, attn_mask=mask
    )
    return time_ms(fn)


def k1_split_kw(pa, splits) -> dict:
    """``splits`` as a keyword for ``paged_flash_decode`` (None: the
    wrapper's own choice).  A package from before K1 took a split (a
    parent checkout timed beside this one) has only its own route."""
    if splits is None:
        return {}
    if not hasattr(pa, "decode_split"):
        raise SmokeFailure("this package's K1 takes no split")
    return {"splits": splits}


def k1_route(pa, q, kvh) -> str:
    """The route K1 takes for ``q`` over ``kvh`` kv heads in package
    ``pa`` ("cuda cores" for a package from before the routes had
    names)."""
    if not hasattr(pa, "decode_route"):
        return "cuda cores"
    return pa.decode_route(q.dtype, q.shape[1], q.shape[2] // kvh)


def k1_tol(pa, q, kvh, want) -> float:
    """K1's tolerance on ``q``: TRAIN_TOL[bf16] of the output's max on
    the tensor-core route, KERNEL_ATOL on the others."""
    if k1_route(pa, q, kvh) == "tc":
        return TRAIN_TOL[torch.bfloat16] * float(want.abs().max())
    return KERNEL_ATOL


def k1_check(tag, pa, args, window, zero_rows, splits=None) -> float:
    """K1 against its plain version on ``args`` at one split: finite,
    within its route's tolerance (``k1_tol``), the slots ``zero_rows``
    (all-sentinel) exactly zero, and two launches bit-equal (no float
    atomics; the merge of the splits runs in a fixed order).  Returns
    the max abs error."""
    kw = k1_split_kw(pa, splits)
    got = pa.paged_flash_decode(*args, window=window, **kw)
    again = pa.paged_flash_decode(*args, window=window, **kw)
    want = pa.paged_flash_decode_plain(*args, window=window)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = k1_tol(pa, args[0], args[1].shape[2], want)
    what = f"K1 {tag} window={window} splits={splits or 'chosen'}"
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite")
    check(not bool(got[zero_rows].any()),
          f"{what}: all-sentinel rows must be zeros")
    check(torch.equal(got, again), f"{what}: two launches differ")
    check(err <= tol, f"{what} disagrees: {err} > {tol}")
    return err


def k1_phase(tag, pa, args, zero_rows, sweep, windows) -> dict:
    """K1 on ``args`` checked at windows ``windows`` for the wrapper's
    split and every split of ``sweep``, then timed (window 0) at each;
    prints one line per window and one of times, and returns the
    record of the wrapper's split."""
    q, pool, _, scale, _, tables, starts = args
    kvh = pool.shape[2]
    sweep = sweep if hasattr(pa, "decode_split") else ()
    chosen = ""
    if sweep:
        b, t, h, _ = q.shape
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        if hasattr(pa, "decode_plan"):  # tiles of the route it launches
            _, entries = pa.decode_plan(q.dtype, b, t, h, kvh,
                                        tables.shape[1], sms)
        else:
            tiles = -(-t * (h // kvh) // pa.Q_TILE_ROWS)
            entries = pa.decode_split(b * kvh, tiles, tables.shape[1], sms)
        chosen = (f"; decode_split: {entries} entries a split, "
                  f"{-(-tables.shape[1] // entries)} splits")
    route = k1_route(pa, q, kvh)
    err = 0.0
    for window in windows:
        errs = [k1_check(tag, pa, args, window, zero_rows, s)
                for s in (None, *sweep)]
        err = max(err, errs[0])
        tol = k1_tol(pa, q, kvh,
                     pa.paged_flash_decode_plain(*args, window=window))
        print(f"K1 {tag} window={window} ({route} route): max_abs_err="
              f"{errs[0]:.3e} at the wrapper's split, {max(errs):.3e} over "
              f"splits {list(sweep)} (tol {tol:.3e}); two launches "
              f"bit-equal; all-sentinel rows zero{chosen}", flush=True)
    times = {s: time_ms(lambda: pa.paged_flash_decode(
        *args, **k1_split_kw(pa, s))) for s in (None, *sweep)}
    ms = times.pop(None)
    plain_ms = time_ms(lambda: pa.paged_flash_decode_plain(*args))
    lib_ms = sdpa_yardstick(q, pool, scale, tables, starts, 0)
    bnd, by = decode_bound(q, pool, scale, tables, starts, 0)
    sweep_txt = "".join(f", splits {s_} {t_:.4f}" for s_, t_ in times.items())
    print(f"K1 {tag} ({route} route): {ms:.4f} ms at the wrapper's split"
          f"{sweep_txt} (plain {plain_ms:.4f}, sdpa {lib_ms:.4f} = "
          f"{ms / lib_ms:.2f}x, bound {bnd:.5f} by {by}) [{SMI}]",
          flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                bound_by=by, library_ms=lib_ms)


def k2_phase(tag, pa, k_new, v_new, pools, scales, tables, starts) -> dict:
    """K2 against ``paged_store`` on copies of ``pools``/``scales``:
    every pool byte and scale equal (rows in sentinel entries and past
    the table dropped, rows outside the window untouched), then timed.
    Returns its record; ``pools``/``scales`` hold K2's writes."""
    ref_pools = [p.clone() for p in pools]
    ref_scales = [None if s is None else s.clone() for s in scales]
    store = (k_new, v_new, *pools, *scales, tables, starts)
    pa.paged_kv_store(*store)
    pa.paged_kv_store_plain(k_new, v_new, *ref_pools, *ref_scales, tables,
                            starts)
    torch.cuda.synchronize()
    pairs = list(zip(pools, ref_pools))
    if scales[0] is not None:
        pairs += list(zip(scales, ref_scales))
    same = all(torch.equal(a, b) for a, b in pairs)
    err = max(float((a.float() - b.float()).abs().max()) for a, b in pairs)
    check(same, f"K2 {tag}: pool bytes differ from paged_store (max abs "
                f"{err})")
    ms = time_ms(lambda: pa.paged_kv_store(*store))
    plain = time_ms(lambda: pa.paged_kv_store_plain(*store))
    bnd, by = store_bound(k_new, pools[0], scales[0], tables, starts)
    print(f"K2 store {tag}: pool bytes equal to paged_store; {ms:.4f} ms "
          f"(plain {plain:.4f}, bound {bnd:.5f} by {by}) [{SMI}]",
          flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, library_ms=None)


def kernel_phase() -> dict:
    """K1 at the decode shape, K2 at t=1, and K2+K1 at a 512-token
    prefill and at a ragged 100-token one (with an all-sentinel slot),
    for bf16, int8 and packed int4 pools of 16-row blocks (the paged
    engine), then the same at the dense cache's shapes
    (``dense_kernel_phase``); returns the measured record per kernel and
    shape (bf16 — the served configuration — and int4, the
    ``--kv-int4`` serve phase's pool)."""
    from oim_tpu_torch.ops import paged_attention as pa

    rng = np.random.RandomState(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    n_blocks = 8 * (MAX_LEN // BS)
    # The least time any launch reads under time_ms: K2's times sit just
    # above it.
    tiny = torch.zeros(1, device="cuda")
    record = {"floor_ms": time_ms(tiny.zero_)}
    print(f"timing floor: a one-element fill takes {record['floor_ms']:.4f} "
          f"ms under the kernels' timing [{SMI}]", flush=True)
    for quant in (False, True, "int4"):
        tag = quant if quant == "int4" else "int8" if quant else "bf16"
        k_pool, v_pool, ks, vs = make_pool(gen, n_blocks, quant)
        # -- K1 at decode: B=8, t=1, mixed contexts, two all-sentinel rows.
        positions = [0, 16, 299, 999, 2047, 776, -1, -1]
        tables_np = make_tables(rng, 8, positions, n_blocks)
        tables = torch.from_numpy(tables_np).cuda()
        starts = torch.tensor([max(p, 0) if p >= 0 else 5 for p in positions],
                              dtype=torch.int32, device="cuda")
        q = torch.randn((8, 1, H, HD), generator=gen,
                        device="cuda").to(torch.bfloat16)
        args = (q, k_pool, v_pool, ks, vs, tables, starts)
        k1 = k1_phase(f"decode {tag} B=8 t=1", pa, args, slice(6, None),
                      DECODE_SPLITS, (0, 256))
        # -- K2 at decode: one new row per slot, two slots all-sentinel.
        dk = torch.randn((8, 1, KVH, HD), generator=gen,
                         device="cuda").to(torch.bfloat16)
        k2d = k2_phase(f"{tag} B=8 t=1", pa, dk, dk.clone(),
                       [k_pool.clone(), v_pool.clone()],
                       [None, None] if ks is None else [ks.clone(),
                                                        vs.clone()],
                       tables, starts)
        # -- K2 + K1 at a 512-token prefill straddling a block, then at a
        # ragged 100 tokens (not a multiple of any tile) with a third,
        # all-sentinel slot.
        for t, pstarts in ((512, [37, 1000]), (100, [37, 1000, 5])):
            ends = [s + t - 1 for s in pstarts[:2]] + [-1] * (
                len(pstarts) - 2)
            ptables = torch.from_numpy(make_tables(
                rng, len(pstarts), ends, n_blocks, reserve=4)).cuda()
            pst = torch.tensor(pstarts, dtype=torch.int32, device="cuda")
            b = len(pstarts)
            k_new = torch.randn((b, t, KVH, HD), generator=gen,
                                device="cuda").to(torch.bfloat16)
            v_new = torch.randn((b, t, KVH, HD), generator=gen,
                                device="cuda").to(torch.bfloat16)
            qp = torch.randn((b, t, H, HD), generator=gen,
                             device="cuda").to(torch.bfloat16)
            pools = [k_pool.clone(), v_pool.clone()]
            scales = [None, None] if ks is None else [ks.clone(), vs.clone()]
            k2 = k2_phase(f"{tag} B={b} t={t}", pa, k_new, v_new, pools,
                          scales, ptables, pst)
            k1t = k1_phase(f"prefill {tag} B={b} t={t}", pa,
                           (qp, *pools, *scales, ptables, pst),
                           slice(2, None), PREFILL_SPLITS, (0, 256))
            if not quant and t == 512:
                record.update(K1=k1, K1t=k1t, K2=k2, K2d=k2d)
            if quant == "int4" and t == 512:
                record.update(K1_i4=k1, K1t_i4=k1t, K2_i4=k2, K2d_i4=k2d)
            del pools, scales
        del k_pool, v_pool, ks, vs
        torch.cuda.empty_cache()
    record.update(dense_kernel_phase(pa, gen))
    return record


def dense_kernel_phase(pa, gen, h=H, kvh=KVH, tag="dense",
                       suffix="_dense", hd=HD) -> dict:
    """K1 and K2 at a main path's shapes: the dense cache of 8 slots x
    2048 rows, which the engine hands the kernels as blocks of
    ``DENSE_BS`` rows through a fixed identity table — every slot live
    at decode, contexts 0 to 2047; a 512-token segment for two slots at
    the prefill — with ``h`` query and ``kvh`` kv heads of ``hd``.
    bf16; returns the records, keyed with ``suffix``."""
    n_blocks = 8 * (MAX_LEN // DENSE_BS)
    k_pool, v_pool, _, _ = make_pool(gen, n_blocks, False, DENSE_BS, kvh,
                                     hd)
    tables = torch.arange(n_blocks, dtype=torch.int32,
                          device="cuda").reshape(8, -1)
    starts = torch.tensor([0, 16, 299, 999, 2047, 776, 1500, 40],
                          dtype=torch.int32, device="cuda")
    q = torch.randn((8, 1, h, hd), generator=gen,
                    device="cuda").to(torch.bfloat16)
    none = slice(0, 0)  # no all-sentinel slot in a dense cache
    k1 = k1_phase(f"decode bf16 {tag} B=8 t=1", pa,
                  (q, k_pool, v_pool, None, None, tables, starts), none,
                  (1, 4, 16, 32), (0, 256))
    dk = torch.randn((8, 1, kvh, hd), generator=gen,
                     device="cuda").to(torch.bfloat16)
    k2d = k2_phase(f"bf16 {tag} B=8 t=1", pa, dk, dk.clone(),
                   [k_pool.clone(), v_pool.clone()], [None, None], tables,
                   starts)
    t, slots = 512, [2, 5]
    ptables = tables[slots].contiguous()
    pst = torch.tensor([37, 1000], dtype=torch.int32, device="cuda")
    k_new, v_new = (torch.randn((2, t, kvh, hd), generator=gen,
                                device="cuda").to(torch.bfloat16)
                    for _ in range(2))
    qp = torch.randn((2, t, h, hd), generator=gen,
                     device="cuda").to(torch.bfloat16)
    pools = [k_pool.clone(), v_pool.clone()]
    k2 = k2_phase(f"bf16 {tag} B=2 t={t}", pa, k_new, v_new, pools,
                  [None, None], ptables, pst)
    k1t = k1_phase(f"prefill bf16 {tag} B=2 t={t}", pa,
                   (qp, *pools, None, None, ptables, pst), none,
                   PREFILL_SPLITS, (0, 256))
    del k_pool, v_pool, pools
    torch.cuda.empty_cache()
    return {"K1" + suffix: k1, "K1t" + suffix: k1t, "K2" + suffix: k2,
            "K2d" + suffix: k2d}


def moe_kernel_phase() -> dict:
    """K1 and K2 at the MoE serve phase's shapes: the dense cache's
    64-row blocks with Mixtral's 32 query and 8 kv heads (group 4: K1's
    decode route holds t·group = 4 of its 8 rows a (slot, kv head), the
    tall route 2048 rows a (slot, kv head) at t=512)."""
    from oim_tpu_torch.ops import paged_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(4)
    return dense_kernel_phase(pa, gen, MOE_H, MOE_KVH,
                              f"dense H={MOE_H} KVH={MOE_KVH}", "_moe")


def spec_kernel_phase() -> dict:
    """K1 and K2 at the speculative paths' shapes.  A verify writes and
    attends ``t = spec + 1`` rows a slot: t = 3 and t = 5 (spec 2 and 4)
    at Qwen's 12 / 2 heads — 18 and 30 rows a (slot, kv head), K1's
    tensor-core route — from decode contexts, on the dense cache's
    64-row blocks (every slot live) and on the paged pool's 16-row
    blocks (two all-sentinel slots).  Then the draft model's shapes on
    its dense cache: Qwen2.5-0.5B's 14 / 2 heads of 64 at t = 1 (group
    7: K1's 8-row route) and at its prefill (``dense_kernel_phase``).
    bf16; returns the records (``K1v{t}_{layout}``, ``K2v{t}_{layout}``
    and the ``_draft`` ones)."""
    from oim_tpu_torch.ops import paged_attention as pa

    rng = np.random.RandomState(14)
    gen = torch.Generator(device="cuda").manual_seed(14)
    record = {}
    contexts = [0, 16, 299, 999, 2040, 776, 1500, 40]
    for layout in ("dense", "paged"):
        if layout == "dense":
            n_blocks = 8 * (MAX_LEN // DENSE_BS)
            k_pool, v_pool, _, _ = make_pool(gen, n_blocks, False, DENSE_BS)
            zero_rows = slice(0, 0)
        else:
            n_blocks = 8 * (MAX_LEN // BS)
            k_pool, v_pool, _, _ = make_pool(gen, n_blocks, False)
            zero_rows = slice(6, None)
        starts = torch.tensor(contexts, dtype=torch.int32, device="cuda")
        for t in (3, 5):
            if layout == "dense":
                tables = torch.arange(n_blocks, dtype=torch.int32,
                                      device="cuda").reshape(8, -1)
            else:
                ends = [c + t - 1 for c in contexts[:6]] + [-1, -1]
                tables = torch.from_numpy(make_tables(
                    rng, 8, ends, n_blocks)).cuda()
            k_new, v_new = (torch.randn((8, t, KVH, HD), generator=gen,
                                        device="cuda").to(torch.bfloat16)
                            for _ in range(2))
            q = torch.randn((8, t, H, HD), generator=gen,
                            device="cuda").to(torch.bfloat16)
            pools = [k_pool.clone(), v_pool.clone()]
            tag = f"verify bf16 {layout} B=8 t={t}"
            record[f"K2v{t}_{layout}"] = k2_phase(
                tag, pa, k_new, v_new, pools, [None, None], tables, starts)
            record[f"K1v{t}_{layout}"] = k1_phase(
                tag, pa, (q, *pools, None, None, tables, starts), zero_rows,
                PREFILL_SPLITS, (0, 256))
            check(k1_route(pa, q, KVH) == "tc",
                  f"K1 {tag}: not on the tensor-core route")
            del pools
        del k_pool, v_pool
        torch.cuda.empty_cache()
    record.update(dense_kernel_phase(
        pa, gen, DRAFT_H, DRAFT_KVH,
        f"dense H={DRAFT_H} KVH={DRAFT_KVH} hd={DRAFT_HD} (the draft)",
        "_draft", hd=DRAFT_HD))
    return record


# The weight-quantized product (``ops/wquant.py``): the distinct weight
# shapes ([E,] K, N) of the quantized serve phases, by the weights that
# have them — Qwen2.5-1.5B's eight targets and Mixtral-8x7B's (attention,
# the experts, the unembedding) — each at the decode batch of 8 rows
# (w_out's experts one input an expert).  Qwen's run int4 (the
# ``--weights-int4`` serve phase) and int8, Mixtral's int8 (the 32-layer
# ``--weights-int8`` serve phase), its experts also int4; the rows of the
# serve phases' modes go on the ``kernels`` line.
QMM_ROWS = 8
QWEN_MATS = (("wq, wo", (1536, 1536)), ("wk, wv", (1536, 256)),
             ("w_gate, w_in", (1536, 8960)), ("w_out", (8960, 1536)),
             ("wlm", (1536, VOCAB)))
MIXTRAL_MATS = (("wq, wo", (4096, 4096)), ("wk, wv", (4096, 1024)),
                ("w_gate, w_in", (8, 4096, 14336)),
                ("w_out", (8, 14336, 4096)), ("wlm", (4096, MOE_VOCAB)))
QMM_CASES = (("qwen", "int4", QWEN_MATS), ("qwen", "int8", QWEN_MATS),
             ("mixtral", "int8", MIXTRAL_MATS),
             ("mixtral", "int4", MIXTRAL_MATS[2:4]))
# The tall route (the dequantized weight, then torch.matmul) at an
# admission's rows: Qwen's w_gate at a 1024-token bucket, Mixtral's
# experts at one 512-token MoE pass.
QMM_TALL = (("qwen", "int4", "w_gate, w_in", (1536, 8960), 1024),
            ("mixtral", "int8", "w_gate, w_in", (8, 4096, 14336), 512))
# quant_matmul against its plain version, as max |got - want| over max
# |want|: both read the same dequantized weights and sum in f32 in
# another order, and a bf16 output rounds once (one step, 2**-7 of a
# value); f32 outputs (the unembedding) differ by order noise over up
# to 14336 terms.  A wrong row, group or scale moves outputs by O(1).
QMM_TOL = {torch.bfloat16: 2.0**-7 + 1e-4, torch.float32: 1e-4}


def qmm_operands(gen, mode, shape, rows, per_expert):
    """A random weight of ``shape`` quantized under ``mode`` (int4 in
    groups of 64), its plain dequantized bf16 values, and bf16 x of
    ``rows`` rows ([E, rows, K] when ``per_expert``)."""
    from oim_tpu_torch.ops.quant import dequantize_weight, quantize_weight

    w = torch.randn(shape, generator=gen, device="cuda") * 0.02
    q, scale = quantize_weight(w, mode, 64)
    del w
    deq = dequantize_weight(q, scale, din=shape[-2]).to(torch.bfloat16)
    xs = (shape[0], rows, shape[-2]) if per_expert else (rows, shape[-2])
    x = torch.randn(xs, generator=gen, device="cuda").to(torch.bfloat16)
    return q, scale, deq, x


def qmm_case(tag, gen, mode, shape, rows, per_expert, out_dtype) -> dict:
    """``quant_matmul`` on one shape against its plain version: finite,
    within ``QMM_TOL``, two launches bit-equal, on the route
    ``quant_route`` names; then timed beside the plain version (the
    two-call dequantize-then-``torch.matmul``), one ``torch.matmul`` on
    the dequantized bf16 weight (what unquantized weights cost) and the
    bound (payload, scales, x and output moved once; 2·E·M·K·N
    operations at the bf16 rate).  Returns its record."""
    from oim_tpu_torch.ops import wquant as wq

    q, scale, deq, x = qmm_operands(gen, mode, shape, rows, per_expert)
    kw = dict(dtype=torch.bfloat16, out_dtype=out_dtype)
    e = shape[0] if len(shape) == 3 else 1
    route = wq.quant_route(torch.bfloat16, rows, shape[-2], shape[-1],
                           64 if mode == "int4" else 0)
    before = wq.counters()[f"quant_matmul_{route}"]
    got = wq.quant_matmul(x, q, scale, **kw)
    again = wq.quant_matmul(x, q, scale, **kw)
    want = wq.quant_matmul_plain(x, q, scale, **kw)
    torch.cuda.synchronize()
    check(wq.counters()[f"quant_matmul_{route}"] == before + 2,
          f"quant_matmul {tag}: not on its {route} route")
    err = float((got.float() - want.float()).abs().max())
    tol = QMM_TOL[got.dtype] * float(want.float().abs().max())
    check(bool(torch.isfinite(got).all()), f"quant_matmul {tag}: non-finite")
    check(torch.equal(got, again), f"quant_matmul {tag}: two launches differ")
    check(err <= tol, f"quant_matmul {tag} disagrees: {err} > {tol}")
    ms = time_ms(lambda: wq.quant_matmul(x, q, scale, **kw))
    plain_ms = time_ms(lambda: wq.quant_matmul_plain(x, q, scale, **kw))
    odt = out_dtype or torch.bfloat16
    xo, wo = x.to(odt), deq.to(odt)
    lib_ms = time_ms(lambda: torch.matmul(xo, wo))
    moved = (q.numel() + scale.numel() * 4 + x.numel() * 2
             + got.numel() * got.element_size())
    bnd, by = bound(moved, 2 * e * rows * shape[-2] * shape[-1],
                    torch.bfloat16)
    print(f"quant_matmul {tag} ({route} route): max_abs_err={err:.3e} "
          f"(tol {tol:.3e}); two launches bit-equal; {ms:.4f} ms (plain "
          f"{plain_ms:.4f}, torch.matmul on the dequantized bf16 weight "
          f"{lib_ms:.4f}, bound {bnd:.5f} by {by}; {q.numel() / ms / 1e9:.2f}"
          f" TB/s of payload, {bnd / ms:.0%} of the bound) [{SMI}]",
          flush=True)
    del q, scale, deq, x, got, again, want, xo, wo
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                bound_by=by, library_ms=lib_ms, route=route,
                key=wq.shape_key(route, shape))


def quant_kernel_phase() -> dict:
    """``quant_matmul`` at ``QMM_CASES``' shapes (8 rows) and the tall
    route at ``QMM_TALL``'s (``qmm_case``).  Returns the records keyed
    ``QMM <model> <mode> <weights>`` (``QMM tall ...`` for the tall
    route)."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    record = {}
    for model, mode, mats in QMM_CASES:
        for names, shape in mats:
            out = torch.float32 if names == "wlm" else None
            tag = f"{model} {mode} {names} {list(shape)} x {QMM_ROWS} rows"
            experts = names == "w_out" and len(shape) == 3
            record[f"QMM {model} {mode} {names}"] = qmm_case(
                tag, gen, mode, shape, QMM_ROWS, experts, out)
    for model, mode, names, shape, rows in QMM_TALL:
        tag = f"{model} {mode} {names} {list(shape)} x {rows} rows"
        record[f"QMM tall {model} {mode} {names}"] = qmm_case(
            tag, gen, mode, shape, rows, False, None)
    return record


# A chunked prefill's segment: 256 tokens (--prefill-chunk 256), timed
# at these starts (the prefix phase's hits write from 1008 on, its long
# miss from 0 to 1792 in steps of 256).
SEGMENT_T = 256
SEGMENT_STARTS = (768, 1536)


def segment_kernel_phase() -> dict:
    """K2 then K1's tall route at a segment's shape — one slot, t = 256
    new rows at each of ``SEGMENT_STARTS``, bf16 — on the dense cache's
    64-row blocks (the slot's identity table row) and on the paged
    pool's 16-row blocks (a table covering the segment's end plus a
    reserve, as an admission's plan does): K2 bit-equal to
    ``paged_store``, K1 against its plain version, each timed with its
    bound (and K1 with SDPA on the gathered view).  Returns the records
    keyed ``K1s<start>_<layout>`` and ``K2s<start>_<layout>``."""
    from oim_tpu_torch.ops import paged_attention as pa

    rng = np.random.RandomState(7)
    gen = torch.Generator(device="cuda").manual_seed(7)
    record = {}
    for layout, bs in (("dense", DENSE_BS), ("paged", BS)):
        n_blocks = 8 * (MAX_LEN // bs)
        k_pool, v_pool, _, _ = make_pool(gen, n_blocks, False, bs)
        for start in SEGMENT_STARTS:
            if layout == "dense":
                tables = torch.arange(n_blocks, dtype=torch.int32,
                                      device="cuda").reshape(8, -1)[3:4]
            else:
                tables = torch.from_numpy(make_tables(
                    rng, 1, [start + SEGMENT_T - 1], n_blocks,
                    reserve=4)).cuda()
            starts = torch.tensor([start], dtype=torch.int32, device="cuda")
            k_new, v_new = (torch.randn((1, SEGMENT_T, KVH, HD),
                                        generator=gen, device="cuda")
                            .to(torch.bfloat16) for _ in range(2))
            q = torch.randn((1, SEGMENT_T, H, HD), generator=gen,
                            device="cuda").to(torch.bfloat16)
            pools = [k_pool.clone(), v_pool.clone()]
            tag = f"segment {layout} t={SEGMENT_T} start={start}"
            record[f"K2s{start}_{layout}"] = k2_phase(
                tag, pa, k_new, v_new, pools, [None, None], tables, starts)
            record[f"K1s{start}_{layout}"] = k1_phase(
                tag, pa, (q, *pools, None, None, tables, starts),
                slice(0, 0), (), (0,))
            del pools
        del k_pool, v_pool
        torch.cuda.empty_cache()
    return record


# ---------------------------------------------------------------------------
# Serve phase


def post(port: int, body: dict,
         path: str = "/v1/generate") -> tuple[int, dict]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.status, json.loads(resp.read())


def get(port: int, path: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return json.loads(resp.read())


def gib(n_bytes: float) -> float:
    return n_bytes / 2**30


def release() -> None:
    """Return a finished phase's device memory to the card: what its
    dropped objects held goes back to the allocator at once (the smoke
    collects no reference cycles), cuBLAS's workspaces — 32 MiB for each
    stream a phase ran products on, such as a graph capture's side
    stream, kept for the process's life — are dropped (a captured graph
    keeps its own, in its pool), and the allocator's cache is
    emptied."""
    torch.cuda.synchronize()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()


def graph_pool_gib() -> float:
    """GiB of the card the allocator holds in private pools: the CUDA
    graphs' memory."""
    return gib(sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0)))


def free_at_peak() -> float:
    """GiB of the card free at the allocator's peak since its last reset:
    free now, plus what the allocator holds now, less what it held at
    the peak."""
    free, _ = torch.cuda.mem_get_info()
    return gib(free + torch.cuda.memory_reserved()
               - torch.cuda.max_memory_reserved())


class WidenedLayers:
    """The served layers widened to f32 as a forward reaches each one,
    into one set of f32 buffers reused layer after layer: the f32
    reference forward over a model too large to copy whole in f32.
    Widening bf16 to f32 is exact, so the forward computes what it would
    over a whole f32 copy.  A weight-quantized weight is widened from
    its dequantized values rounded to the served compute dtype
    (``dtype``): the values the served product reads."""

    def __init__(self, layers, dtype):
        self.layers, self.dtype, self.buffers = layers, dtype, {}

    def __len__(self):
        return len(self.layers)

    def __iter__(self):
        from oim_tpu_torch.ops.quant import dequantize_named

        for lp in self.layers:
            for name in lp:
                if name.endswith("_wscale"):
                    continue
                t = dequantize_named(lp, name, self.dtype)
                if name not in self.buffers:
                    self.buffers[name] = torch.empty(
                        t.shape, dtype=torch.float32, device=t.device)
                self.buffers[name].copy_(t)
                del t
            yield self.buffers


def widened(params, cfg):
    """(params, cfg) of the f32 reference forward over served ``params``:
    the embedding, final norm and unembedding recast (a quantized
    unembedding dequantized to the compute dtype first), the layers
    widened one at a time (``WidenedLayers``)."""
    from dataclasses import replace

    from oim_tpu_torch.models.transformer import prepare_param
    from oim_tpu_torch.ops.quant import dequantize_named

    cfg32 = replace(cfg, dtype="float32")
    out = {name: prepare_param(name, dequantize_named(
               params, name, cfg.compute_dtype), cfg32)
           for name in ("wte", "final_norm", "wlm")}
    out["layers"] = WidenedLayers(params["layers"], cfg.compute_dtype)
    return out, cfg32


class ServedKV:
    """The K/V rows a packed int4 pool holds for each request served
    while watched: at a request's finish, before its blocks go back to
    the allocator, the rows of its prompt and emitted tokens but the
    last (every layer, values and scales) are copied out by its table
    row, keyed by its prompt.  On the engine's stream, after every
    chunk that wrote them."""

    def __init__(self):
        self.kv = {}

    def watch(self, engine) -> None:
        finish = engine._finish_locked

        def recorded(slot, state):
            n = len(state.req.tokens) + len(state.emitted) - 1
            blocks = torch.as_tensor(
                engine._tables_host[slot][: -(-n // engine.kv_block)]
                .astype(np.int64), device=engine.device)
            cache = engine._cache
            self.kv[tuple(state.req.tokens)] = tuple(
                t[:, blocks].flatten(1, 2)[:, :n].clone()
                for t in (cache.k, cache.v, cache.k_scale, cache.v_scale))
            return finish(slot, state)

        engine._finish_locked = recorded

    @staticmethod
    def remove(engine) -> None:
        if "_finish_locked" in vars(engine):
            del engine._finish_locked  # the closure holds the engine


@contextlib.contextmanager
def served_kv(kv, seen: dict):
    """Around the f32 forward of one reply of an int4-KV engine (``kv``:
    ``ServedKV``'s rows for its prompt): each K/V row the forward stores
    is the served pool's own, dequantized, so that its attention reads
    what the served kernels read and δ judges the kernels.  First each
    served int4 value is held against the forward's own ``quantize_int4``
    of the same row: bf16 noise may move a value across a rounding edge
    (one step, counted in ``seen``), a row stored at another position or
    with another scale moves many values by several."""
    from oim_tpu_torch.models import decode as dec
    from oim_tpu_torch.ops.quant import (
        dequantize_int8,
        quantize_int4,
        unpack_int4,
    )

    store, calls = dec._store_kv, [0]

    def served(cache, scale, new, start):
        layer, which = divmod(calls[0], 2)
        calls[0] += 1
        t = new.shape[1]
        values = unpack_int4(kv[which][layer, start:start + t])
        own, _ = quantize_int4(new[0])
        steps = (values.int() - own.int()).abs()
        seen["max_step"] = max(seen["max_step"], int(steps.max()))
        seen["moved"] += int((steps > 0).sum())
        seen["values"] += steps.numel()
        store(cache, scale, dequantize_int8(
            values, kv[2 + which][layer, start:start + t])[None], start)

    dec._store_kv = served
    try:
        yield
    finally:
        dec._store_kv = store


class RoutingTap:
    """Within ``with``, every ``_router_gates`` call through ``module``
    (``models.decode`` for inference, ``models.transformer`` for
    training) appends its top-k expert choices [G, k], in rank order, to
    ``choices``.  Given ``forced`` (such a list from another run making
    the same calls in the same order), call i routes to ``forced[i]``
    instead, gated from its own probs by the reference's rule, and
    ``lost[i]`` [G] is the router probability its own top-k holds
    beyond the forced experts' (0 where they agree, small at a near
    tie).  A package without MoE has no ``_router_gates``: nothing is
    recorded."""

    def __init__(self, module, forced=None):
        self.module, self.forced = module, forced
        self.choices, self.own, self.lost = [], [], []
        self.record = getattr(module, "_router_gates", None)

    def __call__(self, probs, k):
        out = self.record(probs, k)
        if self.forced is None:
            self.choices.append(out[1])
            return out
        idx = self.forced[len(self.choices)]
        top = probs.gather(-1, idx)
        self.choices.append(idx)
        self.own.append(out[1])
        self.lost.append((out[0].sum(-1) - top.sum(-1)).detach())
        return top, idx, top if k == 1 else top / top.sum(-1, keepdim=True)

    def differing(self) -> int:
        """Rows whose own top-k set is not the forced one."""
        return sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                   for a, b in zip(self.own, self.choices))

    def most_lost(self) -> float:
        return max((float(x.max()) for x in self.lost), default=0.0)

    def __enter__(self):
        if self.record is not None:
            self.module._router_gates = self
        return self

    def __exit__(self, *exc):
        if self.record is not None:
            self.module._router_gates = self.record


def emitted_gap(params, cfg, prompt, gen_toks, forced=None):
    """Teacher-forced prefill over prompt + emitted tokens (all but the
    last, which no position reads): (each emitted token's logit below
    its position's max, its log probability, the ``RoutingTap``)."""
    from oim_tpu_torch.models import decode as dec

    seq = torch.tensor([prompt + gen_toks[:-1]], device=DEV)
    with RoutingTap(dec, forced) as tap, torch.no_grad():
        logits, _ = dec.prefill(params, seq, cfg, seq.shape[1])
    logits = logits[0, len(prompt) - 1:]  # predicts gen_toks
    chosen = logits[torch.arange(len(gen_toks)), torch.tensor(gen_toks)]
    gap = logits.max(dim=-1).values - chosen
    lp = chosen - torch.logsumexp(logits, dim=-1)
    return gap.cpu().numpy(), lp.cpu().numpy(), tap


class ServedRouting:
    """The served path's own expert choices, recorded while it serves the
    phase's requests, so that the f32 forward can be teacher-forced them.
    Between ``install()`` and ``remove()`` every ``_router_gates`` call
    through ``models.decode`` is recorded.  Admissions and decode passes
    both run inside CUDA graphs, where a replay runs no Python, so each
    call writes its choices into a device log at a device-side counter:
    a decode pass's [S, k] rows into ``log``, an admission's (inside
    ``serve.engine._admit_logits``) flattened [rows x bucket, k] into
    ``admit_log``.  These are small kernels a layer that the graphs'
    captures record, so ``install()`` comes before the engine starts, and
    the logs outlive its graphs.  ``watch(engine)``, after the warmup,
    sets the counters to 0 and records each decode dispatch (which
    request sits in which slot, at which position) and each admission
    dispatch (its bucket, rows and staged inputs) until ``remove()``;
    ``choices`` maps the logs back to one request."""

    LOG_ROWS = 8192
    ADMIT_ENTRIES = 1 << 22

    def __init__(self, n_slots: int, top_k: int):
        self.log = torch.zeros((self.LOG_ROWS, n_slots, top_k),
                               dtype=torch.int64, device=DEV)
        self.counter = torch.zeros(1, dtype=torch.int64, device=DEV)
        self.admit_log = torch.zeros(self.ADMIT_ENTRIES, dtype=torch.int64,
                                     device=DEV)
        self.admit_counter = torch.zeros(1, dtype=torch.int64, device=DEV)
        self.top_k = top_k
        self.admissions, self.dispatches = [], []
        self.admitting = False

    def __call__(self, probs, k):
        out = self.record(probs, k)
        if self.admitting:
            flat = out[1].reshape(-1)
            at = self.admit_counter + torch.arange(flat.numel(), device=DEV)
            self.admit_log.index_copy_(0, at.remainder(self.ADMIT_ENTRIES),
                                       flat)
            self.admit_counter.add_(flat.numel())
        else:
            self.log.index_copy_(0, self.counter.remainder(self.LOG_ROWS),
                                 out[1][None])
            self.counter.add_(1)
        return out

    def _admit_logits(self, *args):
        self.admitting = True
        try:
            return self.admit(*args)
        finally:
            self.admitting = False

    def install(self) -> None:
        from oim_tpu_torch.models import decode as dec
        from oim_tpu_torch.serve import engine as eng

        self.record, dec._router_gates = dec._router_gates, self
        self.admit, eng._admit_logits = eng._admit_logits, self._admit_logits

    def watch(self, engine) -> None:
        dispatch, admit = engine._dispatch_chunk, engine._dispatch_admission

        def recorded(acc, chained):
            handle = dispatch(acc, chained)
            self.dispatches.append(handle)
            return handle

        def admitted(bucket, rows, prompts, ints):
            self.admissions.append((bucket, rows, prompts.copy(),
                                    ints.copy()))
            return admit(bucket, rows, prompts, ints)

        self.chunk, self.n_layers = engine.chunk, engine.cfg.n_layers
        self.admissions.clear()
        self.counter.zero_()
        self.admit_counter.zero_()
        engine._dispatch_chunk = recorded
        engine._dispatch_admission = admitted

    def remove(self, engine=None) -> None:
        from oim_tpu_torch.models import decode as dec
        from oim_tpu_torch.serve import engine as eng

        dec._router_gates, eng._admit_logits = self.record, self.admit
        for name in ("_dispatch_chunk", "_dispatch_admission"):
            if engine is not None and name in vars(engine):
                delattr(engine, name)  # the closures hold the engine
        self.rows = int(self.counter)
        self.logged = self.log[:min(self.rows, self.LOG_ROWS)].cpu()
        self.admit_entries = int(self.admit_counter)
        self.admit_logged = self.admit_log[:min(
            self.admit_entries, self.ADMIT_ENTRIES)].cpu()

    def admitted(self, prompt) -> list | None:
        """Layer i's [P, k] choices over ``prompt`` from the admission
        dispatch that prefilled it whole (start 0, tail P), or None.
        Dispatch d of (bucket, rows) wrote, layer by layer, rows x bucket
        x k entries after those of the dispatches before it."""
        L, k, p = self.n_layers, self.top_k, len(prompt)
        offset, found = 0, None
        for bucket, rows, prompts, ints in self.admissions:
            size = rows * bucket * k
            meta = ints[:2 * rows].reshape(2, rows)
            for i in range(rows):
                if (meta[0, i] == 0 and meta[1, i] == p
                        and prompts[i, :p].tolist() == list(prompt)):
                    found = [self.admit_logged[offset + layer * size:
                                               offset + (layer + 1) * size]
                             .view(rows * bucket, k)[i * bucket:i * bucket + p]
                             for layer in range(L)]
            offset += L * size
        check(offset == self.admit_entries <= self.ADMIT_ENTRIES,
              f"the admission log holds {self.admit_entries} entries, the "
              f"{len(self.admissions)} recorded dispatches wrote {offset}")
        return found

    def choices(self, prompt, n: int) -> list:
        """The served choices of the request with ``prompt`` and ``n``
        emitted tokens: layer i's [P + n - 1, k] over the prompt (its
        admission's rows) and the emitted tokens but the last (each read
        by one decode pass of the request's slot), in layer order."""
        L, chunk, p = self.n_layers, self.chunk, len(prompt)
        check(self.rows == len(self.dispatches) * chunk * L
              and self.rows <= self.LOG_ROWS,
              f"the decode log holds {self.rows} rows, not "
              f"{len(self.dispatches)} dispatches x {chunk} x {L} layers")
        admitted = self.admitted(prompt)
        check(admitted is not None and len(admitted) == L,
              f"no admission of {L} layers recorded for a {p}-token prompt")
        rows = {}
        for d, handle in enumerate(self.dispatches):
            for slot, state in handle.snapshot.items():
                if list(state.req.tokens) != list(prompt):
                    continue
                for i in range(chunk):
                    pos = int(handle.starts[slot]) + i
                    if p <= pos < p + n - 1:
                        check(pos not in rows, f"position {pos} decoded twice")
                        base = (d * chunk + i) * L
                        rows[pos] = self.logged[base:base + L, slot]
        missing = [q for q in range(p, p + n - 1) if q not in rows]
        check(not missing, f"no decode pass recorded for positions {missing}")
        decoded = [torch.stack([rows[q][layer] for q in range(p, p + n - 1)])
                   if n > 1 else admitted[layer][:0] for layer in range(L)]
        return [torch.cat([a, d_]).to(DEV)
                for a, d_ in zip(admitted, decoded)]

    def decode_passes(self) -> int:
        return self.rows // max(self.n_layers, 1)


def plant_route_control(layers) -> list | None:
    """With ``--route-control``, plant a router fault into ``layers`` in
    place (the router widened from bf16, or layer 0 routed by layer 1's
    router) and return the routers as they were, to be put back with
    ``restore_routers``; without it, None."""
    if ROUTE_CONTROL is None:
        return None
    saved = [lp["router"].detach().clone() for lp in layers]
    with torch.no_grad():
        if ROUTE_CONTROL == "bf16":
            for lp, router in zip(layers, saved):
                lp["router"].copy_(router.to(torch.bfloat16))
        else:
            layers[0]["router"].copy_(saved[1])
    return saved


def restore_routers(layers, saved) -> None:
    if saved is not None:
        with torch.no_grad():
            for lp, router in zip(layers, saved):
                lp["router"].copy_(router)


def serve_phase(argv, tag: str, min_free_gib: float | None = None,
                echo: bool = False, beam_embed: bool = False,
                plain_rate: float | None = None) -> dict:
    """Serve six concurrent requests (with ``echo``, two echo-heavy ones
    too) through the port's serve_main entry
    with ``argv`` and check lengths, drain, kernel counters (reset just
    before the requests, read just after) and a teacher-forced f32
    reference (``teacher_check``); on an engine that replays CUDA graphs,
    also that
    every decode dispatch was one replay, then ``graph_check``.  Prints
    the memory the card had free at the serving peak (weights, cache,
    admission transients, graph pool), which must reach ``min_free_gib``
    when given.  A speculative engine's launches are counted by route
    with its verify passes and a draft model's forwards, its drafts must
    have been made (its acceptance share and decode rate are printed
    beside ``plain_rate``, a plain engine's on the same traffic), and its
    greedy requests served again at depth 2 and 1 must be token-identical
    (``depth_check``).  ``beam_embed``: ``beam_embed_check`` on the
    running server.  Returns the run's kernel launch counts with its
    times to first token, decode rate, memory and forward passes."""
    from oim_tpu_torch.cli import serve_main
    from oim_tpu_torch.ops import paged_attention as pa

    wq = quant_module()
    args = serve_main.build_parser().parse_args(argv)
    mode = (serve_main.weight_quant(args)
            if hasattr(serve_main, "weight_quant") else "")
    moe = bool(getattr(args, "n_experts", 0))
    routing = ServedRouting(args.n_slots, args.moe_top_k) if moe else None
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    if routing is not None:
        routing.install()  # before the engine captures its graphs
    try:
        server = serve_main.start_server(args)
    except BaseException:
        if routing is not None:
            routing.remove()
        raise
    engine = server.engine
    info = engine.info()["engine"]
    graphs = bool(info.get("cuda_graphs"))
    kv = None
    if info.get("kv_quant") == "int4":
        kv = ServedKV()
        kv.watch(engine)
    planted = None
    if routing is not None:
        routing.watch(engine)
        planted = plant_route_control(engine.params["layers"])
    trace = ServeTrace(engine)
    try:
        started = engine.stats()
        print(f"serve {tag}: started in {time.monotonic() - t0:.1f} s "
              f"(weights, warmup{', graph capture' if graphs else ''}; "
              f"warmup {started.get('warmup_seconds', float('nan')):.1f} s "
              f"of which graph capture "
              f"{started.get('graph_capture_seconds', float('nan')):.1f} s);"
              f" paged {info['paged']}, kv_block {info['kv_block']}, "
              f"pipeline depth {info.get('pipeline_depth', 1)}, cuda graphs "
              f"{graphs}; {args.n_layers} layers, "
              f"{engine.n_params / 1e9:.2f} B parameters, "
              f"{gib(torch.cuda.memory_allocated()):.1f} GiB allocated, "
              f"graph pool {graph_pool_gib():.2f} GiB", flush=True)
        vocab = args.vocab_size
        rng = np.random.RandomState(1)
        lens = [16, 100, 300, 513, 777, 1000]
        news = [32, 40, 48, 56, 64, 64]
        bodies = []
        for i, (n, m) in enumerate(zip(lens, news)):
            body = {"tokens": rng.randint(0, vocab, size=n).tolist(),
                    "max_new_tokens": m, "logprobs": True}
            if i == 2:
                body.update(temperature=0.8, seed=1234)
            bodies.append(body)
        if echo:
            erng = np.random.RandomState(2)
            for repeats in ECHO_REPEATS:
                span = erng.randint(0, vocab, ECHO_SPAN).tolist()
                bodies.append({"tokens": span * repeats,
                               "max_new_tokens": 64, "logprobs": True})
        spec = info.get("spec_decode", 0)
        draft_layers = args.draft_n_layers if info.get(
            "spec_draft_model") else 0
        pa.reset_counters()
        if wq is not None:
            wq.reset_counters()
        t0 = time.monotonic()
        with ThreadPoolExecutor(len(bodies)) as pool:
            replies = list(pool.map(lambda b: post(server.port, b), bodies))
        wall = time.monotonic() - t0
        counts = pa.counters()
        if wq is not None:
            counts.update(wq.counters())
        for body, (status, reply) in zip(bodies, replies):
            check(status == 200, f"status {status}")
            toks = reply["tokens"]
            check(len(toks) == body["max_new_tokens"],
                  f"reply length {len(toks)} != {body['max_new_tokens']}")
            check(all(0 <= t < vocab for t in toks), "token out of range")
        stats = get(server.port, "/v1/stats")
        for _ in range(100):
            if stats["active_slots"] == 0 and stats["queued"] == 0:
                break
            time.sleep(0.05)
            stats = get(server.port, "/v1/stats")
        check(stats["active_slots"] == 0 and stats["queued"] == 0,
              f"engine did not drain: {stats}")
        passes = stats["prefill_dispatches"] + stats["decode_passes"]
        # A draft model's forwards: its prefill dispatches and t = 1
        # passes, each through its own layers.
        dprefill = stats.get("draft_prefill_dispatches", 0)
        dpasses = stats.get("draft_passes", 0)
        print(f"serve {tag}: {len(bodies)} concurrent requests in "
              f"{wall:.2f} s; kernel counts {counts} over "
              f"{stats['prefill_dispatches']} admission dispatches and "
              f"{stats['decode_passes']} decode passes dispatched, of "
              f"{args.n_layers} layers"
              + (f", and {dprefill} draft prefill dispatches and {dpasses} "
                 f"draft passes of {draft_layers}" if draft_layers else ""),
              flush=True)
        check(counts["paged_flash_decode"] > 0, "K1 never launched")
        check(counts["paged_kv_store"] > 0, "K2 never launched")
        check(counts["paged_flash_decode_plain"] == 0
              and counts["paged_kv_store_plain"] == 0,
              "a plain version ran on the serving path")
        if mode:
            quant_check(counts, stats, args.n_layers, mode, f"serve {tag}")
        # Every layer of every forward pass went through both kernels.
        launches = args.n_layers * passes + draft_layers * (dprefill
                                                            + dpasses)
        check(counts["paged_flash_decode"] == launches
              and counts["paged_kv_store"] == launches,
              f"launches {counts} != {args.n_layers} x {passes} passes"
              + (f" + {draft_layers} x {dprefill + dpasses} draft passes"
                 if draft_layers else ""))
        if hasattr(pa, "ROUTE_ROWS"):  # a parent checkout has one route
            # Admissions took K1's tensor-core route and decode passes its
            # 8-row route, each layer once; K2 ran at t = 1 on decode
            # passes.  A speculative engine's verify passes (t = spec + 1
            # rows a slot) take the tensor-core route too, as does a draft
            # model's prefill; its t = 1 draft passes the 8-row route.
            routes = {route: counts[f"paged_flash_decode_{route}"]
                      for route in pa.ROUTE_ROWS}
            verify = stats["decode_passes"] if spec else 0
            want = {"tc": (stats["prefill_dispatches"] + verify)
                    * args.n_layers + dprefill * draft_layers,
                    "rows8": (stats["decode_passes"] - verify)
                    * args.n_layers + dpasses * draft_layers,
                    "rows16": 0}
            check(routes == want, f"K1 launches by route {routes} != {want}")
            check(counts["paged_kv_store_t1"] == want["rows8"],
                  f"K2 at t=1 launched {counts['paged_kv_store_t1']} times, "
                  f"not {want['rows8']}")
            print(f"serve {tag}: K1's tensor-core route (admission prefill, "
                  f"64-row tiles) launched {routes['tc']} times "
                  f"({stats['prefill_dispatches']} admission dispatches"
                  + (f" + {verify} verify passes at t={spec + 1}"
                     if spec else "")
                  + f" x {args.n_layers} layers"
                  + (f"; + {dprefill} draft prefills x {draft_layers}"
                     if draft_layers else "")
                  + f"), its decode route {routes['rows8']} ("
                  + (f"{dpasses} draft passes x {draft_layers}"
                     if spec else f"{stats['decode_passes']} passes")
                  + f"), its f32 route 0; K2 at t=1 "
                  f"{counts['paged_kv_store_t1']}", flush=True)
        if "decode_dispatches" in stats:
            # A chunk dispatched and dropped unread (the pipeline's tail)
            # still ran: its passes are in decode_passes above.
            print(f"serve {tag}: {stats['decode_dispatches']} decode chunks "
                  f"dispatched, {stats['readbacks']} read back "
                  f"({stats['decode_dispatches'] - stats['readbacks']} "
                  f"dropped unread at a tail), {stats['graph_replays']} as "
                  f"graph replays; {stats['tail_elisions']} tail elisions; "
                  f"overlap ratio {stats['overlap_ratio']:.3f}", flush=True)
        if graphs:
            check(stats["graph_replays"] == stats["decode_dispatches"] > 0,
                  f"{stats['decode_dispatches']} decode dispatches but "
                  f"{stats['graph_replays']} graph replays")
        if graphs and "admission_replays" in stats:
            check_admission_graphs(stats, started, len(bodies), f"serve {tag}")
        if graphs and draft_layers:
            check(stats["draft_admission_replays"]
                  == stats["draft_prefill_dispatches"] > 0
                  and stats["draft_admission_graphs"]
                  == started["draft_admission_graphs"] > 0,
                  f"serve {tag}: {stats['draft_prefill_dispatches']} draft "
                  f"prefill dispatches, {stats['draft_admission_replays']} "
                  f"replays; {started['draft_admission_graphs']} draft "
                  f"graphs at warmup, {stats['draft_admission_graphs']} now")
            print(f"serve {tag}: {stats['draft_prefill_dispatches']} draft "
                  f"prefill dispatches, all graph replays (keyed by the "
                  f"full prompt's bucket); {stats['draft_admission_graphs']} "
                  f"draft prefill graphs, all captured at warmup", flush=True)
        if spec:
            check(stats["spec_drafted"] > 0, f"serve {tag}: nothing drafted")
            share = stats["spec_accepted"] / stats["spec_drafted"]
            rate = stats["decode_tokens"] / max(stats["decode_seconds"],
                                                1e-9)
            beside = ("" if plain_rate is None else
                      f" against {plain_rate:.1f} for the plain engine on "
                      f"the same traffic in this run ({rate / plain_rate:.2f}"
                      f"x)")
            print(f"serve {tag}: {stats['spec_accepted']} of "
                  f"{stats['spec_drafted']} greedy drafts accepted "
                  f"({share:.3f}); {stats['decode_tokens']} tokens from "
                  f"{stats['decode_passes']} verify passes "
                  f"({stats['decode_tokens'] / max(stats['decode_passes'], 1):.2f}"
                  f" a pass over {len(bodies)} requests); decode "
                  f"{rate:.1f} tok/s{beside} [{SMI}]", flush=True)
            counts["spec"] = {"drafted": stats["spec_drafted"],
                              "accepted": stats["spec_accepted"],
                              "share": share, "decode_tok_s": rate,
                              "plain_tok_s": plain_rate}
        counts["passes"] = {k: stats.get(k, 0) for k in (
            "prefill_dispatches", "decode_passes", "draft_prefill_dispatches",
            "draft_passes")}
        if beam_embed:
            counts["beam_embed"] = beam_embed_check(server, vocab, rng, tag)
        counts["admission_waves"] = trace.wave_lines(f"serve {tag}")
        # Time to first token of a lone 512-token prompt (client wall,
        # HTTP included), and the engine's decode rate.
        t0 = time.monotonic()
        post(server.port, {"tokens": rng.randint(0, vocab, 512).tolist(),
                           "max_new_tokens": 1})
        ttft = time.monotonic() - t0
        dec_rate = stats["decode_tokens"] / max(stats["decode_seconds"], 1e-9)
        print(f"serve {tag}: lone 512-token TTFT {ttft * 1e3:.1f} ms; "
              f"concurrent TTFT p50 {stats['ttft_p50_s'] * 1e3:.1f} ms; "
              f"decode {dec_rate:.1f} tok/s over {stats['decode_tokens']} "
              f"tokens in {stats['decode_seconds']:.3f} s; prefill "
              f"{stats['prefill_seconds']:.3f} s [{SMI}]", flush=True)
        serving_peak = torch.cuda.max_memory_allocated()
        serving_free = free_at_peak()
        peak_reserved = torch.cuda.max_memory_reserved()
        counts["ttft_ms"] = {"lone_512": ttft * 1e3,
                             "concurrent_p50": stats["ttft_p50_s"] * 1e3}
        counts["decode_tok_s"] = dec_rate
        counts["warmup_s"] = stats.get("warmup_seconds")
        counts["capture_s"] = stats.get("graph_capture_seconds")
        counts["admission_capture_s"] = stats.get(
            "admission_capture_seconds")
        counts["graph_pool_gib"] = graph_pool_gib()
    finally:
        trace.remove()
        if routing is not None:
            routing.remove(engine)
            restore_routers(engine.params["layers"], planted)
        if kv is not None:
            kv.remove(engine)
        server.stop()
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"serve {tag}: serving peak {gib(serving_peak):.1f} GiB allocated "
          f"({gib(peak_reserved):.2f} GiB held by the allocator) of "
          f"{gib(total):.1f} GiB; {serving_free:.1f} GiB of the card free "
          f"at the peak (weights, cache, admission transients, graph pool) "
          f"[{SMI}]", flush=True)
    checked = [(body, reply) for i, (body, (_, reply)) in
               enumerate(zip(bodies, replies)) if i != 2]  # greedy ones
    counts["routing_differences"] = teacher_check(engine, checked, tag,
                                                  routing, kv)
    if spec:
        depth_check(engine, [b for b, _ in checked], tag)
    del kv
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if graphs:
        counts["decode_profile"] = graph_check(engine, vocab, rng, tag)
        print(f"serve {tag}: the graph check's peak "
              f"{gib(torch.cuda.max_memory_allocated()):.1f} GiB allocated, "
              f"{free_at_peak():.1f} GiB free", flush=True)
    if min_free_gib is not None:
        check(serving_free >= min_free_gib,
              f"{serving_free:.1f} GiB free at the serving peak, under "
              f"{min_free_gib} GiB")
    counts["peak_gib"] = gib(serving_peak)
    counts["free_at_peak_gib"] = serving_free
    held = torch.cuda.memory_allocated()
    del engine, server, trace
    release()
    print(f"serve {tag}: {gib(held):.1f} GiB allocated with the server "
          f"stopped, {gib(torch.cuda.memory_allocated()):.2f} GiB once it "
          f"and its engine are dropped", flush=True)
    check(torch.cuda.memory_allocated() - base < 2**30,
          "a stopped server kept its engine's memory")
    return counts


def self_draft_phase() -> dict:
    """Engines whose draft model is the target itself, at Qwen2.5-1.5B's
    full width (``SERVE_ARGS``' weights), one for each ``SELF_DRAFT``
    (kv_block, spec): four greedy prompts that do not echo, 48 new tokens
    each.  Greedy drafts of the same model must be accepted above
    ``SELF_ACCEPT`` (the two routes' bf16 rounding may differ only at
    near ties); every verify pass's K1 took the tensor-core route (t =
    spec + 1 rows a slot at group 6) and every draft forward the 8-row
    route, each through every layer, with no plain call.  The engines
    dispatch eagerly (``cuda_graphs=False``: the same kernels; the serve
    phases hold the graphs), which spares three captures of chunks of
    (spec + 2) × 28 layer passes a sub-step.  Counts are reset before and
    read after each engine's requests.  Returns per engine its counts,
    passes and acceptance."""
    from oim_tpu_torch.cli import serve_main
    from oim_tpu_torch.ops import paged_attention as pa
    from oim_tpu_torch.serve.engine import Engine, GenRequest

    args = serve_main.build_parser().parse_args(
        at_depth(SERVE_ARGS, SIDE_LAYERS))
    cfg = serve_main.model_config(args)
    params = serve_main.load_weights(args, cfg, DEV)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, args.vocab_size, n).tolist()
               for n in (50, 100, 200, 250)]
    out = {}
    for kv_block, spec in SELF_DRAFT:
        tag = f"self-draft kv_block={kv_block} spec={spec}"
        t0 = time.monotonic()
        engine = Engine(params, cfg, n_slots=4, max_len=1024, chunk=4,
                        prompt_buckets=(64, 256), kv_block=kv_block,
                        spec_decode=spec, draft_params=params,
                        draft_cfg=cfg, cuda_graphs=False).warmup()
        started = time.monotonic() - t0
        pa.reset_counters()
        rids = [engine.submit(GenRequest(tokens=p, max_new_tokens=48))
                for p in prompts]
        engine.run()
        counts = pa.counters()
        st = engine.stats()
        for rid in rids:
            check(len(engine.result(rid)) == 48, f"{tag}: short reply")
        share = st["spec_accepted"] / max(st["spec_drafted"], 1)
        layers = cfg.n_layers
        verify = st["prefill_dispatches"] + st["decode_passes"]
        want = {"tc": layers * (verify + st["draft_prefill_dispatches"]),
                "rows8": layers * st["draft_passes"], "rows16": 0}
        routes = {r: counts[f"paged_flash_decode_{r}"] for r in want}
        print(f"{tag}: warmup {started:.1f} s; {st['spec_accepted']} of "
              f"{st['spec_drafted']} greedy drafts accepted ({share:.3f}, "
              f"bar {SELF_ACCEPT}); {st['decode_passes']} verify passes at "
              f"t={spec + 1}, {st['draft_passes']} draft passes; K1 by route "
              f"{routes}, K2 at t=1 {counts['paged_kv_store_t1']} [{SMI}]",
              flush=True)
        check(st["spec_drafted"] > 0 and share > SELF_ACCEPT,
              f"{tag}: acceptance {share:.3f} not above {SELF_ACCEPT}")
        check(routes == want and counts["paged_kv_store_t1"]
              == want["rows8"] and counts["paged_flash_decode_plain"] == 0
              and counts["paged_kv_store_plain"] == 0,
              f"{tag}: K1 by route {routes} != {want}, or a plain call")
        out[f"{kv_block}_{spec}"] = {
            "share": share, "decode_passes": st["decode_passes"],
            "draft_passes": st["draft_passes"], "routes": routes}
        del engine
        release()
    del params
    release()
    return out


def draft_serve_phase(plain_rate: float | None) -> dict:
    """``serve_main --spec-decode 4 --draft-params-dir D`` with the draft
    geometry ``DRAFT_FLAGS`` on ``SERVE_ARGS``: D holds random weights
    from ``DRAFT_SEED`` written by the port's exporter
    (``Checkpointer.export_params``) into a scratch directory of the
    checkout, deleted afterwards; then ``serve_phase``'s gates."""
    from types import SimpleNamespace

    from oim_tpu_torch.checkpoint import Checkpointer, CheckpointerOptions
    from oim_tpu_torch.cli import serve_main
    from oim_tpu_torch.models.transformer import init_params

    work = tempfile.mkdtemp(prefix=".smoke-ckpt-draft-", dir=HERE)
    try:
        export = os.path.join(work, "draft")
        argv = SPEC_ARGS + ["--draft-params-dir", export, *DRAFT_FLAGS]
        dcfg = serve_main.draft_config(
            serve_main.build_parser().parse_args(argv))
        t0 = time.monotonic()
        params = init_params(DRAFT_SEED, dcfg, device=DEV, master=True)
        Checkpointer(os.path.join(work, "ckpt"),
                     CheckpointerOptions()).export_params(
            SimpleNamespace(params=params), export)
        del params
        release()
        print(f"serve draft: the draft model's random weights exported in "
              f"{time.monotonic() - t0:.1f} s", flush=True)
        return serve_phase(argv, "draft", echo=True, plain_rate=plain_rate)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def spec_phases(plain_rate: float | None) -> dict:
    """This slice's serving paths: prompt lookup (``SPEC_ARGS``, with
    ``/v1/beam`` and ``/v1/embed`` on its server), the self-draft engines
    and the draft model, each beside ``plain_rate``."""
    return {"lookup": serve_phase(SPEC_ARGS, "spec", echo=True,
                                  beam_embed=True, plain_rate=plain_rate),
            "self": self_draft_phase(),
            "draft": draft_serve_phase(plain_rate)}


def quant_module():
    """The port's ``ops.wquant`` module, or None in a package from before
    weight quantization (a parent checkout timed beside this one)."""
    try:
        from oim_tpu_torch.ops import wquant
    except ImportError:
        return None
    return wquant


def quant_check(counts: dict, stats: dict, n_layers: int, mode: str,
                tag: str) -> None:
    """A weight-quantized serve phase's launches: no plain product ran,
    and every decode pass ran each layer's seven products and the
    unembedding through the fused kernel (admissions add theirs on
    either route)."""
    per_pass = 7 * n_layers + 1
    shapes = {k: n for k, n in counts.items()
              if k.startswith("quant_matmul[") and n}
    print(f"{tag}: quant_matmul ({mode} weights) launched "
          f"{counts['quant_matmul']} times, {counts['quant_matmul_gemv']} on "
          f"the fused route and {counts['quant_matmul_dequant']} on the "
          f"dequantize-then-matmul route, by shape {shapes}; "
          f"{stats['decode_passes']} decode passes x {per_pass} products",
          flush=True)
    check(counts["quant_matmul_plain"] == 0,
          f"{tag}: a plain quant_matmul ran on the serving path")
    check(counts["quant_matmul_gemv"] >= stats["decode_passes"] * per_pass
          > 0, f"{tag}: {counts['quant_matmul_gemv']} fused launches for "
          f"{stats['decode_passes']} decode passes of {per_pass} products")


def check_admission_graphs(stats: dict, before: dict, requests: int,
                           tag: str) -> None:
    """On an engine that replays graphs: every admission dispatch since
    ``before`` (stats taken after warmup) — each first-token group
    dispatch and each non-final segment of ``requests`` requests — was
    one replay, and no graph was captured after warmup."""
    delta = {k: stats[k] - before[k] for k in (
        "admission_replays", "prefill_dispatches", "prefill_segments")}
    non_final = delta["prefill_segments"] - requests
    check(delta["admission_replays"] == delta["prefill_dispatches"]
          + non_final > 0,
          f"{tag}: {delta['admission_replays']} admission replays, not "
          f"{delta['prefill_dispatches']} group dispatches + {non_final} "
          f"segments")
    check(stats["admission_graphs"] == before["admission_graphs"] > 0
          and stats["graph_capture_seconds"]
          == before["graph_capture_seconds"],
          f"{tag}: graphs captured after warmup ({before['admission_graphs']}"
          f" admission graphs then, {stats['admission_graphs']} now)")
    print(f"{tag}: {delta['admission_replays']} admission dispatches, all "
          f"graph replays ({delta['prefill_dispatches']} first-token groups "
          f"+ {non_final} segments); {stats['admission_graphs']} admission "
          f"graphs, all captured at warmup in "
          f"{stats['admission_capture_seconds']:.1f} s", flush=True)


def admit_check(engine, tag: str, what: str, seated: int,
                pending: int) -> None:
    """The engine's next admission wave (``what``), run eagerly and by
    graph replays from one state (``Engine.admit_twice``): first tokens
    and logprobs, the prompts left mid-prefill, the cache and the
    penalty counts bit-equal, with ``seated`` requests seated and
    ``pending`` mid-prefill."""
    eager, replayed = engine.admit_twice()
    same = {"first tokens and logprobs": eager["first"] == replayed["first"],
            "mid-prefill": eager["pending"] == replayed["pending"],
            "cache and counts": all(torch.equal(a, b) for a, b in zip(
                eager["state"], replayed["state"]))}
    print(f"{tag}: one admission wave ({what}) eager vs graph replays from "
          f"one state: {len(replayed['first'])} seated, "
          f"{len(replayed['pending'])} mid-prefill; bit-equal: {same}",
          flush=True)
    check(all(same.values()), f"{tag}: admission replay differs from eager: "
          f"{same}")
    check(len(replayed["first"]) == seated
          and len(replayed["pending"]) == pending,
          f"{tag}: the wave seated {len(replayed['first'])} and left "
          f"{len(replayed['pending'])} mid-prefill, not {seated} and "
          f"{pending}")


def teacher_check(engine, checked, tag: str, routing=None,
                  kv=None) -> list:
    """Each greedy reply of ``checked`` (body, reply), as served,
    teacher-forced through an f32 forward over the served weights
    (widened one layer at a time): every emitted token within δ of its
    position's max logit, logprobs within ``LOGPROB_ATOL``.  An MoE
    model's routing is discontinuous — a near tie that rounds the other
    way in bf16 changes a token's experts, and that token's logits by
    O(0.1-1) — so the f32 forward is also teacher-forced the served
    path's own expert choices (``routing``, a ``ServedRouting``: the
    admissions' and the graph-replayed decode passes'), which must be the
    f32 router's own or a near tie's (at most ``ROUTE_TIE`` of router
    probability from its top-k).  The f32 forward routing freely is
    reported beside.  Quantized weights enter the f32 forward as the
    served product reads them (``widened``).  With int4 KV (``kv``, a
    ``ServedKV``) the f32 forward attends over the served pool's own K/V
    rows, each first held within one int4 step of the forward's own
    quantization of it (``served_kv``): an int4 step is 1/7 of a row's
    max, so bf16 noise that moves a value across a rounding edge moves
    the logits by more than δ allows on its own.  Returns [pairs whose
    choices differ from the f32 router's, (layer, position) pairs]."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params32, cfg32 = widened(engine.params, engine.cfg)
    n_delta = n_pos = n_flips = n_choices = n_free = 0
    worst_lp = worst_lost = worst_gap = free_gap = 0.0
    seen = {"max_step": 0, "moved": 0, "values": 0}
    for body, reply in checked:
        prompt, forced = body["tokens"], None
        gen_toks, lps = reply["tokens"], reply["logprobs"]
        served = None if kv is None else kv.kv[tuple(prompt)]

        def rows():
            return (contextlib.nullcontext() if served is None
                    else served_kv(served, seen))

        if routing is not None:
            forced = routing.choices(prompt, len(gen_toks))
            with rows():
                free = emitted_gap(params32, cfg32, prompt, gen_toks)[0]
            n_free += int((free > DELTA).sum())
            free_gap = max(free_gap, float(free.max()))
        with rows():
            gap, lp_ref, tap = emitted_gap(params32, cfg32, prompt,
                                           gen_toks, forced)
        n_flips += tap.differing()
        n_choices += sum(c.shape[0] for c in tap.choices)
        worst_lost = max(worst_lost, tap.most_lost())
        worst_gap = max(worst_gap, float(gap.max()))
        n_delta += int((gap > 0).sum())
        n_pos += len(gen_toks)
        worst_lp = max(worst_lp, float(np.abs(lp_ref - np.asarray(lps)).max()))
    routed = ""
    if routing is not None:
        routed = (f"; the served path's own expert choices (its admissions' "
                  f"and {routing.decode_passes()} graph-replayed decode "
                  f"passes', recorded as it served) teacher-forced: they "
                  f"differ from the f32 router's own in {n_flips} of "
                  f"{n_choices} (layer, position) pairs, giving up at most "
                  f"{worst_lost:.4f} of router probability (tol "
                  f"{ROUTE_TIE}); routing freely, the f32 forward puts "
                  f"{n_free} emitted tokens over δ (the largest "
                  f"{free_gap:.3f} below its max)")
    print(f"serve {tag}: teacher-forced f32 check of {len(checked)} replies "
          f"as served, {n_pos} positions (the f32 forward widening one "
          f"layer at a time): {n_delta} needed δ={DELTA} (rest exact "
          f"argmax), the largest {worst_gap:.3f}; max |logprob - ref| "
          f"{worst_lp:.4f} (tol {LOGPROB_ATOL}){routed}; its peak "
          f"{gib(torch.cuda.max_memory_allocated()):.1f} GiB allocated",
          flush=True)
    check(worst_gap <= DELTA,
          f"an emitted token's reference logit is {worst_gap:.3f} below "
          f"the max (δ {DELTA}); expert choices differing {n_flips} of "
          f"{n_choices}, most router probability given up {worst_lost:.4f}")
    check(worst_lp <= LOGPROB_ATOL,
          f"engine logprobs off the f32 reference by {worst_lp:.3f}")
    check(worst_lost <= ROUTE_TIE,
          f"the served path routes {worst_lost:.4f} of router probability "
          f"away from the f32 top-k: not a near tie")
    if kv is not None:
        print(f"serve {tag}: the served int4 K/V the f32 forward attended "
              f"over: {seen['moved']} of {seen['values']} values one step "
              f"from its own quantization of them (bf16 noise across a "
              f"rounding edge), none further: max {seen['max_step']} "
              f"step(s)", flush=True)
        check(seen["values"] > 0 and seen["max_step"] <= 1,
              f"serve {tag}: a served int4 K/V value lies "
              f"{seen['max_step']} steps from the f32 forward's own")
    return [n_flips, n_choices]


def class_times(engine, bucket: int, runs: int = 2) -> dict:
    """Device time of one replay of each admission graph at ``bucket``,
    by row class, on inert rows (the sentinel table: every product runs,
    attention reads and writes nothing, so a row's time here is a lower
    bound of a real one's): what a padding row costs.  CUDA events
    around ``runs`` replays each, on an idle engine."""
    times = {}
    for rows in engine._admit_classes[bucket]:
        engine._adm.stage(*engine._admission_inputs(bucket, rows, []))
        graph, _ = engine._admit_graphs[bucket, rows]
        graph.replay()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(runs):
            graph.replay()
        end.record()
        end.synchronize()
        times[rows] = start.elapsed_time(end) / runs
    print(f"serve graph check: one admission replay at bucket {bucket}, by "
          f"row class (inert rows): "
          + ", ".join(f"{rows} rows {ms:.2f} ms" for rows, ms in times.items())
          + f" [{SMI}]", flush=True)
    return times


def graph_check(engine, vocab: int, rng, tag: str = "") -> dict:
    """Every slot seated (greedy, sampled with top-p and penalised rows —
    on a speculative engine, which refuses penalties, sampled at another
    temperature instead — prompts 16 to 1500 tokens) by one admission
    wave run eagerly and by graph replays from one state
    (``admit_check``), then one decode chunk of them, from copies of one
    cache state, run eagerly and by its CUDA graph's replay: the same
    kernels on the same inputs, so tokens, logprobs, the token carry,
    the cache and the penalty counts (a speculative chunk's ``n_emit``,
    lengths carry, history or draft cache too) must be bit-equal.  Then
    ``decode_profile`` of that chunk (``spec_profile`` on a speculative
    engine), whose record it returns."""
    from oim_tpu_torch.serve.engine import GenRequest

    spec = getattr(engine, "spec_decode", 0)
    if hasattr(engine, "admit_twice") and not spec:
        # A parent package has no admission graphs; a speculative
        # engine's are the default phase's.
        class_times(engine, 1024)
    engine.set_pipeline_depth(1)
    lens = [16, 100, 300, 513, 777, 1000, 40, 1500]
    for i, n in enumerate(lens[: engine.n_slots]):
        kw = {}
        if i % 3 == 1:
            kw = dict(temperature=0.8, seed=100 + i, top_p=0.9)
        elif i % 3 == 2:
            kw = (dict(temperature=1.1, seed=100 + i) if spec
                  else dict(repetition_penalty=1.2))
        engine.submit(GenRequest(tokens=rng.randint(0, vocab, n).tolist(),
                                 max_new_tokens=64, **kw))
    n = min(len(lens), engine.n_slots)
    if hasattr(engine, "admit_twice"):  # a parent package has none
        admit_check(engine, "serve graph check",
                    f"{n} prompts of {lens[0]} to {max(lens[:n])} tokens, "
                    f"greedy, sampled and "
                    f"{'sampled hotter' if spec else 'penalised'}", n, 0)
    engine.step()  # (admit every slot and) decode one chunk
    eager, replayed = engine.chunk_twice()
    names = ("out", "lps", "carry") + (("n_emit", "lengths") if spec else ())
    same = {name: torch.equal(eager[name], replayed[name]) for name in names}
    same["cache and counts"] = all(
        torch.equal(a, b) for a, b in zip(eager["state"], replayed["state"]))
    print(f"serve graph check: one {'speculative ' if spec else ''}decode "
          f"chunk of {engine.n_slots} slots from copies of one state, eager "
          f"vs graph replay bit-equal: {same}", flush=True)
    check(all(same.values()), f"graph replay differs from eager: {same}")
    profile = (spec_profile(engine, tag) if spec
               else decode_profile(engine, tag))
    engine.abort("graph check done")
    return profile


def replay_ms(graph, replays: int = 3) -> float:
    """Device time of one replay of ``graph``: CUDA events around
    ``replays`` replays after one more (a replay's kernels run back to
    back, so the events time the device)."""
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / replays


def graphed_ms(fn, replays: int = 10) -> float:
    """Device time of ``fn`` (many kernels, which an eager run would
    launch slower than the device runs them): run once on a side stream,
    captured as a CUDA graph, then ``replay_ms``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return replay_ms(graph, replays)


def spec_profile(engine, tag: str, replays: int = 3) -> dict:
    """A speculative decode chunk of the seated slots (its greedy graph
    replayed ``replays`` times: CUDA events) and its split by part, each
    part on the chunk's own inputs captured as a graph of its own and
    timed by its replays (``graphed_ms``): the drafting (prompt lookup
    over the history, or the draft model's spec + 1 forwards), the
    verify forward (the target's (L+1)-row pass and its unembedding) and
    the acceptance and sampling (``_accept``), each once a sub-step (a
    sub-step also writes the history and the carries).  The replays
    rewrite rows past each slot's length only (dead rows)."""
    from oim_tpu_torch.serve import engine as em

    chunk_ms = replay_ms(engine._graphs[(False, False)], replays)
    b = engine._buf
    tokens, lengths, live = b.tokens, b.meta[0], b.meta[1]
    if engine._draft_cache is not None:
        dtables = torch.where(live[:, None] > 0, engine._draft_identity,
                              engine._draft_sentinel)
        draft = (engine.draft_params, engine.draft_cfg, engine._draft_cache,
                 dtables)

        def drafting():
            return em._model_drafts(draft, tokens, lengths,
                                    engine.spec_decode)
    else:
        def drafting():
            return em._draft_lookup(engine._history, lengths,
                                    engine.spec_decode, engine.spec_ngram,
                                    engine.max_len)
    with torch.no_grad():
        drafts = drafting()
        s = em._Sampling(b.cols, False, False)

        def verify():
            return em._verify_logits(engine.params, engine._cache, b.tables,
                                     lengths, tokens, drafts, engine.cfg)

        logits = verify()

        def accept():
            return em._accept(logits, lengths, tokens, drafts, live, s, None,
                              top_k=engine.top_k, max_len=engine.max_len)

        parts = {"drafting": graphed_ms(drafting),
                 "verify": graphed_ms(verify), "accept": graphed_ms(accept)}
    step_ms = chunk_ms / engine.chunk
    total = sum(parts.values())
    print(f"serve {tag}: one speculative decode chunk ({engine.n_slots} slots "
          f"x {engine.chunk} sub-steps at spec {engine.spec_decode}, graph "
          f"replay) {chunk_ms:.2f} ms of device time, {step_ms:.3f} ms a "
          f"sub-step; parts replayed alone, a sub-step: drafting "
          f"({'draft model' if engine.draft_cfg else 'prompt lookup'}) "
          f"{parts['drafting']:.3f} ms ({parts['drafting'] / total:.1%}), "
          f"verify forward {parts['verify']:.3f} "
          f"({parts['verify'] / total:.1%}), acceptance and sampling "
          f"{parts['accept']:.3f} ({parts['accept'] / total:.1%}); their sum "
          f"{total:.3f} against the replayed sub-step's {step_ms:.3f} (alone, "
          f"each part starts with a cold L2) [{SMI}]", flush=True)
    return {"chunk_ms": chunk_ms, "sub_step_ms": step_ms, "parts_ms": parts}


def depth_check(engine, bodies, tag: str) -> None:
    """``bodies`` (greedy) served again on the stopped server's engine,
    submitted together (one admission pattern), at pipeline depth 2 and
    then 1: the same tokens.  The engine is left at depth 2."""
    from oim_tpu_torch.serve.engine import GenRequest

    runs = []
    for depth in (2, 1):
        engine.set_pipeline_depth(depth)
        rids = [engine.submit(GenRequest(tokens=b["tokens"],
                                         max_new_tokens=b["max_new_tokens"]))
                for b in bodies]
        engine.run()
        runs.append([engine.result(rid) for rid in rids])
    engine.set_pipeline_depth(2)
    same = runs[0] == runs[1]
    print(f"serve {tag}: {len(bodies)} greedy requests served again at "
          f"pipeline depth 2 and 1 ({sum(map(len, runs[0]))} tokens): "
          f"token-identical {same}", flush=True)
    check(same, f"serve {tag}: depth 1 and depth 2 tokens differ")


def beam_embed_check(server, vocab: int, rng, tag: str) -> dict:
    """``/v1/beam`` and ``/v1/embed`` on the running server (slot-free
    work on the plain solo path): beam 1 is the solo ``generate``'s
    greedy tokens on the served weights, beam 4's normalized score is no
    worse than beam 1's (``BEAM_TOL``: the batched forward's bf16
    rounding), and the embedding is ``d_model`` finite values of unit
    norm."""
    from oim_tpu_torch.models import decode as dec

    engine = server.engine
    prompt, new = rng.randint(0, vocab, 24).tolist(), 12
    beams = {}
    for k in (1, 4):
        status, reply = post(server.port, {"tokens": prompt,
                                           "max_new_tokens": new,
                                           "beam_size": k}, "/v1/beam")
        check(status == 200 and len(reply["tokens"]) == new,
              f"serve {tag}: /v1/beam at {k}: {status}")
        beams[k] = reply
    with torch.no_grad():
        solo = dec.generate(engine.params, torch.tensor([prompt], device=DEV),
                            engine.cfg, new)[0, len(prompt):].tolist()
    t0 = time.monotonic()
    status, reply = post(server.port, {"tokens": prompt}, "/v1/embed")
    embed_ms = (time.monotonic() - t0) * 1e3
    vec = np.asarray(reply["embedding"])
    norm = float(np.linalg.norm(vec))
    print(f"serve {tag}: /v1/beam beam 1 {'=' if beams[1]['tokens'] == solo else '!='}"
          f" the solo generate's greedy tokens; normalized score beam 4 "
          f"{beams[4]['score']:.4f} vs beam 1 {beams[1]['score']:.4f}; "
          f"/v1/embed {vec.size} values, norm {norm:.6f}, in "
          f"{embed_ms:.1f} ms", flush=True)
    check(beams[1]["tokens"] == solo,
          f"serve {tag}: beam 1 {beams[1]['tokens']} != generate {solo}")
    check(beams[4]["score"] >= beams[1]["score"] - BEAM_TOL,
          f"serve {tag}: beam 4 scores {beams[4]['score']} under beam 1's "
          f"{beams[1]['score']}")
    check(status == 200 and vec.size == engine.cfg.d_model
          and bool(np.isfinite(vec).all()) and abs(norm - 1.0) < 1e-4,
          f"serve {tag}: /v1/embed gave {vec.size} values of norm {norm}")
    return {"beam1": beams[1]["score"], "beam4": beams[4]["score"],
            "embed_norm": norm, "embed_ms": embed_ms}


def weight_bytes(params) -> int:
    """Bytes a decode pass reads of the matmul weights: every
    ``WEIGHT_QUANT_TARGETS`` entry (its payload and scales when
    quantized; the f32-widened unembedding when not)."""
    from oim_tpu_torch.ops.quant import WEIGHT_QUANT_TARGETS

    total = 0
    for tree in (params, *params["layers"]):
        for name, t in tree.items():
            base = name.removesuffix("_wscale")
            if base in WEIGHT_QUANT_TARGETS:
                total += t.numel() * t.element_size()
    return total


def decode_profile(engine, tag: str, replays: int = 3) -> dict:
    """One decode chunk of the seated slots, its greedy graph replayed
    ``replays`` times: its device time (CUDA events), its tokens a
    second at that time, and, from ``torch.profiler`` over the replays
    (``cli/serve_profile.py``'s families), the weight products' share
    — ``quant_matmul``'s kernels on quantized weights, cuBLAS's on bf16
    ones — and the rate at which they read the weights (``weight_bytes``
    once a pass).  The replays rewrite the chunk's own cache rows."""
    from oim_tpu_torch.cli.serve_profile import FAMILIES, profiled

    graph = engine._graphs[(False, False)]
    chunk_ms = replay_ms(graph, replays)
    window = profiled(graph.replay, replays, chunk_ms * replays, FAMILIES)
    family = ("quant_matmul" if getattr(engine, "weight_quant", "")
              else "gemm (cuBLAS)")
    prod_ms = (window["families_ms"] or {}).get(family, 0.0) / replays
    moved = weight_bytes(engine.params) * engine.chunk
    out = {"chunk_ms": chunk_ms,
           "tok_s": engine.n_slots * engine.chunk / chunk_ms * 1e3,
           "products_ms": prod_ms,
           "products_share": prod_ms / chunk_ms,
           "weights_tb_s": moved / (prod_ms * 1e-3) / 1e12 if prod_ms else
           None, "families_ms": {k: v / replays for k, v in
                                 (window["families_ms"] or {}).items()}}
    rate = ("not measured" if out["weights_tb_s"] is None
            else f"{out['weights_tb_s']:.2f} TB/s "
                 f"({out['weights_tb_s'] * 1e12 / HBM_BYTES_PER_S:.0%} of "
                 f"the HBM rate)")
    print(f"serve {tag}: one decode chunk ({engine.n_slots} slots x "
          f"{engine.chunk} passes, graph replay) {chunk_ms:.2f} ms of device "
          f"time, {out['tok_s']:.1f} tok/s at that time; the weight "
          f"products ({family}) {prod_ms:.2f} ms a chunk, "
          f"{out['products_share']:.1%} of it, reading "
          f"{moved / 2**30:.2f} GiB of weights a chunk at {rate}; by family "
          f"{ {k: round(v, 3) for k, v in out['families_ms'].items()} } "
          f"[{SMI}]", flush=True)
    return out


# The prefix phase's engine flags, added to SERVE_ARGS (and with
# --kv-block 16 for the paged pool), and its traffic: a 1008-token
# system prompt (63 blocks of 16: a paged entry keeps the blocks a
# prompt fully covers, so a block-aligned seed makes the repeated seed
# hit 1007 rows, inside the entry's last block: a copy-on-write), four
# prompts sharing it with tails of 24, 200, 400 and 700 tokens, the seed
# itself again, and an unrelated 1800-token prompt (a miss in 8
# segments) sent once the others are seated; 32 new tokens each.
PREFIX_FLAGS = ["--prefix-cache", "8", "--prefill-chunk", "256"]
PREFIX_SYSTEM = 1008
PREFIX_TAILS = (24, 200, 400, 700)
PREFIX_LONG = 1800
PREFIX_NEW = 32


def prefix_traffic(vocab: int) -> tuple[list, list, list]:
    """(seed prompt, the five prompts sharing it, the long prompt)."""
    rng = np.random.RandomState(5)
    system = rng.randint(0, vocab, PREFIX_SYSTEM).tolist()
    hits = [system + rng.randint(0, vocab, n).tolist() for n in PREFIX_TAILS]
    return system, hits + [list(system)], rng.randint(
        0, vocab, PREFIX_LONG).tolist()


def segments_wanted(start: int, n: int, chunk: int) -> int:
    """Prompt segments of an n-token prompt whose tail is written from
    ``start``: one for a one-shot tail, else one per ``chunk`` tokens of
    the tail (the final one padded to its bucket; no prompt here needs
    un-chunking at max_len 2048)."""
    tail = n - start
    return max(1, -(-tail // chunk)) if chunk else 1


class ServeTrace:
    """What an engine does while it serves, recorded from the step
    thread by wrapping five of its methods: the host time each decode
    chunk's results were read back with the prompt lengths of the live
    streams it carried, each decode dispatch's (graph replay?, how many
    prompts were mid-prefill), each request's first-token time after its
    submission, and each admission wave that dispatched anything: its
    host wall (to its first-token readback, when it has one), its
    dispatches' device time (CUDA events around each: a replay's kernels
    run back to back) and whether it read first tokens back."""

    def __init__(self, engine):
        self.engine = engine
        self.readbacks, self.dispatches, self.first = [], [], {}
        self.waves, self._spans = [], []
        process, enqueue, emit = (engine._process_chunk,
                                  engine._enqueue_chunk, engine._emit)
        admit_wave = engine._admit_wave
        dispatch_admission = getattr(engine, "_dispatch_admission", None)

        def processed(handle, acc):
            live = {(st.rid, len(st.req.tokens))
                    for slot, st in handle.snapshot.items()
                    if engine._slots.get(slot) is st}
            process(handle, acc)
            self.readbacks.append((time.monotonic(), live))

        def enqueued(inputs, tokens, starts, indices, graph):
            self.dispatches.append((graph, len(engine._prefilling)))
            return enqueue(inputs, tokens, starts, indices, graph)

        def emitted(state, token, logprob):
            if not state.emitted:
                now = time.monotonic()
                self.first[len(state.req.tokens)] = (state.t_submit, now)
            return emit(state, token, logprob)

        def waved():
            self._spans = spans = []
            groups = engine.prefill_dispatches
            t0 = time.monotonic()
            admit_wave()
            wall = time.monotonic() - t0
            if spans:
                self.waves.append((wall, spans,
                                   engine.prefill_dispatches > groups))

        def dispatched(bucket, rows, prompts, ints):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            dispatch_admission(bucket, rows, prompts, ints)
            end.record()
            self._spans.append((start, end))

        engine._process_chunk = processed
        engine._enqueue_chunk = enqueued
        engine._emit = emitted
        if dispatch_admission is not None:  # a parent package has none
            engine._admit_wave = waved
            engine._dispatch_admission = dispatched

    def remove(self) -> None:
        for name in ("_process_chunk", "_enqueue_chunk", "_emit",
                     "_admit_wave", "_dispatch_admission"):
            vars(self.engine).pop(name, None)

    def wave_lines(self, tag: str) -> list[dict]:
        """Print each admission wave's wall against its dispatches'
        device time; return them as dicts."""
        torch.cuda.synchronize()
        out = []
        for wall, spans, read in self.waves:
            device = sum(a.elapsed_time(b) for a, b in spans)
            out.append({"wall_ms": wall * 1e3, "device_ms": device,
                        "dispatches": len(spans), "readback": read})
        for w in out:
            print(f"{tag}: admission wave of {w['dispatches']} dispatches: "
                  f"wall {w['wall_ms']:.2f} ms "
                  f"({'to its first-token readback' if w['readback'] else 'segments only, no readback'}"
                  f"), its dispatches' device time {w['device_ms']:.2f} ms "
                  f"[{SMI}]", flush=True)
        return out

    def ttft_ms(self, n_tokens: int) -> float:
        t_submit, t_first = self.first[n_tokens]
        return (t_first - t_submit) * 1e3

    def largest_gap_ms(self, n_tokens: int) -> float:
        """The largest gap between two consecutive decode chunks of one
        live stream (two readbacks that both carried it) that overlaps
        the admission of the ``n_tokens`` prompt (from its submission to
        its first token); 0 when no stream decoded meanwhile."""
        t_submit, t_first = self.first[n_tokens]
        last, gaps = {}, [0.0]
        for t, live in self.readbacks:
            for rid, n in live:
                if n != n_tokens and rid in last and (
                        t_submit < t and last[rid] <= t_first):
                    gaps.append(t - last[rid])
                last[rid] = t
        return max(gaps) * 1e3


def entry_digest(engine) -> str:
    """Digest of the paged pool's blocks that the one prefix entry
    holds, K and V over every layer."""
    (blocks, _), = engine._prefix_cache.values()
    ids = list(blocks)
    return digest(torch.stack([engine._cache.k[:, ids],
                               engine._cache.v[:, ids]]))


def prefix_serve(argv, tag: str, cached: bool) -> dict:
    """Serve the prefix traffic through serve_main with ``argv``: the
    seed, then five prompts sharing it concurrently and, once they are
    all seated, the long prompt; then the first of the five again, alone.  Checks replies (200, the asked length),
    drain, K1's and K2's launches over the concurrent traffic (reset
    just before it, read just after): the tall route and K2 at t > 1
    ``layers × (admission dispatches + non-final segments)``, the decode
    route and K2 at t = 1 ``layers × decode passes``, no plain call; on
    a graph engine every decode dispatch a replay, and at least one of
    them while a prompt was mid-prefill.  With ``cached``: 5 hits,
    ``segments_wanted`` segments, and on the paged pool the entry's
    blocks bit-equal across the traffic and alone held after drain.
    Returns the replies, the trace's times and the counts; the engine
    under ``engine`` for the teacher check."""
    from oim_tpu_torch.cli import serve_main
    from oim_tpu_torch.ops import paged_attention as pa

    wq = quant_module()
    args = serve_main.build_parser().parse_args(argv)
    mode = (serve_main.weight_quant(args)
            if hasattr(serve_main, "weight_quant") else "")
    server = serve_main.start_server(args)
    engine = server.engine
    info = engine.info()["engine"]
    trace = ServeTrace(engine)
    try:
        system, shared, long = prefix_traffic(args.vocab_size)
        status, _ = post(server.port, {"tokens": system,
                                       "max_new_tokens": PREFIX_NEW,
                                       "cache_prefix": True})
        check(status == 200, f"prefix {tag}: seed status {status}")
        before = get(server.port, "/v1/stats")
        entry = entry_digest(engine) if cached and engine.paged else None
        pa.reset_counters()
        bodies = [{"tokens": p, "max_new_tokens": PREFIX_NEW,
                   "logprobs": True} for p in shared + [long]]
        first_rid = engine._next_rid
        with ThreadPoolExecutor(len(bodies)) as pool:
            futures = [pool.submit(post, server.port, b) for b in bodies[:-1]]
            for _ in range(10000):  # every shared prompt seated
                if (engine._next_rid >= first_rid + len(shared)
                        and not (engine._queue or engine._admitting)):
                    break
                time.sleep(0.001)
            futures.append(pool.submit(post, server.port, bodies[-1]))
            replies = [f.result() for f in futures]
        counts = pa.counters()
        stats = get(server.port, "/v1/stats")
        for _ in range(100):
            if stats["active_slots"] == 0 and stats["prefilling"] == 0:
                break
            time.sleep(0.05)
            stats = get(server.port, "/v1/stats")
        check(stats["active_slots"] == 0 and stats["queued"] == 0
              and stats["prefilling"] == 0,
              f"prefix {tag}: engine did not drain: {stats}")
        for body, (status, reply) in zip(bodies, replies):
            check(status == 200, f"prefix {tag}: status {status}")
            check(len(reply["tokens"]) == PREFIX_NEW,
                  f"prefix {tag}: reply length {len(reply['tokens'])}")
        delta = {k: stats[k] - before[k] for k in (
            "prefill_dispatches", "prefill_segments", "decode_passes",
            "decode_dispatches", "graph_replays", "prefix_hits",
            "prefix_misses")}
        chunk = info["prefill_chunk"]
        starts = [0] * len(bodies)
        if cached:
            starts = [PREFIX_SYSTEM] * len(PREFIX_TAILS) + [
                PREFIX_SYSTEM - 1, 0]
        want_segments = sum(segments_wanted(s, len(b["tokens"]), chunk)
                            for s, b in zip(starts, bodies))
        non_final = delta["prefill_segments"] - len(bodies)
        tall = args.n_layers * (delta["prefill_dispatches"] + non_final)
        steps = args.n_layers * delta["decode_passes"]
        print(f"prefix {tag}: {len(bodies)} requests after the seed; "
              f"{delta}; prefix entries {stats['prefix_entries']}, blocks "
              f"used {stats['kv_blocks_used']}, shared "
              f"{stats['kv_blocks_shared']}; kernel counts {counts}",
              flush=True)
        check(delta["prefill_segments"] == want_segments,
              f"prefix {tag}: {delta['prefill_segments']} segments, the "
              f"formula gives {want_segments}")
        check(counts["paged_flash_decode_tc"] == tall
              and counts["paged_kv_store"] - counts["paged_kv_store_t1"]
              == tall,
              f"prefix {tag}: tall-route/K2 t>1 launches {counts} != "
              f"{args.n_layers} x ({delta['prefill_dispatches']} admission "
              f"dispatches + {non_final} segments)")
        check(counts["paged_flash_decode_rows8"] == steps
              and counts["paged_kv_store_t1"] == steps
              and counts["paged_flash_decode_rows16"] == 0,
              f"prefix {tag}: decode launches {counts} != {steps}")
        check(counts["paged_flash_decode_plain"] == 0
              and counts["paged_kv_store_plain"] == 0,
              f"prefix {tag}: a plain version ran on the serving path")
        if info["cuda_graphs"]:
            while_pending = [g for g, n in trace.dispatches if n > 0]
            check(all(g for g, _ in trace.dispatches)
                  and delta["graph_replays"] == delta["decode_dispatches"],
                  f"prefix {tag}: a decode dispatch ran eagerly")
            check(len(while_pending) > 0 or not cached,
                  f"prefix {tag}: no decode dispatch while a prompt was "
                  f"mid-prefill")
            print(f"prefix {tag}: {len(trace.dispatches)} decode "
                  f"dispatches, all graph replays, {len(while_pending)} of "
                  f"them while a prompt was mid-prefill", flush=True)
            if "admission_replays" in stats:
                check_admission_graphs(stats, before, len(bodies),
                                       f"prefix {tag}")
        if cached:
            check(delta["prefix_hits"] == len(shared),
                  f"prefix {tag}: {delta['prefix_hits']} hits, not "
                  f"{len(shared)}")
        if entry is not None:
            after = entry_digest(engine)
            (blocks, _), = engine._prefix_cache.values()
            print(f"prefix {tag}: the seed entry's {len(blocks)} blocks, "
                  f"digest {entry} before the traffic, {after} after",
                  flush=True)
            check(after == entry, f"prefix {tag}: a shared block changed")
            check(stats["kv_blocks_used"] == len(set(blocks)),
                  f"prefix {tag}: {stats['kv_blocks_used']} blocks used "
                  f"after drain, the entry holds {len(set(blocks))}")
        out = {"replies": [r for _, r in replies], "bodies": bodies,
               "ttft_ms": trace.ttft_ms(len(shared[0])),
               "gap_ms": trace.largest_gap_ms(PREFIX_LONG),
               "waves": trace.wave_lines(f"prefix {tag}"),
               "counts": counts, "delta": delta, "engine": engine}
        # The first hit again, alone on the idle engine: its time to first
        # token (client wall, HTTP included) without the concurrent
        # traffic's arrival order in it.
        t0 = time.monotonic()
        post(server.port, {"tokens": shared[0], "max_new_tokens": 1})
        out["lone_ms"] = (time.monotonic() - t0) * 1e3
    finally:
        trace.remove()
        server.stop()
    return out


def prefix_admit_check(engine, layout: str) -> None:
    """On the cached run's engine, stopped: the seed again (a hit at
    ``PREFIX_SYSTEM - 1`` rows, inside the entry's last block: a
    copy-on-write on the paged pool) and a 600-token miss, whose wave
    writes its first segment, admitted eagerly and by graph replays from
    one state (``admit_check``)."""
    from oim_tpu_torch.serve.engine import GenRequest

    system, _, long = prefix_traffic(engine.cfg.vocab_size)
    engine.submit(GenRequest(tokens=list(system), max_new_tokens=8))
    engine.submit(GenRequest(tokens=long[:600], max_new_tokens=8))
    admit_check(engine, f"prefix {layout}", f"a {PREFIX_SYSTEM - 1}-row "
                f"prefix hit{', a copy-on-write' if engine.paged else ''} "
                f"and a 600-token miss's first segment", 1, 1)
    engine.abort("admission check done")


def prefix_phase() -> dict:
    """The prefix cache and chunked prefill at Qwen2.5-1.5B's widths, on
    serve_main's defaults (dense, depth 2, graphs) and with --kv-block 16
    (paged, depth 2, graphs): each layout serves the prefix traffic with
    ``PREFIX_FLAGS`` and again with neither flag (the control), prints
    the 24-token-tail hit's time to first token on both, the largest gap
    between decode chunks while the long prompt admits on both, and how
    many replies the two runs share token for token, and teacher-checks
    every reply the cached run served.  Returns the cached runs' K1/K2
    counts and those times by layout."""
    counts = {}
    for layout, extra in (("dense", []), ("paged", ["--kv-block", "16"])):
        side = at_depth(SERVE_ARGS, SIDE_LAYERS)
        cached = prefix_serve(side + extra + PREFIX_FLAGS,
                              f"{layout} cached", True)
        plain = prefix_serve(side + extra, f"{layout} control", False)
        same = sum(a["tokens"] == b["tokens"]
                   for a, b in zip(cached["replies"], plain["replies"]))
        print(f"prefix {layout}: hit TTFT (the {PREFIX_TAILS[0]}-token "
              f"tail) alone {cached['lone_ms']:.1f} ms cached vs "
              f"{plain['lone_ms']:.1f} ms with no prefix cache, in the "
              f"concurrent traffic {cached['ttft_ms']:.1f} vs "
              f"{plain['ttft_ms']:.1f} ms; largest gap "
              f"between decode chunks while the {PREFIX_LONG}-token prompt "
              f"admits {cached['gap_ms']:.1f} ms with "
              f"{' '.join(PREFIX_FLAGS[2:])}, {plain['gap_ms']:.1f} ms "
              f"without; {same} of "
              f"{len(plain['replies'])} replies token-identical to the "
              f"control run [{SMI}]", flush=True)
        plain.pop("engine")
        engine = cached.pop("engine")
        checked = list(zip(cached["bodies"], cached["replies"]))
        teacher_check(engine, checked, f"prefix {layout}")
        if engine.cuda_graphs and hasattr(engine, "admit_twice"):
            prefix_admit_check(engine, layout)
        del engine
        release()
        check(torch.cuda.memory_allocated() < 2**30,
              f"the prefix phase still holds "
              f"{gib(torch.cuda.memory_allocated()):.1f} GiB")
        counts[layout] = dict(cached["counts"], ttft_ms=cached["ttft_ms"],
                              control_ttft_ms=plain["ttft_ms"],
                              lone_ttft_ms=cached["lone_ms"],
                              control_lone_ttft_ms=plain["lone_ms"],
                              gap_ms=cached["gap_ms"],
                              control_gap_ms=plain["gap_ms"],
                              waves=cached["waves"],
                              control_waves=plain["waves"],
                              identical=same)
    return counts


# ---------------------------------------------------------------------------
# KV block I/O phase: the host tier, parking, and KV shipping

# Engines A and B: serve_main with --kv-block 16 and a prefix cache at
# serve_main's defaults otherwise (bf16 KV, depth 2, graphs); C the same
# weights on a 4-slot engine whose pool is small enough that storing the
# 1008-token entry and serving beside it demotes, with the host tier.
KV_IO_ARGS = at_depth(SERVE_ARGS, SIDE_LAYERS) + [
    "--kv-block", "16", "--prefix-cache", "8"]
KV_HOLD_PROMPTS = (512, 700, 850, 1000)  # two greedy, two sampled
KV_HOLD_FIRST, KV_HOLD_CONT = 8, 56
KV_MIGRATE_PROMPTS = (40, 96, 160, 256, 320, 400, 480, 512)
KV_MIGRATE_BUDGET, KV_MIGRATE_AFTER = 256, 64
KV_TEMP = 0.8
KV_TIER_BLOCKS = 160
KV_TIER_HOST = side_bytes(256 * 2**20)
KV_TIER_BUCKETS = (32, 1024, 2047)
KV_TIER_PRESSURE = (700, 740)  # two 64-block worst cases
KV_PARK_PROMPTS = (700, 760, 800)  # 64 new each
KV_PARK_NEW = 400


class TierClock:
    """CUDA events around an engine's block I/O, recorded as it serves
    (on the stream the engine enqueues it on): each copy down (a
    demotion's or park's gather and copy into pinned memory) and each
    restore's copies up, beside the host wall of each park and restore.
    Wraps the engine's methods; ``remove`` unwraps."""

    def __init__(self, engine):
        self.engine = engine
        self.down, self.up, self.parks, self.restores = [], [], [], []
        read, park = engine._read_blocks_dispatch, engine._try_park_locked
        write = engine._write_host_payload

        def reading(blocks):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            staged, done = read(blocks)
            end.record()
            self.down.append((start, end, sum(t.nbytes for t in staged)))
            return staged, done

        def parking(*args, **kw):
            t0 = time.monotonic()
            parked = park(*args, **kw)
            if parked:
                self.parks.append(time.monotonic() - t0)
            return parked

        def writing(host_blocks, dev_blocks):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            t0 = time.monotonic()
            start.record()
            write(host_blocks, dev_blocks)
            end.record()
            self.restores.append(time.monotonic() - t0)
            self.up.append((start, end, len(dev_blocks)
                            * engine._block_bytes))

        engine._read_blocks_dispatch = reading
        engine._try_park_locked = parking
        engine._write_host_payload = writing

    def remove(self) -> None:
        for name in ("_read_blocks_dispatch", "_try_park_locked",
                     "_write_host_payload"):
            vars(self.engine).pop(name, None)

    @staticmethod
    def rates(spans) -> list[tuple[float, float]]:
        """(device ms, GB/s) of each span."""
        torch.cuda.synchronize()
        out = []
        for start, end, nbytes in spans:
            ms = start.elapsed_time(end)
            out.append((ms, nbytes / ms / 1e6))
        return out


def sync_ms(fn, runs: int = 7) -> float:
    """Median device time in ms of one ``fn`` call by CUDA events around
    it, the device idle before each (a call that allocates pinned host
    memory must not find the device busy: a pinned block is reused only
    once its copy is done)."""
    fn()
    spent = []
    for _ in range(runs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        spent.append(start.elapsed_time(end))
    return float(np.median(spent))


def kv_engines():
    """(A, B, C) sharing one copy of the weights, warmed (every graph
    captured), and the f32 reference forward's (params, cfg)."""
    from oim_tpu_torch.cli import serve_main
    from oim_tpu_torch.serve.engine import Engine

    args = serve_main.build_parser().parse_args(KV_IO_ARGS)
    t0 = time.monotonic()
    a = serve_main.make_engine(args).warmup()
    kw = dict(n_slots=args.n_slots, max_len=args.max_len, chunk=args.chunk,
              kv_block=args.kv_block, prefix_cache_size=args.prefix_cache,
              device=a.device)
    b = Engine(a.params, a.cfg, **kw).warmup()
    c = Engine(a.params, a.cfg, **{
        **kw, "n_slots": 4, "kv_blocks": KV_TIER_BLOCKS,
        "prefix_cache_size": 2, "kv_host_bytes": KV_TIER_HOST,
        "prompt_buckets": KV_TIER_BUCKETS}).warmup()
    print(f"kv io: engines A and B ({args.n_slots} slots, --kv-block "
          f"{args.kv_block}, {a.kv_blocks} blocks), C (4 slots, "
          f"{KV_TIER_BLOCKS} blocks, host tier {c.stats()['kv_host_blocks_total']}"
          f" blocks of {c._block_bytes / 2**20:.2f} MiB) warmed in "
          f"{time.monotonic() - t0:.1f} s; weights shared: "
          f"{a.params['wte'] is b.params['wte'] is c.params['wte']}",
          flush=True)
    check(a.params["wte"] is b.params["wte"] is c.params["wte"],
          "kv io: the engines do not share the weight tensors")
    return a, b, c, widened(a.params, a.cfg)


def kv_run(engine, reqs) -> list[tuple[list, list]]:
    """Submit ``reqs`` (GenRequest keyword dicts) together, run the
    engine, return each (tokens, logprobs)."""
    from oim_tpu_torch.serve.engine import GenRequest

    rids = [engine.submit(GenRequest(**r)) for r in reqs]
    engine.run()
    return [tuple(map(list, engine.result_full(rid, timeout=0)))
            for rid in rids]


def kv_ref_logits(ref, tokens) -> torch.Tensor:
    """The f32 forward's logits [V] after ``tokens``."""
    from oim_tpu_torch.models import decode as dec

    params32, cfg32 = ref
    seq = torch.tensor([tokens], device=DEV)
    with torch.no_grad():
        logits, _ = dec.prefill(params32, seq, cfg32, seq.shape[1])
    return logits[0, -1].float()


def kv_same(ref, req: dict, want: list,
            got: list) -> tuple[bool, str, float]:
    """Whether a stream ``got`` is ``want``, the same request's stream on
    another route: token for token, or diverging first where the two
    tokens are a bf16 near tie of the f32 forward — both within δ of its
    max logit after the common prefix (for a sampled request, of its
    Gumbel-max score, δ / temperature: the noise of that token index is
    a function of the request alone).  Returns (ok, what, the gap)."""
    from oim_tpu_torch.models.decode import sampling_noise

    if want == got:
        return True, "equal", 0.0
    if len(want) != len(got):
        return False, f"length {len(got)} != {len(want)}", float("inf")
    i = next(j for j, (x, y) in enumerate(zip(want, got)) if x != y)
    score, tol = kv_ref_logits(ref, req["tokens"] + want[:i]), DELTA
    temp = req.get("temperature", 0.0)
    if temp > 0:
        score = score / temp + sampling_noise(
            req["seed"], req.get("sample_base", 0) + i, score.numel(), DEV)
        tol = DELTA / temp
    gap = float(score.max() - torch.minimum(score[want[i]], score[got[i]]))
    return (gap <= tol, f"diverges at token {i}, a gap of {gap:.3f} (tol "
            f"{tol:.3f})", gap)


def kv_gate(ref, tag: str, reqs, wants, gots) -> dict:
    """``kv_same`` over streams; fails on any divergence past a near tie.
    Returns how many are equal token for token and the largest gap of
    those that part."""
    equal, worst = 0, 0.0
    for req, want, got in zip(reqs, wants, gots):
        ok, what, gap = kv_same(ref, req, want, got)
        equal += what == "equal"
        worst = max(worst, gap)
        if what != "equal":
            print(f"kv io {tag}: a {len(req['tokens'])}-token "
                  f"{'sampled' if req.get('temperature') else 'greedy'} "
                  f"stream {what}", flush=True)
        check(ok, f"kv io {tag}: a stream {what}")
    return {"equal": equal, "of": len(reqs), "worst_gap": worst}


def kv_hold_ship(a, b, ref) -> dict:
    """Held KV, A to B: four prefill legs on A with ``hold_kv`` (8
    tokens), exported, packed, unpacked and imported on B, which
    continues each for 56 tokens with ``sample_base`` 8.  Gates: B's
    continuations are A's own continuations of the same imported bytes,
    token for token and logprob for logprob (the wire is invisible); and
    each whole stream is A's unbroken run (``kv_same``)."""
    from oim_tpu_torch.serve import disagg

    rng = np.random.RandomState(11)
    base = [dict(tokens=rng.randint(0, VOCAB, n).tolist(), seed=i,
                 temperature=KV_TEMP if i % 2 else 0.0)
            for i, n in enumerate(KV_HOLD_PROMPTS)]
    total = KV_HOLD_FIRST + KV_HOLD_CONT
    unbroken = kv_run(a, [dict(r, max_new_tokens=total) for r in base])
    legs = kv_run(a, [dict(r, max_new_tokens=KV_HOLD_FIRST, hold_kv=True)
                      for r in base])
    rids = sorted(a._kv_holds)
    check(len(rids) == len(base), f"kv io hold: {len(rids)} holds")
    walls = {"export": 0.0, "pack": 0.0, "unpack": 0.0, "import": 0.0}
    shipped, nbytes = [], 0
    for rid in rids:
        t0 = time.monotonic()
        manifest, arrays = a.export_kv(rid)
        t1 = time.monotonic()
        body = disagg.pack_transfer(manifest, arrays)
        t2 = time.monotonic()
        unpacked = disagg.unpack_transfer(body)
        t3 = time.monotonic()
        shipped.append((b.import_kv(*unpacked)[0], a.import_kv(*unpacked)[0]))
        t4 = time.monotonic()
        walls["export"] += t1 - t0
        walls["pack"] += t2 - t1
        walls["unpack"] += t3 - t2
        walls["import"] += t4 - t3
        nbytes += sum(x.nbytes for x in arrays)
        check(manifest["geometry"]["dtype"] == "bfloat16"
              and all(leaf["dtype"] == "bfloat16"
                      for leaf in manifest["leaves"]),
              f"kv io hold: manifest dtypes {manifest['geometry']}")
        check(a.release_kv_hold(rid), f"kv io hold: hold {rid} gone")
    conts = {}
    for name, engine, which in (("B", b, 0), ("A", a, 1)):
        conts[name] = kv_run(engine, [
            dict(r, tokens=r["tokens"] + first, max_new_tokens=KV_HOLD_CONT,
                 kv_import=ids[which], sample_base=KV_HOLD_FIRST)
            for r, (first, _), ids in zip(base, legs, shipped)])
    check(conts["B"] == conts["A"],
          "kv io hold: B's continuations differ from A's own continuations "
          "of the same imported bytes")
    gate = kv_gate(ref, "hold", base, [t for t, _ in unbroken],
                   [first + t for (first, _), (t, _) in
                    zip(legs, conts["B"])])
    equal = gate["equal"]
    mb = nbytes / 1e6
    out = {"streams": len(base), "unbroken": gate, "mb": mb,
           **{f"{k}_ms_per_mb": v * 1e3 / mb for k, v in walls.items()}}
    print(f"kv io hold: {len(base)} streams (2 greedy, 2 sampled) of "
          f"{KV_HOLD_FIRST} + {KV_HOLD_CONT} tokens shipped A → B, "
          f"{mb:.1f} MB; B's continuations = A's own, bit for bit; "
          f"{equal} of {len(base)} whole streams token-identical to the "
          f"unbroken runs, the rest parting at a near tie (the largest gap "
          f"{gate['worst_gap']:.3f}); walls per "
          f"MB: export_kv {out['export_ms_per_mb']:.3f} ms, pack_transfer "
          f"{out['pack_ms_per_mb']:.3f}, unpack_transfer "
          f"{out['unpack_ms_per_mb']:.3f}, import_kv "
          f"{out['import_ms_per_mb']:.3f} [{SMI}]", flush=True)
    return out


def kv_prefix_ship(a, b) -> dict:
    """The prefix phase's 1008-token system prompt stored on A, exported
    by digest, imported and installed on B; a prompt sharing it hits on
    B with the shared rows aliased (B's hit, install and bytes-saved
    counters), its tokens A's hit's, and its time to first token beside
    a same-length miss's."""
    from oim_tpu_torch.serve import disagg

    system, shared, _ = prefix_traffic(VOCAB)
    kv_run(a, [dict(tokens=system, max_new_tokens=1, cache_prefix=True)])
    digest_ = disagg.prefix_digest(system)
    t0 = time.monotonic()
    manifest, arrays = a.export_kv_prefix(digest_)
    body = disagg.pack_transfer(manifest, arrays)
    _, rows = b.import_kv_prefix(*disagg.unpack_transfer(body))
    installed = b.install_prefix_imports()
    wall = time.monotonic() - t0
    check(rows == PREFIX_SYSTEM and installed == 1,
          f"kv io prefix: shipped {rows} rows, installed {installed}")
    rng = np.random.RandomState(12)
    miss = rng.randint(0, VOCAB, len(shared[0])).tolist()
    before = b.stats()
    (b_miss, _), = kv_run(b, [dict(tokens=miss, max_new_tokens=8)])
    miss_ms = b._ttfts[-1] * 1e3
    (b_hit, b_lps), = kv_run(b, [dict(tokens=shared[0], max_new_tokens=8)])
    hit_ms = b._ttfts[-1] * 1e3
    after = b.stats()
    (a_hit, a_lps), = kv_run(a, [dict(tokens=shared[0], max_new_tokens=8)])
    saved = after["prefix_bytes_saved"] - before["prefix_bytes_saved"]
    blocks = PREFIX_SYSTEM // b.kv_block
    check(after["prefix_hits"] - before["prefix_hits"] == 1
          and after["prefix_fetch_installs"] == 1
          and saved == blocks * b._block_bytes,
          f"kv io prefix: B's hit aliased {saved} bytes, hits "
          f"{after['prefix_hits'] - before['prefix_hits']}, installs "
          f"{after['prefix_fetch_installs']}")
    check(b_hit == a_hit and b_lps == a_lps,
          "kv io prefix: B's hit on the shipped entry differs from A's hit "
          "on its own")
    print(f"kv io prefix: the {PREFIX_SYSTEM}-token entry ({blocks} blocks, "
          f"{manifest['rows']} rows, {sum(x.nbytes for x in arrays) / 1e6:.1f}"
          f" MB) exported, shipped and installed on B in {wall * 1e3:.1f} "
          f"ms; B's hit aliased all {blocks} blocks (no recompute of the "
          f"shared rows) and equals A's own hit; TTFT of the hit "
          f"{hit_ms:.1f} ms vs a {len(miss)}-token miss {miss_ms:.1f} ms "
          f"[{SMI}]", flush=True)
    return {"install_ms": wall * 1e3, "hit_ttft_ms": hit_ms,
            "miss_ttft_ms": miss_ms}


def kv_migrate(a, b, ref) -> dict:
    """Eight streams on A (four greedy, four sampled, 256-token budgets)
    suspended by ``begin_migrate_out`` after about 64 tokens, their slots
    exported and imported on B, which continues each with its
    ``sample_base``.  Gates: B's continuations are A's own continuations
    of the same bytes, and each whole stream is the unbroken run
    (``kv_same``)."""
    from oim_tpu_torch.serve import disagg
    from oim_tpu_torch.serve.engine import GenRequest, RequestFailedError

    rng = np.random.RandomState(13)
    base = [dict(tokens=rng.randint(0, VOCAB, n).tolist(), seed=20 + i,
                 temperature=KV_TEMP if i % 2 else 0.0)
            for i, n in enumerate(KV_MIGRATE_PROMPTS)]
    unbroken = kv_run(a, [dict(r, max_new_tokens=KV_MIGRATE_BUDGET)
                          for r in base])
    rids = [a.submit(GenRequest(**r, max_new_tokens=KV_MIGRATE_BUDGET))
            for r in base]
    start = a.stats()["tokens_generated"]
    while a.stats()["tokens_generated"] - start < (
            KV_MIGRATE_AFTER * len(base)):
        a.step()
    a.begin_migrate_out()
    a.run()
    manifests, imports, wall = [], [], 0.0
    for rid in rids:
        kind = None
        try:
            a.result(rid, timeout=0)
        except RequestFailedError as exc:
            kind = exc.kind
        check(kind == "migrated", f"kv io migrate: request {rid} ended "
              f"{kind or 'with a result'}, not suspended")
        t0 = time.monotonic()
        manifest, arrays = a.export_slot(rid)
        unpacked = disagg.unpack_transfer(
            disagg.pack_transfer(manifest, arrays))
        imports.append((b.import_slot(*unpacked)[0],
                        a.import_slot(*unpacked)[0]))
        wall += time.monotonic() - t0
        manifests.append(manifest)
        check(a.release_migrated(rid), "kv io migrate: record gone")
    # A serves again, to continue the same bytes itself: the exact gate.
    a._draining = a._migrate_out = False
    priors = [m["tokens"] for m in manifests]
    check(all(0 < len(p) < KV_MIGRATE_BUDGET for p in priors),
          f"kv io migrate: suspensions at {[len(p) for p in priors]}")
    conts = {}
    for name, engine, which in (("B", b, 0), ("A", a, 1)):
        conts[name] = kv_run(engine, [
            dict(r, tokens=r["tokens"] + m["tokens"],
                 max_new_tokens=KV_MIGRATE_BUDGET - len(m["tokens"]),
                 kv_import=ids[which], sample_base=m["slot"]["sample_base"])
            for r, m, ids in zip(base, manifests, imports)])
    check(conts["B"] == conts["A"],
          "kv io migrate: B's continuations differ from A's own")
    gate = kv_gate(ref, "migrate", base, [t for t, _ in unbroken],
                   [p + t for p, (t, _) in zip(priors, conts["B"])])
    equal = gate["equal"]
    print(f"kv io migrate: {len(base)} streams (4 greedy, 4 sampled) "
          f"suspended after {min(map(len, priors))}–{max(map(len, priors))}"
          f" tokens, exported, shipped and imported in {wall * 1e3:.1f} ms "
          f"all told; B's continuations = A's own, bit for bit; {equal} of "
          f"{len(base)} whole streams token-identical to the unbroken runs, "
          f"the rest parting at a near tie (the largest gap "
          f"{gate['worst_gap']:.3f}) [{SMI}]", flush=True)
    return {"streams": len(base), "unbroken": gate, "ship_ms": wall * 1e3,
            "suspended_at": [len(p) for p in priors]}


def kv_tier(c, ref) -> dict:
    """The host tier on C: the 1008-token entry served (the local hit),
    demoted by three admissions that need its blocks, then promoted by
    the same hit (bit-equal blocks, A's local hit's tokens, the promote's
    TTFT beside the recompute's); then an admission that cannot fit parks
    the coldest slot, whose restored stream is the same request run alone
    (``kv_same``).  Afterwards the pool holds only the entries' blocks and
    the host tier only the demoted entries'."""
    system, shared, _ = prefix_traffic(VOCAB)
    hit = [dict(tokens=shared[0], max_new_tokens=32)]
    clock = TierClock(c)
    try:
        (recompute, _), = kv_run(c, hit)
        recompute_ms = c._ttfts[-1] * 1e3
        kv_run(c, [dict(tokens=system, max_new_tokens=1, cache_prefix=True)])
        (local, _), = kv_run(c, hit)
        (blocks, _), = c._prefix_cache.values()
        ids = torch.as_tensor(blocks, device=DEV)
        before = digest(torch.stack([c._cache.k[:, ids], c._cache.v[:, ids]]))
        s0 = c.stats()
        rng = np.random.RandomState(14)
        kv_run(c, [dict(tokens=rng.randint(0, VOCAB, n).tolist(),
                        max_new_tokens=64) for n in KV_TIER_PRESSURE])
        s1 = c.stats()
        check(s1["prefix_demotions"] > s0["prefix_demotions"]
              and s1["host_prefix_entries"] == 1,
              f"kv io tier: the pressure did not demote the entry: {s1}")
        (promoted, _), = kv_run(c, hit)
        promote_ms = c._ttfts[-1] * 1e3
        s2 = c.stats()
        (blocks, _), = c._prefix_cache.values()
        ids = torch.as_tensor(blocks, device=DEV)
        after = digest(torch.stack([c._cache.k[:, ids], c._cache.v[:, ids]]))
        check(s2["kv_promotions"] - s1["kv_promotions"] == len(blocks)
              and s2["prefix_hits"] == s1["prefix_hits"] + 1,
              f"kv io tier: the hit did not promote: {s2}")
        check(after == before, "kv io tier: the promoted blocks are not the "
              "demoted ones")
        check(promoted == local, "kv io tier: the promoted hit differs from "
              "the hit before demotion")
        promote_gate = kv_gate(ref, "promote", hit, [recompute], [promoted])
        demote_n = len(clock.down)
        # Parking: three staggered admissions, each alone in its wave;
        # the third cannot fit beside the first two and parks one.
        with c._lock:
            c._clear_prefix_cache_locked()
            c._flush_host_tier_locked()
        rng = np.random.RandomState(15)
        reqs = [dict(tokens=rng.randint(0, VOCAB, n).tolist(),
                     max_new_tokens=KV_PARK_NEW, seed=30 + i,
                     temperature=KV_TEMP if i == 1 else 0.0)
                for i, n in enumerate(KV_PARK_PROMPTS)]
        alone = [kv_run(c, [r])[0][0] for r in reqs]
        from oim_tpu_torch.serve.engine import GenRequest

        p0 = c.stats()
        rids = []
        for r in reqs:
            rids.append(c.submit(GenRequest(**r)))
            for _ in range(3):
                c.step()
        c.run()
        together = [list(c.result(rid, timeout=0)) for rid in rids]
        p1 = c.stats()
        parks = p1["kv_parks"] - p0["kv_parks"]
        check(parks > 0 and p1["kv_unparks"] - p0["kv_unparks"] == parks,
              f"kv io tier: {parks} parks, "
              f"{p1['kv_unparks'] - p0['kv_unparks']} restores")
        gate = kv_gate(ref, "park", reqs, alone, together)
        equal = gate["equal"]
        downs = TierClock.rates(clock.down)
        ups = TierClock.rates(clock.up)
    finally:
        clock.remove()
    # The yardsticks: the entry's bytes moved by the tier's own calls,
    # idle, against plain pinned copies of as many bytes.
    with c._lock:
        c._clear_prefix_cache_locked()
    kv_run(c, [dict(tokens=system, max_new_tokens=1, cache_prefix=True)])
    (blocks, _), = c._prefix_cache.values()
    staged, _ = c._read_blocks_dispatch(blocks)
    torch.cuda.synchronize()
    nbytes = sum(t.nbytes for t in staged)
    dev = torch.empty(nbytes, dtype=torch.uint8, device=DEV)
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    yard = {
        "demote": sync_ms(lambda: c._read_blocks_dispatch(blocks)),
        "promote": sync_ms(lambda: c._write_blocks(blocks, staged)),
        "d2h": sync_ms(lambda: host.copy_(dev, non_blocking=True)),
        "h2d": sync_ms(lambda: dev.copy_(host, non_blocking=True)),
    }
    gbs = {k: nbytes / ms / 1e6 for k, ms in yard.items()}
    out = {"recompute_ttft_ms": recompute_ms, "promote_ttft_ms": promote_ms,
           "bytes": nbytes, "ms": yard, "gb_s": gbs, "parks": parks,
           "promote_recompute": promote_gate,
           "park_alone": gate, "park_wall_ms": [w * 1e3 for w in
                                                 clock.parks],
           "restore_wall_ms": [w * 1e3 for w in clock.restores],
           "in_engine_down": downs, "in_engine_up": ups,
           "demotions": demote_n}
    print(f"kv io tier: the {PREFIX_SYSTEM}-token entry demoted and "
          f"promoted bit-equal; its promoted hit = the hit before demotion, "
          f"and {'=' if promote_gate['equal'] else 'at a near tie of'} the "
          f"recompute; its TTFT {promote_ms:.1f} ms promoted "
          f"vs {recompute_ms:.1f} ms recomputed; {parks} park(s) and as many "
          f"restores, {equal} of {len(reqs)} streams token-identical to "
          f"their runs alone (largest near-tie gap "
          f"{gate['worst_gap']:.3f}); park walls {out['park_wall_ms']} ms, restore "
          f"walls {out['restore_wall_ms']} ms [{SMI}]", flush=True)
    print(f"kv io tier: {nbytes / 1e6:.1f} MB ({len(blocks)} blocks): "
          f"demote (gather + copy down) {yard['demote']:.3f} ms = "
          f"{gbs['demote']:.1f} GB/s vs a plain pinned copy down "
          f"{yard['d2h']:.3f} ms = {gbs['d2h']:.1f} GB/s; promote (copy up "
          f"+ scatter) {yard['promote']:.3f} ms = {gbs['promote']:.1f} GB/s "
          f"vs a plain pinned copy up {yard['h2d']:.3f} ms = "
          f"{gbs['h2d']:.1f} GB/s; in the engine, each copy down "
          f"{[f'{ms:.3f} ms {r:.1f} GB/s' for ms, r in downs]}, each "
          f"restore's copies up "
          f"{[f'{ms:.3f} ms {r:.1f} GB/s' for ms, r in ups]} [{SMI}]",
          flush=True)
    return out


def kv_no_leaks(engine, tag: str) -> None:
    """No device block beyond the prefix entries', no host block beyond
    the demoted entries', nothing held, staged, parked or migrated."""
    s = engine.stats()
    entry = {b for blocks, _ in engine._prefix_cache.values() for b in blocks}
    host = {b for blocks, _ in engine._host_prefix.values() for b in blocks}
    check(s["kv_blocks_used"] == len(entry)
          and s["kv_host_blocks_used"] == len(host)
          and not (s["parked_slots"] or s["kv_holds"]
                   or s["kv_imports_staged"] or s["migrated_slots"]
                   or s["prefix_installs_staged"] or s["active_slots"]),
          f"kv io {tag}: blocks left behind: {s['kv_blocks_used']} device "
          f"({len(entry)} the entries'), {s['kv_host_blocks_used']} host "
          f"({len(host)}), {s['parked_slots']} parked, {s['kv_holds']} "
          f"held, {s['kv_imports_staged']} staged, {s['migrated_slots']} "
          f"migrated")


def kv_io_phase() -> dict:
    """KV blocks leave the pool and come back, at Qwen2.5-1.5B's widths:
    held KV, a prefix entry and live slots shipped A → B through the
    wire's bytes, and the host tier's demotion, promotion and parking on
    C (``kv_hold_ship``, ``kv_prefix_ship``, ``kv_migrate``,
    ``kv_tier``).  Across the phase: K1 and K2 launched by route as the
    engines' passes and dispatches say (the decode route and K2 at t = 1
    ``layers × decode passes``, the tall route and K2 at t > 1 ``layers ×
    admission dispatches`` — restored, imported and promoted slots
    included), no plain call; every decode chunk and admission a graph
    replay, none captured after warmup; no block left behind in either
    tier.  Then the engines go and their memory with them."""
    from oim_tpu_torch.ops import paged_attention as pa

    t0 = time.monotonic()
    a, b, c, ref = kv_engines()
    engines = {"A": a, "B": b, "C": c}
    before = {name: e.stats() for name, e in engines.items()}
    pa.reset_counters()
    out = {"hold": kv_hold_ship(a, b, ref)}
    out["prefix"] = kv_prefix_ship(a, b)
    out["migrate"] = kv_migrate(a, b, ref)
    counts = pa.counters()  # before the tier phase's yardsticks
    after_ab = {name: engines[name].stats() for name in ("A", "B")}
    out["tier"] = kv_tier(c, ref)
    tier_counts = pa.counters()
    after = dict(after_ab, C=c.stats())
    layers = a.cfg.n_layers
    passes = dispatches = 0
    for name in engines:
        s, s0 = after[name], before[name]
        d = {k: s[k] - s0[k] for k in (
            "decode_passes", "decode_dispatches", "graph_replays",
            "prefill_dispatches", "admission_replays")}
        passes += d["decode_passes"]
        dispatches += d["prefill_dispatches"]
        check(d["graph_replays"] == d["decode_dispatches"] > 0
              and d["admission_replays"] == d["prefill_dispatches"] > 0,
              f"kv io {name}: not every dispatch a replay: {d}")
        check(s["admission_graphs"] == s0["admission_graphs"]
              and s["graph_capture_seconds"] == s0["graph_capture_seconds"],
              f"kv io {name}: a graph captured after warmup")
    check(tier_counts["paged_flash_decode_rows8"] == layers * passes
          and tier_counts["paged_kv_store_t1"] == layers * passes
          and tier_counts["paged_flash_decode_tc"] == layers * dispatches
          and tier_counts["paged_kv_store"]
          - tier_counts["paged_kv_store_t1"] == layers * dispatches,
          f"kv io: K1/K2 launches {tier_counts} != {layers} x "
          f"({passes} decode passes, {dispatches} admission dispatches)")
    check(tier_counts["paged_flash_decode_plain"] == 0
          and tier_counts["paged_kv_store_plain"] == 0
          and tier_counts["paged_flash_decode_rows16"] == 0,
          f"kv io: a plain version or another route ran: {tier_counts}")
    for name, engine in engines.items():
        kv_no_leaks(engine, name)
    out["counts"] = {"ab": counts, "all": tier_counts}
    out["seconds"] = time.monotonic() - t0
    print(f"kv io: K1/K2 {tier_counts} over {passes} decode passes and "
          f"{dispatches} admission dispatches of the three engines, every "
          f"one a graph replay, no plain call, no capture after warmup, no "
          f"block left in either tier; the phase took {out['seconds']:.1f} "
          f"s [{SMI}]", flush=True)
    del a, b, c, engine, engines, ref
    release()
    check(torch.cuda.memory_allocated() < 2**30,
          f"the kv io phase still holds "
          f"{gib(torch.cuda.memory_allocated()):.1f} GiB")
    return out


# ---------------------------------------------------------------------------
# QoS, shedding and request observation

# Engine Q: serve_main's model with the paged pool and a host tier that
# holds two parked slots of the preemption leg many times over, a policy
# with one premium and one best-effort tenant (unlisted tenants are
# standard), and a slow-capture threshold every request passes, at one
# capture an hour.  Engine S (the shedding leg, through the HTTP server)
# shares Q's weights: a queue bound of 8, brownout at 16 tokens with no
# hold, prompt buckets up to the leg's prompts.
# At all 28 layers: the shedding leg's deadline must expire while eight
# long requests hold the slots, which takes their full-depth decode.
QOS_HOST = 64 * 2**20
QOS_ARGS = SERVE_ARGS + ["--kv-block", "16", "--kv-host-bytes",
                         str(QOS_HOST), "--slow-capture-e2e", "0.001",
                         "--slow-capture-interval", "3600"]
QOS_POLICY = {"tenants": {"user.gold": {"tier": "premium"},
                          "user.bulk": {"tier": "best_effort"}}}
QOS_BULK_PROMPTS = (128, 176, 224, 272, 320, 368, 416, 512)
QOS_BULK_NEW, QOS_BULK_AFTER = 384, 32
QOS_PREMIUM = (256, 64)  # prompt, budget; two requests
QOS_FAIR = (12, 64, 32)  # requests a tenant, prompt, budget
QOS_FAIR_FIRST = 8  # the first finishers, of which each tenant has >= 3
SHED_QUEUE, SHED_BROWNOUT = 8, 16
SHED_BUCKETS = (16, 32, 64)
SHED_LONG = (8, 32, 512)  # requests filling the slots, prompt, budget
SHED_NEW = 64
SHED_DEADLINE_MS = 1500


class SyncCensus:
    """Counts the calls that make the host wait on the device while it
    is on — ``torch.cuda.Event.synchronize``, ``torch.cuda.synchronize``
    and ``Tensor.cpu``/``item``/``tolist`` — and, on ``engines`` (one
    engine or a list), the chunks read back (``_process_chunk``) and the
    admission waves that dispatched (whose first tokens one ``.cpu()``
    reads back).  The engine's own waits are one event a chunk read back
    and one a decode dispatch (its staging buffer's last copy), and one
    ``.cpu()`` a wave; the HTTP routes' are one event an export
    (``_gather_blocks``, which also counts a readback) and one a
    ``/v1/weights`` bounce-buffer copy (``weight_chunks``, given): any
    other call is a wait the engine added."""

    NAMES = (("Event.synchronize", torch.cuda.Event, "synchronize"),
             ("cuda.synchronize", torch.cuda, "synchronize"),
             ("Tensor.cpu", torch.Tensor, "cpu"),
             ("Tensor.item", torch.Tensor, "item"),
             ("Tensor.tolist", torch.Tensor, "tolist"))

    def __init__(self, engines, weight_chunks: int = 0):
        self.engines = (list(engines) if isinstance(engines, (list, tuple))
                        else [engines])
        self.weight_chunks = weight_chunks
        self.calls = dict.fromkeys([n for n, _, _ in self.NAMES], 0)
        # Where each counted call came from (its three callers), named in
        # a failure's message; every count is taken under the lock, since
        # several engines' step threads and handlers count at once.
        self.sites: dict = {}
        self.lock = threading.Lock()
        self.chunks = self.waves = 0
        self.saved = []

    def __enter__(self) -> "SyncCensus":
        for name, owner, attr in self.NAMES:
            fn = getattr(owner, attr)
            self.saved.append((owner, attr, fn))
            setattr(owner, attr, self._counting(name, fn))
        for e in self.engines:
            process, admit = e._process_chunk, e._admit_wave

            def processing(*args, _process=process, **kw):
                with self.lock:
                    self.chunks += 1
                return _process(*args, **kw)

            def admitting(*args, _admit=admit, _e=e, **kw):
                n = _e.prefill_dispatches
                out = _admit(*args, **kw)
                with self.lock:
                    self.waves += _e.prefill_dispatches > n
                return out

            e._process_chunk, e._admit_wave = processing, admitting
        self.befores = [e.stats() for e in self.engines]
        return self

    def _counting(self, name, fn):
        def counted(*args, **kw):
            with self.lock:
                self.calls[name] += 1
            frame, site = sys._getframe(1), []
            while frame is not None and len(site) < 3:
                site.append(f"{os.path.basename(frame.f_code.co_filename)}:"
                            f"{frame.f_lineno}")
                frame = frame.f_back
            key = (name, " < ".join(site))
            with self.lock:
                self.sites[key] = self.sites.get(key, 0) + 1
            return fn(*args, **kw)
        return counted

    def __exit__(self, *exc) -> None:
        for owner, attr, fn in self.saved:
            setattr(owner, attr, fn)
        for e in self.engines:
            for name in ("_process_chunk", "_admit_wave"):
                vars(e).pop(name, None)

    def check(self, tag: str) -> dict:
        d = exports = reads = 0
        for e, s0 in zip(self.engines, self.befores):
            s = e.stats()
            d += s["decode_dispatches"] - s0["decode_dispatches"]
            reads += s["readbacks"] - s0["readbacks"]
            exports += sum(s[k] - s0[k] for k in (
                "kv_exports", "prefix_exports", "slot_exports"))
        want = {"Event.synchronize": d + self.chunks + exports
                + self.weight_chunks, "cuda.synchronize": 0,
                "Tensor.cpu": self.waves, "Tensor.item": 0,
                "Tensor.tolist": 0}
        check(self.calls == want and reads == self.chunks + exports,
              f"{tag}: device waits {self.calls} != {want} for {d} "
              f"dispatches, {self.chunks} chunks read back ({reads} "
              f"readbacks counted), {self.waves} admission waves, "
              f"{exports} exports and {self.weight_chunks} weight copies; "
              f"from {self.sites}")
        return {"waits": dict(self.calls), "dispatches": d,
                "chunks_read": self.chunks, "waves": self.waves,
                "exports": exports, "weight_chunks": self.weight_chunks}


def qos_entries(engine, rids) -> dict:
    """The ring entries of ``rids``, by rid."""
    wanted = set(rids)
    return {e["rid"]: e for e in engine.requests()["requests"]
            if e["rid"] in wanted}


def ttft_ms(entry: dict) -> float:
    return (entry["queue_s"] + entry["admit_s"] + entry["prefill_s"]) * 1e3


def qos_drive(q, bulk, premium):
    """The preemption traffic on Q: the bulk requests fill every slot
    and, once each has ``QOS_BULK_AFTER`` tokens, the premium requests
    arrive; returns (bulk rids, premium rids, each (tokens, logprobs))."""
    from oim_tpu_torch.serve.engine import GenRequest

    rids = [q.submit(GenRequest(**r)) for r in bulk]
    while not (len(q._slots) == len(bulk) and all(
            len(s.emitted) >= QOS_BULK_AFTER for s in q._slots.values())):
        q.step()
    prids = [q.submit(GenRequest(**r)) for r in premium]
    q.run()
    return rids, prids, [tuple(map(list, q.result_full(rid, timeout=0)))
                         for rid in rids + prids]


def qos_preempt(q, ref) -> dict:
    """Preemption: a bulk best-effort tenant saturates Q's eight slots
    and a paying tenant's two requests arrive.  Each parks one bulk slot
    (``qos_preemptions`` 2), both premium first tokens come before any
    bulk stream ends, the two parked streams equal their runs alone and
    their unbroken runs (the same traffic with QoS off), and the tenant
    rows count the traffic.  Returns premium TTFT with QoS and without,
    and the leg's device-wait census."""
    from oim_tpu_torch.common import events

    vocab = q.cfg.vocab_size
    rng = np.random.RandomState(16)
    bulk = [dict(tokens=rng.randint(0, vocab, n).tolist(),
                 max_new_tokens=QOS_BULK_NEW, seed=40 + i,
                 tenant="user.bulk")
            for i, n in enumerate(QOS_BULK_PROMPTS)]
    premium = [dict(tokens=rng.randint(0, vocab, QOS_PREMIUM[0]).tolist(),
                    max_new_tokens=QOS_PREMIUM[1], seed=50 + i,
                    tenant="user.gold") for i in range(2)]
    rows0, preempts0 = q.stats()["tenants"], q.qos_preemptions
    seen = max((e.seq for e in events.all_events()
                if e.kind == "qos.preempt"), default=0)
    with SyncCensus(q) as census:
        rids, prids, served = qos_drive(q, bulk, premium)
    waits = census.check("qos preempt")
    preempts = q.qos_preemptions - preempts0
    victims = [e.fields["victim_rid"] for e in events.all_events()
               if e.kind == "qos.preempt" and e.seq > seen]
    check(preempts == 2 and len(victims) == 2
          and set(victims) <= set(rids),
          f"qos preempt: {preempts} preemptions, victims {victims}")
    entries = qos_entries(q, rids + prids)
    check(len(entries) == len(rids) + len(prids)
          and all(e["outcome"] == "ok" for e in entries.values()),
          "qos preempt: a request is missing from the ring or failed")
    first = [entries[r]["ts"] - entries[r]["e2e_s"]
             + ttft_ms(entries[r]) / 1e3 for r in prids]
    ends = [entries[r]["ts"] for r in rids]
    check(max(first) < min(ends),
          f"qos preempt: a premium first token came "
          f"{max(first) - min(ends):.3f} s after a bulk stream ended")
    rows = q.stats()["tenants"]

    def moved(name, key):
        return rows[name][key] - rows0.get(name, {}).get(key, 0)

    want = {("user.gold", "admitted"): 2, ("user.gold", "requests"): 2,
            ("user.gold", "tokens_out"): 2 * QOS_PREMIUM[1],
            ("user.gold", "preempted"): 2,
            ("user.bulk", "admitted"): len(bulk),
            ("user.bulk", "requests"): len(bulk),
            ("user.bulk", "tokens_out"): len(bulk) * QOS_BULK_NEW,
            ("user.bulk", "parked_victim"): 2}
    got = {k: moved(*k) for k in want}
    check(got == want, f"qos preempt: tenant rows moved {got} != {want}")
    check(rows["user.gold"]["tier"] == "premium"
          and rows["user.bulk"]["tier"] == "best_effort",
          f"qos preempt: tiers {rows}")
    qos_ttft = [ttft_ms(entries[r]) for r in prids]
    # The same traffic with QoS off: FIFO, nothing parks.
    saved = q._qos_policy
    q.set_qos_policy(None)
    try:
        with SyncCensus(q) as plain_census:
            off_rids, off_prids, unbroken = qos_drive(q, bulk, premium)
        plain_waits = plain_census.check("qos preempt, QoS off")
    finally:
        q.set_qos_policy(saved)
    check(q.qos_preemptions == preempts0 + preempts,
          "qos preempt: a preemption with QoS off")
    off_entries = qos_entries(q, off_rids + off_prids)
    fifo_ttft = [ttft_ms(off_entries[r]) for r in off_prids]
    index = [rids.index(v) for v in victims]
    reqs = [bulk[i] for i in index]
    alone = [kv_run(q, [r])[0][0] for r in reqs]
    parked = [served[i][0] for i in index]
    gate_alone = kv_gate(ref, "qos park alone", reqs, alone, parked)
    gate_unbroken = kv_gate(ref, "qos park unbroken", reqs,
                            [unbroken[i][0] for i in index], parked)
    gate_premium = kv_gate(ref, "qos premium", premium,
                           [t for t, _ in unbroken[len(bulk):]],
                           [t for t, _ in served[len(bulk):]])
    print(f"qos preempt: {len(bulk)} best-effort streams ({QOS_BULK_NEW} "
          f"new each) filled the {q.n_slots} slots, 2 premium requests "
          f"({QOS_PREMIUM[0]}-token prompts) arrived after "
          f"{QOS_BULK_AFTER} tokens: {preempts} preemptions (victims "
          f"{index} of the bulk), premium TTFT "
          f"{[round(t, 1) for t in qos_ttft]} ms with QoS vs "
          f"{[round(t, 1) for t in fifo_ttft]} ms without; "
          f"the parked streams: {gate_alone['equal']} of 2 token-identical "
          f"to their runs alone, {gate_unbroken['equal']} of 2 to their "
          f"unbroken runs (largest near-tie gap "
          f"{max(gate_alone['worst_gap'], gate_unbroken['worst_gap']):.3f}); "
          f"premium {gate_premium['equal']} of 2 equal to QoS off; device "
          f"waits {waits['waits']} with QoS, {plain_waits['waits']} without "
          f"[{SMI}]", flush=True)
    return {"preemptions": preempts, "victims": index,
            "victim_rids": victims,
            "premium_ttft_ms": qos_ttft, "premium_ttft_fifo_ms": fifo_ttft,
            "alone": gate_alone, "unbroken": gate_unbroken,
            "premium": gate_premium, "waits": waits,
            "waits_qos_off": plain_waits,
            "rids": rids + prids + off_rids + off_prids}


def qos_fair(q) -> dict:
    """Fair share on Q: two standard tenants, one with a skewed backlog
    (user.x queues all its requests first); each tenant has at least 3
    of the first 8 finishers, read from the request ring."""
    from oim_tpu_torch.serve.engine import GenRequest

    n, prompt, new = QOS_FAIR
    vocab = q.cfg.vocab_size
    rng = np.random.RandomState(17)
    rids = []
    with SyncCensus(q) as census:
        for tenant in ("user.x", "user.y"):
            rids += [q.submit(GenRequest(
                tokens=rng.randint(0, vocab, prompt).tolist(),
                max_new_tokens=new, tenant=tenant)) for _ in range(n)]
        q.run()
    waits = census.check("qos fair")
    for rid in rids:
        q.result(rid, timeout=0)
    wanted = set(rids)
    order = [e["tenant"] for e in q.requests()["requests"]
             if e["rid"] in wanted]
    first = order[:QOS_FAIR_FIRST]
    check(len(order) == len(rids) and first.count("user.x") >= 3
          and first.count("user.y") >= 3,
          f"qos fair: the first {QOS_FAIR_FIRST} finishers {first}")
    print(f"qos fair: user.x queued {n} requests, then user.y {n}; the "
          f"first {QOS_FAIR_FIRST} finishers {first} [{SMI}]", flush=True)
    return {"first": first, "waits": waits, "rids": rids}


def qos_shed(s) -> dict:
    """Shedding through the port's HTTP server in process, on S: long
    requests fill the slots, a request with a deadline and five more
    queue, the next two queue at the brownout threshold and come back
    clamped to ``SHED_BROWNOUT`` tokens, one more finds the queue full
    (429), and the deadline expires in the queue (429); both 429s carry
    a ``Retry-After`` in [1, 120]."""
    from oim_tpu_torch.serve.server import ServeServer

    vocab = s.cfg.vocab_size
    rng = np.random.RandomState(18)
    s0 = s.stats()
    server = ServeServer(s).start()
    results, threads = {}, []

    def send(name, body, want_queued=None, want_active=None):
        def go():
            results[name] = post_status(server.port, body)
        t = threading.Thread(target=go)
        t.start()
        threads.append(t)
        deadline = time.monotonic() + 60
        while True:
            st = s.stats()
            if ((want_queued is None or st["queued"] >= want_queued)
                    and (want_active is None
                         or st["active_slots"] >= want_active)):
                return
            check(time.monotonic() < deadline,
                  f"qos shed: {name} never queued ({st['queued']} queued)")
            time.sleep(0.002)

    def prompt(n):
        return rng.randint(0, vocab, n).tolist()

    try:
        n_long, long_prompt, long_new = SHED_LONG
        for i in range(n_long):
            send(f"long{i}", {"tokens": prompt(long_prompt),
                              "max_new_tokens": long_new},
                 want_active=i + 1)
        send("deadline", {"tokens": prompt(16), "max_new_tokens": SHED_NEW,
                          "deadline_ms": SHED_DEADLINE_MS}, want_queued=1)
        for i in range(5):
            send(f"normal{i}", {"tokens": prompt(16),
                                "max_new_tokens": SHED_NEW},
                 want_queued=2 + i)
        for i in range(2):
            send(f"clamped{i}", {"tokens": prompt(16),
                                 "max_new_tokens": SHED_NEW},
                 want_queued=7 + i)
        full = post_status(server.port, {"tokens": prompt(16),
                                         "max_new_tokens": SHED_NEW})
        for t in threads:
            t.join(300)
    finally:
        server.stop()
    s1 = s.stats()

    def retry(reply) -> int:
        value = int(reply[2].get("Retry-After", 0))
        check(1 <= value <= 120, f"qos shed: Retry-After {value}")
        return value

    code, body, _ = full
    check(code == 429 and "queue full" in body.get("error", ""),
          f"qos shed: a full queue answered {code} {body}")
    code, body, _ = results["deadline"]
    check(code == 429 and "deadline" in body.get("error", ""),
          f"qos shed: the expired deadline answered {code} {body}")
    clamped = [len(results[f"clamped{i}"][1]["tokens"]) for i in range(2)]
    normal = [len(results[f"normal{i}"][1]["tokens"]) for i in range(5)]
    check(clamped == [SHED_BROWNOUT] * 2 and normal == [SHED_NEW] * 5,
          f"qos shed: clamped replies {clamped}, the others {normal}")
    shed = {k: s1[k] - s0[k] for k in ("shed_queue_full", "shed_deadline",
                                       "shed_brownout")}
    check(shed == {"shed_queue_full": 1, "shed_deadline": 1,
                   "shed_brownout": 2}, f"qos shed: counters {shed}")
    after = {"queue_full": retry(full),
             "deadline": retry(results["deadline"])}
    print(f"qos shed: queue bound {SHED_QUEUE}, brownout at "
          f"{SHED_BROWNOUT} tokens: 2 replies clamped to {clamped}, a full "
          f"queue and an expired deadline each 429 with Retry-After "
          f"{after} s; counters {shed} [{SMI}]", flush=True)
    rids = [r[1]["request_id"] for name, r in results.items()
            if r[0] == 200]
    return {"clamped": clamped, "retry_after_s": after, "counters": shed,
            "rids": rids}


def post_status(port: int, body: dict) -> tuple[int, dict, dict]:
    """POST /v1/generate: (status, JSON body, headers), errors too."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read()), dict(exc.headers)


def qos_observed(engines, rids: dict, captures: int, work: str,
                 parked=frozenset()) -> dict:
    """Observation across the legs: every request in its engine's ring
    with its outcome, its phases summing to at most e2e + 1 ms and, but
    for the ``parked`` rids, at least half of it (the phase clock, the
    reference's, gives a parked interval to no phase, and a preemption's
    victim may wait out most of its life in the host tier), one
    ``engine.request`` span and one decode span a chunk; one slow
    capture in the flight dir; the watchdog idle."""
    from oim_tpu_torch.common import events, tracing

    spans = tracing.collector().spans()
    by_trace: dict = {}
    for span in spans:
        if span.component == "engine":
            by_trace.setdefault(span.trace_id, []).append(span)
    checked = 0
    for name, engine in engines.items():
        entries = qos_entries(engine, rids[name])
        check(len(entries) == len(rids[name]),
              f"qos observe {name}: {len(rids[name]) - len(entries)} "
              f"requests missing from the ring")
        for rid, e in entries.items():
            check(e["outcome"] == "ok", f"qos observe {name}: rid {rid} "
                  f"{e['outcome']}")
            total = sum(e[f"{p}_s"] for p in ("queue", "admit", "prefill",
                                              "decode", "stream"))
            low = 0.0 if rid in parked else 0.5 * e["e2e_s"]
            check(low <= total <= e["e2e_s"] + 1e-3,
                  f"qos observe {name}: rid {rid}'s phases sum to {total} "
                  f"of e2e {e['e2e_s']}")
            tree = by_trace.get(e["trace"], [])
            n_root = sum(s.name == "engine.request" for s in tree)
            n_decode = sum(s.name == "engine.decode" for s in tree)
            check(n_root == 1 and n_decode == e["chunks"],
                  f"qos observe {name}: rid {rid} has {n_root} request "
                  f"spans and {n_decode} decode spans for {e['chunks']} "
                  f"chunks")
            checked += 1
        waiting, ewma = engine.watchdog_state()
        check(waiting is None and ewma is not None and ewma > 0,
              f"qos observe {name}: watchdog_state ({waiting}, {ewma}) at "
              f"idle")
    files = [f for f in os.listdir(work) if f.startswith("oim-slowcap-")]
    new = len([e for e in events.all_events()
               if e.kind == "serve.slow_capture"]) - captures
    check(len(files) == 1 and new == 1,
          f"qos observe: {len(files)} slow-capture files, {new} events "
          f"(one an interval)")
    with open(os.path.join(work, files[0])) as f:
        doc = json.load(f)
    check({"kind", "trigger", "thresholds", "entry", "chunks", "stats",
           "ring"} <= set(doc), f"qos observe: slow capture keys {set(doc)}")
    return {"requests": checked, "spans": len(spans),
            "slow_capture": files[0]}


def qos_phase() -> dict:
    """Multi-tenant QoS, shedding and request observation at
    Qwen2.5-1.5B's widths (``qos_preempt``, ``qos_fair`` on Q,
    ``qos_shed`` on S through the HTTP server, ``qos_observed``).
    Across the phase, as the kv io phase: K1 and K2 launched by route as
    the engines' passes and dispatches say (restores included), no
    plain call, every dispatch a graph replay and none captured after
    warmup, the device waits of every leg on Q the engine's own
    (``SyncCensus``, with QoS and without), no block left in either
    tier, and the memory back under 1 GiB."""
    from oim_tpu_torch.cli import serve_main
    from oim_tpu_torch.common import events, tracing
    from oim_tpu_torch.ops import paged_attention as pa
    from oim_tpu_torch.serve.engine import Engine

    t0 = time.monotonic()
    work = tempfile.mkdtemp(prefix=".smoke-qos-", dir=HERE)
    flight = os.environ.get("OIM_FLIGHT_DIR")
    os.environ["OIM_FLIGHT_DIR"] = work
    try:
        policy = os.path.join(work, "policy.json")
        with open(policy, "w") as f:
            json.dump(QOS_POLICY, f)
        args = serve_main.build_parser().parse_args(
            QOS_ARGS + ["--qos-policy", policy])
        q = serve_main.make_engine(args).warmup()
        s = Engine(q.params, q.cfg, n_slots=args.n_slots,
                   max_len=args.max_len, chunk=args.chunk, kv_block=16,
                   prompt_buckets=SHED_BUCKETS, max_queue=SHED_QUEUE,
                   brownout_max_tokens=SHED_BROWNOUT, brownout_hold_s=0.0,
                   device=q.device).warmup()
        ref = widened(q.params, q.cfg)
        print(f"qos: engines Q ({args.n_slots} slots, {q.kv_blocks} blocks "
              f"of 16, host tier {q.stats()['kv_host_blocks_total']} blocks, "
              f"policy {QOS_POLICY}) and S (max_queue {SHED_QUEUE}, "
              f"brownout {SHED_BROWNOUT}) warmed in "
              f"{time.monotonic() - t0:.1f} s", flush=True)
        engines = {"Q": q, "S": s}
        before = {name: e.stats() for name, e in engines.items()}
        tracing.collector().clear()
        captures = len([e for e in events.all_events()
                        if e.kind == "serve.slow_capture"])
        pa.reset_counters()
        out = {"preempt": qos_preempt(q, ref)}
        out["fair"] = qos_fair(q)
        out["shed"] = qos_shed(s)
        counts = pa.counters()
        after = {name: e.stats() for name, e in engines.items()}
        rids = {"Q": out["preempt"].pop("rids") + out["fair"].pop("rids"),
                "S": out["shed"].pop("rids")}
        out["observed"] = qos_observed(
            engines, rids, captures, work,
            parked=set(out["preempt"].pop("victim_rids")))
    finally:
        if flight is None:
            os.environ.pop("OIM_FLIGHT_DIR", None)
        else:
            os.environ["OIM_FLIGHT_DIR"] = flight
        shutil.rmtree(work, ignore_errors=True)
    layers = q.cfg.n_layers
    passes = dispatches = 0
    for name in engines:
        st, st0 = after[name], before[name]
        d = {k: st[k] - st0[k] for k in (
            "decode_passes", "decode_dispatches", "graph_replays",
            "prefill_dispatches", "admission_replays")}
        passes += d["decode_passes"]
        dispatches += d["prefill_dispatches"]
        check(d["graph_replays"] == d["decode_dispatches"] > 0
              and d["admission_replays"] == d["prefill_dispatches"] > 0,
              f"qos {name}: not every dispatch a replay: {d}")
        check(st["admission_graphs"] == st0["admission_graphs"]
              and st["graph_capture_seconds"] == st0["graph_capture_seconds"],
              f"qos {name}: a graph captured after warmup")
    check(counts["paged_flash_decode_rows8"] == layers * passes
          and counts["paged_kv_store_t1"] == layers * passes
          and counts["paged_flash_decode_tc"] == layers * dispatches
          and counts["paged_kv_store"] - counts["paged_kv_store_t1"]
          == layers * dispatches,
          f"qos: K1/K2 launches {counts} != {layers} x ({passes} decode "
          f"passes, {dispatches} admission dispatches)")
    check(counts["paged_flash_decode_plain"] == 0
          and counts["paged_kv_store_plain"] == 0
          and counts["paged_flash_decode_rows16"] == 0,
          f"qos: a plain version or another route ran: {counts}")
    check(after["Q"]["kv_parks"] - before["Q"]["kv_parks"]
          == after["Q"]["kv_unparks"] - before["Q"]["kv_unparks"] == 2,
          f"qos: parks and restores {after['Q']['kv_parks']}, "
          f"{after['Q']['kv_unparks']}")
    for name, engine in engines.items():
        kv_no_leaks(engine, name)
    out["counts"] = counts
    out["seconds"] = time.monotonic() - t0
    print(f"qos: K1/K2 {counts} over {passes} decode passes and "
          f"{dispatches} admission dispatches of the two engines (2 parks, "
          f"2 restores), every one a graph replay, no plain call, no "
          f"capture after warmup, no block left in either tier; "
          f"{out['observed']['requests']} requests observed; the phase "
          f"took {out['seconds']:.1f} s [{SMI}]", flush=True)
    del q, s, engine, engines, ref
    release()
    check(torch.cuda.memory_allocated() < 2**30,
          f"the qos phase still holds "
          f"{gib(torch.cuda.memory_allocated()):.1f} GiB")
    return out


# ---------------------------------------------------------------------------
# The HTTP surfaces a router drives

# Servers A and B: serve_main's model with the paged pool, a prefix cache
# and a host tier; B shares A's weights.  C is brought up from A over
# /v1/weights.  Traffic (the legs' prompts and budgets) is the only cut.
HTTP_HOST = side_bytes(64 * 2**20)
HTTP_STREAM_PROMPTS = (128, 256, 384, 512)
HTTP_STREAM_NEW = 128
HTTP_DISCONNECT = (64, 1024, 8)  # prompt, budget, tokens read
HTTP_DRAIN_PROMPTS = (256, 320, 448, 512)
HTTP_DRAIN_NEW, HTTP_DRAIN_AFTER = 256, 32
HTTP_HOLD_PROMPTS = (700, 850)  # one greedy, one sampled
HTTP_HOLD_FIRST, HTTP_HOLD_CONT = 8, 56
HTTP_SYSTEMS = (512, 384)  # prefix entries on A: the prewarm's two
HTTP_STALL_FLOOR = HTTP_STALL_MULT = 1e-3


def http_args() -> list[str]:
    return at_depth(SERVE_ARGS, SIDE_LAYERS) + [
        "--kv-block", "16", "--prefix-cache", "8", "--kv-host-bytes",
        str(HTTP_HOST)]


def http_call(port: int, path: str, body=None, method=None,
              timeout: float = 600):
    """(status, headers, JSON or raw bytes) of one request to the
    server on ``port``; an HTTP error answers the same way."""
    data = (body if isinstance(body, (bytes, bytearray)) or body is None
            else json.dumps(body).encode())
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status, headers, raw = resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as exc:
        status, headers, raw = exc.code, exc.headers, exc.read()
    if "json" in headers.get("Content-Type", ""):
        return status, headers, json.loads(raw)
    return status, headers, raw


def http_stream(port: int, body: dict, lines: list) -> float:
    """Stream one generate into ``lines`` (parsed NDJSON, in order);
    returns the wall from the request to its first line, in ms."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(dict(body, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    first = None
    with urllib.request.urlopen(req, timeout=600) as resp:
        check(resp.headers["Content-Type"] == "application/x-ndjson"
              and resp.headers["traceparent"].startswith("00-"),
              f"http stream: headers {dict(resp.headers)}")
        for raw in resp:
            if raw.strip():
                if first is None:
                    first = (time.monotonic() - t0) * 1e3
                lines.append(json.loads(raw))
    return first


def ring_entry(engine, rid: int) -> dict:
    """``rid``'s ring entry, waiting for it: the step thread finalizes a
    request a moment after its reply is out."""
    deadline = time.monotonic() + 10
    while True:
        entry = qos_entries(engine, [rid]).get(rid)
        if entry is not None:
            return entry
        check(time.monotonic() < deadline, f"http: rid {rid} not in the ring")
        time.sleep(0.002)


def http_ok(port: int, body: dict) -> dict:
    status, _, reply = http_call(port, "/v1/generate", body)
    check(status == 200, f"http: generate answered {status} {reply}")
    return reply


def http_streams(a_port: int, a) -> dict:
    """Each request alone (the same admission and decode shapes both
    times): the plain reply, then the stream.  Gates: the NDJSON tokens
    and logprobs are the plain reply's, one line a token in order, one
    done line last.  Records the lone 512-token prompt's first-line
    latency beside its plain reply's time to first token."""
    rng = np.random.RandomState(31)
    out = {}
    for n in HTTP_STREAM_PROMPTS:
        body = {"tokens": rng.randint(0, VOCAB, n).tolist(),
                "max_new_tokens": HTTP_STREAM_NEW, "logprobs": True}
        plain = http_ok(a_port, body)
        plain_ttft = ttft_ms(ring_entry(a, plain["request_id"]))
        lines = []
        first = http_stream(a_port, body, lines)
        tokens = [ln["token"] for ln in lines[:-1]]
        lps = [ln["logprob"] for ln in lines[:-1]]
        done = lines[-1]
        check(all("token" in ln for ln in lines[:-1])
              and sum("done" in ln for ln in lines) == 1 and done["done"],
              f"http stream {n}: lines {lines[-2:]}")
        check(tokens == plain["tokens"] == done["tokens"]
              and lps == plain["logprobs"] == done["logprobs"],
              f"http stream {n}: the NDJSON differs from the plain reply")
        out[n] = {"first_line_ms": first, "plain_ttft_ms": plain_ttft,
                  "stream_ttft_ms": ttft_ms(ring_entry(a, done["request_id"])),
                  "rids": [plain["request_id"], done["request_id"]]}
    lone = out[max(HTTP_STREAM_PROMPTS)]
    print(f"http stream: {len(out)} greedy requests, each alone, streamed "
          f"and not: the NDJSON tokens and logprobs are the plain replies'; "
          f"the lone {max(HTTP_STREAM_PROMPTS)}-token prompt's first line "
          f"after {lone['first_line_ms']:.1f} ms at the client (its engine "
          f"TTFT {lone['stream_ttft_ms']:.1f} ms) against the plain reply's "
          f"TTFT {lone['plain_ttft_ms']:.1f} ms [{SMI}]", flush=True)
    return out


def http_disconnect(a_port: int, a) -> dict:
    """A stream closed by its client after 8 tokens: within 2 s the slot
    is free, its blocks are back and the cancel is counted."""
    import socket

    from oim_tpu_torch.common import metrics

    n, budget, read = HTTP_DISCONNECT
    cancelled = metrics.SERVE_REQUESTS.value("cancelled")
    used = a.stats()["kv_blocks_used"]
    body = json.dumps({"tokens": list(range(1, n + 1)),
                       "max_new_tokens": budget, "stream": True}).encode()
    sock = socket.create_connection(("127.0.0.1", a_port), timeout=60)
    sock.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: x\r\nContent-Type: "
                 b"application/json\r\nContent-Length: "
                 + str(len(body)).encode() + b"\r\n\r\n" + body)
    got = b""
    while got.count(b'"token"') < read:
        got += sock.recv(65536)
    sock.close()
    t0 = time.monotonic()
    while time.monotonic() - t0 < 2.0:
        s = a.stats()
        if (s["active_slots"] == 0 and s["kv_blocks_used"] == used
                and metrics.SERVE_REQUESTS.value("cancelled")
                == cancelled + 1):
            break
        time.sleep(0.005)
    wall = time.monotonic() - t0
    s = a.stats()
    check(s["active_slots"] == 0 and s["kv_blocks_used"] == used
          and metrics.SERVE_REQUESTS.value("cancelled") == cancelled + 1,
          f"http disconnect: after 2 s {s['active_slots']} active, "
          f"{s['kv_blocks_used']} blocks used (was {used}), cancels "
          f"{metrics.SERVE_REQUESTS.value('cancelled') - cancelled}")
    print(f"http disconnect: a {budget}-token stream closed after {read} "
          f"tokens; slot and blocks back, cancel counted, {wall * 1e3:.0f} "
          f"ms after the close ({s['tokens_generated']} tokens made all "
          f"told) [{SMI}]", flush=True)
    return {"free_ms": wall * 1e3}


def http_continue(ports, bodies) -> list[dict]:
    """Each (port, body) generate; the requests of one port one after
    another (one admission shape each), the ports' side by side."""
    out = [None] * len(bodies)

    def run(port):
        for i, (p, body) in enumerate(zip(ports, bodies)):
            if p == port:
                out[i] = http_ok(port, body)

    threads = [threading.Thread(target=run, args=(p,)) for p in set(ports)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def http_drain(a_port: int, b_port: int, a, b) -> dict:
    """Four streams on A; once each has shown 32 tokens (of 256) A is
    drained, and a non-stream request in flight with them answers 503
    with ``Retry-After``.  Per stream: its migrate line, ``GET /v1/slot``
    off A, ``PUT /v1/slot`` on B (and on A, undrained: the same bytes),
    the continuation on B and on A, ``DELETE /v1/slot`` on A.  Gates: B's
    continuations are A's own, bit for bit; and (``kv_gate``, once the
    phase's census is over) each spliced stream is its unbroken run or
    parts from it only at a near tie."""
    rng = np.random.RandomState(32)
    base = [dict(tokens=rng.randint(0, VOCAB, n).tolist(), seed=40 + i,
                 temperature=KV_TEMP if i % 2 else 0.0)
            for i, n in enumerate(HTTP_DRAIN_PROMPTS)]
    unbroken = http_continue([a_port] * len(base), [
        dict(r, max_new_tokens=HTTP_DRAIN_NEW) for r in base])
    streams = [[] for _ in base]
    threads = [threading.Thread(target=http_stream, args=(
        a_port, dict(r, max_new_tokens=HTTP_DRAIN_NEW), lines))
        for r, lines in zip(base, streams)]
    plain = []
    threads.append(threading.Thread(target=lambda: plain.append(http_call(
        a_port, "/v1/generate", dict(base[0], max_new_tokens=HTTP_DRAIN_NEW,
                                     seed=99)))))
    for t in threads:
        t.start()
    deadline = time.monotonic() + 120
    while min(len(s) for s in streams) < HTTP_DRAIN_AFTER:
        check(time.monotonic() < deadline, "http drain: streams stalled")
        time.sleep(0.001)
    status, _, reply = http_call(a_port, "/v1/drain", {})
    check(status == 200 and reply["draining"] is True,
          f"http drain: POST /v1/drain answered {status} {reply}")
    for t in threads:
        t.join(600)
    status, headers, _ = plain[0]
    check(status == 503 and 1 <= int(headers.get("Retry-After", 0)) <= 120,
          f"http drain: the non-stream request answered {status} "
          f"{dict(headers)}")
    marks = [s[-1] for s in streams]
    check(all(m.get("migrate") is True for m in marks),
          f"http drain: stream ends {[m.get('error') for m in marks]}")
    rids = [int(m["request_id"]) for m in marks]
    with a._lock:  # the non-stream request's record: no router ships it
        others = [r for r in a._migrated if r not in rids]
    for rid in others:
        check(http_call(a_port, f"/v1/slot?rid={rid}",
                        method="DELETE")[2]["ok"] is True,
              "http drain: a record would not release")
    a._draining = a._migrate_out = False
    priors = [[ln["token"] for ln in s[:-1]] for s in streams]
    check(all(HTTP_DRAIN_AFTER <= len(p) < HTTP_DRAIN_NEW for p in priors),
          f"http drain: suspended at {[len(p) for p in priors]}")
    ships, nbytes, wall = [], 0, 0.0
    for rid in rids:
        t0 = time.monotonic()
        status, _, body = http_call(a_port, f"/v1/slot?rid={rid}")
        check(status == 200, f"http drain: GET /v1/slot answered {status}")
        staged = []
        for port in (b_port, a_port):
            status, headers, reply = http_call(port, "/v1/slot", body,
                                               method="PUT")
            check(status == 200, f"http drain: PUT /v1/slot answered "
                  f"{status} {reply}")
            staged.append(reply)
            if port == b_port:
                wall += time.monotonic() - t0
        nbytes += len(body)
        ships.append(staged)
        for want in (True, False):
            check(http_call(a_port, f"/v1/slot?rid={rid}", method="DELETE")[
                2]["ok"] is want, "http drain: DELETE /v1/slot")
    conts = http_continue(
        [b_port] * len(base) + [a_port] * len(base),
        [dict(r, tokens=r["tokens"] + p, logprobs=True,
              max_new_tokens=HTTP_DRAIN_NEW - len(p),
              kv_import=staged[which]["import_id"],
              sample_base=staged[which]["slot"]["sample_base"])
         for which in (0, 1)
         for r, p, staged in zip(base, priors, ships)])
    on_b, on_a = conts[:len(base)], conts[len(base):]
    check([(c["tokens"], c["logprobs"]) for c in on_b]
          == [(c["tokens"], c["logprobs"]) for c in on_a],
          "http drain: B's continuations differ from A's own continuations "
          "of the same bytes")
    mb = nbytes / 1e6
    print(f"http drain: {len(base)} streams (2 greedy, 2 sampled) drained "
          f"after {min(map(len, priors))}–{max(map(len, priors))} tokens, "
          f"each ended in its migrate line; a non-stream request answered "
          f"503 with Retry-After; {mb:.1f} MB of slots shipped A → B over "
          f"HTTP at {wall * 1e3 / mb:.3f} ms per MB (GET + PUT); B's "
          f"continuations = A's own, bit for bit [{SMI}]", flush=True)
    return {"slot_ms_per_mb": wall * 1e3 / mb, "mb": mb,
            "suspended_at": [len(p) for p in priors],
            "gate": (base, [u["tokens"] for u in unbroken],
                     [p + c["tokens"] for p, c in zip(priors, on_b)]),
            "rids_a": [u["request_id"] for u in unbroken] + rids,
            "rids_b": [c["request_id"] for c in on_b]}


def http_kv(a_port: int, b_port: int, a, b) -> dict:
    """Disaggregated prefill over HTTP: ``hold_kv`` legs on A, ``GET
    /v1/kv?rid`` off A, ``PUT /v1/kv`` on B (and on A), the continuation
    with ``kv_import`` on B and on A, ``DELETE /v1/kv`` on A; a prefix
    entry exported by digest, installed on B and hit there; a 404 for an
    unknown rid, a 409 for a geometry mismatch, a 429 with
    ``Retry-After`` while B's pool cannot reserve the blocks."""
    import struct

    from oim_tpu_torch.serve import disagg

    rng = np.random.RandomState(33)
    base = [dict(tokens=rng.randint(0, VOCAB, n).tolist(), seed=50 + i,
                 temperature=KV_TEMP if i % 2 else 0.0)
            for i, n in enumerate(HTTP_HOLD_PROMPTS)]
    total = HTTP_HOLD_FIRST + HTTP_HOLD_CONT
    unbroken = http_continue([a_port] * len(base),
                             [dict(r, max_new_tokens=total) for r in base])
    legs = http_continue([a_port] * len(base), [
        dict(r, max_new_tokens=HTTP_HOLD_FIRST, hold_kv=True) for r in base])
    staged, nbytes, wall, body = [], 0, 0.0, b""
    for leg in legs:
        t0 = time.monotonic()
        status, _, body = http_call(a_port, f"/v1/kv?rid={leg['request_id']}")
        check(status == 200, f"http kv: GET /v1/kv answered {status}")
        ids = []
        for port in (b_port, a_port):
            status, _, reply = http_call(port, "/v1/kv", body, method="PUT")
            check(status == 200, f"http kv: PUT /v1/kv answered {status}")
            ids.append(reply["import_id"])
            if port == b_port:
                wall += time.monotonic() - t0
        nbytes += len(body)
        staged.append(ids)
        check(http_call(a_port, f"/v1/kv?rid={leg['request_id']}",
                        method="DELETE")[2]["ok"] is True,
              "http kv: DELETE /v1/kv")
    conts = http_continue(
        [b_port] * len(base) + [a_port] * len(base),
        [dict(r, tokens=r["tokens"] + leg["tokens"], logprobs=True,
              max_new_tokens=HTTP_HOLD_CONT, kv_import=ids[which],
              sample_base=HTTP_HOLD_FIRST)
         for which in (0, 1) for r, leg, ids in zip(base, legs, staged)])
    on_b, on_a = conts[:len(base)], conts[len(base):]
    check([(c["tokens"], c["logprobs"]) for c in on_b]
          == [(c["tokens"], c["logprobs"]) for c in on_a],
          "http kv: B's continuations differ from A's own")
    # The faults: an unknown rid, a geometry B does not have, a full pool.
    status = http_call(a_port, "/v1/kv?rid=999999")[0]
    check(status == 404, f"http kv: an unknown rid answered {status}")
    (length,) = struct.unpack(">Q", body[:8])
    manifest = json.loads(body[8:8 + length])
    manifest["geometry"] = dict(manifest["geometry"], block_size=8)
    head = json.dumps(manifest).encode()
    foreign = struct.pack(">Q", len(head)) + head + body[8 + length:]
    status, _, reply = http_call(b_port, "/v1/kv", foreign, method="PUT")
    check(status == 409 and "block_size" in reply["error"],
          f"http kv: a geometry mismatch answered {status} {reply}")
    with b._lock:  # B's pool held full by the smoke itself
        held = b._alloc.alloc(b._alloc.free_blocks)
    try:
        status, headers, reply = http_call(b_port, "/v1/kv", body,
                                           method="PUT")
    finally:
        with b._lock:
            b._alloc.decref(held)
    check(status == 429 and 1 <= int(headers.get("Retry-After", 0)) <= 120,
          f"http kv: a full pool answered {status} {reply}")
    # A prefix entry: stored on A, exported by digest, installed on B.
    systems = [rng.randint(0, VOCAB, n).tolist() for n in HTTP_SYSTEMS]
    http_continue([a_port] * len(systems), [
        dict(tokens=s, max_new_tokens=1, cache_prefix=True)
        for s in systems])
    digest = disagg.prefix_digest(systems[0])
    hits = b.stats()["prefix_hits"]
    t0 = time.monotonic()
    status, _, entry = http_call(a_port, f"/v1/kv?prefix={digest}")
    status2, _, reply = http_call(b_port, "/v1/kv", entry, method="PUT")
    prefix_wall = time.monotonic() - t0
    check(status == status2 == 200 and reply["rows"] == HTTP_SYSTEMS[0],
          f"http kv: the prefix ship answered {status}, {status2} {reply}")
    hit = systems[0] + rng.randint(0, VOCAB, 40).tolist()
    got = http_continue([b_port, a_port], [dict(tokens=hit,
                                                max_new_tokens=8)] * 2)
    check(b.stats()["prefix_hits"] == hits + 1
          and got[0]["tokens"] == got[1]["tokens"],
          f"http kv: B's hit on the shipped entry: hits "
          f"{b.stats()['prefix_hits'] - hits}, tokens {got[0]['tokens']} vs "
          f"A's {got[1]['tokens']}")
    mb = nbytes / 1e6
    print(f"http kv: {len(base)} held legs ({mb:.1f} MB) shipped A → B over "
          f"HTTP at {wall * 1e3 / mb:.3f} ms per MB (GET + PUT); B's "
          f"continuations = A's own, bit for bit; the "
          f"{HTTP_SYSTEMS[0]}-token prefix entry ({len(entry) / 1e6:.1f} MB) "
          f"shipped and installed in {prefix_wall * 1e3:.1f} ms and hit on "
          f"B; 404, 409 and 429 with Retry-After as the reference answers "
          f"[{SMI}]", flush=True)
    return {"kv_ms_per_mb": wall * 1e3 / mb, "mb": mb,
            "prefix_ms": prefix_wall * 1e3,
            "gate": (base, [u["tokens"] for u in unbroken],
                     [leg["tokens"] + c["tokens"]
                      for leg, c in zip(legs, on_b)]),
            "rids_a": [r["request_id"] for r in unbroken + legs + got[1:]]
            + [c["request_id"] for c in on_a],
            "rids_b": [c["request_id"] for c in on_b] + [got[0]["request_id"]]}


def peer_bytes() -> float:
    """The bytes peer restores have read so far (``oim_checkpoint_bytes_
    total{op="restore-peer"}``)."""
    from oim_tpu_torch.checkpoint.manager import _CKPT_BYTES

    return _CKPT_BYTES.value("restore-peer")


def weight_chunk_count(engine) -> int:
    """The bounce-buffer copies one ``GET /v1/weights`` of ``engine``
    makes."""
    from oim_tpu_torch.models.weights import jax_leaves
    from oim_tpu_torch.serve.server import WEIGHTS_BOUNCE_BYTES

    n = 0
    for leaf in jax_leaves(engine.params, engine.cfg):
        for part in leaf.parts:
            t = part()
            n += -(-t.numel() * t.element_size() // WEIGHTS_BOUNCE_BYTES)
    return n


def http_weights(a_port: int, a, args) -> tuple[dict, object]:
    """C restores from A over ``/v1/weights`` (under its own census: the
    stream's only waits are its bounce-buffer copies), bit-equal to A's
    parameters, then installs A's two hottest prefix entries
    (``prewarm_from_peer``, as ``--prefix-prewarm 2`` does).  Records
    the stream's GB/s beside reading the same weights from a
    ``--params-dir`` export (written here, read warm from the page
    cache).  Returns (the record, C)."""
    from oim_tpu_torch.checkpoint import load_params_from_peer
    from oim_tpu_torch.checkpoint.manager import PARAMS, flatten_params
    from oim_tpu_torch.cli import serve_main
    from oim_tpu_torch.models.train import named_parameters
    from oim_tpu_torch.serve.disagg import prewarm_from_peer
    from oim_tpu_torch.serve.engine import Engine
    from oim_tpu_torch.serve.server import WEIGHTS_BOUNCE_BYTES

    url = f"http://127.0.0.1:{a_port}"
    chunks = weight_chunk_count(a)
    moved = peer_bytes()
    with SyncCensus(a, weight_chunks=chunks) as census:
        t0 = time.monotonic()
        params = load_params_from_peer(url, a.cfg, a.device)
        torch.cuda.current_stream().synchronize()  # the copies up, landed
        wall = time.monotonic() - t0
    waits = census.check("http weights")
    nbytes = peer_bytes() - moved
    theirs, ours = dict(named_parameters(a.params)), dict(
        named_parameters(params))
    check(theirs.keys() == ours.keys() and all(
        ours[k].dtype == v.dtype and torch.equal(ours[k], v)
        for k, v in theirs.items()),
        "http weights: C's parameters differ from A's")
    c = Engine(params, a.cfg, n_slots=a.n_slots, max_len=a.max_len,
               chunk=a.chunk, kv_block=a.kv_block,
               prefix_cache_size=a.prefix_cache_size, device=a.device)
    hottest = [e["digest"] for e in a.prefix_digest_summary()][:2]
    installed = prewarm_from_peer(c, url, 2)
    resident = [e["digest"] for e in c.prefix_digest_summary()]
    check(installed == 2 and sorted(resident) == sorted(hottest),
          f"http weights: prewarm installed {installed}: {resident} of A's "
          f"hottest {hottest}")
    work = tempfile.mkdtemp(prefix=".smoke-ckpt-http-", dir=HERE)
    try:
        export = os.path.join(work, "export")
        os.makedirs(export)
        torch.save({k: v.float().cpu() for k, v in flatten_params(
            a.params).items()}, os.path.join(export, PARAMS))
        dir_args = serve_main.build_parser().parse_args(
            http_args() + ["--params-dir", export])
        t0 = time.monotonic()
        loaded = serve_main.load_weights(dir_args, a.cfg, a.device)
        torch.cuda.synchronize()
        dir_wall = time.monotonic() - t0
        del loaded
    finally:
        shutil.rmtree(work, ignore_errors=True)
    gb = nbytes / 1e9
    print(f"http weights: C restored from A over GET /v1/weights, {gb:.2f} "
          f"GB in {wall:.2f} s = {gb / wall:.2f} GB/s ({chunks} copies "
          f"through one pinned {WEIGHTS_BOUNCE_BYTES >> 20} MiB buffer, the "
          f"census's only waits), "
          f"bit-equal to A's parameters; the same weights from a "
          f"--params-dir export (f32, read warm from the page cache) took "
          f"{dir_wall:.2f} s; prewarm installed A's two hottest prefix "
          f"entries [{SMI}]", flush=True)
    return {"gb": gb, "seconds": wall, "gb_s": gb / wall,
            "params_dir_seconds": dir_wall, "census": waits,
            "prewarmed": installed}, c


def http_stall(server, a_port: int, a) -> dict:
    """A second watchdog whose floor and multiplier any device wait
    exceeds, while the step thread is held inside an admission's wait:
    the in-flight requests end with 503, kind "stalled", and
    ``Retry-After``; ``/healthz`` reads 503, then 200 once the wait
    returns; ``oim_serve_stalls_total`` moves by the verdicts."""
    from oim_tpu_torch.common import metrics
    from oim_tpu_torch.serve.server import StallWatchdog

    stalls = metrics.SERVE_STALLS.value(a._engine_label)
    wedged, go = threading.Event(), threading.Event()
    begin = a._watch_begin

    def wedge():
        begin()
        wedged.set()
        go.wait(60)

    a._watch_begin = wedge
    wd = StallWatchdog(a, on_stall=server._on_stall,
                       on_clear=server._on_stall_clear, interval=0.05,
                       multiplier=HTTP_STALL_MULT,
                       floor_s=HTTP_STALL_FLOOR).start()
    results = []
    threads = [threading.Thread(target=lambda i=i: results.append(http_call(
        a_port, "/v1/generate", {"tokens": list(range(1, 65 + i)),
                                 "max_new_tokens": 32})))
        for i in range(2)]
    try:
        for t in threads:
            t.start()
        check(wedged.wait(60), "http stall: no device wait began")
        for t in threads:
            t.join(60)
        sick = http_call(a_port, "/healthz")[0]
    finally:
        del a._watch_begin
        go.set()
    t0 = time.monotonic()
    while http_call(a_port, "/healthz")[0] != 200:
        check(time.monotonic() - t0 < 10, "http stall: /healthz stays 503")
        time.sleep(0.01)
    wd.stop()
    codes = sorted((r[0], "stall" in r[2].get("error", ""),
                    1 <= int(r[1].get("Retry-After", 0)) <= 120)
                   for r in results)
    check(codes == [(503, True, True)] * 2 and sick == 503,
          f"http stall: replies {codes}, /healthz {sick}")
    moved = metrics.SERVE_STALLS.value(a._engine_label) - stalls
    check(moved == wd.stalls >= 1,
          f"http stall: stalls_total moved {moved} for {wd.stalls} verdicts")
    print(f"http stall: {wd.stalls} verdict(s) while the step thread was "
          f"held in a device wait; both in-flight requests 503 'stalled' "
          f"with Retry-After, /healthz 503 then 200 once the wait returned "
          f"[{SMI}]", flush=True)
    return {"verdicts": wd.stalls}


def http_observed(servers, rids: dict) -> dict:
    """``/metrics`` is Prometheus text with the serving and checkpoint
    families; ``/debugz`` and ``/debugz/requests`` are JSON with every
    request of the phase in the ring; ``/v1/info``'s ``load`` is
    ``engine.load()`` plus the pool."""
    import re

    status, headers, text = http_call(servers["A"].port, "/metrics")
    text = text.decode()
    check(status == 200 and headers["Content-Type"].startswith(
        "text/plain; version=0.0.4"), f"http observe: /metrics {status}")
    for line in text.splitlines():
        check(not line or line.startswith("# ") or re.fullmatch(
            r"[a-zA-Z_:][\w:]*(\{[^}]*\})? \S+", line) is not None,
              f"http observe: not exposition text: {line!r}")
    for family in ("oim_serve_requests_total", "oim_serve_tokens_total",
                   "oim_serve_stalls_total", "oim_serve_shed_total",
                   "oim_serve_e2e_seconds", "oim_serve_kv_blocks",
                   "oim_checkpoint_seconds", "oim_checkpoint_bytes_total"):
        check(f"# TYPE {family} " in text,
              f"http observe: /metrics lacks {family}")
    found = 0
    for name, server in servers.items():
        port, engine = server.port, server.engine
        debugz = http_call(port, "/debugz")[2]
        check({"generated_at", "pid", "events"} <= set(debugz),
              f"http observe {name}: /debugz {set(debugz)}")
        ring = {e["rid"]: e for e in http_call(port, "/debugz/requests")[2][
            "requests"]}
        for rid, outcome in rids[name].items():
            check(rid in ring and ring[rid]["outcome"] == outcome,
                  f"http observe {name}: rid {rid} "
                  f"{ring.get(rid, {}).get('outcome')} not {outcome}")
            found += 1
        # The snapshot reads the clock twice over: ``ts`` and each prefix
        # digest's ``age_s`` (rounded to 0.1 s).  So the HTTP read is
        # bracketed by two direct ones: every other key equals both, and
        # each clock reading lies between theirs.
        before = dict(engine.load(), pool=server.pool)
        info = http_call(port, "/v1/info")[2]
        after = dict(engine.load(), pool=server.pool)
        fixed = [clockless(s) for s in (before, info["load"], after)]
        diff = sorted(k for k in fixed[1][0]
                      if fixed[1][0][k] != fixed[0][0].get(k))
        check(fixed[0][0] == fixed[1][0] == fixed[2][0]
              and info["pool"] == server.pool
              and all(lo <= mid <= hi for lo, mid, hi in zip(
                  fixed[0][1], fixed[1][1], fixed[2][1])),
              f"http observe {name}: /v1/info's load is not load() + pool "
              f"(keys {diff} differ; clocks {fixed[0][1]} <= "
              f"{fixed[1][1]} <= {fixed[2][1]} expected)")
    return {"ring_checked": found}


def clockless(load: dict) -> tuple[dict, list]:
    """A load snapshot split into what is not a clock reading and its
    clock readings in order: ``ts``, then each digest's ``age_s``."""
    digests = [{k: v for k, v in d.items() if k != "age_s"}
               for d in load["prefix_digests"]]
    clocks = [load["ts"]] + [d["age_s"] for d in load["prefix_digests"]]
    return dict({k: v for k, v in load.items() if k != "ts"},
                prefix_digests=digests), clocks


def http_phase() -> dict:
    """The HTTP surfaces a router drives, at Qwen2.5-1.5B's widths: two
    port servers A and B (B on A's weights) and an engine C restored from
    A over ``/v1/weights``; the smoke plays the router's part with the
    port's own ship clients.  Legs: token streaming, a client
    disconnect, a migrate-out drain with slot shipping, KV and prefix
    shipping with the faults, the weights, and a stall; then the
    observation routes.  Across the phase, as the kv io phase: K1 and
    K2 launched by route as the servers' passes and dispatches say
    (continuations included), no plain call, every dispatch a graph
    replay and none captured after warmup, no device wait beyond the
    engines' own, the exports' and the weight copies' (``SyncCensus``),
    A's default watchdog silent, no block left in either tier, and the
    memory back under 1 GiB."""
    from oim_tpu_torch.cli import serve_main
    from oim_tpu_torch.ops import paged_attention as pa
    from oim_tpu_torch.serve.engine import Engine
    from oim_tpu_torch.serve.server import ServeServer

    t0 = time.monotonic()
    args = serve_main.build_parser().parse_args(http_args())
    a = serve_main.make_engine(args).warmup()
    b = Engine(a.params, a.cfg, n_slots=args.n_slots, max_len=args.max_len,
               chunk=args.chunk, kv_block=args.kv_block,
               prefix_cache_size=args.prefix_cache,
               kv_host_bytes=args.kv_host_bytes, device=a.device).warmup()
    ref = widened(a.params, a.cfg)
    # A's watchdog: the reference's defaults, polled every 50 ms.
    servers = {"A": ServeServer(a, watchdog_interval=0.05).start(),
               "B": ServeServer(b).start()}
    a_port, b_port = servers["A"].port, servers["B"].port
    print(f"http: servers A (watchdog every 50 ms, multiplier 8, floor 10 "
          f"s) and B, {args.n_slots} slots, {a.kv_blocks} blocks of "
          f"{args.kv_block}, host tier {a.stats()['kv_host_blocks_total']} "
          f"blocks, warmed in {time.monotonic() - t0:.1f} s", flush=True)
    engines = {"A": a, "B": b}
    c = None
    try:
        before = {name: e.stats() for name, e in engines.items()}
        pa.reset_counters()
        with SyncCensus([a, b]) as census:
            out = {"stream": http_streams(a_port, a)}
            out["disconnect"] = http_disconnect(a_port, a)
            out["drain"] = http_drain(a_port, b_port, a, b)
            out["kv"] = http_kv(a_port, b_port, a, b)
        out["census"] = census.check("http legs")
        for leg in ("drain", "kv"):
            out[leg]["unbroken"] = kv_gate(ref, f"http {leg}",
                                           *out[leg].pop("gate"))
            print(f"http {leg}: {out[leg]['unbroken']['equal']} of "
                  f"{out[leg]['unbroken']['of']} whole streams "
                  f"token-identical to the unbroken runs, the rest parting "
                  f"at a near tie (the largest gap "
                  f"{out[leg]['unbroken']['worst_gap']:.3f})", flush=True)
        counts = pa.counters()
        after = {name: e.stats() for name, e in engines.items()}
        out["weights"], c = http_weights(a_port, a, args)
        check(servers["A"].watchdog.stalls == 0,
              f"http: A's default watchdog gave "
              f"{servers['A'].watchdog.stalls} verdicts")
        out["stall"] = http_stall(servers["A"], a_port, a)
        rids = {"A": {r: "ok" for r in out["drain"]["rids_a"][:4]
                      + out["kv"]["rids_a"]},
                "B": {r: "ok" for r in out["drain"]["rids_b"]
                      + out["kv"]["rids_b"]}}
        rids["A"].update({r: "migrated" for r in out["drain"]["rids_a"][4:]})
        for stream in out["stream"].values():
            rids["A"].update({r: "ok" for r in stream.pop("rids")})
        out["observed"] = http_observed(servers, rids)
    finally:
        for server in servers.values():
            server.stop()
    layers = a.cfg.n_layers
    passes = dispatches = 0
    for name in engines:
        s, s0 = after[name], before[name]
        d = {k: s[k] - s0[k] for k in (
            "decode_passes", "decode_dispatches", "graph_replays",
            "prefill_dispatches", "admission_replays")}
        passes += d["decode_passes"]
        dispatches += d["prefill_dispatches"]
        check(d["graph_replays"] == d["decode_dispatches"] > 0
              and d["admission_replays"] == d["prefill_dispatches"] > 0,
              f"http {name}: not every dispatch a replay: {d}")
        check(s["admission_graphs"] == s0["admission_graphs"]
              and s["graph_capture_seconds"] == s0["graph_capture_seconds"],
              f"http {name}: a graph captured after warmup")
    check(counts["paged_flash_decode_rows8"] == layers * passes
          and counts["paged_kv_store_t1"] == layers * passes
          and counts["paged_flash_decode_tc"] == layers * dispatches
          and counts["paged_kv_store"] - counts["paged_kv_store_t1"]
          == layers * dispatches,
          f"http: K1/K2 launches {counts} != {layers} x ({passes} decode "
          f"passes, {dispatches} admission dispatches)")
    check(counts["paged_flash_decode_plain"] == 0
          and counts["paged_kv_store_plain"] == 0
          and counts["paged_flash_decode_rows16"] == 0,
          f"http: a plain version or another route ran: {counts}")
    for name, engine in (("A", a), ("B", b), ("C", c)):
        kv_no_leaks(engine, name)
    out["counts"] = counts
    out["seconds"] = time.monotonic() - t0
    print(f"http: K1/K2 {counts} over {passes} decode passes and "
          f"{dispatches} admission dispatches of A and B, every one a graph "
          f"replay, no plain call, no capture after warmup, device waits "
          f"{out['census']['waits']} all the engines', the exports' and the "
          f"weight copies', no block left in either tier; the phase took "
          f"{out['seconds']:.1f} s [{SMI}]", flush=True)
    # The census and the last server of the loop above hold engines too.
    del a, b, c, engine, engines, ref, servers, server, census
    release()
    check(torch.cuda.memory_allocated() < 2**30,
          f"the http phase still holds "
          f"{gib(torch.cuda.memory_allocated()):.1f} GiB")
    return out


# ---------------------------------------------------------------------------
# Front phase: the operator's front door (text, OpenAI, mTLS, profiling,
# the recompile sentinel, the kernel switch, the daemon's init)

FRONT_ARGS = SERVE_ARGS + ["--kv-block", "16"]
FRONT_TEXT_BYTES = (128, 256, 384, 512)
FRONT_NEW = 128
FRONT_SAMPLED = (0.8, 77)  # temperature, seed of the n = 2 completions
FRONT_SWITCH_PROMPTS = (128, 176, 224, 272, 320, 368, 416, 512)
# A 0.5 s capture: the tracer's stop and export hold the interpreter
# about 20-30 s a second of capture (PERF.md §6).
FRONT_PROFILE_PROMPTS, FRONT_PROFILE_NEW = (128, 192, 256, 320), 768
FRONT_PROFILE_S = 0.5
# Qwen2.5's <|endoftext|>, the stand-in tokenizer's EOS.
QWEN_EOS = 151643


class ByteTokenizer:
    """A byte-level stand-in for ``TextTokenizer`` (the card's machine
    serves without an HF tokenizer directory): text is its UTF-8 bytes,
    one id a byte; an id decodes to one byte, ids past 255 folded into
    bytes, so that the model's random ids split characters across
    tokens; the EOS is skipped as a special token; the chat template
    joins the contents.  Its stream decoder is the port's own."""

    path = "byte-level stand-in"
    eos_id = QWEN_EOS

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids) -> str:
        return bytes(i % 256 for i in ids if i != QWEN_EOS).decode(
            "utf-8", errors="replace")

    def apply_chat_template(self, messages) -> list[int]:
        return self.encode("".join(m["content"] for m in messages))

    def stream_decoder(self):
        from oim_tpu_torch.serve.texttok import StreamDecoder

        return StreamDecoder(self)


def front_text(rng, n: int) -> str:
    """``n`` bytes of ASCII text."""
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz .,", np.uint8)
    return bytes(rng.choice(letters, n)).decode()


def sse_events(port: int, path: str, body: dict, opener=None,
               scheme: str = "http") -> tuple[list, float]:
    """The SSE payloads of one streamed OpenAI call (``[DONE]`` as the
    string) and the wall to the first, in ms."""
    req = urllib.request.Request(
        f"{scheme}://127.0.0.1:{port}{path}",
        data=json.dumps(dict(body, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    out, first = [], None
    t0 = time.monotonic()
    with (opener or urllib.request.urlopen)(req, timeout=600) as resp:
        check(resp.headers["Content-Type"] == "text/event-stream",
              f"front sse: headers {dict(resp.headers)}")
        for raw in resp:
            line = raw.decode().strip()
            if line.startswith("data: "):
                if first is None:
                    first = (time.monotonic() - t0) * 1e3
                payload = line[len("data: "):]
                out.append(payload if payload == "[DONE]"
                           else json.loads(payload))
    return out, first


def front_text_leg(port: int, a, tok) -> dict:
    """Text prompts beside the same ids, each request alone (one shape):
    equal tokens, ``text`` the decode of the tokens, the NDJSON text
    deltas joined the final text.  Records the lone 512-byte prompt's
    plain TTFT and first NDJSON line."""
    rng = np.random.RandomState(41)
    out = {}
    for n in FRONT_TEXT_BYTES:
        text = front_text(rng, n)
        by_text = http_ok(port, {"text": text, "max_new_tokens": FRONT_NEW})
        by_ids = http_ok(port, {"tokens": tok.encode(text),
                                "max_new_tokens": FRONT_NEW,
                                "eos_id": QWEN_EOS})
        lines = []
        first = http_stream(port, {"text": text,
                                   "max_new_tokens": FRONT_NEW}, lines)
        done = lines[-1]
        streamed = "".join(ln["text"] for ln in lines[:-1]) + done.get(
            "text", "")
        check(by_text["tokens"] == by_ids["tokens"] == done["tokens"],
              f"front text {n}: text and token prompts differ")
        check(by_text["text"] == by_ids["text"] == streamed
              == tok.decode(by_text["tokens"]),
              f"front text {n}: the text is not the decode of the tokens, "
              f"or the NDJSON deltas do not join to it")
        out[n] = {"first_line_ms": first,
                  "plain_ttft_ms": ttft_ms(ring_entry(
                      a, by_text["request_id"])),
                  "tokens": by_text["tokens"], "text": text}
    return out


def front_openai_leg(port: int, engine, texts: dict, tok) -> dict:
    """``/v1/completions``: n = 2 sampled choices, each ``/v1/generate``
    with seed s + i (or parting from it at a near tie: the two choices
    admit as one two-row dispatch, the generate alone); a stop string
    from a greedy reply's own text cuts it by the reference's rule with
    ``usage`` unchanged; SSE deltas join to the non-streamed text, one
    ``[DONE]``.  ``/v1/chat/completions``, streamed and not, equals
    ``/v1/completions`` on the rendered prompt.  Records the first SSE
    chunk's latency; returns the sampled choices' gate inputs
    (``kv_gate``, taken after the census)."""
    temp, seed = FRONT_SAMPLED
    text = texts[256]["text"]
    body = {"prompt": text, "max_tokens": 64, "temperature": temp,
            "seed": seed, "n": 2}
    # The choices carry text, which the stand-in's decode folds: the
    # tokens behind each are read off the engine's results as the
    # handler takes them.
    taken = {}
    result = engine.result

    def recording(rid, *args, **kw):
        out = result(rid, *args, **kw)
        taken[rid] = list(out)
        return out

    engine.result = recording
    try:
        status, _, reply = http_call(port, "/v1/completions", body)
    finally:
        vars(engine).pop("result", None)
    check(status == 200 and [c["index"] for c in reply["choices"]] == [0, 1]
          and 0 < reply["usage"]["completion_tokens"] <= 128,
          f"front completions n=2: {status} {reply}")
    first = int(reply["id"].rsplit("-", 1)[1])
    reqs, wants, gots = [], [], []
    for i, choice in enumerate(reply["choices"]):
        native = http_ok(port, {"text": text, "max_new_tokens": 64,
                                "temperature": temp, "seed": seed + i})
        got = taken[first + i]
        check(choice["text"] == tok.decode(got),
              f"front completions: choice {i}'s text is not its decode")
        reqs.append({"tokens": tok.encode(text), "temperature": temp,
                     "seed": seed + i})
        wants.append(native["tokens"])
        gots.append(got)
    greedy = {"prompt": texts[512]["text"], "max_tokens": 64,
              "temperature": 0.0}
    full = http_call(port, "/v1/completions", greedy)[2]
    whole = full["choices"][0]["text"]
    mid = len(whole) // 2
    stop = whole[mid:mid + 2]
    cut = http_call(port, "/v1/completions", dict(greedy, stop=stop))[2]
    check(cut["choices"][0]["text"] == whole[:whole.find(stop)]
          and cut["choices"][0]["finish_reason"] == "stop"
          and cut["usage"] == full["usage"],
          f"front completions: stop {stop!r} cut {cut['choices'][0]!r}")
    events_, first_sse = sse_events(port, "/v1/completions", greedy)
    check(events_.count("[DONE]") == 1 and events_[-1] == "[DONE]"
          and "".join(e["choices"][0]["text"] for e in events_[:-1])
          == whole, "front completions: the SSE deltas differ")
    chat_body = {"messages": [{"role": "user", "content": texts[512][
        "text"]}], "max_tokens": 64, "temperature": 0.0}
    chat = http_call(port, "/v1/chat/completions", chat_body)[2]
    chat_events, _ = sse_events(port, "/v1/chat/completions", chat_body)
    check(chat["choices"][0]["message"]["content"] == whole
          and chat["usage"] == full["usage"]
          and "".join(e["choices"][0]["delta"].get("content", "")
                      for e in chat_events[:-1]) == whole
          and chat_events[-1] == "[DONE]",
          "front chat: not the completion of the rendered prompt")
    for refused in ({"stop": "x"}, {"n": 2}):
        status, _, _ = http_call(port, "/v1/completions", dict(
            greedy, stream=True, **refused))
        check(status == 400, f"front completions: stream with {refused} "
              f"answered {status}")
    return {"gate": (reqs, wants, gots), "stop": stop,
            "first_sse_ms": first_sse}


def make_certs(work: str) -> dict:
    """A CA and certificates for ``serve.a``, ``user.t1`` and
    ``controller.x``, and an evil CA with its own ``user.t1``, made with
    ``openssl`` in ``work``: {name: (ca, cert, key)}."""
    import subprocess

    ext = os.path.join(work, "leaf.cnf")
    with open(ext, "w") as f:
        f.write("basicConstraints=CA:FALSE\nkeyUsage=digitalSignature\n"
                "extendedKeyUsage=serverAuth,clientAuth\n")
    ec = ["-newkey", "ec", "-pkeyopt", "ec_paramgen_curve:prime256v1",
          "-nodes"]

    def run(*cmd):
        proc = subprocess.run(["openssl", *cmd], cwd=work,
                              capture_output=True, text=True)
        check(proc.returncode == 0, f"openssl {cmd[0]}: {proc.stderr}")

    for ca in ("good", "evil"):
        run("req", "-x509", *ec, "-keyout", f"{ca}-ca.key", "-out",
            f"{ca}-ca.crt", "-subj", f"/CN={ca} CA", "-days", "2")
    out = {}
    for name, ca, cn in (("serve.a", "good", "serve.a"),
                         ("user.t1", "good", "user.t1"),
                         ("controller.x", "good", "controller.x"),
                         ("evil", "evil", "user.t1")):
        run("req", *ec, "-keyout", f"{name}.key", "-out", f"{name}.csr",
            "-subj", f"/CN={cn}")
        run("x509", "-req", "-in", f"{name}.csr", "-CA", f"{ca}-ca.crt",
            "-CAkey", f"{ca}-ca.key", "-CAcreateserial", "-out",
            f"{name}.crt", "-days", "2", "-extfile", ext)
        out[name] = tuple(os.path.join(work, f) for f in (
            "good-ca.crt", f"{name}.crt", f"{name}.key"))
    return out


def front_tls_leg(a, a2, a_port: int, tls_port: int, tls_server,
                  certs: dict) -> dict:
    """Server A' (A's weights) over mTLS: a ``user.t1`` client gets A's
    tokens and is the ring entry's tenant whatever ``x-oim-tenant`` says;
    certless and evil-CA clients fail the handshake (counted);
    ``controller.x`` gets 403; ``load_params_from_peer`` over https
    restores A''s parameters bit for bit.  Records ``/v1/weights`` GB/s
    over TLS against plain HTTP, and a stream's first line over both."""
    import ssl

    from oim_tpu_torch.checkpoint import load_params_from_peer
    from oim_tpu_torch.models.train import named_parameters
    from oim_tpu_torch.serve import httptls

    def client(name):
        ca, crt, key = certs[name]
        return httptls.client_ssl_context(ca, crt, key)

    def tls_call(context, body, headers=None):
        req = urllib.request.Request(
            f"https://127.0.0.1:{tls_port}/v1/generate",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json", **(headers or {})})
        with httptls.opener(context).open(req, timeout=600) as resp:
            return json.loads(resp.read())

    rng = np.random.RandomState(43)
    body = {"tokens": rng.randint(0, VOCAB, 512).tolist(),
            "max_new_tokens": 64}
    plain = http_ok(a_port, body)
    got = tls_call(client("user.t1"), body,
                   {"x-oim-tenant": "premium-forged"})
    check(got["tokens"] == plain["tokens"],
          "front tls: A' over mTLS differs from A")
    check(ring_entry(a2, got["request_id"])["tenant"] == "user.t1",
          "front tls: the tenant is not the peer's CN")
    before = tls_server._httpd.handshake_failures
    for context in (httptls.client_ssl_context(certs["user.t1"][0]),
                    client("evil")):
        try:
            tls_call(context, body)
            check(False, "front tls: a client without a good cert served")
        except (ssl.SSLError, urllib.error.URLError, OSError):
            pass
    deadline = time.monotonic() + 10
    while (tls_server._httpd.handshake_failures < before + 2
           and time.monotonic() < deadline):
        time.sleep(0.01)
    check(tls_server._httpd.handshake_failures == before + 2,
          f"front tls: {tls_server._httpd.handshake_failures - before} "
          f"handshake failures counted, not 2")
    try:
        tls_call(client("controller.x"), body)
        check(False, "front tls: controller.x served")
    except urllib.error.HTTPError as exc:
        check(exc.code == 403, f"front tls: controller.x got {exc.code}")
    # A stream's first line over mTLS against plain HTTP.
    firsts = {}
    for scheme, port, opener in (
            ("http", a_port, None),
            ("https", tls_port, httptls.opener(client("user.t1")).open)):
        req = urllib.request.Request(
            f"{scheme}://127.0.0.1:{port}/v1/generate",
            data=json.dumps(dict(body, stream=True)).encode(),
            headers={"Content-Type": "application/json"})
        t0 = time.monotonic()
        with (opener or urllib.request.urlopen)(req, timeout=600) as resp:
            resp.readline()
            firsts[scheme] = (time.monotonic() - t0) * 1e3
            resp.read()
    # The weights over both.
    rates = {}
    theirs = dict(named_parameters(a2.params))
    for scheme, port, context in (("http", a_port, None),
                                  ("https", tls_port, client("user.t1"))):
        t0 = time.monotonic()
        params = load_params_from_peer(f"{scheme}://127.0.0.1:{port}",
                                       a2.cfg, a2.device,
                                       ssl_context=context)
        torch.cuda.current_stream().synchronize()
        wall = time.monotonic() - t0
        ours = dict(named_parameters(params))
        check(ours.keys() == theirs.keys() and all(
            ours[k].dtype == v.dtype and torch.equal(ours[k], v)
            for k, v in theirs.items()),
            f"front tls: weights over {scheme} differ from A''s")
        nbytes = sum(v.numel() * v.element_size() for v in theirs.values())
        rates[scheme] = {"seconds": wall, "gb_s": nbytes / 1e9 / wall}
        del params, ours
    print(f"front tls: A' over mTLS serves user.t1 A's tokens as tenant "
          f"user.t1 (a forged x-oim-tenant ignored); a certless and an "
          f"evil-CA client failed the handshake (2 counted); controller.x "
          f"403; weights over https {rates['https']['gb_s']:.2f} GB/s "
          f"against {rates['http']['gb_s']:.2f} over http, bit-equal; a "
          f"512-token stream's first line {firsts['https']:.1f} ms over "
          f"mTLS, {firsts['http']:.1f} ms plain [{SMI}]", flush=True)
    return {"weights": rates, "first_line_ms": firsts}


def front_traffic(port: int, seed: int) -> tuple[list, list]:
    """Eight greedy requests at once (one a slot), then a lone 512-token
    prompt: (the eight requests' GenRequest bodies and token lists, the
    lone prompt's client TTFT in ms as the last item)."""
    rng = np.random.RandomState(seed)
    bodies = [{"tokens": rng.randint(0, VOCAB, n).tolist(),
               "max_new_tokens": FRONT_NEW}
              for n in FRONT_SWITCH_PROMPTS]
    with ThreadPoolExecutor(len(bodies)) as pool:
        replies = list(pool.map(lambda b: http_ok(port, b), bodies))
    t0 = time.monotonic()
    http_ok(port, {"tokens": rng.randint(0, VOCAB, 512).tolist(),
                   "max_new_tokens": 1})
    return bodies, [r["tokens"] for r in replies] + [
        (time.monotonic() - t0) * 1e3]


def front_switch_leg(servers: dict, engines: dict) -> dict:
    """Engine K (the defaults: the kernels) and engine P (both switches
    off), one weights copy, both graphed at depth 2, serve the same eight
    concurrent requests and a lone 512-token prompt, K then P.  Gates: K's K1/K2 launches by route are its layers x passes, P
    launches neither and runs the plain versions as many times, every
    dispatch of both a replay, the greedy tokens equal or parting at a
    near tie (``kv_gate`` on the returned inputs, after the census),
    ``load()`` each engine's path.  Records each run's decode tok/s and
    lone-512 TTFT."""
    from oim_tpu_torch.ops import paged_attention as pa

    runs, tokens = [], {}
    totals = {name: dict.fromkeys(pa.counters(), 0) for name in "KP"}
    for name in "KP":
        engine = engines[name]
        s0 = engine.stats()
        pa.reset_counters()
        bodies, got = front_traffic(servers[name].port, 51)
        counts = pa.counters()
        s = engine.stats()
        d = {k: s[k] - s0[k] for k in (
            "decode_passes", "decode_dispatches", "graph_replays",
            "prefill_dispatches", "admission_replays", "decode_tokens",
            "decode_seconds")}
        rate = d["decode_tokens"] / max(d["decode_seconds"], 1e-9)
        runs.append({"engine": name, "decode_tok_s": rate,
                     "lone_512_ttft_ms": got[-1]})
        tokens.setdefault(name, got[:-1])
        check(d["graph_replays"] == d["decode_dispatches"] > 0
              and d["admission_replays"] == d["prefill_dispatches"] > 0,
              f"front switch {name}: not every dispatch a replay: {d}")
        layers = engine.cfg.n_layers
        if name == "K":
            check(counts["paged_flash_decode_rows8"]
                  == counts["paged_kv_store_t1"]
                  == layers * d["decode_passes"]
                  and counts["paged_flash_decode_tc"]
                  == counts["paged_kv_store"] - counts["paged_kv_store_t1"]
                  == layers * d["prefill_dispatches"]
                  and counts["paged_flash_decode_plain"]
                  == counts["paged_kv_store_plain"] == 0,
                  f"front switch K: {counts} over {d}")
        else:
            passes = d["decode_passes"] + d["prefill_dispatches"]
            check(counts["paged_flash_decode"] == counts["paged_kv_store"]
                  == 0 and counts["paged_flash_decode_plain"]
                  == counts["paged_kv_store_plain"] == layers * passes,
                  f"front switch P: {counts} over {d}")
        for k, v in counts.items():
            totals[name][k] += v
    check(tokens["K"] and len(tokens["K"]) == len(tokens["P"]),
          "front switch: runs missing")
    for name, want in (("K", (True, True)), ("P", (False, False))):
        load = engines[name].load()
        check((load["paged_kernel"], load["prefill_kernel"]) == want,
              f"front switch {name}: load() reports {load['paged_kernel']}, "
              f"{load['prefill_kernel']}")
    rate = {n: [r["decode_tok_s"] for r in runs if r["engine"] == n]
            for n in "KP"}
    ttft = {n: [r["lone_512_ttft_ms"] for r in runs if r["engine"] == n]
            for n in "KP"}
    print("front switch: K P decode "
          + ", ".join(f"{r['decode_tok_s']:.1f}" for r in runs)
          + " tok/s, lone-512 TTFT "
          + ", ".join(f"{r['lone_512_ttft_ms']:.1f}" for r in runs)
          + f" ms; K launched K1/K2 by route as its passes say, P the plain "
          f"versions only, every dispatch a replay [{SMI}]", flush=True)
    return {"runs": runs, "gate": (bodies, tokens["K"], tokens["P"]),
            "counts": totals, "decode_tok_s": rate,
            "lone_512_ttft_ms": ttft}


def front_decode_rate(port: int, engine, seed: int) -> float:
    """The engine's decode tok/s over four concurrent 256-token requests
    (its own counters)."""
    rng = np.random.RandomState(seed)
    s0 = engine.stats()
    with ThreadPoolExecutor(4) as pool:
        list(pool.map(lambda n: http_ok(port, {
            "tokens": rng.randint(0, VOCAB, n).tolist(),
            "max_new_tokens": 256}), (128, 192, 256, 320)))
    s = engine.stats()
    return ((s["decode_tokens"] - s0["decode_tokens"])
            / max(s["decode_seconds"] - s0["decode_seconds"], 1e-9))


def front_profile_leg(port: int, engine) -> dict:
    """Four greedy streams on A, first unprofiled, then again with a
    2 s ``POST /debugz/profile`` taken in their middle: a second POST
    gets 409, the status is polled until done, the download's tarball
    holds a Chrome trace naming the step thread's kernels or its graph
    launches (which is recorded); returns the profiled and unprofiled
    streams for ``kv_gate``.  Records the decode rate the
    clients saw inside the window against before and after it."""
    import io
    import tarfile

    rng = np.random.RandomState(47)
    bodies = [{"tokens": rng.randint(0, VOCAB, n).tolist(),
               "max_new_tokens": FRONT_PROFILE_NEW}
              for n in FRONT_PROFILE_PROMPTS]

    def streams(stamps):
        def one(body):
            lines = []
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/generate",
                data=json.dumps(dict(body, stream=True)).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as resp:
                for raw in resp:
                    if raw.strip():
                        lines.append(json.loads(raw))
                        stamps.append(time.time())
            return lines[-1]["tokens"]
        with ThreadPoolExecutor(len(bodies)) as pool:
            return list(pool.map(one, bodies))

    # A first capture, alone: it pays the tracer's start-up (reported as
    # init_s), so that the measured one's window is the card's work.
    status, _, reply = http_call(port, "/debugz/profile", {"seconds": 0.05})
    check(status == 202, f"front profile: the first POST answered {status}")
    while True:
        first_doc = http_call(port, "/debugz/profile")[2]["profile"]
        if first_doc["state"] != "running":
            break
        time.sleep(0.02)
    check(first_doc["state"] == "done", f"front profile: {first_doc}")
    shutil.rmtree(first_doc["dir"], ignore_errors=True)
    os.remove(first_doc["tar"])
    quiet = streams([])
    before = front_decode_rate(port, engine, 61)
    stamps, window = [], {}

    def profile():
        try:
            capture()
        except BaseException as exc:  # re-raised on the leg's thread
            window["error"] = exc

    def capture():
        while len(stamps) < 400:  # the streams are decoding
            time.sleep(0.005)
        status, _, reply = http_call(port, "/debugz/profile",
                                     {"seconds": FRONT_PROFILE_S})
        check(status == 202, f"front profile: POST answered {status}")
        status, _, _ = http_call(port, "/debugz/profile", {"seconds": 1})
        check(status == 409, f"front profile: a second POST got {status}")
        deadline = time.monotonic() + 300
        while True:
            doc = http_call(port, "/debugz/profile")[2]["profile"]
            if doc["state"] != "running":
                break
            check(time.monotonic() < deadline,
                  f"front profile: the capture still runs after 300 s: {doc}")
            time.sleep(0.02)
        window["doc"] = doc

    watcher = threading.Thread(target=profile)
    watcher.start()
    loud = streams(stamps)
    watcher.join()
    if "error" in window:
        raise window["error"]
    doc = window["doc"]
    check(doc["state"] == "done", f"front profile: {doc}")
    status, _, raw = http_call(port, "/debugz/profile?download=1")
    check(status == 200, f"front profile: download answered {status}")
    with tarfile.open(fileobj=io.BytesIO(raw), mode="r:gz") as tar:
        member = next(m for m in tar.getmembers()
                      if m.name.endswith("trace.json"))
        trace = json.loads(tar.extractfile(member).read())
    cats: dict = {}
    for e in trace["traceEvents"]:
        cats[str(e.get("cat"))] = cats.get(str(e.get("cat")), 0) + 1
    names = {str(e.get("name", "")) for e in trace["traceEvents"]}
    kernels = sorted(n for n in names if "paged_" in n and "kernel" in n)
    launches = sum(e.get("name") == "cudaGraphLaunch"
                   for e in trace["traceEvents"])
    cpu_ops = sorted(n for n in names if n.startswith("aten::"))[:5]
    first = min(stamps)
    ends = {"window_s": [round(t - first, 3) for t in doc["window_ts"]],
            "streams_end_s": round(max(stamps) - first, 3),
            "init_s": (first_doc["init_s"], doc["init_s"])}
    print(f"front profile: the trace holds {len(trace['traceEvents'])} "
          f"events by category {cats}; some names "
          f"{sorted(names)[:12]}; {ends}", flush=True)

    def rate(t0, t1):
        # The stamps are the streams' lines at the client: one a token.
        return sum(t0 <= t < t1 for t in stamps) / max(t1 - t0, 1e-9)

    t0, t1 = doc["window_ts"]
    span = FRONT_PROFILE_S
    done = doc["done_ts"]
    rates = {"before": rate(t0 - span, t0), "inside": rate(t0, t1),
             "stop_export": rate(t1, done),
             "engine_before": before,
             "engine_after": front_decode_rate(port, engine, 61)}
    check(rates["engine_after"] >= 0.9 * before,
          f"front profile: decode after the capture {rates['engine_after']:.1f}"
          f" tok/s, before it {before:.1f}: the tracer stayed on")
    shutil.rmtree(doc["dir"], ignore_errors=True)
    os.remove(doc["tar"])
    print(f"front profile: a {doc['seconds']:g} s torch.profiler capture "
          f"({doc['tar_bytes']} bytes) during 4 streams, a second POST "
          f"409; its trace names {len(kernels)} paged kernels "
          f"({', '.join(kernels[:3])}) and {launches} cudaGraphLaunch "
          f"calls, CPU ops like {cpu_ops[:3]}; "
          f"the clients read {rates['before']:.1f} tok/s before the "
          f"window, {rates['inside']:.1f} inside it ({t1 - t0:.2f} s: the "
          f"tracer's stop included), {rates['stop_export']:.1f} while the "
          f"trace was written ({done - t1:.2f} s); the engine decoded "
          f"{before:.1f} tok/s on four 256-token requests before the "
          f"capture, {rates['engine_after']:.1f} after it; the tracer's "
          f"start-up {first_doc['init_s']:.2f} s at the first capture, "
          f"{doc['init_s']:.2f} s at this one [{SMI}]", flush=True)
    return {"kernels_named": kernels, "graph_launches": launches,
            "cpu_ops": cpu_ops, "categories": cats,
            "init_s": [first_doc["init_s"], doc["init_s"]],
            "gate": (bodies, quiet, loud), "tok_s": rates}


def front_sentinel_leg(a, make_sibling) -> tuple[dict, object]:
    """An engine that skipped warmup, armed by hand; a sibling warms
    meanwhile (its captures counted, fired against no one); then the
    cold engine serves one request, and its first dispatch's captures
    fire ``serve.recompile`` with that request's admission context, its
    ``recompiles`` and the compile counter moving by their number.
    Returns (the record, the sibling)."""
    from oim_tpu_torch.common import events, metrics
    from oim_tpu_torch.serve import sentinel
    from oim_tpu_torch.serve.engine import Engine, GenRequest

    cold = Engine(a.params, a.cfg, n_slots=a.n_slots, max_len=a.max_len,
                  chunk=a.chunk, kv_block=a.kv_block, device=a.device)
    sentinel.arm(cold)

    since = time.time()

    def fired(label=None):
        """The serve.recompile events since the leg began (of engine
        ``label``; every armed engine gets one a capture)."""
        return [e for e in events.all_events() if e.kind == "serve.recompile"
                and e.ts >= since and label in (None, e.subject)]

    already = len(fired())
    compiles = metrics.XLA_COMPILES.value()
    sibling = make_sibling()
    sibling_captures = len(sibling._admit_graphs) + len(sibling._graphs
                                                        or {})
    check(len(fired()) == already == 0 and cold.recompiles == 0
          and metrics.XLA_COMPILES.value() == compiles + sibling_captures,
          f"front sentinel: the sibling's warmup fired "
          f"{len(fired()) - already} events, counted "
          f"{metrics.XLA_COMPILES.value() - compiles} captures of "
          f"{sibling_captures}")
    compiles = metrics.XLA_COMPILES.value()
    rid = cold.submit(GenRequest(tokens=list(range(1, 200)),
                                 max_new_tokens=16))
    cold.run()
    check(len(cold.result(rid, timeout=0)) == 16, "front sentinel: reply")
    captures = len(cold._admit_graphs) + len(cold._graphs or {})
    new = fired(cold._engine_label)
    check(len(new) == captures == cold.recompiles
          == metrics.XLA_COMPILES.value() - compiles > 0
          and all(e.fields.get("phase") == "admit"
                  and e.fields.get("rids") == (rid,) for e in new),
          f"front sentinel: {len(new)} events for {captures} captures, "
          f"recompiles {cold.recompiles}, contexts "
          f"{[e.fields for e in new[:2]]}")
    seconds = sum(e.fields["duration_s"] for e in new)
    sentinel.disarm(cold)
    kv_no_leaks(cold, "front sentinel")
    others = len(fired()) - len(new)
    print(f"front sentinel: a sibling warmed in the armed process: "
          f"{sibling_captures} captures counted, no event; the unwarmed "
          f"engine's first dispatch captured {captures} graphs in "
          f"{seconds:.2f} s, each a serve.recompile WARNING naming rid "
          f"{rid} in its admission (and {others} for the other armed "
          f"engines of the process, charged as the reference charges "
          f"them) [{SMI}]", flush=True)
    return {"sibling_captures": sibling_captures, "captures": captures,
            "capture_seconds": seconds}, sibling


def front_mixed_leg(mixed, server) -> dict:
    """The mixed engine (decode on the kernels, admissions plain): K1's
    decode route and K2 at t = 1 on every decode pass, K1's tall route
    never, the plain versions once a layer an admission dispatch."""
    from oim_tpu_torch.ops import paged_attention as pa

    s0 = mixed.stats()
    pa.reset_counters()
    bodies, got = front_traffic(server.port, 51)  # the switch's traffic
    counts = pa.counters()
    s = mixed.stats()
    layers = mixed.cfg.n_layers
    passes = s["decode_passes"] - s0["decode_passes"]
    admits = s["prefill_dispatches"] - s0["prefill_dispatches"]
    check(counts["paged_flash_decode_rows8"] == counts["paged_flash_decode"]
          == counts["paged_kv_store"] == counts["paged_kv_store_t1"]
          == layers * passes and counts["paged_flash_decode_tc"] == 0
          and counts["paged_flash_decode_plain"]
          == counts["paged_kv_store_plain"] == layers * admits,
          f"front mixed: {counts} over {passes} passes, {admits} admissions")
    load = mixed.load()
    check((load["paged_kernel"], load["prefill_kernel"]) == (True, False),
          f"front mixed: load() reports {load['paged_kernel']}, "
          f"{load['prefill_kernel']}")
    print(f"front mixed: decode on K1's decode route and K2 at t=1 "
          f"({counts['paged_flash_decode_rows8']} launches = {layers} x "
          f"{passes} passes), admissions plain ({admits} dispatches); "
          f"lone-512 TTFT {got[-1]:.1f} ms [{SMI}]", flush=True)
    return {"counts": counts, "lone_512_ttft_ms": got[-1],
            "tokens": got[:-1]}


def front_daemon_leg() -> dict:
    """``serve_main`` as its own process on the card with
    ``--trace-file``, ``--log-level debug`` and ``--paged-kernel on``,
    two requests: the trace file holds a ``serve.generate`` span a
    request with the engine's phase spans under it, ``/metrics`` carries
    ``oim_process_*``, the log is at debug level; then a
    ``MetricsServer`` here on port 0 serves ``/metrics`` and
    ``/debugz``."""
    import re
    import signal
    import subprocess

    from oim_tpu_torch.common import metrics

    import oim_tpu_torch

    root = os.path.dirname(os.path.dirname(oim_tpu_torch.__file__))
    work = tempfile.mkdtemp(prefix=".smoke-front-", dir=HERE)
    trace = os.path.join(work, "spans.jsonl")
    argv = [sys.executable, "-m", "oim_tpu_torch.cli.serve_main",
            *FRONT_ARGS, "--trace-file", trace, "--log-level", "debug",
            "--paged-kernel", "on", "--watchdog-interval", "0",
            "--drain-timeout", "0"]
    env = dict(os.environ, PYTHONPATH=root, OIM_FLIGHT_DIR=work)
    t0 = time.monotonic()
    proc = subprocess.Popen(argv, cwd=root, env=env, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    lines, listening = [], threading.Event()

    def read():  # stderr to its end, the listening line flagged
        for line in proc.stderr:
            lines.append(line)
            if re.search(r"oim-serve listening .* port=(\d+)", line):
                listening.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        listening.wait(300)
        match = next((re.search(r"oim-serve listening .* port=(\d+)", ln)
                      for ln in lines if "oim-serve listening" in ln), None)
        check(match is not None, "front daemon: serve_main never listened: "
              + "".join(lines[-5:]))
        port = int(match.group(1))
        up = time.monotonic() - t0
        rng = np.random.RandomState(59)
        for n in (256, 512):
            http_ok(port, {"tokens": rng.randint(0, VOCAB, n).tolist(),
                           "max_new_tokens": 32})
        _, _, scrape = http_call(port, "/metrics")
        info = http_call(port, "/v1/info")[2]["engine"]
        proc.send_signal(signal.SIGTERM)
        check(proc.wait(timeout=60) == 0, "front daemon: exit code")
        reader.join(timeout=10)
        spans = [json.loads(ln) for ln in open(trace) if ln.strip()]
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        proc.stderr.close()
        shutil.rmtree(work, ignore_errors=True)
    text = "".join(lines)
    check(b"oim_process_resident_bytes" in scrape
          and b"oim_process_cpu_seconds" in scrape,
          "front daemon: /metrics lacks the process families")
    check(info["paged_kernel"] is True and info["attention"]
          == "cuda-kernels", f"front daemon: engine {info}")
    check(" I warming up " in text and " I drained " in text,
          f"front daemon: log lines {text[-400:]}")
    generate = [s for s in spans if s["name"] == "serve.generate"]
    check(len(generate) == 2, f"front daemon: {len(generate)} serve.generate "
          f"spans")
    for root in generate:
        request = [s for s in spans if s["name"] == "engine.request"
                   and s["parent_id"] == root["span_id"]]
        check(len(request) == 1, "front daemon: engine.request missing")
        phases = {s["name"] for s in spans
                  if s["parent_id"] == request[0]["span_id"]}
        check({"engine.queue", "engine.prefill", "engine.decode"} <= phases,
              f"front daemon: phases {phases}")
    server = metrics.MetricsServer("127.0.0.1:0").start()
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/metrics", timeout=10).read()
        doc = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/debugz", timeout=10).read())
    finally:
        server.stop()
    check(b"oim_process_threads" in body and "events" in doc,
          "front daemon: MetricsServer")
    print(f"front daemon: serve_main --trace-file --log-level debug "
          f"--paged-kernel on listened after {up:.1f} s; 2 requests, "
          f"{len(spans)} spans (serve.generate > engine.request > phases), "
          f"/metrics with oim_process_*, a MetricsServer on port 0 "
          f"[{SMI}]", flush=True)
    return {"listen_s": up, "spans": len(spans)}


def front_phase() -> dict:
    """The operator's front door at Qwen2.5-1.5B's widths (``--kv-block
    16``, 8 slots, max_len 2048): server A with a byte-level stand-in
    tokenizer, A' over mTLS, engine P with both kernel switches off and
    a mixed engine, all on one copy of A's weights, and ``serve_main``
    as its own process.  Legs: text and the OpenAI surfaces, mTLS, the
    kernel switch's A/B (K = A, then P), an on-demand profile, the
    recompile sentinel, the mixed engine, the daemon's init.  Path
    gates: K1/K2 launched by route as A's and A''s passes and
    dispatches say with no plain call, the plain versions only on P and
    the mixed engine, every dispatch a replay and nothing captured after
    warmup outside the sentinel leg (``oim_xla_compiles_total`` still),
    no device wait beyond the engines' own and the weight copies'
    (``SyncCensus`` over the text, OpenAI, mTLS and switch legs), no
    block left, and the memory back under 1 GiB."""
    from oim_tpu_torch.cli import serve_main
    from oim_tpu_torch.common import metrics
    from oim_tpu_torch.ops import paged_attention as pa
    from oim_tpu_torch.serve import httptls, sentinel
    from oim_tpu_torch.serve.engine import Engine
    from oim_tpu_torch.serve.server import ServeServer

    t0 = time.monotonic()
    base = torch.cuda.memory_allocated()
    sentinel.install()  # before any of the phase's engines warms
    args = serve_main.build_parser().parse_args(FRONT_ARGS)
    a = serve_main.make_engine(args).warmup()
    kw = dict(n_slots=args.n_slots, max_len=args.max_len, chunk=args.chunk,
              kv_block=args.kv_block, device=a.device)
    a2 = Engine(a.params, a.cfg, **kw).warmup()
    p = Engine(a.params, a.cfg, **kw, paged_kernel=False,
               prefill_kernel=False).warmup()
    warm_compiles = metrics.XLA_COMPILES.value()
    ref = widened(a.params, a.cfg)
    tok = ByteTokenizer()
    certs_dir = tempfile.mkdtemp(prefix=".smoke-tls-", dir=HERE)
    mixed, servers, deferred = None, {}, []
    try:
        certs = make_certs(certs_dir)
        servers.update({
            "K": ServeServer(a, tokenizer=tok).start(),
            "TLS": ServeServer(a2, ssl_context=httptls.server_ssl_context(
                *certs["serve.a"])).start(),
            "P": ServeServer(p).start(),
        })
        engines = {"K": a, "TLS": a2, "P": p}
        print(f"front: A (a byte-level stand-in tokenizer), A' (mTLS) and "
              f"P (both kernel switches off) on one weights copy, "
              f"{args.n_slots} slots, {a.kv_blocks} blocks of "
              f"{args.kv_block}, warmed in {time.monotonic() - t0:.1f} s "
              f"(P's graph capture {p.stats()['graph_capture_seconds']:.1f}"
              f" s, A's {a.stats()['graph_capture_seconds']:.1f} s)",
              flush=True)
        before = {n: e.stats() for n, e in engines.items()}
        out = {}
        pa.reset_counters()
        chunks = weight_chunk_count(a) + weight_chunk_count(a2)
        with SyncCensus([a, a2], weight_chunks=chunks) as census:
            out["text"] = front_text_leg(servers["K"].port, a, tok)
            out["openai"] = front_openai_leg(servers["K"].port, a,
                                             out["text"], tok)
            out["tls"] = front_tls_leg(a, a2, servers["K"].port,
                                       servers["TLS"].port, servers["TLS"],
                                       certs)
        out["census"] = census.check("front legs")
        out["openai"]["sampled"] = kv_gate(ref, "front completions n=2",
                                           *out["openai"].pop("gate"))
        counts = pa.counters()
        after = {n: engines[n].stats() for n in ("K", "TLS")}
        layers = a.cfg.n_layers
        passes = dispatches = 0
        for n in ("K", "TLS"):
            s, s0 = after[n], before[n]
            d = {k: s[k] - s0[k] for k in (
                "decode_passes", "decode_dispatches", "graph_replays",
                "prefill_dispatches", "admission_replays")}
            passes += d["decode_passes"]
            dispatches += d["prefill_dispatches"]
            check(d["graph_replays"] == d["decode_dispatches"] > 0
                  and d["admission_replays"] == d["prefill_dispatches"] > 0,
                  f"front {n}: not every dispatch a replay: {d}")
        check(counts["paged_flash_decode_rows8"] == layers * passes
              and counts["paged_kv_store_t1"] == layers * passes
              and counts["paged_flash_decode_tc"] == layers * dispatches
              and counts["paged_kv_store"] - counts["paged_kv_store_t1"]
              == layers * dispatches
              and counts["paged_flash_decode_plain"] == 0
              and counts["paged_kv_store_plain"] == 0
              and counts["paged_flash_decode_rows16"] == 0,
              f"front: K1/K2 launches {counts} != {layers} x ({passes} "
              f"decode passes, {dispatches} admission dispatches), or a "
              f"plain call")
        out["counts"] = counts
        lone = out["text"][max(FRONT_TEXT_BYTES)]
        print(f"front text: {len(FRONT_TEXT_BYTES)} text prompts equal to "
              f"their ids, text = the decode, NDJSON deltas joined = the "
              f"text; the lone 512-byte prompt's plain TTFT "
              f"{lone['plain_ttft_ms']:.1f} ms (engine), its first NDJSON "
              f"line {lone['first_line_ms']:.1f} ms, the first SSE chunk "
              f"{out['openai']['first_sse_ms']:.1f} ms (clients); "
              f"completions n=2 {out['openai']['sampled']['equal']} of 2 "
              f"equal to generate with seed s+i, a stop string "
              f"{out['openai']['stop']!r} cut by the reference's rule, SSE "
              f"and chat equal [{SMI}]", flush=True)
        with SyncCensus([a, p]) as census:
            out["switch"] = front_switch_leg(servers, engines)
        try:
            out["switch_census"] = census.check("front switch")
        except SmokeFailure as exc:  # raised at the phase's end
            print(f"front: failed, raised at the phase's end: {exc}",
                  flush=True)
            deferred.append(exc)
        # Outside the census: the profiler's stop waits for the card (on
        # the profile's thread, not the step loop).
        out["profile"] = front_profile_leg(servers["K"].port, a)
        if not (out["profile"]["kernels_named"]
                or out["profile"]["graph_launches"]):
            exc = SmokeFailure("front profile: the trace names neither the "
                               "step thread's kernels nor its graph launches")
            print(f"front: failed, raised at the phase's end: {exc}",
                  flush=True)
            deferred.append(exc)
        bodies, tokens_k, tokens_p = out["switch"].pop("gate")
        out["switch"]["gate"] = kv_gate(ref, "front switch", bodies,
                                        tokens_k, tokens_p)
        out["profile"]["gate"] = kv_gate(ref, "front profile",
                                         *out["profile"].pop("gate"))
        print(f"front switch: K and P {out['switch']['gate']['equal']} of "
              f"{out['switch']['gate']['of']} greedy streams equal, the "
              f"largest near-tie gap {out['switch']['gate']['worst_gap']:.3f};"
              f" profiled streams {out['profile']['gate']['equal']} of "
              f"{out['profile']['gate']['of']} equal to the unprofiled run",
              flush=True)
        for n, e in engines.items():
            s = e.stats()
            check(s["admission_graphs"] == before[n]["admission_graphs"]
                  and s["graph_capture_seconds"]
                  == before[n]["graph_capture_seconds"]
                  and s["recompiles"] == 0,
                  f"front {n}: a graph captured after warmup")
        check(metrics.XLA_COMPILES.value() == warm_compiles,
              f"front: oim_xla_compiles_total moved after warmup by "
              f"{metrics.XLA_COMPILES.value() - warm_compiles}")

        def make_mixed():
            return Engine(a.params, a.cfg, **kw, paged_kernel=True,
                          prefill_kernel=False).warmup()

        out["sentinel"], mixed = front_sentinel_leg(a, make_mixed)
        servers["M"] = ServeServer(mixed).start()
        settled = metrics.XLA_COMPILES.value()
        out["mixed"] = front_mixed_leg(mixed, servers["M"])
        check(metrics.XLA_COMPILES.value() == settled,
              "front mixed: a capture after warmup")
        out["mixed"]["gate"] = kv_gate(ref, "front mixed", bodies, tokens_k,
                                       out["mixed"].pop("tokens"))
    finally:
        for server in servers.values():
            server.stop()
        shutil.rmtree(certs_dir, ignore_errors=True)
    for n, e in (("A", a), ("A'", a2), ("P", p), ("M", mixed)):
        kv_no_leaks(e, f"front {n}")
    out["daemon"] = front_daemon_leg()
    out["seconds"] = time.monotonic() - t0
    if deferred:
        raise deferred[0]
    print(f"front: the phase took {out['seconds']:.1f} s, device waits "
          f"{out['census']['waits']} and {out['switch_census']['waits']} "
          f"all the engines' own, nothing captured after warmup outside "
          f"the sentinel leg, no block left [{SMI}]", flush=True)
    # The loops' last engine (e) and server hold engines too.
    del a, a2, p, mixed, engines, servers, ref, census, e, server
    release()
    check(torch.cuda.memory_allocated() - base < 2**30,
          f"the front phase still holds "
          f"{gib(torch.cuda.memory_allocated() - base):.1f} GiB")
    return out


# ---------------------------------------------------------------------------
# Train-kernel phase


def rel_err(got, want) -> tuple[float, float]:
    """(max |got - want|, that over max |want|), in f32."""
    err = float((got.float() - want.float()).abs().max())
    return err, err / max(float(want.float().abs().max()), 1e-30)


def attended_pairs(b, h, t, window, segments) -> int:
    """(query, key) pairs the causal attention of these inputs attends,
    over every batch row and head: what the kernels must compute."""
    from oim_tpu_torch.ops.flash_attention import _keep

    keep = _keep(t, True, window, segments, DEV)
    per_row = keep.sum(dim=(-2, -1))  # [B or 1, 1]
    return int(per_row.sum()) * h * (b if keep.shape[0] == 1 else 1)


def flash_bound(q, k, pairs, flops_per_pair, n_in, n_out):
    """Least time for one flash kernel: ``n_in`` q-sized or k-sized
    tensors read and ``n_out`` written once (``n_in``/``n_out`` as
    (q-like, k-like, per-row f32) counts), and ``flops_per_pair`` per
    attended (query, key) pair at the inputs' dtype peak."""
    rows = q.shape[0] * q.shape[2] * q.shape[1]  # B * H * T lse rows
    moved = ((n_in[0] + n_out[0]) * q.numel() * q.element_size()
             + (n_in[1] + n_out[1]) * k.numel() * k.element_size()
             + (n_in[2] + n_out[2]) * rows * 4)
    return bound(moved, flops_per_pair * pairs, q.dtype)


def flash_case(gen, dtype, t, window, segmented, b=TRAIN_B):
    """Inputs at the training shape: q, k, v, dout [b, t, heads, 128],
    and packed segment ids (a document boundary about every 100
    tokens) or None."""
    shape_q, shape_k = (b, t, H, HD), (b, t, KVH, HD)
    q, do = (torch.randn(shape_q, generator=gen, device=DEV).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(shape_k, generator=gen, device=DEV).to(dtype)
            for _ in range(2))
    seg = None
    if segmented:
        starts = torch.rand((b, t), generator=gen, device=DEV) < 0.01
        seg = torch.cumsum(starts.int(), dim=1, dtype=torch.int32)
    return q, k, v, do, seg


def check_flash(tag, q, k, v, do, window, seg) -> dict:
    """Each flash kernel against its plain version on these inputs;
    returns the max abs errors by kernel."""
    from oim_tpu_torch.ops import flash_attention as fa

    tol = TRAIN_TOL[q.dtype]
    out, lse = fa.flash_fwd(q, k, v, True, window, seg)
    ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, True, window, seg)
    delta = fa.flash_delta(ref_out, do)
    bwd = (q, k, v, do, ref_lse, delta, True, window, seg)
    dq = fa.flash_dq(*bwd)
    ref_dq = fa.flash_dq_plain(*bwd)
    dk, dv = fa.flash_dkv(*bwd)
    ref_dk, ref_dv = fa.flash_dkv_plain(*bwd)
    torch.cuda.synchronize()
    errs = {}
    for name, got, want in (("flash_fwd", out, ref_out),
                            ("flash_fwd lse", lse, ref_lse),
                            ("flash_dq", dq, ref_dq),
                            ("flash_dkv dk", dk, ref_dk),
                            ("flash_dkv dv", dv, ref_dv)):
        check(bool(torch.isfinite(got).all()), f"{name} {tag} non-finite")
        err, rel = rel_err(got, want)
        # lse is f32 in both dtypes.
        limit = TRAIN_TOL[torch.float32] if name.endswith("lse") else tol
        print(f"{name} {tag}: max_abs_err={err:.3e} rel={rel:.3e} "
              f"(tol {limit:.3e} of max)", flush=True)
        check(rel <= limit, f"{name} {tag} disagrees: {rel:.3e} of max")
        key = name.split()[0]
        errs[key] = max(errs.get(key, 0.0), err)
    return errs


def flash_determinism(bwd) -> None:
    """Two launches of the forward, of dq and of dkv on the same inputs
    give the same bits: no float atomics, every sum in a fixed order
    (the checkpoint phase's bit-equal resume relies on it)."""
    from oim_tpu_torch.ops import flash_attention as fa

    fwd = (*bwd[:3], *bwd[6:])  # q, k, v, causal, window, segments
    first = fa.flash_fwd(*fwd) + (fa.flash_dq(*bwd),) + fa.flash_dkv(*bwd)
    again = fa.flash_fwd(*fwd) + (fa.flash_dq(*bwd),) + fa.flash_dkv(*bwd)
    torch.cuda.synchronize()
    same = [bool(torch.equal(a, b)) for a, b in zip(first, again)]
    print(f"flash determinism bf16 B={TRAIN_B} T={TRAIN_T}: two launches "
          f"bit-equal out/lse/dq/dk/dv {same}", flush=True)
    check(all(same), f"flash kernels differ between launches: {same}")


def dkv_split_times(bwd, pairs) -> None:
    """flash_dkv's time at the main path's case for each split of the
    group of H / KVH q heads, beside the split dkv_split chooses."""
    from oim_tpu_torch.ops import _build
    from oim_tpu_torch.ops import flash_attention as fa

    q = bwd[0]
    group = H // KVH
    chosen = fa.dkv_split(TRAIN_B * KVH, group, TRAIN_T,
                          _build.sm_count(q.device))
    times = {}
    for split in (d for d in range(1, group + 1) if group % d == 0):
        times[split] = time_ms(lambda: fa.flash_dkv(*bwd, split=split))
    print(f"flash_dkv bf16 by split (chosen {chosen}): "
          + ", ".join(f"split {s_} {ms:.4f} ms "
                      f"({8 * HD * pairs / ms / 1e9:.1f} TFLOP/s)"
                      for s_, ms in times.items()) + f" [{SMI}]",
          flush=True)


def train_kernel_phase() -> dict:
    """RMSNorm at [4096, 1536] and the three flash kernels at the training
    shape, held against their plain versions (f32 and bf16; window 256,
    packed segments, a ragged T = 1000), then timed at the main path's
    case (bf16, T = 1024, no window, no segments); returns the record
    per kernel."""
    import torch.nn.functional as F

    from oim_tpu_torch.ops import flash_attention as fa
    from oim_tpu_torch.ops import rmsnorm as rn

    gen = torch.Generator(device=DEV).manual_seed(1)
    record = {}
    # -- RMSNorm: every x/w dtype pair; the main path's is bf16 x, f32 w.
    rows = TRAIN_B * TRAIN_T
    for xdt in (torch.float32, torch.bfloat16):
        for wdt in (torch.float32, torch.bfloat16):
            x = torch.randn((rows, D_MODEL), generator=gen,
                            device=DEV).to(xdt)
            w = (torch.rand(D_MODEL, generator=gen, device=DEV)
                 + 0.5).to(wdt)
            got = rn.rmsnorm_fwd(x, w, 1e-6)
            want = rn.rmsnorm_plain(x, w, 1e-6)
            torch.cuda.synchronize()
            err, rel = rel_err(got, want)
            tag = f"x {str(xdt)[6:]} w {str(wdt)[6:]} [{rows}, {D_MODEL}]"
            print(f"rmsnorm {tag}: max_abs_err={err:.3e} rel={rel:.3e} "
                  f"(tol {TRAIN_TOL[xdt]:.3e} of max)", flush=True)
            check(got.dtype == xdt, f"rmsnorm {tag}: output {got.dtype}")
            check(rel <= TRAIN_TOL[xdt], f"rmsnorm {tag} disagrees: {rel}")
            if xdt == torch.bfloat16 and wdt == torch.float32:
                ms = time_ms(lambda: rn.rmsnorm_fwd(x, w, 1e-6))
                plain_ms = time_ms(lambda: rn.rmsnorm_plain(x, w, 1e-6))
                wl = w.to(xdt)
                lib_ms = time_ms(lambda: F.rms_norm(x, (D_MODEL,), wl, 1e-6))
                moved = 2 * x.numel() * x.element_size() + w.numel() * 4
                bnd, by = bound(moved, 4 * x.numel(), torch.float32)
                print(f"rmsnorm {tag}: {ms:.4f} ms (plain {plain_ms:.4f}, "
                      f"F.rms_norm {lib_ms:.4f}, bound {bnd:.5f} by {by}; "
                      f"{ms / lib_ms:.2f}x F.rms_norm, {bnd / ms:.0%} of the "
                      f"byte bound) [{SMI}]", flush=True)
                again = rn.rmsnorm_fwd(x, w, 1e-6)
                check(torch.equal(again, got),
                      f"rmsnorm {tag}: two launches give other bits")
                record["rmsnorm"] = dict(max_abs_err=err, ms=ms,
                                         plain_ms=plain_ms, bound_ms=bnd,
                                         bound_by=by, library_ms=lib_ms)
    # -- Flash: correctness over the variants, then the main path's case.
    for dtype in (torch.float32, torch.bfloat16):
        for t, window, segmented in ((TRAIN_T, 0, False), (TRAIN_T, 256, False),
                                     (TRAIN_T, 0, True), (1000, 256, True)):
            tag = (f"{str(dtype)[6:]} T={t} window={window} "
                   f"segments={'packed' if segmented else 'none'}")
            case = flash_case(gen, dtype, t, window, segmented)
            check_flash(tag, *case[:4], window, case[4])
            del case
    q, k, v, do, _ = flash_case(gen, torch.bfloat16, TRAIN_T, 0, False)
    errs = check_flash("bf16 main path", q, k, v, do, 0, None)
    out, lse = fa.flash_fwd_plain(q, k, v, True, 0, None)
    delta = fa.flash_delta(out, do)
    bwd = (q, k, v, do, lse, delta, True, 0, None)
    pairs = attended_pairs(TRAIN_B, H, TRAIN_T, 0, None)
    # SDPA yardstick in its [B, H, T, hd] layout (transposed untimed).
    qh, kh, vh, doh = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    sdpa = F.scaled_dot_product_attention
    lib_fwd = time_ms(lambda: sdpa(qh, kh, vh, is_causal=True,
                                   enable_gqa=True))
    qg, kg, vg = (x.detach().requires_grad_() for x in (qh, kh, vh))
    out_g = sdpa(qg, kg, vg, is_causal=True, enable_gqa=True)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        out_g, (qg, kg, vg), doh, retain_graph=True))
    timed = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, True, 0, None),
                      lambda: fa.flash_fwd_plain(q, k, v, True, 0, None),
                      4 * HD, (1, 2, 0), (1, 0, 1), lib_fwd),
        "flash_dq": (lambda: fa.flash_dq(*bwd), lambda: fa.flash_dq_plain(*bwd),
                     6 * HD, (2, 2, 2), (1, 0, 0), lib_bwd),
        "flash_dkv": (lambda: fa.flash_dkv(*bwd),
                      lambda: fa.flash_dkv_plain(*bwd),
                      8 * HD, (2, 2, 2), (0, 2, 0), lib_bwd),
    }
    for name, (kernel, plain, flops, n_in, n_out, lib) in timed.items():
        ms = time_ms(kernel)
        plain_ms = time_ms(plain)
        bnd, by = flash_bound(q, k, pairs, flops, n_in, n_out)
        what = "SDPA forward" if name == "flash_fwd" else "SDPA backward"
        print(f"{name} bf16 B={TRAIN_B} T={TRAIN_T} H={H} KVH={KVH} "
              f"hd={HD}: {ms:.4f} ms (plain {plain_ms:.4f}, {what} "
              f"{lib:.4f}, bound {bnd:.5f} by {by}); "
              f"{flops * pairs / ms / 1e9:.1f} TFLOP/s, {ms / lib:.2f}x "
              f"{what} [{SMI}]", flush=True)
        record[name] = dict(max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                            bound_ms=bnd, bound_by=by, library_ms=lib)
    pair_ms = record["flash_dq"]["ms"] + record["flash_dkv"]["ms"]
    print(f"flash_dq + flash_dkv bf16: {pair_ms:.4f} ms, "
          f"{14 * HD * pairs / pair_ms / 1e9:.1f} TFLOP/s, "
          f"{pair_ms / lib_bwd:.2f}x SDPA backward [{SMI}]", flush=True)
    flash_determinism(bwd)
    dkv_split_times(bwd, pairs)
    del q, k, v, do, qh, kh, vh, doh, qg, kg, vg, out_g, out, lse, delta
    torch.cuda.empty_cache()
    return record


# ---------------------------------------------------------------------------
# Fused-CE kernel phase


# Operations of each fused-CE entry in units of N·D·V: the forward's
# scores (2); dx or dw alone, the scores then the product (4); the joint
# backward, the scores once then both products (6).
CE_OPS = {"fwd": 2, "dx": 4, "dw": 4, "bwd": 6}


def ce_bound(n: int, d: int, v: int, dtype, kind: str) -> tuple[float, str]:
    """Least time for one fused-CE entry on [n, d] x and [d, v] w of
    ``dtype``: x, w, labels (int32) and the per-row f32 inputs read once
    and the outputs written once; ``CE_OPS[kind]``·n·d·v operations."""
    e = torch.tensor([], dtype=dtype).element_size()
    inputs = (n * d + d * v) * e + 4 * n
    ops = CE_OPS[kind] * n * d * v
    if kind == "fwd":  # -> lse, target
        return bound(inputs + 2 * 4 * n, ops, dtype)
    inputs += 2 * 4 * n  # lse, g
    out = (n * d * e if kind in ("dx", "bwd") else 0) + (
        d * v * 4 if kind in ("dw", "bwd") else 0)
    return bound(inputs + out, ops, dtype)


def ce_case(gen, dtype, n, d=D_MODEL, v=VOCAB, masked_every=1024):
    """x [n, d] in ``dtype``, the f32 master w [d, v] cast to it, labels
    with the first and last columns among them, and the per-row
    cotangent the training loss gives (1 / n, zero on masked rows)."""
    x = torch.randn((n, d), generator=gen, device=DEV).to(dtype)
    w = (torch.randn((d, v), generator=gen, device=DEV) / d**0.5).to(dtype)
    labels = torch.randint(0, v, (n,), generator=gen, device=DEV)
    labels[0], labels[-1] = 0, v - 1
    g = torch.full((n,), 1.0 / n, device=DEV)
    g[masked_every - 1::masked_every] = 0.0
    return x, w, labels, g


def check_ce(tag, x, w, labels, g) -> dict:
    """The three fused-CE kernels against their plain versions on these
    inputs; returns the max abs errors by kernel."""
    from oim_tpu_torch.ops import fused_ce as fc

    lse, target = fc.fused_ce_fwd(x, w, labels)
    ref_lse, ref_target = fc.fused_ce_fwd_plain(x, w, labels)
    dx = fc.fused_ce_dx(x, w, labels, ref_lse, g)
    ref_dx = fc.fused_ce_dx_plain(x, w, labels, ref_lse, g)
    dw = fc.fused_ce_dw(x, w, labels, ref_lse, g)
    ref_dw = fc.fused_ce_dw_plain(x, w, labels, ref_lse, g)
    joint = fc.fused_ce_bwd(x, w, labels, ref_lse, g)
    torch.cuda.synchronize()
    check(dx.dtype == x.dtype and dw.dtype == torch.float32,
          f"fused_ce {tag}: dx {dx.dtype}, dw {dw.dtype}")
    same = [bool(torch.equal(a, b)) for a, b in zip(joint, (dx, dw))]
    print(f"fused_ce_bwd {tag} ({fc.route(x, w)} route): the joint "
          f"backward's dx and dw bit-equal to dx and dw launched apart: "
          f"{same}", flush=True)
    check(all(same), f"fused_ce_bwd {tag}: joint differs from apart {same}")
    del joint
    check(not bool(dx[g == 0].any()), f"fused_ce_dx {tag}: masked rows")
    errs = {}
    for name, got, want, limit in (
            ("fused_ce_fwd lse", lse, ref_lse, FUSED_CE_TOL["lse"]),
            ("fused_ce_fwd target", target, ref_target,
             FUSED_CE_TOL["target"]),
            ("fused_ce_dx", dx, ref_dx, FUSED_CE_TOL["dx"][x.dtype]),
            ("fused_ce_dw", dw, ref_dw, FUSED_CE_TOL["dw"])):
        check(bool(torch.isfinite(got).all()), f"{name} {tag} non-finite")
        err, rel = rel_err(got, want)
        print(f"{name} {tag}: max_abs_err={err:.3e} rel={rel:.3e} (tol "
              f"{limit:.3e} of max)", flush=True)
        check(rel <= limit, f"{name} {tag} disagrees: {rel:.3e} of max")
        key = name.split()[0]
        errs[key] = max(errs.get(key, 0.0), err)
    # The joint backward's outputs are dx's and dw's bits (checked above).
    errs["fused_ce_bwd"] = max(errs["fused_ce_dx"], errs["fused_ce_dw"])
    del ref_dx, ref_dw, dx, dw
    return errs


def unfused_ms(x, w, labels, g) -> tuple[float, float]:
    """(forward, backward) device ms of the path the fused kernels
    replace, as the trainer ran it without them: f32 logits from the
    compute-dtype operands, logsumexp and gather; then the f32 dlogits
    and the two f32 products dx and dw (timed only)."""
    xf, wf = x.float(), w.float()

    def fwd():
        logits = xf @ wf
        return (torch.logsumexp(logits, -1)
                - logits.gather(1, labels[:, None])[:, 0])

    logits = xf @ wf

    def bwd():
        d = torch.softmax(logits, -1) * g[:, None]
        d.scatter_add_(1, labels[:, None], -g[:, None])
        return d @ wf.T, xf.T @ d

    return time_ms(fwd), time_ms(bwd)


def ce_determinism(tag, x, w, labels, lse, g) -> None:
    """Two launches of the forward and of the joint backward on the same
    inputs give the same bits (no float atomics; sums in a fixed
    order)."""
    from oim_tpu_torch.ops import fused_ce as fc

    first = fc.fused_ce_fwd(x, w, labels) + fc.fused_ce_bwd(x, w, labels,
                                                            lse, g)
    again = fc.fused_ce_fwd(x, w, labels) + fc.fused_ce_bwd(x, w, labels,
                                                            lse, g)
    torch.cuda.synchronize()
    same = [bool(torch.equal(a, b)) for a, b in zip(first, again)]
    print(f"fused_ce determinism {tag}: two launches bit-equal "
          f"lse/target/dx/dw {same}", flush=True)
    check(all(same), f"fused-CE kernels differ between launches: {same}")


def fused_ce_phase() -> dict:
    """The fused-CE kernels at the training shape (N = 4096, D = 1536,
    V = 151936, bf16 x, the f32 master w cast to bf16: the wgmma route)
    and at a ragged N = 1000 in bf16 and f32 (the f32 case takes the
    mma.sync route), held against their plain versions; then timed at
    the training shape beside their bound, cuBLAS's bf16 ``x @ w`` (a
    rate yardstick: no one PyTorch call computes CE without logits) and
    the unfused path.  Returns the record per kernel: the forward, dx
    alone (a LoRA step's backward) and the joint backward (a full
    step's); dw alone runs on no path and is printed only."""
    from oim_tpu_torch.ops import fused_ce as fc

    gen = torch.Generator(device=DEV).manual_seed(2)
    n = TRAIN_B * TRAIN_T
    for dtype in (torch.bfloat16, torch.float32):
        case = ce_case(gen, dtype, 1000, masked_every=7)
        check_ce(f"{str(dtype)[6:]} N=1000 D={D_MODEL} V={VOCAB}", *case)
        del case
    x, w, labels, g = ce_case(gen, torch.bfloat16, n)
    tag = f"bf16 N={n} D={D_MODEL} V={VOCAB}"
    check(fc.route(x, w) == "wgmma", f"the training shape takes the "
          f"{fc.route(x, w)} route")
    before = fc.counters()
    errs = check_ce(tag, x, w, labels, g)
    after = fc.counters()
    check(after["fused_ce_wgmma"] - before["fused_ce_wgmma"] == 4
          and after["fused_ce_mma_sync"] == before["fused_ce_mma_sync"],
          f"fused-CE route counts at the training shape: {before} -> "
          f"{after}")
    lse, _ = fc.fused_ce_fwd_plain(x, w, labels)
    ce_determinism(tag, x, w, labels, lse, g)
    timed = {
        "fused_ce_fwd": (lambda: fc.fused_ce_fwd(x, w, labels),
                         lambda: fc.fused_ce_fwd_plain(x, w, labels)),
        "fused_ce_dx": (lambda: fc.fused_ce_dx(x, w, labels, lse, g),
                        lambda: fc.fused_ce_dx_plain(x, w, labels, lse, g)),
        "fused_ce_dw": (lambda: fc.fused_ce_dw(x, w, labels, lse, g),
                        lambda: fc.fused_ce_dw_plain(x, w, labels, lse, g)),
        "fused_ce_bwd": (lambda: fc.fused_ce_bwd(x, w, labels, lse, g),
                         lambda: fc.fused_ce_bwd_plain(x, w, labels, lse, g)),
    }
    nv = n * D_MODEL * VOCAB
    cublas = time_ms(lambda: x @ w)
    print(f"fused_ce {tag}: cuBLAS bf16 x @ w {cublas:.4f} ms, "
          f"{2 * nv / cublas / 1e9:.1f} TFLOP/s (yardstick of the rate) "
          f"[{SMI}]", flush=True)
    record = {}
    for name, (kernel, plain) in timed.items():
        kind = name.split("_")[-1]
        ms = time_ms(kernel)
        plain_ms = time_ms(plain, runs=5)
        bnd, by = ce_bound(n, D_MODEL, VOCAB, x.dtype, kind)
        print(f"{name} {tag}: {ms:.4f} ms, {CE_OPS[kind] * nv / ms / 1e9:.1f}"
              f" TFLOP/s (plain {plain_ms:.4f}, bound {bnd:.5f} by {by}; "
              f"{ms / cublas:.2f}x cuBLAS x @ w; no one PyTorch call) "
              f"[{SMI}]", flush=True)
        if kind == "dw":  # no path runs dw alone
            continue
        record[name] = dict(max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                            bound_ms=bnd, bound_by=by, library_ms=None)
    fwd_ms, bwd_ms = unfused_ms(x, w, labels, g)
    print(f"fused_ce {tag}: the unfused path (f32 logits; logsumexp and "
          f"gather; f32 dlogits, dx and dw products) takes {fwd_ms:.4f} ms "
          f"forward and {bwd_ms:.4f} ms backward [{SMI}]", flush=True)
    del x, w, labels, g, lse
    torch.cuda.empty_cache()
    return record


def digest(t) -> str:
    """The first 16 hex digits of a tensor's bytes' SHA-256."""
    import hashlib

    raw = t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


def compare_phase() -> dict:
    """RMSNorm at [4096, 1536] (bf16 x, f32 w) and the fused-CE entries
    at the training shape, on inputs drawn from fixed seeds, by whichever
    package is loaded (``--package``): digests of their outputs, so that
    two builds are compared bit for bit across runs; each entry's device
    time and the host's time to enqueue it; and a full step's fused-CE
    backward through ``fused_linear_ce``'s autograd (whatever backward
    the package runs there) at each of ``CE_CHUNKS`` columns a chunk."""
    from oim_tpu_torch.ops import fused_ce as fc
    from oim_tpu_torch.ops import rmsnorm as rn

    gen = torch.Generator(device=DEV).manual_seed(5)
    n = TRAIN_B * TRAIN_T
    x = torch.randn((n, D_MODEL), generator=gen,
                    device=DEV).to(torch.bfloat16)
    w = torch.rand(D_MODEL, generator=gen, device=DEV) + 0.5
    out = {"rmsnorm": rn.rmsnorm_fwd(x, w, 1e-6)}
    times = {"rmsnorm": time_ms(lambda: rn.rmsnorm_fwd(x, w, 1e-6))}
    host = {"rmsnorm": host_ms(lambda: rn.rmsnorm_fwd(x, w, 1e-6))}
    x, w, labels, g = ce_case(gen, torch.bfloat16, n)
    lse, target = fc.fused_ce_fwd(x, w, labels)
    out.update(fused_ce_lse=lse, fused_ce_target=target,
               fused_ce_dx=fc.fused_ce_dx(x, w, labels, lse, g),
               fused_ce_dw=fc.fused_ce_dw(x, w, labels, lse, g))
    xl, wl = x.detach().requires_grad_(), w.detach().requires_grad_()
    nll = fc.fused_linear_ce(xl, wl, labels)

    def step_backward():
        return torch.autograd.grad(nll, (xl, wl), g, retain_graph=True)

    entries = {"fused_ce_fwd": lambda: fc.fused_ce_fwd(x, w, labels),
               "fused_ce_dx": lambda: fc.fused_ce_dx(x, w, labels, lse, g),
               "fused_ce_dw": lambda: fc.fused_ce_dw(x, w, labels, lse, g),
               "full-step backward": step_backward}
    for name, fn in entries.items():
        times[name], host[name] = time_ms(fn, runs=10), host_ms(fn)
    default, columns = fc.SCRATCH_ELEMENTS, fc.chunk_columns(n, VOCAB)
    chunks = {}
    try:
        for c in CE_CHUNKS:
            fc.SCRATCH_ELEMENTS = c * n
            chunks[c] = time_ms(step_backward, runs=10)
    finally:
        fc.SCRATCH_ELEMENTS = default
    torch.cuda.synchronize()
    digests = {name: digest(t) for name, t in out.items()}
    print(f"compare: output digests {digests}", flush=True)
    print("compare: device " + ", ".join(f"{k} {v:.4f} ms"
                                         for k, v in times.items())
          + f" [{SMI}]", flush=True)
    print("compare: host enqueue " + ", ".join(f"{k} {v:.4f} ms"
                                               for k, v in host.items()),
          flush=True)
    print(f"compare: full-step backward by chunk width (default "
          f"{columns} columns): "
          + ", ".join(f"{c} {v:.4f} ms" for c, v in chunks.items())
          + f" [{SMI}]", flush=True)
    del x, w, labels, g, lse, target, out, xl, wl, nll
    torch.cuda.empty_cache()
    return {"digests": digests, "ms": times, "host_ms": host,
            "backward_ms_by_chunk": chunks}


# ---------------------------------------------------------------------------
# Train phase


def step_grads(params, tokens, cfg):
    """(first-step objective, gradient of every master tensor) of the
    training objective on ``tokens``."""
    from oim_tpu_torch.models.train import _local_objective, named_parameters

    leaves = [value for _, value in named_parameters(params)]
    obj, _ = _local_objective(params, tokens, cfg)
    grads = torch.autograd.grad(obj, leaves)
    return float(obj.detach()), grads


def grad_gap(names, grads, ref_grads) -> tuple[float, str]:
    """(the largest ||g - g_ref|| / ||g_ref|| over the tensors, its
    name); every gradient must be finite."""
    worst, worst_name = 0.0, ""
    for tname, g, g_ref in zip(names, grads, ref_grads):
        check(bool(torch.isfinite(g).all()), f"{tname} grad non-finite")
        rel = float(torch.linalg.vector_norm(g.float() - g_ref)
                    / torch.linalg.vector_norm(g_ref).clamp_min(1e-30))
        if rel > worst:
            worst, worst_name = rel, tname
    return worst, worst_name


def step_parity(args, tag: str = "train",
                dtypes=(torch.bfloat16, torch.float32)) -> None:
    """The kernel path's first step (in each of ``dtypes``) against a
    plain f32 path (``use_pallas=False``: the reference formulas) on the
    same weights and batch: the loss gap and each gradient's relative
    error (an MoE model's router and experts included) within the stated
    tolerances.  An MoE model's routing is discontinuous (a near tie
    that rounds the other way moves a token to other experts, and with
    capacity shifts the queue behind it), so the plain path is
    teacher-forced the kernel path's expert choices (``RoutingTap``),
    which must be its own or a near tie's (``ROUTE_TIE``); the plain
    path routing freely is reported beside.  No optimizer exists
    meanwhile: the masters and at most four sets of gradients are all
    it holds."""
    from dataclasses import replace

    from oim_tpu_torch.cli import train_main
    from oim_tpu_torch.data.loader import TokenBatches
    from oim_tpu_torch.models import transformer
    from oim_tpu_torch.models.train import named_parameters
    from oim_tpu_torch.models.transformer import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = train_main.make_config(args)
    moe = bool(getattr(cfg, "n_experts", 0))
    batches = TokenBatches(train_main._load_corpus(args), args.batch_global,
                           args.seq, seed=args.seed)
    tokens = torch.from_numpy(batches.batch_at(0)[:, :args.seq]).long().to(DEV)
    params = init_params(args.seed, cfg, device=DEV, master=True)
    names = [name for name, value in named_parameters(params)]
    for _, value in named_parameters(params):
        value.requires_grad_(True)
    plain_cfg = replace(cfg, dtype="float32", use_pallas=False)
    free_loss, free_grads = step_grads(params, tokens, plain_cfg)
    for dtype in dtypes:
        name = str(dtype).removeprefix("torch.")
        planted = plant_route_control(params["layers"]) if moe else None
        with RoutingTap(transformer) as tap:
            loss, grads = step_grads(params, tokens, replace(cfg, dtype=name))
        restore_routers(params["layers"], planted)
        routed = ""
        ref_loss, ref_grads = free_loss, free_grads
        if moe:
            free = grad_gap(names, grads, free_grads)
            with RoutingTap(transformer, tap.choices) as forced:
                ref_loss, ref_grads = step_grads(params, tokens, plain_cfg)
            rows = sum(c.shape[0] for c in forced.choices)
            routed = (f"; the plain path teacher-forced the kernel path's "
                      f"expert choices, which differ from its own in "
                      f"{forced.differing()} of {rows} (call, token) rows, "
                      f"giving up at most {forced.most_lost():.4f} of router "
                      f"probability (tol {ROUTE_TIE}); routing freely: loss "
                      f"|diff| {abs(loss - free_loss):.2e}, worst gradient "
                      f"{free[0]:.3e} at {free[1]}")
            check(forced.most_lost() <= ROUTE_TIE,
                  f"{name} kernel path routes {forced.most_lost():.4f} of "
                  f"router probability away from the plain top-k")
        worst, worst_name = grad_gap(names, grads, ref_grads)
        gap = abs(loss - ref_loss)
        print(f"{tag}: first step, {name} kernel path vs plain f32: loss "
              f"{loss:.5f} vs {ref_loss:.5f} (|diff| {gap:.2e}, tol "
              f"{STEP_LOSS_ATOL[dtype]}); worst gradient "
              f"||g - g_ref||/||g_ref|| {worst:.3e} at {worst_name} (tol "
              f"{STEP_GRAD_RTOL[dtype]}){routed}", flush=True)
        check(gap <= STEP_LOSS_ATOL[dtype], f"{name} first-step loss gap "
              f"{gap:.3e}")
        check(worst <= STEP_GRAD_RTOL[dtype], f"{name} gradient of "
              f"{worst_name} off by {worst:.3e}")
        del grads, ref_grads
    del params, free_grads
    torch.cuda.empty_cache()


def graph_report(tag: str, result: dict) -> dict | None:
    """Print a training run's step walls beside its replays' device time
    (CUDA events around each replay), the graph pool, the capture's
    seconds and the peak allocated; returns the run's graph stats (None
    for a package whose trainer has no graph)."""
    graph = result.get("graph")
    walls = [round(t * 1e3, 1) for t in result["step_seconds"]]
    if graph is None:
        print(f"{tag}: step walls {walls} ms (no graph in this package); "
              f"peak allocated {gib(torch.cuda.max_memory_allocated()):.2f} "
              f"GiB [{SMI}]", flush=True)
        return None
    print(f"{tag}: step walls {walls} ms; the replays' device time "
          f"{[round(ms, 1) for ms in graph['replay_ms']]} ms (steps 2-); "
          f"{graph['captures']} capture in {graph['capture_seconds']:.2f} s, "
          f"{graph['replays']} replays; graph pool "
          f"{gib(graph['pool_bytes']):.2f} GiB; peak allocated "
          f"{gib(torch.cuda.max_memory_allocated()):.2f} GiB [{SMI}]",
          flush=True)
    return graph


def check_graph(graph: dict, steps: int, tag: str) -> None:
    """Every step after a trainer's first was one replay of its one
    graph."""
    check(graph is not None and graph["graphed"] and graph["captures"] == 1
          and graph["replays"] == steps - 1,
          f"{tag}: {steps} steps must be one eager step, one capture and "
          f"{steps - 1} replays: {graph}")


def train_steps():
    """(args, result, the kernels' launch counts) of ``TRAIN_STEPS``
    steps of the training configuration through the loaded package's
    train_main entry, the counts set to 0 just before; prints the
    steps' walls, the replays' device time and the peak memory."""
    from oim_tpu_torch.cli import train_main
    from oim_tpu_torch.ops import flash_attention as fa
    from oim_tpu_torch.ops import fused_ce as fc
    from oim_tpu_torch.ops import rmsnorm as rn

    args = train_main.build_parser().parse_args(TRAIN_ARGS)
    torch.cuda.reset_peak_memory_stats()
    rn.reset_counters()
    fa.reset_counters()
    fc.reset_counters()
    t0 = time.monotonic()
    result = train_main.train(args)
    wall = time.monotonic() - t0
    counts = {**rn.counters(), **fa.counters(), **fc.counters()}
    losses = result["losses"]
    mem = torch.cuda.memory_stats()
    print(f"train: {len(losses)} steps in {wall:.1f} s (setup included); "
          f"losses {[round(x, 4) for x in losses]}; kernel counts {counts}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} "
          f"GiB; allocator cudaMalloc {mem.get('num_device_alloc')}, "
          f"cudaFree {mem.get('num_device_free')}, retries "
          f"{mem.get('num_alloc_retries')} (since the process began)",
          flush=True)
    graph_report("train", result)
    return args, result, counts


def check_train_counts(counts: dict, steps: int, args) -> dict:
    """Check a training run's kernel launches against its formulas and
    return them.  Per step: the forward and the remat recompute each run
    both norms and the attention of every layer (an MoE layer's norm
    too); the final norm runs once; the backward runs dq and dkv once per
    layer; the loss runs the fused unembed+CE forward and the joint
    backward (dx and dw from one dlogits pass) once per microbatch, on
    the wgmma route, and never dx or dw apart; no plain version runs."""
    n_layers, micro = args.n_layers, steps * args.grad_accum
    want = {"rmsnorm": steps * (4 * n_layers + 1),
            "flash_fwd": steps * 2 * n_layers,
            "flash_dq": steps * n_layers,
            "flash_dkv": steps * n_layers,
            "fused_ce_fwd": micro, "fused_ce_bwd": micro,
            "fused_ce_dx": 0, "fused_ce_dw": 0}
    for name, n in want.items():
        check(counts[name] == n, f"{name} launched {counts[name]} times, "
              f"expected {n}")
        check(counts[f"{name}_plain"] == 0,
              f"{name}'s plain version ran on the training path")
    check(counts["fused_ce_wgmma"] == 2 * micro
          and counts["fused_ce_mma_sync"] == 0,
          f"fused-CE routes {counts}: the training shape must take wgmma")
    return want


def train_phase(record: dict) -> dict:
    """Train Qwen2.5-1.5B at full width for ``TRAIN_STEPS`` steps through
    the port's train_main entry and check the losses, the kernels'
    launch counts (every layer of every forward, recompute and backward
    went through them; no plain version ran) and the first step against
    a plain f32 path.  Returns the main path's launch counts."""
    args, result, counts = train_steps()
    losses = result["losses"]
    check(len(losses) == TRAIN_STEPS, f"{len(losses)} steps ran")
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    want = check_train_counts(counts, TRAIN_STEPS, args)
    check_graph(result.get("graph"), TRAIN_STEPS, "train")
    # Steady steps (the first pays warm-up); the kernels' share of one.
    steady = result["step_seconds"][1:]
    step_s = float(np.median(steady))
    per_step = {name: n / TRAIN_STEPS * record[name]["ms"]
                for name, n in want.items() if n}
    share = {name: ms / 1e3 / step_s for name, ms in per_step.items()}
    print(f"train: step {step_s * 1e3:.1f} ms (median of steps 2-"
          f"{TRAIN_STEPS}; first {result['step_seconds'][0] * 1e3:.1f} ms), "
          f"{result['tokens_per_step'] / step_s:.0f} tokens/s; kernel share "
          f"of a step (launches x ms): "
          f"{ {k: round(v, 4) for k, v in share.items()} } [{SMI}]",
          flush=True)
    del result
    torch.cuda.empty_cache()
    train_twice(args)
    adamw_phase(args, "train")
    step_parity(args)
    return counts


def train_twice(args, steps: int = 3) -> None:
    """The training configuration from its seed-0 masters on its first
    ``steps`` batches, twice through ``make_train_step``: eagerly and
    graphed (an eager first step, the capture, replays).  They must be
    bit-equal (losses, ce, every parameter and both moments): the replay
    runs the eager step's kernels on the same inputs.  The per-tensor
    AdamW is ``adamw_phase``'s, which holds the updates themselves to
    each other on the same gradients."""
    from oim_tpu_torch.cli import train_main
    from oim_tpu_torch.data.loader import TokenBatches
    from oim_tpu_torch.models.train import (
        TrainState,
        make_train_step,
        named_parameters,
    )
    from oim_tpu_torch.models.transformer import init_params

    cfg = train_main.make_config(args)
    opt = train_main.make_optimizer_config(args)
    corpus = TokenBatches(train_main._load_corpus(args), args.batch_global,
                          args.seq, seed=args.seed)
    batches = [torch.from_numpy(corpus.batch_at(i)[:, :args.seq]).long()
               .to(DEV) for i in range(steps)]
    runs, ref = {}, None
    for name, graphed in (("eager", False), ("graphed", True)):
        state = TrainState.create(
            init_params(args.seed, cfg, device=DEV, master=True), opt,
            "fused")
        step = make_train_step(cfg, cuda_graph=graphed)
        metrics = [step(state, tokens)[1] for tokens in batches]
        runs[name] = {"loss": [float(m["loss"]) for m in metrics],
                      "ce": [float(m["ce"]) for m in metrics],
                      "stats": step.stats()}
        named = list(named_parameters(state.params))
        for _, value in named:
            value.grad = None
        if ref is None:
            ref = state
            continue
        pairs = [(n, a, b) for (n, a), (_, b) in zip(
            named, named_parameters(ref.params))]
        runs[name]["max_abs_diff"] = max(
            float((a - b).detach().abs().max()) for _, a, b in pairs)
        runs[name]["differ"] = [n for n, a, b in pairs if not torch.equal(
            a, b)] + [f"{n}.{key}" for n, a, b in pairs
                      for key in ("exp_avg", "exp_avg_sq", "step")
                      if not torch.equal(state.optimizer.state[a][key],
                                         ref.optimizer.state[b][key])]
        del state, step, named, pairs
        torch.cuda.empty_cache()
    del ref
    torch.cuda.empty_cache()
    eager, graphed = runs["eager"], runs["graphed"]
    print(f"train_twice: {steps} steps from one seed, eager losses "
          f"{eager['loss']}, graphed {graphed['loss']} (captures "
          f"{graphed['stats']['captures']}, replays "
          f"{graphed['stats']['replays']}); bit-equal: "
          f"{eager['loss'] == graphed['loss'] and not graphed['differ']} "
          f"(largest parameter difference {graphed['max_abs_diff']:.3e}) "
          f"[{SMI}]", flush=True)
    check(graphed["stats"]["captures"] == 1
          and graphed["stats"]["replays"] == steps - 1,
          f"train_twice: graphed run {graphed['stats']}")
    check(eager["loss"] == graphed["loss"] and eager["ce"] == graphed["ce"],
          f"graphed losses {graphed['loss']} / ce {graphed['ce']} differ "
          f"from eager {eager['loss']} / {eager['ce']}")
    check(not graphed["differ"],
          f"graphed state differs from eager in {graphed['differ'][:8]} "
          f"(largest parameter difference {graphed['max_abs_diff']:.3e})")


def adamw_phase(args, tag: str, steps: int = 3, runs: int = 10) -> dict:
    """AdamW fused against the capturable per-tensor update over the
    masters of ``args``' model (seed-0 values, fixed random gradients):
    ``steps`` updates from the same start compared (the largest
    parameter difference), then each update's device time (median of
    ``runs``) and its transient memory (the allocator's peak during the
    timed updates over what it held before).  Returns the numbers."""
    from oim_tpu_torch.cli import train_main
    from oim_tpu_torch.models.train import make_optimizer, named_parameters
    from oim_tpu_torch.models.transformer import init_params

    cfg = train_main.make_config(args)
    opt = train_main.make_optimizer_config(args)
    gen = torch.Generator(device=DEV).manual_seed(7)
    grads, fused, out = None, None, {}
    for kind in ("fused", "per_tensor"):
        params = init_params(args.seed, cfg, device=DEV, master=True)
        leaves = [v.requires_grad_(True) for _, v in named_parameters(params)]
        if grads is None:
            grads = [torch.randn(v.shape, generator=gen, device=DEV) * 1e-3
                     for v in leaves]
        for value, g in zip(leaves, grads):
            value.grad = g
        optimizer = make_optimizer(params, opt, kind)
        for _ in range(steps):
            optimizer.step()
        if fused is None:  # the fused update's parameters after ``steps``
            fused = [v.detach().clone() for v in leaves]
        else:
            worst = max(float((a - b).detach().abs().max())
                        for a, b in zip(fused, leaves))
            del fused
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        optimizer.step()
        torch.cuda.synchronize()
        transient = torch.cuda.max_memory_allocated() - held
        out[kind] = {"ms": time_ms(optimizer.step, runs=runs, warmup=0),
                     "transient_gib": gib(transient)}
        del optimizer, params, leaves
        torch.cuda.empty_cache()
    n = sum(v.numel() for v in grads)
    print(f"{tag} adamw: {n / 1e9:.3f} B parameters; after {steps} updates "
          f"from one start the fused and per-tensor parameters differ by at "
          f"most {worst:.3e}; an update takes {out['fused']['ms']:.3f} ms "
          f"fused ({out['fused']['transient_gib']:.3f} GiB transient) and "
          f"{out['per_tensor']['ms']:.3f} ms per-tensor "
          f"({out['per_tensor']['transient_gib']:.3f} GiB transient); 28 "
          f"bytes a parameter at {HBM_BYTES_PER_S / 1e12:.2f} TB/s bound it "
          f"at {28 * n / HBM_BYTES_PER_S * 1e3:.3f} ms [{SMI}]", flush=True)
    check(worst <= 1e-5, f"{tag}: fused AdamW is {worst:.3e} from the "
          f"per-tensor update after {steps} steps")
    check(out["fused"]["transient_gib"] <= out["per_tensor"]["transient_gib"],
          f"{tag}: the fused update's transient memory is the higher: {out}")
    del grads
    torch.cuda.empty_cache()
    return {"max_abs_diff": worst, **out}


# ---------------------------------------------------------------------------
# MoE phases


# RMSNorm's wide route (rows past one warp's registers), held against
# plain at these (dtype, width) pairs: the first is the MoE training's
# f32 first step, where the main path launches it.
WIDE_NORMS = ((torch.float32, 4096), (torch.float32, 8192),
              (torch.bfloat16, 8192))


def rmsnorm_wide_phase(gen, rows: int) -> dict:
    """RMSNorm's wide route on [rows, d] at ``WIDE_NORMS``: the route the
    wrapper picks, the plain version's numbers within the register
    route's tolerance, two launches bit-equal, then timed beside the
    plain version, ``F.rms_norm`` and the byte bound.  Returns the
    record at the first pair."""
    import torch.nn.functional as F

    from oim_tpu_torch.ops import rmsnorm as rn

    record = None
    for xdt, d in WIDE_NORMS:
        x = (torch.randn((rows, d), generator=gen, device=DEV) * 3).to(xdt)
        w = torch.rand(d, generator=gen, device=DEV) + 0.5
        tag = f"x {str(xdt)[6:]} w float32 [{rows}, {d}]"
        check(rn.rmsnorm_route(d, xdt) == "wide",
              f"rmsnorm {tag} does not take the wide route")
        before = rn.counters()
        got = rn.rmsnorm_fwd(x, w, 1e-5)
        again = rn.rmsnorm_fwd(x, w, 1e-5)
        want = rn.rmsnorm_plain(x, w, 1e-5)
        torch.cuda.synchronize()
        check(rn.counters()["rmsnorm_wide"] - before["rmsnorm_wide"] == 2,
              f"rmsnorm {tag}: the wide kernel did not launch")
        err, rel = rel_err(got, want)
        check(rel <= TRAIN_TOL[xdt], f"rmsnorm {tag} disagrees: {rel}")
        check(torch.equal(got, again),
              f"rmsnorm {tag}: two launches give other bits")
        ms = time_ms(lambda: rn.rmsnorm_fwd(x, w, 1e-5))
        plain_ms = time_ms(lambda: rn.rmsnorm_plain(x, w, 1e-5))
        wl = w.to(xdt)
        lib_ms = time_ms(lambda: F.rms_norm(x, (d,), wl, 1e-5))
        moved = 2 * x.numel() * x.element_size() + w.numel() * 4
        bnd, by = bound(moved, 4 * x.numel(), torch.float32)
        print(f"rmsnorm wide route {tag}: max_abs_err={err:.3e} rel="
              f"{rel:.3e} (tol {TRAIN_TOL[xdt]:.3e} of max); two launches "
              f"bit-equal; {ms:.4f} ms (plain {plain_ms:.4f}, F.rms_norm "
              f"{lib_ms:.4f}, bound {bnd:.5f} by {by}; {ms / lib_ms:.2f}x "
              f"F.rms_norm, {bnd / ms:.0%} of the byte bound) [{SMI}]",
              flush=True)
        if record is None:
            record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bnd, bound_by=by, library_ms=lib_ms)
    return record


def moe_train_kernels() -> dict:
    """RMSNorm, the three flash kernels and fused CE at the MoE training
    shapes (bf16: rows 2 x 1024 of width 4096; flash B=2, T=1024, 32 / 8
    heads, group 4, so dkv sums 4 q heads a kv head; fused CE at V =
    32000, one partial chunk of the wgmma route's 32768 columns), held
    against their plain versions (and flash once in f32), then timed;
    RMSNorm's wide route at the same rows (``rmsnorm_wide_phase``),
    whose record it returns."""
    import torch.nn.functional as F

    from oim_tpu_torch.ops import flash_attention as fa
    from oim_tpu_torch.ops import fused_ce as fc
    from oim_tpu_torch.ops import rmsnorm as rn

    gen = torch.Generator(device=DEV).manual_seed(6)
    b, t = MOE_TRAIN_B, TRAIN_T
    rows = b * t
    x = torch.randn((rows, MOE_D), generator=gen,
                    device=DEV).to(torch.bfloat16)
    w = torch.rand(MOE_D, generator=gen, device=DEV) + 0.5
    err, rel = rel_err(rn.rmsnorm_fwd(x, w, 1e-5), rn.rmsnorm_plain(x, w,
                                                                   1e-5))
    check(rel <= TRAIN_TOL[torch.bfloat16], f"rmsnorm MoE disagrees: {rel}")
    print(f"rmsnorm MoE bf16 [{rows}, {MOE_D}]: max_abs_err={err:.3e} "
          f"rel={rel:.3e}; {time_ms(lambda: rn.rmsnorm_fwd(x, w, 1e-5)):.4f}"
          f" ms (F.rms_norm {time_ms(lambda: F.rms_norm(x, (MOE_D,), w.to(x.dtype), 1e-5)):.4f}) [{SMI}]",
          flush=True)
    wide = rmsnorm_wide_phase(gen, rows)
    for dtype in (torch.float32, torch.bfloat16):
        q, do = (torch.randn((b, t, MOE_H, HD), generator=gen,
                             device=DEV).to(dtype) for _ in range(2))
        k, v = (torch.randn((b, t, MOE_KVH, HD), generator=gen,
                            device=DEV).to(dtype) for _ in range(2))
        check_flash(f"{str(dtype)[6:]} MoE B={b} T={t} H={MOE_H} "
                    f"KVH={MOE_KVH}", q, k, v, do, 0, None)
    out, lse = fa.flash_fwd_plain(q, k, v, True, 0, None)
    bwd = (q, k, v, do, lse, fa.flash_delta(out, do), True, 0, None)
    qh, kh, vh = (x_.transpose(1, 2).contiguous() for x_ in (q, k, v))
    sdpa = time_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True, enable_gqa=True))
    print(f"flash MoE bf16 B={b} T={t} H={MOE_H} KVH={MOE_KVH}: fwd "
          f"{time_ms(lambda: fa.flash_fwd(q, k, v, True, 0, None)):.4f} ms "
          f"(SDPA forward {sdpa:.4f}), dq "
          f"{time_ms(lambda: fa.flash_dq(*bwd)):.4f}, dkv "
          f"{time_ms(lambda: fa.flash_dkv(*bwd)):.4f} [{SMI}]", flush=True)
    del q, k, v, do, out, lse, bwd, qh, kh, vh
    xc, wc, labels, g = ce_case(gen, torch.bfloat16, rows, MOE_D, MOE_VOCAB)
    check(fc.route(xc, wc) == "wgmma"
          and fc.chunk_columns(rows, MOE_VOCAB) >= MOE_VOCAB,
          "fused CE at the MoE shape must take wgmma in one chunk")
    before = fc.counters()["fused_ce_wgmma"]
    tag = f"bf16 MoE N={rows} D={MOE_D} V={MOE_VOCAB}"
    check_ce(tag, xc, wc, labels, g)
    check(fc.counters()["fused_ce_wgmma"] - before == 4,
          "fused CE at the MoE shape left the wgmma route")
    lse, _ = fc.fused_ce_fwd_plain(xc, wc, labels)
    print(f"fused_ce {tag}: fwd "
          f"{time_ms(lambda: fc.fused_ce_fwd(xc, wc, labels)):.4f} ms, joint "
          f"backward {time_ms(lambda: fc.fused_ce_bwd(xc, wc, labels, lse, g)):.4f}"
          f" ms (cuBLAS x @ w {time_ms(lambda: xc @ wc):.4f}) [{SMI}]",
          flush=True)
    del xc, wc, labels, g, lse
    torch.cuda.empty_cache()
    return wide


def moe_train_phase(record: dict) -> dict:
    """Train the MoE model at Mixtral's widths, 2 layers, batch 2 x 1024,
    f32 masters with bf16 compute and the router z-loss on, through the
    port's train_main entry: finite losses, an aux above 0 every step,
    the launch formulas at L = 2, and the first step in bf16 and in f32
    against a plain f32 path (in f32, each 4096-wide row, 16384 bytes,
    takes RMSNorm's wide route).  Puts the wide route's record into
    ``record``; returns the run's launch counts, with the wide route's
    launches of the f32 first step under ``rmsnorm_wide``."""
    from oim_tpu_torch.cli import train_main
    from oim_tpu_torch.ops import flash_attention as fa
    from oim_tpu_torch.ops import fused_ce as fc
    from oim_tpu_torch.ops import rmsnorm as rn

    record["rmsnorm_wide"] = moe_train_kernels()
    args = train_main.build_parser().parse_args(MOE_TRAIN_ARGS)
    torch.cuda.reset_peak_memory_stats()
    for mod in (rn, fa, fc):
        mod.reset_counters()
    t0 = time.monotonic()
    result = train_main.train(args)
    wall = time.monotonic() - t0
    counts = {**rn.counters(), **fa.counters(), **fc.counters()}
    losses, aux = result["losses"], result["aux"]
    print(f"moe train: {len(losses)} steps of {args.batch_global}x{args.seq}"
          f" at {args.n_layers} layers in {wall:.1f} s (setup included); "
          f"losses {[round(x_, 4) for x_ in losses]}; aux "
          f"{[round(a, 4) for a in aux]}; step walls "
          f"{[round(t_ * 1e3, 1) for t_ in result['step_seconds']]} ms; "
          f"kernel counts {counts}; peak memory "
          f"{gib(torch.cuda.max_memory_allocated()):.1f} GiB [{SMI}]",
          flush=True)
    graph = graph_report("moe train", result)
    check(len(losses) == MOE_TRAIN_STEPS, f"{len(losses)} MoE steps ran")
    check(all(np.isfinite(losses)), f"non-finite MoE loss: {losses}")
    check(all(np.isfinite(aux)) and min(aux) > 0, f"MoE aux {aux}")
    check_train_counts(counts, MOE_TRAIN_STEPS, args)
    check_graph(graph, MOE_TRAIN_STEPS, "moe train")
    del result
    torch.cuda.empty_cache()
    adamw_phase(args, "moe train")
    # Memory of the first-step parity, f32 included: the f32 masters of
    # 2 layers (12.7 GB), three sets of gradients at once (the plain
    # path's routing freely, the kernel path's, the plain path's forced;
    # 38 GB) and one forward's activations, under 4 GB in f32 at 2 x
    # 1024: batch 2 fits the card.
    rn.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    step_parity(args, "moe train", (torch.bfloat16, torch.float32))
    norms = rn.counters()
    print(f"moe train: first-step parity in bf16 and f32, peak "
          f"{gib(torch.cuda.max_memory_allocated()):.1f} GiB; RMSNorm "
          f"launches {norms} (the wide route: the f32 step's 4096-wide "
          f"rows)", flush=True)
    check(norms["rmsnorm_wide"] > 0 and norms["rmsnorm_plain"] == 0,
          f"the f32 first step did not take RMSNorm's wide route: {norms}")
    counts["rmsnorm_wide"] = norms["rmsnorm_wide"]
    return counts


def route_control(control: str) -> int:
    """The MoE serve phase and the MoE training's first-step parity with
    the router fault ``control`` planted (``plant_route_control``) on the
    served and the kernel path only: each must fail its checks.  Prints
    what each failure read; 1 when both failed, 0 when one passed."""
    from oim_tpu_torch.cli import train_main

    global ROUTE_CONTROL
    ROUTE_CONTROL = control
    caught = {}
    try:
        serve_phase(MOE_SERVE_ARGS, f"moe, router control {control}")
    except SmokeFailure as exc:
        caught["serve"] = str(exc)
    release()
    check(torch.cuda.memory_allocated() < 2**30,
          "the failed serve phase still holds its engine")
    args = train_main.build_parser().parse_args(MOE_TRAIN_ARGS)
    try:
        step_parity(args, f"moe train, router control {control}",
                    (torch.bfloat16,))
    except SmokeFailure as exc:
        caught["train"] = str(exc)
    for phase in ("serve", "train"):
        print(f"router control {control}: the {phase} check "
              f"{'failed: ' + caught[phase] if phase in caught else 'PASSED'}",
              flush=True)
    return int(len(caught) == 2)


def moe_phases(record: dict) -> dict:
    """K1/K2 at the MoE model's heads (into ``record``), then its serve
    phases (bf16 at ``MOE_LAYERS`` layers, then int8 weights at all
    ``MOE_INT8_LAYERS``) and its train phase, on a card the earlier
    phases left empty.  Returns the bf16 serve phase's counts, with the
    int8 one's under ``int8``."""
    release()
    held = torch.cuda.memory_allocated()
    blocks = sorted((b["size"] for seg in torch.cuda.memory_snapshot()
                     for b in seg["blocks"]
                     if b["state"] == "active_allocated"), reverse=True)
    print(f"moe: {gib(held):.2f} GiB allocated before the MoE phases, in "
          f"{len(blocks)} blocks; the largest (MiB) "
          f"{[round(b / 2**20, 1) for b in blocks[:24]]}", flush=True)
    check(held < 2**30, f"earlier phases still hold {gib(held):.1f} GiB")
    record.update(moe_kernel_phase())
    counts = serve_phase(MOE_SERVE_ARGS, "moe", MOE_FREE_GIB)
    held = torch.cuda.memory_allocated()
    check(held < 2**30, f"the MoE serve phase still holds {gib(held):.1f} "
          f"GiB")
    counts["int8"] = serve_phase(MOE_INT8_ARGS,
                                 f"moe int8 {MOE_INT8_LAYERS} layers",
                                 MOE_FREE_GIB)
    held = torch.cuda.memory_allocated()
    check(held < 2**30, f"the MoE int8 serve phase still holds "
          f"{gib(held):.1f} GiB")
    counts["train"] = moe_train_phase(record)
    return counts


# ---------------------------------------------------------------------------
# Checkpoint, resume, export, LoRA and serve phase


def ckpt_args(steps: int, *flags) -> list[str]:
    """The training command at full width with its depth cut to
    ``CKPT_LAYERS``, for ``steps`` steps, plus ``flags``."""
    args = list(TRAIN_ARGS)
    args[args.index("--n-layers") + 1] = str(CKPT_LAYERS)
    args[args.index("--steps") + 1] = str(steps)
    return args + list(flags)


def serve_args(*flags) -> list[str]:
    """The serving command at the checkpoint phase's depth, plus
    ``flags``."""
    args = list(SERVE_ARGS)
    args[args.index("--n-layers") + 1] = str(CKPT_LAYERS)
    return args + list(flags)


def run_train(argv, cuda_graph: bool = True) -> dict:
    from oim_tpu_torch.cli import train_main

    return train_main.train(train_main.build_parser().parse_args(argv),
                            cuda_graph=cuda_graph)


def ckpt_lora_phase(work: str) -> dict:
    """Under ``work``: an uninterrupted 5-step run; the same run
    interrupted after 3 steps (checkpoint every 3) and resumed to 5 from
    that checkpoint by the graphed step with ``--export-dir``, whose
    steps 4-5 must give the uninterrupted losses bit for bit (the eager
    step gives the graphed one's bit for bit: ``train_twice``); a LoRA
    fine-tune on that export with its merged export; the merged weights
    served through ``serve_main``.  Returns the LoRA run's fused-CE
    launch counts."""
    from oim_tpu_torch.checkpoint import (
        Checkpointer,
        directory_bytes,
        load_params,
    )
    from oim_tpu_torch.cli import serve_main
    from oim_tpu_torch.models.lora import merge_lora
    from oim_tpu_torch.models.train import named_parameters
    from oim_tpu_torch.models.weights import recast
    from oim_tpu_torch.ops import fused_ce as fc
    from oim_tpu_torch.ops import paged_attention as pa
    from oim_tpu_torch.serve.engine import GenRequest

    base, export = os.path.join(work, "base"), os.path.join(work, "export")
    lora, merged_dir = os.path.join(work, "lora"), os.path.join(work, "merged")
    torch.cuda.reset_peak_memory_stats()
    uninterrupted = run_train(ckpt_args(5))
    full = uninterrupted["losses"]
    check_graph(graph_report("ckpt uninterrupted", uninterrupted), 5,
                "ckpt uninterrupted")
    t0 = time.monotonic()
    first = run_train(ckpt_args(3, "--checkpoint-dir", base,
                                "--save-every", "3"))
    resumed = run_train(ckpt_args(5, "--checkpoint-dir", base,
                                  "--save-every", "3", "--export-dir",
                                  export))
    steps = Checkpointer(base).all_steps()
    got = first["losses"] + resumed["losses"]
    print(f"ckpt: {CKPT_LAYERS}-layer full-width runs; uninterrupted "
          f"losses {[round(x, 6) for x in full]}; interrupted at 3 and "
          f"resumed at {resumed['start_step']} by the graphed step: "
          f"{[round(x, 6) for x in got]}; bit-equal: {got == full}; "
          f"checkpoints on disk {steps} ({time.monotonic() - t0:.1f} s "
          f"with saves and the export)", flush=True)
    check(resumed["start_step"] == 3 and len(got) == 5, "resume cursor")
    check(bool(np.allclose(got, full, rtol=RESUME_RTOL, atol=0)),
          f"resumed losses {got} differ from uninterrupted {full}")
    check(got == full, f"resumed losses {got} are not the uninterrupted "
          f"run's {full} bit for bit")
    check(resumed["graph"]["replays"] == 1,
          f"the resumed run's graph: {resumed['graph']}")
    check(steps == [3, 5], f"checkpoint steps {steps}")
    base_bytes = directory_bytes(os.path.join(base, "5"))
    check(os.path.isfile(os.path.join(export, "params.pt")), "no export")
    shutil.rmtree(base)  # at most two full checkpoints on disk at once

    fc.reset_counters()
    tuned = run_train(ckpt_args(
        3, "--checkpoint-dir", lora, "--save-every", "3",
        "--lora-rank", str(LORA_RANK), "--lora-base", export,
        "--export-dir", merged_dir))
    counts = fc.counters()
    lora_bytes = directory_bytes(os.path.join(lora, "3"))
    print(f"lora: rank {LORA_RANK}, losses "
          f"{[round(x, 4) for x in tuned['losses']]}; fused-CE counts "
          f"{counts}; adapter checkpoint {lora_bytes / 2**20:.1f} MiB vs "
          f"base checkpoint {base_bytes / 2**20:.1f} MiB", flush=True)
    check_graph(graph_report("lora", tuned), 3, "lora")
    check(counts["fused_ce_fwd"] == counts["fused_ce_dx"] == 3
          and counts["fused_ce_dw"] == counts["fused_ce_bwd"] == 0,
          f"LoRA steps must launch fused-CE fwd and dx, never dw: {counts}")
    check(not any(counts[f"{k}_plain"] for k in ("fused_ce_fwd",
                                                 "fused_ce_dx",
                                                 "fused_ce_dw",
                                                 "fused_ce_bwd")),
          "a fused-CE plain version ran on the LoRA path")
    check(lora_bytes < 0.5 * base_bytes, "adapter checkpoint too large")

    # The merged export is merge_lora of the base and the saved adapters.
    base_params = load_params(export, device=DEV)
    adapters = Checkpointer(lora).restore_params(device=DEV)
    with torch.no_grad():
        want = merge_lora(base_params, adapters, 16.0, LORA_RANK)
    loaded = dict(named_parameters(load_params(merged_dir, device=DEV)))
    for name, value in named_parameters(want):
        check(torch.equal(loaded[name], value),
              f"merged export {name} differs from merge_lora")
    args = serve_main.build_parser().parse_args(
        serve_args("--params-dir", merged_dir))
    engine = serve_main.make_engine(args)
    served, _ = recast(want, engine.cfg, engine.cfg.dtype)
    for (name, got_t), (_, want_t) in zip(named_parameters(engine.params),
                                          named_parameters(served)):
        check(torch.equal(got_t, want_t), f"served {name} is not the merge")
    del base_params, adapters, want, loaded, served
    pa.reset_counters()
    rng = np.random.RandomState(3)
    asked = [16, 24, 32]
    rids = [engine.submit(GenRequest(
        tokens=rng.randint(0, VOCAB, 40 + 30 * i).tolist(),
        max_new_tokens=m)) for i, m in enumerate(asked)]
    out = engine.run()
    pcounts = pa.counters()
    lens = [len(out[r]) for r in rids]
    print(f"lora serve: {len(rids)} greedy requests on the merged export, "
          f"lengths {lens} (asked {asked}); kernel counts {pcounts}",
          flush=True)
    check(lens == asked, f"served lengths {lens} != {asked}")
    check(pcounts["paged_flash_decode"] > 0 and pcounts["paged_kv_store"] > 0
          and pcounts["paged_flash_decode_plain"] == 0
          and pcounts["paged_kv_store_plain"] == 0,
          f"the merged model was not served through K1/K2: {pcounts}")
    del engine
    torch.cuda.empty_cache()
    return counts


def quant_rows(record: dict, phases: dict) -> list[dict]:
    """The ``kernels`` rows of ``quant_matmul``: for each (model, mode)
    of ``phases`` (the serve phase that ran it), one row a weight shape
    of ``quant_kernel_phase`` at 8 rows, and the tall route's row, each
    with the launches of that shape and route in that phase, which must
    be some."""
    rows = []
    for (model, mode), phase in phases.items():
        keys = [(f"QMM {model} {mode} {names}", names, shape, QMM_ROWS)
                for m, md, mats in QMM_CASES if (m, md) == (model, mode)
                for names, shape in mats]
        keys += [(f"QMM tall {model} {mode} {names}", names, shape, rows_)
                 for m, md, names, shape, rows_ in QMM_TALL
                 if (m, md) == (model, mode)]
        for key, names, shape, n_rows in keys:
            rec = dict(record[key])
            route, count_key = rec.pop("route"), rec.pop("key")
            launches = phase.get(count_key, 0)
            check(launches > 0, f"{key}: its shape was launched on no "
                  f"{route} route in its serve phase")
            kernel = ("quant_matmul_kernel" if route == "gemv" else
                      "dequant_kernel, then torch.matmul")
            rows.append(dict(
                name=f"quant_matmul ({route} route: {kernel}; {mode} "
                     f"{model} {names} {list(shape)}, timed at {n_rows} "
                     f"rows)",
                route="cuda", source="oim_tpu_torch/csrc/wquant.cu",
                replaces="oim_tpu/ops/quant.py:53 (no Pallas kernel: XLA's "
                         "fused convert+scale in the product)",
                launches=launches, **rec))
    return rows


def spec_rows(record: dict, spec: dict) -> list[dict]:
    """The ``kernels`` rows of the speculative paths: K1 and K2 at a
    verify's t = 3 and t = 5 rows a slot on each layout, their launches
    those of the phases that ran the shape (every layer of every verify
    pass), and at the draft model's shapes, with its phase's draft passes
    (t = 1) and draft prefills."""
    src = "oim_tpu_torch/csrc/paged_attention.cu"
    k1, k2 = ("oim_tpu/ops/paged_attention.py:93",
              "oim_tpu/ops/paged_attention.py:265")
    layers = int(SERVE_ARGS[SERVE_ARGS.index("--n-layers") + 1])
    dlayers = int(DRAFT_FLAGS[DRAFT_FLAGS.index("--draft-n-layers") + 1])
    verifies = {
        (5, "dense"): ("serve_main --spec-decode 4, prompt lookup and the "
                       "0.5B-width draft",
                       spec["lookup"]["passes"]["decode_passes"]
                       + spec["draft"]["passes"]["decode_passes"]),
        (3, "dense"): ("the self-draft engine, spec 2",
                       spec["self"]["0_2"]["decode_passes"]),
        (3, "paged"): ("the self-draft engine, spec 2, --kv-block 16",
                       spec["self"]["16_2"]["decode_passes"]),
        (5, "paged"): ("the self-draft engine, spec 4, --kv-block 16",
                       spec["self"]["16_4"]["decode_passes"]),
    }
    rows = []
    for (t, layout), (where, passes) in verifies.items():
        blocks = "64-row blocks" if layout == "dense" else "16-row blocks"
        rows += [
            dict(name=f"paged_flash_decode (K1, tall route: "
                      f"paged_prefill_tc_kernel; a verify's t={t} rows a "
                      f"slot, 12 / 2 heads; {layout}, {blocks}: {where})",
                 route="cuda", source=src, replaces=k1,
                 launches=layers * passes, **record[f"K1v{t}_{layout}"]),
            dict(name=f"paged_kv_store (K2, a verify's t={t} rows a slot; "
                      f"{layout}, {blocks}: {where})",
                 route="cuda", source=src, replaces=k2,
                 launches=layers * passes, **record[f"K2v{t}_{layout}"]),
        ]
    draft = spec["draft"]["passes"]
    where = (f"the draft model's dense cache, 64-row blocks, H {DRAFT_H} / "
             f"KVH {DRAFT_KVH}, head_dim {DRAFT_HD}: --draft-params-dir")
    return rows + [
        dict(name=f"paged_flash_decode (K1, decode route: "
                  f"paged_decode_kernel<8> + merge; draft passes, t=1; "
                  f"{where})", route="cuda", source=src, replaces=k1,
             launches=dlayers * draft["draft_passes"],
             **record["K1_draft"]),
        dict(name=f"paged_flash_decode (K1, tall route: "
                  f"paged_prefill_tc_kernel; draft prefills, timed at "
                  f"t=512; {where})", route="cuda", source=src, replaces=k1,
             launches=dlayers * draft["draft_prefill_dispatches"],
             **record["K1t_draft"]),
        dict(name=f"paged_kv_store (K2, draft prefills, timed at t=512; "
                  f"{where})", route="cuda", source=src, replaces=k2,
             launches=dlayers * draft["draft_prefill_dispatches"],
             **record["K2_draft"]),
        dict(name=f"paged_kv_store (K2, draft passes, t=1; {where})",
             route="cuda", source=src, replaces=k2,
             launches=dlayers * draft["draft_passes"],
             **record["K2d_draft"]),
    ]


def ptxas_lines(log: str) -> list[str]:
    """ptxas's register and spill report, one line per kernel, each
    named by its (demangled enough) function name."""
    import re

    types = {"13__nv_bfloat16": "bf16", "f": "f32", "a": "i8"}
    report = {}  # mangled name -> (short name, report lines)
    mangled = "?"
    for line in log.splitlines():
        found = re.search(r"(?:entry function|Function properties for) "
                          r"'?(\w+)", line)
        if found:
            mangled = found.group(1)
            name = mangled
            tag = re.search(r"\d([a-z_]+?_kernel)(?:I(\w*?)E)?E", mangled)
            if tag:  # flash_dq_tc_kernel<128>, flash_fwd_kernel<64,f32>
                args = [n or types[t] for n, t in re.findall(
                    r"L[ib](\d+)E?|(13__nv_bfloat16|f|a)",
                    tag.group(2) or "")]
                name = tag.group(1) + (f"<{','.join(args)}>" if args else "")
            report.setdefault(mangled, (name, []))
        elif "registers" in line or "spill" in line:
            text = line.strip().removeprefix("ptxas info    : ")
            report.setdefault(mangled, (mangled, []))[1].append(text)
    return [f"ptxas: {name}: {'; '.join(parts)}"
            for name, parts in report.values() if parts]


# ---------------------------------------------------------------------------
# Sharded serving (tensor and expert parallelism, the bootstrap)

# Qwen2.5-1.5B at its published widths (SERVE_ARGS' model) and
# Mixtral-8x7B's (MOE_GEOMETRY's), as the ranks build them.
# Qwen's serving legs at SIDE_LAYERS of its 28 layers (the widths
# unchanged): gloo's host passes, a sum a layer, are most of the legs'
# time, and the training-parallel phase needs that time in the smoke's
# limit.  At 7 layers a tp=2 beam's score left tp=1's by 0.33 (its gate
# is 0.05): the shallower model's beams part at near ties.
PAR_QWEN = dict(vocab_size=VOCAB, d_model=D_MODEL, n_layers=SIDE_LAYERS,
                n_heads=H, n_kv_heads=KVH, d_ff=8960, rope_theta=1e6,
                norm_eps=1e-6, attn_bias=True, dtype="bfloat16")
# Mixtral at tp2·ep2 on one card: four ranks' shards plus the tp=1
# reference's whole model, int8 (1.45 GB a layer), at PAR_MOE_LAYERS of
# its 32 layers: 5.8 GB a copy, and each rank draws its experts' f32
# tensors whole (1.9 GB each) before cutting its shard — cut so that the
# phase stays within its share of the smoke's time.
PAR_MOE_LAYERS = 4
PAR_MIXTRAL = dict(vocab_size=MOE_VOCAB, d_model=MOE_D, n_layers=PAR_MOE_LAYERS,
                   n_heads=MOE_H, n_kv_heads=MOE_KVH, d_ff=14336, n_experts=8,
                   moe_top_k=2, rope_theta=1e6, norm_eps=1e-5,
                   dtype="bfloat16")
PAR_ENGINE = dict(n_slots=8, max_len=MAX_LEN, chunk=8)
# Eight concurrent requests (two sampled), then a lone 512-token prompt
# for the time to first token.
PAR_PROMPTS = (64, 128, 192, 256, 320, 384, 448, 512)
PAR_NEW = 16
PAR_SAMPLED = {6: (0.8, 61), 7: (0.7, 62)}  # request index → (temp, seed)
# The legs: (name, model, weight quant, tp, ep).
PAR_LEGS = {"qwen_tp2": (PAR_QWEN, "", 2, 1),
            "mixtral_tp2ep2": (PAR_MIXTRAL, "int8", 2, 2)}
# quant_matmul at the tp2·ep2 ranks' shapes: column-sharded wq, wk and
# the experts' w_gate/w_in over tp (the experts over ep), row-sharded
# wo and w_out, the vocab-sharded wlm.
PAR_QMM = (("wq", (MOE_D, MOE_D // 2)), ("wk, wv", (MOE_D, 512)),
           ("wo", (MOE_D // 2, MOE_D)),
           ("w_gate, w_in", (4, MOE_D, 14336 // 2)),
           ("w_out", (4, 14336 // 2, MOE_D)),
           ("wlm", (MOE_D, MOE_VOCAB // 2)))


def par_requests(vocab: int) -> tuple[list, dict]:
    """(the eight requests, the lone 512-token prompt's request), from a
    fixed seed: the same on every leg."""
    rng = np.random.RandomState(19)
    reqs = []
    for i, n in enumerate(PAR_PROMPTS):
        req = {"tokens": rng.randint(0, vocab, n).tolist(),
               "max_new_tokens": PAR_NEW}
        if i in PAR_SAMPLED:
            req["temperature"], req["seed"] = PAR_SAMPLED[i]
        reqs.append(req)
    lone = {"tokens": rng.randint(0, vocab, 512).tolist(),
            "max_new_tokens": 1}
    return reqs, lone


def sync() -> None:
    if DEV == "cuda":
        torch.cuda.synchronize()


def par_engine(fields: dict, mode: str, mesh, graphs: bool, params=None):
    """The engine of one leg: weights drawn from seed 0 on the card a
    tensor at a time, each cut to this rank's shard as it is made when
    ``mesh`` is given (the values the tp=1 reference draws whole), or
    ``params`` already drawn."""
    from oim_tpu_torch.models.transformer import TransformerConfig, init_params
    from oim_tpu_torch.models.weights import serve_specs, shard_tensor
    from oim_tpu_torch.serve.engine import Engine

    cfg = TransformerConfig(**fields)
    place = None
    if mesh is not None:
        specs = serve_specs(cfg, mesh, mode, 64)

        def place(name, t):
            return shard_tensor(name, t, specs, mesh)

    if params is None:
        params = init_params(0, cfg, device=DEV, weight_quant=mode,
                             int4_group=64, place=place)
    return Engine(params, cfg, mesh=mesh, cuda_graphs=graphs,
                  device=None if mesh is not None else DEV, **PAR_ENGINE)


def par_drive(engine, vocab: int, warm: bool, routing=None) -> dict:
    """Serve the eight requests (after one small warm request, or the
    engine's ``warmup``), counting launches and collectives from zero,
    then the lone 512-token prompt: tokens, walls, counts and stats.
    With ``routing`` (a ``ServedRouting`` installed before the engine
    was built) the eight requests' expert choices come back too, each
    greedy stream's as ``teacher_check`` forces them (``forced``)."""
    from oim_tpu_torch.ops import counts as kernel_counts
    from oim_tpu_torch.serve.engine import GenRequest

    reqs, lone = par_requests(vocab)
    if warm:
        engine.warmup()
    else:
        rid = engine.submit(GenRequest(tokens=[1] * 16, max_new_tokens=9))
        engine.run()
        engine.result(rid)
    sync()
    before = engine.stats()
    if routing is not None:
        routing.watch(engine)
    kernel_counts.reset_counters()
    t0 = time.monotonic()
    rids = [engine.submit(GenRequest(**r)) for r in reqs]
    engine.run()
    wall = time.monotonic() - t0
    counts = kernel_counts.counters()
    stats = engine.stats()
    tokens = [engine.result(rid) for rid in rids]
    forced = None
    if routing is not None:
        routing.remove(engine)
        forced = [[c.cpu().numpy() for c in routing.choices(
                      r["tokens"], len(t))]
                  for r, t in zip(reqs, tokens) if not r.get("temperature")]
    t0 = time.monotonic()
    rid = engine.submit(GenRequest(**lone))
    engine.run()
    engine.result(rid)
    ttft = time.monotonic() - t0
    delta = {k: stats[k] - before[k] for k in (
        "decode_passes", "prefill_dispatches", "graph_replays",
        "admission_replays", "decode_seconds", "decode_tokens",
        "readbacks")}
    return {"tokens": tokens, "forced": forced, "wall_s": wall,
            "ttft_ms": ttft * 1e3,
            "tok_s": sum(map(len, tokens)) / wall,
            "decode_tok_s": delta["decode_tokens"] / delta["decode_seconds"],
            "chunk_ms": delta["decode_seconds"] * 1e3 / delta["readbacks"],
            "counts": counts, "stats": delta}


def par_buffers(engine) -> dict:
    """Digests of what every rank must hold alike after the run."""
    bufs = {"out": engine._buf.out, "lps": engine._buf.lps,
            "carry": engine._buf.tokens, "logits": engine._adm.logits,
            "tok_counts": engine._tok_counts}
    return {name: digest(t) for name, t in bufs.items() if t is not None}


def par_collective_ms(mesh, fields: dict) -> dict:
    """Every rank together: one decode pass's collectives timed alone
    over the mesh (mean of 30 after 3), at the shapes a decode step of
    eight rows gives them — the row-parallel sums over tp, the MoE
    combine's over tp·ep, the logits' gather."""
    from oim_tpu_torch.parallel import collectives as c

    d, v = fields["d_model"], fields["vocab_size"] // mesh.shape["tp"]
    dev = mesh.device
    cases = {"psum_tp": lambda: c.psum(torch.ones(8, 1, d, device=dev,
                                                  dtype=torch.bfloat16),
                                       mesh, "tp"),
             "gather_logits": lambda: c.all_gather(
                 torch.ones(8, v, device=dev), mesh, "tp", dim=-1)}
    if fields.get("n_experts"):
        cases["psum_tp_ep"] = lambda: c.psum(
            torch.ones(8, d, device=dev), mesh, ("tp", "ep"))
    out = {}
    for name, fn in cases.items():
        for _ in range(3):
            fn()
        sync()
        t0 = time.monotonic()
        for _ in range(30):
            fn()
        sync()
        out[name] = (time.monotonic() - t0) * 1e3 / 30
    return out


def par_refuses_gloo_graphs(mesh) -> None:
    """An engine asked for CUDA graphs on a gloo mesh over the card
    refuses before any work: gloo's collectives cannot be captured."""
    from oim_tpu_torch.models.transformer import TransformerConfig, init_params
    from oim_tpu_torch.serve.engine import Engine

    cfg = TransformerConfig(vocab_size=64, d_model=128, n_layers=1,
                            n_heads=mesh.shape["tp"], n_experts=(
                                mesh.shape["ep"] if mesh.shape["ep"] > 1
                                else 0))
    try:
        Engine(init_params(0, cfg, device=DEV), cfg, mesh=mesh,
               cuda_graphs=True, n_slots=1, max_len=64)
    except ValueError as exc:
        check("cannot be captured" in str(exc), f"gloo graphs: {exc}")
    else:
        raise SmokeFailure("an engine took cuda_graphs=True on a gloo mesh")


def par_rank(rank: int, world: int, store: str, leg: tuple, package: str,
             dev: str, io, results) -> None:
    """One gloo rank of a leg on the shared card (a spawned process):
    its engine on its shard; rank 0 drives the traffic and stops the
    followers, which follow; then every rank times the collectives and
    reports its buffers' digests, and with ``io`` runs the block I/O leg
    (``par_io_rank``) on the same shard."""
    import traceback

    import torch.distributed as dist

    global DEV
    DEV = dev
    sys.path.insert(0, package)
    torch.set_num_threads(2)
    try:
        from oim_tpu_torch.ops import _build
        from oim_tpu_torch.parallel import build_mesh

        if DEV == "cuda":
            _build.library()
        fields, mode, tp, ep = leg
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                rank=rank, world_size=world)
        devices = ["cuda:0" if DEV == "cuda" else "cpu"] * world
        mesh = build_mesh(tp=tp, ep=ep, devices=devices)
        if DEV == "cuda":
            par_refuses_gloo_graphs(mesh)
        routing = None
        if rank == 0 and fields.get("n_experts"):
            # Every rank routes alike (the router is whole on each, the
            # hidden states bitwise the same): rank 0's choices are all.
            routing = ServedRouting(PAR_ENGINE["n_slots"],
                                    fields["moe_top_k"])
            routing.install()
        engine = par_engine(fields, mode, mesh, graphs=False)
        answer = {}
        if rank == 0:
            try:
                answer = par_drive(engine, fields["vocab_size"], warm=False,
                                   routing=routing)
            finally:
                engine.stop_followers()
        else:
            engine.follow()
        answer["collective_ms"] = par_collective_ms(mesh, fields)
        answer["buffers"] = par_buffers(engine)
        if io is not None:
            params = engine.params
            del engine
            if DEV == "cuda":
                release()
            answer["io"] = par_io_rank(rank, mesh, params, io)
        answer["peak_gib"] = (gib(torch.cuda.max_memory_allocated())
                              if DEV == "cuda" else 0.0)
        dist.destroy_process_group()
        results.put((rank, answer))
    except Exception:
        results.put((rank, {"error": traceback.format_exc()}))


def par_spawn(leg: str, package: str, io=None) -> list[dict]:
    """A leg's ranks, spawned, on cuda:0 over gloo; their answers by
    rank (``io``: the block I/O leg's inputs, ``par_io_rank``).  Every
    process is joined (killed past its time)."""
    import multiprocessing as mp

    _, _, tp, ep = PAR_LEGS[leg]
    world = tp * ep
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    work = tempfile.mkdtemp(prefix=".smoke-par-", dir=HERE)
    procs = [ctx.Process(target=par_rank, args=(r, world,
                                                os.path.join(work, "store"),
                                                PAR_LEGS[leg], package, DEV,
                                                io, results),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    try:
        answers = {}
        for _ in procs:
            rank, answer = results.get(timeout=600)
            check("error" not in answer,
                  f"parallel {leg}: rank {rank} failed:\n"
                  f"{answer.get('error')}")
            answers[rank] = answer
        return [answers[r] for r in range(world)]
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(work, ignore_errors=True)


def par_counts_check(tag: str, run: dict, fields: dict) -> int:
    """The launches of one driven run: K1 and K2 once a layer a forward
    pass (a decode step or an admission dispatch), no plain version, and
    a mesh's collectives — a vocab-sharded lookup's sum, two row sums a
    layer (wo, and w_out or the MoE combine), one logits gather — once a
    pass.  Returns the passes."""
    counts, stats, n_layers = run["counts"], run["stats"], fields[
        "n_layers"]
    passes = stats["decode_passes"] + stats["prefill_dispatches"]
    if DEV != "cuda":  # a CPU rehearsal runs the plain versions
        return passes
    for name in ("paged_flash_decode", "paged_kv_store"):
        check(counts[name] == n_layers * passes,
              f"parallel {tag}: {name} launched {counts[name]} times, not "
              f"{n_layers} x {passes} passes")
    check(not counts["paged_flash_decode_plain"]
          and not counts["paged_kv_store_plain"],
          f"parallel {tag}: a plain version ran")
    return passes


def par_collectives_check(tag: str, run: dict, fields: dict,
                          passes: int) -> None:
    counts = run["counts"]
    want_sum = (1 + 2 * fields["n_layers"]) * passes
    check(counts["collective.all_reduce"] == want_sum
          and counts["collective.all_gather"] == passes,
          f"parallel {tag}: collectives {counts['collective.all_reduce']} "
          f"sums, {counts['collective.all_gather']} gathers, not "
          f"{want_sum} and {passes}")


def par_ref(fields: dict, mode: str, graphs: bool) -> tuple:
    """The tp=1 reference engine's run and the f32 forward over its
    weights (``kv_gate``'s arbiter)."""
    engine = par_engine(fields, mode, None, graphs)
    run = par_drive(engine, fields["vocab_size"], warm=graphs)
    return engine, run


def par_leg(leg: str, package: str) -> dict:
    """One gloo leg against its tp=1 reference: the reference eagerly in
    this process (the same weights, drawn whole), then the ranks.
    Streams equal or parting at a near tie (``kv_gate``), every rank's
    buffers bitwise rank 0's, K1/K2 and the collectives once a layer a
    pass on rank 0.  Qwen's ranks then run the block I/O leg
    (``par_io_rank``): tp=1 ships them a held request and a live slot
    first, and serves its weights for their peer load."""
    from oim_tpu_torch.serve.server import ServeServer

    fields, mode, tp, ep = PAR_LEGS[leg]
    reqs, _ = par_requests(fields["vocab_size"])
    t0 = time.monotonic()
    engine, ref = par_ref(fields, mode, graphs=False)
    io = server = io_engine = None
    if leg == "qwen_tp2":
        # The exports come from an engine of their own, so that the one
        # held to the ranks counts only the traffic they run.
        source_engine = par_io_engine(engine.params, fields, None,
                                      graphs=False)
        io = {"source": par_io_source(source_engine), "fields": fields}
        del source_engine
        io_engine = par_io_engine(engine.params, fields, None, graphs=False)
        server = ServeServer(engine, port=0).start()
        io["url"] = f"http://127.0.0.1:{server.port}"
    t1 = time.monotonic()
    try:
        ranks = par_spawn(leg, package, io)
        t2 = time.monotonic()
        if server is not None:
            weights = par_weights_sha(server.port)
    finally:
        if server is not None:
            server.stop()
    lead = ranks[0]
    ref32 = widened(engine.params, engine.cfg)
    if lead["forced"] is None:
        gate = kv_gate(ref32, f"parallel {leg}", reqs, ref["tokens"],
                       lead["tokens"])
    else:
        gate = par_teacher(leg, ref32, reqs, ref["tokens"], lead)
    io_out = None
    if io is not None:
        ref_io = par_io_run(io_engine, par_io_steps(
            io["source"], fields["vocab_size"]))
        ios = [r["io"] for r in ranks]
        io_check = par_io_check(ios, io_engine, ref_io, io["source"], ref32,
                                weights)
        io_out = par_io_report(ios, ref_io, io_check, weights)
        io_out["counts"] = ios[0]["counts"]
        # What the one-rank NCCL mesh's run is held to.
        io_out["ref"] = {name: ref_io["outputs"][name]
                         for name in PAR_IO_NCCL}
        for r in ranks:
            r.pop("io")
        del io_engine
    del engine, ref32, lead["forced"]
    if DEV == "cuda":
        release()
    bad = [(r, name) for r, answer in enumerate(ranks[1:], 1)
           for name, d in answer["buffers"].items()
           if d != lead["buffers"][name]]
    check(not bad, f"parallel {leg}: buffers differ from rank 0's: {bad}")
    passes = par_counts_check(leg, lead, fields)
    par_collectives_check(leg, lead, fields, passes)
    coll = lead["collective_ms"]
    per_chunk = PAR_ENGINE["chunk"] * (
        (1 + fields["n_layers"]) * coll["psum_tp"]
        + fields["n_layers"] * coll.get("psum_tp_ep", coll["psum_tp"])
        + coll["gather_logits"])
    share = per_chunk / lead["chunk_ms"]
    print(f"parallel {leg}: {tp * ep} gloo ranks on cuda:0, "
          f"{fields['n_layers']} layers{', ' + mode if mode else ''}, eager: "
          f"{gate['equal']}/{gate['of']} streams equal to tp=1 (worst gap "
          f"{gate['worst_gap']:.3f}); buffers bitwise equal on every rank; "
          f"{passes} passes, K1/K2 and collectives once a layer a pass; "
          f"8 streams {lead['tok_s']:.1f} tok/s (decode "
          f"{lead['decode_tok_s']:.1f}, a chunk {lead['chunk_ms']:.1f} ms) "
          f"against tp=1 {ref['tok_s']:.1f} ({ref['decode_tok_s']:.1f}, "
          f"{ref['chunk_ms']:.1f} ms); lone-512 TTFT {lead['ttft_ms']:.1f} "
          f"ms against {ref['ttft_ms']:.1f}; collectives alone "
          f"{json.dumps({k: round(v, 4) for k, v in coll.items()})} ms, "
          f"~{share:.0%} of a chunk; rank peaks "
          f"{[round(r['peak_gib'], 2) for r in ranks]} GiB; cuda_graphs=True "
          f"refused on the gloo mesh; walls: tp=1 "
          f"{t1 - t0:.1f} s, the ranks {t2 - t1:.1f} s [{SMI}]",
          flush=True)
    return {"gate": gate, "tp": lead, "ref": ref, "passes": passes,
            "collective_share": share,
            "counts": lead["counts"], "io": io_out}


def par_teacher(leg: str, ref32, reqs, wants, lead) -> dict:
    """An MoE leg's streams: routing is discontinuous (a router near tie
    that rounds the other way in bf16 moves a token's logits by
    O(0.1-1)), so instead of ``kv_gate`` each greedy stream of rank 0 is
    teacher-forced through the f32 forward over the same weights with
    the ranks' own expert choices, as ``teacher_check`` does: every
    emitted token within δ of its position's max, the choices the f32
    router's own or a near tie's (``ROUTE_TIE``).  Counts the streams
    equal to tp=1's beside."""
    params32, cfg32 = ref32
    greedy = [(r, t) for r, t in zip(reqs, lead["tokens"])
              if not r.get("temperature")]
    worst_gap = worst_lost = 0.0
    flips = choices = 0
    for (req, toks), forced in zip(greedy, lead["forced"]):
        gap, _, tap = emitted_gap(params32, cfg32, req["tokens"], toks,
                                  [torch.from_numpy(f).to(DEV)
                                   for f in forced])
        worst_gap = max(worst_gap, float(gap.max()))
        worst_lost = max(worst_lost, tap.most_lost())
        flips += tap.differing()
        choices += sum(c.shape[0] for c in tap.choices)
    equal = sum(w == g for w, g in zip(wants, lead["tokens"]))
    print(f"parallel {leg}: {len(greedy)} greedy streams teacher-forced "
          f"with the ranks' expert choices: the largest gap {worst_gap:.3f} "
          f"(δ {DELTA}); the choices differ from the f32 router's in "
          f"{flips} of {choices} (layer, position) pairs, giving up at most "
          f"{worst_lost:.4f} (tol {ROUTE_TIE}); {equal}/{len(wants)} "
          f"streams equal to tp=1's", flush=True)
    check(worst_gap <= DELTA and worst_lost <= ROUTE_TIE,
          f"parallel {leg}: a teacher-forced token {worst_gap:.3f} below "
          f"its max, or {worst_lost:.4f} of router probability given up")
    return {"equal": equal, "of": len(wants), "worst_gap": worst_gap,
            "worst_lost": worst_lost}


def par_nccl_leg(io_ref: dict) -> dict:
    """Qwen on a one-rank NCCL mesh with CUDA graphs, in this process:
    the collectives are captured inside every graph, and each replay
    runs them (counted by replay, ``ops/counts.py``).  Held to the
    engine with no mesh: a sum over one rank and a gather of one are
    copies, so the streams must be the same token for token.  Then the
    block I/O leg's host tier, parking and held-KV round trip on the
    mesh with graphs (``par_nccl_io``), held to ``io_ref``, the tp=1
    engine's run of the same steps."""
    import torch.distributed as dist

    from oim_tpu_torch.parallel import build_mesh

    reqs, _ = par_requests(VOCAB)
    plain, ref = par_ref(PAR_QWEN, "", graphs=True)
    params = plain.params  # one rank of one: its shard is the whole
    del plain
    release()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda:0"))
    try:
        mesh = build_mesh(tp=1)
        engine = par_engine(PAR_QWEN, "", mesh, graphs=True, params=params)
        run = par_drive(engine, VOCAB, warm=True)
        check(run["tokens"] == ref["tokens"],
              "parallel nccl: streams differ from the engine with no mesh")
        passes = par_counts_check("nccl", run, PAR_QWEN)
        par_collectives_check("nccl", run, PAR_QWEN, passes)
        stats = run["stats"]
        check(stats["graph_replays"] > 0 and stats["admission_replays"] > 0
              and stats["graph_replays"] * PAR_ENGINE["chunk"]
              == stats["decode_passes"],
              f"parallel nccl: not every dispatch a replay: {stats}")
        print(f"parallel nccl: one NCCL rank, graphs: {len(reqs)} streams "
              f"equal to the engine with no mesh; {stats['graph_replays']} "
              f"decode and {stats['admission_replays']} admission replays "
              f"carried {run['counts']['collective.all_reduce']} sums and "
              f"{run['counts']['collective.all_gather']} gathers; 8 streams "
              f"{run['tok_s']:.1f} tok/s (decode {run['decode_tok_s']:.1f}) "
              f"against {ref['tok_s']:.1f} ({ref['decode_tok_s']:.1f}) with "
              f"no mesh; lone-512 TTFT {run['ttft_ms']:.1f} ms against "
              f"{ref['ttft_ms']:.1f} [{SMI}]", flush=True)
        del engine
        release()
        io = par_nccl_io(params, mesh, io_ref)
    finally:
        del params
        dist.destroy_process_group()
        release()
    return {"run": run, "ref": ref, "io": io}


def par_nccl_io(params, mesh, io_ref: dict, fields: dict = PAR_QWEN) -> dict:
    """The io engine on the one-rank NCCL mesh with graphs: the host
    tier, parking and a held-KV round trip (``PAR_IO_NCCL``) give the
    tp=1 engine's streams and counters exactly, K1/K2 once a layer a
    pass by replay; then one admission wave and one decode chunk, each
    run eagerly and by replay from one state, bit-equal
    (``admit_check``, ``chunk_twice``)."""
    from oim_tpu_torch.ops import counts as kernel_counts
    from oim_tpu_torch.serve.engine import GenRequest

    engine = par_io_engine(params, fields, mesh, graphs=True)
    engine.warmup()
    sync()
    kernel_counts.reset_counters()
    before = engine.stats()
    t0 = time.monotonic()
    run = par_io_run(engine, par_io_steps(None, fields["vocab_size"]))
    wall = time.monotonic() - t0
    counts = kernel_counts.counters()
    stats = engine.stats()
    passes = sum(stats[k] - before[k] for k in ("decode_passes",
                                                 "prefill_dispatches"))
    differ = [name for name in PAR_IO_NCCL
              if name != "stats" and run["outputs"][name] != io_ref[name]]
    check(not differ, f"parallel nccl io: {differ} differ from the engine "
          f"with no mesh")
    tier = run["outputs"]["stats"]
    check(tier["kv_demotions"] > 0 and tier["kv_promotions"] > 0
          and tier["kv_parks"] > 0 and tier["kv_unparks"] == tier["kv_parks"],
          f"parallel nccl io: the tier's routes were not all taken: {tier}")
    check(run["outputs"]["round_trip"]["bitwise"],
          "parallel nccl io: the round trip changed the shipped bytes")
    n_layers = fields["n_layers"]
    check(counts["paged_flash_decode"] == counts["paged_kv_store"]
          == n_layers * passes > 0 and not counts["paged_flash_decode_plain"]
          and not counts["paged_kv_store_plain"]
          and stats["graph_replays"] > before["graph_replays"],
          f"parallel nccl io: K1/K2 {counts['paged_flash_decode']}/"
          f"{counts['paged_kv_store']} for {passes} passes")
    p = par_io_prompts(fields["vocab_size"])
    engine.set_pipeline_depth(1)
    for name, kw in (("d1", {}), ("d2", dict(temperature=0.9, seed=13))):
        engine.submit(GenRequest(tokens=p[name], max_new_tokens=16, **kw))
    admit_check(engine, "parallel nccl io", "two prompts on the mesh", 2, 0)
    engine.step()
    eager, replayed = engine.chunk_twice()
    same = all(torch.equal(eager[k], replayed[k])
               for k in ("out", "lps", "carry")) and all(
        torch.equal(a, b) for a, b in zip(eager["state"], replayed["state"]))
    check(same, "parallel nccl io: a decode chunk's replay differs from "
          "eager on the mesh")
    engine.run()
    print(f"parallel nccl io: one NCCL rank, graphs, paged with a host tier "
          f"and a QoS policy: the host tier, parking and a held-KV round "
          f"trip give the engine with no mesh's {len(PAR_IO_NCCL) - 1} "
          f"outputs exactly ({json.dumps(run['outputs']['stats'])}); K1/K2 "
          f"{counts['paged_flash_decode']} launches for {passes} passes by "
          f"replay; an admission wave and a decode chunk eager = replay "
          f"bitwise; {wall:.1f} s [{SMI}]", flush=True)
    del engine
    release()
    return {"stats": run["outputs"]["stats"], "passes": passes,
            "counts": {k: counts[k] for k in (
                "paged_flash_decode", "paged_kv_store",
                "paged_flash_decode_rows8", "paged_flash_decode_tc",
                "paged_kv_store_t1")},
            "wall_s": wall}


def par_bootstrap_leg(package: str) -> dict:
    """``serve_main --bootstrap`` on a file staging ``/dev/nvidia0``:
    the binding logged before CUDA starts, one request served (two
    layers at Qwen's widths, no warmup); then ``--tp 2`` on this one
    card refused before any work."""
    import re
    import signal
    import subprocess

    work = tempfile.mkdtemp(prefix=".smoke-par-", dir=HERE)
    path = os.path.join(work, "tpu-bootstrap.json")
    with open(path, "w") as f:
        json.dump({"volume_id": "smoke", "mesh": [1], "num_processes": 1,
                   "chips": [{"device_path": "/dev/nvidia0"}]}, f)
    args = serve_args("--no-warmup", "--watchdog-interval", "0",
                      "--drain-timeout", "0")
    env = dict(os.environ, PYTHONPATH=package)
    env.pop("CUDA_VISIBLE_DEVICES", None)
    base = [sys.executable, "-m", "oim_tpu_torch.cli.serve_main"]
    # Both processes at once: the refusal needs no card time.
    tp2 = subprocess.Popen(base + args + ["--tp", "2"], cwd=package,
                           env=env, stdout=subprocess.DEVNULL,
                           stderr=subprocess.PIPE, text=True)
    proc = subprocess.Popen(base + args + ["--bootstrap", path], cwd=package,
                            env=env, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    lines, listening = [], threading.Event()

    def read():
        for line in proc.stderr:
            lines.append(line)
            if "oim-serve listening" in line:
                listening.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        listening.wait(300)
        match = next((re.search(r"port=(\d+)", ln) for ln in lines
                      if "oim-serve listening" in ln), None)
        check(match is not None, "parallel bootstrap: serve_main never "
              "listened: " + "".join(lines[-5:]))
        reply = http_ok(int(match.group(1)), {"tokens": list(range(1, 65)),
                                              "max_new_tokens": 8})
        proc.send_signal(signal.SIGTERM)
        check(proc.wait(timeout=60) == 0, "parallel bootstrap: exit code")
        reader.join(timeout=10)
        _, refused = tp2.communicate(timeout=300)
    finally:
        for p in (proc, tp2):
            if p.poll() is None:
                p.kill()
                p.wait()
        proc.stderr.close()
        shutil.rmtree(work, ignore_errors=True)
    check(tp2.returncode != 0 and "need 2 devices, have 1" in refused,
          f"parallel bootstrap: --tp 2 on one card: rc {tp2.returncode}, "
          f"{refused[-300:]}")
    text = "".join(lines)
    binding = next((ln for ln in lines if " chip binding " in ln), "")
    check("CUDA_VISIBLE_DEVICES" in binding and "'0'" in binding
          and text.index(" chip binding ") < text.index("oim-serve listening")
          and "after CUDA initialized" not in text,
          f"parallel bootstrap: binding line {binding!r}")
    check(len(reply["tokens"]) == 8, f"parallel bootstrap: reply {reply}")
    print(f"parallel bootstrap: serve_main --bootstrap (/dev/nvidia0) logged "
          f"{binding.strip()[:160]!r} before CUDA, served a request; --tp 2 "
          f"refused: {refused.strip().splitlines()[-1][:120]!r} "
          f"[{SMI}]", flush=True)
    return {"binding": binding.strip(), "tokens": reply["tokens"]}


def paged_rank_phase(pa, gen, h: int, kvh: int, tag: str,
                     suffix: str) -> dict:
    """K1 and K2 at the block I/O leg's shapes (``PAR_IO_ENGINE``): the
    paged pool's 16-row blocks behind tables of ``max_len / 16`` entries,
    two slots, ``h`` query and ``kvh`` kv heads — K1 at decode (contexts
    299 and 64) and at an admission of two 128-token prompts, K2 at t=1
    and t=128.  bf16; returns the records, keyed with ``suffix``."""
    rng = np.random.RandomState(20)
    n_blocks = 64
    n_tables = PAR_IO_ENGINE["max_len"] // BS
    k_pool, v_pool, _, _ = make_pool(gen, n_blocks, False, BS, kvh, HD)
    positions = [299, 64]
    tables = torch.from_numpy(np.ascontiguousarray(make_tables(
        rng, 2, positions, n_blocks)[:, :n_tables])).cuda()
    starts = torch.tensor(positions, dtype=torch.int32, device="cuda")
    q = torch.randn((2, 1, h, HD), generator=gen,
                    device="cuda").to(torch.bfloat16)
    none = slice(0, 0)
    k1 = k1_phase(f"decode bf16 {tag} B=2 t=1", pa,
                  (q, k_pool, v_pool, None, None, tables, starts), none,
                  (1, 2, 4), (0, 256))
    dk = torch.randn((2, 1, kvh, HD), generator=gen,
                     device="cuda").to(torch.bfloat16)
    k2d = k2_phase(f"bf16 {tag} B=2 t=1", pa, dk, dk.clone(),
                   [k_pool.clone(), v_pool.clone()], [None, None], tables,
                   starts)
    t, pstarts = 128, [37, 200]
    ptables = torch.from_numpy(np.ascontiguousarray(make_tables(
        rng, 2, [p + t - 1 for p in pstarts], n_blocks)[:, :n_tables])).cuda()
    pst = torch.tensor(pstarts, dtype=torch.int32, device="cuda")
    k_new, v_new = (torch.randn((2, t, kvh, HD), generator=gen,
                                device="cuda").to(torch.bfloat16)
                    for _ in range(2))
    qp = torch.randn((2, t, h, HD), generator=gen,
                     device="cuda").to(torch.bfloat16)
    pools = [k_pool.clone(), v_pool.clone()]
    k2 = k2_phase(f"bf16 {tag} B=2 t={t}", pa, k_new, v_new, pools,
                  [None, None], ptables, pst)
    k1t = k1_phase(f"prefill bf16 {tag} B=2 t={t}", pa,
                   (qp, *pools, None, None, ptables, pst), none,
                   PREFILL_SPLITS, (0, 256))
    del k_pool, v_pool, pools
    torch.cuda.empty_cache()
    return {"K1" + suffix: k1, "K1t" + suffix: k1t, "K2" + suffix: k2,
            "K2d" + suffix: k2d}


def par_kernel_phase() -> dict:
    """K1/K2 at the ranks' head counts (Qwen tp=2: 6 q and 1 kv head;
    Mixtral tp2·ep2: 16 and 4) on the dense cache's shapes, Qwen's on
    the block I/O leg's paged shapes too, and ``quant_matmul`` at the
    tp2·ep2 ranks' int8 shapes."""
    from oim_tpu_torch.ops import paged_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(19)
    record = dense_kernel_phase(pa, gen, H // 2, KVH // 2,
                                f"dense tp=2 rank H={H // 2} KVH={KVH // 2}",
                                "_tp")
    record.update(paged_rank_phase(
        pa, gen, H // 2, KVH // 2,
        f"paged tp=2 rank H={H // 2} KVH={KVH // 2}", "_tpio"))
    record.update(dense_kernel_phase(
        pa, gen, MOE_H // 2, MOE_KVH // 2,
        f"dense tp2·ep2 rank H={MOE_H // 2} KVH={MOE_KVH // 2}", "_tpmoe"))
    for names, shape in PAR_QMM:
        out = torch.float32 if names == "wlm" else None
        record[f"QMM par {names}"] = qmm_case(
            f"tp2·ep2 rank int8 {names} {list(shape)} x {QMM_ROWS} rows",
            gen, "int8", shape, QMM_ROWS, names == "w_out", out)
    return record


# The block I/O leg (``par_io``): Qwen at tp=2 on the paged pool of
# 16-row blocks with a host tier and a QoS policy, two slots so that a
# premium arrival preempts.  12 pool blocks: two 64-token prompts' worst
# cases (5 blocks each) do not fit beside a stored 4-block prefix entry,
# which is therefore demoted, then promoted by a hit; two best-effort
# streams of 16 tokens fill both slots, and a premium arrival parks
# one.  The tier holds 16 whole blocks (over all the model's kv heads:
# each rank pins its half).  Serial decode (depth 1): a step of at most
# 8 tokens is one chunk, none dispatched ahead past a request's end (a
# gloo pass takes ~0.15 s at 28 layers); the CPU tests hold depth 2
# under a mesh.
PAR_IO_ENGINE = dict(n_slots=2, max_len=512, chunk=8,
                     prompt_buckets=(64, 128), kv_block=16, kv_blocks=12,
                     prefix_cache_size=2, pipeline_depth=1)
PAR_IO_HOST_BLOCKS = 16
PAR_IO_POLICY = ('{"tenants": {"user.gold": {"tier": "premium"}, '
                 '"user.lead": {"tier": "best_effort"}}}')
PAR_IO_KEYS = ("kv_demotions", "kv_promotions", "kv_parks", "kv_unparks",
               "kv_demote_bytes", "kv_promote_bytes", "prefix_demotions",
               "prefix_evictions", "prefix_hits", "kv_host_blocks_total",
               "qos_preemptions", "kv_exports", "kv_imports",
               "kv_ship_bytes", "slot_exports", "slot_imports",
               "migrated_slots", "kv_holds", "kv_imports_staged")


def par_io_prompts(vocab: int) -> dict:
    """The leg's prompts, from a fixed seed."""
    rng = np.random.RandomState(20)
    out = {name: rng.randint(0, vocab, n).tolist() for name, n in (
        ("entry", 64), ("p1", 64), ("p2", 64), ("tail", 16),
        ("lead1", 64), ("lead2", 64), ("gold", 64), ("held", 64),
        ("trip", 64), ("slot", 64), ("beam", 32), ("embed", 48),
        ("d1", 64), ("d2", 32))}
    out["hit"] = out["entry"] + out["tail"]
    return out


def par_io_source(engine) -> dict:
    """What tp=1 ships to the ranks: a held request's (tokens, manifest,
    arrays) and a live sampled slot's (manifest, arrays)."""
    p = par_io_prompts(engine.cfg.vocab_size)
    return {"held": par_io_ops["hold"](engine, dict(tokens=p["held"],
                                                     max_new_tokens=4)),
            "slot": par_io_ops["suspend"](engine, PAR_IO_SLOT | dict(
                tokens=p["slot"]), 4)}


PAR_IO_SLOT = dict(max_new_tokens=16, temperature=0.7, seed=21)
# The embedding against tp=1's: the largest difference and the cosine.
PAR_IO_EMBED_ATOL = 2.5e-3
PAR_IO_EMBED_COS = 0.9995


# The steps the one-rank NCCL mesh runs with graphs.
PAR_IO_NCCL = ("store", "pressure", "hit", "qos", "round_trip", "stats")


def par_io_steps(source: dict, vocab: int) -> list:
    """(name, op, args) of the leg's traffic, the same on tp=2 and on
    tp=1: the host tier (store, pressure → demotion, hit → promotion), a
    QoS preemption (park and restore), held KV and a slot from ``source``
    imported and continued, a held export, a round trip, a slot
    suspended, embed, a beam while two streams decode.  With no ``source``, the steps of ``PAR_IO_NCCL``."""
    p = par_io_prompts(vocab)
    lead = dict(max_new_tokens=16, tenant="user.lead")
    if source is None:
        source = {"held": ([], {}, []), "slot": ({"tokens": []}, [])}
    held_tokens = source["held"][0]
    slot_prior = len(source["slot"][0]["tokens"])
    steps = [
        ("store", "gen", ([dict(tokens=p["entry"], max_new_tokens=2,
                                cache_prefix=True)],)),
        ("pressure", "gen", ([dict(tokens=p["p1"], max_new_tokens=8),
                              dict(tokens=p["p2"], max_new_tokens=8)],)),
        ("hit", "gen", ([dict(tokens=p["hit"], max_new_tokens=8)],)),
        ("qos", "late", ([dict(lead, tokens=p["lead1"], seed=7),
                          dict(lead, tokens=p["lead2"], seed=9,
                               temperature=0.8)], 1,
                         [dict(tokens=p["gold"], max_new_tokens=8,
                               tenant="user.gold")])),
        ("import_held", "import_kv", (*source["held"][1:], dict(
            tokens=p["held"] + held_tokens, max_new_tokens=4))),
        ("hold", "hold", (dict(tokens=p["held"], max_new_tokens=4),)),
        ("round_trip", "round_trip", (dict(tokens=p["trip"],
                                           max_new_tokens=4),)),
        ("suspend", "suspend", (PAR_IO_SLOT | dict(tokens=p["slot"]), 4)),
        ("import_slot", "import_slot", (*source["slot"], dict(
            PAR_IO_SLOT, max_new_tokens=PAR_IO_SLOT["max_new_tokens"]
            - slot_prior))),
        ("embed", "embed", (p["embed"],)),
        ("beam_during", "beam_during", (
            [dict(tokens=p["d1"], max_new_tokens=8),
             dict(tokens=p["d2"], max_new_tokens=8, temperature=0.9,
                  seed=13)], (p["beam"], 8, 2))),
        ("stats", "stats", ()),
    ]
    if not held_tokens:
        return [step for step in steps if step[0] in PAR_IO_NCCL]
    return steps


def _io_gen(engine, requests: list) -> list:
    from oim_tpu_torch.serve.engine import GenRequest

    rids = [engine.submit(GenRequest(**r)) for r in requests]
    engine.run()
    return [list(engine.result(rid, timeout=0)) for rid in rids]


def _io_late(engine, early: list, steps: int, late: list) -> list:
    from oim_tpu_torch.serve.engine import GenRequest

    rids = [engine.submit(GenRequest(**r)) for r in early]
    for _ in range(steps):
        engine.step()
    rids += [engine.submit(GenRequest(**r)) for r in late]
    engine.run()
    return [list(engine.result(rid, timeout=0)) for rid in rids]


def _io_hold(engine, request: dict) -> tuple:
    from oim_tpu_torch.serve.engine import GenRequest

    rid = engine.submit(GenRequest(**request, hold_kv=True))
    engine.run()
    tokens = list(engine.result(rid, timeout=0))
    t0 = time.monotonic()
    manifest, arrays = engine.export_kv(rid)
    engine._io_walls.append(("export", time.monotonic() - t0,
                             sum(a.nbytes for a in arrays)))
    engine.release_kv_hold(rid)
    return tokens, manifest, [a.cpu() for a in arrays]


def _io_import(engine, manifest: dict, arrays: list) -> int:
    names = [leaf["name"] for leaf in manifest["leaves"]]
    t0 = time.monotonic()
    import_id, _ = engine.import_kv(manifest, dict(zip(names, arrays)))
    engine._io_walls.append(("import", time.monotonic() - t0,
                             sum(a.nbytes for a in arrays)))
    return import_id


def _io_import_kv(engine, manifest, arrays, request) -> list:
    import_id = _io_import(engine, manifest, arrays)
    return _io_gen(engine, [dict(request, kv_import=import_id)])[0]


def _io_round_trip(engine, request: dict) -> dict:
    """Held, exported (E1), imported and continued by one token under a
    hold, exported again (E2): whether E2's first rows are E1's bytes."""
    tokens, manifest, arrays = _io_hold(engine, request)
    import_id = _io_import(engine, manifest, arrays)
    _, again, arrays2 = _io_hold(engine, dict(
        request, tokens=request["tokens"] + tokens, max_new_tokens=1,
        kv_import=import_id))
    rows = manifest["rows"]

    def head(a):
        return a.reshape(a.shape[0], -1, *a.shape[3:])[:, :rows]

    same = all(torch.equal(head(a).view(torch.uint8),
                           head(b).view(torch.uint8))
               for a, b in zip(arrays, arrays2))
    return {"bitwise": same, "rows": rows, "rows_again": again["rows"]}


def _io_suspend(engine, request: dict, min_tokens: int) -> tuple:
    from oim_tpu_torch.serve.engine import GenRequest

    rid = engine.submit(GenRequest(**request))
    base = engine.stats()["tokens_generated"]
    for _ in range(40):
        engine.step()
        if engine.stats()["tokens_generated"] - base >= min_tokens:
            break
    engine.begin_migrate_out()
    engine.run()
    manifest, arrays = engine.export_slot(rid)
    engine.release_migrated(rid)
    engine._draining = engine._migrate_out = False
    return manifest, [a.cpu() for a in arrays]


def _io_import_slot(engine, manifest, arrays, request) -> list:
    names = [leaf["name"] for leaf in manifest["leaves"]]
    import_id, _, slot = engine.import_slot(manifest, dict(zip(names,
                                                               arrays)))
    tokens = list(manifest["prompt_tokens"]) + list(manifest["tokens"])
    return _io_gen(engine, [dict(request, tokens=tokens, kv_import=import_id,
                                 sample_base=slot["sample_base"])])[0]


def _io_beam_during(engine, requests: list, beam: tuple) -> dict:
    """A beam search while ``requests`` decode on a step thread: the
    streams, the beam, and how long the beam held the step loop (its
    wall: the dispatches wait for the whole search)."""
    from oim_tpu_torch.serve.engine import GenRequest

    rids = [engine.submit(GenRequest(**r)) for r in requests]
    stepper = threading.Thread(target=engine.run)
    stepper.start()
    try:
        t0 = time.monotonic()
        found = engine.beam(*beam)
        wall = time.monotonic() - t0
    finally:
        stepper.join()
    return {"streams": [list(engine.result(rid, timeout=0)) for rid in rids],
            "beam": found, "beam_s": wall}


par_io_ops = {
    "gen": _io_gen, "late": _io_late, "hold": _io_hold,
    "import_kv": _io_import_kv, "round_trip": _io_round_trip,
    "suspend": _io_suspend, "import_slot": _io_import_slot,
    "embed": lambda e, tokens: e.embed(tokens),
    "beam_during": _io_beam_during,
    "stats": lambda e: {k: e.stats()[k] for k in PAR_IO_KEYS},
}


def par_io_engine(params, fields: dict, mesh, graphs: bool):
    """The leg's engine over ``params`` of model ``fields``: a host tier
    of ``PAR_IO_HOST_BLOCKS`` whole blocks (every kv head's bytes)."""
    from oim_tpu_torch.models.transformer import TransformerConfig
    from oim_tpu_torch.qos.policy import decode_policy
    from oim_tpu_torch.serve.engine import Engine

    cfg = TransformerConfig(**fields)
    block = (2 * cfg.n_layers * cfg.kv_heads * cfg.head_dim
             * cfg.compute_dtype.itemsize * PAR_IO_ENGINE["kv_block"])
    engine = Engine(params, cfg, mesh=mesh, cuda_graphs=graphs,
                    qos=decode_policy(PAR_IO_POLICY),
                    device=None if mesh is not None else DEV,
                    kv_host_bytes=PAR_IO_HOST_BLOCKS * block,
                    **PAR_IO_ENGINE)
    engine._io_walls = []
    return engine


def par_io_run(engine, steps: list) -> dict:
    """``steps`` on ``engine`` (a mesh's leader, or one device): each
    step's output and wall by name, the export/import walls, and the
    tier's promote/demote rates from its counters."""
    out, walls = {}, {}
    for name, op, args in steps:
        t0 = time.monotonic()
        out[name] = par_io_ops[op](engine, *args)
        sync()
        walls[name] = time.monotonic() - t0
    stats = engine.stats()
    return {"outputs": out, "walls": walls, "ship": engine._io_walls,
            "tier": {k: stats[k] for k in (
                "kv_demote_bytes", "kv_demote_seconds", "kv_promote_bytes",
                "kv_promote_seconds")}}


def par_weights_sha(port: int) -> dict:
    """SHA-256 of ``GET /v1/weights`` read in 8 MiB pieces (never held
    whole), with its bytes and wall."""
    import hashlib

    sha, n = hashlib.sha256(), 0
    t0 = time.monotonic()
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/weights",
                                timeout=600) as resp:
        while True:
            piece = resp.read(8 << 20)
            if not piece:
                break
            sha.update(piece)
            n += len(piece)
    return {"sha": sha.hexdigest(), "bytes": n,
            "s": time.monotonic() - t0}


def same_bytes(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two tensors hold the same dtype, shape and bytes."""
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8),
        b.contiguous().reshape(-1).view(torch.uint8)))


def par_io_rank(rank: int, mesh, params, io: dict) -> dict:
    """One rank's block I/O leg (``par_io``) on its shard ``params``: the
    io engine (eager over gloo); rank 0 runs ``par_io_steps`` and serves
    ``/v1/weights`` once while the others follow; then every rank loads
    the tp=1 peer's stream (``load_params_from_peer`` on the mesh, what
    ``serve_main --params-peer`` runs) and holds it to its drawn shard
    bitwise.  Every rank's K1/K2 launches and buffers come back."""
    from oim_tpu_torch.checkpoint import load_params_from_peer
    from oim_tpu_torch.models.transformer import TransformerConfig
    from oim_tpu_torch.models.train import named_parameters
    from oim_tpu_torch.ops import counts as kernel_counts
    from oim_tpu_torch.serve.server import ServeServer

    fields = io["fields"]
    engine = par_io_engine(params, fields, mesh, graphs=False)
    sync()
    kernel_counts.reset_counters()
    before = engine.stats()
    answer = {}
    if rank == 0:
        t0 = time.monotonic()
        try:
            answer = par_io_run(engine, par_io_steps(
                io["source"], fields["vocab_size"]))
            counts = kernel_counts.counters()
            stats = engine.stats()
            answer["passes"] = sum(stats[k] - before[k] for k in (
                "decode_passes", "prefill_dispatches"))
            server = ServeServer(engine, port=0).start()
            try:
                answer["weights"] = par_weights_sha(server.port)
            finally:
                server.stop()
        finally:
            engine.stop_followers()
        answer["wall_s"] = time.monotonic() - t0
    else:
        engine.follow()
        counts = kernel_counts.counters()
    answer["counts"] = {k: counts[k] for k in (
        "paged_flash_decode", "paged_kv_store", "paged_flash_decode_plain",
        "paged_kv_store_plain", "paged_flash_decode_rows8",
        "paged_flash_decode_tc", "paged_kv_store_t1")}
    answer["buffers"] = par_buffers(engine)
    del engine
    if DEV == "cuda":
        release()
    t0 = time.monotonic()
    loaded = load_params_from_peer(io["url"], TransformerConfig(**fields),
                                   mesh.device, mesh=mesh)
    sync()
    answer["peer_s"] = time.monotonic() - t0
    drawn = dict(named_parameters(params))
    answer["peer_bad"] = [name for name, t in named_parameters(loaded)
                          if not same_bytes(t, drawn[name])]
    answer["peer_tensors"] = len(drawn)
    del loaded
    if DEV == "cuda":
        release()
    return answer


def par_io_check(ios: list, ref_engine, ref_io: dict, source: dict,
                 ref32, weights: dict) -> dict:
    """The block I/O leg (``ios``: every rank's answer) against tp=1 on
    the same traffic: every stream equal or parting at a near tie
    (``kv_gate``) — shipped continuations as whole streams against tp=1's
    unbroken runs, tp=2's held KV and slot continued on tp=1 too —, tier
    and ship counters equal, the round trip bitwise, every rank's buffers
    rank 0's, K1 and K2 once a layer a pass on every rank with no plain
    call, beam and embed close to tp=1's, the weights stream byte-equal,
    and the peer's stream loaded into every rank's drawn shard bitwise."""
    lead = ios[0]
    got, want = lead["outputs"], ref_io["outputs"]
    vocab = ref_engine.cfg.vocab_size
    p = par_io_prompts(vocab)
    steps = {name: args for name, _, args in par_io_steps(source, vocab)}
    reqs, wants, gots = [], [], []
    for name in ("store", "pressure", "hit", "qos"):
        args = steps[name]
        for r, w, g in zip(args[0] + (args[2] if name == "qos" else []),
                           want[name], got[name]):
            reqs.append(r)
            wants.append(w)
            gots.append(g)
    for r, w, g in zip(steps["beam_during"][0],
                       want["beam_during"]["streams"],
                       got["beam_during"]["streams"]):
        reqs.append(r)
        wants.append(w)
        gots.append(g)
    held = dict(tokens=p["held"], max_new_tokens=8)
    slot = PAR_IO_SLOT | dict(tokens=p["slot"])
    unbroken = par_io_ops["gen"](ref_engine, [held, slot])
    tokens, manifest, arrays = got["hold"]
    back = tokens + par_io_ops["import_kv"](ref_engine, manifest, arrays, dict(
        tokens=p["held"] + tokens, max_new_tokens=4))
    slot_m, slot_a = got["suspend"]
    slot_back = slot_m["tokens"] + par_io_ops["import_slot"](
        ref_engine, slot_m, slot_a, dict(
            PAR_IO_SLOT, max_new_tokens=PAR_IO_SLOT["max_new_tokens"]
            - len(slot_m["tokens"])))
    for r, w, g in (
            (held, unbroken[0], source["held"][0] + got["import_held"]),
            (slot, unbroken[1], source["slot"][0]["tokens"]
             + got["import_slot"]),
            (held, unbroken[0], back), (slot, unbroken[1], slot_back)):
        reqs.append(r)
        wants.append(w)
        gots.append(g)
    gate = kv_gate(ref32, "parallel io", reqs, wants, gots)
    check(got["stats"] == want["stats"],
          f"parallel io: tier and ship counters {got['stats']} differ from "
          f"tp=1's {want['stats']}")
    stats = got["stats"]
    check(stats["kv_demotions"] > 0 and stats["kv_promotions"] > 0
          and stats["kv_parks"] > 0 and stats["kv_unparks"] == stats[
              "kv_parks"] and stats["qos_preemptions"] > 0,
          f"parallel io: the tier's routes were not all taken: {stats}")
    check(got["round_trip"]["bitwise"],
          "parallel io: a tp=2 round trip changed the shipped bytes")
    hm, wm = manifest, want["hold"][1]
    check([(leaf["name"], leaf["dtype"], leaf["shape"]) for leaf in
           hm["leaves"]] == [(leaf["name"], leaf["dtype"], leaf["shape"])
                             for leaf in wm["leaves"]]
          and hm["rows"] == wm["rows"],
          f"parallel io: tp=2's held manifest {hm} is not tp=1's {wm}")
    bad = [(r, name) for r, io in enumerate(ios[1:], 1)
           for name, dg in io["buffers"].items()
           if dg != lead["buffers"][name]]
    check(not bad, f"parallel io: buffers differ from rank 0's: {bad}")
    n_layers = ref_engine.cfg.n_layers
    for r, io in enumerate(ios):
        c = io["counts"]
        if DEV == "cuda":
            check(c["paged_flash_decode"] == c["paged_kv_store"]
                  == n_layers * lead["passes"] > 0
                  and not c["paged_flash_decode_plain"]
                  and not c["paged_kv_store_plain"],
                  f"parallel io: rank {r}'s K1/K2 launches {c} are not "
                  f"{n_layers} x {lead['passes']} passes with no plain call")
        check(not io["peer_bad"],
              f"parallel io: rank {r}'s peer-loaded shard differs from its "
              f"drawn one at {io['peer_bad'][:4]}")
    beam, ref_beam = got["beam_during"]["beam"], want["beam_during"]["beam"]
    check(abs(beam[1] - ref_beam[1]) <= 0.05,
          f"parallel io: beam score {beam[1]} against tp=1's {ref_beam[1]}")
    vec, ref_vec = np.asarray(got["embed"]), np.asarray(want["embed"])
    emb = float(np.max(np.abs(vec - ref_vec)))
    cos = float(vec @ ref_vec / (np.linalg.norm(vec)
                                 * np.linalg.norm(ref_vec)))
    # A unit vector of d_model values (~0.026 each at Qwen's 1536): a
    # misplaced shard moves every value by about that much; bf16 tp=2
    # against tp=1 moved the largest by 8e-4 in four runs.
    check(emb <= PAR_IO_EMBED_ATOL and cos >= PAR_IO_EMBED_COS,
          f"parallel io: embed differs from tp=1's by {emb} (cosine "
          f"{cos}; bounds {PAR_IO_EMBED_ATOL}, {PAR_IO_EMBED_COS})")
    check(lead["weights"]["sha"] == weights["sha"]
          and lead["weights"]["bytes"] == weights["bytes"],
          "parallel io: the tp=2 /v1/weights stream differs from tp=1's")
    return {"gate": gate, "stats": stats, "embed_err": emb,
            "embed_cos": cos, "beam_equal": beam[0] == ref_beam[0]}


def par_io_report(ios: list, ref_io: dict, check_out: dict,
                  weights: dict) -> dict:
    """The leg's line: rates and walls beside tp=1's."""
    lead = ios[0]
    mb = 1e6

    def per_mb(io, kind):
        rows = [(s, n) for k, s, n in io["ship"] if k == kind]
        return (sum(s for s, _ in rows) * 1e3 / (sum(n for _, n in rows) / mb)
                if rows else float("nan"))

    def tier_gbs(io, kind, share):
        t = io["tier"]
        sec = t[f"kv_{kind}_seconds"]
        return t[f"kv_{kind}_bytes"] * share / sec / 1e9 if sec else 0.0

    gbs = lead["weights"]["bytes"] / lead["weights"]["s"] / 1e9
    ref_gbs = weights["bytes"] / weights["s"] / 1e9
    out = {
        "promote_gbs_rank": tier_gbs(lead, "promote", 0.5),
        "demote_gbs_rank": tier_gbs(lead, "demote", 0.5),
        "promote_gbs_tp1": tier_gbs(ref_io, "promote", 1.0),
        "demote_gbs_tp1": tier_gbs(ref_io, "demote", 1.0),
        "export_ms_per_mb": per_mb(lead, "export"),
        "import_ms_per_mb": per_mb(lead, "import"),
        "export_ms_per_mb_tp1": per_mb(ref_io, "export"),
        "import_ms_per_mb_tp1": per_mb(ref_io, "import"),
        "weights_gbs": gbs, "weights_gbs_tp1": ref_gbs,
        "peer_s": [io["peer_s"] for io in ios],
        "beam_pause_s": lead["outputs"]["beam_during"]["beam_s"],
        "beam_pause_s_tp1": ref_io["outputs"]["beam_during"]["beam_s"],
        "walls": lead["walls"], "walls_tp1": ref_io["walls"],
        "wall_s": lead["wall_s"]}
    gate = check_out["gate"]
    print(f"parallel io: Qwen tp=2 (two gloo ranks on cuda:0, eager) on "
          f"the paged pool with a host tier and a QoS policy: "
          f"{gate['equal']}/{gate['of']} streams equal to tp=1 (worst gap "
          f"{gate['worst_gap']:.3f}); counters equal to tp=1's "
          f"{json.dumps(check_out['stats'])}; round trip bitwise; every "
          f"rank's buffers equal, K1/K2 once a layer a pass on every rank; "
          f"promote {out['promote_gbs_rank']:.2f} GB/s a rank (tp=1 "
          f"{out['promote_gbs_tp1']:.2f}), demote landing "
          f"{out['demote_gbs_rank']:.2f} (tp=1 {out['demote_gbs_tp1']:.2f}); "
          f"export {out['export_ms_per_mb']:.2f} ms/MB (tp=1 "
          f"{out['export_ms_per_mb_tp1']:.2f}), import "
          f"{out['import_ms_per_mb']:.2f} (tp=1 "
          f"{out['import_ms_per_mb_tp1']:.2f}); /v1/weights {gbs:.3f} GB/s "
          f"byte-equal to tp=1's ({ref_gbs:.3f}); peer bring-up "
          f"{[round(s, 1) for s in out['peer_s']]} s a rank, shards "
          f"bitwise; a beam paused the streams {out['beam_pause_s']:.2f} s "
          f"(tp=1 {out['beam_pause_s_tp1']:.2f}), beam tokens "
          f"{'equal' if check_out['beam_equal'] else 'differ'}, embed within "
          f"{check_out['embed_err']:.2e} (cosine "
          f"{check_out['embed_cos']:.7f}); the leg {lead['wall_s']:.1f} s "
          f"[{SMI}]", flush=True)
    return out


def parallel_phase(package: str, record: dict) -> dict:
    """Sharded serving on the one card: the kernels at the ranks'
    shapes, Qwen2.5-1.5B at tp=2 (two gloo ranks sharing cuda:0,
    eager, 14 of its 28 layers), Qwen on a one-rank NCCL mesh with graphs,
    Mixtral-8x7B's widths at tp2·ep2 (four gloo ranks, int8, depth cut
    to ``PAR_MOE_LAYERS``), and ``serve_main --bootstrap``/``--tp 2``.
    Adds the kernel records to ``record``; returns the legs."""
    t0 = time.monotonic()
    record.update(par_kernel_phase())
    walls, out = {"kernels": time.monotonic() - t0}, {}
    for name, leg in (("qwen_tp2", lambda: par_leg("qwen_tp2", package)),
                      ("nccl", lambda: par_nccl_leg(
                          out["qwen_tp2"]["io"]["ref"])),
                      ("mixtral_tp2ep2",
                       lambda: par_leg("mixtral_tp2ep2", package)),
                      ("bootstrap", lambda: par_bootstrap_leg(package))):
        t = time.monotonic()
        out[name] = leg()
        walls[name] = time.monotonic() - t
    out["walls"] = walls
    print(f"parallel: phase {time.monotonic() - t0:.1f} s, by part "
          f"{json.dumps({k: round(v, 1) for k, v in walls.items()})} "
          f"[{SMI}]", flush=True)
    return out


def par_rows(record: dict, phase: dict) -> list[dict]:
    """The ``kernels`` rows of the ranks' shapes, with rank 0's
    launches in its leg."""
    src = "oim_tpu_torch/csrc/paged_attention.cu"
    rows = []
    for leg, suffix, where in (
            ("qwen_tp2", "_tp", f"a tp=2 rank of Qwen2.5-1.5B: H {H // 2} / "
                                f"KVH {KVH // 2}, dense cache"),
            ("mixtral_tp2ep2", "_tpmoe",
             f"a tp2·ep2 rank of Mixtral-8x7B's widths: H {MOE_H // 2} / "
             f"KVH {MOE_KVH // 2}, dense cache")):
        counts = phase[leg]["counts"]
        rows += [
            dict(name=f"paged_flash_decode (K1, decode route: "
                      f"paged_decode_kernel<8> + merge; {where})",
                 route="cuda", source=src,
                 replaces="oim_tpu/ops/paged_attention.py:93",
                 launches=counts["paged_flash_decode_rows8"],
                 **record["K1" + suffix]),
            dict(name=f"paged_flash_decode (K1, tall route: "
                      f"paged_prefill_tc_kernel; admissions, timed at "
                      f"t=512; {where})", route="cuda", source=src,
                 replaces="oim_tpu/ops/paged_attention.py:93",
                 launches=counts["paged_flash_decode_tc"],
                 **record["K1t" + suffix]),
            dict(name=f"paged_kv_store (K2, admissions, timed at t=512; "
                      f"{where})", route="cuda", source=src,
                 replaces="oim_tpu/ops/paged_attention.py:265",
                 launches=(counts["paged_kv_store"]
                           - counts["paged_kv_store_t1"]),
                 **record["K2" + suffix]),
            dict(name=f"paged_kv_store (K2, decode steps, t=1; {where})",
                 route="cuda", source=src,
                 replaces="oim_tpu/ops/paged_attention.py:265",
                 launches=counts["paged_kv_store_t1"],
                 **record["K2d" + suffix]),
        ]
    counts = phase["qwen_tp2"]["io"]["counts"]
    where = (f"the block I/O leg, a tp=2 rank of Qwen2.5-1.5B: H {H // 2} / "
             f"KVH {KVH // 2}, paged 16-row blocks")
    rows += [
        dict(name=f"paged_flash_decode (K1, decode route: "
                  f"paged_decode_kernel<8> + merge; {where})",
             route="cuda", source=src,
             replaces="oim_tpu/ops/paged_attention.py:93",
             launches=counts["paged_flash_decode_rows8"],
             **record["K1_tpio"]),
        dict(name=f"paged_flash_decode (K1, tall route: "
                  f"paged_prefill_tc_kernel; admissions, timed at t=128; "
                  f"{where})", route="cuda", source=src,
             replaces="oim_tpu/ops/paged_attention.py:93",
             launches=counts["paged_flash_decode_tc"],
             **record["K1t_tpio"]),
        dict(name=f"paged_kv_store (K2, admissions, timed at t=128; "
                  f"{where})", route="cuda", source=src,
             replaces="oim_tpu/ops/paged_attention.py:265",
             launches=(counts["paged_kv_store"]
                       - counts["paged_kv_store_t1"]),
             **record["K2_tpio"]),
        dict(name=f"paged_kv_store (K2, decode steps, t=1; {where})",
             route="cuda", source=src,
             replaces="oim_tpu/ops/paged_attention.py:265",
             launches=counts["paged_kv_store_t1"],
             **record["K2d_tpio"]),
    ]
    counts = phase["mixtral_tp2ep2"]["counts"]
    for names, shape in PAR_QMM:
        rec = dict(record[f"QMM par {names}"])
        route, key = rec.pop("route"), rec.pop("key")
        check(counts.get(key, 0) > 0, f"QMM par {names}: not launched on "
              f"its {route} route by the tp2·ep2 ranks")
        rows.append(dict(
            name=f"quant_matmul ({route} route: quant_matmul_kernel; int8 "
                 f"Mixtral {names} {list(shape)} on a tp2·ep2 rank, timed "
                 f"at {QMM_ROWS} rows)",
            route="cuda", source="oim_tpu_torch/csrc/wquant.cu",
            replaces="oim_tpu/ops/quant.py:53 (no Pallas kernel: XLA's "
                     "fused convert+scale in the product)",
            launches=counts[key], **rec))
    return rows


# ---------------------------------------------------------------------------
# Training over a mesh (train_parallel_phase)

# The dp legs: Qwen2.5-1.5B's widths at TPAR_LAYERS of its 28 layers, the
# training configuration's global 4 x 1024 batch split over two gloo
# ranks sharing cuda:0 (NCCL refuses two ranks on one card), for
# TPAR_STEPS steps; the tp leg at TPAR_TP_LAYERS, the ep leg at
# Mixtral-8x7B's widths and TPAR_EP_LAYERS; the one-rank NCCL leg at
# TPAR_NCCL_LAYERS (three runs of it).  Depths are the smoke's time: a
# dp step's gradient all-reduce (and ZeRO-1's all-gather) moves every
# parameter through the host over gloo, and the checkpoint writes and
# reads them: at 14 layers the dp legs took 151 s on an H100; 4 layers
# move 58 % of those bytes.
TPAR_LAYERS = 4
TPAR_STEPS = 3
TPAR_TP_LAYERS = 4
TPAR_EP_LAYERS = 1
TPAR_NCCL_LAYERS = 4
# A mesh's losses against one device's on the same batch: bf16 compute
# in another grouping (per-rank products of half the rows, the gradient
# summed over ranks in f32; under tp the products split along their
# reduction axis), held at the training phase's bf16 step tolerance.
TPAR_LOSS_ATOL = STEP_LOSS_ATOL[torch.bfloat16]
TPAR_KERNELS = ("rmsnorm", "flash_fwd", "flash_dq", "flash_dkv",
                "fused_ce_fwd", "fused_ce_bwd")


def tpar_args(layers: int, steps: int, *flags, base=None) -> list[str]:
    """The training command (``base``, default the training
    configuration's) at ``layers`` layers for ``steps`` steps, plus
    ``flags``."""
    args = list(TRAIN_ARGS if base is None else base)
    args[args.index("--n-layers") + 1] = str(layers)
    args[args.index("--steps") + 1] = str(steps)
    return args + list(flags)


def tpar_run(tag: str, argv: list, cuda_graph: bool = True) -> dict:
    """``train_main`` on ``argv`` in this process (rank 0 of a mesh, the
    others spawned by it), every count set to 0 just before; prints the
    losses, the ranks' peak GiB, moment GiB and dp all-reduce share."""
    from oim_tpu_torch.ops import counts

    release()
    torch.cuda.reset_peak_memory_stats()
    counts.reset_counters()
    t0 = time.monotonic()
    out = run_train(argv, cuda_graph=cuda_graph)
    out["wall"] = time.monotonic() - t0
    out["counts"] = counts.counters()
    steps = out["step_seconds"]
    line = (f"train_parallel {tag}: {len(out['losses'])} steps in "
            f"{out['wall']:.1f} s (setup included), losses "
            f"{[round(x, 6) for x in out['losses']]}, step walls "
            f"{[round(x * 1e3, 1) for x in steps]} ms")
    for r in out.get("ranks") or []:
        red = r["reduce_seconds"]
        share = (sum(red[-len(steps):]) / sum(steps)) if red and steps else 0
        line += (f"; rank {r['rank']}: peak {gib(r['peak_bytes']):.2f} GiB, "
                 f"params {gib(r['param_bytes']):.2f}, moments "
                 f"{gib(r['moment_bytes']):.2f} GiB, dp all-reduce "
                 f"{[round(x * 1e3, 1) for x in red]} ms ({share:.1%} of "
                 f"the steps)")
    print(f"{line} [{SMI}]", flush=True)
    return out


def tpar_kernel_counts(tag: str, out: dict, steps: int, layers: int,
                       on: bool) -> None:
    """Every rank launched the training kernels ``steps`` times their
    per-step formula (``check_train_counts``'s; no plain version), or,
    under tp or ep (the reference's gate), none of them."""
    per = {"rmsnorm": 4 * layers + 1, "flash_fwd": 2 * layers,
           "flash_dq": layers, "flash_dkv": layers, "fused_ce_fwd": 1,
           "fused_ce_bwd": 1}
    for r in out["ranks"]:
        c = r["counts"]
        for name, n in per.items():
            want = steps * n if on else 0
            check(c.get(name, 0) == want and c.get(f"{name}_plain", 0) == 0,
                  f"train_parallel {tag}: rank {r['rank']} launched {name} "
                  f"{c.get(name, 0)} times (plain {c.get(name + '_plain')}),"
                  f" expected {want}")


def tpar_replicas(tag: str, out: dict, want: dict | None = None) -> dict:
    """The replicated leaves' checksums, equal on every rank (and to
    ``want``'s where given)."""
    ranks = out["ranks"]
    first = ranks[0]["replicas"]
    for r in ranks[1:]:
        bad = [n for n in first if r["replicas"].get(n) != first[n]]
        check(not bad, f"train_parallel {tag}: replicated leaves differ "
              f"between rank 0 and rank {r['rank']}: {bad[:4]}")
    if want is not None:
        bad = [n for n in want if first.get(n) != want[n]]
        check(not bad, f"train_parallel {tag}: leaves differ from the "
              f"run held against: {bad[:4]}")
    return first


def tpar_close(tag: str, got: list, want: list, atol: float) -> float:
    gap = max(abs(a - b) for a, b in zip(got, want))
    print(f"train_parallel {tag}: losses {[round(x, 6) for x in got]} "
          f"against {[round(x, 6) for x in want]}: max |diff| {gap:.3e} "
          f"(gate {atol}) [{SMI}]", flush=True)
    check(len(got) == len(want) and all(np.isfinite(got)),
          f"train_parallel {tag}: losses {got}")
    check(gap <= atol, f"train_parallel {tag}: |diff| {gap} > {atol}")
    return gap


def tpar_dp_legs(work: str) -> dict:
    """(a) dp=2 over two gloo ranks on cuda:0 against one device, once
    without ZeRO-1 and once with it — the main path: the ZeRO-1 run
    checkpointed, interrupted after step 2 and resumed by the same
    command, which exports — and (e) that checkpoint restored onto one
    device and its export served by ``serve_main --params-dir``."""
    from oim_tpu_torch.checkpoint import Checkpointer, directory_bytes
    from oim_tpu_torch.cli import serve_main, train_main
    from oim_tpu_torch.models.train import (
        OptimizerConfig,
        TrainState,
        replica_checksums,
    )
    from oim_tpu_torch.models.transformer import init_params
    from oim_tpu_torch.ops import counts as kcounts
    from oim_tpu_torch.serve.engine import GenRequest

    layers, steps = TPAR_LAYERS, TPAR_STEPS
    dp = ["--dp", "2", "--backend", "gloo"]
    ckpt, export = os.path.join(work, "ckpt"), os.path.join(work, "export")
    one = tpar_run("one device", tpar_args(layers, steps))
    ref, one_peak = one["losses"], torch.cuda.max_memory_allocated()
    del one
    plain = tpar_run("dp=2", tpar_args(layers, steps, *dp))
    gap = tpar_close("dp=2 vs one device", plain["losses"], ref,
                     TPAR_LOSS_ATOL)
    tpar_kernel_counts("dp=2", plain, steps, layers, True)
    sums = tpar_replicas("dp=2", plain)
    plain_ranks = [{k: r[k] for k in ("peak_bytes", "moment_bytes",
                                      "param_bytes", "reduce_seconds")}
                   for r in plain["ranks"]]
    plain_losses, plain_steps = plain["losses"], plain["step_seconds"]
    del plain
    # The main path: ZeRO-1 with checkpoints, counted from 0 over both
    # commands.
    release()
    torch.cuda.reset_peak_memory_stats()
    kcounts.reset_counters()
    flags = dp + ["--zero1", "--checkpoint-dir", ckpt, "--save-every",
                  "100"]
    t0 = time.monotonic()
    first = run_train(tpar_args(layers, steps - 1, *flags))
    save_wall = time.monotonic() - t0
    first_losses, first_reduce = first["losses"], first["ranks"][0][
        "reduce_seconds"]
    first_spawned = first["ranks"][1]["counts"]
    del first  # its state: rank 0's masters, gradients and moments
    release()
    resumed = run_train(tpar_args(layers, steps, *flags, "--export-dir",
                                  export))
    main_counts = kcounts.counters()
    # Rank 0 is this process (its counts since the reset, over both
    # commands); rank 1 a process of each command, its counts its own.
    spawned = {k: first_spawned.get(k, 0) + v
               for k, v in resumed["ranks"][1]["counts"].items()}
    zero1 = {"ranks": [dict(resumed["ranks"][0], counts=main_counts),
                       dict(resumed["ranks"][1], counts=spawned)]}
    tpar_kernel_counts("dp=2 zero1 (main path)", zero1, steps, layers, True)
    got = first_losses + resumed["losses"]
    print(f"train_parallel zero1: interrupted at {steps - 1} "
          f"({save_wall:.1f} s with the sharded save), resumed at "
          f"{resumed['start_step']}: losses {[round(x, 6) for x in got]}; "
          f"the run without ZeRO-1 {[round(x, 6) for x in plain_losses]}; "
          f"bit-equal {got == plain_losses}; checkpoint "
          f"{gib(directory_bytes(os.path.join(ckpt, str(steps)))):.2f} GiB "
          f"on disk [{SMI}]", flush=True)
    check(resumed["start_step"] == steps - 1 and got == plain_losses,
          f"train_parallel zero1: resumed losses {got} are not the "
          f"uninterrupted run's {plain_losses} bit for bit")
    tpar_replicas("dp=2 zero1 resumed", resumed, sums)
    for r, plain_r in zip(resumed["ranks"], plain_ranks):
        ratio = r["moment_bytes"] / plain_r["moment_bytes"]
        print(f"train_parallel zero1 rank {r['rank']}: moments "
              f"{gib(r['moment_bytes']):.3f} GiB against "
              f"{gib(plain_r['moment_bytes']):.3f} without ZeRO-1 "
              f"({ratio:.4f}); peak {gib(r['peak_bytes']):.2f} GiB against "
              f"{gib(plain_r['peak_bytes']):.2f} [{SMI}]", flush=True)
        check(0.49 < ratio < 0.51, f"train_parallel zero1: rank "
              f"{r['rank']}'s moments are {ratio:.3f} of the unsharded")
    rank0 = resumed["state"]
    cfg = train_main.make_config(train_main.build_parser().parse_args(
        tpar_args(layers, steps)))
    del resumed, rank0
    release()
    # (e) The ZeRO-1 checkpoint restored onto one device.
    t0 = time.monotonic()
    state, data = Checkpointer(ckpt).restore(lambda: TrainState.create(
        init_params(1, cfg, device=DEV, master=True),
        OptimizerConfig(lr=3e-4)))
    restore_wall = time.monotonic() - t0
    restored = replica_checksums(state)
    check(state.step == steps and data == {"next_step": steps},
          f"train_parallel restore: step {state.step}, data {data}")
    bad = [n for n in sums if restored.get(n) != sums[n]]
    check(not bad, f"train_parallel restore: one device's {bad[:4]} differ "
          "from the ranks'")
    moments = sum(len(v) for v in state.optimizer.state.values())
    check(moments == 3 * len(sums), "train_parallel restore: moments "
          f"{moments} entries for {len(sums)} leaves")
    del state
    release()
    engine = serve_main.make_engine(serve_main.build_parser().parse_args(
        at_depth(SERVE_ARGS, layers) + ["--params-dir", export,
                                        "--no-warmup"]))
    rng = np.random.RandomState(5)
    rid = engine.submit(GenRequest(tokens=rng.randint(0, VOCAB, 64).tolist(),
                                   max_new_tokens=8))
    served = engine.run()[rid]
    check(len(served) == 8, f"train_parallel export: served {served}")
    del engine
    release()
    print(f"train_parallel restore: the dp=2 ZeRO-1 step {steps} onto one "
          f"device in {restore_wall:.1f} s, every leaf bit-equal to the "
          f"ranks'; its export served 8 tokens through serve_main "
          f"--params-dir [{SMI}]", flush=True)
    return {"one_device": ref, "dp2": plain_losses, "zero1": got,
            "gap": gap, "one_device_peak_gib": gib(one_peak),
            "ranks": plain_ranks,
            "zero1_ranks": [{k: r[k] for k in ("peak_bytes", "moment_bytes",
                                               "reduce_seconds")}
                            for r in zero1["ranks"]],
            "step_ms": [x * 1e3 for x in plain_steps],
            "first_reduce_s": first_reduce, "save_wall": save_wall,
            "restore_wall": restore_wall, "counts": main_counts}


def tpar_batches(argv: list) -> list:
    """The global batches ``train_main`` feeds for ``argv``, on the
    card."""
    from oim_tpu_torch.cli import train_main
    from oim_tpu_torch.data.loader import TokenBatches

    args = train_main.build_parser().parse_args(argv)
    batches = TokenBatches(train_main._load_corpus(args), args.batch_global,
                           args.seq, seed=args.seed)
    return [torch.from_numpy(batches.batch_at(s)[:, :args.seq]).long().to(DEV)
            for s in range(args.steps)]


def tpar_plain_ref(argv: list) -> list:
    """One device's losses for ``argv`` with ``use_pallas`` off: the
    math a tp or ep rank runs (the reference's gate), on the same seed
    and batches."""
    from dataclasses import replace

    from oim_tpu_torch.cli import train_main
    from oim_tpu_torch.models.train import TrainState, make_train_step
    from oim_tpu_torch.models.transformer import init_params

    release()
    args = train_main.build_parser().parse_args(argv)
    cfg = replace(train_main.make_config(args), use_pallas=False)
    state = TrainState.create(init_params(args.seed, cfg, device=DEV,
                                          master=True),
                              train_main.make_optimizer_config(args))
    step = make_train_step(cfg)
    losses = [float(step(state, b)[1]["loss"]) for b in tpar_batches(argv)]
    del state, step
    release()
    return losses


def tpar_nccl_leg() -> dict:
    """(b) One NCCL rank with graphs: the training configuration at
    ``TPAR_NCCL_LAYERS`` on a one-rank mesh, every step after the first a
    replay with the gradients' all-reduce over dp inside the graph, bit
    for bit the eager steps on that mesh and the steps with no mesh."""
    import torch.distributed as dist

    from oim_tpu_torch.cli import train_main
    from oim_tpu_torch.models.train import (
        TrainState,
        make_train_step,
        replica_checksums,
    )
    from oim_tpu_torch.models.transformer import init_params
    from oim_tpu_torch.models.weights import init_rank_params, serve_specs
    from oim_tpu_torch.parallel import build_mesh, collectives

    argv = tpar_args(TPAR_NCCL_LAYERS, TPAR_STEPS)
    args = train_main.build_parser().parse_args(argv)
    cfg, opt = train_main.make_config(args), train_main.make_optimizer_config(
        args)
    batches = tpar_batches(argv)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device(DEV, 0))
    try:
        mesh = build_mesh(devices=[DEV + ":0"])

        def run(on_mesh: bool, graph: bool) -> tuple:
            release()
            if on_mesh:
                state = TrainState.create(
                    init_rank_params(0, cfg, mesh, device=DEV), opt,
                    mesh=mesh, specs=serve_specs(cfg, mesh))
            else:
                state = TrainState.create(init_params(0, cfg, device=DEV,
                                                      master=True), opt)
            step = make_train_step(cfg, cuda_graph=graph,
                                   mesh=mesh if on_mesh else None)
            collectives.reset_counters()
            losses = [float(step(state, b)[1]["loss"]) for b in batches]
            out = (losses, replica_checksums(state), step.stats(),
                   collectives.counters()["collective.all_reduce"])
            del state, step
            return out

        graphed = run(True, True)
        eager = run(True, False)
        alone = run(False, True)
    finally:
        dist.destroy_process_group()
        release()
    leaves = 3 + 12 * TPAR_NCCL_LAYERS  # wte, final_norm, wlm; 12 a layer
    stats = graphed[2]
    print(f"train_parallel nccl: one NCCL rank, {TPAR_NCCL_LAYERS} layers: "
          f"graphed losses {graphed[0]}, eager {eager[0]}, no mesh "
          f"{alone[0]}; replays {stats['replays']}, replay ms "
          f"{[round(x, 2) for x in stats['replay_ms']]}; all-reduces "
          f"{graphed[3]} ({leaves} gradients and the metrics a step) "
          f"[{SMI}]", flush=True)
    check(stats["graphed"] and stats["replays"] == TPAR_STEPS - 1,
          f"train_parallel nccl: graph stats {stats}")
    check(graphed[3] == TPAR_STEPS * (leaves + 1),
          f"train_parallel nccl: {graphed[3]} all-reduces, expected "
          f"{TPAR_STEPS * (leaves + 1)} (replays counted)")
    check(graphed[0] == eager[0] == alone[0]
          and graphed[1] == eager[1] == alone[1],
          "train_parallel nccl: the replayed, eager and mesh-free steps "
          "differ")
    return {"losses": graphed[0], "replay_ms": stats["replay_ms"],
            "all_reduces": graphed[3]}


def tpar_tp_leg() -> dict:
    """(c) tp=2 over two gloo ranks on cuda:0 at Qwen's widths and
    ``TPAR_TP_LAYERS`` layers, against one device running the same
    plain math; no rank launches a training kernel (the reference's
    gate)."""
    argv = tpar_args(TPAR_TP_LAYERS, TPAR_STEPS)
    ref = tpar_plain_ref(argv)
    out = tpar_run("tp=2", argv + ["--dp", "1", "--tp", "2", "--backend",
                                   "gloo"])
    gap = tpar_close("tp=2 vs one device (plain math)", out["losses"], ref,
                     TPAR_LOSS_ATOL)
    tpar_kernel_counts("tp=2", out, TPAR_STEPS, TPAR_TP_LAYERS, False)
    tpar_replicas("tp=2", out)
    return {"losses": out["losses"], "ref": ref, "gap": gap,
            "step_ms": [x * 1e3 for x in out["step_seconds"]],
            "peak_gib": [gib(r["peak_bytes"]) for r in out["ranks"]]}


def tpar_ep_leg() -> dict:
    """(d) ep=2 over two gloo ranks on cuda:0 at Mixtral-8x7B's widths
    and ``TPAR_EP_LAYERS`` layer, each rank four of the eight experts,
    against ep=1 running the same plain math."""
    argv = tpar_args(TPAR_EP_LAYERS, TPAR_STEPS, base=MOE_TRAIN_ARGS)
    ref = tpar_plain_ref(argv)
    out = tpar_run("ep=2", argv + ["--dp", "1", "--ep", "2", "--backend",
                                   "gloo"])
    gap = tpar_close("ep=2 vs ep=1 (plain math)", out["losses"], ref,
                     TPAR_LOSS_ATOL)
    tpar_kernel_counts("ep=2", out, TPAR_STEPS, TPAR_EP_LAYERS, False)
    tpar_replicas("ep=2", out)
    check(all(a > 0 for a in out["aux"]), f"ep=2 aux {out['aux']}")
    return {"losses": out["losses"], "ref": ref, "gap": gap,
            "step_ms": [x * 1e3 for x in out["step_seconds"]],
            "peak_gib": [gib(r["peak_bytes"]) for r in out["ranks"]]}


def tpar_bootstrap_leg(package: str, work: str) -> dict:
    """(f) ``train_main --bootstrap``: two processes, each from its own
    staged file (``/dev/nvidia0``, two processes of one slice, a file
    coordinator), form a gloo mesh on the card and train as its two dp
    ranks (dp inferred from the slice)."""
    import subprocess

    argv = tpar_args(CKPT_LAYERS, 2, "--backend", "gloo")
    env = dict(os.environ, PYTHONPATH=package)
    env.pop("CUDA_VISIBLE_DEVICES", None)
    procs = []
    for pid in range(2):
        path = os.path.join(work, f"bootstrap-{pid}.json")
        with open(path, "w") as f:
            json.dump({"volume_id": "smoke-train", "mesh": [1],
                       "num_processes": 2, "process_id": pid,
                       "coordinator_address": f"file://{work}/coordinator",
                       "chips": [{"device_path": "/dev/nvidia0"}]}, f)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "oim_tpu_torch.cli.train_main", *argv,
             "--bootstrap", path], cwd=package, env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
    logs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            logs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    steps = [ln for ln in logs[0].splitlines() if "oim-train step " in ln]
    check(codes == [0, 0] and len(steps) == 2
          and "mesh=dp2" in logs[0] and "bootstrap loaded" in logs[0]
          and "oim-train step" not in logs[1],
          f"train_parallel bootstrap: exit codes {codes}; "
          f"{logs[0][-400:]} | {logs[1][-400:]}")
    print(f"train_parallel bootstrap: two train_main --bootstrap processes "
          f"formed dp=2 on the card; rank 0 logged "
          f"{steps[-1].split(' I ')[-1]!r} [{SMI}]", flush=True)
    return {"steps": steps}


def tpar_kernel_phase() -> dict:
    """RMSNorm, the three flash kernels and the fused-CE forward and
    joint backward at a dp=2 rank's shapes (half the global batch: [2 x
    1024] rows, N = 2048), held against their plain versions and timed
    beside their bound and the PyTorch call that computes the same
    function; returns their records."""
    import torch.nn.functional as F

    from oim_tpu_torch.ops import flash_attention as fa
    from oim_tpu_torch.ops import fused_ce as fc
    from oim_tpu_torch.ops import rmsnorm as rn

    gen = torch.Generator(device=DEV).manual_seed(21)
    b = TRAIN_B // 2
    rows = b * TRAIN_T
    record = {}
    x = torch.randn((rows, D_MODEL), generator=gen, device=DEV).to(
        torch.bfloat16)
    w = torch.rand(D_MODEL, generator=gen, device=DEV) + 0.5
    got, want = rn.rmsnorm_fwd(x, w, 1e-6), rn.rmsnorm_plain(x, w, 1e-6)
    err, rel = rel_err(got, want)
    check(rel <= TRAIN_TOL[torch.bfloat16], f"rmsnorm dp rank: {rel}")
    wl = w.to(x.dtype)
    bnd, by = bound(2 * x.numel() * x.element_size() + w.numel() * 4,
                    4 * x.numel(), torch.float32)
    record["rmsnorm_dp"] = dict(
        max_abs_err=err, ms=time_ms(lambda: rn.rmsnorm_fwd(x, w, 1e-6)),
        plain_ms=time_ms(lambda: rn.rmsnorm_plain(x, w, 1e-6)),
        bound_ms=bnd, bound_by=by,
        library_ms=time_ms(lambda: F.rms_norm(x, (D_MODEL,), wl, 1e-6)))
    del x, w, got, want, wl
    q, k, v, do, _ = flash_case(gen, torch.bfloat16, TRAIN_T, 0, False, b=b)
    errs = check_flash(f"bf16 dp rank B={b}", q, k, v, do, 0, None)
    out, lse = fa.flash_fwd_plain(q, k, v, True, 0, None)
    delta = fa.flash_delta(out, do)
    bwd = (q, k, v, do, lse, delta, True, 0, None)
    pairs = attended_pairs(b, H, TRAIN_T, 0, None)
    qh, kh, vh, doh = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    sdpa = F.scaled_dot_product_attention
    lib_fwd = time_ms(lambda: sdpa(qh, kh, vh, is_causal=True,
                                   enable_gqa=True))
    qg, kg, vg = (t.detach().requires_grad_() for t in (qh, kh, vh))
    out_g = sdpa(qg, kg, vg, is_causal=True, enable_gqa=True)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        out_g, (qg, kg, vg), doh, retain_graph=True))
    for name, kernel, plain, flops, n_in, n_out, lib in (
            ("flash_fwd", lambda: fa.flash_fwd(q, k, v, True, 0, None),
             lambda: fa.flash_fwd_plain(q, k, v, True, 0, None),
             4 * HD, (1, 2, 0), (1, 0, 1), lib_fwd),
            ("flash_dq", lambda: fa.flash_dq(*bwd),
             lambda: fa.flash_dq_plain(*bwd), 6 * HD, (2, 2, 2), (1, 0, 0),
             lib_bwd),
            ("flash_dkv", lambda: fa.flash_dkv(*bwd),
             lambda: fa.flash_dkv_plain(*bwd), 8 * HD, (2, 2, 2), (0, 2, 0),
             lib_bwd)):
        bnd, by = flash_bound(q, k, pairs, flops, n_in, n_out)
        record[f"{name}_dp"] = dict(
            max_abs_err=errs[name], ms=time_ms(kernel),
            plain_ms=time_ms(plain), bound_ms=bnd, bound_by=by,
            library_ms=lib)
    del q, k, v, do, out, lse, delta, bwd, qh, kh, vh, doh, qg, kg, vg, out_g
    release()
    x, w, labels, g = ce_case(gen, torch.bfloat16, rows)
    tag = f"bf16 dp rank N={rows} D={D_MODEL} V={VOCAB}"
    check(fc.route(x, w) == "wgmma", f"fused CE at {tag}: {fc.route(x, w)}")
    errs = check_ce(tag, x, w, labels, g)
    lse, _ = fc.fused_ce_fwd_plain(x, w, labels)
    for name, kernel, plain in (
            ("fused_ce_fwd", lambda: fc.fused_ce_fwd(x, w, labels),
             lambda: fc.fused_ce_fwd_plain(x, w, labels)),
            ("fused_ce_bwd", lambda: fc.fused_ce_bwd(x, w, labels, lse, g),
             lambda: fc.fused_ce_bwd_plain(x, w, labels, lse, g))):
        bnd, by = ce_bound(rows, D_MODEL, VOCAB, x.dtype, name[-3:])
        record[f"{name}_dp"] = dict(
            max_abs_err=errs[name], ms=time_ms(kernel),
            plain_ms=time_ms(plain, runs=5), bound_ms=bnd, bound_by=by,
            library_ms=None)
    del x, w, labels, g, lse
    release()
    for name, rec in record.items():
        print(f"{name} (a dp=2 rank's shape): {rec['ms']:.4f} ms (plain "
              f"{rec['plain_ms']:.4f}, bound {rec['bound_ms']:.5f} by "
              f"{rec['bound_by']}, library {rec['library_ms']}) "
              f"max_abs_err {rec['max_abs_err']:.3e} [{SMI}]", flush=True)
    return record


def train_parallel_phase(package: str, record: dict) -> dict:
    """Training over a mesh on the one card: the kernels at a dp rank's
    shapes, then the legs (see each): dp=2 with and without ZeRO-1 and
    the sharded checkpoint (the main path), one NCCL rank with graphs,
    tp=2, ep=2, and ``train_main --bootstrap``.  Adds the kernel records
    to ``record``; returns the legs."""
    t0 = time.monotonic()
    record.update(tpar_kernel_phase())
    walls, out = {"kernels": time.monotonic() - t0}, {}
    work = tempfile.mkdtemp(prefix=".smoke-tpar-", dir=HERE)
    try:
        for name, leg in (("dp", lambda: tpar_dp_legs(work)),
                          ("nccl", tpar_nccl_leg), ("tp", tpar_tp_leg),
                          ("ep", tpar_ep_leg),
                          ("bootstrap",
                           lambda: tpar_bootstrap_leg(package, work))):
            t = time.monotonic()
            out[name] = leg()
            walls[name] = time.monotonic() - t
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["walls"] = walls
    print(f"train_parallel: phase {time.monotonic() - t0:.1f} s, by part "
          f"{json.dumps({k: round(v, 1) for k, v in walls.items()})} "
          f"[{SMI}]", flush=True)
    return out


def tpar_rows(record: dict, phase: dict) -> list[dict]:
    """The ``kernels`` rows of a dp=2 rank's shapes, with rank 0's
    launches on the main path (dp=2, ZeRO-1, checkpointed and resumed)."""
    counts = phase["dp"]["counts"]
    where = (f"a dp=2 rank of Qwen2.5-1.5B's training, [{TRAIN_B // 2} x "
             f"{TRAIN_T}] rows of the global {TRAIN_B} x {TRAIN_T}")
    rows = []
    for key, name, src, replaces in (
            ("rmsnorm", "rmsnorm", "oim_tpu_torch/csrc/rmsnorm.cu",
             "oim_tpu/ops/rmsnorm.py:27"),
            ("flash_fwd", "flash_fwd (flash_fwd_tc_kernel)",
             "oim_tpu_torch/csrc/flash_attention.cu",
             "oim_tpu/ops/flash_attention.py:100"),
            ("flash_dq", "flash_dq (flash_dq_tc_kernel)",
             "oim_tpu_torch/csrc/flash_attention.cu",
             "oim_tpu/ops/flash_attention.py:163"),
            ("flash_dkv", "flash_dkv (flash_dkv_tc_kernel + dkv_sum_kernel)",
             "oim_tpu_torch/csrc/flash_attention.cu",
             "oim_tpu/ops/flash_attention.py:213"),
            ("fused_ce_fwd", "fused_ce_fwd (ce_tc_kernel, wgmma route)",
             "oim_tpu_torch/csrc/fused_ce.cu", "oim_tpu/ops/fused_ce.py:94"),
            ("fused_ce_bwd", "fused_ce_bwd (ce_tc_kernel: dx of a full "
             "step, from the one dlogits pass that gives dw)",
             "oim_tpu_torch/csrc/fused_ce.cu", "oim_tpu/ops/fused_ce.py:148"),
            ("fused_ce_bwd", "fused_ce_bwd (ce_tc_kernel: dw of a full "
             "step, from the one dlogits pass that gives dx)",
             "oim_tpu_torch/csrc/fused_ce.cu", "oim_tpu/ops/fused_ce.py:168")):
        check(counts.get(key, 0) > 0, f"{key}: not launched on the dp path")
        rows.append(dict(name=f"{name}; {where}", route="cuda", source=src,
                         replaces=replaces, launches=counts[key],
                         **record[f"{key}_dp"]))
    return rows


def parse_args(argv):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    only = parser.add_mutually_exclusive_group()
    only.add_argument(
        "--kernel-phase-only", action="store_true",
        help="build the kernels and run only the K1/K2 kernel phase and "
             "the RMSNorm and fused-CE timings with output digests, "
             "printing their record as the last line")
    only.add_argument(
        "--train-phase-only", action="store_true",
        help="build the kernels and run only the training configuration's "
             "steps, printing their walls and peak memory as the last line")
    only.add_argument(
        "--moe-phase-only", action="store_true",
        help="build the kernels and run only the MoE phases (K1/K2 at the "
             "MoE model's heads, its serve and train phases), printing "
             "their counts as the last line")
    only.add_argument(
        "--route-control", choices=("bf16", "swap"),
        help="plant a router fault in the MoE serve phase's engine and the "
             "MoE training's kernel path (the router rounded to bf16, or "
             "layer 0 routed by layer 1's router), run those two checks "
             "with the references left sound, and fail as the smoke must: "
             "exit 1 when both checks caught it, 0 when one passed")
    only.add_argument(
        "--prefix-phase-only", action="store_true",
        help="build the kernels and run only the prefix phase (the prefix "
             "cache and chunked prefill on both layouts, each beside its "
             "control run), printing its counts and times as the last line")
    only.add_argument(
        "--serve-phase-only", action="store_true",
        help="build the kernels and run only the serve phases (with the "
             "speculative ones where the package serves them), printing "
             "their kernel counts and times to first token as the last "
             "line")
    only.add_argument(
        "--kv-phase-only", action="store_true",
        help="build the kernels and run only the KV block I/O phase (held "
             "KV, a prefix entry and live slots shipped between two "
             "engines, the host tier's demotion, promotion and parking), "
             "printing its gates, walls and rates as the last line")
    only.add_argument(
        "--qos-phase-only", action="store_true",
        help="build the kernels and run only the QoS phase (preemption, "
             "fair share, shedding through the HTTP server, and the "
             "request observation across them), printing its gates, "
             "TTFTs and counts as the last line")
    only.add_argument(
        "--http-phase-only", action="store_true",
        help="build the kernels and run only the HTTP phase (streaming, "
             "a disconnect, drain and slot shipping, KV and prefix "
             "shipping, weights from a sibling, a stall, and the "
             "observation routes, on two servers at the served widths), "
             "printing its gates, latencies and rates as the last line")
    only.add_argument(
        "--spec-phase-only", action="store_true",
        help="build the kernels and run only the speculative paths: K1/K2 "
             "at the verify and draft shapes, the default serve phase (the "
             "plain engine on the same traffic), prompt lookup with beam "
             "and embed, the self-draft engines and the draft model, "
             "printing their counts as the last line")
    only.add_argument(
        "--parallel-phase-only", action="store_true",
        help="build the kernels and run only the parallel phase (K1/K2 "
             "and quant_matmul at the ranks' shapes, Qwen at tp=2 over two "
             "gloo ranks on the one card, Qwen on a one-rank NCCL mesh "
             "with graphs, Mixtral's widths at tp2·ep2 over four, "
             "serve_main --bootstrap and --tp 2), printing its kernel rows "
             "and legs as the last line")
    only.add_argument(
        "--train-parallel-phase-only", action="store_true",
        help="build the kernels and run only the training-parallel phase "
             "(the training kernels at a dp=2 rank's shapes, train_main at "
             "dp=2 with and without --zero1 and its sharded checkpoint, "
             "one NCCL rank with graphs, tp=2, ep=2 and --bootstrap), "
             "printing its kernel rows and legs as the last line")
    only.add_argument(
        "--front-phase-only", action="store_true",
        help="build the kernels and run only the front phase (text and "
             "OpenAI surfaces with a stand-in tokenizer, mTLS, the kernel "
             "switch's A/B, an on-demand profile, the recompile sentinel "
             "and the daemon's init, at the served widths), printing its "
             "gates, latencies and rates as the last line")
    parser.add_argument(
        "--package", default=HERE, metavar="DIR",
        help="the checkout whose oim_tpu_torch to load (default: this "
             "one); with --kernel-phase-only, --train-phase-only, "
             "--serve-phase-only or --prefix-phase-only, another "
             "checkout's build is run on the same inputs")
    args = parser.parse_args(argv)
    if args.package != HERE and not (args.kernel_phase_only
                                     or args.train_phase_only
                                     or args.serve_phase_only
                                     or args.prefix_phase_only):
        parser.error("--package needs --kernel-phase-only, "
                     "--train-phase-only, --serve-phase-only or "
                     "--prefix-phase-only")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    package = os.path.abspath(args.package)
    sys.path.insert(0, package)
    try:
        import oim_tpu_torch
    except ImportError as exc:
        print(f"chip_smoke: the port's package is missing: {exc}",
              file=sys.stderr)
        return 3
    if os.path.dirname(os.path.dirname(oim_tpu_torch.__file__)) != package:
        print(f"chip_smoke: oim_tpu_torch must come from {package}",
              file=sys.stderr)
        return 3
    from oim_tpu_torch.ops import _build

    global SMI
    SMI = _build.gpu_line()
    print(SMI, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}",
          flush=True)
    t0 = time.monotonic()
    _build.library()
    print(f"build: {time.monotonic() - t0:.1f} s ({_build.library_path().name})",
          flush=True)
    for line in ptxas_lines(_build.build_log):
        print(line, flush=True)
    if args.train_phase_only:
        _, result, _ = train_steps()
        steady = float(np.median(result["step_seconds"][1:])) * 1e3
        print(f"train-only: steady step {steady:.1f} ms (median of steps "
              f"2-{TRAIN_STEPS}) [{SMI}]", flush=True)
        print(json.dumps({"package": package, "train": {
            "step_ms": [t * 1e3 for t in result["step_seconds"]],
            "steady_ms": steady,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "graph": result.get("graph")}}), flush=True)
        return 0
    if args.spec_phase_only:
        record = spec_kernel_phase()
        plain = serve_phase(SERVE_ARGS, "default", echo=True)
        spec = spec_phases(plain["decode_tok_s"])
        print(json.dumps({"package": package, "kernel_phase": record,
                          "default": plain, "spec": spec},
                         default=str), flush=True)
        return 0
    if args.serve_phase_only:
        from oim_tpu_torch.cli import serve_main

        served = {}
        flags = vars(serve_main.build_parser().parse_args([]))
        if "pipeline_depth" in flags:
            # The six requests alone, as a parent package serves them.
            served["default"] = serve_phase(SERVE_ARGS, "default")
            served["paged"] = serve_phase(PAGED_SERVE_ARGS, "paged")
            if "kv_int4" in flags:
                served["quant"] = serve_phase(QUANT_SERVE_ARGS, "int4")
            if "spec_decode" in flags:
                served["spec"] = spec_phases(None)
            if "kv_host_bytes" in flags:
                served["kv_io"] = kv_io_phase()
            if "qos_policy" in flags:
                served["qos"] = qos_phase()
            if "watchdog_interval" in flags:
                served["http"] = http_phase()
            if "tokenizer_dir" in flags:
                served["front"] = front_phase()
        else:  # a package from before depth 2: paged, serial, eager only
            served["paged"] = serve_phase(SERVE_ARGS + ["--kv-block", "16"],
                                          "paged")
        print(json.dumps({"package": package, "serve": served}), flush=True)
        return 0
    if args.kv_phase_only:
        print(json.dumps({"package": package, "kv_io": kv_io_phase()},
                         default=str), flush=True)
        return 0
    if args.qos_phase_only:
        print(json.dumps({"package": package, "qos": qos_phase()},
                         default=str), flush=True)
        return 0
    if args.http_phase_only:
        print(json.dumps({"package": package, "http": http_phase()},
                         default=str), flush=True)
        return 0
    if args.front_phase_only:
        print(json.dumps({"package": package, "front": front_phase()},
                         default=str), flush=True)
        return 0
    if args.parallel_phase_only:
        record = {}
        phase = parallel_phase(package, record)
        print(json.dumps({"package": package,
                          "kernels": par_rows(record, phase),
                          "parallel": {leg: {k: v for k, v in out.items()
                                             if k not in ("counts",
                                                          "forced")}
                                       if leg != "walls" else out
                                       for leg, out in phase.items()}},
                         default=str), flush=True)
        return 0
    if args.train_parallel_phase_only:
        record = {}
        phase = train_parallel_phase(package, record)
        print(json.dumps({"package": package,
                          "kernels": tpar_rows(record, phase),
                          "train_parallel": {
                              leg: {k: v for k, v in out.items()
                                    if k != "counts"}
                              if leg != "walls" else out
                              for leg, out in phase.items()}},
                         default=str), flush=True)
        return 0
    if args.route_control:
        return route_control(args.route_control)
    if args.moe_phase_only:
        record = {}
        moe = moe_phases(record)
        print(json.dumps({"package": package, "moe": moe,
                          "kernel_phase": record}), flush=True)
        return 0
    if args.prefix_phase_only:
        from oim_tpu_torch.cli import serve_main

        if "prefix_cache" not in vars(serve_main.build_parser().parse_args(
                [])):
            print("chip_smoke: this package serves no prefix cache",
                  file=sys.stderr)
            return 3
        print(json.dumps({"package": package, "prefix": prefix_phase()}),
              flush=True)
        return 0
    record = kernel_phase()
    if args.kernel_phase_only:
        if quant_module() is not None:
            record.update(quant_kernel_phase())
        compared = compare_phase()
        print(json.dumps({"package": package, "kernel_phase": record,
                          "compare": compared}), flush=True)
        return 0
    walls = {"build+kernel": time.monotonic() - t0}

    def timed(name, fn, *fn_args):
        t = time.monotonic()
        out = fn(*fn_args)
        walls[name] = time.monotonic() - t
        print(f"wall: {name} phase {walls[name]:.1f} s", flush=True)
        return out

    timed("kernels+", lambda: [record.update(f()) for f in (
        segment_kernel_phase, spec_kernel_phase, quant_kernel_phase,
        train_kernel_phase, fused_ce_phase)])
    # The main path: serve_main's defaults.  Then the paged engine's
    # serial loop, and the prefix cache with chunked prefill on both
    # layouts, each with its own counts.
    counts = timed("default", lambda: serve_phase(SERVE_ARGS, "default",
                                                  echo=True))
    paged_counts = timed("paged", serve_phase, PAGED_SERVE_ARGS, "paged")
    quant_counts = timed("int4", serve_phase, QUANT_SERVE_ARGS, "int4")
    prefix_counts = timed("prefix", prefix_phase)
    spec_counts = timed("spec", spec_phases, counts["decode_tok_s"])
    timed("kv_io", kv_io_phase)
    timed("qos", qos_phase)
    timed("http", http_phase)
    parallel = timed("parallel", parallel_phase, package, record)
    train_parallel = timed("train_parallel", train_parallel_phase, package,
                           record)
    counts.update(timed("train", train_phase, record))
    work = tempfile.mkdtemp(prefix=".smoke-ckpt-", dir=HERE)
    try:
        free = shutil.disk_usage(work).free
        print(f"ckpt: working in {os.path.basename(work)}, "
              f"{free / 2**30:.0f} GiB free", flush=True)
        # dx alone runs on LoRA steps (a full step runs the joint).
        counts["fused_ce_dx"] = ckpt_lora_phase(work)["fused_ce_dx"]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    moe_counts = timed("moe", moe_phases, record)
    # Last: the MoE phase needs its headroom, and after the front phase
    # (which loads the profiler's tracer) it found 7.5 of the 8 GiB it
    # gates on free at its serving peak.
    front_counts = timed("front", front_phase)["counts"]
    print(f"walls: {json.dumps({k: round(v, 1) for k, v in walls.items()})}",
          flush=True)
    sources = {"rmsnorm": ("oim_tpu_torch/csrc/rmsnorm.cu",
                           "oim_tpu/ops/rmsnorm.py:27"),
               "flash_fwd": ("oim_tpu_torch/csrc/flash_attention.cu",
                             "oim_tpu/ops/flash_attention.py:100"),
               "flash_dq": ("oim_tpu_torch/csrc/flash_attention.cu",
                            "oim_tpu/ops/flash_attention.py:163"),
               "flash_dkv": ("oim_tpu_torch/csrc/flash_attention.cu",
                             "oim_tpu/ops/flash_attention.py:213"),
               "fused_ce_fwd": ("oim_tpu_torch/csrc/fused_ce.cu",
                                "oim_tpu/ops/fused_ce.py:94"),
               "fused_ce_dx": ("oim_tpu_torch/csrc/fused_ce.cu",
                               "oim_tpu/ops/fused_ce.py:148"),
               # dx and dw of a full step from one dlogits pass: the
               # only path on which the dw kernel's work runs.
               "fused_ce_bwd": ("oim_tpu_torch/csrc/fused_ce.cu",
                                "oim_tpu/ops/fused_ce.py:168")}
    def paged_rows(where: str, phase: dict, suffix: str) -> list[dict]:
        """K1's two routes and K2's two shapes, timed at ``where``'s
        shapes, with the launches of the serve phase ``phase``."""
        src = "oim_tpu_torch/csrc/paged_attention.cu"
        return [
            dict(name=f"paged_flash_decode (K1, decode route: "
                      f"paged_decode_kernel<8> + merge; {where})",
                 route="cuda", source=src,
                 replaces="oim_tpu/ops/paged_attention.py:93",
                 launches=phase["paged_flash_decode_rows8"],
                 **record["K1" + suffix]),
            dict(name=f"paged_flash_decode (K1, tall route: "
                      f"paged_prefill_tc_kernel on tensor cores; admission "
                      f"segments, timed at t=512; {where})",
                 route="cuda", source=src,
                 replaces="oim_tpu/ops/paged_attention.py:93",
                 launches=phase["paged_flash_decode_tc"],
                 **record["K1t" + suffix]),
            dict(name=f"paged_kv_store (K2, admission segments, timed at "
                      f"t=512; {where})", route="cuda", source=src,
                 replaces="oim_tpu/ops/paged_attention.py:265",
                 launches=(phase["paged_kv_store"]
                           - phase["paged_kv_store_t1"]),
                 **record["K2" + suffix]),
            dict(name=f"paged_kv_store (K2, decode steps, t=1; {where})",
                 route="cuda", source=src,
                 replaces="oim_tpu/ops/paged_attention.py:265",
                 launches=phase["paged_kv_store_t1"],
                 **record["K2d" + suffix]),
        ]

    kernels = paged_rows(
        "dense cache, 64-row blocks: serve_main's defaults", counts,
        "_dense",
    ) + paged_rows(
        "paged pool, 16-row blocks: --kv-block 16 --pipeline-depth 1",
        paged_counts, "",
    ) + paged_rows(
        "paged pool, 16-row blocks: the front phase's servers A (text, "
        "OpenAI) and A' (mTLS), --kv-block 16", front_counts, "",
    ) + paged_rows(
        f"dense cache, 64-row blocks, H {MOE_H} / KVH {MOE_KVH}: the MoE "
        f"serve phase, Mixtral-8x7B widths at {MOE_LAYERS} layers",
        moe_counts, "_moe",
    ) + [
        dict(name=f"{kernel} at a chunked-prefill segment (t="
                  f"{SEGMENT_T} from start {start}; {layout}: the prefix "
                  f"phase's cached run, its launches at every segment and "
                  f"admission)",
             route="cuda", source="oim_tpu_torch/csrc/paged_attention.cu",
             replaces=replaces,
             launches=(prefix_counts[layout]["paged_flash_decode_tc"]
                       if key == "K1s" else
                       prefix_counts[layout]["paged_kv_store"]
                       - prefix_counts[layout]["paged_kv_store_t1"]),
             **record[f"{key}{start}_{layout}"])
        for layout in ("dense", "paged") for start in SEGMENT_STARTS
        for key, kernel, replaces in (
            ("K1s", "paged_flash_decode (K1, tall route: "
                    "paged_prefill_tc_kernel)",
             "oim_tpu/ops/paged_attention.py:93"),
            ("K2s", "paged_kv_store (K2)",
             "oim_tpu/ops/paged_attention.py:265"))
    ] + [
        dict(name=name, route="cuda", source=source, replaces=replaces,
             launches=counts[name], **record[name])
        for name, (source, replaces) in sources.items()
    ] + [
        dict(name=f"rmsnorm (wide route: rmsnorm_wide_kernel, rows past a "
                  f"warp's registers; f32 [{MOE_TRAIN_B * TRAIN_T}, "
                  f"{MOE_D}]: the MoE training's f32 first step)",
             route="cuda", source="oim_tpu_torch/csrc/rmsnorm.cu",
             replaces="oim_tpu/ops/rmsnorm.py:27",
             launches=moe_counts["train"]["rmsnorm_wide"],
             **record["rmsnorm_wide"])
    ] + paged_rows(
        "packed int4 paged pool, 16-row blocks: --kv-block 16 --kv-int4 "
        "--weights-int4", quant_counts, "_i4",
    ) + quant_rows(record, {("qwen", "int4"): quant_counts,
                            ("mixtral", "int8"): moe_counts["int8"]}
    ) + spec_rows(record, spec_counts) + par_rows(record, parallel) + (
        tpar_rows(record, train_parallel))
    print(SMI, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
