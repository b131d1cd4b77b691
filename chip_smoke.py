"""Chip smoke for the PyTorch/CUDA port: build the Hopper kernels, hold
each against its plain PyTorch version at the shapes its path gives it,
then drive the paths through the port's own entry points at
Qwen2.5-1.5B's full width — serve six requests at ``serve_main``'s
defaults (the dense cache, pipeline depth 2, each decode chunk one CUDA
graph replay) and again on the paged engine at depth 1 (paged-attention
kernels K1 on its decode and tensor-core routes, K2, in both), train a
few steps in the trainer's usual configuration
(RMSNorm, flash attention forward, dq, dkv, and the fused unembed+CE
forward, dx and dw), then checkpoint, resume, export, fine-tune LoRA on
the export and serve the merged weights — and check what comes back.
Then an exact-routing MoE model at Mixtral-8x7B's widths: served on
``serve_main``'s defaults with its depth cut to fit the card, and
trained at two layers with capacity routing and the aux and z losses.

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
card.  ``--moe-phase-only`` runs only the MoE phases (K1/K2 at the MoE
model's heads, its serve phase and its train phase).
``--route-control bf16|swap`` plants a router fault in the MoE serve
phase's engine and the MoE training's kernel path (the references kept
sound) and runs those two checks, which must fail: a control of the
routing checks' tolerance.
``--train-phase-only [--package DIR]`` likewise runs only the
training configuration's steps and prints their wall times and peak
memory, and ``--serve-phase-only [--package DIR]`` only the serve phases
(their checks, the lone 512-token prompt's time to first token, the
concurrent p50 and the decode rate; the default-configuration phase
only where the package serves it); run both builds in turns (parent,
change, change, parent) to compare them in one call.

It exits non-zero without a result line when no GPU is visible, when the
port's package is not beside it, or when any phase fails.  Every number
it prints is measured in this run; the second-to-last line is the
``{"kernels": [...]}`` record and the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time
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
# The same model on the paged engine and the serial loop, eager: the
# serving path of the earlier slices.
PAGED_SERVE_ARGS = SERVE_ARGS + ["--kv-block", "16", "--pipeline-depth",
                                 "1"]
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
# 24 of 32 layers: in bf16 a layer is 2.90 GB (experts 2.82, attention
# 0.08) plus 0.067 GB of dense cache (8 slots x 2048 rows), wte and the
# f32 wlm add 0.79 GB — 71 GB (66 GiB) at 24 layers, which leaves the
# 8 GiB of headroom on an 80 GB card that ``MOE_FREE_GIB`` checks at the
# serving peak (admission transients, graph pool).  Trained at 2 layers:
# f32 masters, grads and AdamW moments of 3.2 B parameters, ~51 GB.
MOE_GEOMETRY = [
    "--vocab-size", "32000", "--d-model", "4096", "--n-heads", "32",
    "--n-kv-heads", "8", "--d-ff", "14336", "--n-experts", "8",
    "--moe-top-k", "2", "--rope-theta", "1000000", "--norm-eps", "1e-5",
    "--dtype", "bfloat16",
]
MOE_LAYERS = 24
MOE_SERVE_ARGS = MOE_GEOMETRY + [
    "--n-layers", str(MOE_LAYERS), "--n-slots", "8", "--max-len",
    str(MAX_LEN), "--chunk", "8", "--port", "0", "--seed", "0",
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


def make_pool(gen, n_blocks, quant, bs=BS, kvh=KVH):
    shape = (n_blocks, bs, kvh, HD)
    if quant:
        k = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                          dtype=torch.int8)
        ks = torch.rand(shape[:-1], generator=gen, device="cuda") * 0.04 + 0.005
        vs = torch.rand(shape[:-1], generator=gen, device="cuda") * 0.04 + 0.005
        return k, v, ks, vs
    k = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    return k, v, None, None


def row_bytes(pool, scale) -> int:
    """Bytes of one position's K (or V) row in the pool: every kv head's
    payload plus, for int8, its f32 scale."""
    kvh = pool.shape[2]
    per_row = kvh * HD * pool.element_size()
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
    # int8: an abs-max, a division and a rounding per element, in f32.
    ops = 3 * 2 * k_new.numel() if scale is not None else 0
    return bound(moved, ops, torch.float32)


def sdpa_yardstick(q, pool, scale, tables, starts, window):
    """One F.scaled_dot_product_attention call over the gathered,
    dequantized view with the same mask — the library time beside K1
    (timed only; the port never calls it)."""
    from oim_tpu_torch.ops.paged import paged_view
    from oim_tpu_torch.ops.quant import dequantize_int8

    b, t, h, hd = q.shape
    view, sview = paged_view(pool, scale, tables)
    kv = view.float() if sview is None else dequantize_int8(view, sview)
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
    for bf16 and int8 pools of 16-row blocks (the paged engine), then
    the same at the dense cache's shapes (``dense_kernel_phase``);
    returns the measured record per kernel and shape (bf16 — the served
    configuration)."""
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
    for quant in (False, True):
        tag = "int8" if quant else "bf16"
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
            del pools, scales
        del k_pool, v_pool, ks, vs
        torch.cuda.empty_cache()
    record.update(dense_kernel_phase(pa, gen))
    return record


def dense_kernel_phase(pa, gen, h=H, kvh=KVH, tag="dense",
                       suffix="_dense") -> dict:
    """K1 and K2 at a main path's shapes: the dense cache of 8 slots x
    2048 rows, which the engine hands the kernels as blocks of
    ``DENSE_BS`` rows through a fixed identity table — every slot live
    at decode, contexts 0 to 2047; a 512-token segment for two slots at
    the prefill — with ``h`` query and ``kvh`` kv heads.  bf16; returns
    the records, keyed with ``suffix``."""
    n_blocks = 8 * (MAX_LEN // DENSE_BS)
    k_pool, v_pool, _, _ = make_pool(gen, n_blocks, False, DENSE_BS, kvh)
    tables = torch.arange(n_blocks, dtype=torch.int32,
                          device="cuda").reshape(8, -1)
    starts = torch.tensor([0, 16, 299, 999, 2047, 776, 1500, 40],
                          dtype=torch.int32, device="cuda")
    q = torch.randn((8, 1, h, HD), generator=gen,
                    device="cuda").to(torch.bfloat16)
    none = slice(0, 0)  # no all-sentinel slot in a dense cache
    k1 = k1_phase(f"decode bf16 {tag} B=8 t=1", pa,
                  (q, k_pool, v_pool, None, None, tables, starts), none,
                  (1, 4, 16, 32), (0, 256))
    dk = torch.randn((8, 1, kvh, HD), generator=gen,
                     device="cuda").to(torch.bfloat16)
    k2d = k2_phase(f"bf16 {tag} B=8 t=1", pa, dk, dk.clone(),
                   [k_pool.clone(), v_pool.clone()], [None, None], tables,
                   starts)
    t, slots = 512, [2, 5]
    ptables = tables[slots].contiguous()
    pst = torch.tensor([37, 1000], dtype=torch.int32, device="cuda")
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


def moe_kernel_phase() -> dict:
    """K1 and K2 at the MoE serve phase's shapes: the dense cache's
    64-row blocks with Mixtral's 32 query and 8 kv heads (group 4: K1's
    decode route holds t·group = 4 of its 8 rows a (slot, kv head), the
    tall route 2048 rows a (slot, kv head) at t=512)."""
    from oim_tpu_torch.ops import paged_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(4)
    return dense_kernel_phase(pa, gen, MOE_H, MOE_KVH,
                              f"dense H={MOE_H} KVH={MOE_KVH}", "_moe")


# ---------------------------------------------------------------------------
# Serve phase


def post(port: int, body: dict) -> tuple[int, dict]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
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
    collects no reference cycles), and the allocator's cache is
    emptied."""
    torch.cuda.empty_cache()


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
    over a whole f32 copy."""

    def __init__(self, layers):
        self.layers, self.buffers = layers, {}

    def __len__(self):
        return len(self.layers)

    def __iter__(self):
        for lp in self.layers:
            for name, t in lp.items():
                if name not in self.buffers:
                    self.buffers[name] = torch.empty(
                        t.shape, dtype=torch.float32, device=t.device)
                self.buffers[name].copy_(t)
            yield self.buffers


def widened(params, cfg):
    """(params, cfg) of the f32 reference forward over served ``params``:
    the embedding, final norm and unembedding recast, the layers
    widened one at a time (``WidenedLayers``)."""
    from dataclasses import replace

    from oim_tpu_torch.models.transformer import prepare_param

    cfg32 = replace(cfg, dtype="float32")
    out = {name: prepare_param(name, params[name], cfg32)
           for name in ("wte", "final_norm", "wlm")}
    out["layers"] = WidenedLayers(params["layers"])
    return out, cfg32


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
    through ``models.decode`` is recorded.  An admission's calls (eager:
    one a layer inside ``_admit_batch``) are kept with its prompts.  A
    decode pass's calls run inside a chunk's CUDA graph, where a replay
    runs no Python, so each writes its [S, k] choices into a device log
    at a device-side counter: three small kernels a layer a pass, which
    the chunk's capture records (so ``install()`` comes before the engine
    starts, and the log outlives its graphs).  ``watch(engine)``, after
    the warmup, sets the counter to 0 and records each decode dispatch
    (which request sits in which slot, at which position) until
    ``remove()``; ``choices`` maps the log back to one request."""

    LOG_ROWS = 8192

    def __init__(self, n_slots: int, top_k: int):
        self.log = torch.zeros((self.LOG_ROWS, n_slots, top_k),
                               dtype=torch.int64, device=DEV)
        self.counter = torch.zeros(1, dtype=torch.int64, device=DEV)
        self.admissions, self.dispatches = [], []
        self.admitting = None

    def __call__(self, probs, k):
        out = self.record(probs, k)
        if self.admitting is not None:
            self.admitting.append(out[1])
        else:
            self.log.index_copy_(0, self.counter.remainder(self.LOG_ROWS),
                                 out[1][None])
            self.counter.add_(1)
        return out

    def _admit_batch(self, params, cache, row_tables, prompts, starts,
                     true_tails, *rest):
        self.admitting = []
        try:
            return self.admit(params, cache, row_tables, prompts, starts,
                              true_tails, *rest)
        finally:
            self.admissions.append((prompts, true_tails, self.admitting))
            self.admitting = None

    def install(self) -> None:
        from oim_tpu_torch.models import decode as dec
        from oim_tpu_torch.serve import engine as eng

        self.record, dec._router_gates = dec._router_gates, self
        self.admit, eng._admit_batch = eng._admit_batch, self._admit_batch

    def watch(self, engine) -> None:
        dispatch = engine._dispatch_chunk

        def recorded(acc, chained):
            handle = dispatch(acc, chained)
            self.dispatches.append(handle)
            return handle

        self.chunk, self.n_layers = engine.chunk, engine.cfg.n_layers
        self.admissions.clear()
        self.counter.zero_()
        engine._dispatch_chunk = recorded

    def remove(self, engine=None) -> None:
        from oim_tpu_torch.models import decode as dec
        from oim_tpu_torch.serve import engine as eng

        dec._router_gates, eng._admit_batch = self.record, self.admit
        if engine is not None and "_dispatch_chunk" in vars(engine):
            del engine._dispatch_chunk  # the closure holds the engine
        self.rows = int(self.counter)
        self.logged = self.log[:min(self.rows, self.LOG_ROWS)].cpu()

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
        admitted = None
        for prompts, tails, calls in self.admissions:
            prompts, tails = prompts.cpu(), tails.cpu()
            for i in range(prompts.shape[0]):
                if (int(tails[i]) == p
                        and prompts[i, :p].tolist() == list(prompt)):
                    bucket = prompts.shape[1]
                    admitted = [c[i * bucket:i * bucket + p].cpu()
                                for c in calls]
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


def serve_phase(argv, tag: str, min_free_gib: float | None = None) -> dict:
    """Serve six concurrent requests through the port's serve_main entry
    with ``argv`` and check lengths, drain, kernel counters (reset just
    before the requests, read just after) and a teacher-forced f32
    reference (``teacher_check``); on an engine that replays CUDA graphs,
    also that
    every decode dispatch was one replay, then ``graph_check``.  Prints
    the memory the card had free at the serving peak (weights, cache,
    admission transients, graph pool), which must reach ``min_free_gib``
    when given.  Returns the run's kernel launch counts with its times
    to first token, decode rate and memory."""
    from oim_tpu_torch.cli import serve_main
    from oim_tpu_torch.ops import paged_attention as pa

    args = serve_main.build_parser().parse_args(argv)
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
    planted = None
    if routing is not None:
        routing.watch(engine)
        planted = plant_route_control(engine.params["layers"])
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
              f"{gib(torch.cuda.memory_allocated()):.1f} GiB allocated",
              flush=True)
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
        pa.reset_counters()
        t0 = time.monotonic()
        with ThreadPoolExecutor(len(bodies)) as pool:
            replies = list(pool.map(lambda b: post(server.port, b), bodies))
        wall = time.monotonic() - t0
        counts = pa.counters()
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
        print(f"serve {tag}: {len(bodies)} concurrent requests in "
              f"{wall:.2f} s; kernel counts {counts} over "
              f"{stats['prefill_dispatches']} admission dispatches and "
              f"{stats['decode_passes']} decode passes dispatched, of "
              f"{args.n_layers} layers", flush=True)
        check(counts["paged_flash_decode"] > 0, "K1 never launched")
        check(counts["paged_kv_store"] > 0, "K2 never launched")
        check(counts["paged_flash_decode_plain"] == 0
              and counts["paged_kv_store_plain"] == 0,
              "a plain version ran on the serving path")
        # Every layer of every forward pass went through both kernels.
        check(counts["paged_flash_decode"] == args.n_layers * passes
              and counts["paged_kv_store"] == args.n_layers * passes,
              f"launches {counts} != {args.n_layers} x {passes} passes")
        if hasattr(pa, "ROUTE_ROWS"):  # a parent checkout has one route
            # Admissions took K1's tensor-core route and decode passes its
            # 8-row route, each layer once; K2 ran at t = 1 on decode
            # passes.
            routes = {route: counts[f"paged_flash_decode_{route}"]
                      for route in pa.ROUTE_ROWS}
            want = {"tc": stats["prefill_dispatches"] * args.n_layers,
                    "rows8": stats["decode_passes"] * args.n_layers,
                    "rows16": 0}
            check(routes == want, f"K1 launches by route {routes} != {want}")
            check(counts["paged_kv_store_t1"] == want["rows8"],
                  f"K2 at t=1 launched {counts['paged_kv_store_t1']} times, "
                  f"not {want['rows8']}")
            print(f"serve {tag}: K1's tensor-core route (admission prefill, "
                  f"64-row tiles) launched {routes['tc']} times "
                  f"({stats['prefill_dispatches']} admission dispatches x "
                  f"{args.n_layers} layers), its decode route "
                  f"{routes['rows8']} ({stats['decode_passes']} passes), its "
                  f"f32 route 0; K2 at t=1 {counts['paged_kv_store_t1']}",
                  flush=True)
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
        counts["ttft_ms"] = {"lone_512": ttft * 1e3,
                             "concurrent_p50": stats["ttft_p50_s"] * 1e3}
        counts["decode_tok_s"] = dec_rate
        counts["warmup_s"] = stats.get("warmup_seconds")
        counts["capture_s"] = stats.get("graph_capture_seconds")
    finally:
        if routing is not None:
            routing.remove(engine)
            restore_routers(engine.params["layers"], planted)
        server.stop()
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"serve {tag}: serving peak {gib(serving_peak):.1f} GiB allocated "
          f"of {gib(total):.1f} GiB; {serving_free:.1f} GiB of the card free "
          f"at the peak (weights, cache, admission transients, graph pool) "
          f"[{SMI}]", flush=True)
    checked = [(body, reply) for i, (body, (_, reply)) in
               enumerate(zip(bodies, replies)) if i != 2]  # greedy ones
    counts["routing_differences"] = teacher_check(engine, checked, tag,
                                                  routing)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if graphs:
        graph_check(engine, vocab, rng)
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
    del engine, server
    release()
    print(f"serve {tag}: {gib(held):.1f} GiB allocated with the server "
          f"stopped, {gib(torch.cuda.memory_allocated()):.2f} GiB once it "
          f"and its engine are dropped", flush=True)
    check(torch.cuda.memory_allocated() - base < 2**30,
          "a stopped server kept its engine's memory")
    return counts


def teacher_check(engine, checked, tag: str, routing=None) -> list:
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
    reported beside.  Returns [pairs whose choices differ from the f32
    router's, (layer, position) pairs]."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params32, cfg32 = widened(engine.params, engine.cfg)
    n_delta = n_pos = n_flips = n_choices = n_free = 0
    worst_lp = worst_lost = worst_gap = free_gap = 0.0
    for body, reply in checked:
        prompt, forced = body["tokens"], None
        gen_toks, lps = reply["tokens"], reply["logprobs"]
        if routing is not None:
            forced = routing.choices(prompt, len(gen_toks))
            free = emitted_gap(params32, cfg32, prompt, gen_toks)[0]
            n_free += int((free > DELTA).sum())
            free_gap = max(free_gap, float(free.max()))
        gap, lp_ref, tap = emitted_gap(params32, cfg32, prompt, gen_toks,
                                       forced)
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
    return [n_flips, n_choices]


def graph_check(engine, vocab: int, rng) -> None:
    """One decode chunk of every slot seated (greedy, sampled with top-p
    and penalised rows, contexts 16 to 1500), from copies of one cache
    state, run eagerly and by its CUDA graph's replay: the same kernels
    on the same inputs, so tokens, logprobs, the token carry, the cache
    and the penalty counts must be bit-equal."""
    from oim_tpu_torch.serve.engine import GenRequest

    engine.set_pipeline_depth(1)
    lens = [16, 100, 300, 513, 777, 1000, 40, 1500]
    for i, n in enumerate(lens[: engine.n_slots]):
        kw = {}
        if i % 3 == 1:
            kw = dict(temperature=0.8, seed=100 + i, top_p=0.9)
        elif i % 3 == 2:
            kw = dict(repetition_penalty=1.2)
        engine.submit(GenRequest(tokens=rng.randint(0, vocab, n).tolist(),
                                 max_new_tokens=64, **kw))
    engine.step()  # admit every slot and decode one chunk
    eager, replayed = engine.chunk_twice()
    same = {name: torch.equal(eager[name], replayed[name])
            for name in ("out", "lps", "carry")}
    same["cache and counts"] = all(
        torch.equal(a, b) for a, b in zip(eager["state"], replayed["state"]))
    print(f"serve graph check: one decode chunk of {engine.n_slots} slots "
          f"from copies of one state, eager vs graph replay bit-equal: "
          f"{same}", flush=True)
    check(all(same.values()), f"graph replay differs from eager: {same}")
    engine.abort("graph check done")


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


def flash_case(gen, dtype, t, window, segmented):
    """Inputs at the training shape: q, k, v, dout [B, t, heads, 128],
    and packed segment ids (a document boundary about every 100
    tokens) or None."""
    shape_q, shape_k = (TRAIN_B, t, H, HD), (TRAIN_B, t, KVH, HD)
    q, do = (torch.randn(shape_q, generator=gen, device=DEV).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(shape_k, generator=gen, device=DEV).to(dtype)
            for _ in range(2))
    seg = None
    if segmented:
        starts = torch.rand((TRAIN_B, t), generator=gen, device=DEV) < 0.01
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


def train_steps():
    """(args, result, the kernels' launch counts) of ``TRAIN_STEPS``
    steps of the training configuration through the loaded package's
    train_main entry, the counts set to 0 just before; prints the
    steps' walls and the peak memory."""
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
    steps_ms = [round(t * 1e3, 1) for t in result["step_seconds"]]
    mem = torch.cuda.memory_stats()
    print(f"train: {len(losses)} steps in {wall:.1f} s (setup included); "
          f"losses {[round(x, 4) for x in losses]}; step walls {steps_ms} "
          f"ms; kernel counts {counts}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; allocator "
          f"cudaMalloc {mem.get('num_device_alloc')}, cudaFree "
          f"{mem.get('num_device_free')}, retries "
          f"{mem.get('num_alloc_retries')} (since the process began)",
          flush=True)
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
    step_parity(args)
    return counts


# ---------------------------------------------------------------------------
# MoE phases


def moe_train_kernels() -> None:
    """RMSNorm, the three flash kernels and fused CE at the MoE training
    shapes (bf16: rows 2 x 1024 of width 4096; flash B=2, T=1024, 32 / 8
    heads, group 4, so dkv sums 4 q heads a kv head; fused CE at V =
    32000, one partial chunk of the wgmma route's 32768 columns), held
    against their plain versions (and flash once in f32), then timed."""
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


def moe_train_phase() -> dict:
    """Train the MoE model at Mixtral's widths, 2 layers, batch 2 x 1024,
    f32 masters with bf16 compute and the router z-loss on, through the
    port's train_main entry: finite losses, an aux above 0 every step,
    the launch formulas at L = 2, and the first step against a plain f32
    path.  Returns the run's launch counts."""
    from oim_tpu_torch.cli import train_main
    from oim_tpu_torch.ops import flash_attention as fa
    from oim_tpu_torch.ops import fused_ce as fc
    from oim_tpu_torch.ops import rmsnorm as rn

    moe_train_kernels()
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
    check(len(losses) == MOE_TRAIN_STEPS, f"{len(losses)} MoE steps ran")
    check(all(np.isfinite(losses)), f"non-finite MoE loss: {losses}")
    check(all(np.isfinite(aux)) and min(aux) > 0, f"MoE aux {aux}")
    check_train_counts(counts, MOE_TRAIN_STEPS, args)
    del result
    torch.cuda.empty_cache()
    # bf16 compute only: in f32 a 4096-wide row is 16384 bytes, over the
    # RMSNorm kernel's 8192 (ops/rmsnorm.py MAX_ROW_BYTES; ROADMAP Queue
    # C2), so the f32 kernel path does not run at this width.
    print(f"moe train: the f32 kernel path is not checked: a row of "
          f"{MOE_D} f32 is {4 * MOE_D} bytes, over the RMSNorm kernel's "
          f"{rn.MAX_ROW_BYTES}", flush=True)
    step_parity(args, "moe train", (torch.bfloat16,))
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
    and train phases, on a card the earlier phases left empty.  Returns
    the serve phase's counts."""
    release()
    held = torch.cuda.memory_allocated()
    print(f"moe: {gib(held):.2f} GiB allocated before the MoE phases",
          flush=True)
    check(held < 2**30, f"earlier phases still hold {gib(held):.1f} GiB")
    record.update(moe_kernel_phase())
    counts = serve_phase(MOE_SERVE_ARGS, "moe", MOE_FREE_GIB)
    held = torch.cuda.memory_allocated()
    check(held < 2**30, f"the MoE serve phase still holds {gib(held):.1f} "
          f"GiB")
    counts["train"] = moe_train_phase()
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


def run_train(argv) -> dict:
    from oim_tpu_torch.cli import train_main

    return train_main.train(train_main.build_parser().parse_args(argv))


def ckpt_lora_phase(work: str) -> dict:
    """Under ``work``: an uninterrupted 5-step run; the same run
    interrupted after 3 steps (checkpoint every 3) and resumed to 5, whose
    steps 4-5 give the uninterrupted losses; the same command again with
    ``--export-dir``; a LoRA fine-tune on that export with its merged
    export; the merged weights served through ``serve_main``.  Returns
    the LoRA run's fused-CE launch counts."""
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
    full = run_train(ckpt_args(5))["losses"]
    t0 = time.monotonic()
    first = run_train(ckpt_args(3, "--checkpoint-dir", base,
                                "--save-every", "3"))
    resumed = run_train(ckpt_args(5, "--checkpoint-dir", base,
                                  "--save-every", "3"))
    steps = Checkpointer(base).all_steps()
    got = first["losses"] + resumed["losses"]
    print(f"ckpt: {CKPT_LAYERS}-layer full-width runs; uninterrupted losses "
          f"{[round(x, 6) for x in full]}; interrupted at 3 and resumed at "
          f"{resumed['start_step']}: {[round(x, 6) for x in got]}; "
          f"bit-equal: {got == full}; checkpoints on disk {steps} "
          f"({time.monotonic() - t0:.1f} s with saves)", flush=True)
    check(resumed["start_step"] == 3 and len(got) == 5, "resume cursor")
    check(bool(np.allclose(got, full, rtol=RESUME_RTOL, atol=0)),
          f"resumed losses {got} differ from uninterrupted {full}")
    check(steps == [3, 5], f"checkpoint steps {steps}")
    base_bytes = directory_bytes(os.path.join(base, "5"))
    run_train(ckpt_args(5, "--checkpoint-dir", base,
                        "--save-every", "3", "--export-dir", export))
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
        "--serve-phase-only", action="store_true",
        help="build the kernels and run only the serve phase, printing its "
             "kernel counts and times to first token as the last line")
    parser.add_argument(
        "--package", default=HERE, metavar="DIR",
        help="the checkout whose oim_tpu_torch to load (default: this "
             "one); with --kernel-phase-only, --train-phase-only or "
             "--serve-phase-only, another checkout's build is run on the "
             "same inputs")
    args = parser.parse_args(argv)
    if args.package != HERE and not (args.kernel_phase_only
                                     or args.train_phase_only
                                     or args.serve_phase_only):
        parser.error("--package needs --kernel-phase-only, "
                     "--train-phase-only or --serve-phase-only")
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
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}}),
            flush=True)
        return 0
    if args.serve_phase_only:
        from oim_tpu_torch.cli import serve_main

        served = {}
        if "pipeline_depth" in vars(serve_main.build_parser().parse_args([])):
            served["default"] = serve_phase(SERVE_ARGS, "default")
            served["paged"] = serve_phase(PAGED_SERVE_ARGS, "paged")
        else:  # a package from before depth 2: paged, serial, eager only
            served["paged"] = serve_phase(SERVE_ARGS + ["--kv-block", "16"],
                                          "paged")
        print(json.dumps({"package": package, "serve": served}), flush=True)
        return 0
    if args.route_control:
        return route_control(args.route_control)
    if args.moe_phase_only:
        record = {}
        moe = moe_phases(record)
        print(json.dumps({"package": package, "moe": moe,
                          "kernel_phase": record}), flush=True)
        return 0
    record = kernel_phase()
    if args.kernel_phase_only:
        compared = compare_phase()
        print(json.dumps({"package": package, "kernel_phase": record,
                          "compare": compared}), flush=True)
        return 0
    record.update(train_kernel_phase())
    record.update(fused_ce_phase())
    # The main path: serve_main's defaults.  Then the paged engine's
    # serial loop, with its own counts.
    counts = serve_phase(SERVE_ARGS, "default")
    paged_counts = serve_phase(PAGED_SERVE_ARGS, "paged")
    counts.update(train_phase(record))
    work = tempfile.mkdtemp(prefix=".smoke-ckpt-", dir=HERE)
    try:
        free = shutil.disk_usage(work).free
        print(f"ckpt: working in {os.path.basename(work)}, "
              f"{free / 2**30:.0f} GiB free", flush=True)
        # dx alone runs on LoRA steps (a full step runs the joint).
        counts["fused_ce_dx"] = ckpt_lora_phase(work)["fused_ce_dx"]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    moe_counts = moe_phases(record)
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
        f"dense cache, 64-row blocks, H {MOE_H} / KVH {MOE_KVH}: the MoE "
        f"serve phase, Mixtral-8x7B widths at {MOE_LAYERS} layers",
        moe_counts, "_moe",
    ) + [
        dict(name=name, route="cuda", source=source, replaces=replaces,
             launches=counts[name], **record[name])
        for name, (source, replaces) in sources.items()
    ]
    print(SMI, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
