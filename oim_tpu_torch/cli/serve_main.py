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
With ``--weights-int8`` all 32 of Mixtral-8x7B's layers fit one H100
(1.45 GB a layer, against 2.90 in bf16); ``--weights-int4 [--int4-group
G]`` stores the weights as packed int4 with group-wise scales, and
``--kv-int4 --kv-block N`` the paged KV pool as packed int4.  Weights
are quantized from their f32 values: as each is drawn from ``--seed``,
or after a ``--params-dir``/``--checkpoint-dir`` restore, layer by
layer.

Sharded serving: ``--tp T --ep E`` serves one model over T·E local
GPUs, heads, MLP columns and vocab over ``tp``, MoE experts over ``ep``
(``Engine(mesh=...)``).  The command stays one process: it starts the
T·E − 1 other ranks itself (``torch.multiprocessing``, spawned, on
``cuda:1`` …), one NCCL process group through a file rendezvous; rank 0
is the server, the others follow its dispatches.  Each rank draws or
restores the weights and keeps only its shard on its card.  Too few
GPUs fails before any work ("need N devices, have M"); with ``--device
cpu`` the ranks run on the CPU over gloo.  Everything below works on a
mesh too: ``--kv-host-bytes`` (each rank pins its kv-head share of the
tier), ``--params-peer`` (every rank reads the sibling's stream and
keeps its shard), ``/v1/kv``, ``/v1/slot``, ``/v1/weights`` (each
tensor gathered whole to rank 0), ``/v1/beam``, ``/v1/embed`` and the
drain by migration; the followers stop once the last slot record has
been taken or the drain timeout has passed.  ``--bootstrap FILE`` (default
``$TPU_BOOTSTRAP``) binds the process to the cards a CSI-staged
bootstrap names (``/dev/nvidiaN`` → ``CUDA_VISIBLE_DEVICES``) before the
first CUDA touch.

The host-RAM KV tier: ``--kv-host-bytes B --kv-block N`` demotes prefix
entries to a pinned host pool of B bytes instead of evicting them, and
parks the coldest slot there when an admission cannot fit
(``--no-kv-park`` keeps demotion and turns parking off).

Multi-tenant QoS and overload: ``--qos-policy FILE`` (a tenant policy
document, ``qos/policy.py``) admits by weighted fair share and lets a
premium tenant's admission park a lower tier's slot (with the host
tier); ``--brownout-max-tokens N`` clamps budgets under sustained queue
pressure; ``--request-ring N`` sizes the completed-request ring, and
``--slow-capture-e2e``/``--slow-capture-tpot-mult``/
``--slow-capture-interval`` dump slow requests' stories to
``$OIM_FLIGHT_DIR``.

A fleet member: ``--pool prefill|decode|mixed`` is the role a router
partitions on; ``--params-peer URL`` takes the weights from a serving
sibling's ``GET /v1/weights`` (either package's) instead of storage, and
with ``--prefix-cache`` also installs the sibling's ``--prefix-prewarm``
hottest prefix entries before serving.  A stall watchdog
(``--watchdog-interval``, ``--stall-multiplier``, ``--stall-floor``)
fails in-flight requests fast and turns ``/healthz`` 503 while a device
wait is wedged.  SIGTERM or Ctrl-C drains by migration: the server stops
admitting and suspends in-flight requests into ``/v1/slot`` records for
a router to ship, waits up to ``--drain-timeout`` for them to leave and
settles for ``min(2, timeout)`` s; a second Ctrl-C stops at once.

The operator's front door: ``--tokenizer-dir D`` (an HF tokenizer
directory; needs ``transformers``) turns on text prompts, decoded
replies and the OpenAI ``/v1/completions`` and ``/v1/chat/completions``;
``--http-tls --ca --cert --key`` serves over mTLS (the peer's CN is the
tenant; an ``https://`` ``--params-peer`` dials with the same
certificate); ``--paged-kernel``/``--prefill-kernel`` ``auto|on|off``
switch the decode passes and the admissions between the Hopper kernels
and their plain PyTorch versions, the A/B control.  The daemon starts as
the reference's does: ``--log-level``, spans to ``--trace-file``, the
flight recorder with its crash hook, the recompile sentinel and the
process metrics, then the cheap checks (TLS files, the tokenizer)
before any weight moves.

Speculative decoding: ``--spec-decode N`` drafts N tokens a slot a
decode step by prompt lookup (``--spec-ngram``) and verifies them in one
forward; with ``--draft-params-dir D --draft-n-layers ... --draft-d-model
... --draft-n-heads ...`` a small draft model drafts them instead, e.g.
Qwen2.5-0.5B's widths beside Qwen2.5-1.5B:
    ... --spec-decode 4 --draft-params-dir D --draft-n-layers 24 \\
        --draft-d-model 896 --draft-n-heads 14 --draft-n-kv-heads 2 \\
        --draft-d-ff 4864
"""

from __future__ import annotations

import argparse
import os
import shutil
import signal
import sys
import tempfile
import threading
import time

import torch
import torch.distributed as dist

from oim_tpu_torch import log
from oim_tpu_torch.checkpoint import (
    Checkpointer,
    CheckpointerOptions,
    load_params,
    load_params_from_peer,
)
from oim_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
    prepare_param,
)
from oim_tpu_torch.models.weights import (
    check_params,
    recast,
    serve_specs,
    shard_tensor,
)
from oim_tpu_torch.parallel import apply_chip_binding, build_mesh
from oim_tpu_torch.parallel import load_bootstrap
from oim_tpu_torch.parallel.mesh import mesh_devices
from oim_tpu_torch.ops.quant import WEIGHT_QUANT_TARGETS, quantize_weight
from oim_tpu_torch.qos.policy import load_policy_file
from oim_tpu_torch.common import events, metrics, tracing
from oim_tpu_torch.serve import httptls, sentinel
from oim_tpu_torch.serve.disagg import POOLS, prewarm_from_peer
from oim_tpu_torch.serve.engine import Engine, resolve_device
from oim_tpu_torch.serve.server import ServeServer
from oim_tpu_torch.serve.texttok import TextTokenizer

# --paged-kernel / --prefill-kernel → the Engine's switch.
KERNEL_SWITCH = {"auto": None, "on": True, "off": False}


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
    weights.add_argument(
        "--params-peer", default="", metavar="URL",
        help="restore weights from a serving sibling's streamed "
        "GET /v1/weights instead of storage (scale-out fast bring-up: "
        "bounded by network, not checkpoint cold-start); validated "
        "against this instance's --vocab-size/--d-model/... geometry",
    )
    p.add_argument(
        "--prefix-prewarm", type=int, default=4, metavar="K",
        help="with --params-peer and --prefix-cache: also pull the "
        "weight-donor's K hottest resident prefix entries "
        "(GET /v1/kv?prefix=) and install them before serving, so the "
        "replica joins the fleet with its cohort's system prompts "
        "already resident; strictly best-effort — any failure degrades "
        "to normal bring-up (0 = off)",
    )
    p.add_argument(
        "--pool", default="mixed", choices=POOLS,
        help="disaggregation pool role: prefill = take long-prompt "
        "admissions and serve GET /v1/kv exports (pair with --kv-block; "
        "a dense prefill backend makes every ship fall back to "
        "recompute), decode = ingest shipped KV (PUT /v1/kv) and stream "
        "continuations, mixed (default) = serve everything, no ships; "
        "surfaced via /v1/info so a router partitions the fleet",
    )
    p.add_argument(
        "--watchdog-interval", type=float, default=1.0, metavar="S",
        help="stall-watchdog poll interval: a decode chunk blocking the "
        "driver past max(--stall-floor, --stall-multiplier x its EWMA "
        "wall) fails in-flight requests fast and flips /healthz "
        "(0 = watchdog off)",
    )
    p.add_argument(
        "--stall-multiplier", type=float, default=8.0,
        help="stall verdict: device wait exceeding this multiple of the "
        "chunk-wall EWMA",
    )
    p.add_argument(
        "--stall-floor", type=float, default=30.0, metavar="S",
        help="never call a stall before this many seconds of device "
        "wait (headroom for one-off recompiles)",
    )
    p.add_argument(
        "--drain-timeout", type=float, default=120.0,
        help="seconds to let in-flight requests finish on SIGTERM before "
        "exiting",
    )
    p.add_argument(
        "--warmup-embed", action="store_true",
        help="also pre-compile the /v1/embed path at every bucket "
        "(one forward compile per bucket; skip unless serving embeds)",
    )
    p.add_argument(
        "--no-warmup", action="store_true",
        help="skip pre-compiling admit buckets + decode (first live "
        "requests then pay the 20-40s TPU compiles)",
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
                   help="tensor-parallel ways: heads, mlp and vocab over "
                   "tp·ep local GPUs, one spawned rank each")
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel ways for MoE serving")
    p.add_argument("--bootstrap", default="",
                   help="tpu-bootstrap.json path (default: $TPU_BOOTSTRAP "
                   "when set): bind to the staged cards before CUDA starts")
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
    p.add_argument(
        "--kv-host-bytes", type=int, default=0, metavar="B",
        help="host-RAM KV overflow tier budget in bytes (0 = off; "
        "requires --kv-block): prefix shortfalls DEMOTE idle entries "
        "to host RAM instead of destroying them (a later hit promotes "
        "the blocks back — no recompute prefill), and admissions that "
        "cannot fit can park the coldest slot's table there and "
        "restore it exactly when blocks free",
    )
    p.add_argument(
        "--no-kv-park", action="store_true",
        help="with --kv-host-bytes: disable swap-based slot parking "
        "(demote/promote of idle prefix entries stays on) — parking "
        "trades a mid-stream victim's latency for the head-of-line "
        "admission, which latency-floor deployments may not want",
    )
    quant = p.add_mutually_exclusive_group()
    quant.add_argument(
        "--weights-int8", action="store_true",
        help="weight-only int8 for the matmul weights (per-output-channel "
        "scales) — halves weight bytes, the small-batch decode bottleneck",
    )
    quant.add_argument(
        "--weights-int4", action="store_true",
        help="weight-only int4 with group-wise scales (--int4-group) — "
        "~0.56 bytes/weight; the next decode lever once GQA + int8 KV "
        "shrink the cache",
    )
    p.add_argument(
        "--int4-group", type=int, default=64,
        help="int4 scale group along the reduction axis (gcd-clamped to "
        "each layer's geometry)",
    )
    kvq = p.add_mutually_exclusive_group()
    kvq.add_argument(
        "--kv-int8", action="store_true",
        help="int8-quantized KV cache (half the cache bandwidth decode "
        "pays; per-token/head scales)",
    )
    kvq.add_argument(
        "--kv-int4", action="store_true",
        help="int4-quantized KV cache (kv4: half int8's cache bytes "
        "again, packed two values a byte, dequantized in the paged "
        "attention kernels' operand read) — requires --kv-block; dense "
        "layouts reject it because only the paged pool carries the block "
        "scales",
    )
    p.add_argument(
        "--spec-decode", type=int, default=0,
        help="speculative decoding draft length (0 = off): prompt-lookup "
        "drafts verified draft_len+1 positions per slot per step, exact "
        "for greedy and sampled output alike",
    )
    p.add_argument(
        "--spec-ngram", type=int, default=2,
        help="n-gram length the prompt-lookup drafter matches on",
    )
    p.add_argument(
        "--draft-params-dir", default="",
        help="params-only export of a small DRAFT model (oim-train "
        "--export-dir): model-drafted speculation instead of prompt "
        "lookup (requires --spec-decode and the --draft-* geometry)",
    )
    p.add_argument("--draft-n-layers", type=int, default=0)
    p.add_argument("--draft-d-model", type=int, default=0)
    p.add_argument("--draft-n-heads", type=int, default=0)
    p.add_argument("--draft-n-kv-heads", type=int, default=0)
    p.add_argument("--draft-d-ff", type=int, default=0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument(
        "--prefill-chunk", type=int, default=0, metavar="T",
        help="chunked prefill: admit long prompts in T-token KV-write "
        "segments, one an admission wave, so decode chunks of live "
        "streams run between them (T one of the prompt buckets; 0 = "
        "one-shot prefill)",
    )
    p.add_argument(
        "--prefix-cache", type=int, default=0, metavar="N",
        help="cache up to N prompt-KV entries (requests marked "
        "cache_prefix); later prompts sharing a cached prefix skip "
        "re-prefilling it",
    )
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
    p.add_argument(
        "--brownout-max-tokens", type=int, default=0, metavar="N",
        help="brownout: under sustained queue pressure (queue >= 75%% of "
        "--max-queue for over a second), clamp incoming requests' "
        "max_new_tokens to N instead of letting the backlog grow to the "
        "hard 429 — degraded answers beat errors (0 = off)",
    )
    p.add_argument(
        "--request-ring", type=int, default=256, metavar="N",
        help="recently-completed-request ring size: per-request phase "
        "breakdowns (queue/admit/prefill/decode/stream) served at "
        "GET /debugz/requests and merged fleet-wide by the router at "
        "/v1/requests (`oimctl requests`); drop-oldest beyond N",
    )
    p.add_argument(
        "--slow-capture-e2e", type=float, default=0.0, metavar="S",
        help="tail-latency auto-capture: any request whose end-to-end "
        "latency reaches S seconds dumps its full phase trace, an "
        "engine stats snapshot, and the ring neighborhood to the "
        "flight dir ($OIM_FLIGHT_DIR) as a `serve.slow_capture` "
        "artifact (0 = off)",
    )
    p.add_argument(
        "--slow-capture-tpot-mult", type=float, default=0.0, metavar="M",
        help="relative slow-capture trigger: capture when a request's "
        "time-per-output-token exceeds M times the engine's token-rate "
        "EWMA — catches regressions without an absolute threshold "
        "(0 = off)",
    )
    p.add_argument(
        "--slow-capture-interval", type=float, default=60.0, metavar="S",
        help="minimum seconds between slow-capture dumps (rate limit: "
        "one bad burst must not fill the flight dir)",
    )
    p.add_argument(
        "--qos-policy", default="", metavar="FILE",
        help="tenant QoS policy JSON (doc/serving.md 'Multi-tenant "
        "QoS'): the engine admits by weighted fair share instead of "
        "FIFO and may preempt (park, never kill) a lower-tier tenant's "
        "slot for a higher-priority admission; empty = QoS off (pure "
        "FIFO, the pre-QoS behavior)",
    )
    p.add_argument(
        "--paged-kernel", choices=("auto", "on", "off"), default="auto",
        help="hand-written paged attention on every decode pass (decode "
        "chunks, a verify's rows, the draft's decode): kernel K1 over the "
        "block table and K2's fused store, with no gathered K/V view: "
        "auto (default) = on when the engine runs on the GPU, on = the "
        "kernel wrappers anywhere (their plain versions on the CPU), off "
        "= the plain PyTorch gather path on the same device, graphed "
        "too (the A/B control)",
    )
    p.add_argument(
        "--prefill-kernel", choices=("auto", "on", "off"), default="auto",
        help="the same switch for admissions and prompt segments (K2's "
        "fused store, then K1's tensor-core route): auto (default) = on "
        "when the engine runs on the GPU, on = the kernel wrappers "
        "anywhere, off = the plain PyTorch path (the A/B control and "
        "exactness oracle).  Pairs with --prefill-chunk: segments of "
        "long prompts then interleave with decode chunks",
    )
    p.add_argument(
        "--trace-file", default="",
        help="append spans as JSON lines (default: $OIM_TRACE_FILE)",
    )
    p.add_argument("--ca", help="CA cert file (mTLS: --http-tls, an https "
                   "--params-peer)")
    p.add_argument("--cert", help="cert (CN serve.<id>)")
    p.add_argument("--key", help="key")
    p.add_argument(
        "--tokenizer-dir", default="",
        help="HF tokenizer directory (oim-import-hf copies it next to "
        "the weights): enables {'text': ...} requests and decoded-text "
        "replies on the HTTP API; without it this instance speaks "
        "token ids only",
    )
    p.add_argument(
        "--http-tls", action="store_true",
        help="serve the HTTP API over mTLS with the same --ca/--cert/"
        "--key: clients (oim-route, oimctl) must hold a deployment-CA "
        "cert or the handshake fails (the gRPC plane's mTLS-everywhere "
        "stance, on the data plane)",
    )
    p.add_argument("--log-level", default="info")
    return p


def peer_ssl_context(args):
    """The client context an ``https://`` ``--params-peer`` dials with
    (``--ca/--cert/--key``; SystemExit without them), else None."""
    if not args.params_peer.startswith("https://"):
        return None
    if not (args.ca and args.cert and args.key):
        raise SystemExit("an https --params-peer needs --ca/--cert/--key")
    return httptls.client_ssl_context(args.ca, args.cert, args.key)


def weight_quant(args) -> str:
    """The weight quant mode the flags ask for: "int8", "int4" or ""."""
    if getattr(args, "weights_int8", False):
        return "int8"
    return "int4" if getattr(args, "weights_int4", False) else ""


def place_served(params: dict, cfg: TransformerConfig, mode: str,
                 group: int, device, place=None) -> dict:
    """Restored f32 ``params`` (checked) onto ``device`` in serving's
    layout, in place, one tensor at a time — quantized under ``mode``
    from its whole f32 values, else cast to the compute dtype — each
    kept as ``place`` returns it (a rank's shard: the card never holds
    the whole model), as the reference quantizes a restored tree."""
    place = place or (lambda name, t: t)
    for tree in (params, *params["layers"]):
        for name in [n for n in tree if n != "layers"]:
            value = tree[name].to(device)
            if mode and name in WEIGHT_QUANT_TARGETS:
                q, scale = quantize_weight(value, mode, group)
                tree[name] = place(name, q)
                tree[f"{name}_wscale"] = place(f"{name}_wscale", scale)
            else:
                tree[name] = place(name, prepare_param(name, value, cfg))
    return params


def load_weights(args, cfg: TransformerConfig, device, mesh=None) -> dict:
    """The served parameters in serving's layout: the export or the
    checkpoint's f32 params (checked against the flags' geometry, cast to
    the compute dtype, or quantized with ``--weights-int8``/``-int4``
    from their f32 values, one tensor at a time), else random from
    ``--seed`` (quantized as drawn).  A missing export or checkpoint
    raises: a server never quietly serves random weights.  On a rank of
    ``mesh`` each tensor is made whole on the card (drawn, or restored to
    the host first), quantized or cast, and cut to the rank's shard
    before the next: the card holds its shard and one whole tensor,
    never the model, as the reference restores sharded over its serving
    mesh."""
    mode = weight_quant(args)
    if args.params_peer:
        # The sibling streams what it serves, quantized or not: checked
        # against the flags' geometry and weight quant, never requantized;
        # on a mesh each rank reads it and keeps its shard.
        return load_params_from_peer(args.params_peer, cfg, device,
                                     weight_quant=mode,
                                     int4_group=args.int4_group,
                                     ssl_context=peer_ssl_context(args),
                                     mesh=mesh)
    place = None
    if mesh is not None:
        specs = serve_specs(cfg, mesh, mode, args.int4_group)

        def place(name, tensor):
            return shard_tensor(name, tensor, specs, mesh)

    if not (args.params_dir or args.checkpoint_dir):
        return init_params(args.seed, cfg, device=device, weight_quant=mode,
                           int4_group=args.int4_group, place=place)
    params, what = restore_params(args, device if mesh is None else "cpu")
    check_params(params, cfg, what)
    return place_served(params, cfg, mode, args.int4_group, device, place)


def restore_params(args, device) -> tuple:
    """(f32 params on ``device``, what they came from) of
    ``--params-dir`` or ``--checkpoint-dir``."""
    if args.params_dir:
        return (load_params(args.params_dir, device=device),
                f"--params-dir {args.params_dir}")
    with Checkpointer(args.checkpoint_dir,
                      CheckpointerOptions(create=False)) as ckpt:
        return (ckpt.restore_params(device=device),
                f"--checkpoint-dir {args.checkpoint_dir}")


def draft_config(args) -> TransformerConfig:
    """The draft model's config from the ``--draft-*`` flags and the
    target's vocabulary, RoPE base, norm epsilon and dtype, as the
    reference's ``serve_main`` builds it."""
    if not (args.draft_n_layers and args.draft_d_model
            and args.draft_n_heads):
        raise SystemExit(
            "--draft-params-dir needs --draft-n-layers, "
            "--draft-d-model and --draft-n-heads"
        )
    return TransformerConfig(
        vocab_size=args.vocab_size,
        d_model=args.draft_d_model,
        n_layers=args.draft_n_layers,
        n_heads=args.draft_n_heads,
        n_kv_heads=args.draft_n_kv_heads,
        d_ff=args.draft_d_ff,
        rope_theta=args.rope_theta,
        norm_eps=args.norm_eps,
        dtype=args.dtype,
    )


def load_draft(args, device):
    """(draft params, draft config) from ``--draft-params-dir``
    (``draft_config``), or (None, None)."""
    if not args.draft_params_dir:
        return None, None
    draft_cfg = draft_config(args)
    what = f"--draft-params-dir {args.draft_params_dir}"
    params = load_params(args.draft_params_dir, device=device)
    check_params(params, draft_cfg, what)
    return recast(params, draft_cfg, draft_cfg.dtype)[0], draft_cfg


def model_config(args) -> TransformerConfig:
    """The served model's config from the geometry flags."""
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
        d_ff=args.d_ff or 4 * args.d_model,
        n_experts=args.n_experts,
        moe_top_k=args.moe_top_k,
        rope_theta=args.rope_theta,
        rope_scaling=tuple(args.rope_scaling),
        sliding_window=args.sliding_window,
        norm_eps=args.norm_eps,
        dtype=args.dtype,
    )


def make_engine(args, cuda_graphs: bool = True, mesh=None) -> Engine:
    """The engine from parsed args: device first (no GPU and no
    ``--device cpu`` fails before any work), then weights and engine;
    on a rank of ``mesh`` (``join_mesh``) its shard on its device.
    ``cuda_graphs=False`` dispatches decode chunks and admissions
    eagerly: a measurement's A/B control, deliberately not a serving
    flag."""
    if mesh is None and mesh_size(args) > 1:
        raise ValueError(
            f"--tp {args.tp} --ep {args.ep}: sharded serving runs on the "
            f"mesh of ranks that main() starts (ROADMAP Queue A12, first "
            f"part); make_engine alone serves one device")
    device = mesh.device if mesh is not None else resolve_device(args.device)
    # Tolerant load (defaults on a missing or torn file): a bad policy
    # document degrades to FIFO and never blocks serving.
    qos = load_policy_file(args.qos_policy) if args.qos_policy else None
    cfg = model_config(args)
    params = load_weights(args, cfg, device, mesh)
    draft_params, draft_cfg = load_draft(args, device)
    return Engine(
        params, cfg,
        n_slots=args.n_slots,
        max_len=args.max_len,
        chunk=args.chunk,
        top_k=args.top_k,
        top_p=args.top_p,
        kv_int8=args.kv_int8,
        kv_int4=args.kv_int4,
        prefix_cache_size=args.prefix_cache,
        prefill_chunk=args.prefill_chunk,
        spec_decode=args.spec_decode,
        spec_ngram=args.spec_ngram,
        draft_params=draft_params,
        draft_cfg=draft_cfg,
        penalties=not args.no_penalties,
        max_queue=args.max_queue,
        pipeline_depth=args.pipeline_depth,
        kv_block=args.kv_block,
        kv_blocks=args.kv_blocks,
        kv_host_bytes=args.kv_host_bytes,
        kv_park=not args.no_kv_park,
        brownout_max_tokens=args.brownout_max_tokens,
        request_ring=args.request_ring,
        qos=qos,
        slow_capture_e2e_s=args.slow_capture_e2e,
        slow_capture_tpot_mult=args.slow_capture_tpot_mult,
        slow_capture_interval_s=args.slow_capture_interval,
        device=device,
        cuda_graphs=cuda_graphs,
        paged_kernel=KERNEL_SWITCH[args.paged_kernel],
        prefill_kernel=KERNEL_SWITCH[args.prefill_kernel],
        mesh=mesh,
    )


def mesh_size(args) -> int:
    return args.tp * args.ep


def join_mesh(args, rank: int, store_path: str):
    """This process's rank of the serving mesh: the process group
    (NCCL, or gloo with ``--device cpu``) through the file rendezvous at
    ``store_path``, then the tp×ep mesh over one device a rank."""
    n = mesh_size(args)
    cpu = torch.device(args.device).type == "cpu"
    devices = ["cpu"] * n if cpu else mesh_devices(n)
    store = dist.FileStore(store_path, n)
    if cpu:
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=n)
    else:
        dist.init_process_group("nccl", store=store, rank=rank,
                                world_size=n, device_id=devices[rank])
    return build_mesh(tp=args.tp, ep=args.ep, devices=devices)


def follow_rank(rank: int, store_path: str, argv) -> None:
    """A follower rank of ``serve_main --tp/--ep`` (the spawned target):
    its shard of the engine, running rank 0's dispatches until rank 0
    stops it."""
    args = build_parser().parse_args(argv)
    log.init_from_string(args.log_level)
    torch.set_num_threads(1)
    engine = make_engine(args, mesh=join_mesh(args, rank, store_path))
    engine.follow()
    dist.destroy_process_group()


def start_mesh(args, argv) -> tuple:
    """(this process's mesh rank 0, the follower processes, the
    rendezvous directory) for ``--tp``/``--ep``, or (None, [], None).
    Too few GPUs fails here, before any process starts."""
    n = mesh_size(args)
    if n == 1:
        return None, [], None
    if torch.device(args.device).type != "cpu":
        mesh_devices(n)
    rendezvous = tempfile.mkdtemp(prefix="oim-serve-mesh-")
    store = os.path.join(rendezvous, "store")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=follow_rank, args=(rank, store, argv),
                         daemon=True) for rank in range(1, n)]
    for p in procs:
        p.start()
    log.current().info("mesh ranks started", tp=args.tp, ep=args.ep,
                       followers=len(procs))
    return join_mesh(args, 0, store), procs, rendezvous


def stop_mesh(engine, procs, rendezvous) -> None:
    """Stop the followers (the leader's stop record), join them, and
    remove the rendezvous: no rank outlives the leader."""
    if engine is not None and engine.mesh is not None:
        engine.stop_followers()
    for p in procs:
        p.join(timeout=30)
        if p.is_alive():
            p.terminate()
            p.join()
    if procs:
        log.current().info("mesh ranks stopped",
                           exitcodes=[p.exitcode for p in procs])
    if rendezvous is not None:
        shutil.rmtree(rendezvous, ignore_errors=True)


def server_tls(args):
    """The listener's mTLS context (``--http-tls``; SystemExit without
    ``--ca/--cert/--key``), else None."""
    if not args.http_tls:
        return None
    if not (args.ca and args.cert and args.key):
        raise SystemExit("--http-tls requires --ca/--cert/--key")
    return httptls.server_ssl_context(args.ca, args.cert, args.key)


def load_tokenizer(args):
    """``--tokenizer-dir``'s tokenizer, else None."""
    if not args.tokenizer_dir:
        return None
    tokenizer = TextTokenizer(args.tokenizer_dir)
    log.current().info("tokenizer loaded", path=args.tokenizer_dir)
    return tokenizer


def start_server(args, ssl_context=None, tokenizer=None,
                 mesh=None) -> ServeServer:
    """Build and warm the engine (unless ``--no-warmup``; on ``mesh``,
    rank 0's), install the
    weight donor's hottest prefix entries (``--params-peer`` with
    ``--prefix-cache``: after warmup, before the step thread starts, so
    this thread writes the pool), then start the server with
    ``ssl_context`` and ``tokenizer``; logs the listening line."""
    engine = make_engine(args, mesh=mesh)
    if not args.no_warmup:
        log.current().info("warming up", buckets=list(engine.prompt_buckets))
        engine.warmup(embed=args.warmup_embed)
    if args.params_peer and args.prefix_prewarm > 0 and args.prefix_cache:
        opener = httptls.opener(peer_ssl_context(args)).open
        installed = prewarm_from_peer(engine, args.params_peer.rstrip("/"),
                                      args.prefix_prewarm, opener=opener)
        log.current().info("prefix pre-warm", peer=args.params_peer,
                           installed=installed)
    server = ServeServer(
        engine, host=args.host, port=args.port, ssl_context=ssl_context,
        tokenizer=tokenizer, watchdog_interval=args.watchdog_interval,
        stall_multiplier=args.stall_multiplier,
        stall_floor_s=args.stall_floor, pool=args.pool,
    ).start()
    scheme = "https" if server.tls else "http"
    log.current().info(
        "oim-serve listening", host=server.host, port=server.port,
        n_slots=args.n_slots, max_len=args.max_len, mtls=server.tls,
        url=f"{scheme}://{server.host}:{server.port}",
    )
    return server


def init_daemon(args) -> None:
    """The reference's daemon init, in its order: the log level, the
    span collector (``--trace-file``), the flight recorder and its crash
    hook, the recompile sentinel (before any warmup, so that its
    bracket sees every capture and build) and the process metrics."""
    log.init_from_string(args.log_level)
    tracing.init("oim-serve", args.trace_file or None)
    events.init("oim-serve")
    events.install_crash_hook()
    sentinel.install()
    metrics.install_process_metrics()


def bind_bootstrap(args) -> dict:
    """Apply ``--bootstrap``'s (or ``$TPU_BOOTSTRAP``'s) chip binding,
    in the reference's place in the init order: before the first CUDA
    touch.  Returns what was applied ({} without a bootstrap)."""
    path = args.bootstrap or os.environ.get("TPU_BOOTSTRAP", "")
    if not path:
        return {}
    applied = apply_chip_binding(load_bootstrap(path))
    log.current().info("chip binding", path=path, applied=applied)
    return applied


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    init_daemon(args)
    bind_bootstrap(args)
    # The cheap pieces first: a bad certificate path, tokenizer
    # directory or peer URL fails before any weight moves.
    ssl_context = server_tls(args)
    tokenizer = load_tokenizer(args)
    peer_ssl_context(args)
    mesh, procs, rendezvous = start_mesh(args, argv)
    server = engine = None
    try:
        server = start_server(args, ssl_context, tokenizer, mesh)
        engine = server.engine
        serve_until_stopped(args, server)
    finally:
        stop_mesh(engine, procs, rendezvous)
    return 0


def serve_until_stopped(args, server) -> None:
    """Serve until SIGTERM or Ctrl-C, then drain and stop the server."""
    engine = server.engine
    stop = threading.Event()

    # Ctrl-C drains as SIGTERM does; a second one is the default
    # handler's KeyboardInterrupt: a hard stop mid-drain.
    def request_stop(*_):
        signal.signal(signal.SIGINT, signal.default_int_handler)
        stop.set()

    signal.signal(signal.SIGTERM, request_stop)
    signal.signal(signal.SIGINT, request_stop)
    try:
        stop.wait()
        # Migrate-out drain: stop admitting and suspend in-flight slots
        # into /v1/slot records for a router to ship to siblings, so the
        # wait below ends as soon as they are suspended.  Under a mesh a
        # record's export needs every rank, so the wait also lasts until
        # the records have been taken.
        server.begin_drain()
        log.current().info("draining", in_flight=engine.in_flight(),
                           timeout_s=args.drain_timeout)
        deadline = time.monotonic() + args.drain_timeout

        def busy() -> bool:
            return bool(engine.in_flight() or (
                engine.mesh is not None
                and engine.stats()["migrated_slots"]))

        while busy() and time.monotonic() < deadline:
            time.sleep(0.2)
        # Settle: the last slot frees before its handler thread has
        # written the reply; exiting at once would cut that reply.
        time.sleep(min(2.0, args.drain_timeout))
        log.current().info("drained", remaining=engine.in_flight())
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()


if __name__ == "__main__":
    raise SystemExit(main())
