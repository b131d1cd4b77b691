"""The PyTorch port's serving slice on the CPU, against the JAX package.

One small Qwen2-style model (q/k/v biases, GQA 4/2, f32) is drawn from a
seed by the JAX package and handed to the port with ``from_jax_params``,
so both packages compute the same function:

- the port's plain ``prefill`` logits agree with the reference's to
  1e-4 (f32, summation order only);
- greedy streams are token-identical to ``oim_tpu.models.decode.generate``
  — the port's solo ``generate`` and its paged ``Engine`` alike, fp and
  int8 KV, with more requests than slots and mixed prompt lengths;
- sampled streams cannot reproduce JAX's threefry bits, so a sampled
  request through the engine must equal the port's own solo
  ``generate`` with the same seed (the key depends only on the request
  and the token index, never on the slot, batch or chunk);
- the HTTP server and ``serve_main`` answer the JAX server's JSON.
"""

import gc
import json
import threading
import time
import urllib.error
import urllib.request
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oim_tpu.models import TransformerConfig as JaxConfig
from oim_tpu.models import decode as jdecode
from oim_tpu.models import init_params as jax_init_params

from oim_tpu_torch.cli import serve_main
from oim_tpu_torch.models import decode as tdecode
from oim_tpu_torch.models.transformer import TransformerConfig
from oim_tpu_torch.models.transformer import init_params
from oim_tpu_torch.models.weights import from_jax_params, n_params
from oim_tpu_torch.ops import paged_attention as tpa
from oim_tpu_torch.qos.policy import QosPolicy
from oim_tpu_torch.serve.engine import (
    BlockAllocator,
    DeadlineExpiredError,
    Engine,
    GenRequest,
    RequestFailedError,
)
from oim_tpu_torch.serve.server import ServeServer
from torch_cpu_threads import one_torch_thread  # noqa: F401

CFG = dict(
    vocab_size=101, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=96, attn_bias=True, dtype="float32",
)
ENGINE = dict(
    n_slots=3, max_len=64, chunk=4, prompt_buckets=(8, 16, 32), kv_block=8,
    device="cpu",
)
QUANTS = [False, True]
QUANT_IDS = ["fp", "kv8"]
# The config switches the serving forward reads beyond the Qwen2 shape:
# Gemma's gelu_tanh MLP, offset norm scales and scaled embedding, and a
# sliding window shorter than the prompts.
VARIANT = dict(mlp_act="gelu_tanh", norm_offset=True, embed_scale=True,
               sliding_window=5)


@pytest.fixture(scope="module")
def model():
    """(jax cfg, jax params, port cfg, port params) — the same weights.
    The reference initialises biases to zero; random ones make the
    q/k/v bias path count."""
    jcfg = JaxConfig(**CFG, use_pallas=False)
    jparams = dict(jax_init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.RandomState(0)
    for name in ("bq", "bk", "bv"):
        shape = jparams[name].shape
        jparams[name] = jnp.asarray(
            rng.randn(*shape).astype(np.float32) * 0.1
        )
    tree = {name: np.asarray(value) for name, value in jparams.items()}
    tcfg = TransformerConfig(**CFG)
    return jcfg, jparams, tcfg, from_jax_params(tree, tcfg)


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, CFG["vocab_size"], n).tolist() for n in lengths]


def _jax_greedy(jcfg, jparams, prompts, max_new, **kw):
    """Reference continuations, one ``generate`` call per prompt group of
    equal length and budget (rows of one call are independent)."""
    out = {}
    groups = {}
    for i, (p, m) in enumerate(zip(prompts, max_new)):
        groups.setdefault((len(p), m), []).append(i)
    for (n, m), rows in groups.items():
        batch = jnp.asarray([prompts[i] for i in rows], jnp.int32)
        gen = np.asarray(jdecode.generate(jparams, batch, jcfg, m, **kw))
        for r, i in enumerate(rows):
            out[i] = gen[r, n:].tolist()
    return [out[i] for i in range(len(prompts))]


def test_from_jax_params_layout(model):
    jcfg, jparams, tcfg, params = model
    assert len(params["layers"]) == CFG["n_layers"]
    total = sum(int(np.prod(v.shape)) for v in jparams.values())
    assert n_params(params) == total
    lp = params["layers"][1]
    np.testing.assert_array_equal(
        lp["wq"].numpy(), np.asarray(jparams["wq"])[0, 1]
    )
    assert lp["attn_norm"].dtype == torch.float32


def test_init_params_is_seeded():
    cfg = TransformerConfig(**CFG)
    a, b = init_params(3, cfg), init_params(3, cfg)
    c = init_params(4, cfg)
    assert torch.equal(a["wte"], b["wte"]) and not torch.equal(
        a["wte"], c["wte"])
    # Truncated normal at +-2 sigma, scaled by 1/sqrt(fan_in).
    assert float(a["wlm"].abs().max()) <= 2.0 / CFG["d_model"] ** 0.5
    assert torch.equal(a["layers"][0]["bq"], torch.zeros(64))


def _variant_model():
    """A second model with every VARIANT switch on, as ``model``."""
    cfg = {**CFG, **VARIANT}
    jcfg = JaxConfig(**cfg, use_pallas=False)
    jparams = jax_init_params(jax.random.PRNGKey(1), jcfg)
    tree = {name: np.asarray(value) for name, value in jparams.items()}
    tcfg = TransformerConfig(**cfg)
    return jcfg, jparams, tcfg, from_jax_params(tree, tcfg)


@pytest.mark.parametrize("variant", [False, True], ids=["qwen2", "variant"])
def test_prefill_logits_match_jax(model, variant):
    jcfg, jparams, tcfg, params = _variant_model() if variant else model
    tokens = np.asarray(_prompts(1, [9, 9]), np.int32)
    want, _ = jdecode.prefill(jparams, jnp.asarray(tokens), jcfg, 16)
    got, cache = tdecode.prefill(params, torch.from_numpy(tokens), tcfg, 16)
    assert got.dtype == torch.float32 and cache.length == 9
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("kv_int8", QUANTS, ids=QUANT_IDS)
def test_solo_generate_matches_jax(model, kv_int8):
    jcfg, jparams, tcfg, params = model
    tokens = np.asarray(_prompts(2, [7, 7]), np.int32)
    want = jdecode.generate(jparams, jnp.asarray(tokens), jcfg, 10,
                            kv_int8=kv_int8)
    got = tdecode.generate(params, torch.from_numpy(tokens), tcfg, 10,
                           kv_int8=kv_int8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kv_int8", QUANTS, ids=QUANT_IDS)
def test_engine_greedy_matches_jax(model, kv_int8):
    """Six requests submitted together on three slots, three prompt
    buckets, budgets that end mid-chunk: identical to the reference."""
    jcfg, jparams, tcfg, params = model
    prompts = _prompts(3, [5, 5, 12, 12, 20, 20])
    max_new = [9, 9, 6, 6, 11, 11]
    engine = Engine(params, tcfg, kv_int8=kv_int8, **ENGINE).warmup()
    rids = [engine.submit(GenRequest(tokens=p, max_new_tokens=m))
            for p, m in zip(prompts, max_new)]
    engine.run()
    got = [engine.result(rid) for rid in rids]
    assert got == _jax_greedy(jcfg, jparams, prompts, max_new,
                              kv_int8=kv_int8)
    stats = engine.stats()
    assert stats["active_slots"] == stats["queued"] == 0
    assert stats["kv_blocks_used"] == 0
    assert stats["tokens_generated"] == sum(max_new)


def test_engine_variant_greedy_matches_jax():
    """The VARIANT switches through the paged engine (the window applied
    by the attention kernels' plain versions) match the reference."""
    jcfg, jparams, tcfg, params = _variant_model()
    prompts = _prompts(9, [7, 13])
    engine = Engine(params, tcfg, **ENGINE)
    rids = [engine.submit(GenRequest(tokens=p, max_new_tokens=9))
            for p in prompts]
    engine.run()
    got = [engine.result(rid) for rid in rids]
    assert got == _jax_greedy(jcfg, jparams, prompts, [9, 9])


def test_engine_penalties_match_jax(model):
    jcfg, jparams, tcfg, params = model
    prompts = _prompts(4, [10, 10])
    penal = dict(repetition_penalty=1.3, presence_penalty=0.2,
                 frequency_penalty=0.1)
    engine = Engine(params, tcfg, **ENGINE)
    rids = [engine.submit(GenRequest(tokens=p, max_new_tokens=12, **penal))
            for p in prompts]
    engine.run()
    got = [engine.result(rid) for rid in rids]
    assert got == _jax_greedy(jcfg, jparams, prompts, [12, 12], **penal)


def test_engine_sampled_matches_solo_generate(model):
    """Sampled requests (top-p, penalties) through two slots, so they
    run in different batches and slots: each equals the port's solo
    ``generate`` at its seed."""
    _, _, tcfg, params = model
    prompt = _prompts(5, [11])[0]
    kw = dict(temperature=0.9, top_p=0.95, repetition_penalty=1.2)
    engine = Engine(params, tcfg, **{**ENGINE, "n_slots": 2, "chunk": 3})
    seeds = (1, 2, 3)
    rids = [engine.submit(GenRequest(tokens=prompt, max_new_tokens=10,
                                     seed=s, **kw)) for s in seeds]
    engine.run()
    outs = []
    for s, rid in zip(seeds, rids):
        want = tdecode.generate(params, torch.tensor([prompt]), tcfg, 10,
                                seed=s, **kw)[0, len(prompt):].tolist()
        got = engine.result(rid)
        assert got == want
        outs.append(got)
    assert len({tuple(o) for o in outs}) > 1  # the seed matters


def test_engine_pool_backpressure_stays_exact(model):
    """A pool too small for the offered load defers admissions; the
    deferred requests still come out identical to the solo oracle and
    every block returns."""
    _, _, tcfg, params = model
    engine = Engine(params, tcfg, **{**ENGINE, "kv_blocks": 6})
    prompts = _prompts(6, [12, 14, 9, 13])
    rids = [engine.submit(GenRequest(tokens=p, max_new_tokens=8))
            for p in prompts]
    engine.run()
    for p, rid in zip(prompts, rids):
        want = tdecode.generate(params, torch.tensor([p]), tcfg, 8)
        assert engine.result(rid) == want[0, len(p):].tolist()
    stats = engine.stats()
    assert stats["kv_admit_deferrals"] > 0
    assert stats["kv_blocks_used"] == 0 and stats["kv_blocks_free"] == 6


def test_engine_runs_plain_attention_on_cpu(model):
    """On the CPU every layer of every pass runs the plain versions and
    no kernel launches; one store and one attend per layer per pass."""
    _, _, tcfg, params = model
    engine = Engine(params, tcfg, **ENGINE)
    tpa.reset_counters()
    rid = engine.submit(GenRequest(tokens=[1, 2, 3], max_new_tokens=6))
    engine.run()
    assert len(engine.result(rid)) == 6
    counts = tpa.counters()
    stats = engine.stats()
    passes = stats["prefill_dispatches"] + stats["decode_passes"]
    assert counts["paged_flash_decode"] == counts["paged_kv_store"] == 0
    assert counts["paged_flash_decode_plain"] == CFG["n_layers"] * passes
    assert counts["paged_kv_store_plain"] == CFG["n_layers"] * passes


def test_engine_stop_ids_and_cancel(model):
    _, _, tcfg, params = model
    prompt = _prompts(7, [6])[0]
    full = tdecode.generate(params, torch.tensor([prompt]), tcfg, 12)
    full = full[0, len(prompt):].tolist()
    engine = Engine(params, tcfg, **{**ENGINE, "n_slots": 1})
    rid = engine.submit(GenRequest(tokens=prompt, max_new_tokens=12,
                                   stop_ids=(full[4],)))
    queued = engine.submit(GenRequest(tokens=prompt, max_new_tokens=4))
    assert engine.cancel(queued)
    engine.run()
    got = engine.result(rid)
    assert got == full[: full.index(full[4]) + 1]  # the stop id is emitted
    with pytest.raises(RequestFailedError) as err:
        engine.result(queued)
    assert err.value.kind == "cancelled"
    assert engine.stats()["kv_blocks_used"] == 0


def test_engine_deadlines(model):
    """A deadline already past is refused at submission; one that passes
    while the request waits in the queue sheds it before it takes a
    slot; one that passes mid-decode fails it at the next chunk
    boundary and returns its blocks."""
    _, _, tcfg, params = model
    engine = Engine(params, tcfg, **{**ENGINE, "n_slots": 1})
    with pytest.raises(DeadlineExpiredError):
        engine.submit(GenRequest(tokens=[1, 2], max_new_tokens=2,
                                 deadline=time.monotonic() - 1.0))
    busy = engine.submit(GenRequest(tokens=[1, 2], max_new_tokens=8))
    late = engine.submit(GenRequest(tokens=[3], max_new_tokens=2,
                                    deadline=time.monotonic() + 0.05))
    engine.step()  # seats `busy` in the one slot; `late` waits
    time.sleep(0.1)
    engine.run()
    assert len(engine.result(busy)) == 8
    with pytest.raises(RequestFailedError) as err:
        engine.result(late)
    assert err.value.kind == "deadline_queue"
    slow = engine.submit(GenRequest(tokens=[1, 2], max_new_tokens=20,
                                    deadline=time.monotonic() + 0.5))
    engine.step()  # admitted, one chunk decoded
    time.sleep(0.6)
    engine.run()
    with pytest.raises(RequestFailedError) as err:
        engine.result(slow)
    assert err.value.kind == "deadline"
    assert engine.stats()["kv_blocks_used"] == 0


@pytest.mark.parametrize("option,match", [
    # Served since their ports (the cases keep their ids): the host tier
    # beside the prefix cache whose entries it takes, and alone; spec
    # decode alone and beside chunked prefill; a QoS policy (``info``
    # reports whether one is loaded).
    (dict(prefix_cache_size=2, kv_host_bytes=1 << 20), "host tier"),
    (dict(spec_decode=2), "spec decode"),
    (dict(prefill_chunk=8, spec_decode=2), "spec decode"),
    (dict(kv_host_bytes=1 << 20), "host tier"),
    (dict(qos=QosPolicy()), "QoS"),
])
def test_engine_refuses_unported_options(model, option, match):
    _, _, tcfg, params = model
    if match in _PORTED:
        engine = Engine(params, tcfg, **{**ENGINE, **option})
        info = engine.info()["engine"]
        assert {k: info[k] for k in option} == {
            k: True if k == "qos" else v for k, v in option.items()}
        if match in _PAGED_ONLY:
            # The reference's refusal on the dense cache, message and all.
            with pytest.raises(ValueError, match=_PAGED_ONLY[match]):
                Engine(params, tcfg, **{**ENGINE, **option, "kv_block": 0})
        return
    with pytest.raises(ValueError, match=f"ROADMAP.*{match}"):
        Engine(params, tcfg, **{**ENGINE, **option})


# Options the cases above once refused, served since, and those of them
# that need the paged pool (the reference's ValueError on a dense one).
_PORTED = {"spec decode", "host tier", "QoS"}
_PAGED_ONLY = {"host tier": "kv_host_bytes needs the paged cache"}


def test_engine_refuses_moe_and_cache_prefix(model):
    """MoE configs and ``cache_prefix`` are served now (the name is the
    test's earlier one): an engine builds on MoE weights and reports its
    experts; ``cache_prefix`` is ignored with the prefix cache off, as
    in the reference, and honoured with it on."""
    _, _, tcfg, params = model
    moe = TransformerConfig(**{**CFG, "n_experts": 4, "moe_top_k": 2})
    info = Engine(init_params(0, moe), moe, **ENGINE).info()["model"]
    assert (info["n_experts"], info["moe_top_k"]) == (4, 2)
    for size in (0, 2):
        engine = Engine(params, tcfg, **ENGINE, prefix_cache_size=size)
        # Nine tokens: one full block of the paged pool to share.
        rid = engine.submit(GenRequest(tokens=list(range(1, 10)),
                                       max_new_tokens=2, cache_prefix=True))
        engine.run()
        assert len(engine.result(rid)) == 2
        assert engine.stats()["prefix_entries"] == (0 if size == 0 else 1)


def test_block_allocator():
    alloc = BlockAllocator(4)
    a = alloc.alloc(3)
    assert alloc.alloc(2) is None  # all or nothing
    assert alloc.free_blocks == 1 and alloc.used_blocks == 3
    assert alloc.decref(a) == 3 and alloc.free_blocks == 4
    with pytest.raises(ValueError):
        alloc.decref([a[0]])


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        return json.loads(resp.read())


def test_server_generate_roundtrip(model):
    """Five concurrent /v1/generate on a three-slot engine (queueing and
    continuous batching) return the solo oracle's tokens."""
    _, _, tcfg, params = model
    server = ServeServer(Engine(params, tcfg, **ENGINE)).start()
    try:
        assert _get(server.port, "/healthz") == {"ok": True}
        prompts = _prompts(8, [4, 9, 15, 22, 6])
        bodies = [{"tokens": p, "max_new_tokens": 7, "logprobs": True}
                  for p in prompts]
        bodies[1].update(temperature=0.7, seed=11, top_p=0.9)
        replies = [None] * len(bodies)

        def send(i):
            replies[i] = _post(server.port, bodies[i])

        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(len(bodies))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        for body, (status, reply) in zip(bodies, replies):
            assert status == 200
            kw = {k: body[k] for k in ("temperature", "seed", "top_p")
                  if k in body}
            want = tdecode.generate(params, torch.tensor([body["tokens"]]),
                                    tcfg, 7, **kw)
            assert reply["tokens"] == want[0, len(body["tokens"]):].tolist()
            assert len(reply["logprobs"]) == 7
            assert all(lp <= 0.0 for lp in reply["logprobs"])
        stats = _get(server.port, "/v1/stats")
        assert stats["active_slots"] == 0 and stats["queued"] == 0
        info = _get(server.port, "/v1/info")
        assert info["engine"]["paged"] and info["engine"]["device"] == "cpu"
        assert info["model"]["n_kv_heads"] == 2
        # A stream answers NDJSON: the solo oracle's tokens, one line
        # each, then the done line.
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/v1/generate",
            data=json.dumps({"tokens": prompts[0], "max_new_tokens": 7,
                             "stream": True}).encode())
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.headers["Content-Type"] == "application/x-ndjson"
            lines = [json.loads(ln) for ln in resp.read().splitlines()]
        want = tdecode.generate(params, torch.tensor([prompts[0]]), tcfg, 7)
        want = want[0, len(prompts[0]):].tolist()
        assert [ln["token"] for ln in lines[:-1]] == want
        assert lines[-1]["done"] is True and lines[-1]["tokens"] == want
        # The prefix cache is off: cache_prefix is ignored, as in the
        # reference, not refused.
        status, reply = _post(server.port, {"tokens": [1],
                                            "max_new_tokens": 2,
                                            "cache_prefix": True})
        assert status == 200 and len(reply["tokens"]) == 2
        assert _get(server.port, "/v1/stats")["prefix_entries"] == 0
        status, _ = _post(server.port, {"max_new_tokens": 3})
        assert status == 400
        status, _ = _post(server.port, {"tokens": [1] * 70})
        assert status == 400
    finally:
        server.stop()


def test_serve_main_on_cpu(model):
    """The entry point as a user calls it, with ``--device cpu``: weights
    from the seed, warmup, listen, answer, stop."""
    args = serve_main.build_parser().parse_args([
        "--vocab-size", "101", "--d-model", "64", "--n-layers", "2",
        "--n-heads", "4", "--n-kv-heads", "2", "--d-ff", "96",
        "--attn-bias", "--dtype", "float32", "--max-len", "64",
        "--n-slots", "2", "--chunk", "4", "--kv-block", "8", "--port", "0",
        "--seed", "5", "--device", "cpu",
    ])
    server = serve_main.start_server(args)
    try:
        status, reply = _post(server.port, {"tokens": [3, 1, 4, 1, 5],
                                            "max_new_tokens": 5})
        assert status == 200
        cfg = server.engine.cfg
        want = tdecode.generate(init_params(5, cfg),
                                torch.tensor([[3, 1, 4, 1, 5]]), cfg, 5)
        assert reply["tokens"] == want[0, 5:].tolist()
        assert server.engine.stats()["tokens_generated"] == 5  # no warmup
    finally:
        server.stop()


def test_server_stop_releases_engine():
    """A stopped server holds its engine in no reference cycle: dropping
    the server frees the engine (and on the card its memory) at once,
    with the cyclic collector off."""
    args = serve_main.build_parser().parse_args([
        "--vocab-size", "101", "--d-model", "64", "--n-layers", "2",
        "--n-heads", "4", "--n-kv-heads", "2", "--d-ff", "96",
        "--dtype", "float32", "--max-len", "64", "--n-slots", "2",
        "--chunk", "4", "--port", "0", "--seed", "5", "--device", "cpu",
    ])
    gc.collect()
    gc.disable()
    try:
        server = serve_main.start_server(args)
        try:
            status, _ = _post(server.port, {"tokens": [3, 1, 4],
                                            "max_new_tokens": 5})
            assert status == 200
        finally:
            server.stop()
        engine = weakref.ref(server.engine)
        del server
        assert engine() is None
    finally:
        gc.enable()
