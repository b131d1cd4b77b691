"""The port's chunked prefill on the CPU, against the JAX package.

One small Qwen2-style model (q/k/v biases, GQA 4/2, f32) is drawn by the
JAX package and handed to the port with ``from_jax_params``.  A prompt
longer than ``prefill_chunk`` is written in segments, one an admission
wave, while the live slots decode between them:

- the segment size and the decode chunk are invisible: greedy and
  sampled streams are the same at every setting, and greedy ones equal
  the JAX engine's (logprobs within 1e-4, summation order only);
- segments compose with a prefix hit on both layouts, and on the paged
  pool with the copy-on-write of a block the hit ends inside, at depth 1
  and 2, fp and int8 KV; a prompt near ``max_len`` is un-chunked until
  its final window fits;
- a decode chunk writes nothing into a pending prefill's rows (its row
  is not live): the rows its segments wrote are bit-equal when the next
  segment and the final dispatch come;
- cancel, deadline and abort free a pending prefill's slot and blocks,
  ``pending()`` steps it to its end, and ``serve_main --prefix-cache
  --prefill-chunk`` serves ``cache_prefix`` over HTTP.
"""

import json
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oim_tpu.models import TransformerConfig as JaxConfig
from oim_tpu.models import decode as jdecode
from oim_tpu.models import init_params as jax_init_params
from oim_tpu.serve import Engine as JaxEngine
from oim_tpu.serve import GenRequest as JaxRequest

from oim_tpu_torch.cli import serve_main
from oim_tpu_torch.models.transformer import TransformerConfig
from oim_tpu_torch.models.weights import from_jax_params
from oim_tpu_torch.serve.engine import (
    Engine,
    GenRequest,
    RequestFailedError,
)
from torch_cpu_threads import one_torch_thread  # noqa: F401

CFG = dict(
    vocab_size=101, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=96, attn_bias=True, dtype="float32",
)
ENGINE = dict(n_slots=2, max_len=64, chunk=4, prompt_buckets=(8, 16, 32))
LAYOUTS = {"dense": dict(kv_block=0), "paged": dict(kv_block=8)}
LOGPROB_ATOL = 1e-4


@pytest.fixture(scope="module")
def model():
    """(jax cfg, jax params, port cfg, port params) — the same weights,
    with random q/k/v biases."""
    jcfg = JaxConfig(**CFG, use_pallas=False)
    jparams = dict(jax_init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.RandomState(0)
    for name in ("bq", "bk", "bv"):
        jparams[name] = jnp.asarray(
            rng.randn(*jparams[name].shape).astype(np.float32) * 0.1
        )
    tree = {name: np.asarray(value) for name, value in jparams.items()}
    tcfg = TransformerConfig(**CFG)
    return jcfg, jparams, tcfg, from_jax_params(tree, tcfg)


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, CFG["vocab_size"],
                                               n).tolist()


def _oracle(model, tokens, n):
    """The reference's solo greedy continuation."""
    jcfg, jparams, _, _ = model
    out = jdecode.generate(jparams, jnp.asarray([tokens], jnp.int32), jcfg,
                           n)
    return np.asarray(out)[0, len(tokens):].tolist()


def _port_engine(model, **kw):
    _, _, tcfg, params = model
    return Engine(params, tcfg, **{**ENGINE, **kw}, device="cpu")


TRAFFIC = [  # (prompt seed, length, budget, temperature)
    (1, 5, 9, 0.0), (2, 30, 7, 0.0), (3, 20, 6, 0.8), (4, 17, 8, 0.0),
]


def _serve(engine, request_cls):
    rids = [engine.submit(request_cls(
        tokens=_prompt(seed, n), max_new_tokens=m, temperature=temp,
        seed=seed)) for seed, n, m, temp in TRAFFIC]
    engine.run()
    return [engine.result_full(rid) for rid in rids]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_prefill_chunk_and_decode_chunk_invisible(model, layout):
    """Four requests on two slots, two of them longer than a segment:
    every (prefill_chunk, decode chunk) setting gives the same tokens,
    sampled ones included (the noise is keyed by token index), and the
    greedy streams and every logprob equal the JAX engine's."""
    jcfg, jparams, _, _ = model
    outs = {}
    for pc in (0, 8, 16):
        for chunk in (1, 4):
            engine = _port_engine(model, **LAYOUTS[layout], chunk=chunk,
                                  prefill_chunk=pc)
            outs[pc, chunk] = _serve(engine, GenRequest)
            segments = engine.stats()["prefill_segments"]
            want = sum(1 + max(0, -(-n // pc) - 1) if pc else 1
                       for _, n, _, _ in TRAFFIC)
            assert segments == want, (pc, segments, want)
    tokens = {key: [t for t, _ in out] for key, out in outs.items()}
    assert all(t == tokens[0, 4] for t in tokens.values())
    ref = _serve(JaxEngine(jparams, jcfg, **ENGINE, **LAYOUTS[layout],
                           prefill_chunk=8), JaxRequest)
    for i, (_, _, _, temp) in enumerate(TRAFFIC):
        if temp == 0.0:  # threefry's draws differ from the port's keys
            assert outs[8, 4][i][0] == ref[i][0]
            np.testing.assert_allclose(outs[8, 4][i][1], ref[i][1],
                                       atol=LOGPROB_ATOL, rtol=0)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_chunked_prefill_with_prefix_injection(model, layout):
    """A cached prefix shortens the tail and the tail's segments continue
    from the hit's offset: the same tokens as one-shot admission and as
    the JAX engine."""
    jcfg, jparams, _, _ = model
    prefix, long_tail = _prompt(70, 16), _prompt(71, 24)
    kw = {**ENGINE, **LAYOUTS[layout], "max_len": 96,
          "prompt_buckets": (8, 16, 32, 64), "prefix_cache_size": 2}
    outs = []
    for make, request_cls in (
            (lambda pc: _port_engine(model, **kw, prefill_chunk=pc),
             GenRequest),
            (lambda pc: JaxEngine(jparams, jcfg, **kw, prefill_chunk=pc),
             JaxRequest)):
        for pc in ((0, 16) if request_cls is GenRequest else (16,)):
            engine = make(pc)
            engine.submit(request_cls(tokens=prefix, max_new_tokens=2,
                                      cache_prefix=True))
            engine.run()
            rid = engine.submit(request_cls(tokens=prefix + long_tail,
                                            max_new_tokens=6))
            engine.run()
            assert engine.stats()["prefix_hits"] == 1
            outs.append(engine.result(rid))
    assert outs[0] == outs[1] == outs[2]


_REFS: dict = {}


@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp", "kv8"])
@pytest.mark.parametrize("depth", [1, 2])
def test_prefix_cow_hit_with_chunked_tail(model, depth, kv_int8):
    """A 12-token cached prompt on 8-token blocks leaves its entry's
    second block partly covered: a 32-token prompt sharing it copies
    that block first, then writes its 20-token tail in segments from
    the copied frontier.  Tokens equal the JAX engine's (its engines
    shared across depths, as the reference's own test does)."""
    jcfg, jparams, _, _ = model
    kw = dict(n_slots=3, max_len=64, chunk=4, prompt_buckets=(8, 16, 32),
              kv_block=8, kv_blocks=10, prefill_chunk=8,
              prefix_cache_size=2, kv_int8=kv_int8)
    if kv_int8 not in _REFS:
        _REFS[kv_int8] = JaxEngine(jparams, jcfg, **kw)
    ref = _REFS[kv_int8]
    ref.set_pipeline_depth(depth)
    with ref._lock:
        ref._clear_prefix_cache_locked()
    system = _prompt(11, 12)
    hit = system + _prompt(12, 20)
    outs = []
    for engine, request_cls in ((_port_engine(model, **kw,
                                              pipeline_depth=depth),
                                 GenRequest), (ref, JaxRequest)):
        engine.submit(request_cls(tokens=system, max_new_tokens=2,
                                  cache_prefix=True))
        engine.run()
        h0 = engine.stats()["prefix_hits"]
        rid = engine.submit(request_cls(tokens=hit, max_new_tokens=6))
        engine.run()
        assert engine.stats()["prefix_hits"] == h0 + 1
        outs.append(engine.result(rid))
    assert outs[0] == outs[1]


def test_validation(model):
    """The reference's messages for a negative chunk, one past max_len
    and one that is not a prompt bucket."""
    jcfg, jparams, tcfg, params = model
    for chunk in (-1, 4096, 9):
        kw = dict(n_slots=1, max_len=64, prefill_chunk=chunk)
        with pytest.raises(ValueError) as want:
            JaxEngine(jparams, jcfg, **kw)
        with pytest.raises(ValueError) as got:
            Engine(params, tcfg, **kw, device="cpu")
        assert str(got.value) == str(want.value)


def test_near_max_len_boundary(model):
    """A prompt whose final segment's bucketed window would run past the
    region is un-chunked from the back until it fits: the same tokens
    as one-shot admission, and the reference's."""
    for plen in (85, 88, 89):
        prompt = _prompt(80 + plen, plen)
        outs = []
        for pc in (0, 16):
            engine = _port_engine(model, max_len=96, prefill_chunk=pc,
                                  prompt_buckets=None)
            rid = engine.submit(GenRequest(tokens=prompt, max_new_tokens=5))
            engine.run()
            outs.append(engine.result(rid))
        assert outs[0] == outs[1] == _oracle(model, prompt, 5), plen


def _rows(engine, slot, stop):
    """Copies of ``slot``'s K and V rows [0, stop), every layer, through
    its table (dense: its region)."""
    cache = engine._cache
    if not engine.paged:
        return cache.k[:, slot, :stop].clone(), cache.v[:, slot, :stop].clone()
    bs = engine.kv_block
    ids = [int(b) for b in engine._tables_host[slot][: -(-stop // bs)]]
    return tuple(t[:, ids].reshape(t.shape[0], -1, *t.shape[3:])[:, :stop]
                 .clone() for t in (cache.k, cache.v))


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_pending_prefill_rows_survive_decode_chunks(model, layout, depth):
    """A 30-token prompt is admitted in 8-token segments while another
    slot decodes.  The rows each segment wrote are bit-equal when the
    next segment comes and when the prompt's final dispatch seats it:
    the decode chunks between them, in which its row is not live, write
    nothing into its region or blocks."""
    engine = _port_engine(model, **LAYOUTS[layout], prefill_chunk=8,
                          pipeline_depth=depth)
    live = engine.submit(GenRequest(tokens=_prompt(40, 5),
                                    max_new_tokens=30))
    engine.step()  # seated and decoding
    prompt = _prompt(41, 30)
    long_rid = engine.submit(GenRequest(tokens=prompt, max_new_tokens=12))
    written = []
    segment = engine._prefill_segment

    def checked(slot, seg, start):
        if written:
            for a, b in zip(written[-1], _rows(engine, slot, start)):
                assert torch.equal(a, b), "a decode chunk wrote into it"
        segment(slot, seg, start)
        written.append(_rows(engine, slot, start + len(seg)))

    engine._prefill_segment = checked
    interleaved = 0
    for _ in range(10):  # bounded: three segments, then the final one
        before = engine.decode_dispatches
        engine.step()
        interleaved += engine.stats()["prefilling"] > 0 and (
            engine.decode_dispatches > before)
        if any(s.rid == long_rid for s in engine._slots.values()):
            break
    slot = next(s for s, st in engine._slots.items() if st.rid == long_rid)
    for a, b in zip(written[-1], _rows(engine, slot, 24)):
        assert torch.equal(a, b)
    assert len(written) == 3 and interleaved >= 2
    engine.run()
    assert engine.result(long_rid) == _oracle(model, prompt, 12)
    assert engine.result(live) == _oracle(model, _prompt(40, 5), 30)


def _pending_engine(model, layout, **req):
    """An engine with one 30-token prompt pending after its first
    segment (a live slot decoding beside it), and that prompt's rid."""
    engine = _port_engine(model, **LAYOUTS[layout], prefill_chunk=8)
    engine.submit(GenRequest(tokens=_prompt(42, 5), max_new_tokens=20))
    engine.step()
    rid = engine.submit(GenRequest(tokens=_prompt(43, 30), max_new_tokens=4,
                                   **req))
    engine.step()
    assert engine.stats()["prefilling"] == 1
    return engine, rid


@pytest.mark.parametrize("how", ["cancel", "deadline", "abort"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_failed_pending_prefill_frees_slot_and_blocks(model, layout, how):
    """Cancelled, expired or aborted mid-prefill, a pending prompt fails
    with its kind, and its slot and blocks come back: after the run
    every slot is free and no block is held."""
    req = {"deadline": time.monotonic() + 600} if how == "deadline" else {}
    engine, rid = _pending_engine(model, layout, **req)
    if how == "cancel":
        assert engine.cancel(rid)
    elif how == "deadline":
        # Expire it now, mid-prefill, whatever the machine's load.
        engine._prefilling[rid].req.deadline = time.monotonic()
    else:
        engine.abort("stop")
    engine.run()
    with pytest.raises(RequestFailedError) as err:
        engine.result(rid)
    assert err.value.kind == {"cancel": "cancelled", "deadline": "deadline",
                              "abort": "aborted"}[how]
    stats = engine.stats()
    assert stats["prefilling"] == 0 and stats["free_slots"] == 2
    assert stats["kv_blocks_used"] == 0 and not engine._admitting


def test_pending_steps_a_prefill_to_its_end(model):
    """With no live slot, a pending prefill alone keeps ``pending()``
    true, and each step writes one more segment until the prompt is
    seated and served."""
    engine = _port_engine(model, prefill_chunk=8, **LAYOUTS["paged"])
    prompt = _prompt(44, 30)
    rid = engine.submit(GenRequest(tokens=prompt, max_new_tokens=3))
    seen = []
    while engine.pending():
        engine.step()
        seen.append(engine.stats()["prefilling"])
    assert seen[:3] == [1, 1, 1]  # segments 1, 2 and 3
    assert engine.stats()["prefill_segments"] == 4
    assert engine.result(rid) == _oracle(model, prompt, 3)


def _http(port, path, body=None, method=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"},
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_serve_main_prefix_cache_and_prefill_chunk(layout):
    """``serve_main --prefix-cache 2 --prefill-chunk 8`` as a user runs
    it on the CPU: a ``cache_prefix`` request stores its prompt, a later
    prompt sharing it hits and is prefilled in segments, both answer the
    reference's tokens, /v1/info and /v1/stats report the cache and the
    segments, and /v1/kv (prefix export and install) is refused with
    its queue."""
    argv = ["--vocab-size", "101", "--d-model", "64", "--n-layers", "2",
            "--n-heads", "4", "--n-kv-heads", "2", "--d-ff", "96",
            "--attn-bias", "--dtype", "float32", "--max-len", "64",
            "--n-slots", "2", "--chunk", "4", "--port", "0", "--seed", "5",
            "--device", "cpu", "--prefix-cache", "2", "--prefill-chunk",
            "16", "--kv-block", str(LAYOUTS[layout]["kv_block"])]
    server = serve_main.start_server(serve_main.build_parser()
                                     .parse_args(argv))
    try:
        engine = server.engine
        system = _prompt(50, 24)
        hit = system + _prompt(51, 20)
        status, first = _http(server.port, "/v1/generate", {
            "tokens": system, "max_new_tokens": 3, "cache_prefix": True})
        assert status == 200
        status, second = _http(server.port, "/v1/generate", {
            "tokens": hit, "max_new_tokens": 5, "logprobs": True})
        assert status == 200 and len(second["logprobs"]) == 5
        for tokens, reply, n in ((system, first, 3), (hit, second, 5)):
            solo = Engine(engine.params, engine.cfg, n_slots=1, max_len=64,
                          device="cpu")
            rid = solo.submit(GenRequest(tokens=tokens, max_new_tokens=n))
            solo.run()
            assert reply["tokens"] == solo.result(rid)
        stats = _http(server.port, "/v1/stats")[1]
        assert (stats["prefix_hits"], stats["prefix_entries"]) == (1, 1)
        # 24 tokens: 16 + 8; the hit's 20-token tail from 24 (the
        # entry's three full blocks, paged): 16 + 4.
        assert stats["prefill_segments"] == 4
        info = _http(server.port, "/v1/info")[1]["engine"]
        assert (info["prefix_cache_size"], info["prefill_chunk"]) == (2, 16)
        # The KV routes answer as the reference's: an unknown digest is
        # 404 on the paged pool and 409 on the dense cache (it cannot
        # ship), and a PUT whose body is no transfer is 409.
        status, reply = _http(server.port, "/v1/kv?prefix=abc")
        assert status == (404 if engine.paged else 409)
        assert ("no resident prefix" if engine.paged
                else "paged engine") in reply["error"]
        status, reply = _http(server.port, "/v1/kv", {}, method="PUT")
        assert status == 409 and "malformed KV transfer" in reply["error"]
    finally:
        server.stop()
