"""Pipeline depth 2 in the port's serving engine, against depth 1 and the
JAX package's engine.

On the CPU, one small Qwen2-style model (q/k/v biases, GQA 4/2, f32) is
drawn by the JAX package and handed to the port with
``from_jax_params``:

- greedy streams at ``pipeline_depth=2`` are token-identical to depth 1
  on the same engine and to the reference ``Engine`` at depth 2, paged
  and dense, fp and int8 KV, with more requests than slots and a
  mid-stream admission wave landing while a chunk is in flight;
- sampled streams at depth 2 equal the port's solo ``generate``;
- the reference's pipeline cases (``tests/test_serve_pipeline.py``):
  abort and drain with a chunk in flight, no admission while one is in
  flight, validation, tail elision, and the overlap accounting;
- launch counts survive graph replay: a captured region's counts are
  taken back and added per replay (``recording``/``replay_counts``), and
  on the CPU every dispatched pass — a tail chunk dropped unread too —
  ran the plain versions once per layer.

The tests marked ``cuda`` need an NVIDIA GPU and skip without one
(decided inside each test); they import no JAX, so on the GPU machine

    python -m pytest --noconftest tests/test_torch_pipeline.py -q -m cuda

runs them: a decode chunk replayed from its CUDA graph equals the same
chunk run eagerly from copies of one state, bit for bit, and an engine
on graphs serves the streams of an engine on eager dispatch.
"""

import numpy as np
import pytest
import torch

from oim_tpu_torch.models import decode as tdecode
from oim_tpu_torch.models.transformer import TransformerConfig, init_params
from oim_tpu_torch.models.weights import from_jax_params
from oim_tpu_torch.ops import paged_attention as tpa
from oim_tpu_torch.serve.engine import (
    DrainingError,
    Engine,
    GenRequest,
    RequestFailedError,
)

CFG = dict(
    vocab_size=101, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=96, attn_bias=True, dtype="float32",
)
# One prompt bucket keeps the reference's compiles few.
ENGINE = dict(n_slots=3, max_len=64, chunk=4, prompt_buckets=(16,))
LAYOUTS = {"paged": 8, "dense": 0}


@pytest.fixture(scope="module")
def model():
    """(jax cfg, jax params, port cfg, port params) — the same weights,
    with random q/k/v biases.  JAX is imported here, not at the top, so
    that the card tests run where it is not installed."""
    import jax
    import jax.numpy as jnp

    from oim_tpu.models import TransformerConfig as JaxConfig
    from oim_tpu.models import init_params as jax_init_params

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


@pytest.fixture(scope="module")
def engine(model):
    """A dense depth-2 port engine shared by the behaviour cases (each
    leaves it idle; the drain case, terminal, runs last)."""
    _, _, tcfg, params = model
    return Engine(params, tcfg, **ENGINE, device="cpu")


def _prompt(seed: int, n: int) -> list[int]:
    return np.random.RandomState(seed).randint(
        0, CFG["vocab_size"], size=n).tolist()


def _oracle(params, tcfg, tokens, max_new, **kw) -> list[int]:
    out = tdecode.generate(params, torch.tensor([tokens]), tcfg, max_new,
                           **kw)
    return out[0, len(tokens):].tolist()


def _workload(engine, request_cls):
    """More requests than slots, budgets ending mid-chunk, and a second
    wave submitted after two steps, while a chunk is in flight: the
    streams in submission order.  ``engine`` is the port's or the
    reference's (the same submit/step/run surface)."""
    specs = [(_prompt(21, 9), 10), (_prompt(22, 5), 6), (_prompt(23, 12), 9),
             (_prompt(24, 7), 5)]
    rids = [engine.submit(request_cls(tokens=t, max_new_tokens=m))
            for t, m in specs]
    engine.step()
    engine.step()
    late = [(_prompt(25, 6), 7), (_prompt(26, 11), 8)]
    rids += [engine.submit(request_cls(tokens=t, max_new_tokens=m))
             for t, m in late]
    results = engine.run()
    return [results[r] for r in rids]


@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp", "kv8"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_depth2_matches_depth1_and_reference(model, layout, kv_int8):
    """The port at depth 2 == the port at depth 1 (the same engine) ==
    the reference engine at depth 2, token for token."""
    from oim_tpu.serve import Engine as JaxEngine
    from oim_tpu.serve import GenRequest as JaxRequest

    jcfg, jparams, tcfg, params = model
    kw = dict(**ENGINE, kv_block=LAYOUTS[layout], kv_int8=kv_int8)
    engine = Engine(params, tcfg, **kw, device="cpu")
    assert engine.pipeline_depth == 2
    piped = _workload(engine, GenRequest)
    assert engine.stats()["tail_elisions"] > 0  # the pipeline ran
    engine.set_pipeline_depth(1)
    serial = _workload(engine, GenRequest)
    reference = _workload(JaxEngine(jparams, jcfg, **kw, pipeline_depth=2),
                          JaxRequest)
    assert piped == serial == reference
    assert [len(s) for s in piped] == [10, 6, 9, 5, 7, 8]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sampled_depth2_matches_solo_generate(model, layout):
    """Sampled requests (top-p, penalties) on two slots at depth 2, so
    they run in different slots and chained chunks: each equals the
    port's solo ``generate`` at its seed."""
    _, _, tcfg, params = model
    engine = Engine(params, tcfg, **{**ENGINE, "n_slots": 2, "chunk": 3},
                    kv_block=LAYOUTS[layout], device="cpu")
    prompt = _prompt(5, 11)
    kw = dict(temperature=0.9, top_p=0.95, repetition_penalty=1.2)
    seeds = (1, 2, 3)
    rids = [engine.submit(GenRequest(tokens=prompt, max_new_tokens=10,
                                     seed=s, **kw)) for s in seeds]
    engine.run()
    outs = [engine.result(rid) for rid in rids]
    for seed, got in zip(seeds, outs):
        assert got == _oracle(params, tcfg, prompt, 10, seed=seed, **kw)
    assert len({tuple(o) for o in outs}) > 1  # the seed matters


def test_abort_quiesces_inflight_chunk(model, engine):
    """abort() with a chunk in flight drops it unread, fails every
    request with the abort message, leaks no slot, and the engine serves
    exactly afterwards."""
    _, _, tcfg, params = model
    rids = [engine.submit(GenRequest(tokens=_prompt(80 + i, 5),
                                     max_new_tokens=12)) for i in range(2)]
    engine.step()
    assert engine.stats()["inflight_dispatches"] == 1
    engine.abort("test abort")
    assert engine.stats()["inflight_dispatches"] == 0
    for rid in rids:
        with pytest.raises(RequestFailedError, match="test abort"):
            engine.result(rid, timeout=0)
    assert engine.in_flight() == 0
    assert engine.stats()["free_slots"] == 3
    tokens = _prompt(85, 6)
    rid = engine.submit(GenRequest(tokens=tokens, max_new_tokens=5))
    assert engine.run()[rid] == _oracle(params, tcfg, tokens, 5)
    engine.result(rid, timeout=0)


def test_overlap_and_idle_accounting(engine):
    """A serial phase accrues no overlap and some device idle; the same
    engine back at depth 2 accrues overlapped readback."""
    engine.set_pipeline_depth(1)
    before = engine.stats()
    rid = engine.submit(GenRequest(tokens=_prompt(95, 6), max_new_tokens=16))
    engine.run()
    st = engine.stats()
    assert st["overlap_seconds"] == before["overlap_seconds"]
    assert st["device_idle_seconds"] > before["device_idle_seconds"]
    assert st["pipeline_depth"] == 1
    assert st["dispatch_seconds"] > 0.0
    assert st["readback_seconds"] > before["readback_seconds"]
    engine.set_pipeline_depth(2)
    rid2 = engine.submit(GenRequest(tokens=_prompt(96, 6),
                                    max_new_tokens=16))
    results = engine.run()
    st2 = engine.stats()
    assert st2["overlap_seconds"] > st["overlap_seconds"]
    assert 0.0 < st2["overlap_ratio"] <= 1.0
    assert st2["pipeline_depth"] == 2
    assert len(results[rid]) == 16 and len(results[rid2]) == 16
    engine.result(rid, timeout=0)
    engine.result(rid2, timeout=0)


def test_no_admission_while_chunk_in_flight(engine):
    """The boundary rule inside ``_admit_wave``: called with a chunk in
    flight (the interleaving where a submit lands after the step's
    boundary check), it admits nothing; the next boundary admits, and
    the streams equal the serial engine's."""
    rid_a = engine.submit(GenRequest(tokens=_prompt(97, 6),
                                     max_new_tokens=12))
    engine.step()  # admit A, dispatch a chunk, keep it in flight
    assert engine.in_flight() == 1
    rid_b = engine.submit(GenRequest(tokens=_prompt(98, 7),
                                     max_new_tokens=8))
    before = engine.stats()
    engine._admit_wave()
    st = engine.stats()
    assert st["queued"] == before["queued"] == 1
    assert st["active_slots"] == before["active_slots"]
    results = engine.run()
    engine.set_pipeline_depth(1)
    rid_a2 = engine.submit(GenRequest(tokens=_prompt(97, 6),
                                      max_new_tokens=12))
    rid_b2 = engine.submit(GenRequest(tokens=_prompt(98, 7),
                                      max_new_tokens=8))
    serial = engine.run()
    engine.set_pipeline_depth(2)
    assert results[rid_a] == serial[rid_a2]
    assert results[rid_b] == serial[rid_b2]
    for rid in (rid_a, rid_b, rid_a2, rid_b2):
        engine.result(rid, timeout=0)


def test_pipeline_depth_validation(model, engine):
    _, _, tcfg, params = model
    with pytest.raises(ValueError, match="pipeline_depth"):
        Engine(params, tcfg, n_slots=1, max_len=16, pipeline_depth=3,
               device="cpu")
    with pytest.raises(ValueError, match="pipeline_depth"):
        engine.set_pipeline_depth(0)
    assert engine.info()["engine"]["pipeline_depth"] == 2
    rid = engine.submit(GenRequest(tokens=[1, 2, 3], max_new_tokens=12))
    engine.step()  # a chunk in flight
    with pytest.raises(RuntimeError, match="idle engine"):
        engine.set_pipeline_depth(1)
    engine.run()
    engine.result(rid, timeout=0)


def test_tail_elision_skips_guaranteed_waste(engine):
    """When the chunk in flight covers every slot's remaining budget, the
    chained dispatch is skipped: the same dispatches as the serial
    engine, one elision counted, the same output."""
    tokens = _prompt(110, 6)
    engine.set_pipeline_depth(1)
    before = engine.stats()
    rid_s = engine.submit(GenRequest(tokens=tokens, max_new_tokens=6))
    serial = engine.run()[rid_s]
    mid = engine.stats()
    assert mid["tail_elisions"] == before["tail_elisions"]
    serial_dispatches = mid["decode_dispatches"] - before["decode_dispatches"]
    engine.set_pipeline_depth(2)
    rid_p = engine.submit(GenRequest(tokens=tokens, max_new_tokens=6))
    piped = engine.run()[rid_p]
    st = engine.stats()
    assert piped == serial
    assert st["tail_elisions"] == mid["tail_elisions"] + 1
    assert st["decode_dispatches"] - mid["decode_dispatches"] == (
        serial_dispatches)
    engine.result(rid_s, timeout=0)
    engine.result(rid_p, timeout=0)


def test_dropped_tail_chunk_is_counted(model):
    """An EOS in the first chunk finishes the only request while the
    chained chunk is in flight: that chunk is dropped unread, yet its
    passes count — every dispatched pass ran the plain versions once per
    layer on the CPU."""
    _, _, tcfg, params = model
    tokens = _prompt(121, 7)
    oracle = _oracle(params, tcfg, tokens, 4)
    eos = oracle[2]
    assert oracle.index(eos) == 2  # first emitted by the first chunk
    engine = Engine(params, tcfg, **ENGINE, device="cpu")
    tpa.reset_counters()
    rid = engine.submit(GenRequest(tokens=tokens, max_new_tokens=30,
                                   eos_id=eos))
    engine.run()
    got = engine.result(rid)
    assert got == oracle[:3]
    st = engine.stats()
    assert st["decode_dispatches"] == st["readbacks"] + 1  # one dropped
    assert st["inflight_dispatches"] == 0
    passes = st["prefill_dispatches"] + st["decode_passes"]
    counts = tpa.counters()
    assert counts["paged_flash_decode_plain"] == CFG["n_layers"] * passes
    assert counts["paged_kv_store_plain"] == CFG["n_layers"] * passes
    assert counts["paged_flash_decode"] == counts["paged_kv_store"] == 0


def test_recording_keeps_a_regions_counts_for_replay():
    """A stub region standing for a capture: its counts are taken back
    (a capture launches nothing) and kept; each replay adds them again;
    a plain call inside a region raises."""
    tpa.reset_counters()
    tpa.paged_kv_store.launches += 1  # a launch before the region
    with tpa.recording() as delta:
        tpa.paged_flash_decode.launches += 2
        tpa.ROUTE_LAUNCHES["rows8"] += 2
        tpa.paged_kv_store.launches += 2
        tpa.paged_kv_store.decode_launches += 2
    assert delta == {**{name: 0 for name in tpa.counters()},
                     "paged_flash_decode": 2, "paged_flash_decode_rows8": 2,
                     "paged_kv_store": 2, "paged_kv_store_t1": 2}
    assert tpa.counters() == {**{name: 0 for name in tpa.counters()},
                              "paged_kv_store": 1}
    for _ in range(3):
        tpa.replay_counts(delta)
    counts = tpa.counters()
    assert counts["paged_flash_decode"] == counts[
        "paged_flash_decode_rows8"] == 6
    assert counts["paged_kv_store"] == 7 and counts["paged_kv_store_t1"] == 6
    with pytest.raises(RuntimeError, match="plain versions ran"):
        with tpa.recording():
            tpa.paged_kv_store_plain.calls += 1
    tpa.reset_counters()
    assert not any(tpa.counters().values())


def test_drain_completes_inflight_chunk(model, engine):
    """drain() with a chunk in flight: the chunk completes, nothing past
    EOS is emitted, no slot leaks.  Last among the shared engine's cases:
    draining is terminal."""
    _, _, tcfg, params = model
    tokens = _prompt(70, 6)
    oracle = _oracle(params, tcfg, tokens, 12)
    eos = oracle[4]  # mid-chunk, with a chained chunk past it
    rid = engine.submit(GenRequest(tokens=tokens, max_new_tokens=12,
                                   eos_id=eos))
    engine.step()
    assert engine.stats()["inflight_dispatches"] == 1
    engine.drain()
    with pytest.raises(DrainingError):
        engine.submit(GenRequest(tokens=tokens, max_new_tokens=1))
    while engine.pending():
        engine.step()
    got = engine.result(rid, timeout=0)
    assert got == oracle[: oracle.index(eos) + 1] and got[-1] == eos
    assert engine.in_flight() == 0
    st = engine.stats()
    assert st["active_slots"] == 0 and st["free_slots"] == 3
    assert st["inflight_dispatches"] == 0


# ---------------------------------------------------------------------------
# On the card

# bf16 at head_dim 64, the narrowest the kernels take.
CARD_CFG = dict(vocab_size=512, d_model=256, n_layers=2, n_heads=4,
                n_kv_heads=2, d_ff=512, attn_bias=True, dtype="bfloat16")
CARD_ENGINE = dict(n_slots=4, max_len=128, chunk=4, prompt_buckets=(16, 64))


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the kernels)")


def _card_requests():
    """Greedy and sampled rows, one truncating by top-p, one penalised."""
    return [
        GenRequest(tokens=_prompt(200, 9), max_new_tokens=20),
        GenRequest(tokens=_prompt(201, 40), max_new_tokens=17,
                   temperature=0.8, seed=3, top_p=0.9),
        GenRequest(tokens=_prompt(202, 13), max_new_tokens=23,
                   repetition_penalty=1.3),
        GenRequest(tokens=_prompt(203, 60), max_new_tokens=12,
                   temperature=1.1, seed=4),
        GenRequest(tokens=_prompt(204, 5), max_new_tokens=9),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16", "kv8"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_graph_chunk_equals_eager_chunk(layout, kv_int8):
    """One decode chunk, from copies of one state, run eagerly and by its
    graph's replay: tokens, logprobs, the token carry, the cache and the
    penalty counts bit-equal (the same kernels on the same inputs)."""
    _need_gpu()
    cfg = TransformerConfig(**CARD_CFG)
    engine = Engine(init_params(0, cfg), cfg, **CARD_ENGINE,
                    kv_block=LAYOUTS[layout] * 2, kv_int8=kv_int8).warmup()
    engine.set_pipeline_depth(1)
    for req in _card_requests()[:4]:
        engine.submit(req)
    engine.step()  # admit all four and decode one chunk
    eager, replayed = engine.chunk_twice()
    for name in ("out", "lps", "carry"):
        assert torch.equal(eager[name], replayed[name]), name
    for a, b in zip(eager["state"], replayed["state"]):
        assert torch.equal(a, b)
    engine.abort("done")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_moe_graph_chunk_equals_eager_chunk(layout):
    """An MoE decode chunk (drop-free routing over every expert: f32
    router, a stable sort for the top-k, no data-dependent shape)
    captures as one graph, and its replay is bit-equal to the eager
    chunk from a copy of the same state."""
    _need_gpu()
    cfg = TransformerConfig(**{**CARD_CFG, "n_experts": 4, "moe_top_k": 2})
    engine = Engine(init_params(0, cfg), cfg, **CARD_ENGINE,
                    kv_block=LAYOUTS[layout] * 2).warmup()
    engine.set_pipeline_depth(1)
    for req in _card_requests()[:4]:
        engine.submit(req)
    engine.step()
    eager, replayed = engine.chunk_twice()
    for name in ("out", "lps", "carry"):
        assert torch.equal(eager[name], replayed[name]), name
    for a, b in zip(eager["state"], replayed["state"]):
        assert torch.equal(a, b)
    engine.abort("done")


@pytest.mark.cuda
def test_graph_engine_serves_the_eager_engines_streams():
    """The default engine (dense, depth 2, graphs) and one dispatching
    the same chunks eagerly serve the same streams; every decode
    dispatch was one replay, and K1's decode route and K2 at t = 1
    launched once per layer per dispatched pass, with no plain call."""
    _need_gpu()
    cfg = TransformerConfig(**CARD_CFG)
    params = init_params(0, cfg)
    streams = []
    for graphs in (True, False):
        engine = Engine(params, cfg, **CARD_ENGINE,
                        cuda_graphs=graphs).warmup()
        tpa.reset_counters()
        rids = [engine.submit(req) for req in _card_requests()]
        engine.run()
        streams.append([engine.result(rid) for rid in rids])
        st = engine.stats()
        counts = tpa.counters()
        assert st["graph_replays"] == (st["decode_dispatches"] if graphs
                                       else 0)
        assert counts["paged_flash_decode_rows8"] == counts[
            "paged_kv_store_t1"] == cfg.n_layers * st["decode_passes"]
        assert counts["paged_flash_decode_tc"] == (
            cfg.n_layers * st["prefill_dispatches"])
        assert counts["paged_flash_decode_plain"] == 0
        assert counts["paged_kv_store_plain"] == 0
    assert streams[0] == streams[1]
