"""The port's admission as the CUDA graphs replay it, run eagerly on the
CPU against the JAX package.

One small Qwen2-style model (q/k/v biases, GQA 4/2, f32) is drawn by the
JAX package and handed to the port with ``from_jax_params``.  Admission
runs over static buffers (``Engine._run_admission``): a group sharing a
prompt bucket is padded to a row class with inert rows and split past
the token cap, and a chunked prefill's segment is one dispatch of the
(``prefill_chunk``, 1) class.  On the CPU the same padded shapes run
eagerly, so here:

- admission equals the JAX engine's on both layouts — greedy tokens
  identical, logprobs within 1e-4, and every dispatch's first-token
  logits within 1e-4 of the JAX model's at the prompt's last position —
  across a group padded from 3 rows to 4, prefix hits at a nonzero start
  (paged: one a copy-on-write) and a prompt written in segments;
- padding rows write no KV: every other slot's rows (dense) and every
  block outside the group's tables (paged) keep their digest;
- the token cap splits a group without changing its tokens.

The tests marked ``cuda`` need an NVIDIA GPU and skip without one; they
import no JAX, so on the GPU machine

    python -m pytest --noconftest tests/test_torch_admit_graph.py -q -m cuda

runs them: an admission wave replayed from its graphs is bit-equal to
the same wave run eagerly from the same state, a prefix hit with a
copy-on-write and a segment included, and no graph is captured after
warmup.
"""

import hashlib

import numpy as np
import pytest
import torch

from oim_tpu_torch.models.transformer import TransformerConfig, init_params
from oim_tpu_torch.serve import engine as engine_mod
from oim_tpu_torch.serve.engine import Engine, GenRequest
from torch_cpu_threads import one_torch_thread  # noqa: F401

CFG = dict(
    vocab_size=101, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=96, attn_bias=True, dtype="float32",
)
# Four slots, so that a three-row group pads to the four-row class.
ENGINE = dict(n_slots=4, max_len=64, chunk=4, prompt_buckets=(8, 16, 32))
LAYOUTS = {"dense": dict(kv_block=0), "paged": dict(kv_block=8)}
LOGPROB_ATOL = 1e-4
LOGITS_ATOL = 1e-4


@pytest.fixture(scope="module")
def model():
    """(jax cfg, jax params, port cfg, port params) — the same weights,
    with random q/k/v biases.  JAX is imported here, not at the top, so
    that the card tests run where it is not installed."""
    import jax
    import jax.numpy as jnp

    from oim_tpu.models import TransformerConfig as JaxConfig
    from oim_tpu.models import init_params as jax_init_params
    from oim_tpu_torch.models.weights import from_jax_params

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


def _record_dispatches(engine) -> list:
    """Wrap ``engine._run_admission``: each dispatch appends (bucket,
    rows, prompts, meta, tables, logits) as it left the static
    buffers."""
    seen = []
    run = engine._run_admission

    def recorded(bucket, rows):
        run(bucket, rows)
        views = engine._adm.views(bucket, rows)
        seen.append((bucket, rows, *(v.clone() for v in views),
                     engine._adm.logits[:rows].clone()))

    engine._run_admission = recorded
    return seen


# The seed is 16 tokens, two full blocks of 8, written in two segments:
# sent again it hits 15 rows, inside the entry's second block (a
# copy-on-write on the paged pool); with five more tokens it hits all
# 16.  Segments are 8 tokens, the smallest bucket.
SEED = _prompt(70, 16)
WAVES = [
    [dict(tokens=SEED, max_new_tokens=3, cache_prefix=True)],
    # Three prompts of bucket 8: one group, padded to four rows.
    [dict(tokens=_prompt(71, 3), max_new_tokens=5),
     dict(tokens=_prompt(72, 5), max_new_tokens=6),
     dict(tokens=_prompt(73, 7), max_new_tokens=4)],
    # Both hits, and a 30-token miss written in three segments before its
    # 6-token tail.
    [dict(tokens=list(SEED), max_new_tokens=5),
     dict(tokens=SEED + _prompt(74, 5), max_new_tokens=6),
     dict(tokens=_prompt(75, 30), max_new_tokens=5)],
]


def _serve(engine, request_cls) -> list:
    out = []
    for wave in WAVES:
        rids = [engine.submit(request_cls(**r)) for r in wave]
        engine.run()
        out += [engine.result_full(rid) for rid in rids]
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_admission_matches_jax(model, layout):
    """The traffic through the JAX engine and the port's: tokens and
    logprobs as the reference's, hits and segments counted as its; the
    three-row group ran as one four-row dispatch whose padding row has
    tail 1 and the sentinel table row; each segment was one dispatch of
    the (8, 1) class (``prefill_chunk``, 1); and each dispatch's first-token logits are the JAX
    model's at its prompt's last position."""
    import jax.numpy as jnp

    from oim_tpu.models import decode as jdecode
    from oim_tpu.serve import Engine as JaxEngine
    from oim_tpu.serve import GenRequest as JaxRequest

    jcfg, jparams, tcfg, params = model
    kw = dict(**ENGINE, **LAYOUTS[layout], prefix_cache_size=2,
              prefill_chunk=8)
    engine = Engine(params, tcfg, **kw, device="cpu")
    seen = _record_dispatches(engine)
    got = _serve(engine, GenRequest)
    ref_engine = JaxEngine(jparams, jcfg, **kw)
    want = _serve(ref_engine, JaxRequest)
    for (g_toks, g_lps), (w_toks, w_lps) in zip(got, want):
        assert g_toks == w_toks
        np.testing.assert_allclose(g_lps, w_lps, atol=LOGPROB_ATOL, rtol=0)
    st, ref_st = engine.stats(), ref_engine.stats()
    for key in ("prefix_hits", "prefix_misses", "prefill_segments"):
        assert st[key] == ref_st[key], key
    assert st["prefix_hits"] == 2 and st["prefill_segments"] == 11

    sentinel = engine._sentinel
    padded = [d for d in seen if d[:2] == (8, 4)]
    assert len(padded) == 1
    _, _, _, meta, tables, _ = padded[0]
    assert meta[1].tolist() == [3, 5, 7, 1] and meta[0, 3] == 0
    assert (tables[3] == sentinel).all() and (tables[:3, 0] < sentinel).all()
    # Full 8-token windows through the (8, 1) class: the seed's segment and
    # its final tail, then the miss's three segments.
    windows = [d for d in seen if d[:2] == (8, 1) and d[3][1, 0] == 8]
    assert [int(d[3][0, 0]) for d in windows] == [0, 8, 0, 8, 16]

    prompts = [r["tokens"] for wave in WAVES for r in wave]
    checked = 0
    for bucket, rows, staged, meta, _, logits in seen:
        for i in range(rows):
            start, tail = int(meta[0, i]), int(meta[1, i])
            full = [p for p in prompts if len(p) == start + tail
                    and p[start:] == staged[i, :tail].tolist()]
            if not full:
                continue  # a padding row, or a non-final segment
            ref, _ = jdecode.prefill(jparams, jnp.asarray([full[0]],
                                                          jnp.int32),
                                     jcfg, ENGINE["max_len"])
            np.testing.assert_allclose(logits[i].numpy(),
                                       np.asarray(ref)[0, -1],
                                       atol=LOGITS_ATOL, rtol=0)
            checked += 1
    assert checked == len(prompts)  # every first token's dispatch


def _digest(t) -> str:
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_padding_rows_write_no_kv(model, layout):
    """A three-row group dispatched as four rows over a cache full of
    noise: the fourth slot's rows and the admitted slots' rows past the
    bucket (dense), or every block outside the three table rows (paged),
    keep their digest."""
    _, _, tcfg, params = model
    engine = Engine(params, tcfg, **ENGINE, **LAYOUTS[layout], device="cpu")
    gen = torch.Generator().manual_seed(0)
    for t in (engine._cache.k, engine._cache.v):
        t.copy_(torch.randn(t.shape, generator=gen))
    before = [engine._cache.k.clone(), engine._cache.v.clone()]
    for seed, n in ((81, 9), (82, 12), (83, 14)):
        engine.submit(GenRequest(tokens=_prompt(seed, n), max_new_tokens=4))
    seen = _record_dispatches(engine)
    engine._admit_wave()  # seats the three, decodes nothing
    assert [d[:2] for d in seen] == [(16, 4)]
    if engine.paged:
        owned = set(engine._tables_host[:3].ravel().tolist())
        others = [b for b in range(engine.kv_blocks) if b not in owned]

        def untouched(t):
            return t[:, others]
    else:
        def untouched(t):
            return torch.cat([t[:, 3].flatten(), t[:, :3, 16:].flatten()])
    after = [engine._cache.k, engine._cache.v]
    assert ([_digest(untouched(t)) for t in after]
            == [_digest(untouched(t)) for t in before])
    engine.abort("done")


def test_token_cap_splits_without_changing_results(model, monkeypatch):
    """Four prompts of bucket 16 run as one four-row dispatch under the
    default cap and as two two-row dispatches under a cap of 32 tokens,
    with the same tokens and logprobs; a bucket over the cap runs one
    row a dispatch."""
    _, _, tcfg, params = model
    reqs = [dict(tokens=_prompt(90 + i, 10 + i), max_new_tokens=5)
            for i in range(4)]
    out, dispatches = [], []
    for cap in (engine_mod.ADMIT_TOKENS, 32):
        monkeypatch.setattr(engine_mod, "ADMIT_TOKENS", cap)
        engine = Engine(params, tcfg, **ENGINE, device="cpu")
        seen = _record_dispatches(engine)
        rids = [engine.submit(GenRequest(**r)) for r in reqs]
        engine.run()
        out.append([engine.result_full(rid) for rid in rids])
        dispatches.append([d[:2] for d in seen])
        assert engine.stats()["prefill_dispatches"] == len(seen)
    assert dispatches == [[(16, 4)], [(16, 2), (16, 2)]]
    for (a_toks, a_lps), (b_toks, b_lps) in zip(*out):
        assert a_toks == b_toks
        np.testing.assert_allclose(a_lps, b_lps, atol=1e-5, rtol=0)
    monkeypatch.setattr(engine_mod, "ADMIT_TOKENS", 20)
    capped = Engine(params, tcfg, **ENGINE, device="cpu")
    assert capped._admit_classes == {8: (1, 2), 16: (1,), 32: (1,)}
    assert capped._pieces(3, 16) == [(1, 1)] * 3
    assert capped._pieces(3, 8) == [(2, 2), (1, 1)]
    monkeypatch.undo()
    assert Engine(params, tcfg, **ENGINE, device="cpu")._pieces(3, 32) == [
        (3, 4)]


# ---------------------------------------------------------------------------
# On the card

# bf16 at head_dim 64, the narrowest the kernels take.
CARD_CFG = dict(vocab_size=512, d_model=256, n_layers=2, n_heads=4,
                n_kv_heads=2, d_ff=512, attn_bias=True, dtype="bfloat16")
CARD_ENGINE = dict(n_slots=4, max_len=128, chunk=4, prompt_buckets=(16, 64))


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the kernels)")


def _same(runs) -> dict:
    eager, replayed = runs
    return {"first": eager["first"] == replayed["first"],
            "pending": eager["pending"] == replayed["pending"],
            "state": all(torch.equal(a, b) for a, b in
                         zip(eager["state"], replayed["state"]))}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_admit_twice_is_bit_equal(layout):
    """Two admission waves, each run eagerly and by graph replays from
    copies of one state: first tokens and logprobs, the pending
    prefills, the cache and the penalty counts bit-equal.  The second
    wave holds a prefix hit inside the entry's last block (paged: a
    copy-on-write), a padded group and a prompt that writes its first
    segment.  After warmup no graph is captured, every admission
    dispatch is a replay, and a row class with no graph raises."""
    _need_gpu()
    cfg = TransformerConfig(**CARD_CFG)
    engine = Engine(init_params(0, cfg), cfg, **CARD_ENGINE,
                    kv_block=LAYOUTS[layout]["kv_block"] * 2,
                    prefix_cache_size=2, prefill_chunk=16).warmup()
    graphs = engine.stats()["admission_graphs"]
    assert graphs == sum(len(c) for c in engine._admit_classes.values())
    engine.set_pipeline_depth(1)
    rng = np.random.RandomState(3)
    system = rng.randint(0, 512, 32).tolist()
    engine.submit(GenRequest(tokens=system, max_new_tokens=2,
                             cache_prefix=True))
    runs = engine.admit_twice()
    assert all(_same(runs).values()), _same(runs)
    engine.run()
    for n in (9, 12):
        engine.submit(GenRequest(tokens=rng.randint(0, 512, n).tolist(),
                                 max_new_tokens=8, repetition_penalty=1.2))
    engine.submit(GenRequest(tokens=list(system), max_new_tokens=8,
                             temperature=0.8, seed=2))
    engine.submit(GenRequest(tokens=rng.randint(0, 512, 40).tolist(),
                             max_new_tokens=4))
    runs = engine.admit_twice()
    assert all(_same(runs).values()), _same(runs)
    assert len(runs[1]["first"]) == 3 and len(runs[1]["pending"]) == 1
    engine.run()
    before = engine.stats()
    engine.submit(GenRequest(tokens=rng.randint(0, 512, 60).tolist(),
                             max_new_tokens=4))
    engine.run()
    st = engine.stats()
    delta = {k: st[k] - before[k] for k in (
        "admission_replays", "prefill_dispatches", "prefill_segments")}
    assert delta == {"admission_replays": 4, "prefill_dispatches": 1,
                     "prefill_segments": 4}
    assert st["admission_graphs"] == graphs
    with pytest.raises(RuntimeError, match="no admission graph"):
        engine._dispatch_admission(16, 3, *engine._admission_inputs(
            16, 3, []))
