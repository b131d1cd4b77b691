"""The port's speculative decoding on the CPU, against the JAX package.

One small Qwen2-style model (q/k/v biases, GQA 4/2, f32) is drawn by the
JAX package and handed to the port with ``from_jax_params``; a draft
model (1 layer, 32 wide, its own geometry) likewise.  The same traffic —
greedy prompts whose continuations fall into cycles that prompt lookup
catches, and a sampled row — goes through a JAX ``oim_tpu`` engine and
the port's engine built with the same speculative settings (prompt
lookup at spec 2 and 4, the draft model; dense and paged; depth 1 and 2;
int8 KV): greedy tokens are identical and so are the drafted and
accepted counts.  Every stream, sampled ones included, is also the
port's plain engine's, token for token, with logprobs within 1e-4 (both
compute in f32 and differ in summation order only).  ``_draft_lookup``
is bit-equal to the reference's on random histories and its edge cases,
the solo ``make_speculative_fn`` to the reference's and to ``generate``,
and a draft that is the target accepts above the reference's 0.8 bar.
The card's test of a speculative chunk (eager against its graph replay,
bit-equal) lives in ``tests/test_torch_pipeline.py``, which imports no
JAX at the top.
"""

import json
import urllib.error
import urllib.request
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oim_tpu.models import TransformerConfig as JaxConfig
from oim_tpu.models import init_params as jax_init_params
from oim_tpu.models.speculative import make_speculative_fn as jax_spec_fn
from oim_tpu.serve import Engine as JaxEngine
from oim_tpu.serve import GenRequest as JaxRequest
from oim_tpu.serve.engine import _draft_lookup as jax_draft_lookup

from oim_tpu_torch.checkpoint import Checkpointer, CheckpointerOptions
from oim_tpu_torch.cli import serve_main
from oim_tpu_torch.models import decode as tdecode
from oim_tpu_torch.models.speculative import make_speculative_fn
from oim_tpu_torch.models.transformer import TransformerConfig, init_params
from oim_tpu_torch.models.weights import from_jax_params
from oim_tpu_torch.serve.engine import Engine, GenRequest, _draft_lookup
from torch_cpu_threads import one_torch_thread  # noqa: F401

CFG = dict(
    vocab_size=101, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=96, attn_bias=True, dtype="float32",
)
DRAFT = dict(vocab_size=101, d_model=32, n_layers=1, n_heads=2, d_ff=32,
             dtype="float32")
ENGINE = dict(n_slots=2, max_len=64, chunk=4, prompt_buckets=(16, 32))
LOGPROB_ATOL = 1e-4


def _port(jcfg_kw: dict, seed: int):
    """(jax cfg, jax params, port cfg, port params), with random q/k/v
    biases when the config has them."""
    jcfg = JaxConfig(**jcfg_kw, use_pallas=False)
    jparams = dict(jax_init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.RandomState(seed)
    for name in ("bq", "bk", "bv"):
        if name in jparams:
            jparams[name] = jnp.asarray(
                rng.randn(*jparams[name].shape).astype(np.float32) * 0.1
            )
    tree = {name: np.asarray(value) for name, value in jparams.items()}
    tcfg = TransformerConfig(**jcfg_kw)
    return jcfg, jparams, tcfg, from_jax_params(tree, tcfg)


@pytest.fixture(scope="module")
def model():
    return _port(CFG, 0)


@pytest.fixture(scope="module")
def draft():
    return _port(DRAFT, 7)


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, CFG["vocab_size"],
                                               n).tolist()


def _traffic():
    """Five greedy prompts of 8 to 20 tokens (whose 24-token greedy
    continuations repeat, so that prompt lookup drafts and accepts) and
    one sampled row."""
    reqs = [dict(tokens=_prompt(s, 5 + 3 * s), max_new_tokens=24)
            for s in range(1, 6)]
    reqs.append(dict(tokens=_prompt(9, 11), max_new_tokens=10,
                     temperature=0.8, seed=3))
    return reqs


def _serve(engine, request_cls, reqs):
    rids = [engine.submit(request_cls(**r)) for r in reqs]
    engine.run()
    return [engine.result_full(rid) for rid in rids], engine.stats()


_PLAIN = {}


def _plain(model, kv_int8: bool):
    """The port's plain engine on ``_traffic`` (computed once a KV
    precision)."""
    if kv_int8 not in _PLAIN:
        _, _, tcfg, params = model
        _PLAIN[kv_int8] = _serve(
            Engine(params, tcfg, **ENGINE, kv_int8=kv_int8, device="cpu"),
            GenRequest, _traffic())[0]
    return _PLAIN[kv_int8]


# Each case's engine settings, and whether the JAX engine runs it too
# (the one case without it differs from the others in no code path the
# reference's engine has: it holds the port to its plain engine only).
SPEC_CASES = {
    "lookup2-dense-d2": (dict(spec_decode=2), True),
    "lookup4-paged-d1-kv8": (dict(spec_decode=4, kv_block=8,
                                  pipeline_depth=1, kv_int8=True), True),
    "draft2-paged-d2": (dict(spec_decode=2, kv_block=8, draft=True), True),
    "draft3-dense-d1-kv8": (dict(spec_decode=3, pipeline_depth=1,
                                 kv_int8=True, draft=True), False),
}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_spec_engine_matches_reference_and_plain(model, draft, case):
    """Greedy tokens and the drafted/accepted counts equal the JAX
    engine's with the same speculative settings; every stream (the
    sampled one too) is the port's plain engine's, logprobs within
    LOGPROB_ATOL."""
    jcfg, jparams, tcfg, params = model
    kw, against_jax = SPEC_CASES[case]
    kw = dict(kw)
    port_kw, jax_kw = dict(kw), dict(kw)
    if kw.pop("draft", False):
        djcfg, djparams, dtcfg, dparams = draft
        port_kw.update(draft_params=dparams, draft_cfg=dtcfg)
        jax_kw.update(draft_params=djparams, draft_cfg=djcfg)
        del port_kw["draft"], jax_kw["draft"]
    reqs = _traffic()
    got, stats = _serve(Engine(params, tcfg, **ENGINE, **port_kw,
                               device="cpu"), GenRequest, reqs)
    assert stats["spec_drafted"] > 0
    if against_jax:
        want, jstats = _serve(JaxEngine(jparams, jcfg, **ENGINE, **jax_kw),
                              JaxRequest, reqs)
        greedy = [i for i, r in enumerate(reqs) if not r.get("temperature")]
        assert [got[i][0] for i in greedy] == [want[i][0] for i in greedy]
        for key in ("spec_drafted", "spec_accepted"):
            assert stats[key] == jstats[key], key
    plain = _plain(model, kw.get("kv_int8", False))
    assert [t for t, _ in got] == [t for t, _ in plain]
    for (_, lp), (_, plp) in zip(got, plain):
        np.testing.assert_allclose(lp, plp, atol=LOGPROB_ATOL, rtol=0)
    for (toks, _), r in zip(got, reqs):
        assert len(toks) == r["max_new_tokens"]


def test_lookup_accepts_on_cycles(model):
    """Prompt lookup pays on this traffic: the greedy continuations
    repeat, and the accepted drafts show as fewer decode dispatches than
    a plain engine's for the same tokens."""
    _, _, tcfg, params = model
    reqs = _traffic()[:5]
    runs = [_serve(Engine(params, tcfg, **ENGINE, spec_decode=spec,
                          device="cpu"), GenRequest, reqs)
            for spec in (0, 4)]
    assert [t for t, _ in runs[0][0]] == [t for t, _ in runs[1][0]]
    assert runs[1][1]["spec_accepted"] > 0
    assert (runs[1][1]["decode_dispatches"]
            < runs[0][1]["decode_dispatches"])


def test_self_draft_acceptance(model):
    """A draft that is the target accepts essentially every draft (the
    reference's bar: above 0.8; below 1 only by the drafts of sub-steps
    past a request's budget), on prompts that do not echo."""
    _, _, tcfg, params = model
    engine = Engine(params, tcfg, n_slots=1, max_len=96, chunk=4,
                    spec_decode=4, draft_params=params, draft_cfg=tcfg,
                    device="cpu")
    engine.submit(GenRequest(tokens=_prompt(90, 16), max_new_tokens=32,
                             eos_id=-1))
    engine.run()
    stats = engine.stats()
    assert stats["spec_drafted"] > 0
    assert stats["spec_accepted"] / stats["spec_drafted"] > 0.8, stats
    assert stats["draft_passes"] == 5 * stats["decode_passes"]
    assert stats["draft_prefill_dispatches"] == 1


@pytest.mark.parametrize("source", ["lookup", "draft"])
def test_spec_with_prefix_cache_and_chunked_prefill(model, draft, source):
    """Speculation composes with the prefix cache (a hit injects target
    rows only: the history gets the whole prompt, the draft prefills it
    from position 0) and with chunked prefill: the streams are the plain
    engine's with the same cache settings, on both layouts."""
    _, _, tcfg, params = model
    kw = dict(prefix_cache_size=2, prefill_chunk=16)
    if source == "draft":
        kw.update(draft_params=draft[3], draft_cfg=draft[2])
    system = _prompt(71, 16)
    phases = [[dict(tokens=system, max_new_tokens=3, cache_prefix=True)],
              [dict(tokens=system + _prompt(80 + i, 4 + 4 * i),
                    max_new_tokens=10) for i in range(3)]
              + [dict(tokens=_prompt(85, 30), max_new_tokens=10)]]
    for kv_block in (0, 8):
        runs = []
        for spec in (0, 3):
            extra = kw if spec else dict(prefix_cache_size=2,
                                         prefill_chunk=16)
            engine = Engine(params, tcfg, **ENGINE, kv_block=kv_block,
                            spec_decode=spec, device="cpu", **extra)
            runs.append([_serve(engine, GenRequest, p)[0] for p in phases])
            stats = engine.stats()
            assert stats["prefix_hits"] == 3
            assert stats["prefill_segments"] > stats["prefill_dispatches"]
        assert [[t for t, _ in ph] for ph in runs[0]] == [
            [t for t, _ in ph] for ph in runs[1]]


def test_spec_validation(model, draft):
    """The reference's refusals: penalties on a speculative engine, a
    request past the headroom reserve, bad spec settings, a draft without
    spec or with another vocabulary."""
    _, _, tcfg, params = model
    engine = Engine(params, tcfg, n_slots=1, max_len=32, chunk=2,
                    spec_decode=4, device="cpu")
    # usable = 32 - 5 = 27: a request needing 28 rows is refused.
    with pytest.raises(ValueError, match="headroom"):
        engine.submit(GenRequest(tokens=[1] * 20, max_new_tokens=8))
    with pytest.raises(ValueError, match="penalties"):
        engine.submit(GenRequest(tokens=[1, 2], max_new_tokens=4,
                                 repetition_penalty=1.2))
    engine.submit(GenRequest(tokens=[1] * 20, max_new_tokens=7))
    engine.run()
    assert engine.info()["engine"]["spec_decode"] == 4
    assert engine.info()["engine"]["usable_len"] == 27
    assert engine.prompt_buckets[-1] == 26
    _, _, dtcfg, dparams = draft
    bad = [
        dict(spec_decode=-1),
        dict(spec_decode=2, spec_ngram=0),
        dict(draft_params=dparams),
        dict(draft_params=dparams, draft_cfg=dtcfg),
        dict(spec_decode=2, draft_params=dparams,
             draft_cfg=TransformerConfig(**{**DRAFT, "vocab_size": 50})),
        dict(spec_decode=30),
    ]
    for kw in bad:
        with pytest.raises(ValueError):
            Engine(params, tcfg, n_slots=1, max_len=32, chunk=2,
                   device="cpu", **kw)


def test_draft_lookup_matches_reference():
    """``_draft_lookup`` over [S, max_len] histories is bit-equal to the
    reference's per-slot function: random histories of few symbols (so
    that matches abound) at every length, and the reference test's
    cases — the decided continuation preferred over the freshest edge
    match, and the edge fallback with undecided positions masked."""
    max_len = 16
    rng = np.random.RandomState(0)
    hist = rng.randint(0, 3, (40, max_len))
    hist[0] = [9] * 10 + [5, 4, 3, 2, 1, 0]
    hist[1] = [7, 8, 7, 8, 5, 4, 3, 2] + [0] * 8
    lengths = rng.randint(0, max_len, 40)
    lengths[:2] = (9, 3)
    for draft_len, ngram in ((4, 2), (3, 3)):
        want = jax.vmap(partial(jax_draft_lookup, draft_len=draft_len,
                                ngram=ngram, max_len=max_len))(
            jnp.asarray(hist, jnp.int32), jnp.asarray(lengths, jnp.int32))
        got = _draft_lookup(torch.from_numpy(hist),
                            torch.from_numpy(lengths).int(), draft_len,
                            ngram, max_len)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if (draft_len, ngram) == (4, 2):
            assert got[0].tolist() == [9, 9, 9, 9]
            assert got[1].tolist() == [7, 8, 0, 0]


def test_solo_speculative_matches_reference(model):
    """``make_speculative_fn`` emits the reference's tokens in the same
    number of verify forwards, and ``generate``'s greedy tokens."""
    jcfg, jparams, tcfg, params = model
    for seed, n, new in ((1, 8, 20), (3, 14, 17)):
        tokens = _prompt(seed, n)
        want, jstats = jax_spec_fn(jcfg, draft_len=3, ngram=2)(
            jparams, jnp.asarray([tokens], jnp.int32), max_new_tokens=new)
        got, stats = make_speculative_fn(tcfg, draft_len=3, ngram=2)(
            params, torch.tensor([tokens]), new)
        assert got[0].tolist() == np.asarray(want)[0].tolist()
        assert stats["iterations"] == int(jstats["iterations"])
        assert stats["drafts_accepted"] == int(jstats["drafts_accepted"])
        assert stats["iterations"] < new - 1
        plain = tdecode.generate(params, torch.tensor([tokens]), tcfg, new)
        assert got[0].tolist() == plain[0].tolist()
    with pytest.raises(ValueError):
        make_speculative_fn(tcfg, draft_len=0)


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


GEOMETRY = ["--vocab-size", "101", "--d-model", "64", "--n-layers", "2",
            "--n-heads", "4", "--n-kv-heads", "2", "--d-ff", "96",
            "--dtype", "float32", "--max-len", "64", "--n-slots", "2",
            "--chunk", "4", "--port", "0", "--seed", "5", "--device", "cpu"]


def test_serve_main_spec_decode_on_cpu(tmp_path):
    """``serve_main --spec-decode`` as a user calls it: prompt lookup, and
    a draft model from a params export (the port's exporter, weights
    from a seed), each serving ``generate``'s greedy tokens over HTTP
    with the speculative keys in ``/v1/info`` and ``/v1/stats``, a
    penalised request a 400, and ``/v1/beam`` and ``/v1/embed`` beside
    them; a draft directory without its geometry exits."""
    dcfg = TransformerConfig(vocab_size=101, d_model=32, n_layers=1,
                             n_heads=2, d_ff=32, dtype="float32")
    export = tmp_path / "draft"
    Checkpointer(tmp_path / "ckpt", CheckpointerOptions()).export_params(
        type("State", (), {"params": init_params(3, dcfg, master=True)}),
        export)
    draft_flags = ["--draft-params-dir", str(export), "--draft-n-layers",
                   "1", "--draft-d-model", "32", "--draft-n-heads", "2",
                   "--draft-d-ff", "32"]
    tokens = [3, 1, 4, 1, 5, 9, 2, 6]
    for flags in (["--spec-decode", "3"], ["--spec-decode", "2",
                                           *draft_flags]):
        server = serve_main.start_server(
            serve_main.build_parser().parse_args(GEOMETRY + flags))
        try:
            status, reply = _post(server.port, "/v1/generate",
                                  {"tokens": tokens, "max_new_tokens": 12})
            assert status == 200
            cfg = server.engine.cfg
            want = tdecode.generate(init_params(5, cfg),
                                    torch.tensor([tokens]), cfg, 12)
            assert reply["tokens"] == want[0, len(tokens):].tolist()
            info = server.engine.info()["engine"]
            assert info["spec_decode"] == int(flags[1])
            assert info["spec_draft_model"] == (len(flags) > 2)
            assert server.engine.stats()["spec_drafted"] > 0
            status, _ = _post(server.port, "/v1/generate", {
                "tokens": tokens, "max_new_tokens": 4,
                "presence_penalty": 0.5})
            assert status == 400
            # The slot-free routes on the same server: beam 1 is greedy.
            status, reply = _post(server.port, "/v1/beam", {
                "tokens": tokens, "max_new_tokens": 12, "beam_size": 1})
            assert status == 200
            assert reply["tokens"] == want[0, len(tokens):].tolist()
            status, reply = _post(server.port, "/v1/embed",
                                  {"tokens": tokens})
            assert status == 200 and reply["dim"] == cfg.d_model
        finally:
            server.stop()
    with pytest.raises(SystemExit):
        serve_main.make_engine(serve_main.build_parser().parse_args(
            GEOMETRY + ["--spec-decode", "2", "--draft-params-dir",
                        str(export)]))
