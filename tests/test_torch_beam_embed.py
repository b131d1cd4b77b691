"""The port's beam search and embeddings on the CPU, against the JAX
package.

One small Qwen2-style model (q/k/v biases, GQA 4/2, f32) is drawn by the
JAX package and handed to the port with ``from_jax_params``.
``models/beam.py`` emits the reference's ``make_beam_search_fn`` tokens,
its score within 1e-4 (both in f32: summation order only), with and
without an EOS; beam 1 is greedy decoding; ``Engine.beam`` trims at the
EOS, validates as the reference's does and bounds its per-configuration
state.  ``embed_tokens`` is within 1e-5 of the reference's, and
``Engine.embed`` does not depend on the padding bucket.  Both are
refused while draining, and ``/v1/embed`` and ``/v1/beam`` answer over
HTTP with the reference's bodies and 400s.
"""

import json
import math
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oim_tpu.models import TransformerConfig as JaxConfig
from oim_tpu.models import init_params as jax_init_params
from oim_tpu.models.beam import make_beam_search_fn as jax_beam_fn
from oim_tpu.models.decode import embed_tokens as jax_embed_tokens

from oim_tpu_torch.models import decode as tdecode
from oim_tpu_torch.models.beam import make_beam_search_fn
from oim_tpu_torch.models.transformer import TransformerConfig
from oim_tpu_torch.models.weights import from_jax_params
from oim_tpu_torch.serve import engine as engine_mod
from oim_tpu_torch.serve.engine import DrainingError, Engine
from oim_tpu_torch.serve.server import ServeServer
from torch_cpu_threads import one_torch_thread  # noqa: F401

CFG = dict(
    vocab_size=101, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=96, attn_bias=True, dtype="float32",
)
SCORE_ATOL = 1e-4
EMBED_ATOL = 1e-5


@pytest.fixture(scope="module")
def model():
    jcfg = JaxConfig(**CFG, use_pallas=False)
    jparams = dict(jax_init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.RandomState(0)
    for name in ("bq", "bk", "bv"):
        jparams[name] = jnp.asarray(
            rng.randn(*jparams[name].shape).astype(np.float32) * 0.1)
    tree = {name: np.asarray(value) for name, value in jparams.items()}
    tcfg = TransformerConfig(**CFG)
    return jcfg, jparams, tcfg, from_jax_params(tree, tcfg)


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, CFG["vocab_size"],
                                               n).tolist()


def _greedy(model, tokens, n):
    _, _, tcfg, params = model
    out = tdecode.generate(params, torch.tensor([tokens]), tcfg, n)
    return out[0, len(tokens):].tolist()


@pytest.mark.parametrize("beam_size,eos", [(1, None), (4, None), (3, "b1")],
                         ids=["beam1", "beam4", "beam3-eos"])
def test_beam_matches_reference(model, beam_size, eos):
    """Tokens identical to the reference's beam search, the total and
    normalized scores within SCORE_ATOL and the length equal; with an
    EOS the greedy path emits (beam 1's fourth token), beams freeze."""
    jcfg, jparams, tcfg, params = model
    tokens, new = _prompt(11, 8), 9
    eos_id = _greedy(model, tokens, new)[3] if eos else None
    want, wstats = jax_beam_fn(jcfg, beam_size=beam_size, eos_id=eos_id)(
        jparams, jnp.asarray([tokens], jnp.int32), max_new_tokens=new)
    got, stats = make_beam_search_fn(tcfg, beam_size=beam_size,
                                     eos_id=eos_id)(
        params, torch.tensor([tokens]), new)
    assert got[0].tolist() == np.asarray(want)[0].tolist()
    for key in ("score", "normalized_score"):
        assert abs(stats[key] - float(wstats[key])) <= SCORE_ATOL, key
    assert stats["length"] == int(wstats["length"])
    if beam_size == 1:
        assert got[0, len(tokens):].tolist() == _greedy(model, tokens, new)


def test_engine_beam(model):
    """``Engine.beam``: beam 1 is the engine's greedy output, beam 4 a
    full generation with a finite score, an EOS trims (the EOS kept);
    the reference's validation; the search-function FIFO and the shape
    budget bound the per-configuration state; a speculative engine's
    headroom and buckets do not apply to beam."""
    _, _, tcfg, params = model
    engine = Engine(params, tcfg, n_slots=1, max_len=64, chunk=4,
                    device="cpu")
    tokens = _prompt(11, 8)
    b1, s1 = engine.beam(tokens, max_new_tokens=9, beam_size=1)
    assert b1 == _greedy(model, tokens, 9)
    b4, s4 = engine.beam(tokens, max_new_tokens=9, beam_size=4)
    assert len(b4) == 9 and math.isfinite(s4) and math.isfinite(s1)
    assert len(engine._beam_fns) == 2
    engine.beam(tokens, max_new_tokens=9, beam_size=4)
    assert len(engine._beam_fns) == 2
    # The first token not emitted before it, as the EOS: the generation
    # stops there, the EOS included.
    k = next(i for i in range(1, 9) if b1[i] not in b1[:i])
    be, _ = engine.beam(tokens, max_new_tokens=9, beam_size=1, eos_id=b1[k])
    assert be == b1[: k + 1]
    for kw in (dict(tokens=[CFG["vocab_size"] + 5], max_new_tokens=4),
               dict(tokens=tokens, max_new_tokens=60),
               dict(tokens=tokens, max_new_tokens=4, beam_size=1000),
               dict(tokens=[], max_new_tokens=4),
               dict(tokens=tokens, max_new_tokens=0),
               dict(tokens=[1, 2], max_new_tokens=2, alpha=float("nan"))):
        with pytest.raises(ValueError):
            engine.beam(**kw)
    for i in range(engine_mod._MAX_BEAM_PROGRAMS + 3):
        engine.beam(tokens, max_new_tokens=2, beam_size=1,
                    alpha=0.5 + 0.01 * i)
    assert len(engine._beam_fns) <= engine_mod._MAX_BEAM_PROGRAMS
    spec = Engine(params, tcfg, n_slots=1, max_len=64, chunk=4,
                  spec_decode=4, prompt_buckets=(16,), device="cpu")
    long_prompt = _prompt(13, 20)  # past the largest bucket
    assert spec.beam(long_prompt, 40, beam_size=2) == engine.beam(
        long_prompt, 40, beam_size=2)


def test_beam_trace_budget(model, monkeypatch):
    """Past the shape budget both caches clear instead of growing."""
    _, _, tcfg, params = model
    engine = Engine(params, tcfg, n_slots=1, max_len=64, chunk=4,
                    device="cpu")
    monkeypatch.setattr(engine_mod, "_MAX_BEAM_TRACES", 3)
    for n in (3, 4, 5):
        engine.beam(_prompt(20 + n, n), max_new_tokens=2, beam_size=1)
    assert len(engine._beam_traces) == 3
    engine.beam(_prompt(26, 6), max_new_tokens=2, beam_size=1)
    assert len(engine._beam_traces) == 1


def test_embed_matches_reference(model):
    """``embed_tokens`` within EMBED_ATOL of the reference's on a padded
    batch; ``Engine.embed`` is unit-norm and the reference's value at
    any bucket."""
    jcfg, jparams, tcfg, params = model
    rows = [_prompt(3, 7), _prompt(4, 12)]
    padded = np.zeros((2, 16), np.int64)
    lens = np.asarray([len(r) for r in rows])
    for i, r in enumerate(rows):
        padded[i, : len(r)] = r
    want = np.asarray(jax_embed_tokens(
        jparams, jnp.asarray(padded, jnp.int32), jnp.asarray(lens), jcfg))
    got = tdecode.embed_tokens(params, torch.from_numpy(padded),
                               torch.from_numpy(lens), tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=EMBED_ATOL, rtol=0)
    tokens = rows[0]
    vecs = [Engine(params, tcfg, n_slots=1, max_len=64, chunk=2,
                   prompt_buckets=buckets, device="cpu").embed(tokens)
            for buckets in (None, (32,))]
    for vec in vecs:
        assert len(vec) == CFG["d_model"]
        np.testing.assert_allclose(np.linalg.norm(vec), 1.0, rtol=1e-5)
        np.testing.assert_allclose(vec, want[0], atol=EMBED_ATOL, rtol=0)


def test_slot_free_work_refused_while_draining(model):
    _, _, tcfg, params = model
    engine = Engine(params, tcfg, n_slots=1, max_len=64, chunk=2,
                    device="cpu")
    engine.drain()
    with pytest.raises(DrainingError):
        engine.embed([1, 2, 3])
    with pytest.raises(DrainingError):
        engine.beam([1, 2, 3], max_new_tokens=2)
    assert engine.in_flight() == 0


def _post(port, path, body: bytes):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body,
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def test_http_embed_and_beam(model):
    """``/v1/embed`` and ``/v1/beam`` with the reference's bodies: the
    embedding and its ``dim``, beam 1's greedy tokens and a float score;
    a body without ``tokens``, a text prompt and a bad beam width are
    400s."""
    _, _, tcfg, params = model
    engine = Engine(params, tcfg, n_slots=2, max_len=64, chunk=4,
                    device="cpu")
    server = ServeServer(engine, port=0).start()
    try:
        tokens = _prompt(12, 6)
        status, reply = _post(server.port, "/v1/embed",
                              json.dumps({"tokens": tokens}).encode())
        assert status == 200 and reply["dim"] == CFG["d_model"]
        np.testing.assert_allclose(reply["embedding"], engine.embed(tokens),
                                   atol=1e-6, rtol=0)
        status, reply = _post(server.port, "/v1/beam", json.dumps(
            {"tokens": tokens, "max_new_tokens": 6, "beam_size": 1}).encode())
        assert status == 200
        assert reply["tokens"] == _greedy(model, tokens, 6)
        assert isinstance(reply["score"], float)
        for path, body in (("/v1/beam", b'{"max_new_tokens": 3}'),
                           ("/v1/embed", b"{}"),
                           ("/v1/embed", b'{"text": "hi"}'),
                           ("/v1/beam", json.dumps({
                               "tokens": tokens, "beam_size": 99}).encode())):
            status, _ = _post(server.port, path, body)
            assert status == 400, (path, body)
    finally:
        server.stop()
