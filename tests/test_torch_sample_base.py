"""``sample_base`` in the port's serving engine and server, on the CPU.

A continuation resends the prompt plus the k tokens a client already
holds and sets ``sample_base = k`` (the reference's router does this on
every splice): each sampled token's noise index is then its index in
the uninterrupted stream, so the continuation emits that stream's tokens
from k on.  Greedy streams ignore it, and a negative base is refused, as
``oim_tpu/serve/engine.py`` refuses it.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from oim_tpu_torch.models.transformer import TransformerConfig, init_params
from oim_tpu_torch.serve.engine import Engine, GenRequest
from oim_tpu_torch.serve.server import ServeServer
from torch_cpu_threads import one_torch_thread  # noqa: F401

CFG = dict(
    vocab_size=101, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=96, attn_bias=True, dtype="float32",
)
# chunk 3: a continuation's first decode chunk starts off the
# uninterrupted run's chunk boundaries.
ENGINE = dict(
    n_slots=2, max_len=64, chunk=3, prompt_buckets=(8, 16, 32), kv_block=8,
    device="cpu",
)
TOTAL = 12
SAMPLED = dict(temperature=0.9, top_p=0.95, seed=7)


@pytest.fixture(scope="module")
def model():
    cfg = TransformerConfig(**CFG)
    return cfg, init_params(3, cfg)


def _prompt():
    return np.random.RandomState(4).randint(0, CFG["vocab_size"],
                                            9).tolist()


def _run(model, reqs):
    cfg, params = model
    engine = Engine(params, cfg, **ENGINE)
    rids = [engine.submit(r) for r in reqs]
    engine.run()
    return [engine.result(rid) for rid in rids]


@pytest.mark.parametrize("k", [1, 4, 6])
def test_sampled_continuation_reproduces_the_stream(model, k):
    """Prompt + the first k tokens with ``sample_base = k`` emits the
    uninterrupted run's tokens k, k + 1, ...; without the base it draws
    base-0 noise and the streams part."""
    prompt = _prompt()
    full = _run(model, [GenRequest(tokens=prompt, max_new_tokens=TOTAL,
                                   **SAMPLED)])[0]
    cont, unbased = _run(model, [
        GenRequest(tokens=prompt + full[:k], max_new_tokens=TOTAL - k,
                   sample_base=k, **SAMPLED),
        GenRequest(tokens=prompt + full[:k], max_new_tokens=TOTAL - k,
                   **SAMPLED),
    ])
    assert cont == full[k:]
    assert unbased != full[k:]


def test_greedy_ignores_sample_base(model):
    prompt = _prompt()
    plain, based = _run(model, [
        GenRequest(tokens=prompt, max_new_tokens=8),
        GenRequest(tokens=prompt, max_new_tokens=8, sample_base=5),
    ])
    assert based == plain


def test_engine_refuses_negative_sample_base(model):
    cfg, params = model
    engine = Engine(params, cfg, **ENGINE)
    with pytest.raises(ValueError, match="sample_base"):
        engine.submit(GenRequest(tokens=[1, 2], max_new_tokens=2,
                                 sample_base=-1))


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def test_server_reads_sample_base(model):
    """``/v1/generate`` passes ``sample_base`` to the engine (a spliced
    continuation over HTTP) and answers 400 to a negative one."""
    cfg, params = model
    server = ServeServer(Engine(params, cfg, **ENGINE)).start()
    try:
        prompt, k = _prompt(), 5
        body = {"tokens": prompt, "max_new_tokens": TOTAL, **SAMPLED}
        status, full = _post(server.port, body)
        assert status == 200
        status, cont = _post(server.port, {
            **body, "tokens": prompt + full["tokens"][:k],
            "max_new_tokens": TOTAL - k, "sample_base": k})
        assert status == 200 and cont["tokens"] == full["tokens"][k:]
        status, reply = _post(server.port, {**body, "sample_base": -2})
        assert status == 400 and "sample_base" in reply["error"]
    finally:
        server.stop()
