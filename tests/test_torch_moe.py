"""Exact-routing MoE serving in the port, on the CPU, against the JAX
package.

Tiny f32 MoE models are drawn by the JAX package (``init_params`` with
``n_experts``) and handed to the port with ``from_jax_params``; random
inputs come from numpy seeds.  Held against ``oim_tpu``:

- ``_router_gates`` at k = 1 and 2 (and its tie order: equal probs rank
  the lower expert first, as ``jax.lax.top_k`` does), and ``_moe_exact``
  within 1e-6 of the output's scale (f32 both sides, summation order
  only: observed ~2e-7);
- solo decode: prefill logits within 1e-4 and greedy tokens identical;
- the engine, dense and paged, at pipeline depth 1 and 2, token for
  token with the reference's engine at every prompt length tested, for
  (E, k) = (2, 1) and (4, 2);
- the parameter layout (names, shapes, dtypes, counts) of MoE trees,
  ``info()``'s expert fields, ``serve_main --n-experts 4 --moe-top-k 2``
  over HTTP, and ``--tp``/``--ep`` refused (Queue A12).

The card's test of an MoE decode chunk's CUDA graph lives in
``tests/test_torch_pipeline.py`` (that file imports no JAX at its top,
so it runs on the GPU machine).
"""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oim_tpu.models import TransformerConfig as JaxConfig
from oim_tpu.models import decode as jdecode
from oim_tpu.models import init_params as jax_init_params
from oim_tpu.models import transformer as jtransformer
from oim_tpu.serve import Engine as JaxEngine
from oim_tpu.serve import GenRequest as JaxRequest

from oim_tpu_torch.cli import serve_main
from oim_tpu_torch.models import decode as tdecode
from oim_tpu_torch.models import transformer as ttransformer
from oim_tpu_torch.models.train import named_parameters
from oim_tpu_torch.models.transformer import TransformerConfig, init_params
from oim_tpu_torch.models.weights import (
    check_params,
    from_jax_params,
    n_params,
    param_shapes,
    recast,
)
from oim_tpu_torch.serve.engine import Engine, GenRequest

BASE = dict(vocab_size=101, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=96, dtype="float32")
MOES = [(2, 1), (4, 2)]
MOE_IDS = ["e2k1", "e4k2"]
ENGINE = dict(n_slots=3, max_len=64, chunk=4, prompt_buckets=(8, 16, 32))
# Prompt lengths on both sides of every bucket edge, budgets ending
# mid-chunk.
LENGTHS = [3, 8, 9, 16, 17, 30]
MAX_NEW = [9, 5, 12, 6, 7, 10]
# f32 both sides, the same formula in another summation order.
MOE_RTOL = 1e-6
LOGITS_ATOL = 1e-4
TINY = ["--vocab-size", "101", "--d-model", "64", "--n-layers", "2",
        "--n-heads", "4", "--n-kv-heads", "2", "--d-ff", "96",
        "--dtype", "float32", "--max-len", "64", "--n-slots", "2",
        "--chunk", "4"]


def _moe(e: int, k: int, seed: int = 0):
    """(jax cfg, jax params on the device, port cfg, port serving
    params) of a tiny MoE model with ``e`` experts, top ``k``."""
    kw = {**BASE, "n_experts": e, "moe_top_k": k}
    jcfg = JaxConfig(**kw, use_pallas=False)
    jparams = jax_init_params(jax.random.PRNGKey(seed), jcfg)
    tcfg = TransformerConfig(**kw)
    return jcfg, jparams, tcfg, from_jax_params(jax.device_get(jparams), tcfg)


@pytest.fixture(scope="module", params=MOES, ids=MOE_IDS)
def model(request):
    return _moe(*request.param)


def _layer0(jparams):
    """The reference's first layer's weights, unstacked."""
    return {name: value[0, 0] for name, value in jparams.items()
            if name not in ("wte", "wlm", "final_norm")}


@pytest.mark.parametrize("k", [1, 2])
def test_router_gates_match_reference(k):
    rng = np.random.RandomState(k)
    logits = rng.randn(9, 4).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    want = jtransformer._router_gates(jnp.asarray(probs), k)
    got = ttransformer._router_gates(torch.from_numpy(probs), k)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=MOE_RTOL)
    if k == 2:
        np.testing.assert_allclose(got[2].sum(-1).numpy(), 1.0, rtol=1e-6)


def test_router_gates_break_ties_as_the_reference():
    """Equal probs: the lower expert index ranks first, on both sides."""
    probs = np.asarray([[0.25, 0.25, 0.25, 0.25],
                        [0.1, 0.3, 0.3, 0.3],
                        [0.4, 0.1, 0.4, 0.1]], np.float32)
    for k in (1, 2, 3):
        want = np.asarray(jtransformer._router_gates(jnp.asarray(probs), k)[1])
        got = ttransformer._router_gates(torch.from_numpy(probs), k)[1]
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [[0, 1, 2], [1, 2, 3], [0, 2, 1]])


@pytest.mark.parametrize("t", [1, 7, 1100], ids=["t1", "t7", "t1100"])
def test_moe_exact_matches_reference(model, t, monkeypatch):
    """One MoE block at a decode step, a short segment and one longer
    than ``MOE_TOKENS`` (split into passes here, one pass in the
    reference)."""
    jcfg, jparams, tcfg, params = model
    monkeypatch.setattr(tdecode, "MOE_TOKENS", 512)
    x = np.random.RandomState(t).randn(2, t, BASE["d_model"]).astype(
        np.float32)
    want = np.asarray(jdecode._moe_exact(jnp.asarray(x),
                                         _layer0(jparams), jcfg))
    got = tdecode._moe_exact(torch.from_numpy(x), params["layers"][0], tcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=MOE_RTOL * np.abs(want).max())


def test_moe_exact_is_per_token(model):
    """A row's result does not depend on its batchmates (drop-free
    routing): one row alone equals the same row in a batch of four."""
    _, _, tcfg, params = model
    x = torch.from_numpy(np.random.RandomState(5).randn(
        4, 6, BASE["d_model"]).astype(np.float32))
    lp = params["layers"][1]
    torch.testing.assert_close(tdecode._moe_exact(x[:1], lp, tcfg),
                               tdecode._moe_exact(x, lp, tcfg)[:1],
                               rtol=0, atol=1e-6)


def test_prefill_and_generate_match_reference(model):
    jcfg, jparams, tcfg, params = model
    prompt = np.random.RandomState(1).randint(0, 101, (2, 6))
    want, _ = jdecode.prefill(jparams, jnp.asarray(prompt), jcfg, max_len=12)
    got, _ = tdecode.prefill(params, torch.from_numpy(prompt), tcfg, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGITS_ATOL)
    want = jdecode.generate(jparams, jnp.asarray(prompt), jcfg, 6)
    got = tdecode.generate(params, torch.from_numpy(prompt), tcfg, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _serve(engine, request_cls, prompts, max_new):
    rids = [engine.submit(request_cls(tokens=p, max_new_tokens=m))
            for p, m in zip(prompts, max_new)]
    results = engine.run()
    return [results[r] for r in rids]


@pytest.mark.parametrize("moe", MOES, ids=MOE_IDS)
def test_engine_matches_reference_engine(moe):
    """The reference's engine and the port's, dense and paged, at depth 2
    and 1, give the same greedy tokens at every prompt length."""
    jcfg, jparams, tcfg, params = _moe(*moe, seed=moe[0])
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, 101, n).tolist() for n in LENGTHS]
    want = _serve(JaxEngine(jparams, jcfg, **ENGINE), JaxRequest, prompts,
                  MAX_NEW)
    for kv_block in (0, 8):
        for depth in (2, 1):
            engine = Engine(params, tcfg, **ENGINE, kv_block=kv_block,
                            pipeline_depth=depth, device="cpu")
            got = _serve(engine, GenRequest, prompts, MAX_NEW)
            assert got == want, (kv_block, depth)
            assert engine.stats()["tokens_generated"] == sum(MAX_NEW)


def test_param_layout_of_moe_trees(model):
    """``from_jax_params``, ``init_params``, ``param_shapes``,
    ``check_params``, ``n_params`` and ``recast`` on MoE trees: the
    reference's shapes and count; the router f32 in every layout, the
    experts in the compute dtype."""
    jcfg, jparams, tcfg, params = model
    e, d, f = tcfg.n_experts, tcfg.d_model, tcfg.ff_dim
    lp = params["layers"][0]
    assert tuple(lp["router"].shape) == (d, e)
    assert tuple(lp["w_gate"].shape) == tuple(lp["w_in"].shape) == (e, d, f)
    assert tuple(lp["w_out"].shape) == (e, f, d)
    want_count = sum(int(np.prod(v.shape)) for v in jparams.values())
    assert n_params(params) == want_count
    fresh = init_params(0, tcfg, master=True)
    assert {n: tuple(t.shape) for n, t in named_parameters(fresh)} == (
        param_shapes(tcfg))
    check_params(fresh, tcfg, "fresh")
    with pytest.raises(ValueError, match="does not match"):
        check_params(fresh, TransformerConfig(**BASE), "dense flags")
    served, cfg16 = recast(fresh, tcfg, "bfloat16")
    assert served["layers"][1]["router"].dtype == torch.float32
    assert served["layers"][1]["w_out"].dtype == torch.bfloat16
    assert cfg16.n_experts == e


def test_info_reports_the_experts(model):
    jcfg, jparams, tcfg, params = model
    got = Engine(params, tcfg, **ENGINE, device="cpu").info()["model"]
    want = JaxEngine(jparams, jcfg, **ENGINE).info()["model"]
    for key in ("n_experts", "moe_top_k", "d_ff", "n_layers"):
        assert got[key] == want[key], key
    dense = Engine(init_params(0, TransformerConfig(**BASE)),
                   TransformerConfig(**BASE), **ENGINE, device="cpu")
    assert (dense.info()["model"]["n_experts"],
            dense.info()["model"]["moe_top_k"]) == (0, 0)


def test_serve_main_serves_moe_over_http():
    """``serve_main --n-experts 4 --moe-top-k 2`` on its default engine
    answers /v1/generate with solo ``generate``'s greedy tokens over the
    same seeded weights, and /v1/info names the experts."""
    args = serve_main.build_parser().parse_args(
        TINY + ["--n-experts", "4", "--moe-top-k", "2", "--device", "cpu",
                "--port", "0", "--seed", "3"])
    server = serve_main.start_server(args)
    try:
        prompt = np.random.RandomState(2).randint(0, 101, 11).tolist()
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/v1/generate",
            data=json.dumps({"tokens": prompt,
                             "max_new_tokens": 7}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            reply = json.loads(resp.read())
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/v1/info", timeout=60) as r:
            info = json.loads(r.read())
        cfg = server.engine.cfg
    finally:
        server.stop()
    assert (cfg.n_experts, cfg.moe_top_k) == (4, 2)
    assert (info["model"]["n_experts"], info["model"]["moe_top_k"]) == (4, 2)
    want = tdecode.generate(init_params(3, cfg), torch.tensor([prompt]), cfg,
                            7)[0, 11:].tolist()
    assert reply["tokens"] == want


@pytest.mark.parametrize("flag", ["--ep", "--tp"])
def test_serve_main_refuses_sharded_serving(flag):
    args = serve_main.build_parser().parse_args(
        TINY + ["--n-experts", "4", "--device", "cpu", flag, "2"])
    with pytest.raises(ValueError, match="Queue A12"):
        serve_main.make_engine(args)
