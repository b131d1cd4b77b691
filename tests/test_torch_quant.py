"""The port's weight-only quantization on the CPU, against the JAX package.

Inputs come from a seeded numpy generator (or the JAX package's own
init) and go through both packages, in f32:

- ``quantize_weight_int8``/``_int4`` (packed int4 along ``din``, an odd
  ``din`` padded by a zero row) and the gcd group clamp: unpacked
  payloads and scales bit-equal, dequantized values equal;
- ``quantize_params_int8``/``_int4`` on the port's layout equal
  ``from_jax_params`` of the reference's quantized trees;
  ``weight_quant_mode``, ``maybe_dequantize_weights``; quantized as
  drawn by ``init_params`` equals quantized after init;
- solo ``prefill`` logits over quantized params within 1e-5 of the
  reference's (the plain ``quant_matmul`` dequantizes each weight as
  the reference's ``maybe_dequantize_weights`` does; f32 summation order
  only);
- the engine, dense and paged, depth 1 and 2, and a small MoE with int8
  experts: greedy tokens identical to the JAX engine's on the same
  quantized params;
- ``serve_main --device cpu --weights-int4 --kv-int4 --kv-block 8``
  answers ``/v1/generate``, and ``/v1/info`` carries the reference's
  quantization keys.
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
from oim_tpu.ops import quant as jquant
from oim_tpu.serve import Engine as JaxEngine
from oim_tpu.serve import GenRequest as JaxRequest

from oim_tpu_torch.cli import serve_main
from oim_tpu_torch.models import decode as tdecode
from oim_tpu_torch.models.train import named_parameters
from oim_tpu_torch.models.transformer import TransformerConfig, init_params
from oim_tpu_torch.models.weights import (
    check_params,
    from_jax_params,
    n_params,
    param_shapes,
)
from oim_tpu_torch.ops import quant as tquant
from oim_tpu_torch.ops import wquant
from oim_tpu_torch.serve.engine import Engine, GenRequest
from torch_cpu_threads import one_torch_thread  # noqa: F401

CFG = dict(
    vocab_size=101, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=96, attn_bias=True, dtype="float32",
)
# d_ff 36 (a multiple of 4, not of 8 or 64): the int4 groups of w_out
# clamp to gcd(36, group); w_gate/w_in group d_model 64 whole.
MOE = dict(CFG, d_ff=36, n_experts=4, moe_top_k=2, attn_bias=False)
ENGINE = dict(n_slots=2, max_len=64, chunk=4, prompt_buckets=(8, 16, 32))
LOGIT_TOL = 1e-5
GROUP = 16


def _values(x):
    return np.asarray(x).astype(np.int8)


_QUANTIZED = {}


def _quantize_ref(jparams, mode):
    """The reference's quantized tree of ``jparams`` (each computed
    once)."""
    key = (id(jparams), mode)
    if key not in _QUANTIZED:
        _QUANTIZED[key] = (jparams, jquant.quantize_params_int8(jparams)
                           if mode == "int8" else
                           jquant.quantize_params_int4(jparams, group=GROUP))
    return _QUANTIZED[key][1]


def _jax_model(cfg):
    jcfg = JaxConfig(**cfg, use_pallas=False)
    jparams = dict(jax_init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.RandomState(0)
    for name in ("bq", "bk", "bv"):
        if name in jparams:
            jparams[name] = jnp.asarray(
                rng.randn(*jparams[name].shape).astype(np.float32) * 0.1)
    return jcfg, jparams


@pytest.fixture(scope="module")
def model():
    """(jax cfg, jax params, port cfg) of the dense model."""
    jcfg, jparams = _jax_model(CFG)
    return jcfg, jparams, TransformerConfig(**CFG)


def _port(jparams_q, tcfg):
    return from_jax_params({k: np.asarray(v) for k, v in jparams_q.items()},
                           tcfg)


# ---------------------------------------------------------------------------
# Quantizers


@pytest.mark.parametrize("shape,group", [
    ((64, 40), 64),      # one group of 64 rows
    ((3, 36, 24), 64),   # an expert axis; gcd(36, 64) = 4
    ((37, 16), 16),      # odd din: gcd 1, a padded packed row
    ((2, 7, 5), 3),      # odd din and dout, gcd(7, 3) = 1
], ids=["whole", "experts-gcd", "odd-din", "odd-both"])
def test_weight_quantizers_bit_equal(shape, group):
    w = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    w[..., 0, 0] = 0.0
    q4j, s4j = jquant.quantize_weight_int4(jnp.asarray(w), group)
    q4t, s4t = tquant.quantize_weight_int4(torch.from_numpy(w), group)
    din = shape[-2]
    assert q4t.dtype == torch.uint8 and q4t.shape[-2] == -(-din // 2)
    values = tquant.unpack_int4(q4t, dim=-2)
    np.testing.assert_array_equal(_values(q4j), values[..., :din, :].numpy())
    if din % 2:
        assert not values[..., din:, :].any()  # the padding row is zero
    np.testing.assert_array_equal(np.asarray(s4j), s4t.numpy())
    np.testing.assert_array_equal(
        np.asarray(jquant.dequantize_weight_int4(q4j, s4j)),
        tquant.dequantize_weight_int4(q4t, s4t).numpy())
    q8j, s8j = jquant.quantize_weight_int8(jnp.asarray(w))
    q8t, s8t = tquant.quantize_weight_int8(torch.from_numpy(w))
    np.testing.assert_array_equal(np.asarray(q8j), q8t.numpy())
    np.testing.assert_array_equal(np.asarray(s8j), s8t.numpy())
    np.testing.assert_array_equal(
        np.asarray(jquant.dequantize_weight_int8(q8j, s8j)),
        tquant.dequantize_weight_int8(q8t, s8t).numpy())


@pytest.mark.parametrize("din,group", [(64, 64), (96, 64), (36, 64),
                                       (37, 16), (8960, 64), (14336, 128)])
def test_int4_group_gcd_clamp(din, group):
    assert tquant._int4_group(din, group) == jquant._int4_group(din, group)


def test_quantized_trees_from_jax_and_port(model):
    """``from_jax_params`` of the reference's quantized trees equals the
    port's ``quantize_params_*`` of its float params; the mode, the
    dequantized tree, the shapes and the parameter count agree."""
    _, jparams, tcfg = model
    master = from_jax_params({k: np.asarray(v) for k, v in jparams.items()},
                             tcfg, master=True)
    for mode in ("int8", "int4"):
        port = _port(_quantize_ref(jparams, mode), tcfg)
        mine = (tquant.quantize_params_int8(master) if mode == "int8"
                else tquant.quantize_params_int4(master, GROUP))
        got, want = dict(named_parameters(port)), dict(named_parameters(mine))
        assert sorted(got) == sorted(want)
        for name, t in want.items():
            assert got[name].dtype == t.dtype, name
            assert torch.equal(got[name], t), name
        assert tquant.weight_quant_mode(port) == mode
        assert jquant.weight_quant_mode(_quantize_ref(jparams, mode)) == mode
        check_params(port, tcfg, "the quantized tree", int4_group=GROUP)
        shapes = param_shapes(tcfg, mode, GROUP)
        assert {k: tuple(v.shape) for k, v in got.items()} == shapes
        assert n_params(port) == n_params(master)
        deq = tquant.maybe_dequantize_weights(port)
        ref = jquant.maybe_dequantize_weights(_quantize_ref(jparams, mode))
        np.testing.assert_array_equal(deq["wlm"].numpy(),
                                      np.asarray(ref["wlm"]))
        np.testing.assert_array_equal(
            deq["layers"][1]["w_out"].numpy(),
            np.asarray(ref["w_out"]).reshape(2, 96, 64)[1])
        assert not any(n.endswith("_wscale") for n, _ in
                       named_parameters(deq))
    assert tquant.weight_quant_mode(master) == ""
    assert tquant.maybe_dequantize_weights(master) is master
    with pytest.raises(ValueError, match="never"):
        from_jax_params({k: np.asarray(v) for k, v in
                         _quantize_ref(jparams, "int8").items()}, tcfg,
                        master=True)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_as_drawn_equals_quantized_after_init(mode):
    cfg = TransformerConfig(**MOE)
    drawn = init_params(3, cfg, weight_quant=mode, int4_group=GROUP)
    master = init_params(3, cfg, master=True)
    after = (tquant.quantize_params_int8(master) if mode == "int8"
             else tquant.quantize_params_int4(master, GROUP))
    got, want = dict(named_parameters(drawn)), dict(named_parameters(after))
    assert sorted(got) == sorted(want)
    for name, t in want.items():
        if name.endswith("_wscale") or f"{name}_wscale" in dict(
                named_parameters(after)):
            assert torch.equal(got[name], t), name
    assert drawn["layers"][0]["router"].dtype == torch.float32


# ---------------------------------------------------------------------------
# The model and the engine


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_prefill_logits_match_jax(model, mode):
    jcfg, jparams, tcfg = model
    jq = _quantize_ref(jparams, mode)
    tokens = np.random.RandomState(7).randint(0, CFG["vocab_size"], (2, 9))
    want, _ = jdecode.prefill(jq, jnp.asarray(tokens, jnp.int32), jcfg, 16)
    before = wquant.counters()
    got, _ = tdecode.prefill(_port(jq, tcfg), torch.from_numpy(tokens),
                             tcfg, 16)
    after = wquant.counters()
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    # Every layer's seven products and the unembedding went through the
    # plain version of quant_matmul on the CPU.
    assert (after["quant_matmul_plain"] - before["quant_matmul_plain"]
            == 7 * CFG["n_layers"] + 1)
    assert after["quant_matmul"] == before["quant_matmul"]


def _traffic(vocab):
    rng = np.random.RandomState(11)
    return [(rng.randint(0, vocab, n).tolist(), m)
            for n, m in ((5, 7), (20, 6), (9, 8))]


def _serve(engine, request_cls, traffic):
    rids = [engine.submit(request_cls(tokens=p, max_new_tokens=m))
            for p, m in traffic]
    engine.run()
    return [engine.result(rid) for rid in rids]


@pytest.fixture(scope="module")
def reference(model):
    """The JAX engine's greedy streams over each quantized tree."""
    jcfg, jparams, _ = model
    out = {}
    for mode in ("int8", "int4"):
        engine = JaxEngine(_quantize_ref(jparams, mode), jcfg, **ENGINE)
        out[mode] = _serve(engine, JaxRequest, _traffic(CFG["vocab_size"]))
        info = engine.info()["engine"]
        assert (info["weight_quant"], info["weights_int8"]) == (
            mode, mode == "int8")
    return out


@pytest.mark.parametrize("mode,layout,depth", [
    ("int8", dict(kv_block=0), 2),
    ("int8", dict(kv_block=8), 1),
    ("int4", dict(kv_block=8), 2),
    ("int4", dict(kv_block=0), 1),
], ids=["int8-dense-depth2", "int8-paged-depth1", "int4-paged-depth2",
        "int4-dense-depth1"])
def test_engine_greedy_matches_jax(model, reference, mode, layout, depth):
    _, jparams, tcfg = model
    engine = Engine(_port(_quantize_ref(jparams, mode), tcfg), tcfg,
                    **ENGINE, **layout, pipeline_depth=depth, device="cpu")
    got = _serve(engine, GenRequest, _traffic(CFG["vocab_size"]))
    assert got == reference[mode]
    info = engine.info()["engine"]
    assert (info["weight_quant"], info["weights_int8"]) == (
        mode, mode == "int8")
    assert engine.info()["model"]["n_params"] == n_params(
        from_jax_params({k: np.asarray(v) for k, v in jparams.items()},
                        tcfg))


def test_moe_int8_experts_match_jax():
    """A small MoE with int8 experts (w_gate/w_in [E, d, f] over a shared
    input, w_out [E, f, d] over a per-expert one) on the default dense
    engine: greedy tokens identical to the JAX engine's."""
    jcfg, jparams = _jax_model(MOE)
    jq = _quantize_ref(jparams, "int8")
    tcfg = TransformerConfig(**MOE)
    traffic = _traffic(MOE["vocab_size"])
    want = _serve(JaxEngine(jq, jcfg, **ENGINE), JaxRequest, traffic)
    engine = Engine(_port(jq, tcfg), tcfg, **ENGINE, device="cpu")
    assert engine.params["layers"][0]["w_out"].shape == (4, 36, 64)
    assert _serve(engine, GenRequest, traffic) == want


def test_moe_tall_input_dequantizes_experts_once(monkeypatch):
    """Past ``GEMV_ROWS`` tokens ``_moe_exact`` dequantizes each expert
    weight once for all of its passes (here four of 32 tokens): the same
    output as the dequantized tree, three plain dequants, not twelve."""
    monkeypatch.setattr(tdecode, "MOE_TOKENS", 32)
    cfg = TransformerConfig(**MOE)
    lp = init_params(3, cfg, weight_quant="int8")["layers"][0]
    x = torch.from_numpy(
        np.random.RandomState(5).randn(1, 100, 64).astype(np.float32))
    before = wquant.counters()["quant_matmul_plain"]
    got = tdecode._moe_exact(x, lp, cfg)
    assert wquant.counters()["quant_matmul_plain"] - before == 3
    want = tdecode._moe_exact(
        x, tquant.maybe_dequantize_weights(lp, torch.float32), cfg)
    assert torch.equal(got, want)


def test_serve_main_weights_int4_kv_int4_on_cpu():
    """The entry point with both int4 rungs: the seed's weights quantized
    as drawn, a packed int4 paged pool, an answer over HTTP, and the
    reference's quantization keys in /v1/info."""
    args = serve_main.build_parser().parse_args([
        "--vocab-size", "101", "--d-model", "64", "--n-layers", "2",
        "--n-heads", "4", "--n-kv-heads", "2", "--d-ff", "96",
        "--attn-bias", "--dtype", "float32", "--max-len", "64",
        "--n-slots", "2", "--chunk", "4", "--kv-block", "8", "--port", "0",
        "--seed", "5", "--device", "cpu", "--weights-int4", "--int4-group",
        "32", "--kv-int4",
    ])
    server = serve_main.start_server(args)
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/v1/generate",
            data=json.dumps({"tokens": [3, 1, 4, 1, 5],
                             "max_new_tokens": 5}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
            tokens = json.loads(resp.read())["tokens"]
        cfg = server.engine.cfg
        want = tdecode.generate(
            init_params(5, cfg, weight_quant="int4", int4_group=32),
            torch.tensor([[3, 1, 4, 1, 5]]), cfg, 5)
        assert tokens == want[0, 5:].tolist()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/v1/info", timeout=60) as r:
            info = json.loads(r.read())["engine"]
        assert {k: info[k] for k in ("kv_int8", "kv_int4", "kv_quant",
                                     "weights_int8", "weight_quant")} == {
            "kv_int8": False, "kv_int4": True, "kv_quant": "int4",
            "weights_int8": False, "weight_quant": "int4"}
        assert server.engine._cache.k.dtype == torch.uint8
    finally:
        server.stop()
    with pytest.raises(SystemExit):
        serve_main.build_parser().parse_args(["--weights-int8",
                                              "--weights-int4"])
