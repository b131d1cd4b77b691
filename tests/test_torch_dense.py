"""The port's dense ``SlotCache`` and ``serve_main``'s defaults, on the CPU,
against the JAX package.

One small Qwen2-style model (q/k/v biases, GQA 4/2, f32) is drawn by the
JAX package and handed to the port with ``from_jax_params``:

- the dense engine (``kv_block=0``, one region per slot, run through the
  paged kernels' plain versions by a fixed identity table) is
  token-identical to the reference's dense engine and to the port's
  paged engine, fp and int8 KV, over three prompt buckets; its layer
  views are the cache itself; it refuses ``kv_int4`` and ``kv_blocks``
  with the reference's messages and reports itself as the reference
  does, in ``info()`` and over ``/v1/info`` and ``/v1/stats``;
- ``serve_main.build_parser()`` gives every flag it shares with the
  reference parser the reference's default, and the same flags build
  the same ``TransformerConfig`` and a dense, depth-2, penalties-on
  engine; ``--no-penalties`` builds an engine without the count state
  that refuses penalised requests with the reference's message.
"""

import dataclasses
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oim_tpu.cli import serve_main as jax_serve_main
from oim_tpu.models import TransformerConfig as JaxConfig
from oim_tpu.models import init_params as jax_init_params
from oim_tpu.serve import Engine as JaxEngine
from oim_tpu.serve import GenRequest as JaxRequest

from oim_tpu_torch.cli import serve_main
from oim_tpu_torch.models import decode as tdecode
from oim_tpu_torch.models.transformer import TransformerConfig
from oim_tpu_torch.models.weights import from_jax_params
from oim_tpu_torch.serve.engine import (
    Engine,
    GenRequest,
    SlotCache,
    dense_block_size,
)
from oim_tpu_torch.serve.server import ServeServer

CFG = dict(
    vocab_size=101, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=96, attn_bias=True, dtype="float32",
)
ENGINE = dict(n_slots=3, max_len=64, chunk=4, prompt_buckets=(8, 16, 32))
VARIANT = dict(mlp_act="gelu_tanh", norm_offset=True, embed_scale=True,
               sliding_window=5)
# The geometry flags of a tiny model, shared by both parsers.
TINY = ["--vocab-size", "101", "--d-model", "64", "--n-layers", "2",
        "--n-heads", "4", "--n-kv-heads", "2", "--d-ff", "96",
        "--attn-bias", "--dtype", "float32", "--max-len", "64",
        "--n-slots", "2", "--chunk", "4"]


def _port(jcfg_kw: dict, seed: int = 0):
    """(jax cfg, jax params, port cfg, port params) for ``jcfg_kw``,
    with random q/k/v biases when the config has them."""
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
    return _port(CFG)


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, CFG["vocab_size"], n).tolist() for n in lengths]


def _serve(engine, request_cls, prompts, max_new):
    rids = [engine.submit(request_cls(tokens=p, max_new_tokens=m))
            for p, m in zip(prompts, max_new)]
    results = engine.run()
    return [results[r] for r in rids]


@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp", "kv8"])
def test_dense_matches_reference_dense_and_port_paged(model, kv_int8):
    """Six requests on three slots over three prompt buckets, budgets
    ending mid-chunk: the port's dense engine, the reference's dense
    engine and the port's paged engine emit the same tokens."""
    jcfg, jparams, tcfg, params = model
    prompts = _prompts(3, [5, 5, 12, 12, 20, 20])
    max_new = [9, 9, 6, 6, 11, 11]
    dense = Engine(params, tcfg, **ENGINE, kv_int8=kv_int8, device="cpu")
    assert not dense.paged and isinstance(dense._cache, SlotCache)
    got = _serve(dense, GenRequest, prompts, max_new)
    want = _serve(JaxEngine(jparams, jcfg, **ENGINE, kv_int8=kv_int8),
                  JaxRequest, prompts, max_new)
    paged = Engine(params, tcfg, **ENGINE, kv_int8=kv_int8, kv_block=8,
                   device="cpu")
    assert got == want == _serve(paged, GenRequest, prompts, max_new)
    stats = dense.stats()
    assert stats["active_slots"] == stats["queued"] == 0
    assert stats["free_slots"] == ENGINE["n_slots"]
    assert stats["tokens_generated"] == sum(max_new)


def test_dense_variant_matches_reference():
    """Gemma's switches and a sliding window shorter than the prompts
    through the dense engine match the reference's dense engine."""
    jcfg, jparams, tcfg, params = _port({**CFG, **VARIANT}, seed=1)
    prompts = _prompts(9, [7, 13])
    engine = Engine(params, tcfg, **ENGINE, device="cpu")
    got = _serve(engine, GenRequest, prompts, [9, 9])
    assert got == _serve(JaxEngine(jparams, jcfg, **ENGINE), JaxRequest,
                         prompts, [9, 9])


@pytest.mark.parametrize("max_len,block", [(2048, 64), (1024, 64),
                                           (1000, 50), (64, 64), (100, 50),
                                           (97, 1)])
def test_dense_block_size(max_len, block):
    """The largest block that divides the region and K1's ring holds."""
    assert dense_block_size(max_len) == block


@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp", "kv8"])
def test_dense_layer_views_are_the_cache(model, kv_int8):
    """A layer's pool views are reshapes of the cache (no copy), and the
    identity table maps slot s's table entry j to its region's rows
    j·bs … (j + 1)·bs − 1."""
    _, _, tcfg, params = model
    engine = Engine(params, tcfg, n_slots=3, max_len=96, device="cpu",
                    kv_int8=kv_int8)
    cache = engine._cache
    assert cache.block_size == 48 and engine._n_tables == 2
    views = cache.layer(1)
    planes = (cache.k, cache.v, cache.k_scale, cache.v_scale)
    for view, plane in zip(views, planes):
        if plane is None:
            assert view is None
            continue
        assert view.data_ptr() == plane[1].data_ptr()
        assert view.shape[:2] == (6, 48)
    table = engine._tables_host
    np.testing.assert_array_equal(table, [[0, 1], [2, 3], [4, 5]])
    view = views[0]
    view[table[2, 1], 7] = 1  # slot 2, row 48 + 7
    assert bool((cache.k[1, 2, 55] == 1).all())
    assert int((cache.k != 0).sum()) == view[0, 0].numel()


def test_dense_refuses_kv_int4_and_kv_blocks(model):
    """The reference's refusals, message for message."""
    jcfg, jparams, tcfg, params = model
    for kw in (dict(kv_int4=True), dict(kv_blocks=12),
               dict(kv_int8=True, kv_int4=True)):
        with pytest.raises(ValueError) as want:
            JaxEngine(jparams, jcfg, **ENGINE, **kw)
        with pytest.raises(ValueError) as got:
            Engine(params, tcfg, **ENGINE, **kw, device="cpu")
        assert str(got.value) == str(want.value)


def test_dense_reports_as_the_reference(model):
    jcfg, jparams, tcfg, params = model
    engine = Engine(params, tcfg, **ENGINE, device="cpu")
    want = JaxEngine(jparams, jcfg, **ENGINE).info()["engine"]
    got = engine.info()["engine"]
    for key in ("paged", "kv_block", "kv_blocks", "pipeline_depth",
                "penalties", "n_slots", "max_len", "chunk"):
        assert got[key] == want[key], key
    assert (got["paged"], got["kv_block"], got["pipeline_depth"]) == (
        False, 0, 2)
    stats = engine.stats()
    assert stats["kv_blocks_total"] == stats["kv_blocks_used"] == 0
    assert stats["kv_admit_deferrals"] == 0


def test_server_reports_the_reference_fields(model):
    """``/v1/info`` and ``/v1/stats`` of a dense depth-2 engine carry the
    layout and pipeline fields under the reference engine's names, with
    its values for an idle engine of the same shape."""
    jcfg, jparams, tcfg, params = model
    ref = JaxEngine(jparams, jcfg, **ENGINE)
    server = ServeServer(Engine(params, tcfg, **ENGINE, device="cpu"))
    server.start()
    try:
        def get(path):
            url = f"http://127.0.0.1:{server.port}{path}"
            with urllib.request.urlopen(url, timeout=30) as resp:
                return json.loads(resp.read())

        info, stats = get("/v1/info")["engine"], get("/v1/stats")
    finally:
        server.stop()
    want_info, want_stats = ref.info()["engine"], ref.stats()
    for key in ("paged", "kv_block", "kv_blocks", "pipeline_depth",
                "penalties"):
        assert info[key] == want_info[key], key
    for key in ("pipeline_depth", "inflight_dispatches", "tail_elisions",
                "readback_seconds", "overlap_seconds", "overlap_ratio",
                "dispatch_seconds", "device_idle_seconds", "readbacks",
                "kv_block_size", "kv_blocks_total", "kv_blocks_used",
                "kv_admit_deferrals"):
        assert stats[key] == want_stats[key], key


# ---------------------------------------------------------------------------
# serve_main


def test_serve_main_defaults_match_reference():
    """Every flag both parsers have takes the reference's default; the
    engine and model-family flags are among them."""
    port = vars(serve_main.build_parser().parse_args([]))
    ref = vars(jax_serve_main.build_parser().parse_args([]))
    shared = set(port) & set(ref)
    assert {"pipeline_depth", "kv_block", "kv_blocks", "no_penalties",
            "sliding_window", "rope_scaling", "mlp_act", "norm_offset",
            "embed_scale", "n_slots", "max_len", "chunk", "top_k", "top_p",
            "kv_int8", "max_queue", "norm_eps", "attn_bias"} <= shared
    assert {k: port[k] for k in shared} == {k: ref[k] for k in shared}


@pytest.mark.parametrize("flags", [
    [],
    ["--sliding-window", "5", "--rope-scaling", "8", "1", "4", "32",
     "--mlp-act", "gelu_tanh", "--norm-offset", "--embed-scale",
     "--no-penalties", "--kv-block", "8", "--pipeline-depth", "1",
     "--kv-int8", "--rope-theta", "500000"],
], ids=["defaults", "family"])
def test_serve_main_builds_the_reference_config(flags):
    """The same flags give the same TransformerConfig fields and the
    same engine layout, depth and penalties as the reference's
    ``make_engine``."""
    ref = jax_serve_main.make_engine(
        jax_serve_main.build_parser().parse_args(TINY + flags))
    args = serve_main.build_parser().parse_args(
        TINY + flags + ["--device", "cpu"])
    engine = serve_main.make_engine(args)
    port_fields = dataclasses.asdict(engine.cfg)
    ref_fields = dataclasses.asdict(ref.cfg)
    shared = set(port_fields) & set(ref_fields)
    assert {"sliding_window", "rope_scaling", "mlp_act", "norm_offset",
            "embed_scale", "rope_theta", "attn_bias", "d_ff"} <= shared
    assert {k: port_fields[k] for k in shared} == {
        k: ref_fields[k] for k in shared}
    for name in ("paged", "kv_block", "pipeline_depth", "penalties",
                 "kv_int8"):
        assert getattr(engine, name) == getattr(ref, name), name


def test_no_penalties_engine(model):
    """``penalties=False`` keeps no count state, serves greedy streams
    unchanged and refuses a penalised request as the reference does."""
    jcfg, jparams, tcfg, params = model
    engine = Engine(params, tcfg, **ENGINE, penalties=False, device="cpu")
    assert engine._tok_counts is None and engine._gen_counts is None
    assert not engine.info()["engine"]["penalties"]
    ref = JaxEngine(jparams, jcfg, **ENGINE, penalties=False)
    for kw in (dict(repetition_penalty=1.2), dict(presence_penalty=0.5),
               dict(frequency_penalty=0.1)):
        with pytest.raises(ValueError) as want:
            ref.submit(JaxRequest(tokens=[1, 2], max_new_tokens=2, **kw))
        with pytest.raises(ValueError) as got:
            engine.submit(GenRequest(tokens=[1, 2], max_new_tokens=2, **kw))
        assert str(got.value) == str(want.value)
    prompt = _prompts(11, [9])[0]
    got = _serve(engine, GenRequest, [prompt], [10])[0]
    want = tdecode.generate(params, torch.tensor([prompt]), tcfg, 10)
    assert got == want[0, len(prompt):].tolist()
