"""Shared pieces of the port's sharded-serving tests: the small models,
their requests and cases, and the engines they are held against.

The params are drawn by the port's seeded ``init_params`` (q/k/v biases
random) and handed to both packages as the reference's numpy tree, so
the JAX engine on its mesh, the port's single-device engine and the
port's ranks (``tests/torch_tp_worker.py``) compute one function.  All
f32 at tiny widths.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from oim_tpu.models import TransformerConfig as JaxConfig
from oim_tpu.ops.quant import quantize_params_int8 as jax_quant_int8
from oim_tpu.parallel import build_mesh as jax_build_mesh
from oim_tpu.serve import Engine as JaxEngine
from oim_tpu.serve import GenRequest as JaxRequest

from oim_tpu_torch.models.transformer import TransformerConfig, init_params
from oim_tpu_torch.models.weights import from_jax_params, to_jax_params
from oim_tpu_torch.serve.engine import Engine, GenRequest
from torch_tp_worker import quantized

# Qwen2-style (biases, GQA 4/2), an even vocab: wte/wlm shard over tp.
CFG = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=64, attn_bias=True, dtype="float32")
DRAFT = dict(vocab_size=128, d_model=16, n_layers=1, n_heads=2, d_ff=32,
             dtype="float32")
# Mixtral-style routing (4 experts, top 2) at an odd vocab: wte/wlm
# replicate under the reference's fitted rule.
MOE = dict(vocab_size=101, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=64, n_experts=4, moe_top_k=2, dtype="float32")
# One prompt bucket and one admission wave keep the JAX engines'
# compiles few.
ENGINE = dict(n_slots=4, max_len=64, chunk=4, prompt_buckets=(32,))
# The prefix cases: two slots, a long prompt, 16-token segments.
PREFIX_ENGINE = dict(ENGINE, n_slots=2, prompt_buckets=(16, 48))


def prompt(seed: int, n: int, vocab: int = 101) -> list[int]:
    return np.random.RandomState(seed).randint(0, vocab, n).tolist()


def echo(n: int) -> list[int]:
    return ([7, 21, 40, 3] * n)[:n]


GREEDY = [dict(tokens=prompt(50, 7), max_new_tokens=6),
          dict(tokens=echo(12), max_new_tokens=8),
          dict(tokens=prompt(52, 20), max_new_tokens=7)]
SAMPLED = [dict(tokens=prompt(51, 13), max_new_tokens=5, temperature=0.7,
                seed=3),
           dict(tokens=prompt(53, 9), max_new_tokens=6, temperature=0.9,
                top_p=0.8, seed=5)]
SHARED = prompt(60, 24)
# Two slots: the shared prompt's second request waits for the first's
# slot, by when its prefix is stored.
PREFIX = [dict(tokens=SHARED, max_new_tokens=5, cache_prefix=True),
          dict(tokens=prompt(63, 40), max_new_tokens=4),
          dict(tokens=SHARED + prompt(62, 5), max_new_tokens=5)]
PENALTY = [dict(tokens=echo(10), max_new_tokens=6, repetition_penalty=1.4,
                presence_penalty=0.3, frequency_penalty=0.2)]

# The dense model's cases: name → (engine arguments, weight quant,
# requests, draft model?).
CASES = {
    "plain": (dict(ENGINE), "", GREEDY + SAMPLED, False),
    "kv_int8": (dict(ENGINE, kv_int8=True), "", GREEDY + SAMPLED, False),
    "weights_int8": (dict(ENGINE), "int8", GREEDY + SAMPLED, False),
    "int4": (dict(ENGINE, kv_block=16, kv_int4=True), "int4:16",
             GREEDY + SAMPLED, False),
    # wo's 16 rows a rank split its 32-row groups: wo stays whole and
    # its input is gathered over tp.
    "int4_gathered": (dict(ENGINE), "int4:32", GREEDY, False),
    "paged_prefix": (dict(PREFIX_ENGINE, kv_block=16, prefix_cache_size=2,
                          prefill_chunk=16, pipeline_depth=1), "",
                     PREFIX + SAMPLED, False),
    "dense_prefix": (dict(PREFIX_ENGINE, prefix_cache_size=2), "", PREFIX,
                     False),
    "spec_lookup": (dict(ENGINE, spec_decode=3, penalties=False), "",
                    GREEDY + SAMPLED, False),
    "spec_draft": (dict(ENGINE, spec_decode=3, penalties=False), "",
                   GREEDY + SAMPLED, True),
    "penalties": (dict(ENGINE), "", PENALTY + GREEDY[:1], False),
}


@functools.cache
def tree(fields: tuple, seed: int) -> dict:
    """The reference's numpy params of the config ``dict(fields)``."""
    cfg = TransformerConfig(**dict(fields))
    out = {name: t.numpy() for name, t in
           to_jax_params(init_params(seed, cfg), cfg).items()}
    rng = np.random.RandomState(seed)
    for name in ("bq", "bk", "bv"):
        if name in out:
            out[name] = (rng.randn(*out[name].shape) * 0.1).astype(
                np.float32)
    return out


def model_tree(fields: dict, seed: int = 0) -> dict:
    return tree(tuple(sorted(fields.items())), seed)


def draft_case() -> dict:
    return {"cfg": DRAFT, "tree": model_tree(DRAFT, 7)}


def case(name: str, fields: dict = CFG, cases: dict = CASES) -> dict:
    """One case as the ranks take it (``torch_tp_worker.run_case``)."""
    engine, weights, requests, draft = cases[name]
    out = {"name": name, "cfg": fields, "tree": model_tree(fields),
           "engine": engine, "weights": weights, "requests": requests}
    if draft:
        out["draft"] = draft_case()
    return out


def port_single(c: dict) -> tuple:
    """(tokens, logprobs) of the port's single-device engine on case
    ``c``."""
    cfg = TransformerConfig(**c["cfg"])
    params = quantized(from_jax_params(c["tree"], cfg), c["weights"])
    kw = dict(c["engine"])
    if "draft" in c:
        dcfg = TransformerConfig(**c["draft"]["cfg"])
        kw.update(draft_cfg=dcfg,
                  draft_params=from_jax_params(c["draft"]["tree"], dcfg))
    engine = Engine(params, cfg, device="cpu", **kw)
    rids = [engine.submit(GenRequest(**r)) for r in c["requests"]]
    engine.run()
    full = [engine.result_full(rid) for rid in rids]
    return [list(t) for t, _ in full], [list(lp) for _, lp in full]


def greedy_rows(c: dict, tokens: list) -> list:
    return [t for t, r in zip(tokens, c["requests"])
            if not r.get("temperature")]


def jax_mesh(c: dict, tp: int, ep: int = 1) -> list:
    """Greedy tokens of the JAX engine on its own tp×ep mesh (virtual
    CPU devices) on case ``c``."""
    params = {k: jnp.asarray(v) for k, v in c["tree"].items()}
    if c["weights"] == "int8":
        params = jax_quant_int8(params)
    kw = dict(c["engine"])
    if "draft" in c:
        kw.update(draft_cfg=JaxConfig(**c["draft"]["cfg"], use_pallas=False),
                  draft_params={k: jnp.asarray(v)
                                for k, v in c["draft"]["tree"].items()})
    mesh = jax_build_mesh(tp=tp, ep=ep, devices=jax.devices()[:tp * ep])
    engine = JaxEngine(params, JaxConfig(**c["cfg"], use_pallas=False),
                       mesh=mesh, **kw)
    greedy = [r for r in c["requests"] if not r.get("temperature")]
    rids = [engine.submit(JaxRequest(**r)) for r in greedy]
    results = engine.run()
    return [results[rid] for rid in rids]
