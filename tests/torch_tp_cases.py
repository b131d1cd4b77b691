"""Shared pieces of the port's sharded-serving tests: the small models,
their requests and cases, and the engines they are held against.  JAX
is imported only by the functions that build its engines, so that a
module of the port's engines alone starts without it.

The params are drawn by the port's seeded ``init_params`` (q/k/v biases
random) and handed to both packages as the reference's numpy tree, so
the JAX engine on its mesh, the port's single-device engine and the
port's ranks (``tests/torch_tp_worker.py``) compute one function.  All
f32 at tiny widths.
"""

import functools
import os

import numpy as np

from oim_tpu_torch.models.transformer import TransformerConfig, init_params
from oim_tpu_torch.models.weights import from_jax_params, to_jax_params
from oim_tpu_torch.serve.engine import Engine, GenRequest
from torch_tp_worker import quantized, run_script

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
    import jax
    import jax.numpy as jnp

    from oim_tpu.models import TransformerConfig as JaxConfig
    from oim_tpu.ops.quant import quantize_params_int8 as jax_quant_int8
    from oim_tpu.parallel import build_mesh as jax_build_mesh
    from oim_tpu.serve import Engine as JaxEngine
    from oim_tpu.serve import GenRequest as JaxRequest

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


# ---------------------------------------------------------------------------
# Block I/O under a mesh (``tests/test_torch_tp_io*.py``): the host tier,
# KV shipping, weights, peers, beam and embed.  The steps are
# ``torch_tp_worker.run_script``'s, run alike on the tp=2 leader and on
# the single-device engine.

# The reference's pressure geometry (``tests/test_torch_host_tier.py``):
# a 10-block pool of 8-token blocks, worst cases of 5 blocks, and a host
# tier of 16 whole blocks (a whole block: 2 layers x K, V x 2 kv heads x
# 8 x 8 rows x 4 bytes = 2 KiB), so the tier's size depends on counting
# bytes over the whole model's kv heads.
HOST_BYTES = 16 * 2048
TIER_ENGINE = dict(n_slots=4, max_len=64, chunk=4, prompt_buckets=(16, 32),
                   kv_block=8, kv_blocks=10, prefix_cache_size=2,
                   kv_host_bytes=HOST_BYTES)
QOS_POLICY = ('{"tenants": {"user.gold": {"tier": "premium"}, '
              '"user.lead": {"tier": "best_effort"}}}')
QOS_ENGINE = dict(TIER_ENGINE, n_slots=2, kv_blocks=16, qos=QOS_POLICY)
SHIP_ENGINE = dict(TIER_ENGINE, kv_blocks=16, prompt_buckets=(8, 16, 32))
TIER_KEYS = ["kv_demotions", "kv_promotions", "kv_parks", "kv_unparks",
             "kv_demote_bytes", "kv_promote_bytes", "prefix_demotions",
             "prefix_evictions", "prefix_hits", "kv_host_blocks_total",
             "host_prefix_entries", "qos_preemptions"]
SHIP_KEYS = ["kv_exports", "kv_imports", "kv_ship_bytes", "prefix_exports",
             "prefix_fetch_installs", "slot_exports", "slot_imports",
             "prefix_hits", "prefix_bytes_saved", "kv_holds",
             "kv_imports_staged", "migrated_slots"]

HIT = prompt(1, 16) + prompt(2, 8)
COW_HIT = prompt(1, 16) + prompt(4, 3)
TIER_SCRIPT = [
    ("gen", [dict(tokens=HIT, max_new_tokens=5)]),
    ("gen", [dict(tokens=COW_HIT, max_new_tokens=5, temperature=0.8,
                  seed=11)]),
    ("flush",),
    # Seed an entry, retire it under pressure (demoted), hit it twice
    # (promoted), a sampled stream beside.
    ("gen", [dict(tokens=prompt(1, 16), max_new_tokens=2,
                  cache_prefix=True)]),
    ("gen", [dict(tokens=prompt(100 + i, 16), max_new_tokens=24)
             for i in range(3)]),
    ("gen", [dict(tokens=HIT, max_new_tokens=5),
             dict(tokens=prompt(5, 9), max_new_tokens=5, temperature=0.8,
                  seed=3)]),
    ("gen", [dict(tokens=COW_HIT, max_new_tokens=5, temperature=0.8,
                  seed=11)]),
    ("stats", TIER_KEYS),
]
QOS_LEAD = [dict(tokens=prompt(70, 16), max_new_tokens=40, seed=7,
                 tenant="user.lead"),
            dict(tokens=prompt(71, 16), max_new_tokens=40, seed=9,
                 tenant="user.lead")]
QOS_GOLD = [dict(tokens=prompt(72, 16), max_new_tokens=6, seed=3,
                 tenant="user.gold")]


def _sampled(reqs: list) -> list:
    return [dict(r, temperature=0.8) for r in reqs]


QOS_SCRIPT = [
    ("late", QOS_LEAD, 4, QOS_GOLD),
    ("late", _sampled(QOS_LEAD), 4, _sampled(QOS_GOLD)),
    ("stats", TIER_KEYS),
]

HELD = dict(tokens=prompt(31, 20), max_new_tokens=3)
HELD_FULL = dict(HELD, max_new_tokens=12)
SYSTEM = prompt(7, 16)
PREFIX_HIT = SYSTEM + prompt(8, 5)
SLOT = dict(tokens=prompt(33, 14), max_new_tokens=20, temperature=0.7,
            seed=21)
SOURCE_SCRIPT = [  # what the single-device exporter ships to the ranks
    ("hold", HELD),
    ("gen", [dict(tokens=SYSTEM, max_new_tokens=2, cache_prefix=True)]),
    ("export_prefix", SYSTEM),
    ("suspend", SLOT, 5),
]


def ship_script(held, prefix, slot) -> list:
    """The shipping case's steps, importing the single-device exports
    ``held`` (tokens, manifest, arrays), ``prefix`` and ``slot``
    (manifest, arrays)."""
    prior = len(slot[0]["tokens"])
    return [
        ("hold", HELD),
        ("import_kv", held[1], held[2],
         dict(tokens=HELD["tokens"] + held[0], max_new_tokens=9)),
        ("roundtrip_kv", dict(tokens=prompt(34, 11), max_new_tokens=4)),
        ("gen", [dict(tokens=SYSTEM, max_new_tokens=2, cache_prefix=True)]),
        ("export_prefix", SYSTEM),
        ("flush",),
        ("import_prefix", *prefix),
        ("gen", [dict(tokens=PREFIX_HIT, max_new_tokens=6)]),
        ("roundtrip_prefix", SYSTEM),
        ("suspend", SLOT, 5),
        ("import_slot", *slot, dict(max_new_tokens=SLOT["max_new_tokens"]
                                    - prior, temperature=0.7, seed=21)),
        ("stats", SHIP_KEYS),
    ]


BEAM = (prompt(40, 9), 6, 3)
SOLO_SCRIPT = [
    ("beam", *BEAM),
    ("beam", prompt(41, 5), 4, 2, 0.6, 17),
    ("embed", prompt(42, 11)),
    ("beam_during", GREEDY + SAMPLED, BEAM),
    ("weights",),
    ("storm", GREEDY + SAMPLED, [prompt(43 + i, 5 + i) for i in range(
        (os.cpu_count() or 4) + 2)]),
]
# Still refused or not parking under a mesh, as on one device: packed
# int4 KV ships nothing; a draft engine does not park.
INT4_SCRIPT = [("try", "hold", HELD), ("attr", "kv_park")]
DRAFT_SCRIPT = [("attr", "kv_park"),
                ("gen", [dict(tokens=HIT, max_new_tokens=4)])]

IO_CASES = {
    "tier": (TIER_ENGINE, "", TIER_SCRIPT),
    "qos": (QOS_ENGINE, "", QOS_SCRIPT),
    "solo": (dict(ENGINE), "", SOLO_SCRIPT),
    "int4_kv": (dict(TIER_ENGINE, kv_int4=True), "", INT4_SCRIPT),
    "draft": (dict(TIER_ENGINE, spec_decode=2, penalties=False), "",
              DRAFT_SCRIPT),
}


def io_case(name: str, script=None, engine=None, **over) -> dict:
    """One block I/O case as the ranks take it."""
    eng, weights, steps = IO_CASES.get(name, (engine, "", script))
    out = {"name": name, "cfg": CFG, "tree": model_tree(CFG),
           "engine": eng, "weights": weights,
           "script": script if script is not None else steps}
    if name == "draft":
        out["draft"] = draft_case()
    out.update(over)
    return out


def port_engine(c: dict) -> Engine:
    """The port's single-device engine of case ``c``."""
    from oim_tpu_torch.qos.policy import decode_policy

    cfg = TransformerConfig(**c["cfg"])
    params = quantized(from_jax_params(c["tree"], cfg), c["weights"])
    kw = dict(c["engine"])
    if isinstance(kw.get("qos"), str):
        kw["qos"] = decode_policy(kw["qos"])
    if "draft" in c:
        dcfg = TransformerConfig(**c["draft"]["cfg"])
        kw.update(draft_cfg=dcfg,
                  draft_params=from_jax_params(c["draft"]["tree"], dcfg))
    return Engine(params, cfg, device="cpu", **kw)


class RankView:
    """Rank ``rank``'s view of a mesh of ``sizes`` with no process group:
    what ``shard_params``, ``gather_params`` and ``serve_specs`` read."""

    def __init__(self, rank: int, **sizes):
        from oim_tpu_torch.parallel.mesh import AXES, _coords

        self.shape = {a: sizes.get(a, 1) for a in AXES}
        self.rank = rank
        self._axes = AXES
        self._coords = _coords
        self.size = int(np.prod(list(self.shape.values())))

    def coords_of(self, rank: int) -> dict:
        return dict(zip(self._axes, self._coords(rank, self.shape)))

    def _key(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self._axes if a in axes)

    def axis_size(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in self._key(axes)]))

    def axis_index(self, axes, rank=None) -> int:
        coords = self.coords_of(self.rank if rank is None else rank)
        index = 0
        for a in self._key(axes):
            index = index * self.shape[a] + coords[a]
        return index


def rank_views(**sizes) -> list:
    n = int(np.prod(list(sizes.values())))
    return [RankView(r, **sizes) for r in range(n)]


class GroupRuns:
    """``cases`` handed to one spawned tp=2 group at once (or later, by
    ``submit``, while the ranks start); ``get`` collects every answer at
    first use ({name: [rank answers]}), so the test process works
    meanwhile; ``outputs`` is rank 0's script outputs of a case that
    raised on no rank."""

    def __init__(self, tmp_dir: str, cases: list, **sizes):
        from torch_tp_worker import RankGroup

        self.group = RankGroup(2, tmp_dir, **(sizes or dict(tp=2)))
        self.cases = []
        self.submit(cases)
        self.answers = None

    def submit(self, cases: list) -> None:
        self.cases += cases
        self.group.submit(cases)

    def get(self) -> dict:
        if self.answers is None:
            self.answers = self.group.collect([c["name"]
                                               for c in self.cases])
        return self.answers

    def outputs(self, name: str) -> list:
        answers = self.get()[name]
        assert [a.get("error") for a in answers] == [None, None], answers
        return answers[0]["outputs"]

    def close(self) -> None:
        self.group.close()


_SINGLE: dict = {}


def single_outputs(case: dict) -> list:
    """Case ``case``'s steps on the port's single-device engine (cached
    by name)."""
    if case["name"] not in _SINGLE:
        _SINGLE[case["name"]] = run_script(port_engine(case), case["script"])
    return _SINGLE[case["name"]]


def same_streams(got: list, want: list) -> None:
    """The same tokens, logprobs within 1e-4."""
    assert [t for t, _ in got] == [t for t, _ in want]
    np.testing.assert_allclose(np.concatenate([lp for _, lp in got]),
                               np.concatenate([lp for _, lp in want]),
                               atol=1e-4, rtol=0)


def jax_engine(engine: dict, tp: int = 1):
    """The JAX engine over the plain model's numpy params with ``engine``
    arguments (a QoS policy as its JSON text): one device, or its own tp
    mesh of virtual CPU devices."""
    import jax
    import jax.numpy as jnp

    from oim_tpu.models import TransformerConfig as JaxConfig
    from oim_tpu.parallel import build_mesh as jax_build_mesh
    from oim_tpu.serve import Engine as JaxEngine

    from oim_tpu.qos.policy import decode_policy

    params = {k: jnp.asarray(v) for k, v in model_tree(CFG).items()}
    mesh = None
    if tp > 1:
        mesh = jax_build_mesh(tp=tp, devices=jax.devices()[:tp])
    kw = dict(engine)
    if isinstance(kw.get("qos"), str):
        kw["qos"] = decode_policy(kw["qos"])
    return JaxEngine(params, JaxConfig(**CFG, use_pallas=False), mesh=mesh,
                     **kw)


# ---------------------------------------------------------------------------
# Training over a mesh (tests/test_torch_train_mesh*.py): the small
# models, their batches, the one-device runs they are held against, and
# the assembly of the ranks' blocks into whole tensors.

# Qwen2-style with packed documents (separator 0: the static normalizer
# meets dropped labels), an even vocab (wte/wlm shard over tp).
TRAIN_DENSE = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4,
                   n_kv_heads=2, d_ff=64, attn_bias=True, dtype="float32",
                   doc_sep_id=0)
# Mixtral-style routing: 4 experts, top 2, the router z-loss.
TRAIN_MOE = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4,
                 n_kv_heads=2, d_ff=64, n_experts=4, moe_top_k=2,
                 router_z_loss=1e-3, dtype="float32")
TRAIN_OPT = dict(lr=1e-2, warmup_steps=1, decay_steps=3, weight_decay=0.1,
                 grad_clip=0.0)
TRAIN_B, TRAIN_T, TRAIN_STEPS = 4, 32, 3


def train_batches(vocab: int, steps: int = TRAIN_STEPS, b: int = TRAIN_B,
                  t: int = TRAIN_T, seed: int = 0) -> np.ndarray:
    """[steps, b, t] global batches: the trainer's synthetic corpus cut by
    its loader, the +1 boundary token dropped."""
    from oim_tpu_torch.data.loader import TokenBatches

    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab, size=4000 // 8)
    corpus = ((base[:, None] + np.arange(8)[None, :]) % vocab).reshape(-1)
    batches = TokenBatches(corpus.astype(np.int32), b, t, seed=seed)
    return np.stack([batches.batch_at(s)[:, :t] for s in range(steps)])


def train_case(name: str, mesh: dict, op: str = "steps", **spec) -> dict:
    """A ``torch_tp_worker.run_train_case`` case on a mesh of ``mesh``."""
    return {"name": name, "mesh": mesh, "train": dict(spec, op=op)}


def one_device_run(cfg: dict, opt: dict, batches, seed: int = 0,
                   tree=None, grad_accum: int = 1) -> tuple:
    """(per step [loss, ce, aux], final params by name as numpy) of the
    port's one-device trainer on the same global batches."""
    import torch

    from oim_tpu_torch.models import train as ttrain

    config = TransformerConfig(**{**cfg, "grad_accum": grad_accum})
    params = (from_jax_params(tree, config, master=True) if tree is not None
              else init_params(seed, config, master=True))
    state = ttrain.TrainState.create(params, ttrain.OptimizerConfig(**opt))
    step = ttrain.make_train_step(config, cuda_graph=False)
    metrics = []
    for batch in batches:
        state, m = step(state, torch.from_numpy(batch).long())
        metrics.append([float(m[k]) for k in ("loss", "ce", "aux")])
    return metrics, {n: t.detach().numpy().copy()
                     for n, t in ttrain.named_parameters(state.params)}


def assemble(answers: list, key: str = "blocks", part: int = 1) -> dict:
    """Whole arrays from the ranks' ``(start, array, ...)`` blocks under
    ``key`` (``part`` picks which array of a moment's)."""
    pieces: dict = {}
    for answer in answers:
        if answer is None or answer.get("idle"):
            continue
        for name, entry in answer[key].items():
            pieces.setdefault(name, []).append((entry[0], entry[part]))
    out = {}
    for name, blocks in pieces.items():
        shape = [max(s[d] + a.shape[d] for s, a in blocks)
                 for d in range(blocks[0][1].ndim)]
        whole = np.full(shape, np.nan, dtype=blocks[0][1].dtype)
        for start, arr in blocks:
            whole[tuple(slice(s, s + n) for s, n in zip(start, arr.shape))] \
                = arr
        assert not np.isnan(whole).any(), name
        out[name] = whole
    return out


def replicas_differ(answers: list) -> list:
    """The leaves of which two ranks hold the same region with other
    bits (a replicated leaf must be bitwise one on every rank)."""
    seen, bad = {}, []
    for answer in answers:
        if answer is None or answer.get("idle"):
            continue
        for name, (start, arr) in answer["blocks"].items():
            key = (name, tuple(start), arr.shape)
            if key in seen and seen[key] != arr.tobytes():
                bad.append(name)
            seen.setdefault(key, arr.tobytes())
    return sorted(set(bad))


# The reference's side of tests/test_torch_train_mesh_jax*.py: its
# trainer's optimizer and its train step on its own mesh of virtual CPU
# devices (JAX imported here only).
JAX_TRAIN_OPT = dict(lr=1e-2, warmup_steps=1, decay_steps=3,
                     weight_decay=0.1, grad_clip=1.0)


def jax_chain(opt: dict):
    """The reference trainer's optimizer (oim_tpu/cli/train_main.py)."""
    import optax

    lr = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=opt["lr"],
        warmup_steps=max(opt["warmup_steps"], 1),
        decay_steps=opt["warmup_steps"] + opt["decay_steps"])
    adamw = optax.adamw(
        lr, weight_decay=opt["weight_decay"],
        mask=lambda params: {n: not n.endswith("_norm") for n in params})
    return optax.chain(optax.clip_by_global_norm(opt["grad_clip"]), adamw)


def jax_flat(tree: dict, n_layers: int) -> dict:
    """Reference params (stacked [1, L, ...]) by the port's names."""
    out = {}
    for name, value in tree.items():
        value = np.asarray(value)
        if name in ("wte", "final_norm", "wlm"):
            out[name] = value
        else:
            value = value.reshape(n_layers, *value.shape[2:])
            for i in range(n_layers):
                out[f"layers.{i}.{name}"] = value[i]
    return out


def jax_initial(cfg: dict) -> dict:
    """The reference's seeded initialisation of ``cfg``, host numpy."""
    import jax

    from oim_tpu.models import TransformerConfig as JConfig
    from oim_tpu.models import init_params as j_init_params

    tree = j_init_params(jax.random.PRNGKey(0), JConfig(**cfg))
    return {k: np.asarray(v) for k, v in jax.device_get(tree).items()}


def jax_mesh_train(cfg: dict, sizes: dict, zero1: bool, host: dict,
                   batches) -> tuple:
    """(per-step [loss, ce], final params by the port's names) of the
    reference's ``make_train_step`` on ``build_mesh(**sizes)`` from
    ``host``, ZeRO-1 through ``shard_state`` as asked; each dp block of
    the global array on its dp rank."""
    import jax

    from oim_tpu.models import TrainState as JTrainState
    from oim_tpu.models import TransformerConfig as JConfig
    from oim_tpu.models import make_train_step as j_make_train_step
    from oim_tpu.models.train import data_pspec, shard_state
    from oim_tpu.parallel import build_mesh as jax_build_mesh

    jcfg = JConfig(**cfg)
    n = int(np.prod(list(sizes.values())))
    mesh = jax_build_mesh(**sizes, devices=jax.devices()[:n])
    chain = jax_chain(JAX_TRAIN_OPT)
    tree = {k: jax.numpy.asarray(v) for k, v in host.items()}
    state = shard_state(JTrainState.create(tree, chain), jcfg, mesh,
                        zero1=zero1)
    step = j_make_train_step(jcfg, mesh, chain)
    sharding = jax.sharding.NamedSharding(mesh, data_pspec())
    metrics = []
    for tokens in batches:
        state, m = step(state, jax.device_put(tokens, sharding))
        metrics.append([float(m[k]) for k in ("loss", "ce")])
    return metrics, jax_flat(jax.device_get(state.params), jcfg.n_layers)


def mesh_against_jax(tmp_dir: str, name: str, cfg: dict, sizes: dict,
                     zero1: bool) -> tuple:
    """(the port's ranks' answers, the reference's (metrics, params)) on
    one mesh: four spawned ranks from the reference's initialisation,
    the reference running while they do."""
    from torch_tp_worker import RankGroup

    host, batches = jax_initial(cfg), train_batches(cfg["vocab_size"])
    group = RankGroup(4, tmp_dir, **sizes)
    try:
        group.submit([train_case(name, sizes, cfg=cfg, opt=JAX_TRAIN_OPT,
                                 zero1=zero1, batches=batches, tree=host)])
        want = jax_mesh_train(cfg, sizes, zero1, host, batches)
        answers = group.collect([name])[name]
    finally:
        group.close()
    for answer in answers:
        assert "error" not in answer, f"{name}: {answer['error']}"
    return answers, want
