"""Tensor-parallel serving in the port: two spawned gloo ranks against
the port's single-device engine and the JAX engine on its tp=2 mesh.

The counterpart of ``tests/test_serve.py``'s mesh cases.  The same
numpy params (``tests/torch_tp_cases.py``: Qwen2-style q/k/v biases,
GQA 4/2, an even vocab so that ``wte``/``wlm`` shard over ``tp``, f32)
go through the port's engine over two ranks (``tests/torch_tp_worker.py``;
one group for the module, every case on it), the port's engine on one
device and, for the plain case, the JAX engine on a tp=2 mesh of
virtual CPU devices (``tests/test_torch_tp_jax.py`` holds the rest of
the JAX cases).  Greedy and sampled streams and their logprobs
equal the single-device engine's in every case — int8 KV, int8 and int4
weights (int4 at a group that keeps ``wo`` whole, its input gathered),
the paged pool with the prefix cache and chunked prefill at depth 1, the
dense prefix cache, prompt-lookup and draft-model speculation,
penalties — greedy tokens the JAX engine's, and every rank's final
buffers are bitwise rank 0's.  Indivisible heads are refused with the
reference's message.  The host tier, shipping, migration, weights,
beam and embed under a mesh are ``tests/test_torch_tp_io*.py``'s and
``tests/test_torch_tp_ship.py``'s.
"""

import numpy as np
import pytest

from oim_tpu_torch.models.transformer import TransformerConfig
from oim_tpu_torch.models.weights import rank_config, serve_specs
from torch_cpu_threads import one_torch_thread  # noqa: F401
from torch_tp_cases import (
    CASES,
    CFG,
    case,
    greedy_rows,
    jax_mesh,
    model_tree,
    port_single,
)
from torch_tp_worker import RankGroup, same_buffers

# name → (case fields over the plain one's, the message rank 0 raises)
REFUSALS = {
    "heads": (dict(cfg=dict(CFG, d_model=48, n_heads=3, n_kv_heads=0)),
              "must divide by mesh tp=2"),
}


def _refusal(name: str) -> dict:
    over, _ = REFUSALS[name]
    out = dict(case("plain"), name=f"refuse_{name}", requests=[])
    out.update(over)
    out["tree"] = model_tree(out["cfg"])
    return out


class _Runs:
    """Every case handed to one spawned tp=2 group at once; ``get``
    collects their answers ({name: [rank answers]}) at first use, so the
    JAX engines' tests run while the ranks work."""

    def __init__(self, tmp_dir: str):
        self.cases = [case(n) for n in CASES] + [_refusal(n)
                                                  for n in REFUSALS]
        self.group = RankGroup(2, tmp_dir, tp=2)
        self.group.submit(self.cases)
        self.answers = None

    def get(self) -> dict:
        if self.answers is None:
            self.answers = self.group.collect([c["name"]
                                               for c in self.cases])
        return self.answers


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    runs = _Runs(str(tmp_path_factory.mktemp("tp2")))
    try:
        yield runs
    finally:
        runs.group.close()


def test_tp_engine_matches_jax_mesh(runs):
    """Greedy tokens of the port's tp=2 engine equal the JAX engine's on
    its own tp=2 mesh."""
    c = case("plain")
    want = jax_mesh(c, tp=2)
    assert greedy_rows(c, runs.get()["plain"][0]["tokens"]) == want


@pytest.mark.parametrize("name", list(CASES))
def test_tp_engine_matches_single_device(runs, name):
    """Greedy and sampled streams and logprobs of the tp=2 engine equal
    the single-device engine's; every rank ends with rank 0's buffers."""
    answers = runs.get()[name]
    assert [a.get("error") for a in answers] == [None, None], answers
    tokens, logprobs = port_single(case(name))
    assert answers[0]["tokens"] == tokens, name
    np.testing.assert_allclose(
        np.concatenate([np.asarray(x) for x in answers[0]["logprobs"]]),
        np.concatenate([np.asarray(x) for x in logprobs]), atol=1e-4)
    assert same_buffers(answers) == [], name
    assert answers[0]["info"]["tp"] == 2 and answers[0]["info"]["ep"] == 1


def test_tp_paths_took_their_routes(runs):
    """The cases exercised what they name: a prefix hit on both cache
    layouts, drafts under both speculation sources, accepted ones from
    prompt lookup (the random draft model's are rejected, exactly)."""
    answers = runs.get()
    assert answers["paged_prefix"][0]["stats"]["prefix_hits"] == 1
    assert answers["dense_prefix"][0]["stats"]["prefix_hits"] == 1
    for name in ("spec_lookup", "spec_draft"):
        assert answers[name][0]["stats"]["spec_drafted"] > 0
    assert answers["spec_lookup"][0]["stats"]["spec_accepted"] > 0


@pytest.mark.parametrize("name", list(REFUSALS))
def test_tp_refusals(runs, name):
    """Indivisible heads raise on rank 0 with the reference's
    message."""
    answer = runs.get()[f"refuse_{name}"][0]
    assert REFUSALS[name][1] in (answer.get("error") or ""), answer


class _Mesh:
    """The sizes and index a rank-0 view of a tp=2 mesh reports."""

    shape = {"dp": 1, "pp": 1, "sp": 1, "tp": 2, "ep": 1}

    def axis_size(self, axes):
        axes = (axes,) if isinstance(axes, str) else axes
        return int(np.prod([self.shape[a] for a in axes]))

    def axis_index(self, axes):
        return 0


def test_rank_config_shards_by_logical_axes():
    """The rank-local config and specs: heads, kv heads, MLP and vocab
    over tp, the int4 group rule, the weight-quant companions, and the
    reference's ``fitted`` rule (an odd vocab replicates ``wte``/``wlm``)."""
    cfg = TransformerConfig(**CFG)
    specs = serve_specs(cfg, _Mesh())
    assert specs["wq"] == (None, "tp") and specs["wo"] == ("tp", None)
    assert specs["wte"] == ("tp", None) and specs["wlm"] == (None, "tp")
    assert specs["bk"] == ("tp",) and specs["attn_norm"] == (None,)
    local = rank_config(cfg, _Mesh(), specs)
    assert (local.n_heads, local.kv_heads, local.ff_dim) == (2, 1, 32)
    assert local.head_dim == cfg.head_dim and local.vocab_shard
    assert local.row_psum == {"wo", "w_out"} and not local.row_gather
    odd = TransformerConfig(**dict(CFG, vocab_size=101))
    assert serve_specs(odd, _Mesh())["wte"] == (None, None)
    # int4 at a group the shard's rows do not hold whole: wo replicates
    # and its input is gathered; w_out's 32 rows a rank hold 32-row groups.
    specs4 = serve_specs(cfg, _Mesh(), "int4", 32)
    assert specs4["wo"] == (None, None) and specs4["w_out"] == ("tp", None)
    assert specs4["wo_wscale"] == (None, None)
    assert rank_config(cfg, _Mesh(), specs4).row_gather == {"wo"}
    assert serve_specs(cfg, _Mesh(), "int8")["w_gate_wscale"] == ("tp",)
