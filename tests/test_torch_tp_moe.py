"""MoE serving over a tp2·ep2 mesh in the port: four spawned gloo ranks
against the port's single-device engine, its solo decode and the JAX
engine on its own tp2·ep2 mesh.

The counterpart of ``tests/test_serve.py::
test_tp_ep_sharded_moe_engine_matches``: heads and the MLP columns over
``tp``, the experts over ``ep`` (each rank runs its two of four experts
for every token, the combine summed over both axes), the router whole on
every rank.  The model (``tests/torch_tp_cases.py::MOE``, f32) has an
odd vocab, which the reference's fitted rule replicates; an even-vocab
case shards ``wte``/``wlm`` over ``tp`` as well.  Greedy and sampled
streams equal the single-device engine's (int8 weights, the paged pool
with int8 KV, prompt lookup too), greedy tokens the solo decode's and
the JAX engine's, and every rank's final buffers are bitwise rank 0's.
Experts that ``ep`` does not divide, and a dense model on an ``ep``
mesh, are refused with the reference's message.
"""

import numpy as np
import pytest
import torch

from oim_tpu_torch.models.decode import generate
from oim_tpu_torch.models.transformer import TransformerConfig
from oim_tpu_torch.models.weights import from_jax_params
from torch_cpu_threads import one_torch_thread  # noqa: F401
from torch_tp_cases import (
    CFG,
    ENGINE,
    GREEDY,
    MOE,
    SAMPLED,
    case,
    greedy_rows,
    jax_mesh,
    model_tree,
    port_single,
)
from torch_tp_worker import RankGroup, same_buffers

MOE_EVEN = dict(MOE, vocab_size=128)
MOE_CASES = {
    "moe": (dict(ENGINE), "", GREEDY + SAMPLED, False),
    "moe_weights_int8": (dict(ENGINE), "int8", GREEDY + SAMPLED, False),
    "moe_paged_kv_int8": (dict(ENGINE, kv_block=16, kv_int8=True), "",
                          GREEDY + SAMPLED, False),
    "moe_spec_lookup": (dict(ENGINE, spec_decode=2, penalties=False), "",
                        GREEDY + SAMPLED, False),
}
FIELDS = {"moe_even_vocab": MOE_EVEN}
MOE_CASES["moe_even_vocab"] = MOE_CASES["moe"]
EP_MESSAGE = "must be a positive multiple of mesh ep=2"
REFUSALS = {"refuse_experts": dict(MOE, n_experts=3, moe_top_k=2),
            "refuse_dense": CFG}


def _case(name: str) -> dict:
    return case(name, FIELDS.get(name, MOE), MOE_CASES)


def _refusal(name: str) -> dict:
    fields = REFUSALS[name]
    return dict(_case("moe"), name=name, cfg=fields, tree=model_tree(fields),
                requests=[])


class _Runs:
    """Every case handed to one spawned tp2·ep2 group at once; ``get``
    collects the answers at first use, so the JAX engine's test runs
    while the ranks work."""

    def __init__(self, tmp_dir: str):
        self.cases = [_case(n) for n in MOE_CASES] + [_refusal(n)
                                                      for n in REFUSALS]
        self.group = RankGroup(4, tmp_dir, tp=2, ep=2)
        self.group.submit(self.cases)
        self.answers = None

    def get(self) -> dict:
        if self.answers is None:
            self.answers = self.group.collect([c["name"]
                                               for c in self.cases])
        return self.answers


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    runs = _Runs(str(tmp_path_factory.mktemp("tp2ep2")))
    try:
        yield runs
    finally:
        runs.group.close()


def test_moe_tp_ep_matches_jax_mesh(runs):
    """Greedy tokens of the port's tp2·ep2 MoE engine equal the JAX
    engine's on its own tp2·ep2 mesh."""
    c = _case("moe")
    want = jax_mesh(c, tp=2, ep=2)
    assert greedy_rows(c, runs.get()["moe"][0]["tokens"]) == want


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_tp_ep_matches_single_device(runs, name):
    """Streams and logprobs equal the single-device engine's; all four
    ranks end with rank 0's buffers."""
    answers = runs.get()[name]
    assert [a.get("error") for a in answers] == [None] * 4, answers
    tokens, logprobs = port_single(_case(name))
    assert answers[0]["tokens"] == tokens, name
    np.testing.assert_allclose(
        np.concatenate([np.asarray(x) for x in answers[0]["logprobs"]]),
        np.concatenate([np.asarray(x) for x in logprobs]), atol=1e-4)
    assert same_buffers(answers) == [], name
    info = answers[0]["info"]
    assert (info["tp"], info["ep"]) == (2, 2)


def test_moe_tp_ep_matches_solo_decode(runs):
    """Greedy rows equal the solo decode's (``models/decode.py``), the
    port's oracle."""
    c = _case("moe")
    cfg = TransformerConfig(**c["cfg"])
    params = from_jax_params(c["tree"], cfg)
    got = greedy_rows(c, runs.get()["moe"][0]["tokens"])
    for r, tokens in zip([r for r in c["requests"]
                          if not r.get("temperature")], got):
        prompt = torch.tensor([r["tokens"]])
        out = generate(params, prompt, cfg, r["max_new_tokens"])
        assert out[0, len(r["tokens"]):].tolist() == tokens


@pytest.mark.parametrize("name", list(REFUSALS))
def test_moe_ep_refusals(runs, name):
    """Experts that ep does not divide, or none, raise the reference's
    message on every rank."""
    for answer in runs.get()[name]:
        assert EP_MESSAGE in (answer.get("error") or ""), answer
