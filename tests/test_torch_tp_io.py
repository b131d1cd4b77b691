"""The host KV tier, beam and embed under a mesh, on the CPU: two
spawned gloo ranks (``tests/torch_tp_worker.py``, one group for the
module) against the port's single-device engine.

The counterpart of the reference's mesh engine doing all of this with no
special code.  Each case runs ``torch_tp_worker.run_script``'s steps on
the tp=2 leader and the same steps on one device
(``tests/torch_tp_cases.py``: Qwen2-style, GQA 4/2 — one kv head a rank
— f32):

- **the host tier**: a prefix demoted under pressure and promoted by
  two hits (one copy-on-write), and a QoS preemption that parks a
  best-effort slot and restores it; greedy and sampled streams and
  logprobs (1e-4) equal the single device's, and so do the tier and byte
  counters — the tier is sized over the whole model's kv heads, each
  rank pinning its share;
- **beam and embed**, and a beam while streams decode on the step
  thread (no deadlock, the streams exact); the tp=2 leader's
  ``/v1/weights`` is byte-equal to one device's;
- ``gather_params`` inverts ``shard_params`` bitwise (plain, int8, int4
  at both group cases, MoE tp·ep: no replicated leaf doubled);
- packed int4 KV still ships nothing and a draft engine does not park.

Every rank's final buffers are bitwise rank 0's.  Shipping and peers are
``tests/test_torch_tp_ship.py``'s, the JAX engine's side
``tests/test_torch_tp_io_jax.py``'s.
"""

import numpy as np
import pytest

from oim_tpu_torch.models.transformer import TransformerConfig, init_params
from oim_tpu_torch.models.weights import gather_params, shard_params
from oim_tpu_torch.ops.quant import quantize_params_int4, quantize_params_int8
from torch_cpu_threads import one_torch_thread  # noqa: F401
from torch_tp_cases import (
    CFG,
    HOST_BYTES,
    IO_CASES,
    MOE,
    GroupRuns,
    io_case,
    rank_views,
    same_streams,
    single_outputs,
)
from torch_tp_worker import digests, same_buffers

CASES = {name: io_case(name) for name in IO_CASES}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    runs = GroupRuns(str(tmp_path_factory.mktemp("tp2io")),
                     list(CASES.values()))
    try:
        yield runs
    finally:
        runs.close()


def _single(name: str) -> list:
    return single_outputs(CASES[name])


@pytest.mark.parametrize("name", ["tier", "qos"])
def test_host_tier_matches_single_device(runs, name):
    """Demotion and promotion, parking and restore at tp=2: every stream
    and logprob, and the tier's block and byte counters, are the single
    device's."""
    got, want = runs.outputs(name), _single(name)
    for g, w in zip(got[:-1], want[:-1]):
        if g is not None:
            same_streams(g, w)
    assert got[-1] == want[-1]
    stats = got[-1]
    if name == "tier":
        assert stats["kv_demotions"] > 0 and stats["kv_promotions"] > 0
        assert stats["prefix_hits"] >= 2
    else:
        assert stats["kv_parks"] >= 2 and stats["qos_preemptions"] >= 2
        assert stats["kv_unparks"] == stats["kv_parks"]


def test_host_tier_is_sized_over_the_whole_model(runs):
    """Each rank holds 1/tp of a block's bytes, but the tier holds as
    many blocks as one device's: the budget counts whole blocks."""
    assert runs.outputs("tier")[-1]["kv_host_blocks_total"] == (
        HOST_BYTES // 2048)


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_ends_with_rank0_buffers(runs, name):
    answers = runs.get()[name]
    assert [a.get("error") for a in answers] == [None, None], answers
    assert same_buffers(answers) == []


def test_beam_and_embed_match_single_device(runs):
    """Beam tokens equal one device's (scores within 1e-4), embed within
    1e-5, and a beam run while five streams decode leaves the streams
    exact."""
    got, want = runs.outputs("solo"), _single("solo")
    for g, w in zip(got[:2], want[:2]):
        assert g[0] == w[0]
        assert abs(g[1] - w[1]) <= 1e-4
    np.testing.assert_allclose(got[2], want[2], atol=1e-5, rtol=0)
    streams, beam = got[3]
    same_streams(streams, want[3][0])
    assert beam[0] == want[0][0]


def test_embeds_from_many_threads_while_streams_decode(runs):
    """More embedding threads than cores beside the step thread, under a
    short switch interval: no record out of order (the ranks' group
    would hang or pair the wrong collectives), the streams exact, every
    vector one device's within 1e-5."""
    (streams, vectors), (want_streams, want_vectors) = (
        runs.outputs("solo")[5], _single("solo")[5])
    same_streams(streams, want_streams)
    np.testing.assert_allclose(np.concatenate(vectors),
                               np.concatenate(want_vectors), atol=1e-5,
                               rtol=0)


def test_weights_stream_is_byte_equal(runs):
    assert runs.outputs("solo")[4] == _single("solo")[4]


def test_int4_kv_and_draft_engines_stay_as_on_one_device(runs):
    """Packed int4 KV refuses to ship; a draft engine does not park."""
    error, park = runs.outputs("int4_kv")
    assert "unsupported on kv_int4" in error
    assert [error, park] == _single("int4_kv")
    park, streams = runs.outputs("draft")
    assert park is False
    same_streams(streams, _single("draft")[1])


def _tree(fields: dict, weights: str) -> tuple:
    cfg = TransformerConfig(**fields)
    params = init_params(0, cfg)
    if weights == "int8":
        params = quantize_params_int8(params)
    elif weights:
        params = quantize_params_int4(params, int(weights[5:]))
    return cfg, params


@pytest.mark.parametrize("fields,weights,sizes", [
    (CFG, "", dict(tp=2)), (CFG, "int8", dict(tp=2)),
    (CFG, "int4:16", dict(tp=2)), (CFG, "int4:32", dict(tp=2)),
    (dict(CFG, vocab_size=101), "", dict(tp=2)),
    (MOE, "", dict(tp=2, ep=2)), (MOE, "int8", dict(tp=2, ep=2)),
], ids=["plain", "int8", "int4_g16", "int4_g32_wo_whole", "odd_vocab",
        "moe_tp2ep2", "moe_int8"])
def test_gather_params_inverts_shard_params(fields, weights, sizes):
    """Every rank's shard, gathered, is the whole tree bit for bit: no
    leaf doubled (the replicated ones are rank 0's), none missing."""
    cfg, params = _tree(fields, weights)
    views = rank_views(**sizes)
    shards = [shard_params(params, cfg, view) for view in views]
    whole = gather_params(shards, cfg, views[0])
    assert digests(whole) == digests(params)
