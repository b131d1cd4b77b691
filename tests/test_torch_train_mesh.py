"""Training over a dp·tp·ep mesh against one device, on the CPU.

Four spawned ranks (``tests/torch_tp_worker.py``'s ``RankGroup``, gloo,
one PyTorch thread each) train the small models of
``tests/torch_tp_cases.py`` for three steps on meshes of dp=2, tp=2 and
dp=2·tp=2 (dense, Qwen2-style with packed documents) and ep=2 and
tp=2·ep=2 (MoE, top 2 with the router z-loss), each rank from its
block of the same seeded initialisation, each dp rank on its rows of
the same global batches; the port's one-device trainer runs those
batches whole.  A pure dp mesh runs the kernels' plain versions as one
device does; tp and ep the plain layer math with the differentiable
collectives (the reference's gate).

Tolerances are the one-device parity test's (``tests/test_torch_train.py``):
losses within 1e-5 (the same f32 function in another summation order),
parameters within 2e-5 after three AdamW steps at lr 1e-2 (Adam divides
by sqrt(v): an element whose gradient is near zero takes a step that
depends on its last bits).  What must be exact is exact: the
initialisation cut up, replicated leaves across ranks after every step,
and ZeRO-1's trajectory against the unsharded update on the same mesh.
"""

import numpy as np
import pytest

from oim_tpu_torch.cli import train_main
from oim_tpu_torch.data.loader import ShardSpec, TokenBatches
from oim_tpu_torch.models.transformer import TransformerConfig, init_params
from oim_tpu_torch.models.train import named_parameters, zero1_dim
from torch_cpu_threads import one_torch_thread  # noqa: F401
from torch_tp_cases import (
    TRAIN_DENSE,
    TRAIN_MOE,
    TRAIN_OPT,
    assemble,
    one_device_run,
    replicas_differ,
    train_batches,
    train_case,
)
from torch_tp_worker import RankGroup

DP2, TP2, DP2TP2 = dict(dp=2), dict(tp=2), dict(dp=2, tp=2)
EP2, TP2EP2 = dict(ep=2), dict(tp=2, ep=2)
CLIP = dict(TRAIN_OPT, grad_clip=0.05)
DENSE_BATCHES = train_batches(TRAIN_DENSE["vocab_size"])
MOE_BATCHES = train_batches(TRAIN_MOE["vocab_size"])
# name → (mesh, model, optimizer, extra spec); one mesh at a time, in
# this order, so the group re-forms four times.
CASES = {
    "dense_dp2tp2": (DP2TP2, TRAIN_DENSE, TRAIN_OPT, {"init": True}),
    "clip_dp2tp2": (DP2TP2, TRAIN_DENSE, CLIP, {}),
    "dense_dp2": (DP2, TRAIN_DENSE, TRAIN_OPT, {}),
    "zero1_dp2": (DP2, TRAIN_DENSE, TRAIN_OPT, {"zero1": True}),
    "accum_dp2": (DP2, dict(TRAIN_DENSE, grad_accum=2), TRAIN_OPT, {}),
    "dense_tp2": (TP2, TRAIN_DENSE, TRAIN_OPT, {}),
    "moe_ep2": (EP2, TRAIN_MOE, TRAIN_OPT, {}),
    "moe_tp2ep2": (TP2EP2, TRAIN_MOE, TRAIN_OPT, {}),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    group = RankGroup(4, str(tmp_path_factory.mktemp("train-mesh")),
                      **DP2TP2)
    try:
        cases = [train_case(name, mesh, cfg=cfg, opt=opt,
                            batches=MOE_BATCHES if cfg is TRAIN_MOE
                            else DENSE_BATCHES, seed=0, **extra)
                 for name, (mesh, cfg, opt, extra) in CASES.items()]
        group.submit(cases)
        out = group.collect(list(CASES))
    finally:
        group.close()
    for name, answers in out.items():
        for answer in answers:
            assert "error" not in answer, f"{name}: {answer['error']}"
    return out


def _one_device(name: str, **kw):
    _, cfg, opt, _ = CASES[name]
    batches = MOE_BATCHES if cfg is TRAIN_MOE else DENSE_BATCHES
    cfg = {k: v for k, v in cfg.items() if k != "grad_accum"}
    return one_device_run(cfg, opt, batches, **kw)


def _metrics(answers: list) -> np.ndarray:
    return np.array(answers[0]["metrics"])


def _close_to(answers: list, want_metrics, want_params,
              columns=(0, 1, 2)) -> None:
    np.testing.assert_allclose(_metrics(answers)[:, columns],
                               np.array(want_metrics)[:, columns], rtol=0,
                               atol=1e-5)
    got = assemble(answers)
    assert set(got) == set(want_params)
    for name, value in got.items():
        np.testing.assert_allclose(value, want_params[name], rtol=0,
                                   atol=2e-5, err_msg=name)


@pytest.mark.parametrize("name", ["dense_dp2", "dense_tp2", "dense_dp2tp2",
                                  "moe_ep2", "moe_tp2ep2"])
def test_three_steps_match_one_device(runs, name):
    """Losses, ce and aux of the whole batch on every rank, and the
    parameters gathered from the ranks' blocks."""
    answers = runs[name]
    want_metrics, want_params = _one_device(name)
    _close_to(answers, want_metrics, want_params)
    live = [a for a in answers if not a.get("idle")]
    for other in live[1:]:
        assert other["metrics"] == live[0]["metrics"]
    if name.startswith("moe"):
        assert min(m[2] for m in live[0]["metrics"]) > 1.0  # aux counted


def test_initialisation_is_one_device_cut_up(runs):
    """Each rank's blocks of the seeded initialisation are the one-device
    tensors' regions, bit for bit."""
    cfg = TransformerConfig(**TRAIN_DENSE)
    whole = dict(named_parameters(init_params(0, cfg, master=True)))
    sharded = 0
    for answer in runs["dense_dp2tp2"]:
        for name, (start, block) in answer["init"].items():
            want = whole[name].numpy()[tuple(
                slice(s, s + n) for s, n in zip(start, block.shape))]
            assert block.tobytes() == want.tobytes(), name
            sharded += block.shape != want.shape or block.shape != tuple(
                whole[name].shape)
    assert sharded  # some leaf was cut


@pytest.mark.parametrize("name", list(CASES))
def test_replicated_leaves_bitwise_equal_after_every_step(runs, name):
    """Every region two ranks both hold has one value on both after
    each step: replicated leaves (norms, router, biases of whole heads)
    get whole gradients everywhere, and the dp sum is one sum."""
    answers = [a for a in runs[name] if not a.get("idle")]
    for step in range(len(answers[0]["digests"])):
        seen = {}
        for answer in answers:
            for leaf, (start, digest) in answer["digests"][step].items():
                key = (leaf, tuple(start))
                assert seen.setdefault(key, digest) == digest, (step, leaf)
    assert replicas_differ(answers) == []


def test_grad_accum_2_at_dp2_equals_the_full_batch(runs):
    """Two sequential microbatches a dp rank: the one-device run of the
    whole batch in one pass — its loss and parameters (``ce`` is the
    microbatches' mean ratio, which packing moves off the batch's)."""
    want_metrics, want_params = _one_device("accum_dp2")
    _close_to(runs["accum_dp2"], want_metrics, want_params, columns=(0, 2))


def test_zero1_takes_the_unsharded_trajectory(runs):
    """ZeRO-1 at dp=2: losses and parameters bit for bit the unsharded
    update's on the same mesh (the fused AdamW on a slice is the
    elementwise update of that slice)."""
    plain, zero1 = runs["dense_dp2"], runs["zero1_dp2"]
    assert _metrics(zero1).tolist() == _metrics(plain).tolist()
    got, want = assemble(zero1), assemble(plain)
    for name in want:
        assert got[name].tobytes() == want[name].tobytes(), name
    moments, unsharded = assemble(zero1, "moments"), assemble(plain,
                                                              "moments")
    for name in unsharded:
        np.testing.assert_array_equal(moments[name], unsharded[name])


def test_zero1_moment_bytes_fall_by_dp(runs):
    """Each rank holds 1/dp of the moments of every leaf with a
    dimension dp divides, whole moments of the rest."""
    cfg = TransformerConfig(**TRAIN_DENSE)
    shapes = {n: tuple(t.shape)
              for n, t in named_parameters(init_params(0, cfg, master=True))}
    for answer in runs["zero1_dp2"][:2]:
        for name, (_, exp_avg, exp_avg_sq, _) in answer["moments"].items():
            divides = any(n % 2 == 0 for n in shapes[name])
            want = np.prod(shapes[name]) // (2 if divides else 1)
            assert exp_avg.size == exp_avg_sq.size == want, name
    plain = runs["dense_dp2"][0]["moment_bytes"]
    assert runs["zero1_dp2"][0]["moment_bytes"] * 2 == plain


def test_zero1_cuts_along_the_reference_dimension():
    """The first dimension no axis cuts that dp divides; none: whole."""
    class Mesh:
        shape = {"dp": 2, "pp": 1, "sp": 1, "tp": 2, "ep": 1}

    assert zero1_dim((128, 32), ("tp", None), Mesh()) == 1
    assert zero1_dim((32, 64), (None, "tp"), Mesh()) == 0
    assert zero1_dim((3, 5), (None, None), Mesh()) is None
    Mesh.shape = dict(Mesh.shape, tp=1)
    assert zero1_dim((128, 32), ("tp", None), Mesh()) == 0


def test_clip_at_dp2tp2_equals_one_device(runs):
    """``clip_by_global_norm`` over sharded and replicated leaves takes
    the whole gradient's norm: the clipped one-device run, which the
    bound changes."""
    want_metrics, want_params = _one_device("clip_dp2tp2")
    _close_to(runs["clip_dp2tp2"], want_metrics, want_params)
    _, unclipped = _one_device("dense_dp2tp2")
    assert max(np.abs(unclipped[n] - want_params[n]).max()
               for n in want_params) > 1e-3  # the bound acted


def test_dp_ranks_feed_the_global_batch():
    """``train_main``'s rows a dp rank (``ShardSpec(dp index, dp)``; its
    tp/ep peers the same) together are the one-device batch: rank r
    holds rows r::dp, and their concatenation in rank order is the
    global array the reference's multi-process feed assembles."""
    corpus = np.arange(5000, dtype=np.int32) % 97
    whole = TokenBatches(corpus, 8, 16, seed=3)

    class Mesh:
        shape = {"dp": 2, "pp": 1, "sp": 1, "tp": 2, "ep": 1}

        def __init__(self, dp):
            self.dp = dp

        def axis_index(self, axis):
            return self.dp

    for step in (0, 5):
        ranks = [TokenBatches(corpus, 8, 16, train_main._shard(Mesh(r)),
                              seed=3).batch_at(step) for r in range(2)]
        assert train_main._shard(Mesh(1)) == ShardSpec(1, 2)
        want = whole.batch_at(step)
        np.testing.assert_array_equal(np.concatenate(ranks),
                                      np.concatenate([want[0::2],
                                                      want[1::2]]))
