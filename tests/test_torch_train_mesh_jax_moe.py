"""The port's mesh trainer against the reference's on its mesh, on the
CPU: dp=2·ep=2 on the MoE model (top 2, the router z-loss; one layer)
with ZeRO-1.

The same weights (the reference's seeded initialisation, carried to the
port's layout) and the same global batches go through the reference's
``make_train_step(cfg, build_mesh(dp=2, ep=2))`` on conftest's forced
CPU devices, with the optax chain its trainer builds, and through four
spawned port ranks on the same mesh (``tests/torch_tp_worker.py``,
gloo; ``torch_tp_cases.mesh_against_jax``).  Each dp rank of either
takes the same rows: the global array split in dp blocks.  Under ep
both packages run the plain layer math (the reference's
``_manual_setup`` turns its kernels off there), and the moments are
sharded over dp by ``shard_state(..., zero1=True)`` and ``--zero1``.

Tolerances are the one-device parity test's (``tests/test_torch_train.py``):
per-step losses within 1e-5, parameters within 2e-5 after three steps.
"""

import numpy as np
import pytest

from torch_cpu_threads import one_torch_thread  # noqa: F401
from torch_tp_cases import TRAIN_MOE, assemble, mesh_against_jax


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return mesh_against_jax(str(tmp_path_factory.mktemp("mesh-jax-moe")),
                            "moe_dp2ep2", dict(TRAIN_MOE, n_layers=1),
                            dict(dp=2, ep=2),
                            zero1=True)


def test_losses_match_the_reference_on_its_mesh(run):
    answers, (want, _) = run
    for answer in answers:
        got = np.array(answer["metrics"])[:, :2]  # the reference's two
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_parameters_match_the_reference_on_its_mesh(run):
    answers, (_, want) = run
    got = assemble(answers)
    assert set(got) == set(want)
    for leaf, value in got.items():
        np.testing.assert_allclose(value, want[leaf], rtol=0, atol=2e-5,
                                   err_msg=leaf)
