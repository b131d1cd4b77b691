"""The JAX engine on its tp=2 mesh against the port, for the quantized
cases ``tests/test_torch_tp_serve.py`` does not run it on: int8 KV and
int8 weights.

Greedy tokens of ``oim_tpu``'s ``Engine(mesh=build_mesh(tp=2))`` equal
the port's single-device engine's on the same numpy params
(``tests/torch_tp_cases.py``), and ``test_torch_tp_serve.py`` holds the
port's tp=2 engine to that same single-device engine token for token:
so the port's tp=2 engine emits the JAX tp=2 engine's tokens.  Kept
apart (and speculation in ``test_torch_tp_jax_spec.py``) so that each
module stays a few JAX compiles long.
"""

import pytest

from torch_cpu_threads import one_torch_thread  # noqa: F401
from torch_tp_cases import case, greedy_rows, jax_mesh, port_single


@pytest.mark.parametrize("name", ["kv_int8", "weights_int8"])
def test_jax_tp_engine_matches_port(name):
    c = case(name)
    tokens, _ = port_single(c)
    assert jax_mesh(c, tp=2) == greedy_rows(c, tokens)
