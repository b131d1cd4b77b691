"""The JAX engine on its tp=2 mesh against the port under speculative
decoding: prompt lookup and a draft model (replicated on every rank, as
the reference replicates it).

Greedy tokens of ``oim_tpu``'s ``Engine(mesh=build_mesh(tp=2),
spec_decode=3)`` equal the port's single-device engine's on the same
numpy params (``tests/torch_tp_cases.py``), which
``tests/test_torch_tp_serve.py`` holds the port's tp=2 engine to, token
for token.
"""

import pytest

from torch_cpu_threads import one_torch_thread  # noqa: F401
from torch_tp_cases import case, greedy_rows, jax_mesh, port_single


@pytest.mark.parametrize("name", ["spec_lookup", "spec_draft"])
def test_jax_tp_spec_engine_matches_port(name):
    c = case(name)
    tokens, _ = port_single(c)
    assert jax_mesh(c, tp=2) == greedy_rows(c, tokens)
