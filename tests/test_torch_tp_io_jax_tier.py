"""The host KV tier and beam on the JAX engine's own tp=2 mesh (virtual
CPU devices), against the port, on the CPU.

With the same ``kv_host_bytes``, the JAX tp=2 engine runs the host
tier's steps (``tests/torch_tp_cases.py::TIER_SCRIPT``: a prefix
demoted under pressure and promoted by two hits): its greedy tokens and
promotions are the port's single-device engine's, which
``tests/test_torch_tp_io.py`` holds the port's tp=2 engine to, and its
tier holds as many host blocks (sized over the whole model's bytes, as
the port's tp=2 tier now is).  Its beam search is the port's too.
"""

from oim_tpu.serve import GenRequest as JaxRequest

from torch_cpu_threads import one_torch_thread  # noqa: F401
from torch_tp_cases import (
    BEAM,
    HOST_BYTES,
    TIER_ENGINE,
    TIER_SCRIPT,
    io_case,
    jax_engine,
    port_engine,
    single_outputs,
)


def _jax_gen(engine, requests: list) -> list:
    rids = [engine.submit(JaxRequest(**r)) for r in requests]
    engine.run()
    return [list(engine.result(rid, timeout=0)) for rid in rids]


def test_jax_mesh_host_tier_matches_port():
    """The JAX tp=2 engine's greedy streams through the demote/promote
    steps equal the port's single-device engine's, with the same tier
    size in blocks."""
    engine = jax_engine(TIER_ENGINE, tp=2)
    want = single_outputs(io_case("tier"))
    # A fresh engine starts where the port's flush left it: the two
    # oracle runs before that are the port's own check.
    start = TIER_SCRIPT.index(("flush",)) + 1
    for (op, *args), out in zip(TIER_SCRIPT[start:], want[start:]):
        if op == "gen":
            got = _jax_gen(engine, args[0])
            assert [g for g, r in zip(got, args[0])
                    if not r.get("temperature")] == [
                t for (t, _), r in zip(out, args[0])
                if not r.get("temperature")]
    stats = engine.stats()
    assert stats["kv_host_blocks_total"] == HOST_BYTES // 2048
    assert stats["kv_promotions"] == want[-1]["kv_promotions"] > 0
    tokens, score = engine.beam(*BEAM)
    port = port_engine(io_case("solo")).beam(*BEAM)
    assert list(tokens) == port[0] and abs(score - port[1]) <= 1e-4
