"""QoS preemption by parking on the JAX engine's own tp=2 mesh (virtual
CPU devices), against the port, on the CPU.

``tests/torch_tp_cases.py::QOS_SCRIPT`` runs through
``torch_tp_worker.run_script`` on the JAX engine as on the port's: two
best-effort streams hold both slots, a premium arrival parks one on the
host tier, and the parked stream is restored when a slot frees, once
greedy and once sampled.  The JAX tp=2 engine's greedy streams and its
park, restore and preemption counters are the port's single-device
engine's, which ``tests/test_torch_tp_io.py`` holds the port's tp=2
ranks to exactly (tokens and counters), so all three agree.
"""

from torch_cpu_threads import one_torch_thread  # noqa: F401
from torch_tp_cases import QOS_ENGINE, QOS_SCRIPT, io_case, jax_engine
from torch_tp_cases import single_outputs
from torch_tp_worker import run_script


def _greedy(out: list, requests: list) -> list:
    return [tokens for (tokens, _), r in zip(out, requests)
            if not r.get("temperature")]


def test_jax_mesh_parks_as_the_port():
    got = run_script(jax_engine(QOS_ENGINE, tp=2), QOS_SCRIPT)
    want = single_outputs(io_case("qos"))
    for (op, *args), g, w in zip(QOS_SCRIPT, got, want):
        if op == "late":
            early, _, late = args
            assert _greedy(g, early + late) == _greedy(w, early + late)
    assert got[-1] == want[-1]
    assert got[-1]["kv_parks"] >= 2 and got[-1]["qos_preemptions"] >= 2
