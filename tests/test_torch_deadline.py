"""A request's deadline on the port's HTTP server, held against the JAX
package's server on the same requests.

A router forwards a routed budget only as the ``x-oim-deadline-ms``
header, so a backend must read it.  Both servers, each over a tiny
engine built once for the module:

- a header-only budget reaches the engine's ``GenRequest.deadline``;
- a header budget of 0 or less is answered 400;
- a budget too short for a busy engine (its step loop held while the
  request waits in the queue) fails with the same status on both;
- the body's ``deadline_ms`` wins over the header, valid or not.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from oim_tpu.models import TransformerConfig as JaxConfig
from oim_tpu.models import init_params as jax_init_params
from oim_tpu.serve import Engine as JaxEngine
from oim_tpu.serve.server import ServeServer as JaxServer

from oim_tpu_torch.models.transformer import TransformerConfig
from oim_tpu_torch.models.weights import from_jax_params
from oim_tpu_torch.serve.engine import Engine
from oim_tpu_torch.serve.server import ServeServer
from torch_cpu_threads import one_torch_thread  # noqa: F401

CFG = dict(vocab_size=61, d_model=32, n_layers=1, n_heads=2, n_kv_heads=1,
           d_ff=48, dtype="float32")
ENGINE = dict(n_slots=1, max_len=32, chunk=4, prompt_buckets=(8,),
              kv_block=0)
SERVERS = ("reference", "port")


@pytest.fixture(scope="module")
def servers():
    """{name: (port, submitted requests, step gate)} of both servers.
    Each engine records what it is submitted, and its step loop runs
    only while the gate is set."""
    jcfg = JaxConfig(**CFG, use_pallas=False)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tree = {name: np.asarray(value) for name, value in jparams.items()}
    tcfg = TransformerConfig(**CFG)
    built = {
        "reference": JaxServer(JaxEngine(jparams, jcfg, **ENGINE)),
        "port": ServeServer(Engine(from_jax_params(tree, tcfg), tcfg,
                                   **ENGINE, device="cpu")),
    }
    out = {}
    for name, server in built.items():
        engine, seen, gate = server.engine, [], threading.Event()
        gate.set()
        submit, step = engine.submit, engine.step

        def recorded(req, submit=submit, seen=seen):
            seen.append(req)
            return submit(req)

        def gated(step=step, gate=gate):
            gate.wait()
            step()

        engine.submit, engine.step = recorded, gated
        out[name] = (server.start().port, seen, gate)
    # One request each first, so that compiles are not in the timings.
    for port, _, _ in out.values():
        assert _post(port, {"tokens": [1, 2], "max_new_tokens": 2})[0] == 200
    yield out
    for server in built.values():
        server.stop()


def _post(port, body, deadline_header=None):
    headers = {"Content-Type": "application/json"}
    if deadline_header is not None:
        headers["x-oim-deadline-ms"] = deadline_header
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(body).encode(), headers=headers,
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


@pytest.mark.parametrize("name", SERVERS)
def test_header_deadline_reaches_the_engine(servers, name):
    port, seen, _ = servers[name]
    t0 = time.monotonic()
    status, _ = _post(port, {"tokens": [3, 4, 5], "max_new_tokens": 2},
                      deadline_header="30000")
    assert status == 200
    assert t0 + 30.0 <= seen[-1].deadline <= time.monotonic() + 30.0


@pytest.mark.parametrize("header", ["0", "-5"])
@pytest.mark.parametrize("name", SERVERS)
def test_header_deadline_not_positive_is_400(servers, name, header):
    port, _, _ = servers[name]
    status, reply = _post(port, {"tokens": [3], "max_new_tokens": 2},
                          deadline_header=header)
    assert status == 400 and "deadline_ms" in reply["error"]


def test_short_budget_on_a_busy_engine_fails_alike(servers):
    """With each engine's step loop held, a request with a 50 ms header
    budget waits in the queue past it: both servers answer it with the
    same status, the reference's for a request shed in the queue."""
    statuses = {}
    for name in SERVERS:
        port, _, gate = servers[name]
        reply = {}

        def send():
            reply["status"] = _post(port, {"tokens": [7, 8],
                                           "max_new_tokens": 4},
                                    deadline_header="50")[0]

        gate.clear()
        try:
            sender = threading.Thread(target=send)
            sender.start()
            time.sleep(0.3)
        finally:
            gate.set()
        sender.join(timeout=60)
        statuses[name] = reply["status"]
    assert statuses == {"reference": 429, "port": 429}


@pytest.mark.parametrize("name", SERVERS)
def test_body_deadline_wins_over_header(servers, name):
    port, seen, _ = servers[name]
    t0 = time.monotonic()
    status, _ = _post(port, {"tokens": [3, 4], "max_new_tokens": 2,
                             "deadline_ms": 20000}, deadline_header="-1")
    assert status == 200
    assert t0 + 20.0 <= seen[-1].deadline <= time.monotonic() + 20.0
    status, _ = _post(port, {"tokens": [3, 4], "max_new_tokens": 2,
                             "deadline_ms": 0}, deadline_header="20000")
    assert status == 400
