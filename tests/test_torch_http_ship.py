"""KV, slot and weight shipping over HTTP between a JAX ``ServeServer``
and a port ``ServeServer``, both ways, on the CPU.

- ``/v1/kv`` hold-and-import (fp and int8 KV): the continuation on the
  importer is the exporter's unbroken greedy run; the hold's release is
  idempotent;
- a prefix entry exported by digest and installed: a hit on the
  importer, tokens as the exporter's own hit;
- ``POST /v1/drain`` with ``GET``/``PUT``/``DELETE /v1/slot`` at pipeline
  depth 1 and 2: a drained stream ends in its migrate line, and the
  continuation on the other server makes it token-identical to the
  unbroken run (greedy across the packages; sampled within the port,
  which draws its own noise); a non-stream request caught by the drain
  gets 503 with ``Retry-After``.  Each drain happens with the source's
  step thread held after the stream has shown 4 tokens;
- the faults answer as the reference answers them: 404 for an unknown
  rid or digest, 400 without one, 409 for a geometry mismatch, 429 with
  ``Retry-After`` when the pool cannot reserve the blocks;
- ``to_jax_params`` inverts ``from_jax_params``, and ``/v1/weights``
  works both ways: the port's ``load_params_from_peer`` from a JAX peer
  is the port's own ``from_jax_params`` of the same tree, and the
  reference's ``load_params_from_peer`` from a port peer is the JAX
  tree, bit for bit — f32, bf16, int8 and int4 weights;
- ``prewarm_from_peer`` both ways.
"""

import threading
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oim_tpu.checkpoint import load_params_from_peer as jax_load_peer
from oim_tpu.ops.quant import quantize_params_int4, quantize_params_int8
from oim_tpu.serve import Engine as JaxEngine
from oim_tpu.serve import disagg as jdisagg
from oim_tpu.serve.server import ServeServer as JaxServer

from oim_tpu_torch.checkpoint import load_params_from_peer
from oim_tpu_torch.checkpoint.manager import _CKPT_BYTES
from oim_tpu_torch.models.train import named_parameters
from oim_tpu_torch.models.transformer import TransformerConfig
from oim_tpu_torch.models.weights import from_jax_params, to_jax_params
from oim_tpu_torch.serve import disagg
from oim_tpu_torch.serve.engine import Engine
from oim_tpu_torch.serve.server import ServeServer
from torch_cpu_threads import one_torch_thread  # noqa: F401
from torch_serve_http import (
    CFG,
    StepGate,
    call,
    jax_model,
    prompt,
    stream_lines,
    url,
    wait_until,
)

ENGINE = dict(n_slots=2, max_len=64, chunk=4, prompt_buckets=(8, 16, 32),
              kv_block=8, prefix_cache_size=2)
OPEN = urllib.request.urlopen


@pytest.fixture(scope="module")
def model():
    return jax_model()


@pytest.fixture(scope="module")
def fleet(model):
    """{(package, quant): server}: a JAX and a port server per KV quant,
    on the same weights."""
    jcfg, jparams, tcfg, params = model
    servers = {}
    for quant in ("fp", "int8"):
        kw = dict(ENGINE, kv_int8=quant == "int8")
        servers["jax", quant] = JaxServer(JaxEngine(jparams, jcfg, **kw))
        servers["port", quant] = ServeServer(
            Engine(params, tcfg, **kw, device="cpu"))
    for server in servers.values():
        server.start()
    yield servers
    for server in servers.values():
        server.stop()


def _gen(server, **body) -> dict:
    status, _, reply = call(url(server), "/v1/generate", body)
    assert status == 200, reply
    return reply


def _settled(server) -> None:
    s = server.engine.stats()
    assert s["kv_holds"] == 0 and s["kv_imports_staged"] == 0
    assert s["migrated_slots"] == 0 and s["active_slots"] == 0


DIRECTIONS = ["jax_to_port", "port_to_jax"]


def _pair(fleet, direction: str, quant: str = "fp"):
    src, dst = direction.split("_to_")
    return fleet[src, quant], fleet[dst, quant]


@pytest.mark.parametrize("quant", ["fp", "int8"])
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_kv_hold_ship(fleet, direction, quant):
    src, dst = _pair(fleet, direction, quant)
    tokens = prompt(30, 14)
    oracle = _gen(src, tokens=tokens, max_new_tokens=12)["tokens"]
    leg = _gen(src, tokens=tokens, max_new_tokens=3, hold_kv=True)
    import_id, rows, n = disagg.ship_kv(OPEN, url(src), leg["request_id"],
                                        url(dst))
    assert rows == len(tokens) + 2 and n > 0
    cont = _gen(dst, tokens=tokens + leg["tokens"], max_new_tokens=9,
                kv_import=import_id, sample_base=3)
    assert leg["tokens"] + cont["tokens"] == oracle
    for want in (True, False):  # released once; idempotent after
        status, _, reply = call(url(src),
                                f"/v1/kv?rid={leg['request_id']}",
                                method="DELETE")
        assert status == 200 and reply["ok"] is want
    _settled(src)
    _settled(dst)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_prefix_ship(fleet, direction):
    src, dst = _pair(fleet, direction)
    system = prompt(40 + DIRECTIONS.index(direction), 16)
    _gen(src, tokens=system, max_new_tokens=1, cache_prefix=True)
    digest = disagg.prefix_digest(system)
    assert digest == jdisagg.prefix_digest(system)
    hits = dst.engine.stats()["prefix_hits"]
    rows, n = disagg.ship_prefix(OPEN, url(src), digest, url(dst))
    assert rows == 16 and n > 0
    hit = system + prompt(50, 6)
    got = _gen(dst, tokens=hit, max_new_tokens=6)["tokens"]
    assert got == _gen(src, tokens=hit, max_new_tokens=6)["tokens"]
    assert dst.engine.stats()["prefix_hits"] == hits + 1


def _drained_stream(src, body: dict) -> list[dict]:
    """Stream ``body`` on ``src``, hold its step thread once 4 tokens are
    out, drain, and return the stream's lines."""
    lines: list = []
    gate = StepGate.after_tokens(src.engine, 4)
    thread = threading.Thread(
        target=lambda: stream_lines(url(src), body, on_line=lines.append),
        daemon=True)
    try:
        thread.start()
        assert gate.held.wait(30) and wait_until(lambda: len(lines) >= 4)
        status, _, reply = call(url(src), "/v1/drain", {})
        assert status == 200 and reply["draining"] is True
        assert call(url(src), "/v1/drain", {})[0] == 200  # idempotent
        gate.release()
        thread.join(30)
        assert not thread.is_alive()
    finally:
        gate.remove()
    return lines


def _undrain(server) -> None:
    server.engine._draining = False
    server.engine._migrate_out = False


CASES = [("greedy", "jax_to_port"), ("greedy", "port_to_jax"),
         ("sampled", "port_to_port")]


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("mode,direction", CASES)
def test_drain_slot_ship(fleet, mode, direction, depth):
    src_name, dst_name = direction.split("_to_")
    src, dst = fleet[src_name, "fp"], fleet[dst_name, "fp"]
    for server in (src, dst):
        server.engine.set_pipeline_depth(depth)
    body = {"tokens": prompt(60 + depth, 8), "max_new_tokens": 40}
    if mode == "sampled":
        body.update(temperature=0.9, seed=11)
    oracle = _gen(src, **body)["tokens"]
    lines = _drained_stream(src, body)
    assert lines[-1].get("migrate") is True, lines[-1]
    rid = int(lines[-1]["request_id"])
    prior = [ln["token"] for ln in lines if "token" in ln]
    assert 4 <= len(prior) < 40
    _undrain(src)
    for path, code in (("/v1/slot", 400), ("/v1/slot?rid=999999", 404)):
        assert call(url(src), path)[0] == code
    import_id, rows, slot, n = disagg.ship_slot(OPEN, url(src), rid,
                                                url(dst))
    assert rows == len(body["tokens"]) + len(prior) - 1 and n > 0
    assert slot["sample_base"] == len(prior)
    cont = _gen(dst, **dict(body, tokens=body["tokens"] + prior,
                            max_new_tokens=40 - len(prior),
                            kv_import=import_id,
                            sample_base=slot["sample_base"]))
    assert prior + cont["tokens"] == oracle
    for want in (True, False):
        status, _, reply = call(url(src), f"/v1/slot?rid={rid}",
                                method="DELETE")
        assert status == 200 and reply["ok"] is want
    for server in (src, dst):
        server.engine.set_pipeline_depth(2)
        _settled(server)


def test_drain_fails_nonstream_retryable(fleet):
    """A non-stream request caught by a drain answers 503 with
    ``Retry-After`` (a router resubmits it on a sibling)."""
    src = fleet["port", "fp"]
    gate = StepGate.after_tokens(src.engine, 4)
    result = []
    thread = threading.Thread(target=lambda: result.append(call(
        url(src), "/v1/generate",
        {"tokens": prompt(61, 8), "max_new_tokens": 40})), daemon=True)
    try:
        thread.start()
        assert gate.held.wait(30)
        call(url(src), "/v1/drain", {})
        gate.release()
        thread.join(30)
    finally:
        gate.remove()
    status, headers, _ = result[0]
    assert status == 503 and int(headers["Retry-After"]) >= 1
    for rid in list(src.engine._migrated):
        src.engine.release_migrated(rid)
    _undrain(src)
    _settled(src)


def _faults(fleet, package: str) -> list[int]:
    """The status of each fault against one package's fp server."""
    server, int8 = fleet[package, "fp"], fleet[package, "int8"]
    codes = [call(url(server), path)[0] for path in (
        "/v1/kv?rid=999999", "/v1/kv?prefix=feedfacefeedface", "/v1/kv",
        "/v1/slot?rid=999999")]
    codes.append(call(url(server), "/v1/kv", b"", method="PUT")[0])
    leg = _gen(server, tokens=prompt(70, 20), max_new_tokens=4,
               hold_kv=True)
    body = call(url(server), f"/v1/kv?rid={leg['request_id']}")[2]
    codes.append(call(url(int8), "/v1/kv", body, method="PUT")[0])  # 409
    imports, last = [], None
    for _ in range(8):  # 3 blocks each into a 16-block pool
        last = call(url(server), "/v1/kv", body, method="PUT")
        if last[0] != 200:
            break
        imports.append(last[2]["import_id"])
    codes.append(last[0])
    assert last[0] != 429 or int(last[1]["Retry-After"]) >= 1
    for import_id in imports:
        assert call(url(server), f"/v1/kv?import={import_id}",
                    method="DELETE")[2]["ok"] is True
    call(url(server), f"/v1/kv?rid={leg['request_id']}", method="DELETE")
    _settled(server)
    return codes


def test_faults_answer_as_the_reference(fleet):
    codes = _faults(fleet, "port")
    assert codes == [404, 404, 400, 404, 409, 409, 429]
    assert _faults(fleet, "jax") == codes


def _bf16(tree: dict) -> dict:
    """The tree as a bf16 model holds it: matrices bf16, norms f32."""
    return {k: v if "norm" in k else v.astype(jnp.bfloat16)
            for k, v in tree.items()}


def _tree(model, weights: str) -> tuple[dict, TransformerConfig, str]:
    """(JAX tree, the port config, weight quant) of one weights case."""
    jcfg, jparams, tcfg, _ = model
    if weights == "bf16":
        return _bf16(jparams), TransformerConfig(
            **dict(CFG, dtype="bfloat16")), ""
    if weights == "int8":
        return dict(quantize_params_int8(jparams)), tcfg, "int8"
    if weights == "int4":
        return dict(quantize_params_int4(jparams, group=32)), tcfg, "int4"
    return dict(jparams), tcfg, ""


WEIGHTS = ["f32", "bf16", "int8", "int4"]


@pytest.mark.parametrize("weights", WEIGHTS)
def test_to_jax_params_inverts_from_jax_params(model, weights):
    """The reference's names, shapes and dtypes and its values, bit for
    bit: bf16 as bf16, ``wlm`` narrowed back from its widened copy, int4
    payloads as their values (one a byte on the wire)."""
    tree, tcfg, _ = _tree(model, weights)
    tree = {k: np.asarray(v) for k, v in tree.items()}
    back = to_jax_params(from_jax_params(tree, tcfg), tcfg)
    assert back.keys() == tree.keys()
    for name, want in tree.items():
        got = back[name]
        assert tuple(got.shape) == want.shape, name
        if str(want.dtype) == "bfloat16":
            assert got.dtype == torch.bfloat16, name
            assert np.array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16)), name
        elif str(want.dtype) == "int4":
            assert got.dtype == torch.int8, name
            assert np.array_equal(got.numpy(), want.astype(np.int8)), name
        else:
            assert str(got.dtype) == f"torch.{want.dtype}", name
            assert np.array_equal(got.numpy(), want), name


@pytest.mark.parametrize("weights", WEIGHTS)
def test_weights_port_from_jax_peer(fleet, model, weights):
    """The port restores from the reference's ``/v1/weights`` what its
    own ``from_jax_params`` makes of the same tree, bit for bit, and
    counts the bytes; a peer of another geometry is refused first."""
    tree, tcfg, quant = _tree(model, weights)
    peer = (fleet["jax", "fp"] if weights == "f32" else
            JaxServer(types.SimpleNamespace(
                params=tree, pending=lambda: False)).start())
    try:
        moved = _CKPT_BYTES.value("restore-peer")
        got = load_params_from_peer(url(peer), tcfg, "cpu",
                                    weight_quant=quant, int4_group=32)
        want = from_jax_params({k: np.asarray(v) for k, v in tree.items()},
                               tcfg)
        got_named, want_named = (dict(named_parameters(p))
                                 for p in (got, want))
        assert got_named.keys() == want_named.keys()
        for name, value in want_named.items():
            assert got_named[name].dtype == value.dtype, name
            assert torch.equal(got_named[name], value), name
        assert _CKPT_BYTES.value("restore-peer") == moved + sum(
            np.asarray(v).nbytes for v in tree.values())
        with pytest.raises(ValueError, match="geometry"):
            load_params_from_peer(url(peer), TransformerConfig(
                **dict(CFG, d_ff=128)), "cpu", weight_quant=quant,
                int4_group=32)
    finally:
        if weights != "f32":
            peer.stop()


@pytest.mark.parametrize("weights", WEIGHTS)
def test_weights_jax_from_port_peer(fleet, model, weights):
    """The reference restores from the port's ``/v1/weights`` (checked
    against the JAX tree's own shapes and dtypes) the JAX tree, bit for
    bit."""
    tree, tcfg, _ = _tree(model, weights)
    peer = (fleet["port", "fp"] if weights == "f32" else ServeServer(
        Engine(from_jax_params({k: np.asarray(v) for k, v in tree.items()},
                               tcfg), tcfg, n_slots=1, max_len=32,
               device="cpu")).start())
    try:
        got = jax_load_peer(url(peer), jax.eval_shape(lambda: tree))
        assert got.keys() == tree.keys()
        for name, value in tree.items():
            a, b = np.asarray(got[name]), np.asarray(value)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert a.tobytes() == b.tobytes(), name
    finally:
        if weights != "f32":
            peer.stop()


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_prewarm_from_peer(fleet, model, direction):
    """A new replica installs its donor's hottest prefix entries before
    its step thread starts (here: while it is held) and its first hit on
    one equals the donor's own."""
    src, dst = _pair(fleet, direction)
    prompts = [prompt(80 + i, 16) for i in range(2)]
    for p in prompts:
        _gen(src, tokens=p, max_new_tokens=1, cache_prefix=True)
    helper = jdisagg if isinstance(dst, JaxServer) else disagg
    gate = StepGate(dst.engine, lambda: True)
    try:
        with dst.engine._lock:
            dst.engine._clear_prefix_cache_locked()
        assert helper.prewarm_from_peer(dst.engine, url(src), 2) == 2
    finally:
        gate.remove()
    resident = {e["digest"] for e in dst.engine.prefix_digest_summary()}
    assert resident == {disagg.prefix_digest(p) for p in prompts}
    hit = prompts[0] + prompt(90, 5)
    hits = dst.engine.stats()["prefix_hits"]
    assert (_gen(dst, tokens=hit, max_new_tokens=5)["tokens"]
            == _gen(src, tokens=hit, max_new_tokens=5)["tokens"])
    assert dst.engine.stats()["prefix_hits"] == hits + 1
    assert helper.prewarm_from_peer(dst.engine, "http://127.0.0.1:9", 2,
                                    timeout=1.0) == 0
