"""mTLS on the port's serving data plane, held against the reference's
serving security matrix on the CPU.

Certificates come from the reference's ``CertAuthority`` (a good CA and
an evil one).  A port backend (``serve.a``) and a JAX backend
(``serve.j``) serve one model over mTLS, and the reference's ``Router``
(``route.r1``) fronts the port backend over TLS.  As
``tests/test_security_matrix.py`` holds the reference:

- a good client (``user.t1``) generates directly and through the
  router, with the JAX backend's tokens;
- certless and evil-CA clients fail the handshake on the backend and
  the router, and the backend's listener counts them; a non-serving CN
  (``controller.x``) gets 403; a client pinned to the good CA refuses an
  evil server;
- the tenant is the peer's CN, and a forged ``x-oim-tenant`` is ignored;
- ``load_params_from_peer`` over https both ways (JAX peer → port, port
  peer → JAX) is bit-equal, and a KV hold ships between the JAX and the
  port backend through ``httptls.opener``;
- ``serve_main`` refuses ``--http-tls`` and an https ``--params-peer``
  without ``--ca/--cert/--key``, with the reference's messages.
"""

import json
import ssl
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler

import jax
import numpy as np
import pytest

from oim_tpu.checkpoint import load_params_from_peer as jax_load_peer
from oim_tpu.common.ca import CertAuthority
from oim_tpu.serve import Engine as JaxEngine
from oim_tpu.serve import Router
from oim_tpu.serve.httptls import client_ssl_context as jax_client_context
from oim_tpu.serve.httptls import server_ssl_context as jax_server_context
from oim_tpu.serve.server import ServeServer as JaxServer

from oim_tpu_torch.checkpoint import load_params_from_peer
from oim_tpu_torch.cli import serve_main
from oim_tpu_torch.models.train import named_parameters
from oim_tpu_torch.models.weights import to_jax_params
from oim_tpu_torch.serve import disagg, httptls
from oim_tpu_torch.serve.engine import Engine
from oim_tpu_torch.serve.server import ServeServer
from torch_cpu_threads import one_torch_thread  # noqa: F401
from torch_serve_http import jax_model, prompt

ENGINE = dict(n_slots=2, max_len=64, chunk=4, prompt_buckets=(8, 16, 32),
              kv_block=8)
BODY = {"tokens": [1, 2, 3], "max_new_tokens": 4}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("servetls")
    good, evil = CertAuthority("GOOD CA"), CertAuthority("EVIL CA")

    def certfiles(authority, cn, trust=None):
        cred = authority.issue(cn)
        cafile = tmp / f"{id(authority)}.{id(trust)}.ca.crt"
        cafile.write_bytes((trust or authority).ca_pem)
        crt = tmp / f"{cn}.{id(authority)}.crt"
        key = tmp / f"{cn}.{id(authority)}.key"
        crt.write_bytes(cred.cert_pem)
        key.write_bytes(cred.key_pem)
        return str(cafile), str(crt), str(key)

    jcfg, jparams, tcfg, params = jax_model()
    port = ServeServer(
        Engine(params, tcfg, **ENGINE, device="cpu"),
        ssl_context=httptls.server_ssl_context(
            *certfiles(good, "serve.a"))).start()
    ref = JaxServer(JaxEngine(jparams, jcfg, **ENGINE),
                    ssl_context=jax_server_context(
                        *certfiles(good, "serve.j"))).start()
    r_files = certfiles(good, "route.r1")
    router = Router(backends=(f"https://127.0.0.1:{port.port}",),
                    health_interval=0.2, unhealthy_after=2,
                    ssl_context=jax_server_context(*r_files),
                    client_ssl_context=jax_client_context(*r_files)).start()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and not router.healthy_backends():
        time.sleep(0.05)
    assert router.healthy_backends(), "mTLS router to port backend failed"
    yield {"good": good, "evil": evil, "certfiles": certfiles,
           "port": port, "jax": ref, "router": router, "jcfg": jcfg,
           "jparams": jparams, "tcfg": tcfg}
    router.stop()
    port.stop()
    ref.stop()


def _context(w, cn="user.t1", authority="good", trust=None):
    return httptls.client_ssl_context(
        *w["certfiles"](w[authority], cn, trust=trust))


def _port_of(w, target: str) -> int:
    return w[target].port


def _request(port: int, context, path="/v1/generate", body=BODY,
             headers=None, timeout=30):
    req = urllib.request.Request(
        f"https://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with httptls.opener(context).open(req, timeout=timeout) as resp:
        return json.loads(resp.read())


@pytest.mark.parametrize("target", ["port", "router"])
def test_good_client_end_to_end(world, target):
    """A deployment-CA client generates on the port backend, directly and
    through the reference's router, every hop authenticated, with the
    JAX backend's greedy tokens."""
    got = _request(_port_of(world, target), _context(world))
    want = _request(world["jax"].port, _context(world))
    assert got["tokens"] == want["tokens"] and len(got["tokens"]) == 4


@pytest.mark.parametrize("target", ["port", "router"])
@pytest.mark.parametrize("client", ["certless", "evil_ca"])
def test_rejects_certless_and_evil_ca_clients(world, target, client):
    """No client cert, or one from another CA (trusting the good CA for
    the server): the handshake fails before a request is read; the port
    backend counts its failures."""
    if client == "certless":
        ca_file = world["certfiles"](world["good"], "user.nobody")[0]
        context = httptls.client_ssl_context(ca_file)
    else:
        context = _context(world, "user.t1", "evil", trust=world["good"])
    before = world["port"]._httpd.handshake_failures
    with pytest.raises((ssl.SSLError, urllib.error.URLError, OSError)):
        _request(_port_of(world, target), context, timeout=10)
    if target == "port":
        deadline = time.monotonic() + 10
        while (world["port"]._httpd.handshake_failures == before
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert world["port"]._httpd.handshake_failures > before


@pytest.mark.parametrize("target", ["port", "router"])
def test_rejects_non_serving_cn(world, target):
    """A good-CA cert whose CN is not a serving identity passes the
    handshake and is refused 403."""
    with pytest.raises(urllib.error.HTTPError) as err:
        _request(_port_of(world, target), _context(world, "controller.x"),
                 timeout=10)
    assert err.value.code == 403
    assert "serving-plane" in json.loads(err.value.read())["error"]


def test_client_rejects_evil_server(world):
    """A client pinned to the deployment CA refuses a server presenting
    an evil-CA cert (the port's own TLS listener)."""

    class Quiet(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

    mitm = httptls.TLSThreadingHTTPServer(
        ("127.0.0.1", 0), Quiet, httptls.server_ssl_context(
            *world["certfiles"](world["evil"], "serve.mitm"),
            require_client_cert=False))
    thread = threading.Thread(target=mitm.serve_forever, daemon=True)
    thread.start()
    try:
        with pytest.raises((ssl.SSLError, urllib.error.URLError, OSError)):
            _request(mitm.server_address[1], _context(world), timeout=10)
    finally:
        mitm.shutdown()
        mitm.server_close()
        thread.join(timeout=10)


def test_peer_cn_is_the_tenant(world):
    """Under mTLS the tenant is the client's CN: a forged ``x-oim-tenant``
    does not re-badge the request."""
    engine = world["port"].engine
    reply = _request(world["port"].port, _context(world, "user.t1"),
                     headers={"x-oim-tenant": "premium-forged"})
    rid = reply["request_id"]
    deadline = time.monotonic() + 10
    entries = []
    while time.monotonic() < deadline:
        entries = [e for e in engine.requests()["requests"]
                   if e["rid"] == rid]
        if entries:
            break
        time.sleep(0.01)
    assert entries and entries[0]["tenant"] == "user.t1"


def test_params_from_jax_peer_over_https(world):
    """The port restores the JAX backend's weights over mTLS, bit for bit
    as its own tree."""
    w = world
    got = load_params_from_peer(f"https://127.0.0.1:{w['jax'].port}",
                                w["tcfg"], "cpu", ssl_context=_context(w))
    want = dict(named_parameters(w["port"].engine.params))
    got = dict(named_parameters(got))
    assert got.keys() == want.keys()
    for name, value in want.items():
        assert got[name].dtype == value.dtype
        assert got[name].equal(value), name


def test_params_from_port_peer_over_https(world):
    """The reference restores the port backend's weights over mTLS: the
    JAX tree, bit for bit."""
    w = world
    tree = to_jax_params(w["port"].engine.params, w["tcfg"])
    got = jax_load_peer(
        f"https://127.0.0.1:{w['port'].port}",
        jax.eval_shape(lambda: {k: np.asarray(v) for k, v in tree.items()}),
        ssl_context=_context(w))
    assert got.keys() == tree.keys()
    for name, value in tree.items():
        a, b = np.asarray(got[name]), np.asarray(value)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_kv_ship_over_https(world, direction):
    """A held KV state ships between the JAX and the port backend
    through ``httptls.opener``: the continuation on the importer is the
    exporter's unbroken greedy run."""
    src_name, dst_name = direction.split("_to_")
    src, dst = world[src_name], world[dst_name]
    opener = httptls.opener(_context(world)).open
    base = {name: f"https://127.0.0.1:{world[name].port}"
            for name in ("jax", "port")}
    tokens = prompt(30, 14)
    oracle = _request(src.port, _context(world),
                      body={"tokens": tokens, "max_new_tokens": 12})
    leg = _request(src.port, _context(world),
                   body={"tokens": tokens, "max_new_tokens": 3,
                         "hold_kv": True})
    import_id, rows, n = disagg.ship_kv(opener, base[src_name],
                                        leg["request_id"], base[dst_name])
    assert rows == len(tokens) + 2 and n > 0
    cont = _request(dst.port, _context(world),
                    body={"tokens": tokens + leg["tokens"],
                          "max_new_tokens": 9, "kv_import": import_id,
                          "sample_base": 3})
    assert leg["tokens"] + cont["tokens"] == oracle["tokens"]
    disagg.release_kv(opener, base[src_name], rid=leg["request_id"])


@pytest.mark.parametrize("argv, message", [
    (["--http-tls"], "--http-tls requires --ca/--cert/--key"),
    (["--params-peer", "https://127.0.0.1:1"],
     "an https --params-peer needs --ca/--cert/--key"),
], ids=["http_tls", "https_peer"])
def test_serve_main_tls_refusals(argv, message, monkeypatch):
    """Refused at start, after the daemon's init (kept out of this
    process: it is process-wide) and before an engine or a weight
    exists, with the reference's message."""
    inits = []
    monkeypatch.setattr(serve_main, "init_daemon", inits.append)
    monkeypatch.setattr(serve_main, "make_engine", None)  # never reached
    with pytest.raises(SystemExit) as exc:
        serve_main.main(["--device", "cpu", "--vocab-size", "31",
                         "--d-model", "32", "--n-layers", "1",
                         "--n-heads", "2", "--port", "0", *argv])
    assert str(exc.value) == message and len(inits) == 1
