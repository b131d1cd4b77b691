"""mTLS for the HTTP serving data plane (standard library only).

The port's copy of ``oim_tpu/serve/httptls.py``: the same deployment CA
tree, the same contexts and the same serving-plane CN pinning, so that a
port backend, a reference backend and the reference's router speak to
each other over one certificate tree:

    client ⇄ router ⇄ oim-serve      (HTTPS, client certs required)

Identity model: the deployment CA is private and closed-world — holding
a CA-signed cert opens the handshake, and the cert's CN must also be a
serving-plane identity (``serve.*``, ``route.*``, ``user.*``) or every
handler answers 403.  Hostname checking is off on purpose: components
dial each other by IP:port, and the cert's CN (``serve.<id>``, read by
handlers through ``peer_common_name``) is the identity, not the network
address.

Servers wrap the listening socket, so the TLS handshake happens in the
connection's own thread on its first read; a client presenting no cert
or a cert from another CA fails the handshake before a byte of the HTTP
request is read (``TLSThreadingHTTPServer.handshake_failures`` counts
them).
"""

from __future__ import annotations

import ssl
import urllib.request
from http.server import ThreadingHTTPServer


def server_ssl_context(
    ca_file: str, cert_file: str, key_file: str,
    require_client_cert: bool = True,
) -> ssl.SSLContext:
    """TLS context for a serving listener: presents ``cert_file`` and
    (by default) REQUIRES a peer cert signed by ``ca_file`` — mTLS."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert_file, key_file)
    ctx.load_verify_locations(ca_file)
    if require_client_cert:
        ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def client_ssl_context(
    ca_file: str, cert_file: str | None = None, key_file: str | None = None
) -> ssl.SSLContext:
    """TLS context for dialing a serving endpoint: verifies the server
    chains to OUR CA (not the system roots), presents a client cert when
    given (required by mTLS servers).  See the module docstring for why
    ``check_hostname`` is off."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_REQUIRED
    ctx.load_verify_locations(ca_file)
    if cert_file:
        ctx.load_cert_chain(cert_file, key_file)
    return ctx


def opener(
    context: ssl.SSLContext | None,
) -> urllib.request.OpenerDirector:
    """urllib opener sending requests through ``context`` (plain HTTP
    opener when ``None`` — the no-TLS deployments keep working)."""
    if context is None:
        return urllib.request.build_opener()
    return urllib.request.build_opener(
        urllib.request.HTTPSHandler(context=context)
    )


# CN prefixes that carry a serving-plane identity.  Holding ANY
# deployment-CA cert opens the TLS handshake (closed-world CA, module
# docstring); this pin additionally requires the cert to BE a serving
# identity — a controller's controller.* or the registry's
# component.registry cert cannot call the serving API or impersonate a
# backend to a router.
SERVING_CN_PREFIXES = ("serve.", "route.", "user.")


def authorize_serving_peer(handler) -> bool:
    """True when ``handler``'s peer may speak the serving data plane:
    plain HTTP (no identities to pin), or a TLS peer whose cert CN is a
    serving-plane identity (``serve.*`` backend, ``route.*`` router,
    ``user.*`` client).  Defense-in-depth over the CA gate."""
    getpeercert = getattr(handler.connection, "getpeercert", None)
    if getpeercert is None:
        return True
    cert = getpeercert()
    if not cert:
        # TLS without a client cert: the listener deliberately ran with
        # require_client_cert=False — nothing to pin.
        return True
    cn = _cert_common_name(cert)
    return cn is not None and cn.startswith(SERVING_CN_PREFIXES)


def check_serving_peer(handler) -> bool:
    """``authorize_serving_peer`` plus the 403 every serving handler
    sends on failure — call first in each do_GET/do_POST so both the
    router and backend reject non-serving identities identically."""
    import json

    if authorize_serving_peer(handler):
        return True
    body = json.dumps(
        {"error": "peer CN is not a serving-plane identity"}
    ).encode()
    handler.send_response(403)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)
    return False


def _cert_common_name(cert) -> str | None:
    for rdn in cert.get("subject", ()):
        for key, value in rdn:
            if key == "commonName":
                return value
    return None


def peer_common_name(handler) -> str | None:
    """CN of the authenticated client driving ``handler``'s request, or
    None on a plain-HTTP server."""
    getpeercert = getattr(handler.connection, "getpeercert", None)
    if getpeercert is None:
        return None
    cert = getpeercert()
    if not cert:
        return None
    return _cert_common_name(cert)


class TLSThreadingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer whose accepted sockets speak TLS.

    The listener socket itself is wrapped with
    ``do_handshake_on_connect=False``, so the handshake happens lazily
    on the first I/O in the per-connection handler thread — a slow or
    hostile client cannot block the accept loop.  Handshake failures
    (wrong CA, no client cert) are an expected hostile-input event:
    counted per server instance, not tracebacked.  Anything that is NOT
    a TLS/connection-teardown error still goes through the default
    handler — a handler-side bug must stay loud.
    """

    def __init__(self, addr, handler_cls, ssl_context: ssl.SSLContext):
        super().__init__(addr, handler_cls)
        self.handshake_failures = 0
        self.socket = ssl_context.wrap_socket(
            self.socket, server_side=True, do_handshake_on_connect=False
        )

    def handle_error(self, request, client_address):
        import sys

        exc = sys.exc_info()[1]
        if isinstance(
            exc,
            (
                ssl.SSLError,
                ConnectionResetError,
                BrokenPipeError,
                ConnectionAbortedError,
                TimeoutError,
            ),
        ):
            # Failed handshakes / client teardown: the mTLS gate doing
            # its job, or a client hanging up — not a server bug.
            self.handshake_failures += 1
            return
        super().handle_error(request, client_address)
