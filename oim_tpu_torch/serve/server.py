"""HTTP front end for the engine: a stdlib threading HTTP server plus one
step thread that runs the engine.

The counterpart of ``oim_tpu/serve/server.py``'s core surface, with the
same JSON bodies: ``GET /healthz``, ``GET /v1/stats``, ``GET /v1/info``
and non-streaming ``POST /v1/generate`` (``tokens``, ``max_new_tokens``,
``temperature``, ``seed``, ``top_p``, ``stop_ids``, ``sample_base`` and
the other per-request sampling fields).  ``/v1/info`` and ``/v1/stats``
carry the engine's layout and pipeline fields under the reference's
names (``paged``, ``kv_block``, ``pipeline_depth``, ``penalties``;
``readback_seconds``, ``overlap_seconds``, ``overlap_ratio``,
``tail_elisions``, ``inflight_dispatches``; the prefix cache's and
chunked prefill's ``prefix_*``, ``prefill_segments``, ``prefilling``;
speculative decoding's ``spec_drafted``, ``spec_accepted``).
``POST /v1/embed`` (``{"tokens": [...]}`` → ``{"embedding": [...],
"dim": d}``) and ``POST /v1/beam`` (``{"tokens", "max_new_tokens",
"beam_size", "alpha", "eos_id"}`` → ``{"tokens": [...], "score": s}``)
answer from ``Engine.embed`` and ``Engine.beam``, with token prompts.
A request's ``cache_prefix`` stores its prompt's KV when the engine has
a prefix cache.  A deadline comes as the body's ``deadline_ms`` or, when
the body has none, the ``x-oim-deadline-ms`` header (how a router sends
a routed budget), as in the reference.  The tenant is the
``x-oim-tenant`` header (this listener is plain HTTP, the trusted
perimeter behind a router), and a ``traceparent`` header parents the
``serve.generate`` span, under which the engine records the request's
phase spans.  Every 429 and 503 carries ``Retry-After``: the engine's
estimate of when its backlog drains.  Streaming, text prompts, the
OpenAI surface, KV shipping over HTTP (``/v1/kv``: held KV and prefix
export or install; ``/v1/slot``, ``/v1/drain``), profiling and the stall
watchdog come with later slices (ROADMAP Queue A: the rest of
server.py); ``/v1/kv`` answers 501 naming them.  A request's
``hold_kv`` and ``kv_import`` reach the engine, whose ``export_kv`` and
``import_kv`` speak the reference's wire in process.
"""

from __future__ import annotations

import json
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from oim_tpu_torch.common import tracing
from oim_tpu_torch.serve.engine import (
    DeadlineExpiredError,
    DrainingError,
    Engine,
    EngineFailedError,
    GenRequest,
    QueueFullError,
    RequestFailedError,
)

# Per-kind HTTP status of a request that failed without a result.
_FAILED_STATUS = {"deadline_queue": 429, "deadline": 504, "migrated": 503}
# The KV shipping routes: held-KV and prefix export (GET) and install
# (POST).  The engine ships (``Engine.export_kv`` and the rest); the
# routes wait for the streaming surfaces the router's ship flows ride.
_KV_NOT_PORTED = (
    "/v1/kv (KV shipping over HTTP: held-KV and prefix export and "
    "install) is not ported to oim_tpu_torch yet (ROADMAP Queue A: A11 "
    "and A16); the engine's export_kv/import_kv carry the wire"
)


def _deadline(body: dict, headers) -> float | None:
    """A request's deadline on the engine's clock: ``deadline_ms`` in the
    body (wins) or the ``x-oim-deadline-ms`` header — the one a router
    forwards a routed budget in — as a relative millisecond budget, made
    absolute here so that client and server clocks never meet.  A budget
    of 0 or less is a ValueError (400)."""
    ms = body.get("deadline_ms")
    if ms is None:
        ms = headers.get("x-oim-deadline-ms")
    if ms is None:
        return None
    ms = float(ms)
    if ms <= 0:
        raise ValueError(f"deadline_ms must be > 0, got {ms}")
    return time.monotonic() + ms / 1000.0


def _tenant(headers) -> str:
    """The requesting tenant: the ``x-oim-tenant`` header, as the
    reference reads it on a plain-HTTP listener (a router in front
    resolves the real identity and forwards it); "" (anon) without
    one."""
    return (headers.get("x-oim-tenant") or "").strip()[:128]


def _parse_generate(body: dict, headers, span=None) -> GenRequest:
    """A ``/v1/generate`` JSON body and its request headers → GenRequest
    (KeyError, TypeError or ValueError on a malformed request); ``span``
    is the server span the engine's phase spans go under."""
    if body.get("stream"):
        raise ValueError("streaming is not ported yet; send stream=false")
    return GenRequest(
        tokens=[int(t) for t in body["tokens"]],
        max_new_tokens=int(body.get("max_new_tokens", 16)),
        temperature=float(body.get("temperature", 0.0)),
        seed=int(body.get("seed", 0)),
        eos_id=(
            int(body["eos_id"]) if body.get("eos_id") is not None else None
        ),
        stop_ids=tuple(int(t) for t in body.get("stop_ids", ())),
        top_p=(
            float(body["top_p"]) if body.get("top_p") is not None else None
        ),
        min_p=float(body.get("min_p", 0.0)),
        repetition_penalty=float(body.get("repetition_penalty", 1.0)),
        presence_penalty=float(body.get("presence_penalty", 0.0)),
        frequency_penalty=float(body.get("frequency_penalty", 0.0)),
        cache_prefix=bool(body.get("cache_prefix")),
        hold_kv=bool(body.get("hold_kv")),
        kv_import=(
            int(body["kv_import"]) if body.get("kv_import") is not None
            else None
        ),
        deadline=_deadline(body, headers),
        sample_base=int(body.get("sample_base", 0)),
        tenant=_tenant(headers),
        span=(tracing.SpanContext(span.trace_id, span.span_id)
              if span is not None else None),
    )


def _prompt_tokens(body: dict) -> list[int]:
    """A body's prompt ids: ``tokens`` (a ``text`` prompt needs the
    tokenizer, which the port does not have yet)."""
    if "text" in body:
        raise ValueError(
            "'text' prompts are not ported to oim_tpu_torch yet (ROADMAP "
            "Queue A11: texttok); send 'tokens'"
        )
    return [int(t) for t in body["tokens"]]


class _Handler(BaseHTTPRequestHandler):
    """One request against the ``ServeServer`` that ``self.server.owner``
    names: a weak proxy, so that the listener does not keep a stopped
    server, and through it the engine, alive."""

    def log_message(self, *args):  # per-request stderr noise off
        pass

    def _json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if code in (429, 503):
            # Every shed and every unavailable answer says when to retry.
            engine = self.server.owner.engine
            self.send_header("Retry-After", str(engine.retry_after_s()))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        outer = self.server.owner
        if self.path == "/healthz":
            if outer.error is not None:
                self._json(503, {"ok": False, "error": outer.error})
            else:
                self._json(200, {"ok": True})
        elif self.path == "/v1/stats":
            self._json(200, outer.engine.stats())
        elif self.path == "/v1/info":
            self._json(200, outer.engine.info())
        elif self.path.split("?")[0] == "/v1/kv":
            self._json(501, {"error": _KV_NOT_PORTED})
        else:
            self._json(404, {"error": f"no such path {self.path}"})

    def do_POST(self):
        outer = self.server.owner
        if self.path.split("?")[0] == "/v1/kv":
            self._json(501, {"error": _KV_NOT_PORTED})
            return
        if self.path not in ("/v1/generate", "/v1/embed", "/v1/beam"):
            self._json(404, {"error": f"no such path {self.path}"})
            return
        if outer.error is not None:
            self._json(503, {"error": outer.error})
            return
        if self.path != "/v1/generate":
            self._slot_free(outer.engine)
            return
        # Join the caller's W3C trace: the engine's phase spans go under
        # this server span.
        parent = tracing.parse_traceparent(
            self.headers.get(tracing.TRACEPARENT_KEY, ""))
        with tracing.start_span("serve.generate", component="oim-serve",
                                parent=parent) as span:
            self._generate(outer.engine, span)

    def _generate(self, engine: Engine, span) -> None:
        try:
            length = int(self.headers.get("Content-Length", "0"))
            body = json.loads(self.rfile.read(length) or b"{}")
            req = _parse_generate(body, self.headers, span)
            rid = engine.submit(req)
        except (QueueFullError, DeadlineExpiredError) as exc:
            span.status = "error: shed"
            self._json(429, {"error": str(exc)})
            return
        except (DrainingError, EngineFailedError) as exc:
            span.status = "error: unavailable"
            self._json(503, {"error": str(exc)})
            return
        except (KeyError, TypeError, ValueError) as exc:
            span.status = "error: bad request"
            self._json(400, {"error": str(exc)})
            return
        try:
            tokens, lps = engine.result_full(rid, timeout=600)
        except TimeoutError:
            engine.cancel(rid, "server-side wait timed out")
            engine.forget(rid)
            span.status = "error: timeout"
            self._json(503, {"error": f"request {rid} timed out"})
            return
        except RequestFailedError as exc:
            span.status = f"error: {exc.kind}"
            self._json(_FAILED_STATUS.get(exc.kind, 500),
                       {"error": str(exc)})
            return
        payload = {"tokens": tokens, "request_id": rid}
        if body.get("logprobs"):
            payload["logprobs"] = lps
        self._json(200, payload)


    def _slot_free(self, engine: Engine) -> None:
        """``/v1/embed`` or ``/v1/beam``: slot-free work run on this
        handler thread."""
        try:
            length = int(self.headers.get("Content-Length", "0"))
            body = json.loads(self.rfile.read(length) or b"{}")
            tokens = _prompt_tokens(body)
            if self.path == "/v1/embed":
                vec = engine.embed(tokens)
                payload = {"embedding": vec, "dim": len(vec)}
            else:
                toks, score = engine.beam(
                    tokens,
                    max_new_tokens=int(body.get("max_new_tokens", 16)),
                    beam_size=int(body.get("beam_size", 4)),
                    alpha=float(body.get("alpha", 0.6)),
                    eos_id=(int(body["eos_id"])
                            if body.get("eos_id") is not None else None),
                )
                payload = {"tokens": toks, "score": score}
        except (DrainingError, EngineFailedError) as exc:
            self._json(503, {"error": str(exc)})
            return
        except (KeyError, TypeError, ValueError) as exc:
            self._json(400, {"error": str(exc)})
            return
        self._json(200, payload)


class ServeServer:
    """Owns the engine's step thread and the HTTP listener.  ``start()``
    returns self; ``port`` is the bound port (0 → ephemeral)."""

    def __init__(self, engine: Engine, host: str = "127.0.0.1",
                 port: int = 0):
        self.engine = engine
        self.error: str | None = None  # set when the step thread dies
        self._stop = threading.Event()
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.owner = weakref.proxy(self)
        self.host, self.port = self._httpd.server_address[:2]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._step_thread = threading.Thread(target=self._step_loop,
                                               daemon=True)

    def _step_loop(self) -> None:
        while not self._stop.is_set():
            try:
                if self.engine.pending():
                    self.engine.step()
                else:
                    time.sleep(0.005)
            except Exception as exc:  # step-thread death = service death
                self.error = f"{type(exc).__name__}: {exc}"
                # step() already latched the crash and failed every
                # waiter; this abort is a backstop.
                self.engine.abort(self.error)
                return

    def start(self) -> "ServeServer":
        self._http_thread.start()
        self._step_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        self._http_thread.join(timeout=10)
        self._step_thread.join(timeout=60)
