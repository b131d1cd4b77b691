"""HTTP front end for the engine: a stdlib threading HTTP server, one step
thread that runs the engine, and an optional stall watchdog.

The counterpart of ``oim_tpu/serve/server.py``, with its routes, status
codes and JSON bodies:

- ``POST /v1/generate``: ``tokens``, ``max_new_tokens``, ``temperature``,
  ``seed``, ``top_p``, ``stop_ids``, ``sample_base``, the other sampling
  fields, ``cache_prefix``, ``hold_kv`` and ``kv_import``.  Without
  ``stream`` it answers ``{"tokens", "request_id", "traceparent"}`` (plus
  ``logprobs`` when asked).  With ``"stream": true`` the reply is NDJSON:
  one ``{"token"}`` line a generated token as its chunk is read back
  (``"logprob"`` added when asked), a ``traceparent`` response header, and
  a last line ``{"done": true, "tokens", "request_id"}``; a request that a
  migrate-out drain suspends ends in ``{"error", "migrate": true,
  "request_id"}`` (the router ships its ``/v1/slot`` record and splices
  the continuation), any other failure in ``{"error"}``.  A client that
  disconnects cancels and forgets its request.  A deadline comes as
  ``deadline_ms`` or the ``x-oim-deadline-ms`` header, the tenant as the
  mTLS peer's CN or, on a plain-HTTP listener (the trusted perimeter
  behind a router), the ``x-oim-tenant`` header, and a ``traceparent``
  header parents the ``serve.generate`` span.
- ``POST /v1/embed``, ``POST /v1/beam``: slot-free work.
- With a ``tokenizer`` (``serve/texttok.py``; ``serve_main
  --tokenizer-dir``) ``generate``, ``beam`` and ``embed`` take ``"text"``
  in place of ``tokens`` (a text request's EOS defaults to the
  tokenizer's), replies carry the decoded ``"text"``, and stream lines
  their text deltas (``StreamDecoder``, on the handler thread).  Without
  one a text prompt is a 400.
- ``POST /v1/completions`` and ``POST /v1/chat/completions``: the OpenAI
  shapes on the engine — ``n`` choices (seeds ``seed + i``), ``stop``
  strings (the decoded text is cut at the first one found once the
  request ends; nothing stops early, so ``usage`` counts every generated
  token), ``max_tokens``, ``temperature``, ``top_p``, the presence and
  frequency penalties, ``usage``; ``"stream": true`` is a Server-Sent
  Events stream of chunks (chat: deltas) ending in ``data: [DONE]``,
  refused with ``stop`` or ``n > 1``.  Chat renders its messages through
  the tokenizer's own chat template; a ``serve.completions`` span.
- ``GET /v1/kv?rid=N`` (a ``hold_kv`` request's KV) or ``?prefix=D`` (a
  resident prefix entry), ``PUT /v1/kv`` (stage a shipped state: a
  continuation's ``kv_import``, or a prefix entry to install), ``DELETE
  /v1/kv?rid=|import=``; ``POST /v1/drain`` (stop admitting and suspend
  in-flight work into slot records), ``GET``/``PUT``/``DELETE
  /v1/slot``.  The KV wire is ``serve/disagg.py``'s; 404 when nothing is
  there to export, 409 on a geometry mismatch or an ineligible engine,
  429 with ``Retry-After`` when the pool cannot reserve the blocks.
- ``GET /v1/weights``: the served weights in the reference's framing and
  flat layout (``models/weights.py::jax_leaves``), leaf by leaf off the
  card through one pinned bounce buffer, for a sibling's
  ``load_params_from_peer``; on a mesh's leader each tensor gathered
  whole from the ranks' shards, one at a time.
- ``GET /healthz``, ``/v1/stats``, ``/v1/info`` (with the server's
  ``pool``, the live ``load`` and the tokenizer's path), ``/metrics``
  (the Prometheus text of ``common/metrics.py``'s registry), ``/debugz``
  (the flight recorder) and ``/debugz/requests`` (the engine's request
  ring).
- ``POST /debugz/profile {"seconds": S}``: a bounded ``torch.profiler``
  capture (CPU activity, and the card's when the engine runs there) on
  its own thread under its own lock, S clamped to 0.05-60 s, one at a
  time (409 while one runs), its Chrome trace written into the flight
  dir and tarred (the status reports the tracer's start-up seconds,
  ``init_s``, the window's wall times, ``window_ts``, and when the
  trace was written, ``done_ts``); ``GET /debugz/profile`` its status, ``?download=1``
  the tarball (404 before any, 409 while running, 410 when the file is
  gone).  Served while the error latch stands, as every ``/debugz``
  route is.

With an ``ssl_context`` (``serve/httptls.py``) the listener is mTLS:
every handler first pins the peer's CN to a serving-plane identity
(403 otherwise), and the tenant is the peer's CN, the
``x-oim-tenant`` header ignored.  Every 429 and 503 carries
``Retry-After``, the engine's estimate of when its backlog drains.  With
``watchdog_interval`` > 0 a ``StallWatchdog`` fails in-flight requests
fast (503, kind "stalled") and turns ``/healthz`` 503 while a device
wait is wedged, and back once it returns.
"""

from __future__ import annotations

import json
import math
import os
import queue
import struct
import tarfile
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

import torch

from oim_tpu_torch.common import events, metrics, tracing
from oim_tpu_torch.serve import disagg
from oim_tpu_torch.serve.httptls import (
    TLSThreadingHTTPServer,
    check_serving_peer,
    peer_common_name,
)
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
_FAILED_STATUS = {"deadline_queue": 429, "deadline": 504, "stalled": 503,
                  "migrated": 503}
# Bytes of the pinned buffer each leaf of /v1/weights passes through.
WEIGHTS_BOUNCE_BYTES = 32 << 20
# A /debugz/profile window's bounds, in seconds.
PROFILE_MIN_S, PROFILE_MAX_S = 0.05, 60.0


class StallWatchdog:
    """Step-thread stall detector.

    Polls ``engine.watchdog_state()`` every ``interval`` seconds: when the
    step thread has waited on the device, in one wait, longer than
    ``max(floor_s, multiplier × chunk-wall EWMA)``, the device is
    presumed wedged.  Then ``on_stall(message)`` runs (the server fails
    in-flight requests with kind "stalled" and turns ``/healthz`` 503),
    an ERROR ``serve.stall`` event is recorded, and
    ``oim_serve_stalls_total`` counts it.  No verdict before the first
    chunk is read back (no EWMA yet).  If the wait later returns,
    ``on_clear`` runs once."""

    def __init__(self, engine: Engine, on_stall, on_clear=None,
                 interval: float = 1.0, multiplier: float = 8.0,
                 floor_s: float = 10.0):
        if interval <= 0 or multiplier <= 0 or floor_s <= 0:
            raise ValueError(
                f"need interval, multiplier, floor_s > 0; got "
                f"{interval}, {multiplier}, {floor_s}")
        self.engine = engine
        self.on_stall = on_stall
        self.on_clear = on_clear
        self.interval = interval
        self.multiplier = multiplier
        self.floor_s = floor_s
        self.stalls = 0
        self._fired = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def check(self) -> bool:
        """One poll; True while a stall verdict stands (tests call it
        directly)."""
        wait, ewma = self.engine.watchdog_state()
        if wait is None:
            if self._fired:  # the wedged wait returned after all
                self._fired = False
                if self.on_clear is not None:
                    self.on_clear()
            return False
        if ewma is None or self._fired:
            return self._fired
        limit = max(self.floor_s, self.multiplier * ewma)
        if wait <= limit:
            return False
        self._fired = True
        self.stalls += 1
        message = (
            f"decode stall: device wait {wait:.1f}s exceeds {limit:.1f}s "
            f"(chunk EWMA {ewma:.4f}s x {self.multiplier:g}, floor "
            f"{self.floor_s:g}s) — device hang")
        metrics.SERVE_STALLS.inc(self.engine._engine_label)
        events.emit("serve.stall", component="oim-serve",
                    severity=events.ERROR, wait_s=round(wait, 1),
                    limit_s=round(limit, 1), chunk_ewma_s=round(ewma, 4))
        self.on_stall(message)
        return True

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.check()

    def start(self) -> "StallWatchdog":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


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


def _tenant(handler, tls: bool) -> str:
    """The requesting tenant: the mTLS peer's CN when this server
    terminates TLS; on a plain-HTTP listener (the trusted perimeter: a
    router in front resolves the real identity and forwards it) the
    ``x-oim-tenant`` header; "" (anon) without either.  Under TLS the
    header is ignored: a client with a certificate must not re-badge
    itself as another tenant."""
    cn = peer_common_name(handler)
    if cn:
        return cn
    if tls:
        return ""
    return (handler.headers.get("x-oim-tenant") or "").strip()[:128]


def _parse_generate(body: dict, handler, tokenizer=None, tls: bool = False,
                    span=None) -> GenRequest:
    """A ``/v1/generate`` JSON body and its request's handler →
    GenRequest (KeyError, TypeError or ValueError on a malformed
    request); ``span`` is the server span the engine's phase spans go
    under."""
    headers = handler.headers
    return GenRequest(
        tokens=_prompt_tokens(body, tokenizer),
        max_new_tokens=int(body.get("max_new_tokens", 16)),
        temperature=float(body.get("temperature", 0.0)),
        seed=int(body.get("seed", 0)),
        eos_id=_default_eos(body, tokenizer),
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
        tenant=_tenant(handler, tls),
        span=(tracing.SpanContext(span.trace_id, span.span_id)
              if span is not None else None),
    )


def _prompt_tokens(body: dict, tokenizer=None) -> list[int]:
    """Prompt ids from ``tokens`` or, with a tokenizer, ``text`` —
    exactly one of the two."""
    if "text" in body and "tokens" in body:
        raise ValueError("send either 'tokens' or 'text', not both")
    if "text" in body:
        if tokenizer is None:
            raise ValueError(
                "'text' needs a server-side tokenizer (oim-serve "
                "--tokenizer-dir); this instance speaks token ids only"
            )
        return tokenizer.encode(str(body["text"]))
    return [int(t) for t in body["tokens"]]


def _default_eos(body: dict, tokenizer=None) -> int | None:
    """An explicit ``eos_id`` wins; a text request defaults to the
    tokenizer's EOS (a text caller means "a model turn", not "exactly
    max_new_tokens")."""
    if body.get("eos_id") is not None:
        return int(body["eos_id"])
    if "text" in body and tokenizer is not None:
        return tokenizer.eos_id
    return None


def _leaf_views(tensor: torch.Tensor):
    """A host tensor's C-order bytes as a memoryview (bf16 through its
    2-byte words), without a copy when it is contiguous."""
    t = tensor.detach().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return memoryview(t.numpy()).cast("B")


def _weight_chunks(device: torch.device, parts):
    """The bytes of ``parts`` (callables returning tensors where the
    served weights lie), in order, as memoryviews valid until the next
    is taken.  On the GPU each part is made and copied down on a side
    stream that first waits for the step thread's stream, through one
    pinned buffer of ``WEIGHTS_BOUNCE_BYTES``, waiting only on that
    copy's event: never on the whole device."""
    if device.type != "cuda":
        for part in parts:
            yield _leaf_views(part().cpu())
        return
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.default_stream(device))
    bounce = torch.empty(WEIGHTS_BOUNCE_BYTES, dtype=torch.uint8,
                         pin_memory=True)
    host = memoryview(bounce.numpy())
    copied = torch.cuda.Event()
    with torch.cuda.stream(side):
        for part in parts:
            flat = part().contiguous().view(-1).view(torch.uint8)
            for off in range(0, flat.numel(), WEIGHTS_BOUNCE_BYTES):
                n = min(WEIGHTS_BOUNCE_BYTES, flat.numel() - off)
                bounce[:n].copy_(flat[off:off + n], non_blocking=True)
                copied.record(side)
                copied.synchronize()
                yield host[:n]


def _send_transfer(handler, manifest, chunks_total: int, chunks) -> None:
    """Answer 200 with the wire's framing: an 8-byte big-endian manifest
    length, the JSON manifest, then ``chunks`` (``chunks_total`` bytes).
    A client that goes away mid-body ends the answer; nothing here holds
    state to clean up."""
    mb = json.dumps(manifest, separators=(",", ":")).encode()
    handler.send_response(200)
    handler.send_header("Content-Type", "application/octet-stream")
    handler.send_header("Content-Length", str(8 + len(mb) + chunks_total))
    handler.end_headers()
    try:
        handler.wfile.write(struct.pack(">Q", len(mb)))
        handler.wfile.write(mb)
        for chunk in chunks:
            handler.wfile.write(chunk)
        handler.wfile.flush()
    except (BrokenPipeError, ConnectionResetError):
        return  # the caller's fallback owns recovery


def _completion_stops(body: dict, tokenizer) -> list[str]:
    stops = body.get("stop") or []
    if isinstance(stops, str):
        stops = [stops]
    if stops and tokenizer is None:
        raise ValueError("stop strings need a server-side tokenizer")
    return [str(stop) for stop in stops]


def _cut_at_stops(text: str, stops: list[str]) -> tuple[str, bool]:
    """``text`` cut at each stop string in turn, where found (the
    reference's rule), and whether any cut."""
    cut = False
    for stop in stops:
        at = text.find(stop)
        if at >= 0:
            text, cut = text[:at], True
    return text, cut


class _Handler(BaseHTTPRequestHandler):
    """One request against the ``ServeServer`` that ``self.server.owner``
    names: a weak proxy, so that the listener does not keep a stopped
    server, and through it the engine, alive.  Every route first pins an
    mTLS peer's CN to a serving-plane identity (403 otherwise)."""

    want_logprobs = False

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

    def _body(self) -> bytes:
        return self.rfile.read(int(self.headers.get("Content-Length", "0")))

    def do_GET(self):
        if not check_serving_peer(self):
            return
        outer = self.server.owner
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            metrics.write_exposition(self)
        elif path == "/debugz":
            self._json(200, events.snapshot())
        elif path == "/debugz/requests":
            self._json(200, outer.engine.requests())
        elif path == "/debugz/profile":
            outer._profile_get(self)
        elif self.path == "/healthz":
            if outer.error is not None:
                self._json(503, {"ok": False, "error": outer.error})
            else:
                self._json(200, {"ok": True})
        elif self.path == "/v1/stats":
            self._json(200, outer.engine.stats())
        elif self.path == "/v1/info":
            info = outer.engine.info()
            info["tokenizer"] = (outer.tokenizer.path
                                 if outer.tokenizer is not None else None)
            info["pool"] = outer.pool
            info["load"] = outer.load_snapshot()
            self._json(200, info)
        elif self.path == "/v1/weights":
            outer._stream_weights(self)
        elif path == "/v1/kv":
            outer._stream_kv(self)
        elif path == "/v1/slot":
            outer._stream_slot(self)
        else:
            self._json(404, {"error": f"no such path {self.path}"})

    def do_PUT(self):
        if not check_serving_peer(self):
            return
        outer = self.server.owner
        path = self.path.split("?", 1)[0]
        if path not in ("/v1/kv", "/v1/slot"):
            self._json(404, {"error": f"no such path {self.path}"})
            return
        if outer.error is not None:
            # Nothing would ever admit the continuation.
            self._json(503, {"error": outer.error})
            return
        outer._ingest(self, slot=path == "/v1/slot")

    def do_DELETE(self):
        """Release a hold, a staged import or a suspended-slot record:
        the router's cleanup after a ship.  Idempotent: an unknown id
        answers ``{"ok": false}`` (the TTL may have swept it)."""
        if not check_serving_peer(self):
            return
        engine = self.server.owner.engine
        path, _, query = self.path.partition("?")
        if path not in ("/v1/kv", "/v1/slot"):
            self._json(404, {"error": f"no such path {self.path}"})
            return
        params = parse_qs(query)
        try:
            if path == "/v1/slot":
                ok = engine.release_migrated(int(params["rid"][0]))
            elif "rid" in params:
                ok = engine.release_kv_hold(int(params["rid"][0]))
            else:
                ok = engine.release_kv_import(int(params["import"][0]))
        except (KeyError, ValueError):
            self._json(400, {"error": "need ?rid=" if path == "/v1/slot"
                             else "need ?rid= or ?import="})
            return
        self._json(200, {"ok": bool(ok)})

    def do_POST(self):
        if not check_serving_peer(self):
            return
        outer = self.server.owner
        if self.path == "/v1/drain":
            # Before the error latch: draining a wedged backend is legal
            # and idempotent (there is just nothing left to migrate).
            outer.begin_drain()
            self._json(200, {"ok": True, "draining": True,
                             "in_flight": outer.engine.in_flight()})
            return
        if self.path.split("?", 1)[0] == "/debugz/profile":
            # Before the error latch too: a trace of a wedged backend is
            # what a capture is for.
            self._profile_post(outer)
            return
        completions = self.path in ("/v1/completions",
                                    "/v1/chat/completions")
        if not completions and self.path not in (
                "/v1/generate", "/v1/embed", "/v1/beam"):
            self._json(404, {"error": f"no such path {self.path}"})
            return
        if outer.error is not None:
            # A dead step thread or a standing stall verdict: fail fast
            # instead of queueing work nothing will drive.
            self._json(503, {"error": outer.error})
            return
        if self.path in ("/v1/embed", "/v1/beam"):
            self._slot_free(outer.engine)
            return
        # Join the caller's W3C trace: the engine's phase spans go under
        # this server span.
        parent = tracing.parse_traceparent(
            self.headers.get(tracing.TRACEPARENT_KEY, ""))
        name = "serve.completions" if completions else "serve.generate"
        with tracing.start_span(name, component="oim-serve",
                                parent=parent) as span:
            if completions:
                self._completions(outer, span,
                                  chat=self.path.endswith("chat/completions"))
            else:
                self._generate(outer, span)

    def _profile_post(self, outer) -> None:
        try:
            length = int(self.headers.get("Content-Length") or 0)
            doc = json.loads(self.rfile.read(length)) if length else {}
        except ValueError:
            self._json(400, {"error": "malformed JSON body"})
            return
        seconds = doc.get("seconds", 2.0)
        if (not isinstance(seconds, (int, float)) or isinstance(seconds, bool)
                or not seconds > 0):
            self._json(400, {"error": "seconds must be a positive number"})
            return
        self._json(*outer.start_profile(float(seconds)))

    def _generate(self, outer, span) -> None:
        engine, tokenizer = outer.engine, outer.tokenizer
        try:
            body = json.loads(self._body() or b"{}")
            req = _parse_generate(body, self, tokenizer, outer.tls, span)
            span.attrs.update(prompt_tokens=len(req.tokens),
                              max_new_tokens=req.max_new_tokens,
                              stream=bool(body.get("stream")))
            self.want_logprobs = bool(body.get("logprobs"))
            if body.get("stream"):
                self._stream(outer, req, span)
                return
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
        span.attrs["generated"] = len(tokens)
        payload = {
            "tokens": tokens, "request_id": rid,
            "traceparent": tracing.SpanContext(
                span.trace_id, span.span_id).traceparent(),
        }
        if tokenizer is not None:
            payload["text"] = tokenizer.decode(tokens)
        if self.want_logprobs:
            payload["logprobs"] = lps
        self._json(200, payload)

    def _line(self, obj: dict) -> None:
        self.wfile.write((json.dumps(obj) + "\n").encode())

    def _stream(self, outer, req: GenRequest, span) -> None:
        """NDJSON token stream: the engine's callback only puts into a
        queue (it runs on the step thread), and this handler drains the
        queue onto the socket, decoding text deltas here when the server
        has a tokenizer.  Tokens come in dispatch order, a chunk at a
        time, and the ``(None, None)`` end exactly once, as the serial
        engine would deliver them (one chunk later at depth 2)."""
        engine = outer.engine
        decoder = (outer.tokenizer.stream_decoder()
                   if outer.tokenizer is not None else None)
        tokens_q: queue.Queue = queue.Queue()
        try:
            rid = engine.submit(
                req, on_token=lambda t, lp: tokens_q.put((t, lp)))
        except (QueueFullError, DeadlineExpiredError) as exc:
            span.status = "error: shed"
            self._json(429, {"error": str(exc)})
            return
        except (DrainingError, EngineFailedError) as exc:
            span.status = "error: unavailable"
            self._json(503, {"error": str(exc)})
            return
        try:
            # The headers inside the try: a client gone at once raises
            # here, and its request must still be cancelled and forgotten.
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("traceparent", tracing.SpanContext(
                span.trace_id, span.span_id).traceparent())
            self.end_headers()  # HTTP/1.0: the body ends on close
            while True:
                try:
                    token, logprob = tokens_q.get(timeout=600)
                except queue.Empty:
                    engine.cancel(rid, "stream timed out")
                    engine.forget(rid)
                    span.status = "error: timeout"
                    self._line({"error": f"request {rid} timed out"})
                    return
                if token is None:
                    break
                line = {"token": token}
                if decoder is not None:
                    line["text"] = decoder.push(token)
                if self.want_logprobs:
                    line["logprob"] = logprob
                self._line(line)
                self.wfile.flush()
            try:
                tokens, lps = engine.result_full(rid, timeout=30)
            except RequestFailedError as exc:
                engine.forget(rid)
                if exc.kind == "migrated":
                    # A migrate-out drain: the router ships this rid's
                    # /v1/slot record and splices the continuation.
                    span.status = "migrated"
                    self._line({"error": str(exc), "migrate": True,
                                "request_id": rid})
                else:
                    span.status = f"error: {exc.kind}"
                    self._line({"error": str(exc)})
                return
            except (RuntimeError, TimeoutError) as exc:
                engine.forget(rid)
                span.status = "error: aborted"
                self._line({"error": str(exc)})
                return
            span.attrs["generated"] = len(tokens)
            final = {"done": True, "tokens": tokens, "request_id": rid}
            if decoder is not None:
                tail = decoder.flush()
                if tail:
                    final["text"] = tail
            if self.want_logprobs:
                final["logprobs"] = lps
            self._line(final)
        except (BrokenPipeError, ConnectionResetError):
            # The client went away: stop decoding for nobody.
            engine.cancel(rid, "client disconnected")
            engine.forget(rid)
            span.status = "error: client disconnected"

    # -- the OpenAI surfaces ---------------------------------------------------

    def _completions(self, outer, span, chat: bool) -> None:
        """``/v1/completions`` (``chat`` False) or
        ``/v1/chat/completions``: ``n`` engine requests with seeds
        ``seed + i``, the decoded text of each cut at its first stop
        string (post hoc, the reference's rule), or one SSE stream.  A
        failure of one choice cancels and forgets the others."""
        engine, tokenizer = outer.engine, outer.tokenizer
        rids: list[int] = []
        try:
            body = json.loads(self._body() or b"{}")
            if chat:
                if tokenizer is None:
                    raise ValueError("chat completions need a server-side "
                                     "tokenizer (oim-serve --tokenizer-dir)")
                messages = body.get("messages")
                if not isinstance(messages, list) or not messages:
                    raise ValueError("messages must be a non-empty list")
                tokens = tokenizer.apply_chat_template(messages)
            else:
                prompt = body.get("prompt", "")
                if isinstance(prompt, list):
                    tokens = [int(t) for t in prompt]
                elif tokenizer is None:
                    raise ValueError(
                        "string prompts need a server-side tokenizer "
                        "(oim-serve --tokenizer-dir); send a token-id list "
                        "instead")
                else:
                    tokens = tokenizer.encode(str(prompt))
            stops = _completion_stops(body, tokenizer)
            n = int(body.get("n", 1))
            if not 1 <= n <= 8:
                raise ValueError("n must be in [1, 8]")
            stream = bool(body.get("stream"))
            if stream and (stops or n != 1):
                raise ValueError(
                    "stream=true supports neither stop strings nor n > 1")
            if stream and tokenizer is None:
                # Token ids joined into the text field would not parse.
                raise ValueError("stream=true needs a server-side tokenizer "
                                 "(oim-serve --tokenizer-dir)")
            max_tokens = int(body.get("max_tokens", 16))
            common = dict(
                tokens=tokens, max_new_tokens=max_tokens,
                temperature=float(body.get("temperature", 1.0)),
                deadline=_deadline(body, self.headers),
                span=tracing.SpanContext(span.trace_id, span.span_id),
                tenant=_tenant(self, outer.tls),
                eos_id=tokenizer.eos_id if tokenizer is not None else None,
                top_p=(float(body["top_p"])
                       if body.get("top_p") is not None else None),
                presence_penalty=float(body.get("presence_penalty", 0.0)),
                frequency_penalty=float(body.get("frequency_penalty", 0.0)),
            )
            seed = int(body.get("seed", 0))
            if stream:
                self._completions_stream(
                    outer, GenRequest(seed=seed, **common), body, chat)
                return
            for i in range(n):
                rids.append(engine.submit(GenRequest(seed=seed + i,
                                                     **common)))
        except (QueueFullError, DeadlineExpiredError) as exc:
            self._forget_all(engine, rids, cancel="batch sibling shed")
            self._json(429, {"error": {"message": str(exc)}})
            return
        except (DrainingError, EngineFailedError) as exc:
            self._forget_all(engine, rids, cancel="batch sibling shed")
            self._json(503, {"error": {"message": str(exc)}})
            return
        except (KeyError, TypeError, ValueError) as exc:
            self._json(400, {"error": {"message": str(exc)}})
            return
        choices, completion_tokens = [], 0
        for i, rid in enumerate(rids):
            try:
                out = engine.result(rid, timeout=600)
            except TimeoutError:
                self._forget_all(engine, rids[i:],
                                 cancel="client wait timed out")
                self._json(503, {"error": {"message": f"{rid} timed out"}})
                return
            except RequestFailedError as exc:
                self._forget_all(engine, rids[i + 1:],
                                 cancel="batch sibling failed")
                self._json(_FAILED_STATUS.get(exc.kind, 500),
                           {"error": {"message": str(exc)}})
                return
            except RuntimeError as exc:
                self._forget_all(engine, rids[i + 1:],
                                 cancel="batch sibling failed")
                self._json(500, {"error": {"message": str(exc)}})
                return
            completion_tokens += len(out)
            choice = {"index": i, "logprobs": None, "finish_reason": (
                "length" if len(out) >= max_tokens else "stop")}
            if tokenizer is not None:
                text, cut = _cut_at_stops(tokenizer.decode(out), stops)
                if cut:
                    choice["finish_reason"] = "stop"
                if chat:
                    choice["message"] = {"role": "assistant",
                                         "content": text}
                else:
                    choice["text"] = text
            else:
                choice["text"] = ""
                choice["tokens"] = out
            choices.append(choice)
        span.attrs.update(prompt_tokens=len(tokens), n=n,
                          generated=completion_tokens)
        self._json(200, {
            "id": f"{'chatcmpl' if chat else 'cmpl'}-{rids[0]}",
            "object": "chat.completion" if chat else "text_completion",
            "created": int(time.time()),
            "model": body.get("model", "oim-tpu"),
            "choices": choices,
            "usage": {"prompt_tokens": len(tokens),
                      "completion_tokens": completion_tokens,
                      "total_tokens": len(tokens) + completion_tokens},
        })

    @staticmethod
    def _forget_all(engine, rids, cancel: str | None = None) -> None:
        """Release the results of ``rids`` (cancelling each first with
        ``cancel``): a request of n choices failing part way must neither
        strand its other results nor decode them for nobody."""
        for rid in rids:
            if cancel is not None:
                engine.cancel(rid, cancel)
            engine.forget(rid)

    def _completions_stream(self, outer, req: GenRequest, body,
                            chat: bool) -> None:
        """An SSE stream of OpenAI completion chunks (chat: deltas),
        then a chunk with the finish reason and ``data: [DONE]``.  The
        callback only queues (step thread); decoding runs here."""
        engine = outer.engine
        tokens_q: queue.Queue = queue.Queue()
        decoder = outer.tokenizer.stream_decoder()
        rid = engine.submit(req, on_token=lambda t, lp: tokens_q.put((t, lp)))
        created = int(time.time())

        def chunk(text, finish=None) -> bytes:
            if chat:
                choice = {"index": 0, "finish_reason": finish, "delta": (
                    {"role": "assistant", "content": text}
                    if text or finish is None else {})}
            else:
                choice = {"index": 0, "text": text, "finish_reason": finish,
                          "logprobs": None}
            return ("data: " + json.dumps({
                "id": f"{'chatcmpl' if chat else 'cmpl'}-{rid}",
                "object": ("chat.completion.chunk" if chat
                           else "text_completion"),
                "created": created,
                "model": body.get("model", "oim-tpu"),
                "choices": [choice],
            }) + "\n\n").encode()

        try:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            emitted = 0
            while True:
                token, _ = tokens_q.get(timeout=600)
                if token is None:
                    tail = decoder.flush()
                    if tail:
                        self.wfile.write(chunk(tail))
                    finish = ("length" if emitted >= req.max_new_tokens
                              else "stop")
                    self.wfile.write(chunk("", finish=finish))
                    self.wfile.write(b"data: [DONE]\n\n")
                    engine.forget(rid)
                    return
                emitted += 1
                delta = decoder.push(token)
                if delta:
                    self.wfile.write(chunk(delta))
                    self.wfile.flush()
        except queue.Empty:
            # A terminal error event: a silent close would read as done.
            engine.cancel(rid, "stream timed out")
            engine.forget(rid)
            try:
                self.wfile.write(b"data: " + json.dumps({"error": {
                    "message": f"request {rid} timed out"}}).encode()
                    + b"\n\n")
            except (BrokenPipeError, ConnectionResetError):
                pass
        except (BrokenPipeError, ConnectionResetError):
            engine.cancel(rid, "client disconnected")
            engine.forget(rid)

    def _slot_free(self, engine: Engine) -> None:
        """``/v1/embed`` or ``/v1/beam``: slot-free work run on this
        handler thread."""
        tokenizer = self.server.owner.tokenizer
        try:
            body = json.loads(self._body() or b"{}")
            tokens = _prompt_tokens(body, tokenizer)
            if self.path == "/v1/embed":
                vec = engine.embed(tokens)
                payload = {"embedding": vec, "dim": len(vec)}
            else:
                toks, score = engine.beam(
                    tokens,
                    max_new_tokens=int(body.get("max_new_tokens", 16)),
                    beam_size=int(body.get("beam_size", 4)),
                    alpha=float(body.get("alpha", 0.6)),
                    eos_id=_default_eos(body, tokenizer),
                )
                payload = {"tokens": toks, "score": score}
                if tokenizer is not None:
                    payload["text"] = tokenizer.decode(toks)
        except (DrainingError, EngineFailedError) as exc:
            self._json(503, {"error": str(exc)})
            return
        except (KeyError, TypeError, ValueError) as exc:
            self._json(400, {"error": str(exc)})
            return
        self._json(200, payload)


class ServeServer:
    """Owns the engine's step thread, the HTTP listener and, with
    ``watchdog_interval`` > 0, a ``StallWatchdog``.  ``start()`` returns
    self; ``port`` is the bound port (0 → ephemeral).  ``ssl_context``
    (``httptls.server_ssl_context``) makes the listener mTLS;
    ``tokenizer`` (a ``texttok.TextTokenizer``, or anything with its
    interface) turns on the text and OpenAI surfaces.  ``pool`` is the
    instance's disaggregation role (``prefill``, ``decode`` or
    ``mixed``), shown in ``/v1/info`` and its ``load`` for the router."""

    def __init__(self, engine: Engine, host: str = "127.0.0.1",
                 port: int = 0, ssl_context=None, tokenizer=None,
                 watchdog_interval: float = 0.0,
                 stall_multiplier: float = 8.0, stall_floor_s: float = 10.0,
                 pool: str = "mixed"):
        if pool not in disagg.POOLS:
            raise ValueError(
                f"pool must be one of {disagg.POOLS}, got {pool!r}")
        self.pool = pool
        self.engine = engine
        self.tokenizer = tokenizer
        self.tls = ssl_context is not None
        # /debugz/profile: its state and worker under a lock of their own,
        # never the engine's lock or the error latch, so that a capture
        # can be taken of a wedged backend.
        self._profile_lock = threading.Lock()
        self._profile: dict | None = None
        self._profile_thread: threading.Thread | None = None
        # Held by the step thread around each step and by a profile's
        # tracer start and stop (``_run_profile``).
        self._step_gate = threading.Lock()
        # Set when the step thread dies (for good) or while a stall
        # verdict stands (cleared when the wait returns); the watchdog
        # and the step thread change it under _error_lock, handlers read
        # it bare.
        self.error: str | None = None
        self._error_lock = threading.Lock()
        self._stall_error = False
        self._stop = threading.Event()
        # The listener and the watchdog reach the server through a weak
        # proxy: a stopped server holds its engine in no reference cycle.
        owner = weakref.proxy(self)
        self.watchdog = (
            StallWatchdog(engine,
                          on_stall=lambda message: owner._on_stall(message),
                          on_clear=lambda: owner._on_stall_clear(),
                          interval=watchdog_interval,
                          multiplier=stall_multiplier,
                          floor_s=stall_floor_s)
            if watchdog_interval > 0 else None
        )
        self._httpd = (
            TLSThreadingHTTPServer((host, port), _Handler, ssl_context)
            if ssl_context is not None
            else ThreadingHTTPServer((host, port), _Handler))
        self._httpd.owner = owner
        self.host, self.port = self._httpd.server_address[:2]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._step_thread = threading.Thread(target=self._step_loop,
                                             daemon=True)

    # -- the stall watchdog's verdicts ----------------------------------------

    def _on_stall(self, message: str) -> None:
        """Fail in-flight requests fast with the retryable "stalled" kind
        (503 with Retry-After) and turn ``/healthz`` 503."""
        with self._error_lock:
            if self.error is None:
                self.error = message
                self._stall_error = True
        self.engine.abort(message, kind="stalled")

    def _on_stall_clear(self) -> None:
        """The wedged wait returned: ``/healthz`` is 200 again, unless
        the step thread died meanwhile (that error stays)."""
        with self._error_lock:
            if self._stall_error:
                self.error = None
                self._stall_error = False

    # -- shipping -------------------------------------------------------------

    def load_snapshot(self) -> dict:
        """The engine's live pressure plus this instance's pool role:
        ``/v1/info``'s ``load``."""
        return dict(self.engine.load(), pool=self.pool)

    def begin_drain(self) -> None:
        """Migrate-out drain (``POST /v1/drain``): stop admitting, and
        have the step thread suspend every in-flight request into a
        ``/v1/slot`` record at its next step.  Idempotent; any thread."""
        self.engine.begin_migrate_out()

    def _unavailable(self, handler, what: str) -> bool:
        """Refuse (503) a route that reads the device while the error
        latch stands: against a wedged card the read would hang this
        handler thread."""
        if self.error is None:
            return False
        handler._json(503, {"error": f"{what} unavailable: {self.error}"})
        return True

    def _stream_weights(self, handler) -> None:
        """``GET /v1/weights``: the reference's flat parameter dict in
        its framing — manifest, then each leaf's bytes in manifest order,
        each made and copied down as it is sent.  A mesh's leader gathers
        each tensor whole from the ranks' shards as its part is made
        (``Engine.weight_leaves``), on the host."""
        if self._unavailable(handler, "weights"):
            return
        leaves = self.engine.weight_leaves()
        manifest = [{"name": leaf.name, "dtype": leaf.dtype,
                     "shape": list(leaf.shape)} for leaf in leaves]
        total = sum(math.prod(leaf.shape) * (
            1 if leaf.dtype == "int4"
            else disagg.torch_dtype(leaf.dtype).itemsize) for leaf in leaves)
        parts = [part for leaf in leaves for part in leaf.parts]
        device = (self.engine.device if self.engine.mesh is None
                  else torch.device("cpu"))
        _send_transfer(handler, manifest, total,
                       _weight_chunks(device, parts))

    def _send_export(self, handler, manifest, arrays) -> None:
        total = sum(a.numel() * a.element_size() for a in arrays)
        _send_transfer(handler, manifest, total,
                       (_leaf_views(a) for a in arrays))

    def _stream_kv(self, handler) -> None:
        """``GET /v1/kv?rid=N`` (held KV) or ``?prefix=D`` (a resident
        prefix entry): 404 when there is nothing of that name, 409 when
        this engine cannot ship (dense, packed int4)."""
        if self._unavailable(handler, "KV export"):
            return
        params = parse_qs(handler.path.partition("?")[2])
        prefix = (params.get("prefix") or [""])[0]
        try:
            if prefix:
                manifest, arrays = self.engine.export_kv_prefix(prefix)
            else:
                manifest, arrays = self.engine.export_kv(
                    int(params["rid"][0]))
        except (KeyError, ValueError):
            handler._json(400, {"error": "need ?rid=<request id> or "
                                         "?prefix=<digest>"})
            return
        except disagg.KvIneligibleError as exc:
            missing = ("no held KV" in str(exc)
                       or "no resident prefix" in str(exc))
            handler._json(404 if missing else 409, {"error": str(exc)})
            return
        self._send_export(handler, manifest, arrays)

    def _stream_slot(self, handler) -> None:
        """``GET /v1/slot?rid=N``: one suspended slot's record (the KV
        wire with its ``"slot"`` branch); 404 when the rid has no record
        (released, swept or never suspended here), 409 when it cannot
        ship."""
        if self._unavailable(handler, "slot export"):
            return
        params = parse_qs(handler.path.partition("?")[2])
        try:
            rid = int(params["rid"][0])
        except (KeyError, ValueError):
            handler._json(400, {"error": "need ?rid=<request id>"})
            return
        try:
            manifest, arrays = self.engine.export_slot(rid)
        except disagg.KvIneligibleError as exc:
            code = 404 if "no migrated slot" in str(exc) else 409
            handler._json(code, {"error": str(exc)})
            return
        self._send_export(handler, manifest, arrays)

    def _ingest(self, handler, slot: bool) -> None:
        """``PUT /v1/kv`` or ``PUT /v1/slot``: stage a shipped state
        (validated against this engine, blocks reserved all-or-nothing):
        a hold becomes a continuation's ``kv_import`` (``{"import_id",
        "rows"}``), a prefix entry is installed (``{"prefix", "rows"}``,
        rows 0 when already resident), a slot echoes its branch
        (``{"import_id", "rows", "slot"}``).  409 on a mismatch, 429 on
        pool exhaustion, 400 on a malformed body."""
        engine = self.engine
        try:
            manifest, data = disagg.unpack_transfer(handler._body())
            if slot:
                import_id, rows, meta = engine.import_slot(manifest, data)
                reply = {"import_id": import_id, "rows": rows, "slot": meta}
            elif manifest.get("prefix"):
                digest, rows = engine.import_kv_prefix(manifest, data)
                reply = {"prefix": digest, "rows": rows}
            else:
                import_id, rows = engine.import_kv(manifest, data)
                reply = {"import_id": import_id, "rows": rows}
        except disagg.KvCapacityError as exc:
            handler._json(429, {"error": str(exc)})
            return
        except (disagg.KvGeometryError, disagg.KvIneligibleError) as exc:
            handler._json(409, {"error": str(exc)})
            return
        except (KeyError, TypeError, ValueError) as exc:
            handler._json(400, {"error": str(exc)})
            return
        handler._json(200, reply)

    # -- on-demand profiling ----------------------------------------------------

    def start_profile(self, seconds: float) -> tuple[int, dict]:
        """Start a bounded ``torch.profiler`` capture into the flight
        dir; (HTTP code, payload).  One at a time: 409 while one runs."""
        seconds = max(PROFILE_MIN_S, min(float(seconds), PROFILE_MAX_S))
        with self._profile_lock:
            if (self._profile is not None
                    and self._profile["state"] == "running"):
                return 409, {"error": "a profile capture is already running",
                             "profile": dict(self._profile)}
            out_dir = os.path.join(
                events.flight_dir(),
                f"oim-profile-{os.getpid()}-{int(time.time() * 1000)}")
            self._profile = {"state": "running", "dir": out_dir,
                             "seconds": seconds, "started_ts": time.time(),
                             "init_s": 0.0, "window_ts": [0.0, 0.0],
                             "tar": "", "tar_bytes": 0, "error": ""}
            # The previous worker has finished (its state says so): join
            # it, so that stop() has one thread to reap.
            if self._profile_thread is not None:
                self._profile_thread.join(timeout=5)
            self._profile_thread = threading.Thread(
                target=self._run_profile, args=(out_dir, seconds),
                name="serve-profile", daemon=True)
            self._profile_thread.start()
            return 202, {"ok": True, "profile": dict(self._profile)}

    def _run_profile(self, out_dir: str, seconds: float) -> None:
        """The capture's thread: CPU activity, plus the card's when the
        engine runs there, for ``seconds`` (less when the server stops);
        the Chrome trace into ``out_dir``, then tarred beside it."""
        try:
            # Imported here: a server pays for the profiler only when an
            # operator asks for a trace.
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.engine.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            os.makedirs(out_dir, exist_ok=True)
            prof = profile(activities=activities)
            t0 = time.time()
            # The tracer starts and stops with no step in flight on the
            # step thread: its start and stop hold the interpreter lock
            # while they take the tracer's own locks, which the card's
            # runtime calls on the step thread take too.  The first start
            # in a process pays the tracer's set-up (``init_s``).
            with self._step_gate:
                prof.start()
            t1 = time.time()
            with self._profile_lock:
                self._profile.update(init_s=t1 - t0, window_ts=[t1, 0.0])
            try:
                self._stop.wait(seconds)
            finally:
                with self._step_gate:
                    prof.stop()
            with self._profile_lock:
                self._profile["window_ts"][1] = time.time()
            prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
            tar_path = out_dir + ".tar.gz"
            with tarfile.open(tar_path, "w:gz") as tar:
                tar.add(out_dir, arcname=os.path.basename(out_dir))
            size = os.path.getsize(tar_path)
            with self._profile_lock:
                self._profile.update(state="done", tar=tar_path,
                                     tar_bytes=size, done_ts=time.time())
            events.emit("serve.profile", component="serve",
                        subject=os.path.basename(tar_path), seconds=seconds,
                        path=tar_path, bytes=size)
        except Exception as exc:
            with self._profile_lock:
                self._profile.update(state="failed",
                                     error=f"{type(exc).__name__}: {exc}")

    def _profile_get(self, handler) -> None:
        """``GET /debugz/profile``: the status; ``?download=1`` the
        finished capture's tarball (404 before any, 409 while running,
        410 when its file is gone)."""
        query = parse_qs(handler.path.partition("?")[2])
        with self._profile_lock:
            doc = dict(self._profile) if self._profile is not None else None
        if "download" not in query:
            handler._json(200, {"profile": doc})
            return
        if doc is None or doc["state"] != "done":
            code = 409 if doc is not None and doc["state"] == "running" \
                else 404
            handler._json(code, {"error": "no finished profile to download",
                                 "profile": doc})
            return
        try:
            with open(doc["tar"], "rb") as f:
                body = f.read()
        except OSError as exc:
            handler._json(410, {"error": f"trace artifact gone: {exc}"})
            return
        handler.send_response(200)
        handler.send_header("Content-Type", "application/gzip")
        handler.send_header("Content-Length", str(len(body)))
        handler.send_header(
            "Content-Disposition",
            f'attachment; filename="{os.path.basename(doc["tar"])}"')
        handler.end_headers()
        handler.wfile.write(body)

    # -- lifecycle -------------------------------------------------------------

    def _step_loop(self) -> None:
        while not self._stop.is_set():
            try:
                if self.engine.pending():
                    with self._step_gate:
                        self.engine.step()
                else:
                    time.sleep(0.005)
            except Exception as exc:  # step-thread death = service death
                message = f"{type(exc).__name__}: {exc}"
                with self._error_lock:
                    # Over a stall verdict too: a dead step thread is the
                    # stronger condition, and permanent.
                    self.error = message
                    self._stall_error = False
                # step() already latched the crash and failed every
                # waiter; this abort is a backstop.
                self.engine.abort(message)
                return

    def start(self) -> "ServeServer":
        self._http_thread.start()
        self._step_thread.start()
        if self.watchdog is not None:
            self.watchdog.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self.watchdog is not None:
            self.watchdog.stop()
        self._httpd.shutdown()
        self._httpd.server_close()
        self._http_thread.join(timeout=10)
        self._step_thread.join(timeout=60)
        # _stop ended a capture's window early; reap its thread.
        with self._profile_lock:
            thread, self._profile_thread = self._profile_thread, None
        if thread is not None:
            thread.join(timeout=10)
