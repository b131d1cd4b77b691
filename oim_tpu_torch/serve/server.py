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
``tail_elisions``, ``inflight_dispatches``).  Streaming, text,
embeddings, beam search,
the OpenAI surface, KV shipping, profiling and the stall watchdog come
with later slices (ROADMAP Queue A: the rest of server.py).
"""

from __future__ import annotations

import json
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

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
_FAILED_STATUS = {"deadline_queue": 429, "deadline": 504}


def _parse_generate(body: dict) -> GenRequest:
    """A ``/v1/generate`` JSON body → GenRequest (KeyError, TypeError or
    ValueError on a malformed body)."""
    if body.get("stream"):
        raise ValueError("streaming is not ported yet; send stream=false")
    deadline = None
    if body.get("deadline_ms") is not None:
        ms = float(body["deadline_ms"])
        if ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {ms}")
        deadline = time.monotonic() + ms / 1000.0
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
        # Read so that the engine refuses what the port cannot do yet,
        # rather than serving such a request as if the field were absent.
        cache_prefix=bool(body.get("cache_prefix")),
        hold_kv=bool(body.get("hold_kv")),
        kv_import=(
            int(body["kv_import"]) if body.get("kv_import") is not None
            else None
        ),
        deadline=deadline,
        sample_base=int(body.get("sample_base", 0)),
    )


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
        else:
            self._json(404, {"error": f"no such path {self.path}"})

    def do_POST(self):
        outer = self.server.owner
        if self.path != "/v1/generate":
            self._json(404, {"error": f"no such path {self.path}"})
            return
        if outer.error is not None:
            self._json(503, {"error": outer.error})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            body = json.loads(self.rfile.read(length) or b"{}")
            req = _parse_generate(body)
            rid = outer.engine.submit(req)
        except (QueueFullError, DeadlineExpiredError) as exc:
            self._json(429, {"error": str(exc)})
            return
        except (DrainingError, EngineFailedError) as exc:
            self._json(503, {"error": str(exc)})
            return
        except (KeyError, TypeError, ValueError) as exc:
            self._json(400, {"error": str(exc)})
            return
        try:
            tokens, lps = outer.engine.result_full(rid, timeout=600)
        except TimeoutError:
            outer.engine.cancel(rid, "server-side wait timed out")
            outer.engine.forget(rid)
            self._json(503, {"error": f"request {rid} timed out"})
            return
        except RequestFailedError as exc:
            self._json(_FAILED_STATUS.get(exc.kind, 500),
                       {"error": str(exc)})
            return
        payload = {"tokens": tokens, "request_id": rid}
        if body.get("logprobs"):
            payload["logprobs"] = lps
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
