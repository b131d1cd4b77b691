"""Shared pieces of the port's HTTP tests: the small Qwen2-style model
drawn by the JAX package (q/k/v biases, GQA 4/2, f32) and handed to the
port with ``from_jax_params``, so that both packages' engines compute
the same function; HTTP helpers; and ``StepGate``, which holds a
server's step thread at a point the test chooses (a drain or a stall at
a known place, never a race with a short stream)."""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np

from oim_tpu.models import TransformerConfig as JaxConfig
from oim_tpu.models import init_params as jax_init_params

from oim_tpu_torch.models.transformer import TransformerConfig
from oim_tpu_torch.models.weights import from_jax_params

CFG = dict(
    vocab_size=101, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=96, attn_bias=True, dtype="float32",
)
LOGPROB_ATOL = 1e-4


def jax_model():
    """(JAX config, JAX params, port config, port params) of one model."""
    jcfg = JaxConfig(**CFG, use_pallas=False)
    jparams = dict(jax_init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.RandomState(0)
    for name in ("bq", "bk", "bv"):
        jparams[name] = jnp.asarray(
            rng.randn(*jparams[name].shape).astype(np.float32) * 0.1)
    tree = {name: np.asarray(value) for name, value in jparams.items()}
    tcfg = TransformerConfig(**CFG)
    return jcfg, jparams, tcfg, from_jax_params(tree, tcfg)


def prompt(seed: int, n: int) -> list[int]:
    return np.random.RandomState(seed).randint(0, CFG["vocab_size"],
                                               n).tolist()


def url(server) -> str:
    return f"http://{server.host}:{server.port}"


def call(base: str, path: str, body=None, method=None, timeout=60):
    """(status, headers, parsed JSON or raw bytes) of one request; an
    HTTP error answers the same way instead of raising."""
    data = None
    if isinstance(body, (bytes, bytearray)):
        data = bytes(body)
    elif body is not None:
        data = json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status, headers, raw = resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as exc:
        status, headers, raw = exc.code, exc.headers, exc.read()
    kind = headers.get("Content-Type", "")
    return status, headers, json.loads(raw) if "json" in kind else raw


def stream_lines(base: str, body: dict, on_line=None,
                 timeout=60) -> list[dict]:
    """POST a streaming generate; every NDJSON line parsed, in order
    (``on_line`` sees each as it arrives)."""
    req = urllib.request.Request(
        base + "/v1/generate", json.dumps(dict(body, stream=True)).encode(),
        {"Content-Type": "application/json"})
    lines = []
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        for raw in resp:
            if raw.strip():
                lines.append(json.loads(raw))
                if on_line is not None:
                    on_line(lines[-1])
    return lines


class StepGate:
    """Holds a server's step thread before its next ``engine.step()``
    once ``when()`` is true, until ``release``: wraps the engine's
    ``step`` (either package's) on the instance; ``remove`` unwraps."""

    def __init__(self, engine, when):
        self.engine, self.when = engine, when
        self.held = threading.Event()
        self._go = threading.Event()
        step = engine.step

        def gated():
            if not self._go.is_set() and self.when():
                self.held.set()
                self._go.wait(60)
            return step()

        engine.step = gated

    @classmethod
    def after_tokens(cls, engine, n: int) -> "StepGate":
        """A gate that holds once the engine has made ``n`` more tokens
        than it has now (its own count, either package's)."""
        base = engine.stats()["tokens_generated"]
        return cls(engine,
                   lambda: engine.stats()["tokens_generated"] >= base + n)

    def release(self) -> None:
        self._go.set()

    def remove(self) -> None:
        self.release()
        vars(self.engine).pop("step", None)


def wait_until(cond, timeout: float = 30.0) -> bool:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.005)
    return True
