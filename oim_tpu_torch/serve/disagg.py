"""The paged-KV block-transfer wire: what one engine ships to another.

The port's own copy of the engine-facing half of
``oim_tpu/serve/disagg.py``: the fleet digest of a prefix entry, the
error taxonomy, the hold, import and migrated-slot records, and the
manifest codec.  A transfer is an 8-byte big-endian manifest length, a
JSON manifest (geometry, valid rows, prompt and emitted tokens,
sampling state, the leaf table), then each leaf's raw bytes in manifest
order.  The framing and the manifest are byte-compatible with the
reference's, so bytes one package packs unpack in the other.

Leaves are torch tensors on the host.  Dtype names are the reference's
(``str`` of a JAX dtype: ``"bfloat16"``, ``"float32"``, ``"int8"``),
mapped to torch dtypes here; numpy has no bfloat16, so a bf16 leaf
moves as raw 2-byte words (``view(torch.int16)`` out,
``torch.frombuffer`` in).  An unknown name is a malformed manifest
(``KvGeometryError``).

The HTTP clients of the server's ship routes are the reference's too:
``ship_kv`` (held KV, ``GET /v1/kv?rid=`` → ``PUT /v1/kv``),
``ship_slot`` (a suspended slot, ``GET /v1/slot?rid=`` → ``PUT
/v1/slot``), ``ship_prefix`` (a prefix entry, ``GET /v1/kv?prefix=`` →
``PUT /v1/kv``), the best-effort ``release_slot`` and ``release_kv``
(``DELETE``), and ``prewarm_from_peer`` (a new replica installs a
sibling's hottest prefix entries before it serves).  Each relays the
bytes verbatim and raises on any failure, for the caller to fall back to
recompute; the release calls and the prewarm never raise.
"""

from __future__ import annotations

import hashlib
import json
import struct
import time
import urllib.request
from dataclasses import dataclass, field

import numpy as np
import torch

# Pool roles (serve_main --pool): "prefill" backends take long-prompt
# admissions and serve /v1/kv exports; "decode" backends ingest shipped
# KV and stream the continuation; "mixed" (the default) does both and
# never takes part in a ship.
POOLS = ("prefill", "decode", "mixed")

# Hold/import bounds: a KV hold (exporter) or staged import (importer)
# pins pool blocks, so both are TTL'd and count-capped — an
# orchestrator that died mid-ship leaks nothing past the TTL, and a
# flood of ingests cannot pin the pool shut (oldest evicted first).
KV_HOLD_TTL_S = 60.0
KV_HOLD_MAX = 8
KV_IMPORT_TTL_S = 60.0
KV_IMPORT_MAX = 8

# Staged prefix installs pin pool blocks as staged imports do; the
# digest summary is cut to the hottest PREFIX_DIGEST_CAP entries.
PREFIX_IMPORT_TTL_S = 60.0
PREFIX_IMPORT_MAX = 8
PREFIX_DIGEST_CAP = 32

# Migrated-slot records pin their captured blocks as holds do, with the
# same TTL and no count cap: they are minted only from live slots and
# parked requests, so engine capacity bounds them.
MIGRATE_TTL_S = 60.0

MANIFEST_KIND = "oim-kv"
MANIFEST_VERSION = 1

# Manifest dtype names (the reference's) ↔ the torch dtypes of the
# leaves a pool ships: its payload and int8's f32 scales.
_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
    "int8": torch.int8,
}
_NAMES = {dtype: name for name, dtype in _DTYPES.items()}


def prefix_digest(tokens) -> str:
    """Stable content digest of a prefix-cache entry: the hash of the
    token ids it covers, the fleet-wide identity of a resident prefix.
    16 hex chars, as the reference computes it."""
    payload = ",".join(str(int(t)) for t in tokens).encode()
    return hashlib.sha256(b"oim-pfx:" + payload).hexdigest()[:16]


class KvTransferError(RuntimeError):
    """Base: this backend cannot serve or accept the transfer."""


class KvIneligibleError(KvTransferError):
    """Dense (non-paged) or packed-int4 engine, or no such hold, entry or
    record: the caller falls back to recompute (HTTP 409/404)."""


class KvGeometryError(KvTransferError):
    """The manifest's geometry or leaves do not match this engine (layer
    count, KV heads, head dim, block size, quantization, dtype), or the
    body is malformed: refused, never coerced (HTTP 409)."""


class KvCapacityError(KvTransferError):
    """The pool cannot reserve the shipped blocks now: backpressure
    (HTTP 429 + Retry-After), never a partial import."""


@dataclass
class KvHold:
    """A completed ``hold_kv`` request's retained KV: its block ids (one
    extra ref each, taken at finish), the valid row frontier, and the
    token record the continuation must extend."""

    rid: int
    blocks: tuple[int, ...]
    rows: int
    prompt_tokens: list[int]
    tokens: list[int]  # emitted
    sampling: dict
    t_created: float = field(default_factory=time.monotonic)


@dataclass
class KvImport:
    """A staged ingest: freshly reserved block ids (ref 1 each), the
    shipped frontier, the token record the continuation's prompt must
    start with, and the host payload (leaf name → tensor [n_layers,
    n_ship, block_size, ...]) the step thread writes at admission.  On a
    mesh's leader the payload is rank 0's kv-head part, and ``tag``
    names every rank's part (``Engine._stash``); -1 off a mesh."""

    import_id: int
    blocks: tuple[int, ...]
    rows: int
    tokens: list[int]  # prompt + emitted
    data: dict
    t_created: float = field(default_factory=time.monotonic)
    tag: int = -1


@dataclass
class SlotRecord:
    """A suspended live slot: EITHER ``blocks`` (device ids, one extra
    ref each: an active slot captured at the migrate wave) OR
    ``host_blocks`` (a parked request's host-tier payload, its refs
    taken over from the parked record).  ``meta`` becomes the
    manifest's ``"slot"`` branch (``sample_base``, the deadline
    remainder, tenant and tier, trace context)."""

    rid: int
    blocks: tuple[int, ...]
    host_blocks: tuple[int, ...]
    rows: int
    prompt_tokens: list[int]
    tokens: list[int]  # emitted on this backend
    sampling: dict
    meta: dict
    t_created: float = field(default_factory=time.monotonic)


def dtype_name(dtype: torch.dtype) -> str:
    """The manifest's name of a torch dtype (``"bfloat16"``, never
    ``"torch.bfloat16"``)."""
    try:
        return _NAMES[dtype]
    except KeyError:
        raise KvGeometryError(f"no wire name for dtype {dtype}") from None


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a manifest dtype name; an unknown name is a
    malformed manifest."""
    try:
        return _DTYPES[name]
    except (KeyError, TypeError):
        raise KvGeometryError(f"unknown leaf dtype {name!r}") from None


def leaf_bytes(leaf: torch.Tensor) -> bytes:
    """A leaf's raw bytes in C order; bf16 as its 2-byte words."""
    t = leaf.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def leaf_table(names, leaves) -> list[dict]:
    """The manifest's leaf table for ``leaves`` in order."""
    return [
        {"name": name, "dtype": dtype_name(leaf.dtype),
         "shape": [int(d) for d in leaf.shape]}
        for name, leaf in zip(names, leaves)
    ]


def build_manifest(
    *,
    geometry: dict,
    rows: int,
    prompt_tokens: list[int],
    tokens: list[int],
    sampling: dict,
    leaves: list[dict],
) -> dict:
    return {
        "kind": MANIFEST_KIND,
        "version": MANIFEST_VERSION,
        "geometry": geometry,
        "rows": rows,
        "prompt_tokens": list(prompt_tokens),
        "tokens": list(tokens),
        "sampling": dict(sampling),
        "leaves": leaves,
    }


def pack_transfer(manifest: dict, arrays) -> bytes:
    """One transfer as bytes: 8-byte big-endian manifest length, the
    JSON manifest, each leaf's (a host tensor's) raw bytes in manifest
    order."""
    mb = json.dumps(manifest, separators=(",", ":")).encode()
    parts = [struct.pack(">Q", len(mb)), mb]
    parts += [leaf_bytes(arr) for arr in arrays]
    return b"".join(parts)


def unpack_transfer(body: bytes) -> tuple[dict, dict]:
    """Parse one transfer body → (manifest, {leaf name: host tensor}).
    Raises KvGeometryError on any framing or shape problem: a torn or
    foreign body refuses cleanly, never ingests garbage."""
    try:
        if len(body) < 8:
            raise ValueError("short header")
        (mlen,) = struct.unpack(">Q", body[:8])
        if mlen > len(body) - 8:
            raise ValueError("manifest length exceeds body")
        manifest = json.loads(body[8:8 + mlen])
        if (
            not isinstance(manifest, dict)
            or manifest.get("kind") != MANIFEST_KIND
        ):
            raise ValueError(f"not a {MANIFEST_KIND} manifest")
        off = 8 + mlen
        data: dict[str, torch.Tensor] = {}
        for leaf in manifest["leaves"]:
            dtype = torch_dtype(leaf["dtype"])
            shape = tuple(int(d) for d in leaf["shape"])
            count = int(np.prod(shape)) if shape else 1
            nbytes = count * dtype.itemsize
            if off + nbytes > len(body):
                raise ValueError(f"leaf {leaf['name']} truncated")
            # A writable copy of the leaf's bytes (``bytes`` is not).
            raw = bytearray(body[off:off + nbytes])
            wire = torch.int16 if dtype == torch.bfloat16 else dtype
            tensor = torch.frombuffer(raw, dtype=wire, count=count)
            data[leaf["name"]] = tensor.view(dtype).reshape(shape)
            off += nbytes
        if off != len(body):
            raise ValueError(f"{len(body) - off} trailing bytes")
        return manifest, data
    except KvGeometryError:
        raise
    except (KeyError, TypeError, ValueError, struct.error) as exc:
        raise KvGeometryError(f"malformed KV transfer: {exc}") from exc


def validate_geometry(manifest: dict, geometry: dict) -> None:
    """Refuse a manifest whose geometry does not match this engine's
    (``geometry``: the engine's own dict, same keys), and a torn prefix
    or slot branch, before any payload is staged."""
    theirs = manifest.get("geometry")
    if not isinstance(theirs, dict):
        raise KvGeometryError("manifest carries no geometry")
    for key, want in geometry.items():
        got = theirs.get(key)
        if got != want:
            raise KvGeometryError(
                f"geometry mismatch on {key}: peer has {got!r}, "
                f"this engine has {want!r}"
            )
    rows = manifest.get("rows")
    n_tok = len(manifest.get("prompt_tokens", ())) + len(
        manifest.get("tokens", ())
    )
    if manifest.get("prefix"):
        # A prefix entry has one row per covered token and no emitted
        # tokens, and its digest hashes exactly those tokens.
        if manifest.get("tokens"):
            raise KvGeometryError(
                "a prefix transfer must not carry emitted tokens"
            )
        if not isinstance(rows, int) or rows < 1 or rows != n_tok:
            raise KvGeometryError(
                f"prefix rows {rows!r} inconsistent with {n_tok} "
                f"tokens (a prefix entry has one row per covered token)"
            )
        want = prefix_digest(manifest.get("prompt_tokens", ()))
        if manifest["prefix"] != want:
            raise KvGeometryError(
                f"prefix digest {manifest['prefix']!r} does not match "
                f"the shipped token record ({want})"
            )
    elif not isinstance(rows, int) or rows < 1 or rows != n_tok - 1:
        raise KvGeometryError(
            f"rows {rows!r} inconsistent with {n_tok} tokens "
            f"(valid rows must be tokens - 1)"
        )
    slot = manifest.get("slot")
    if slot is not None:
        # A live-slot transfer is hold-shaped plus a "slot" branch whose
        # sampling offset sampled exactness depends on.
        if manifest.get("prefix"):
            raise KvGeometryError(
                "a transfer cannot be both a prefix entry and a slot"
            )
        base = slot.get("sample_base") if isinstance(slot, dict) else None
        if not isinstance(base, int) or base < len(
            manifest.get("tokens", ())
        ):
            raise KvGeometryError(
                f"slot sample_base {base!r} inconsistent with "
                f"{len(manifest.get('tokens', ()))} emitted tokens"
            )


# ---------------------------------------------------------------------------
# HTTP clients of the ship routes


def _relay(opener, get_url: str, put_url: str, what: str,
           timeout: float) -> tuple[dict, int]:
    """GET a transfer off one backend and PUT the same bytes into
    another's ingest; returns (the ingest's JSON reply, bytes relayed).
    A short read (the source died mid-body) raises."""
    with opener(get_url, timeout=timeout) as resp:
        clen = int(resp.headers.get("Content-Length", "0"))
        body = resp.read()
    if clen and len(body) != clen:
        raise OSError(f"{what} fetch truncated: {len(body)} of {clen} bytes "
                      f"(the source backend died mid-ship)")
    req = urllib.request.Request(
        put_url, data=body,
        headers={"Content-Type": "application/octet-stream"}, method="PUT")
    with opener(req, timeout=timeout) as resp:
        return json.loads(resp.read()), len(body)


def ship_kv(opener, prefill_url: str, rid: int, decode_url: str,
            timeout: float = 30.0) -> tuple[int, int, int]:
    """Move one held KV state from the prefill backend into the decode
    backend's ingest: (import_id, rows, bytes shipped).  Raises on any
    failure (the caller recomputes); releases nothing (the caller
    releases the hold either way)."""
    reply, n = _relay(opener, f"{prefill_url}/v1/kv?rid={int(rid)}",
                      f"{decode_url}/v1/kv", "KV", timeout)
    return int(reply["import_id"]), int(reply["rows"]), n


def ship_slot(opener, src_url: str, rid: int, dst_url: str,
              timeout: float = 30.0) -> tuple[int, int, dict, int]:
    """Move one suspended live slot from the draining backend into the
    target's staging ingest: (import_id, rows, the slot branch, bytes
    shipped).  Raises on any failure (404 record gone, 409 geometry, 429
    capacity, a short read) for the caller's recompute; releases
    nothing."""
    reply, n = _relay(opener, f"{src_url}/v1/slot?rid={int(rid)}",
                      f"{dst_url}/v1/slot", "slot", timeout)
    slot = reply.get("slot")
    return (int(reply["import_id"]), int(reply["rows"]),
            slot if isinstance(slot, dict) else {}, n)


def ship_prefix(opener, src_url: str, digest: str, dst_url: str,
                timeout: float = 30.0) -> tuple[int, int]:
    """Move one resident prefix entry into the target's ingest, which
    installs it: (rows, bytes shipped).  Raises on any failure (the
    caller recomputes the prefill); nothing is held on the source."""
    reply, n = _relay(opener, f"{src_url}/v1/kv?prefix={digest}",
                      f"{dst_url}/v1/kv", "prefix", timeout)
    return int(reply["rows"]), n


def _delete(opener, url: str, timeout: float) -> None:
    """A best-effort DELETE: the TTL sweep is the backstop."""
    try:
        with opener(urllib.request.Request(url, method="DELETE"),
                    timeout=timeout):
            pass
    except Exception:
        pass


def release_slot(opener, url: str, rid: int, timeout: float = 5.0) -> None:
    """Best-effort release of a suspended-slot record on the draining
    source."""
    _delete(opener, f"{url}/v1/slot?rid={int(rid)}", timeout)


def release_kv(opener, url: str, *, rid: int | None = None,
               import_id: int | None = None, timeout: float = 5.0) -> None:
    """Best-effort release of a hold (``rid``, the prefill side) or a
    staged import (``import_id``, the decode side)."""
    query = (f"rid={int(rid)}" if rid is not None
             else f"import={int(import_id)}")
    _delete(opener, f"{url}/v1/kv?{query}", timeout)


def prewarm_from_peer(engine, peer_url: str, top_k: int, opener=None,
                      timeout: float = 30.0) -> int:
    """Install the ``top_k`` hottest prefix entries that the sibling at
    ``peer_url`` advertises (``/v1/info``'s ``load.prefix_digests``) on
    ``engine``, and land them in its pool; returns how many were
    installed.  Best-effort: any failure leaves the engine serving cold,
    never blocks it.  Call before the step thread starts: this thread
    writes the pool."""
    if top_k <= 0 or not getattr(engine, "paged", False):
        return 0
    opener = opener or urllib.request.urlopen
    try:
        with opener(f"{peer_url}/v1/info", timeout=timeout) as resp:
            info = json.loads(resp.read())
    except Exception:
        return 0
    digests = (info.get("load") or {}).get("prefix_digests") or []
    installed = 0
    for entry in digests[:max(0, int(top_k))]:
        digest = entry.get("digest") if isinstance(entry, dict) else None
        if not digest:
            continue
        try:
            with opener(f"{peer_url}/v1/kv?prefix={digest}",
                        timeout=timeout) as resp:
                body = resp.read()
            engine.import_kv_prefix(*unpack_transfer(body))
            installed += 1
        except Exception:
            continue  # per entry: the rest may still land
    if installed:
        engine.install_prefix_imports()
    return installed
