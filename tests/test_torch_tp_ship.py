"""KV shipping and peers under a mesh, on the CPU: two spawned gloo
ranks (``tests/torch_tp_worker.py``, one group for the module) against
the port's single-device engine.

The same steps (``torch_tp_worker.run_script``) run on the tp=2 leader
and on one device (``tests/torch_tp_cases.py``: Qwen2-style, GQA 4/2 —
one kv head a rank — f32):

- held KV, a prefix entry and a live (sampled) slot exported by the
  single-device engine import into tp=2 and continue its unbroken runs;
- tp=2's exports carry the whole kv heads — the names, dtypes, shapes,
  rows and tokens of one device's, the leaves within 1e-5 — and import
  into one device the same way;
- a tp=2 → tp=2 round trip (held KV, a prefix entry) returns the bytes
  bit for bit, and the ship counters are one device's;
- ranks loading from a single-device peer (int4 weights at the group
  that keeps ``wo`` whole) each hold ``shard_params``' slice bitwise,
  serve its greedy tokens and stream its ``/v1/weights`` bytes back.

Every rank's final buffers are bitwise rank 0's.
"""

import hashlib
import urllib.request

import numpy as np
import pytest

from oim_tpu_torch.models.transformer import TransformerConfig
from oim_tpu_torch.models.weights import shard_params
from oim_tpu_torch.serve.server import ServeServer
from torch_cpu_threads import one_torch_thread  # noqa: F401
from torch_tp_cases import (
    CFG,
    ENGINE,
    GREEDY,
    HELD,
    HELD_FULL,
    PREFIX_HIT,
    SHIP_ENGINE,
    SLOT,
    SOURCE_SCRIPT,
    GroupRuns,
    io_case,
    port_engine,
    rank_views,
    ship_script,
    single_outputs,
)
from torch_tp_worker import digests, run_script, same_buffers

PEER_WEIGHTS = "int4:32"  # wo replicated: the fitted rule's leaf


def _source():
    """The single-device exporter's held KV, prefix entry and slot."""
    engine = port_engine(io_case("source", script=[], engine=SHIP_ENGINE))
    held, _, prefix, slot = run_script(engine, SOURCE_SCRIPT)
    return held, prefix, slot


class _Runs(GroupRuns):
    """The ship case (importing the single-device exports) and the peer
    case (loading from a single-device server, kept up until the ranks
    answer) on one tp=2 group."""

    def __init__(self, tmp_dir: str):
        self.source = _source()
        self.ship = io_case("ship", script=ship_script(*self.source),
                            engine=SHIP_ENGINE)
        peer = io_case("peer", script=[("weights",), ("gen", GREEDY)],
                       engine=dict(ENGINE), weights=PEER_WEIGHTS)
        self.sibling = port_engine(peer)
        self.server = ServeServer(self.sibling, port=0).start()
        self.peer = dict(peer, peer=f"http://127.0.0.1:{self.server.port}")
        super().__init__(tmp_dir, [self.ship, self.peer])

    def close(self) -> None:
        super().close()
        self.server.stop()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    runs = _Runs(str(tmp_path_factory.mktemp("tp2ship")))
    try:
        yield runs
    finally:
        runs.close()


def _rows(arrays: list, n: int) -> list:
    """Each leaf's first ``n`` rows: [n_layers, N, block, ...] → [n_layers,
    n, ...]."""
    return [a.reshape(a.shape[0], -1, *a.shape[3:])[:, :n] for a in arrays]


def _dst() -> object:
    return port_engine(io_case("dst", script=[], engine=SHIP_ENGINE))


def _unbroken(request: dict) -> list:
    return run_script(_dst(), [("gen", [request])])[0][0][0]


@pytest.mark.parametrize("name", ["ship", "peer"])
def test_every_rank_ends_with_rank0_buffers(runs, name):
    answers = runs.get()[name]
    assert [a.get("error") for a in answers] == [None, None], answers
    assert same_buffers(answers) == []


def test_held_export_is_the_single_device_one(runs):
    """tp=2's held export: the names, dtypes, shapes, rows and tokens of
    one device's, the leaves within 1e-5."""
    tokens, manifest, arrays = runs.outputs("ship")[0]
    want_tokens, want_manifest, want_arrays = runs.source[0]
    assert tokens == want_tokens and manifest == want_manifest
    for got, want in zip(arrays, want_arrays):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_held_kv_ships_both_ways(runs):
    """One device's held KV continues on tp=2, and tp=2's on one device,
    each the unbroken run."""
    want = _unbroken(HELD_FULL)
    first = runs.source[0][0]
    assert runs.outputs("ship")[1][0] == want[len(first):]
    tokens, manifest, arrays = runs.outputs("ship")[0]
    engine = _dst()
    cont = run_script(engine, [("import_kv", manifest, arrays, dict(
        tokens=HELD["tokens"] + tokens, max_new_tokens=9))])[0]
    assert tokens + cont[0] == want


def test_kv_round_trip_is_bitwise(runs):
    """tp=2 → tp=2: exported, imported and exported again, the shipped
    rows come back bit for bit."""
    (m1, a1), (m2, a2) = runs.outputs("ship")[2]
    assert m2["rows"] == m1["rows"] + 1
    for first, again in zip(_rows(a1, m1["rows"]), _rows(a2, m1["rows"])):
        assert first.tobytes() == again.tobytes()


def test_prefix_round_trip_is_bitwise(runs):
    (m1, a1), (m2, a2) = runs.outputs("ship")[8]
    assert m1 == m2
    assert [a.tobytes() for a in a1] == [a.tobytes() for a in a2]


def test_prefix_ships_both_ways(runs):
    """One device's prefix entry installs on tp=2 and its hit is one
    device's hit; tp=2's entry installs on one device likewise."""
    out = runs.outputs("ship")
    assert out[6] == (runs.source[1][0]["prefix"], 16)
    want = _unbroken(dict(tokens=PREFIX_HIT, max_new_tokens=6))
    assert out[7][0][0] == want
    manifest, arrays = out[4]
    engine = _dst()
    got = run_script(engine, [
        ("import_prefix", manifest, arrays),
        ("gen", [dict(tokens=PREFIX_HIT, max_new_tokens=6)]),
        ("stats", ["prefix_hits", "prefix_fetch_installs"])])
    assert got[1][0][0] == want
    assert got[2] == {"prefix_hits": 1, "prefix_fetch_installs": 1}


def test_slot_ships_both_ways(runs):
    """A live sampled slot suspended on one device continues on tp=2 as
    the unbroken stream, and one suspended on tp=2 continues on one
    device."""
    want = _unbroken(SLOT)
    prior = runs.source[2][0]["tokens"]
    assert prior + runs.outputs("ship")[10][0] == want
    manifest, arrays = runs.outputs("ship")[9]
    single = single_outputs(runs.ship)[9]
    assert manifest["tokens"] == single[0]["tokens"]
    assert manifest["slot"]["sample_base"] == len(manifest["tokens"])
    engine = _dst()
    cont = run_script(engine, [("import_slot", manifest, arrays, dict(
        max_new_tokens=SLOT["max_new_tokens"] - len(manifest["tokens"]),
        temperature=0.7, seed=21))])[0]
    assert manifest["tokens"] + cont[0] == want


def test_ship_counters_match_single_device(runs):
    got, want = runs.outputs("ship"), single_outputs(runs.ship)
    assert got[-1] == want[-1]
    assert got[-1]["kv_exports"] >= 2 and got[-1]["slot_exports"] == 1


def test_peer_loads_each_rank_its_shard(runs):
    """Ranks loading from a single-device peer hold ``shard_params``' slice
    of its params bitwise, serve its greedy tokens, and stream its bytes
    back."""
    answers = runs.get()["peer"]
    assert [a.get("error") for a in answers] == [None, None], answers
    cfg = TransformerConfig(**CFG)
    for rank, view in enumerate(rank_views(tp=2)):
        want = digests(shard_params(runs.sibling.params, cfg, view))
        assert answers[rank]["params"] == want
    with urllib.request.urlopen(
            f"{runs.peer['peer']}/v1/weights", timeout=60) as resp:
        body = resp.read()
    assert answers[0]["outputs"][0] == hashlib.sha256(body).hexdigest()
    want = single_outputs(runs.peer)[1]
    assert [t for t, _ in answers[0]["outputs"][1]] == [t for t, _ in want]
