"""KV, prefix and slot shipping and embed between the JAX engine and the
port's tp=2 ranks, on the CPU: two spawned gloo ranks
(``tests/torch_tp_worker.py``) and the JAX engine (one device) exchange
held KV, a prefix entry and a live slot both ways through the wire's
bytes (``pack_transfer`` of one package, ``unpack_transfer`` of the
other), and each continuation is the unbroken run; the ranks' embedding
is the JAX engine's within 1e-5.  The same steps
(``torch_tp_worker.run_script``) drive both engines.  The JAX engine on
its own tp=2 mesh is ``tests/test_torch_tp_io_jax_tier.py``'s and
``tests/test_torch_tp_io_jax_qos.py``'s.
"""

import numpy as np
import pytest
import torch

from oim_tpu.serve import disagg as jdisagg

from oim_tpu_torch.serve import disagg
from torch_cpu_threads import one_torch_thread  # noqa: F401
from torch_tp_cases import (
    HELD,
    HELD_FULL,
    PREFIX_HIT,
    SHIP_ENGINE,
    SLOT,
    SYSTEM,
    GroupRuns,
    io_case,
    jax_engine,
    prompt,
    single_outputs,
)
from torch_tp_worker import run_script

# Greedy: the two packages' samplers draw differently, their argmax not.
GREEDY_SLOT = dict(tokens=SLOT["tokens"], max_new_tokens=20)
EMBED = prompt(42, 11)


def _to_port(manifest: dict, arrays: list) -> tuple:
    """A JAX export through the wire into the port's (manifest, arrays)."""
    manifest, data = disagg.unpack_transfer(jdisagg.pack_transfer(
        manifest, arrays))
    return manifest, [data[leaf["name"]].numpy()
                      for leaf in manifest["leaves"]]


def _to_jax(manifest: dict, arrays: list) -> tuple:
    """A port export through the wire into the JAX engine's (manifest,
    arrays)."""
    manifest, data = jdisagg.unpack_transfer(disagg.pack_transfer(
        manifest, [torch.from_numpy(a) for a in arrays]))
    return manifest, [data[leaf["name"]] for leaf in manifest["leaves"]]


class _Runs(GroupRuns):
    """The JAX engine's held KV, prefix entry and suspended slot,
    imported by the tp=2 ranks, whose own exports come back for the JAX
    engine to import."""

    def __init__(self, tmp_dir: str):
        super().__init__(tmp_dir, [])  # the ranks start meanwhile
        self.jax = jax_engine(SHIP_ENGINE)
        held, _, prefix, slot = run_script(self.jax, [
            ("hold", HELD),
            ("gen", [dict(tokens=SYSTEM, max_new_tokens=2,
                          cache_prefix=True)]),
            ("export_prefix", SYSTEM),
            ("suspend", GREEDY_SLOT, 5)])
        self.first, self.prefix = held[0], _to_port(*prefix)
        self.prior = slot[0]["tokens"]
        self.case = io_case("jax_ship", engine=SHIP_ENGINE, script=[
            ("import_kv", *_to_port(*held[1:]), dict(
                tokens=HELD["tokens"] + self.first, max_new_tokens=9)),
            ("hold", HELD),
            ("gen", [dict(tokens=SYSTEM, max_new_tokens=2,
                          cache_prefix=True)]),
            ("export_prefix", SYSTEM),
            ("flush",),
            ("import_prefix", *self.prefix),
            ("gen", [dict(tokens=PREFIX_HIT, max_new_tokens=6)]),
            ("suspend", GREEDY_SLOT, 5),
            ("import_slot", *_to_port(*slot), dict(
                max_new_tokens=20 - len(self.prior))),
            ("embed", EMBED),
            ("stats", ["prefix_hits", "prefix_fetch_installs",
                       "slot_imports", "slot_exports"])])
        self.submit([self.case])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    runs = _Runs(str(tmp_path_factory.mktemp("tp2jax")))
    try:
        yield runs
    finally:
        runs.close()


@pytest.fixture(scope="module")
def unbroken():
    """The port's single-device runs that no ship broke: held, prefix
    hit, slot (greedy tokens)."""
    out = single_outputs(io_case("jax_unbroken", engine=SHIP_ENGINE, script=[
        ("gen", [HELD_FULL]), ("gen", [dict(tokens=PREFIX_HIT,
                                            max_new_tokens=6)]),
        ("gen", [GREEDY_SLOT])]))
    return [o[0][0] for o in out]


@pytest.fixture(scope="module")
def back(runs):
    """The ranks' held KV, prefix entry and slot imported by the JAX
    engine and continued: its outputs and stats."""
    out = runs.outputs("jax_ship")
    tokens, manifest, arrays = out[1]
    slot = _to_jax(*out[7])
    return tokens, slot[0]["tokens"], run_script(runs.jax, [
        ("import_kv", *_to_jax(manifest, arrays), dict(
            tokens=HELD["tokens"] + tokens, max_new_tokens=9)),
        ("flush",),
        ("import_prefix", *_to_jax(*out[3])),
        ("gen", [dict(tokens=PREFIX_HIT, max_new_tokens=6)]),
        ("import_slot", *slot, dict(
            max_new_tokens=20 - len(slot[0]["tokens"]))),
        ("embed", EMBED)])


def test_held_kv_ships_between_jax_and_tp2(runs, unbroken, back):
    """The JAX engine's held KV continues on the tp=2 ranks, and the
    ranks' on the JAX engine, each the unbroken run."""
    want = unbroken[0]
    assert runs.first + runs.outputs("jax_ship")[0][0] == want
    tokens, _, out = back
    assert tokens == want[:len(tokens)]
    assert tokens + out[0][0] == want


def test_prefix_ships_between_jax_and_tp2(runs, unbroken, back):
    """The JAX engine's prefix entry installs on the ranks and its hit
    is the unbroken run, and the ranks' entry on the JAX engine."""
    out = runs.outputs("jax_ship")
    assert out[5] == (runs.prefix[0]["prefix"], 16)
    assert out[6][0][0] == unbroken[1]
    assert out[3][0]["prefix"] == runs.prefix[0]["prefix"]
    assert out[-1]["prefix_hits"] == out[-1]["prefix_fetch_installs"] == 1
    assert back[2][2] == (runs.prefix[0]["prefix"], 16)
    assert back[2][3][0][0] == unbroken[1]
    stats = runs.jax.stats()
    assert stats["prefix_fetch_installs"] == stats["prefix_hits"] == 1


def test_slot_ships_between_jax_and_tp2(runs, unbroken, back):
    """A live slot suspended on the JAX engine continues on the ranks as
    the unbroken stream, and one suspended on the ranks continues on the
    JAX engine."""
    out = runs.outputs("jax_ship")
    assert runs.prior + out[8][0] == unbroken[2]
    assert out[-1]["slot_imports"] == out[-1]["slot_exports"] == 1
    _, prior, cont = back
    assert prior + cont[4][0] == unbroken[2]


def test_embed_matches_jax(runs, back):
    np.testing.assert_allclose(runs.outputs("jax_ship")[9], back[2][5],
                               atol=1e-5, rtol=0)


def test_every_rank_ends_with_rank0_buffers(runs):
    from torch_tp_worker import same_buffers

    answers = runs.get()["jax_ship"]
    assert [a.get("error") for a in answers] == [None, None], answers
    assert same_buffers(answers) == []
