"""Spawned ranks for the port's sharded-serving tests.

A ``RankGroup`` starts ``world`` processes with the ``spawn`` method
(never ``fork``: the test process holds JAX), each on one PyTorch
thread, meeting in a gloo process group through a ``FileStore`` under
the test's temporary directory (no TCP port for parallel test workers
to race for), and builds one mesh over CPU devices.  Every rank then
takes cases from its own queue: it builds the port's ``Engine`` on the
mesh with the case's params and arguments; rank 0 serves the case's
requests (or makes its call) and then stops the followers, which run
``Engine.follow`` meanwhile.  Each rank answers with what it saw: rank
0's tokens and logprobs, or the error it raised, and every rank's final
device buffers, which the tests hold bitwise to rank 0's.  This module
imports no JAX: the children import it by name.
"""

import multiprocessing as mp
import os
import queue
import traceback

import numpy as np

TIMEOUT_S = 120.0


def _buffers(engine) -> dict:
    """The device state every rank must hold alike after a case: the
    decode chunk's outputs and token carry, the admission logits, the
    penalty counts and prompt lookup's history."""
    out = {"out": engine._buf.out, "lps": engine._buf.lps,
           "carry": engine._buf.tokens, "logits": engine._adm.logits,
           "tok_counts": engine._tok_counts, "history": engine._history}
    return {name: t.numpy().copy() for name, t in out.items()
            if t is not None}


def quantized(params: dict, weights: str) -> dict:
    """``params`` under ``weights``: "" as they are, "int8", or
    "int4:<group>"."""
    from oim_tpu_torch.ops.quant import (
        quantize_params_int4,
        quantize_params_int8,
    )

    if weights == "int8":
        return quantize_params_int8(params)
    if weights.startswith("int4:"):
        return quantize_params_int4(params, int(weights[5:]))
    return params


def _params(case: dict):
    from oim_tpu_torch.models.transformer import TransformerConfig
    from oim_tpu_torch.models.weights import from_jax_params

    cfg = TransformerConfig(**case["cfg"])
    params = from_jax_params(case["tree"], cfg)
    params = quantized(params, case.get("weights", ""))
    kwargs = dict(case.get("engine", {}))
    if "draft" in case:
        dcfg = TransformerConfig(**case["draft"]["cfg"])
        kwargs.update(draft_cfg=dcfg, draft_params=from_jax_params(
            case["draft"]["tree"], dcfg))
    return cfg, params, kwargs


def run_case(mesh, case: dict) -> dict:
    """One case on this rank (see the module docstring)."""
    from oim_tpu_torch.serve.engine import Engine, GenRequest

    cfg, params, kwargs = _params(case)
    try:
        engine = Engine(params, cfg, device="cpu", mesh=mesh, **kwargs)
    except Exception as exc:
        return {"error": f"{type(exc).__name__}: {exc}"}
    if mesh.rank != 0:
        engine.follow()
        return {"buffers": _buffers(engine)}
    answer = {}
    try:
        call = case.get("call")
        if call is not None:
            name, args = call
            getattr(engine, name)(*args)
        rids = [engine.submit(GenRequest(**r)) for r in case["requests"]]
        engine.run()
        full = [engine.result_full(rid) for rid in rids]
        answer["tokens"] = [list(t) for t, _ in full]
        answer["logprobs"] = [list(lp) for _, lp in full]
        answer["stats"] = {k: engine.stats()[k] for k in (
            "prefix_hits", "spec_drafted", "spec_accepted")}
        answer["info"] = engine.info()["engine"]
    except Exception as exc:
        answer["error"] = f"{type(exc).__name__}: {exc}"
    finally:
        engine.stop_followers()
    answer["buffers"] = _buffers(engine)
    return answer


def _rank_main(rank: int, world: int, store_path: str, sizes: dict,
               jobs, results) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from oim_tpu_torch.parallel import build_mesh

    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world)
        mesh = build_mesh(devices=["cpu"] * world, **sizes)
        while True:
            case = jobs.get()
            if case is None:
                break
            try:
                results.put((rank, case["name"], run_case(mesh, case)))
            except Exception:
                results.put((rank, case["name"],
                             {"error": traceback.format_exc()}))
        dist.destroy_process_group()
    except Exception:
        results.put((rank, None, {"error": traceback.format_exc()}))


class RankGroup:
    """``world`` spawned ranks over one gloo mesh of ``sizes`` (``tp``,
    ``ep``); ``run`` hands every rank the same cases and returns
    ``{case name: [each rank's answer]}``.  ``close`` joins every child
    (killing any that does not stop)."""

    def __init__(self, world: int, tmp_dir: str, **sizes):
        ctx = mp.get_context("spawn")
        self.world = world
        self.results = ctx.Queue()
        self.jobs = [ctx.Queue() for _ in range(world)]
        store = os.path.join(tmp_dir, "rendezvous")
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(r, world, store, sizes, self.jobs[r],
                                        self.results), daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def submit(self, cases: list) -> None:
        for case in cases:
            for q in self.jobs:
                q.put(case)

    def collect(self, names: list) -> dict:
        out = {name: [None] * self.world for name in names}
        for _ in range(len(names) * self.world):
            try:
                rank, name, answer = self.results.get(timeout=TIMEOUT_S)
            except queue.Empty:
                raise RuntimeError("a rank did not answer in time") from None
            if name is None:
                raise RuntimeError(f"rank {rank} failed:\n{answer['error']}")
            out[name][rank] = answer
        return out

    def close(self) -> None:
        for q in self.jobs:
            q.put(None)
        for p in self.procs:
            p.join(timeout=20)
            if p.is_alive():
                p.kill()
                p.join()


def same_buffers(answers: list) -> list:
    """The buffer names where some rank's state differs from rank 0's
    bit for bit."""
    lead = answers[0]["buffers"]
    bad = []
    for other in answers[1:]:
        for name, value in lead.items():
            got = other["buffers"].get(name)
            if got is None or got.tobytes() != value.tobytes():
                bad.append(name)
    return bad


def tree_of(params_np: dict) -> dict:
    """A reference params dict as plain numpy arrays (picklable)."""
    return {name: np.asarray(value) for name, value in params_np.items()}


def _collectives(mesh) -> dict:
    """The wrappers of ``parallel/collectives.py`` over the mesh's two
    ranks on ``tp``, each rank's input made from its index."""
    import torch

    from oim_tpu_torch.parallel import collectives as c

    i = mesh.axis_index("tp")
    x = torch.arange(8, dtype=torch.float32).reshape(4, 2) + 10 * i
    out = {
        "psum": c.psum(x.clone(), mesh, "tp"),
        "pmean": c.pmean(x.clone(), mesh, "tp"),
        "all_gather0": c.all_gather(x, mesh, "tp", dim=0),
        "all_gather1": c.all_gather(x, mesh, "tp", dim=1),
        "reduce_scatter": c.reduce_scatter(x, mesh, "tp", dim=0),
        "ppermute": c.ppermute_shift(x, mesh, "tp", 1),
        "all_to_all": c.all_to_all(x, mesh, "tp", split_axis=0,
                                   concat_axis=1),
        "counts": c.counters(),
    }
    return {k: v if k == "counts" else v.numpy() for k, v in out.items()}


def _parallel_rank(rank: int, world: int, store_path: str, results) -> None:
    """One rank of ``tests/test_torch_parallel.py``'s group: meshes built
    from sizes and from bootstraps, and every collective over tp."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from oim_tpu_torch.parallel import Bootstrap, build_mesh
    from oim_tpu_torch.parallel import mesh_from_bootstrap

    try:
        dist.init_process_group("gloo", store=dist.FileStore(store_path,
                                                             world),
                                rank=rank, world_size=world)
        cpus = ["cpu"] * world
        mesh = build_mesh(tp=2, devices=cpus)
        answer = {"shape": mesh.shape, "coords": mesh.coords,
                  "collectives": _collectives(mesh)}
        dp = mesh_from_bootstrap(Bootstrap(mesh=[2], chips=[{}] * 2),
                                 devices=cpus)
        answer["bootstrap_dp"] = dp.shape
        ep = mesh_from_bootstrap(Bootstrap(chips=[{}, {}]), ep=2,
                                 devices=cpus)
        answer["bootstrap_ep"] = ep.shape
        try:
            build_mesh(tp=4, devices=["cpu"] * 4)
        except ValueError as exc:
            answer["world_error"] = str(exc)
        dist.destroy_process_group()
        results.put((rank, answer))
    except Exception:
        results.put((rank, {"error": traceback.format_exc()}))


def _bootstrap_rank(path: str, results) -> None:
    """A workload's first call on a staged bootstrap: ``initialize``
    forms the process group and the mesh; one psum proves the group."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from oim_tpu_torch.parallel import collectives, initialize

    try:
        mesh = initialize(path, backend="gloo", devices=["cpu", "cpu"])
        x = torch.full((8,), float(dist.get_rank() + 1))
        total = collectives.psum(x, mesh, "dp")
        results.put((dist.get_rank(), {
            "world": dist.get_world_size(), "shape": mesh.shape,
            "sum": float(total.sum())}))
        dist.destroy_process_group()
    except Exception:
        results.put((-1, {"error": traceback.format_exc()}))


def spawn_all(target, args_per_rank: list) -> list:
    """Run ``target(*args, results)`` in one spawned process per entry
    of ``args_per_rank``; returns their answers by the rank each
    reports.  Every child is joined (killed past its time)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=target, args=(*args, results), daemon=True)
             for args in args_per_rank]
    for p in procs:
        p.start()
    try:
        answers = {}
        for _ in procs:
            rank, answer = results.get(timeout=TIMEOUT_S)
            if "error" in answer:
                raise RuntimeError(answer["error"])
            answers[rank] = answer
        return [answers[r] for r in sorted(answers)]
    finally:
        for p in procs:
            p.join(timeout=20)
            if p.is_alive():
                p.kill()
                p.join()
