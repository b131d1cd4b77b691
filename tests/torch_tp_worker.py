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
device buffers, which the tests hold bitwise to rank 0's.  A case with a
``script`` runs ``run_script``'s steps on rank 0 instead (the block I/O
cases: the host tier, KV shipping, weights, beam and embed), and the
tests run the same steps on the single-device engine and on the JAX
engine (each step submits the engine's own package's ``GenRequest``);
a case with a ``peer`` URL loads every rank's shard from that server's
``/v1/weights``.  This module imports no JAX: the children import it by
name.
"""

import hashlib
import multiprocessing as mp
import os
import queue
import threading
import traceback
import urllib.request

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


def _params(case: dict, mesh=None):
    from oim_tpu_torch.checkpoint import load_params_from_peer
    from oim_tpu_torch.models.transformer import TransformerConfig
    from oim_tpu_torch.models.weights import from_jax_params
    from oim_tpu_torch.qos.policy import decode_policy

    cfg = TransformerConfig(**case["cfg"])
    if case.get("peer"):
        weights = case.get("weights", "")
        params = load_params_from_peer(
            case["peer"], cfg, "cpu", weight_quant=weights.split(":")[0],
            int4_group=int(weights[5:]) if weights.startswith("int4:")
            else 64, mesh=mesh)
    else:
        params = quantized(from_jax_params(case["tree"], cfg),
                           case.get("weights", ""))
    kwargs = dict(case.get("engine", {}))
    if isinstance(kwargs.get("qos"), str):
        kwargs["qos"] = decode_policy(kwargs["qos"])
    if "draft" in case:
        dcfg = TransformerConfig(**case["draft"]["cfg"])
        kwargs.update(draft_cfg=dcfg, draft_params=from_jax_params(
            case["draft"]["tree"], dcfg))
    return cfg, params, kwargs


def digests(params: dict) -> dict:
    """SHA-256 of each tensor's bytes of a port params tree, by dotted
    name."""
    from oim_tpu_torch.models.train import named_parameters

    return {name: hashlib.sha256(_host_bytes(t)).hexdigest()
            for name, t in named_parameters(params)}


def _host_bytes(t) -> bytes:
    import torch

    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def run_case(mesh, case: dict) -> dict:
    """One case on this rank (see the module docstring)."""
    from oim_tpu_torch.serve.engine import Engine, GenRequest

    cfg, params, kwargs = _params(case, mesh)
    extra = {"params": digests(params)} if case.get("peer") else {}
    try:
        engine = Engine(params, cfg, device="cpu", mesh=mesh, **kwargs)
    except Exception as exc:
        return {"error": f"{type(exc).__name__}: {exc}"}
    if mesh.rank != 0:
        engine.follow()
        return {"buffers": _buffers(engine), **extra}
    answer = dict(extra)
    try:
        if "script" in case:
            answer["outputs"] = run_script(engine, case["script"])
            return answer
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


# ---------------------------------------------------------------------------
# Scripts: the block I/O cases' steps, on a mesh's rank 0 or one device


def _np(arrays) -> list:
    """Exported arrays (the port's tensors or the JAX engine's arrays)
    as host numpy copies."""
    return [np.array(a.detach().cpu() if hasattr(a, "detach") else a)
            for a in arrays]


def _wire(engine, manifest: dict, arrays: list) -> dict:
    """{leaf name: array} as ``engine``'s import takes it: torch tensors
    for the port's, numpy arrays (the JAX wire's) for the JAX engine."""
    names = [leaf["name"] for leaf in manifest["leaves"]]
    if type(engine).__module__.startswith("oim_tpu_torch"):
        import torch

        arrays = [torch.from_numpy(np.asarray(a)) for a in arrays]
    return dict(zip(names, arrays))


def _submit(engine, request: dict, **extra) -> int:
    """Submit ``request`` as ``engine``'s own package's GenRequest (the
    port's or the JAX engine's)."""
    import sys

    module = sys.modules[type(engine).__module__]
    return engine.submit(module.GenRequest(**request, **extra))


def _gen(engine, requests: list) -> list:
    """Submit every request, run to the end: [(tokens, logprobs)]."""
    rids = [_submit(engine, r) for r in requests]
    engine.run()
    return [tuple(map(list, engine.result_full(rid, timeout=0)))
            for rid in rids]


def _late(engine, early: list, steps: int, late: list) -> list:
    """``early`` submitted and stepped ``steps`` times, then ``late``
    (a QoS preemption's premium arrival), run to the end."""
    rids = [_submit(engine, r) for r in early]
    for _ in range(steps):
        engine.step()
    rids += [_submit(engine, r) for r in late]
    engine.run()
    return [tuple(map(list, engine.result_full(rid, timeout=0)))
            for rid in rids]


def _hold(engine, request: dict) -> tuple:
    """A held request's (tokens, manifest, arrays), the hold released."""
    rid = _submit(engine, request, hold_kv=True)
    engine.run()
    tokens = list(engine.result(rid, timeout=0))
    manifest, arrays = engine.export_kv(rid)
    engine.release_kv_hold(rid)
    return tokens, manifest, _np(arrays)


def _import_kv(engine, manifest: dict, arrays: list, request: dict):
    """Import a held export and run its continuation ``request``."""
    import_id, _ = engine.import_kv(manifest,
                                    _wire(engine, manifest, arrays))
    return _gen(engine, [dict(request, kv_import=import_id)])[0]


def _export_prefix(engine, tokens: list) -> tuple:
    from oim_tpu_torch.serve.disagg import prefix_digest

    manifest, arrays = engine.export_kv_prefix(prefix_digest(tokens))
    return manifest, _np(arrays)


def _import_prefix(engine, manifest: dict, arrays: list) -> tuple:
    """Stage a shipped prefix entry and land it (this thread owns the
    pool): (digest, rows)."""
    out = engine.import_kv_prefix(manifest, _wire(engine, manifest, arrays))
    engine.install_prefix_imports()
    return out


def _suspend(engine, request: dict, min_tokens: int) -> tuple:
    """A live slot suspended by migrate-out mid-stream: its (manifest,
    arrays), the record released and the engine admitting again."""
    rid = _submit(engine, request)
    base = engine.stats()["tokens_generated"]
    for _ in range(40):
        engine.step()
        if engine.stats()["tokens_generated"] - base >= min_tokens:
            break
    engine.begin_migrate_out()
    engine.run()
    manifest, arrays = engine.export_slot(rid)
    engine.release_migrated(rid)
    engine._draining = engine._migrate_out = False
    return manifest, _np(arrays)


def _import_slot(engine, manifest: dict, arrays: list, request: dict):
    """Import a shipped slot and continue it (``request`` gives the
    budget and sampling; its prompt is the record's tokens)."""
    import_id, _, slot = engine.import_slot(
        manifest, _wire(engine, manifest, arrays))
    tokens = list(manifest["prompt_tokens"]) + list(manifest["tokens"])
    return _gen(engine, [dict(request, tokens=tokens, kv_import=import_id,
                              sample_base=slot["sample_base"])])[0]


def _roundtrip_kv(engine, request: dict) -> tuple:
    """Hold ``request``, export it (E1), import E1 and continue it by one
    token under a hold, export that (E2): (E1, E2), each (manifest,
    arrays); E2's first E1 rows are E1's."""
    tokens, manifest, arrays = _hold(engine, request)
    import_id, _ = engine.import_kv(manifest,
                                    _wire(engine, manifest, arrays))
    _, manifest2, arrays2 = _hold(engine, dict(
        request, tokens=list(request["tokens"]) + tokens, max_new_tokens=1,
        kv_import=import_id))
    return (manifest, arrays), (manifest2, arrays2)


def _roundtrip_prefix(engine, tokens: list) -> tuple:
    """Store prefix ``tokens``, export it (E1), drop it, import and land
    E1, export it again (E2): (E1, E2)."""
    _flush(engine)
    _gen(engine, [dict(tokens=tokens, max_new_tokens=2, cache_prefix=True)])
    first = _export_prefix(engine, tokens)
    _flush(engine)
    _import_prefix(engine, *first)
    return first, _export_prefix(engine, tokens)


def _try(engine, op: str, *args) -> str:
    """The error step ``op`` raises, as "Type: message" ("" if none)."""
    try:
        SCRIPT_OPS[op](engine, *args)
    except Exception as exc:
        return f"{type(exc).__name__}: {exc}"
    return ""


def _beam_during(engine, requests: list, beam: tuple) -> tuple:
    """A beam search called while ``requests`` decode on a step thread:
    (the streams, the beam's (tokens, score))."""
    rids = [_submit(engine, r) for r in requests]
    stepper = threading.Thread(target=engine.run)
    stepper.start()
    try:
        found = engine.beam(*beam)
    finally:
        stepper.join()
    return ([tuple(map(list, engine.result_full(rid, timeout=0)))
             for rid in rids], found)


def _storm(engine, requests: list, prompts: list) -> tuple:
    """More threads than cores, each embedding one of ``prompts`` (every
    one a record and a leader's pass inside the turn), while
    ``requests`` decode on a step thread, under a short switch interval:
    (the streams, the vectors).  Every thread is joined within its
    time."""
    import sys

    rids = [_submit(engine, r) for r in requests]
    vectors = [None] * len(prompts)

    def embed(i):
        vectors[i] = engine.embed(prompts[i])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=engine.run)] + [
            threading.Thread(target=embed, args=(i,))
            for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT_S)
        if any(t.is_alive() for t in threads):
            raise RuntimeError("a thread did not finish: deadlock")
    finally:
        sys.setswitchinterval(interval)
    engine.run()
    return ([tuple(map(list, engine.result_full(rid, timeout=0)))
             for rid in rids], vectors)


def _weights(engine) -> str:
    """SHA-256 of the body ``GET /v1/weights`` answers on this engine."""
    from oim_tpu_torch.serve.server import ServeServer

    server = ServeServer(engine, port=0).start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/v1/weights",
                timeout=60) as resp:
            return hashlib.sha256(resp.read()).hexdigest()
    finally:
        server.stop()


def _flush(engine) -> None:
    """Drop every prefix entry of both tiers, counter-silent."""
    engine._warming = True
    try:
        with engine._lock:
            engine._clear_prefix_cache_locked()
            engine._flush_host_tier_locked()
    finally:
        engine._warming = False


def _stats(engine, keys: list) -> dict:
    stats = engine.stats()
    return {k: stats[k] for k in keys}


SCRIPT_OPS = {
    "gen": _gen, "late": _late, "hold": _hold, "import_kv": _import_kv,
    "export_prefix": _export_prefix, "import_prefix": _import_prefix,
    "suspend": _suspend, "import_slot": _import_slot,
    "beam": lambda e, *a: e.beam(*a), "embed": lambda e, t: e.embed(t),
    "beam_during": _beam_during, "storm": _storm, "weights": _weights,
    "flush": _flush,
    "stats": _stats, "roundtrip_kv": _roundtrip_kv,
    "roundtrip_prefix": _roundtrip_prefix, "try": _try,
    "attr": lambda e, name: getattr(e, name),
}


def run_script(engine, steps: list) -> list:
    """Each step ``(op, *args)`` of ``SCRIPT_OPS`` on ``engine``, in
    order: their outputs."""
    return [SCRIPT_OPS[op](engine, *args) for op, *args in steps]


# ---------------------------------------------------------------------------
# Training cases: a case with ``train`` runs one of ``TRAIN_OPS`` on this
# rank of its mesh and answers with its blocks


def rank_blocks(state) -> dict:
    """``{"blocks": {name: (start, array)}, "moments": {name: (start,
    exp_avg, exp_avg_sq, count)}}``: this rank's parameter blocks and
    the moments its optimizer owns, each at its region's start in the
    whole leaf."""
    from oim_tpu_torch.checkpoint.manager import _moment_region, _region
    from oim_tpu_torch.models.train import named_parameters

    blocks = {name: ([s for s, _ in _region(state, name, t)],
                     t.detach().numpy().copy())
              for name, t in named_parameters(state.params)}
    moments = {}
    for owned in state.owned:
        opt = state.optimizer.state.get(owned.tensor)
        if opt:
            moments[owned.name] = (
                [s for s, _ in _moment_region(state, owned)],
                opt["exp_avg"].numpy().copy(),
                opt["exp_avg_sq"].numpy().copy(), float(opt["step"]))
    return {"blocks": blocks, "moments": moments,
            "moment_bytes": state.moment_bytes(), "step": state.step}


def _state(mesh, spec: dict):
    """A fresh ``TrainState`` on ``mesh``: the reference tree's masters
    cut to this rank's blocks (``tree``), or ``init_rank_params`` from
    ``seed``."""
    from oim_tpu_torch.models.train import OptimizerConfig, TrainState
    from oim_tpu_torch.models.transformer import TransformerConfig
    from oim_tpu_torch.models.weights import (
        from_jax_params,
        init_rank_params,
        serve_specs,
        shard_tensor,
    )

    cfg = TransformerConfig(**spec["cfg"])
    specs = serve_specs(cfg, mesh)
    if "tree" in spec:
        whole = from_jax_params(spec["tree"], cfg, master=True)
        params = {n: shard_tensor(n, t, specs, mesh)
                  for n, t in whole.items() if n != "layers"}
        params["layers"] = [{n: shard_tensor(n, t, specs, mesh)
                             for n, t in lp.items()}
                            for lp in whole["layers"]]
    else:
        params = init_rank_params(spec.get("seed", 0), cfg, mesh)
    return cfg, TrainState.create(params, OptimizerConfig(**spec["opt"]),
                                  mesh=mesh, specs=specs,
                                  zero1=spec.get("zero1", False))


def _train_steps(mesh, spec: dict) -> dict:
    """``spec["batches"]`` ([steps, B, T] global batches; this rank
    takes its dp block of rows, as the reference's global array splits
    over dp) through ``make_train_step`` on the mesh."""
    import torch

    from oim_tpu_torch.models.train import make_train_step

    cfg, state = _state(mesh, spec)
    init = rank_blocks(state)["blocks"] if spec.get("init") else None
    step = make_train_step(cfg, cuda_graph=False, mesh=mesh)
    dp, i = mesh.shape["dp"], mesh.axis_index("dp")
    metrics, digests = [], []
    for batch in spec["batches"]:
        rows = batch.shape[0] // dp
        tokens = torch.from_numpy(batch[i * rows:(i + 1) * rows]).long()
        state, m = step(state, tokens)
        metrics.append([float(m[k]) for k in ("loss", "ce", "aux")])
        digests.append({name: (start, hashlib.sha256(a.tobytes()).hexdigest())
                        for name, (start, a)
                        in rank_blocks(state)["blocks"].items()})
    return dict(rank_blocks(state), metrics=metrics, init=init,
                digests=digests)


def _train_main(mesh, spec: dict) -> dict:
    """``train_main``'s run of ``spec["argv"]`` as this rank of its mesh
    (the mesh the flags ask for)."""
    from oim_tpu_torch.cli import train_main

    args = train_main.build_parser().parse_args(spec["argv"])
    out = train_main._train(args, False, mesh)
    return dict(rank_blocks(out["state"]), losses=out["losses"],
                start_step=out["start_step"])


def _restore(mesh, spec: dict) -> dict:
    """The latest step of ``spec["dir"]`` restored onto this rank of the
    mesh (ZeRO-1 as ``spec`` asks)."""
    from oim_tpu_torch.checkpoint import Checkpointer, CheckpointerOptions

    ckpt = Checkpointer(spec["dir"], CheckpointerOptions(create=False))
    state, data = ckpt.restore(lambda: _state(mesh, spec)[1])
    return dict(rank_blocks(state), data=data)


def _failed_save(mesh, spec: dict) -> dict:
    """One step, then a save in which the last rank fails before it
    writes: every rank's ``wait`` error and the steps on disk after."""
    import torch

    from oim_tpu_torch.checkpoint import Checkpointer, CheckpointerOptions
    from oim_tpu_torch.checkpoint import manager
    from oim_tpu_torch.models.train import make_train_step

    cfg, state = _state(mesh, spec)
    step = make_train_step(cfg, cuda_graph=False, mesh=mesh)
    dp, i = mesh.shape["dp"], mesh.axis_index("dp")
    batch = spec["batches"][0]
    rows = batch.shape[0] // dp
    state, _ = step(state, torch.from_numpy(
        batch[i * rows:(i + 1) * rows]).long())
    ckpt = Checkpointer(spec["dir"], CheckpointerOptions(
        commit_timeout=spec["timeout"]))
    real = manager._write_files
    if mesh.rank == mesh.size - 1:
        def broken(directory, files):
            raise OSError("disk lost mid-save")

        manager._write_files = broken
    try:
        ckpt.save(state, {"next_step": 1})
        ckpt.wait()
        error = ""
    except Exception as exc:
        error = f"{type(exc).__name__}: {exc}"
    finally:
        manager._write_files = real
    import torch.distributed as dist

    dist.barrier(group=mesh.control)
    return {"error_seen": error, "steps": ckpt.all_steps(),
            "leftovers": sorted(os.listdir(spec["dir"]))}


def _serve(mesh, spec: dict) -> dict:
    """``serve_main``'s engine for ``spec["argv"]`` on the mesh (its
    ``--tp``): rank 0 serves ``spec["requests"]`` greedily, the others
    follow; rank 0 answers with the tokens."""
    from oim_tpu_torch.cli import serve_main
    from oim_tpu_torch.serve.engine import GenRequest

    args = serve_main.build_parser().parse_args(spec["argv"])
    engine = serve_main.make_engine(args, mesh=mesh)
    if mesh.rank != 0:
        engine.follow()
        return {}
    try:
        rids = [engine.submit(GenRequest(**r)) for r in spec["requests"]]
        done = engine.run()
        return {"tokens": [list(done[rid]) for rid in rids]}
    finally:
        engine.stop_followers()


TRAIN_OPS = {"steps": _train_steps, "main": _train_main, "serve": _serve,
             "restore": _restore, "failed_save": _failed_save}


def run_train_case(mesh, case: dict) -> dict:
    """A training case on this rank (``case["train"]["op"]``)."""
    spec = case["train"]
    return TRAIN_OPS[spec["op"]](mesh, spec)


def _join(rank: int, world: int, store_path: str, sizes: dict):
    """This rank's mesh of ``sizes`` over a gloo group of ``world``
    ranks meeting at ``store_path``."""
    import torch.distributed as dist

    from oim_tpu_torch.parallel import build_mesh

    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    return build_mesh(devices=["cpu"] * world, **sizes)


def _rank_main(rank: int, world: int, store_path: str, sizes: dict,
               jobs, results) -> None:
    import math

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        mesh = _join(rank, world, store_path, sizes)
        generation = 0
        while True:
            case = jobs.get()
            if case is None:
                break
            want = case.get("mesh", sizes)
            if want != sizes:
                # Another mesh for this case and those after it: a new
                # group of as many ranks as it needs; the rest idle.
                sizes, generation = want, generation + 1
                if dist.is_initialized():
                    dist.destroy_process_group()
                n = math.prod(sizes.values())
                mesh = (_join(rank, n, f"{store_path}-{generation}", sizes)
                        if rank < n else None)
            if mesh is None:
                results.put((rank, case["name"], {"idle": True}))
                continue
            try:
                run = run_train_case if "train" in case else run_case
                results.put((rank, case["name"], run(mesh, case)))
            except Exception:
                results.put((rank, case["name"],
                             {"error": traceback.format_exc()}))
        if dist.is_initialized():
            dist.destroy_process_group()
    except Exception:
        results.put((rank, None, {"error": traceback.format_exc()}))


class RankGroup:
    """``world`` spawned ranks over one gloo mesh of ``sizes`` (``dp``,
    ``tp``, ``ep``); ``run`` hands every rank the same cases and returns
    ``{case name: [each rank's answer]}``.  A case with a ``mesh`` (its
    sizes) runs on a mesh of those sizes, formed anew over the first of
    the ranks when it differs from the last case's; the other ranks
    answer ``{"idle": True}``.  ``close`` joins every child
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


def _train_bootstrap_rank(path: str, argv: list, results) -> None:
    """``train_main --bootstrap path`` as one process of a staged
    slice: its losses, the mesh it trained on, and its rank."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from oim_tpu_torch.cli import train_main

    try:
        out = train_main.train(train_main.build_parser().parse_args(
            argv + ["--bootstrap", path]))
        results.put((out["rank"], {"losses": out["losses"],
                                   "mesh": out["mesh"],
                                   "initialized": dist.is_initialized()}))
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
