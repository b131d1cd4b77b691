"""What ``torch.distributed`` offers on the card: a probe.

Three questions decide how ``parallel/collectives.py`` runs its
collectives on a one-card machine:

1. Does gloo run ``all_reduce`` (f32 and bf16), ``all_gather``,
   ``all_gather_into_tensor`` and ``broadcast`` on CUDA tensors, between
   two processes that share ``cuda:0``?
2. Does NCCL refuse two ranks on one device?
3. Can a one-rank NCCL ``all_reduce`` be captured in a CUDA graph and
   replayed?

Each question runs in spawned processes that rendezvous through a
``FileStore``; the answers print as one JSON line.  Run it on a machine
with a card::

    python -m oim_tpu_torch.cli.dist_probe
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import sys
import tempfile
import traceback


def _gloo_rank(rank: int, world: int, store_path: str, out) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    dev = torch.device("cuda:0")
    answers = {}

    def attempt(name, fn):
        try:
            answers[name] = fn()
        except Exception as exc:  # the probe's answer is the failure
            answers[name] = f"error: {type(exc).__name__}: {exc}"[:300]

    def all_reduce(dtype):
        x = torch.full((1024,), rank + 1.0, device=dev, dtype=dtype)
        dist.all_reduce(x)
        torch.cuda.synchronize()
        return bool(torch.all(x == sum(range(1, world + 1))).item())

    def all_gather():
        x = torch.full((4,), float(rank), device=dev)
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        torch.cuda.synchronize()
        return all(bool(torch.all(p == i).item()) for i, p in enumerate(parts))

    def all_gather_into_tensor():
        x = torch.full((4,), float(rank), device=dev)
        out_t = torch.empty((world * 4,), device=dev)
        dist.all_gather_into_tensor(out_t, x)
        torch.cuda.synchronize()
        return bool(torch.all(out_t.view(world, 4)
                              == torch.arange(world, device=dev)[:, None])
                    .item())

    def broadcast():
        x = torch.full((8,), float(rank + 7), device=dev)
        dist.broadcast(x, src=0)
        torch.cuda.synchronize()
        return bool(torch.all(x == 7.0).item())

    attempt("all_reduce_f32", lambda: all_reduce(torch.float32))
    attempt("all_reduce_bf16", lambda: all_reduce(torch.bfloat16))
    attempt("all_gather", all_gather)
    attempt("all_gather_into_tensor", all_gather_into_tensor)
    attempt("broadcast", broadcast)
    dist.destroy_process_group()
    out.put((rank, answers))


def _nccl_two_rank(rank: int, world: int, store_path: str, out) -> None:
    import torch
    import torch.distributed as dist

    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group("nccl", store=store, rank=rank,
                                world_size=world,
                                device_id=torch.device("cuda:0"))
        x = torch.ones(16, device="cuda:0")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        out.put((rank, f"ran: {x[0].item()}"))
        dist.destroy_process_group()
    except Exception as exc:
        out.put((rank, f"error: {type(exc).__name__}: {exc}"[:400]))


def _nccl_graph(store_path: str, out) -> None:
    import torch
    import torch.distributed as dist

    try:
        store = dist.FileStore(store_path, 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                                device_id=torch.device("cuda:0"))
        x = torch.ones(1024, device="cuda:0")
        dist.all_reduce(x)  # the communicator's first, eager collective
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            x.mul_(2.0)
            dist.all_reduce(x)
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph):
            x.mul_(2.0)
            dist.all_reduce(x)
        x.fill_(1.0)
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
        out.put((0, {"captured": True, "after_3_replays": x[0].item()}))
        dist.destroy_process_group()
    except Exception:
        out.put((0, {"captured": False,
                     "error": traceback.format_exc()[-600:]}))


def _run(target, world: int, tmp: str, name: str, extra=(),
         timeout: float = 120.0) -> dict:
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = os.path.join(tmp, name)
    if extra is None:
        procs = [ctx.Process(target=target, args=(store, out))]
    else:
        procs = [ctx.Process(target=target, args=(r, world, store, out))
                 for r in range(world)]
    for p in procs:
        p.start()
    answers = {}
    try:
        for _ in procs:
            rank, value = out.get(timeout=timeout)
            answers[rank] = value
    except Exception as exc:
        answers["timeout"] = f"{type(exc).__name__} after {timeout} s"
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return answers


def probe() -> dict:
    """The three answers, by question."""
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        return {
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "device": torch.cuda.get_device_name(0),
            "gloo_cuda": _run(_gloo_rank, 2, tmp, "gloo"),
            "nccl_two_ranks_one_device": _run(_nccl_two_rank, 2, tmp,
                                              "nccl2", timeout=90.0),
            "nccl_one_rank_graph": _run(_nccl_graph, 1, tmp, "nccl1",
                                        extra=None),
        }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("dist_probe needs a CUDA device", file=sys.stderr)
        return 1
    print(json.dumps(probe()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
