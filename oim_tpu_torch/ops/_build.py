"""Build and bind the hand-written Hopper kernels (``oim_tpu_torch/csrc``).

The sources have a plain C interface, so each is compiled with ``nvcc``
(all at once, one process per source) and the objects are linked into
one shared library bound with ``ctypes`` — no PyTorch headers, so a
build takes seconds, not minutes.  The library is built at first use
(never at import: this module must import on machines with no CUDA
toolkit) into ``oim_tpu_torch/csrc/build/``, which ``.gitignore``
lists, under a name keyed by the sources' and flags' hash, so an edited
source always rebuilds and an unchanged one is reused.

Each entry point launches on the caller's stream and returns
``cudaGetLastError()``; ``check`` turns a non-zero code into an error
naming the kernel, since a refused launch never runs and a later
``synchronize`` would not report it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("paged_attention.cu", "rmsnorm.cu", "flash_attention.cu",
           "fused_ce.cu", "wquant.cu")
HEADERS = ("common.cuh", "paged_attention.cuh", "rmsnorm.cuh",
           "flash_attention.cuh", "fused_ce.cuh", "wquant.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Dtype codes shared with csrc/common.cuh (enum OimDType); uint8 is
# packed int4, two values a byte (ops/quant.py).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.uint8: 3}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # q, q_dtype, k_pool, v_pool, kv_dtype, k_scale, v_scale, tables,
    # starts, out, partials, B, t, H, KVH, hd, n_blocks, block_size,
    # n_tables, window, entries, stream
    "oim_paged_flash_decode": (
        _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    # the same arguments: K1's tall route on the tensor cores
    "oim_paged_prefill_tc": (
        _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    # k_new, v_new, new_dtype, k_pool, v_pool, pool_dtype, k_scale,
    # v_scale, tables, starts, B, t, KVH, hd, n_blocks, block_size,
    # n_tables, stream
    "oim_paged_kv_store": (
        _P, _P, _I, _P, _P, _I, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    # x, x_dtype, w, w_dtype, out, rows, d, eps, stream
    "oim_rmsnorm": (_P, _I, _P, _I, _P, _I, _I, ctypes.c_float, _P),
    # the same arguments: rows too wide for one warp's registers
    "oim_rmsnorm_wide": (_P, _I, _P, _I, _P, _I, _I, ctypes.c_float, _P),
    # q, k, v, dtype, segments, out, lse, B, T, H, KVH, hd, causal,
    # window, stream
    "oim_flash_fwd": (
        _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    # q, k, v, dout, lse, delta, dtype, segments, dq, B, T, H, KVH, hd,
    # causal, window, stream
    "oim_flash_dq": (
        _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    # q, k, v, dout, lse, delta, dtype, segments, dk, dv, partials, B,
    # T, H, KVH, hd, causal, window, split, stream
    "oim_flash_dkv": (
        _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    # x, w, dtype, labels, lse, target, partial, N, D, V, stream
    "oim_fused_ce_fwd": (_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P),
    # x, w, dtype, labels, lse, g, dlogits, acc, dx, N, D, V, chunk_v,
    # stream
    "oim_fused_ce_dx": (
        _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
    ),
    # x, w, dtype, labels, lse, g, dlogits, dw, N, D, V, chunk_v, stream
    "oim_fused_ce_dw": (
        _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
    ),
    # x, w, labels, lse, target, partial, N, D, V, stream
    "oim_fused_ce_tc_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # x, w, labels, lse, g, dlogits, acc, dx, dw, N, D, V, chunk_v, stream
    "oim_fused_ce_tc_bwd": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
    ),
    # x, x_dtype, x_expert_stride, q, q_dtype, scale, out, out_dtype,
    # partials, E, M, K, N, group, splits, stream
    "oim_quant_matmul": (
        _P, _I, ctypes.c_longlong, _P, _I, _P, _P, _I, _P,
        _I, _I, _I, _I, _I, _I, _P,
    ),
    # q, q_dtype, scale, w, w_dtype, E, K, N, group, stream
    "oim_dequant_weight": (_P, _I, _P, _P, _I, _I, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's output (ptxas register/spill report) of the build
# Called with a build's wall seconds after ``build`` compiled the kernels
# (serve/sentinel.py installs its report here).
BUILD_LISTENERS: list = []


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the Hopper kernels build on a machine with the "
        "CUDA toolkit (PATH or /usr/local/cuda/bin)"
    )


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        digest.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"liboim_kernels-{digest.hexdigest()[:16]}.so"


def _run(cmds: list[list[str]]) -> str:
    """Run the commands at once; their joined output, or an error naming
    each one that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate(timeout=900)
        outs.append(out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} ({proc.returncode})")
    log = "".join(outs)
    if failed:
        raise RuntimeError(f"nvcc failed: {'; '.join(failed)}\n{log}")
    return log


def build() -> Path:
    """Compile the kernels unless this exact build exists; returns the
    library path.  Each source compiles in its own ``nvcc``, all started
    together, and one more links them.  Outputs are written under
    temporary names and the library renamed into place, so a concurrent
    build never loads a torn file.  A build that ran reports its wall
    time to each of ``BUILD_LISTENERS`` (the recompile sentinel)."""
    global build_log
    path = library_path()
    if path.exists():
        return path
    t0 = time.monotonic()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(name).stem}.o" for name in SOURCES]
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        build_log = _run([
            [_nvcc(), *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            for name, obj in zip(SOURCES, objs)
        ])
        build_log += _run([[_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
                            *map(str, objs)]])
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    for listener in list(BUILD_LISTENERS):
        listener(time.monotonic() - t0)
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(code: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {code}")


def ptr(t: torch.Tensor | None) -> int | None:
    """A tensor's device pointer for a ``c_void_p`` argument (None → NULL)."""
    return None if t is None else t.data_ptr()


def gpu_line() -> str:
    """The first card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them: the
    line to keep beside every time measured on the card (a card set
    below its maximum power runs slower under load)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors: what the split rules size
    their grids against."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream
