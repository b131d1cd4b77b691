"""Variants of K1's tensor-core route and of K2, timed side by side.

Each variant is a named set of text substitutions applied to a copy of
``csrc/paged_attention.cu`` (a deeper cp.async ring, the precise 2^x, Q
fragments reloaded each step at three blocks an SM, ...).  Every variant
and the source as it stands ("base") are compiled at once, one ``nvcc``
each, into ``csrc/build/variants/`` (which ``.gitignore`` lists), then
held against ``paged_flash_decode_plain`` (or ``paged_store``, for K2) on
the chip smoke's admission shapes — a 512-token segment over two slots
at starts 37 and 1000 and a ragged 100-token one over three, bf16 and
int8 pools, 16-row blocks, the serving model's 12 q heads on 2 kv heads
of 128 — and timed as the smoke times kernels (CUDA events behind a
device sleep, the L2 flushed before each run; "warm" without the flush)
at the wrapper's split and at forced ones.  A variant whose text no
longer matches the source is reported and skipped.  The first line
printed is the time of a one-element fill under the same timing, the
floor below which no launch reads.

``--stamps`` builds instead a copy of the tensor-core kernel in which
warp 0 of every block reads the SM clock after each phase of a step
(each read behind a data dependency on the phase's last result) and
prints the cycles a step spends in each: the table lookup of a later
step, the wait for the step's copies, the barrier, the next copies'
issue, S = Q Kᵀ, the softmax and P V.  Run on the machine with the GPU:

    python -m oim_tpu_torch.cli.paged_variants [--stamps] [--only a,b]
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys

import numpy as np
import torch

from oim_tpu_torch.ops import _build
from oim_tpu_torch.ops import paged_attention as pa

H, KVH, HD, BS, MAX_LEN = 12, 2, 128, 16, 2048
N_BLOCKS = 8 * (MAX_LEN // BS)
SPLITS = (None, 1, 2, 4, 8)
SLEEP_CYCLES = 200_000_000
TC_TOL = 2.0**-7 + 1e-4  # of the output's max: the smoke's tc-route limit

_QA = """  uint32_t qa[KK][4];
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
    ldmatrix_x4(qa[kk], qs + (r0 + lane % 16) * RS + (lane / 16) * 8 + kk * 16);
"""
_S_LOOP = """      for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {"""
_S_MMA = """          mma_bf16(s[2 * np], qa[kk], b0);
          mma_bf16(s[2 * np + 1], qa[kk], b1);
        }
      }
"""
_PREFETCH = ("    prefetch(kb_after, row_after, (i + kTcStages - 1) % "
             "kTcStages);\n")
_SCORES = ("      // Scores in base 2 (int8: times the key's scale); masked "
           "pairs at")
_SHIFT = "#pragma unroll\n    for (int j = 0; j + 1 < kTcStages - 1; ++j) {"
_RING = "constexpr int kTcStages = 3;"

VARIANTS = {
    "base": [],
    "ring4": [(_RING, "constexpr int kTcStages = 4;")],
    "ring5": [(_RING, "constexpr int kTcStages = 5;")],
    # The precise 2^x in place of the hardware's approximation.
    "exp2f": [("alpha[r] = ex2(m[r] - m_next);",
               "alpha[r] = exp2f(m[r] - m_next);"),
              ("s[j][2 * r] = ex2(s[j][2 * r] - mu);",
               "s[j][2 * r] = exp2f(s[j][2 * r] - mu);"),
              ("s[j][2 * r + 1] = ex2(s[j][2 * r + 1] - mu);",
               "s[j][2 * r + 1] = exp2f(s[j][2 * r + 1] - mu);")],
    # Q's fragments reloaded from shared memory every step, registers
    # capped for three blocks an SM.
    "qsmem3": [
        (_QA, ""),
        (_S_LOOP, _S_LOOP.replace(
            "      for (int kk = 0; kk < KK; ++kk) {",
            "      for (int kk = 0; kk < KK; ++kk) {\n        uint32_t qa_kk[4];"
            "\n        ldmatrix_x4(qa_kk, qs + (r0 + lane % 16) * RS + "
            "(lane / 16) * 8 + kk * 16);")),
        ("mma_bf16(s[2 * np], qa[kk], b0);", "mma_bf16(s[2 * np], qa_kk, b0);"),
        ("mma_bf16(s[2 * np + 1], qa[kk], b1);",
         "mma_bf16(s[2 * np + 1], qa_kk, b1);"),
        ("__launch_bounds__(kThreads, 2) paged_prefill_tc_kernel(",
         "__launch_bounds__(kThreads, 3) paged_prefill_tc_kernel("),
    ],
    # The next step's copies issued among the S products (S computed by
    # idle warps too, the copies without a branch).
    "interleave": [
        (_PREFETCH, ""),
        ("    if (kb >= 0) {\n      unsigned char* ks = ring + st * 2 * BK * RB;",
         "    {\n      unsigned char* ks = ring + st * 2 * BK * RB;"),
        ("        const int r = __shfl_sync(0xffffffffu, row, key);",
         "        const int r = kb >= 0 ? __shfl_sync(0xffffffffu, row, key) "
         ": -1;"),
        ("    if (!idle) {\n      float s[NT][4];", "    {\n      float s[NT][4];"),
        (_SCORES, "  " + _PREFETCH + "      if (!idle) {\n" + _SCORES),
        (_SHIFT, "}\n" + _SHIFT),
    ],
    # S over two accumulator sets (kk even, kk odd), summed after.
    "chains": [
        ("""      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;""",
         """      float s[NT][4], s_odd[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = s_odd[j][e] = 0.f;"""),
        (_S_MMA, """          if (kk % 2) {
            mma_bf16(s_odd[2 * np], qa[kk], b0);
            mma_bf16(s_odd[2 * np + 1], qa[kk], b1);
          } else {
            mma_bf16(s[2 * np], qa[kk], b0);
            mma_bf16(s[2 * np + 1], qa[kk], b1);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += s_odd[j][e];
"""),
    ],
}

# The clock-stamped copy (--stamps): phase sums of warp 0's thread 0,
# added over blocks into g_prof, read by oim_stamps.
PHASES = ("lookup", "wait", "barrier", "copies", "S", "softmax", "PV")
_STAMPS = [
    ("constexpr int kTcRows = 64;", """__device__ unsigned long long g_prof[16];
// The SM clock, read after a use of `dep` (so after its producer ends).
__device__ __forceinline__ long long stamp(float dep) {
  if (dep == 1.2345e-37f) g_prof[15] = 1;
  return clock64();
}
constexpr int kTcRows = 64;"""),
    ("  // The q tile, copied first so that its latency overlaps the table",
     "  long long P[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  const long long t_start = stamp(0.f);\n"
     "  // The q tile, copied first so that its latency overlaps the table"),
    ("  for (int i = 0; pending[0] >= 0; ++i) {\n    const int kb = pending[0];",
     "  for (int i = 0; pending[0] >= 0; ++i) {\n    const int kb = pending[0];"
     "\n    const long long t0 = stamp(0.f);\n    ++P[7];"),
    ("    const int kb_after = next_step(&valid_after, &row_after);",
     "    const int kb_after = next_step(&valid_after, &row_after);\n"
     "    const long long t1 = stamp(static_cast<float>(kb_after));\n"
     "    P[0] += t1 - t0;"),
    ("    cp_async_wait<kTcStages - 2>();  // step i's rows landed",
     "    cp_async_wait<kTcStages - 2>();  // step i's rows landed\n"
     "    const long long t2 = stamp(0.f);\n    P[1] += t2 - t1;"),
    ("    __syncthreads();  // ... for every thread; step i - 1's reads done",
     "    __syncthreads();  // ... for every thread; step i - 1's reads done\n"
     "    const long long t3 = stamp(0.f);\n    P[2] += t3 - t2;"),
    (_PREFETCH, _PREFETCH + "    const long long t4 = stamp(0.f);\n"
                            "    P[3] += t4 - t3;\n"),
    (_SCORES, "      const long long t5 = stamp(s[NT - 1][3]);\n"
              "      P[4] += t5 - t4;\n" + _SCORES),
    ("#pragma unroll\n      for (int c = 0; c < ND; ++c)\n#pragma unroll\n"
     "        for (int e = 0; e < 4; ++e) acc[c][e] *= alpha[e / 2];",
     "      const long long t6 = stamp(l[1]);\n      P[5] += t6 - t5;\n"
     "#pragma unroll\n      for (int c = 0; c < ND; ++c)\n#pragma unroll\n"
     "        for (int e = 0; e < 4; ++e) acc[c][e] *= alpha[e / 2];"),
    ("        acc_to_a(s, kk, a);\n        out_product<HD>(a, vs, kk, acc);\n"
     "      }\n",
     "        acc_to_a(s, kk, a);\n        out_product<HD>(a, vs, kk, acc);\n"
     "      }\n      P[6] += stamp(acc[ND - 1][3]) - t6;\n"),
    ("  cp_async_wait<0>();  // only empty groups remain\n",
     """  cp_async_wait<0>();  // only empty groups remain
  if (threadIdx.x == 0) {
    for (int k = 0; k < 8; ++k)
      atomicAdd(&g_prof[k], static_cast<unsigned long long>(P[k]));
    atomicAdd(&g_prof[8],
              static_cast<unsigned long long>(stamp(0.f) - t_start));
    atomicAdd(&g_prof[9], 1ull);
  }
"""),
]
_STAMPS_EXPORT = """
extern "C" int oim_stamps(unsigned long long* dst, int reset) {
  if (reset) {
    unsigned long long zero[16] = {0};
    return cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
  }
  return cudaMemcpyFromSymbol(dst, g_prof, sizeof(unsigned long long) * 16);
}
"""


def _variant_source(subs) -> str | None:
    src = (_build.CSRC / "paged_attention.cu").read_text()
    for old, new in subs:
        if old not in src:
            return None
        src = src.replace(old, new)
    return src


def _start_build(name: str, src: str):
    out = _build.BUILD_DIR / "variants" / name
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for header in _build.HEADERS:
        shutil.copy(_build.CSRC / header, out / header)
    (out / "paged_attention.cu").write_text(src)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
           str(out / "lib.so"), str(out / "paged_attention.cu")]
    return out / "lib.so", subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _tc_registers(log: str) -> list[str]:
    """ptxas's register and spill lines of the tensor-core kernel's
    instantiations in a build log."""
    found, name = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            name = line
        elif "paged_prefill_tc_kernel" in name and (
                "registers" in line or "spill" in line):
            found.append(line.split(":", 1)[-1].strip())
    return found


def _load(path, names=("oim_paged_prefill_tc", "oim_paged_kv_store")):
    lib = ctypes.CDLL(str(path))
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = _build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def _time_ms(fn, flush=True, runs=25) -> float:
    """Median device time of one call: CUDA events behind a device sleep,
    128 MiB written before each run to flush the L2 (``flush``)."""
    for _ in range(3):
        fn()
    buf = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(runs)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in events:
        if flush:
            buf.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def _cases(gen, rng, quant):
    """(tag, q, pools, tables, starts, k_new) of the smoke's admission
    shapes on one pool."""
    shape = (N_BLOCKS, BS, KVH, HD)
    if quant:
        pools = [torch.randint(-127, 128, shape, generator=gen, device="cuda",
                               dtype=torch.int8) for _ in range(2)]
        pools += [torch.rand(shape[:-1], generator=gen, device="cuda") * 0.04
                  + 0.005 for _ in range(2)]
    else:
        pools = [torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16) for _ in range(2)] + [None, None]
    for t, starts in ((512, [37, 1000]), (100, [37, 1000, 5])):
        b = len(starts)
        tables = np.full((b, MAX_LEN // BS), N_BLOCKS, np.int32)
        free = list(rng.permutation(N_BLOCKS))
        for row, s in enumerate(starts[:2]):
            n = (s + t - 1) // BS + 5
            tables[row, :n] = [free.pop() for _ in range(n)]
        q = torch.randn((b, t, H, HD), generator=gen, device="cuda").to(
            torch.bfloat16)
        k_new = torch.randn((b, t, KVH, HD), generator=gen,
                            device="cuda").to(torch.bfloat16)
        yield (f"{'int8' if quant else 'bf16'} B={b} t={t}", q, pools,
               torch.from_numpy(tables).cuda(),
               torch.tensor(starts, dtype=torch.int32, device="cuda"), k_new)


def _tc_call(lib, q, pools, tables, starts, splits):
    """A launch of ``lib``'s tensor-core route as the wrapper makes it."""
    b, t = q.shape[:2]
    n_tables = tables.shape[1]
    _, entries = pa.decode_plan(q.dtype, b, t, H, KVH, n_tables,
                                _build.sm_count(q.device), splits)
    n_splits = -(-n_tables // entries)
    out = torch.empty(q.shape, dtype=torch.float32, device="cuda")
    part = torch.empty(n_splits * b * t * H * (HD + 2), dtype=torch.float32,
                       device="cuda")
    k, v, ks, vs = pools

    def call():
        _build.check(lib.oim_paged_prefill_tc(
            q.data_ptr(), _build.DTYPE_CODES[q.dtype], k.data_ptr(),
            v.data_ptr(), _build.DTYPE_CODES[k.dtype], _build.ptr(ks),
            _build.ptr(vs), tables.data_ptr(), starts.data_ptr(),
            out.data_ptr(), part.data_ptr(), b, t, H, KVH, HD, N_BLOCKS, BS,
            n_tables, 0, entries, _build.stream_of(q)), "variant")
        return out
    return call


def _store_call(lib, k_new, pools, tables, starts):
    b, t = k_new.shape[:2]
    k, v, ks, vs = pools

    def call():
        _build.check(lib.oim_paged_kv_store(
            k_new.data_ptr(), k_new.data_ptr(), _build.DTYPE_CODES[k_new.dtype],
            k.data_ptr(), v.data_ptr(), _build.DTYPE_CODES[k.dtype],
            _build.ptr(ks), _build.ptr(vs), tables.data_ptr(),
            starts.data_ptr(), b, t, KVH, HD, N_BLOCKS, BS, tables.shape[1],
            _build.stream_of(k_new)), "variant")
    return call


def run_variants(names) -> None:
    builds = {}
    for name in names:
        src = _variant_source(VARIANTS[name])
        if src is None:
            print(f"{name}: its text no longer matches the source; skipped")
            continue
        builds[name] = _start_build(name, src)
    libs = {}
    for name, (path, proc) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: build failed\n{log[-3000:]}")
            continue
        print(f"{name}: built; tc kernel: {'; '.join(_tc_registers(log))}")
        libs[name] = _load(path)
    tiny = torch.zeros(1, device="cuda")
    print(f"floor: a one-element fill {_time_ms(tiny.zero_):.4f} ms cold, "
          f"{_time_ms(tiny.zero_, flush=False):.4f} warm")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.RandomState(0)
    for quant in (False, True):
        for tag, q, pools, tables, starts, k_new in _cases(gen, rng, quant):
            want = pa.paged_flash_decode_plain(q, *pools, tables, starts)
            tol = TC_TOL * float(want.abs().max())
            stored = [None if p is None else p.clone() for p in pools]
            pa.paged_kv_store_plain(k_new, k_new, *stored, tables, starts)
            for name, lib in libs.items():
                cells = []
                for splits in SPLITS:
                    call = _tc_call(lib, q, pools, tables, starts, splits)
                    err = float((call() - want).abs().max())
                    cells.append(
                        f"{splits or 'chosen'} {_time_ms(call):.4f}/"
                        f"{_time_ms(call, flush=False):.4f}"
                        + ("" if err <= tol else f" WRONG {err:.3g}"))
                copy = [None if p is None else p.clone() for p in pools]
                store = _store_call(lib, k_new, copy, tables, starts)
                store()
                same = all(torch.equal(a, b) for a, b in zip(copy, stored)
                           if a is not None)
                print(f"{tag} {name}: tc ms cold/warm by split "
                      + ", ".join(cells) + f"; K2 {_time_ms(store):.4f}/"
                      f"{_time_ms(store, flush=False):.4f}"
                      + ("" if same else " WRONG"), flush=True)


def run_stamps() -> None:
    src = _variant_source(_STAMPS)
    if src is None:
        raise SystemExit("the stamp points no longer match the source")
    path, proc = _start_build("stamps", src + _STAMPS_EXPORT)
    log, _ = proc.communicate()
    if proc.returncode:
        raise SystemExit(f"stamped build failed\n{log[-3000:]}")
    lib = _load(path, ("oim_paged_prefill_tc",))
    lib.oim_stamps.argtypes = (ctypes.c_void_p, ctypes.c_int)
    lib.oim_stamps.restype = ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.RandomState(0)
    for tag, q, pools, tables, starts, _ in _cases(gen, rng, False):
        for splits in (None, 1):
            call = _tc_call(lib, q, pools, tables, starts, splits)
            call()
            sums = (ctypes.c_ulonglong * 16)()
            torch.cuda.synchronize()
            lib.oim_stamps(None, 1)
            call()
            torch.cuda.synchronize()
            lib.oim_stamps(sums, 0)
            steps, blocks = max(sums[7], 1), max(sums[9], 1)
            print(f"stamps {tag} splits {splits or 'chosen'}: {sums[9]} "
                  f"blocks walked {sums[7]} steps; cycles a block "
                  f"{sums[8] / blocks:.0f}; cycles a step "
                  + ", ".join(f"{name} {sums[k] / steps:.0f}"
                              for k, name in enumerate(PHASES)), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--stamps", action="store_true",
                        help="cycles a step by phase of the tc kernel")
    parser.add_argument("--only", default=",".join(VARIANTS),
                        help="comma-separated variants to build and time")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("paged_variants times the GPU: run it there")
    print(_build.gpu_line())
    if args.stamps:
        run_stamps()
    else:
        run_variants([n for n in args.only.split(",") if n])
    return 0


if __name__ == "__main__":
    sys.exit(main())
