"""Fused unembedding + cross-entropy: the logits-materializing reference,
plain PyTorch versions of the Hopper kernels, their wrappers, and the
differentiable ``fused_linear_ce`` the training loss calls.

Kernels (``csrc/fused_ce.cu``), replacing the TPU kernels of
``oim_tpu/ops/fused_ce.py``:

- ``fused_ce_fwd`` (``_fwd_kernel``): per row, the logsumexp of ``x @ w``
  over the vocabulary and the label's logit, with the [N, V] logits never
  stored.
- ``fused_ce_dx`` (``_dx_kernel``): ``dx = dlogits @ wᵀ``, the scores
  recomputed from (x, w, lse).
- ``fused_ce_dw`` (``_dw_kernel``): ``dw = xᵀ @ dlogits`` in f32.
- ``fused_ce_bwd``: dx and dw together from one pass of dlogits per
  vocabulary chunk: what a full training step's backward runs, in place
  of dx and dw apart (a LoRA step, whose w is frozen, runs dx alone).

Two routes, chosen from the shape (``route``), never from a failure:
``"wgmma"`` (bf16 with D and V multiples of 8, 16-byte-aligned bases:
TMA-fed ``wgmma`` in a persistent kernel, ``oim_fused_ce_tc_*``) and
``"mma_sync"`` (f32, and bf16 rows TMA cannot take: the warp-level
``mma.sync`` kernels, ``oim_fused_ce_fwd`` / ``_dx`` / ``_dw``).

The numerics are the reference's: compute-dtype operands with f32
accumulation (``w`` is cast to x's dtype outside the kernels, as the
reference casts it outside ``pallas_call``), ``lse = m + log(max(l,
1e-30))``, and one definition of the dlogits for both gradients:
``((exp(s - lse) - onehot) · g)`` rounded to x's dtype before either
product.  The wrappers take any N, D and V (ragged tiles are masked;
rows TMA cannot read take the mma.sync route), so unlike the reference
nothing falls back to ``reference_linear_ce``.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs
its plain version only for CPU tensors; ``<wrapper>.launches``,
``<plain>.calls`` and ``ROUTE_LAUNCHES`` count which path and route
ran.  The reference's ``block_n`` / ``block_v`` are its VMEM tiling and
not part of this interface.
"""

from __future__ import annotations

import torch

from oim_tpu_torch.ops import _build

# Vocabulary columns per forward tile (csrc/fused_ce.cu kBN): the forward
# keeps one (max, sum of exp) pair per row and tile.
TILE_V = 128
# Elements of the dlogits scratch the backward kernels fill per chunk of
# the vocabulary, by route.  wgmma: 128 Mi (256 MiB in bf16; 32768
# columns at the training shape's N = 4096), where wider chunks cut the
# dx product's f32 round trips and the launches' tail waves (the widths
# ``chip_smoke.py --kernel-phase-only`` times; PERF.md).  mma_sync: 32
# Mi, the width that route was timed at.
SCRATCH_ELEMENTS = 128 << 20
MMA_SYNC_SCRATCH_ELEMENTS = 32 << 20
DTYPES = (torch.float32, torch.bfloat16)
# Wrapper launches by route (see ``route``).
ROUTE_LAUNCHES = {"wgmma": 0, "mma_sync": 0}


def reference_linear_ce(x, w, labels):
    """Per-token NLL [N] f32 through materialized logits — the
    reference's oracle: ``x @ w`` of compute-dtype operands accumulated
    in f32, then an f32 log-softmax at ``labels``."""
    logits = x.float() @ w.to(x.dtype).float()
    lse = torch.logsumexp(logits, dim=-1)
    target = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
    return lse - target


def _check(what, x, w, labels, *rows) -> None:
    """Raise on shapes the kernels (and plain versions) do not share: x
    [N, D], w [D, V] of x's dtype, labels [N], and each ``(name,
    tensor)`` of ``rows`` [N]."""
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(
            f"{what}: x {tuple(x.shape)} and w {tuple(w.shape)} must be "
            f"[N, D] and [D, V]")
    if w.dtype != x.dtype:
        raise ValueError(
            f"{what}: w is {w.dtype}, expected x's {x.dtype} (cast it "
            f"first, as fused_linear_ce does)")
    if w.shape[1] < 1 or x.shape[1] < 1:
        raise ValueError(f"{what}: D and V must be >= 1")
    for name, t in (("labels", labels),) + rows:
        if tuple(t.shape) != (x.shape[0],):
            raise ValueError(
                f"{what}: {name} {tuple(t.shape)} must be [{x.shape[0]}]")


def _kernel_operands(what, x, w, labels, *rows):
    """The operands as the kernels take them: x and w contiguous, of one
    of ``DTYPES``, labels int32 and per-row vectors f32, all on x's
    device."""
    if x.dtype not in DTYPES:
        raise ValueError(f"{what} kernel takes f32/bf16, got {x.dtype}")
    out = []
    for name, t, dtype in (("x", x, x.dtype), ("w", w, x.dtype),
                           ("labels", labels, torch.int32)) + tuple(
                               (n, r, torch.float32) for n, r in rows):
        if t.device != x.device:
            raise ValueError(
                f"{what}: {name} on {t.device}, expected {x.device}")
        out.append(t.to(dtype).contiguous())
    return out


def route(x, w) -> str:
    """The kernel route for kernel operands x [N, D] and w [D, V]:
    ``"wgmma"`` where TMA can read both (bf16, rows of whole 16-byte
    chunks, 16-byte-aligned bases), else ``"mma_sync"``."""
    d, v = w.shape
    if (x.dtype == torch.bfloat16 and d % 8 == 0 and v % 8 == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0):
        return "wgmma"
    return "mma_sync"


def chunk_columns(n: int, v: int, way: str = "wgmma") -> int:
    """Vocabulary columns per backward chunk on route ``way``: the
    dlogits scratch [n, chunk] holds about that route's scratch elements,
    in whole forward tiles, and no more than the vocabulary needs."""
    elements = (SCRATCH_ELEMENTS if way == "wgmma"
                else MMA_SYNC_SCRATCH_ELEMENTS)
    want = max(TILE_V, elements // max(n, 1) // TILE_V * TILE_V)
    return min(want, -(-v // TILE_V) * TILE_V)


def _scores(x, w):
    """f32 scores [N, V] of compute-dtype operands (exact products, f32
    sums: the kernels' arithmetic)."""
    return x.float() @ w.float()


def _dlogits(x, w, labels, lse, g):
    """The dlogits [N, V] in x's dtype: ``((exp(s - lse) - onehot) ·
    g)`` from recomputed scores — the one definition dx and dw share."""
    p = torch.exp(_scores(x, w) - lse[:, None])
    onehot = torch.zeros_like(p)
    onehot.scatter_(1, labels.long()[:, None], 1.0)
    return ((p - onehot) * g.float()[:, None]).to(x.dtype)


# ---------------------------------------------------------------------------
# Forward


def fused_ce_fwd_plain(x, w, labels):
    """Plain PyTorch version of ``fused_ce_fwd`` (same signature)."""
    fused_ce_fwd_plain.calls += 1
    s = _scores(x, w)
    lse = torch.logsumexp(s, dim=-1)
    target = torch.gather(s, 1, labels.long()[:, None])[:, 0]
    return lse, target


fused_ce_fwd_plain.calls = 0


def fused_ce_fwd(x, w, labels):
    """x [N, D] (f32 or bf16), w [D, V] of x's dtype, labels [N] in [0,
    V) → (lse [N] f32, target logit [N] f32).  CUDA tensors launch the
    kernel; CPU tensors run the plain version."""
    _check("fused_ce_fwd", x, w, labels)
    if not x.is_cuda:
        return fused_ce_fwd_plain(x, w, labels)
    x, w, labels = _kernel_operands("fused_ce_fwd", x, w, labels)
    n, d = x.shape
    v = w.shape[1]
    lse = torch.empty(n, dtype=torch.float32, device=x.device)
    target = torch.zeros(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return lse, target
    partial = torch.empty((2, -(-v // TILE_V), n), dtype=torch.float32,
                          device=x.device)
    way = route(x, w)
    lib = _build.library()
    common = (_build.ptr(labels), _build.ptr(lse), _build.ptr(target),
              _build.ptr(partial), n, d, v, _build.stream_of(x))
    if way == "wgmma":
        code = lib.oim_fused_ce_tc_fwd(_build.ptr(x), _build.ptr(w), *common)
    else:
        code = lib.oim_fused_ce_fwd(_build.ptr(x), _build.ptr(w),
                                    _build.DTYPE_CODES[x.dtype], *common)
    _build.check(code, "fused_ce_fwd")
    fused_ce_fwd.launches += 1
    ROUTE_LAUNCHES[way] += 1
    return lse, target


fused_ce_fwd.launches = 0


# ---------------------------------------------------------------------------
# Backward


def fused_ce_dx_plain(x, w, labels, lse, g):
    """Plain PyTorch version of ``fused_ce_dx`` (same signature)."""
    fused_ce_dx_plain.calls += 1
    d = _dlogits(x, w, labels, lse, g)
    return (d.float() @ w.float().T).to(x.dtype)


fused_ce_dx_plain.calls = 0


def fused_ce_dw_plain(x, w, labels, lse, g):
    """Plain PyTorch version of ``fused_ce_dw`` (same signature)."""
    fused_ce_dw_plain.calls += 1
    d = _dlogits(x, w, labels, lse, g)
    return x.float().T @ d.float()


fused_ce_dw_plain.calls = 0


def fused_ce_bwd_plain(x, w, labels, lse, g):
    """Plain PyTorch version of ``fused_ce_bwd``: the dlogits once, then
    both products."""
    fused_ce_bwd_plain.calls += 1
    d = _dlogits(x, w, labels, lse, g).float()
    return (d @ w.float().T).to(x.dtype), x.float().T @ d


fused_ce_bwd_plain.calls = 0


def _backward(what, x, w, labels, lse, g, want_dx, want_dw):
    """(dx or None, dw or None, route) by the kernels of x's route.  The
    wgmma route computes each chunk's dlogits once for both; the
    mma_sync route runs its dx and dw kernels one after the other."""
    x, w, labels, lse, g = _kernel_operands(
        what, x, w, labels, ("lse", lse), ("g", g))
    n, d = x.shape
    v = w.shape[1]
    way = route(x, w)
    dx = (torch.empty((n, d), dtype=x.dtype, device=x.device)
          if want_dx else None)
    dw = (torch.empty((d, v), dtype=torch.float32, device=x.device)
          if want_dw else None)
    if n == 0:
        return dx, None if dw is None else dw.zero_(), way
    chunk = chunk_columns(n, v, way)
    scratch = torch.empty((n, chunk), dtype=x.dtype, device=x.device)
    acc = (torch.empty((n, d), dtype=torch.float32, device=x.device)
           if want_dx and x.dtype != torch.float32 else None)
    lib = _build.library()
    ops = (_build.ptr(x), _build.ptr(w))
    rows = (_build.ptr(labels), _build.ptr(lse), _build.ptr(g),
            _build.ptr(scratch))
    stream = _build.stream_of(x)
    if way == "wgmma":
        _build.check(lib.oim_fused_ce_tc_bwd(
            *ops, *rows, _build.ptr(acc), _build.ptr(dx), _build.ptr(dw),
            n, d, v, chunk, stream), what)
        return dx, dw, way
    code = _build.DTYPE_CODES[x.dtype]
    if want_dx:
        _build.check(lib.oim_fused_ce_dx(
            *ops, code, *rows, _build.ptr(acc), _build.ptr(dx), n, d, v,
            chunk, stream), what)
    if want_dw:
        _build.check(lib.oim_fused_ce_dw(
            *ops, code, *rows, _build.ptr(dw), n, d, v, chunk, stream), what)
    return dx, dw, way


def fused_ce_dx(x, w, labels, lse, g):
    """dx [N, D] in x's dtype from the forward's inputs, its ``lse`` and
    the per-row cotangent ``g`` [N]: the dlogits times wᵀ, summed in
    f32.  CUDA tensors launch the kernel; CPU tensors run the plain
    version."""
    _check("fused_ce_dx", x, w, labels, ("lse", lse), ("g", g))
    if not x.is_cuda:
        return fused_ce_dx_plain(x, w, labels, lse, g)
    dx, _, way = _backward("fused_ce_dx", x, w, labels, lse, g, True, False)
    fused_ce_dx.launches += 1
    ROUTE_LAUNCHES[way] += 1
    return dx


fused_ce_dx.launches = 0


def fused_ce_dw(x, w, labels, lse, g):
    """dw [D, V] f32 from the same operands as ``fused_ce_dx``: xᵀ times
    the dlogits.  CUDA tensors launch the kernel; CPU tensors run the
    plain version."""
    _check("fused_ce_dw", x, w, labels, ("lse", lse), ("g", g))
    if not x.is_cuda:
        return fused_ce_dw_plain(x, w, labels, lse, g)
    _, dw, way = _backward("fused_ce_dw", x, w, labels, lse, g, False, True)
    fused_ce_dw.launches += 1
    ROUTE_LAUNCHES[way] += 1
    return dw


fused_ce_dw.launches = 0


def fused_ce_bwd(x, w, labels, lse, g):
    """(dx, dw) of ``fused_ce_dx`` and ``fused_ce_dw`` from one dlogits
    pass per vocabulary chunk on the wgmma route: three N·D·V products
    instead of four (the mma_sync route runs its dx and dw kernels one
    after the other).  CUDA tensors launch the kernels; CPU tensors run
    the plain version."""
    _check("fused_ce_bwd", x, w, labels, ("lse", lse), ("g", g))
    if not x.is_cuda:
        return fused_ce_bwd_plain(x, w, labels, lse, g)
    dx, dw, way = _backward("fused_ce_bwd", x, w, labels, lse, g, True, True)
    fused_ce_bwd.launches += 1
    ROUTE_LAUNCHES[way] += 1
    return dx, dw


fused_ce_bwd.launches = 0


# ---------------------------------------------------------------------------
# Autograd


class _FusedLinearCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, labels):
        lse, target = fused_ce_fwd(x, w.to(x.dtype), labels)
        ctx.save_for_backward(x, w, labels, lse)
        return lse - target

    @staticmethod
    def backward(ctx, g):
        x, w, labels, lse = ctx.saved_tensors
        wc = w.to(x.dtype)
        g = g.float().contiguous()
        need_dx, need_dw = ctx.needs_input_grad[:2]
        dx = dw = None
        if need_dx and need_dw:  # a full step: one dlogits pass for both
            dx, dw = fused_ce_bwd(x, wc, labels, lse, g)
        elif need_dx:  # a LoRA step freezes w: no dw work
            dx = fused_ce_dx(x, wc, labels, lse, g)
        elif need_dw:
            dw = fused_ce_dw(x, wc, labels, lse, g)
        return dx, None if dw is None else dw.to(w.dtype), None


def fused_linear_ce(x, w, labels):
    """Per-token NLL of ``softmax(x @ w)`` at ``labels``, [N] f32 (the
    reference's ``fused_linear_ce``): x [N, D] in the compute dtype, w
    [D, V] (cast to x's dtype for the kernels; its gradient comes back
    in w's dtype), labels [N] in [0, V).  The [N, V] logits exist in
    neither pass."""
    return _FusedLinearCE.apply(x, w, labels)


def reset_counters() -> None:
    """Zero every launch, route and plain-call count."""
    replay_counts({name: -n for name, n in counters().items()})


def counters() -> dict:
    """Current launch, route and plain-call counts by name."""
    return {
        "fused_ce_fwd": fused_ce_fwd.launches,
        "fused_ce_dx": fused_ce_dx.launches,
        "fused_ce_dw": fused_ce_dw.launches,
        "fused_ce_bwd": fused_ce_bwd.launches,
        "fused_ce_fwd_plain": fused_ce_fwd_plain.calls,
        "fused_ce_dx_plain": fused_ce_dx_plain.calls,
        "fused_ce_dw_plain": fused_ce_dw_plain.calls,
        "fused_ce_bwd_plain": fused_ce_bwd_plain.calls,
        **{f"fused_ce_{way}": n for way, n in ROUTE_LAUNCHES.items()},
    }


def replay_counts(delta: dict) -> None:
    """Add ``delta``'s counts under ``counters()``'s names (others are
    ignored): what a replay of a captured region launched
    (``ops/counts.py``)."""
    for fn in (fused_ce_fwd, fused_ce_dx, fused_ce_dw, fused_ce_bwd):
        fn.launches += delta[fn.__name__]
    for fn in (fused_ce_fwd_plain, fused_ce_dx_plain, fused_ce_dw_plain,
               fused_ce_bwd_plain):
        fn.calls += delta[fn.__name__]
    for way in ROUTE_LAUNCHES:
        ROUTE_LAUNCHES[way] += delta[f"fused_ce_{way}"]
