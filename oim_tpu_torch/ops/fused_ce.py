"""Fused unembedding + cross-entropy: the logits-materializing reference,
plain PyTorch versions of the three Hopper kernels, their wrappers, and
the differentiable ``fused_linear_ce`` the training loss calls.

Kernels (``csrc/fused_ce.cu``), each replacing one TPU kernel of
``oim_tpu/ops/fused_ce.py``:

- ``fused_ce_fwd`` → ``oim_fused_ce_fwd`` (``_fwd_kernel``): per row,
  the logsumexp of ``x @ w`` over the vocabulary and the label's logit,
  with the [N, V] logits never stored.
- ``fused_ce_dx`` → ``oim_fused_ce_dx`` (``_dx_kernel``):
  ``dx = dlogits @ wᵀ``, the scores recomputed from (x, w, lse).
- ``fused_ce_dw`` → ``oim_fused_ce_dw`` (``_dw_kernel``):
  ``dw = xᵀ @ dlogits`` in f32.

The numerics are the reference's: compute-dtype operands with f32
accumulation (``w`` is cast to x's dtype outside the kernels, as the
reference casts it outside ``pallas_call``), ``lse = m + log(max(l,
1e-30))``, and one definition of the dlogits for both gradients:
``((exp(s - lse) - onehot) · g)`` rounded to x's dtype before either
product.  The kernels take any N, D and V (ragged tiles are masked), so
unlike the reference nothing falls back to ``reference_linear_ce``.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs
its plain version only for CPU tensors; ``<wrapper>.launches`` and
``<plain>.calls`` count which path ran.  The reference's ``block_n`` /
``block_v`` are its VMEM tiling and not part of this interface.
"""

from __future__ import annotations

import torch

from oim_tpu_torch.ops import _build

# Vocabulary columns per forward tile (csrc/fused_ce.cu kBN): the forward
# keeps one (max, sum of exp) pair per row and tile.
TILE_V = 128
# Elements of the dlogits scratch the backward kernels fill per chunk of
# the vocabulary (32 Mi: 64 MiB in bf16 at any N).
SCRATCH_ELEMENTS = 32 << 20
DTYPES = (torch.float32, torch.bfloat16)


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


def chunk_columns(n: int, v: int) -> int:
    """Vocabulary columns per backward chunk: the dlogits scratch [n,
    chunk] holds about ``SCRATCH_ELEMENTS``, in whole forward tiles, and
    no more than the vocabulary needs."""
    want = max(TILE_V, SCRATCH_ELEMENTS // max(n, 1) // TILE_V * TILE_V)
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
    code = _build.library().oim_fused_ce_fwd(
        _build.ptr(x), _build.ptr(w), _build.DTYPE_CODES[x.dtype],
        _build.ptr(labels), _build.ptr(lse), _build.ptr(target),
        _build.ptr(partial), n, d, v, _build.stream_of(x),
    )
    _build.check(code, "fused_ce_fwd")
    fused_ce_fwd.launches += 1
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


def fused_ce_dx(x, w, labels, lse, g):
    """dx [N, D] in x's dtype from the forward's inputs, its ``lse`` and
    the per-row cotangent ``g`` [N]: the dlogits times wᵀ, summed in
    f32.  CUDA tensors launch the kernel; CPU tensors run the plain
    version."""
    _check("fused_ce_dx", x, w, labels, ("lse", lse), ("g", g))
    if not x.is_cuda:
        return fused_ce_dx_plain(x, w, labels, lse, g)
    x, w, labels, lse, g = _kernel_operands(
        "fused_ce_dx", x, w, labels, ("lse", lse), ("g", g))
    n, d = x.shape
    v = w.shape[1]
    dx = torch.empty((n, d), dtype=x.dtype, device=x.device)
    if n == 0:
        return dx
    chunk = chunk_columns(n, v)
    scratch = torch.empty((n, chunk), dtype=x.dtype, device=x.device)
    acc = (None if x.dtype == torch.float32 else
           torch.empty((n, d), dtype=torch.float32, device=x.device))
    code = _build.library().oim_fused_ce_dx(
        _build.ptr(x), _build.ptr(w), _build.DTYPE_CODES[x.dtype],
        _build.ptr(labels), _build.ptr(lse), _build.ptr(g),
        _build.ptr(scratch), _build.ptr(acc), _build.ptr(dx), n, d, v, chunk,
        _build.stream_of(x),
    )
    _build.check(code, "fused_ce_dx")
    fused_ce_dx.launches += 1
    return dx


fused_ce_dx.launches = 0


def fused_ce_dw(x, w, labels, lse, g):
    """dw [D, V] f32 from the same operands as ``fused_ce_dx``: xᵀ times
    the dlogits.  CUDA tensors launch the kernel; CPU tensors run the
    plain version."""
    _check("fused_ce_dw", x, w, labels, ("lse", lse), ("g", g))
    if not x.is_cuda:
        return fused_ce_dw_plain(x, w, labels, lse, g)
    x, w, labels, lse, g = _kernel_operands(
        "fused_ce_dw", x, w, labels, ("lse", lse), ("g", g))
    n, d = x.shape
    v = w.shape[1]
    if n == 0:
        return torch.zeros((d, v), dtype=torch.float32, device=x.device)
    dw = torch.empty((d, v), dtype=torch.float32, device=x.device)
    chunk = chunk_columns(n, v)
    scratch = torch.empty((n, chunk), dtype=x.dtype, device=x.device)
    code = _build.library().oim_fused_ce_dw(
        _build.ptr(x), _build.ptr(w), _build.DTYPE_CODES[x.dtype],
        _build.ptr(labels), _build.ptr(lse), _build.ptr(g),
        _build.ptr(scratch), _build.ptr(dw), n, d, v, chunk,
        _build.stream_of(x),
    )
    _build.check(code, "fused_ce_dw")
    fused_ce_dw.launches += 1
    return dw


fused_ce_dw.launches = 0


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
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = fused_ce_dx(x, wc, labels, lse, g)
        if ctx.needs_input_grad[1]:  # a LoRA step freezes w: no dw work
            dw = fused_ce_dw(x, wc, labels, lse, g).to(w.dtype)
        return dx, dw, None


def fused_linear_ce(x, w, labels):
    """Per-token NLL of ``softmax(x @ w)`` at ``labels``, [N] f32 (the
    reference's ``fused_linear_ce``): x [N, D] in the compute dtype, w
    [D, V] (cast to x's dtype for the kernels; its gradient comes back
    in w's dtype), labels [N] in [0, V).  The [N, V] logits exist in
    neither pass."""
    return _FusedLinearCE.apply(x, w, labels)


def reset_counters() -> None:
    """Zero every launch and plain-call count."""
    for fn in (fused_ce_fwd, fused_ce_dx, fused_ce_dw):
        fn.launches = 0
    for fn in (fused_ce_fwd_plain, fused_ce_dx_plain, fused_ce_dw_plain):
        fn.calls = 0


def counters() -> dict:
    """Current launch and plain-call counts by name."""
    return {
        "fused_ce_fwd": fused_ce_fwd.launches,
        "fused_ce_dx": fused_ce_dx.launches,
        "fused_ce_dw": fused_ce_dw.launches,
        "fused_ce_fwd_plain": fused_ce_fwd_plain.calls,
        "fused_ce_dx_plain": fused_ce_dx_plain.calls,
        "fused_ce_dw_plain": fused_ce_dw_plain.calls,
    }
