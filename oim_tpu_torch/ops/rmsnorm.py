"""RMSNorm: the plain formula, the Hopper kernel's wrapper, and the
differentiable ``rmsnorm`` the training forward calls.

``rmsnorm_fwd`` launches ``csrc/rmsnorm.cu`` ``rmsnorm_kernel``, which
replaces ``oim_tpu/ops/rmsnorm.py`` ``_kernel``, for CUDA tensors (or
raises) and runs ``rmsnorm_plain`` only for CPU tensors.  Like the
reference's kernel it takes rows of any width: ``rmsnorm_route`` sends
rows that fit one warp's registers to ``rmsnorm_kernel`` and wider ones
to ``rmsnorm_wide_kernel`` (a block a row, two passes).  ``rmsnorm``
is a ``torch.autograd.Function`` like the reference's custom_vjp: the
forward goes through ``rmsnorm_fwd``, the backward recomputes through
``reference_rmsnorm`` (no backward kernel; RMSNorm is cheap to redo).
The serving path calls ``reference_rmsnorm`` directly, as the
reference's engine forces ``use_pallas=False``.

``rmsnorm_fwd.launches`` counts kernel launches (``.wide_launches``
those of the wide route among them) and ``rmsnorm_plain.calls`` plain
runs in its place; the backward's recompute is neither.
"""

from __future__ import annotations

import torch

from oim_tpu_torch.ops import _build

# The register route keeps a row in one warp's registers: at most 16
# chunks of 16 bytes a lane.  Wider rows take the wide route.
MAX_ROW_BYTES = 16 * 16 * 32


def rmsnorm_route(d: int, dtype) -> str:
    """The kernel a row of ``d`` elements of ``dtype`` takes: "rows"
    (``rmsnorm_kernel``, the row in a warp's registers) when it fits
    ``MAX_ROW_BYTES``, else "wide" (``rmsnorm_wide_kernel``)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return "rows" if d * itemsize <= MAX_ROW_BYTES else "wide"


def reference_rmsnorm(x, w, eps: float = 1e-6):
    """``x * rsqrt(mean(x², -1) + eps) * w`` reduced in f32, returned in
    x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps) * w.to(torch.float32)
    return normed.to(x.dtype)


def rmsnorm_plain(x, w, eps: float = 1e-6):
    """Plain PyTorch version of ``rmsnorm_fwd``: ``reference_rmsnorm``,
    counted."""
    rmsnorm_plain.calls += 1
    return reference_rmsnorm(x, w, eps)


rmsnorm_plain.calls = 0


def _check_kernel_operands(x, w) -> None:
    """Raise unless the kernels take these operands: x f32/bf16 [..., D]
    with rows of whole 16-byte chunks, 16-byte aligned; w [D] f32/bf16
    on x's device."""
    d = x.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype not in (
            torch.float32, torch.bfloat16):
        raise ValueError(
            f"rmsnorm kernel takes f32/bf16 x and w; got {x.dtype}, {w.dtype}")
    if tuple(w.shape) != (d,):
        raise ValueError(f"rmsnorm: w {tuple(w.shape)} must be [{d}]")
    row_bytes = d * x.element_size()
    if row_bytes % 16:
        raise ValueError(
            f"rmsnorm kernel needs rows of whole 16-byte chunks; got {d} x "
            f"{x.dtype}")
    if w.device != x.device:
        raise ValueError(f"rmsnorm: w on {w.device}, expected {x.device}")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(
            "rmsnorm kernel reads x and w in 16-byte chunks: align them")


def rmsnorm_fwd(x, w, eps: float = 1e-6):
    """RMSNorm of x [..., D] by w [D], reduced in f32, in x's dtype.
    CUDA tensors launch the kernel; CPU tensors run the plain version."""
    if not x.is_cuda:
        return rmsnorm_plain(x, w, eps)
    x = x.contiguous()
    w = w.contiguous()
    _check_kernel_operands(x, w)
    out = torch.empty_like(x)
    d = x.shape[-1]
    wide = rmsnorm_route(d, x.dtype) == "wide"
    lib = _build.library()
    entry = lib.oim_rmsnorm_wide if wide else lib.oim_rmsnorm
    code = entry(
        _build.ptr(x), _build.DTYPE_CODES[x.dtype],
        _build.ptr(w), _build.DTYPE_CODES[w.dtype],
        _build.ptr(out), x.numel() // d, d, float(eps), _build.stream_of(x),
    )
    _build.check(code, "rmsnorm_wide" if wide else "rmsnorm")
    rmsnorm_fwd.launches += 1
    rmsnorm_fwd.wide_launches += int(wide)
    return out


rmsnorm_fwd.launches = 0
rmsnorm_fwd.wide_launches = 0


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rmsnorm_fwd(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_(ctx.needs_input_grad[0])
            wd = w.detach().requires_grad_(ctx.needs_input_grad[1])
            out = reference_rmsnorm(xd, wd, ctx.eps)
            inputs = [t for t in (xd, wd) if t.requires_grad]
            grads = iter(torch.autograd.grad(out, inputs, g))
        gx = next(grads) if ctx.needs_input_grad[0] else None
        gw = next(grads) if ctx.needs_input_grad[1] else None
        return gx, gw, None


def rmsnorm(x, w, eps: float = 1e-6):
    """Differentiable RMSNorm over the last dimension (the reference's
    ``oim_tpu.ops.rmsnorm.rmsnorm``): forward through ``rmsnorm_fwd``,
    backward through ``reference_rmsnorm``."""
    return _RMSNorm.apply(x, w, eps)


def reset_counters() -> None:
    """Zero the launch and plain-call counts."""
    replay_counts({name: -n for name, n in counters().items()})


def counters() -> dict:
    """Current launch and plain-call counts by name."""
    return {"rmsnorm": rmsnorm_fwd.launches,
            "rmsnorm_wide": rmsnorm_fwd.wide_launches,
            "rmsnorm_plain": rmsnorm_plain.calls}


def replay_counts(delta: dict) -> None:
    """Add ``delta``'s counts under ``counters()``'s names (others are
    ignored): what a replay of a captured region launched
    (``ops/counts.py``)."""
    rmsnorm_fwd.launches += delta["rmsnorm"]
    rmsnorm_fwd.wide_launches += delta["rmsnorm_wide"]
    rmsnorm_plain.calls += delta["rmsnorm_plain"]
