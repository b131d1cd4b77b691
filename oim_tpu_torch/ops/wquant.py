"""The weight-quantized product: ``x @ W`` over a weight-only int8 or
packed int4 weight, with ``W`` dequantized where it is read.

This kernel replaces no Pallas kernel.  The reference dequantizes its
weights in plain JAX (``oim_tpu/ops/quant.py`` ``dequantize_named``) and
leaves it to XLA to fuse the convert and the scale into the product's
operand read, so device-memory traffic stays int8 or packed int4.
``quant_matmul`` is that fusion on Hopper (``csrc/wquant.cu``).

What it computes: ``x @ W`` with ``W = dequantize_weight(q, scale)``
rounded to ``dtype`` (the compute dtype the reference's product reads,
``dequantize_named(..., dtype=cfg.compute_dtype)``), f32 sums, the
output in ``out_dtype`` (default x's dtype; f32 for the unembedding,
whose bf16 x bf16 product the reference keeps in f32).  Shapes, as the
model uses them: ``q`` [K', N] with ``x`` [..., K]; ``q`` [E, K', N] (a
leading expert axis) with ``x`` [M, K] shared by the experts (``w_gate``,
``w_in``) or ``x`` [E, M, K] one input an expert (``w_out``).  K' is K
for int8 and ceil(K / 2) packed rows for int4 (``ops/quant.py``).

Two routes, picked by ``quant_route`` from the dtype and shapes alone
(no device sync, so CUDA graphs capture either): bf16 x with at most
``GEMV_ROWS`` rows an expert (every decode pass, the admission's one-row
unembedding, MoE experts at decode) takes ``quant_matmul_kernel``, which
streams the payload once, dequantizes it in registers and multiplies on
the tensor cores; taller products (admission waves, segments), f32 x
and shapes the kernel's tiles do not divide dequantize the weight to
``dtype`` with ``dequant_kernel`` and call ``torch.matmul`` on it, as
the reference's XLA computes that product outside any Pallas kernel.
The kernel route cuts the reduction into ``quant_split`` ranges run as
separate blocks and merges them in a fixed order.

``dequantize_weights`` dequantizes a layer's weights once for several
tall products (``_moe_exact``'s passes over an admission's tokens).

CUDA tensors launch a kernel or raise; CPU tensors run the plain
versions.  ``quant_matmul.launches`` counts calls that launched,
``ROUTE_LAUNCHES`` the kernels by route (``gemv``: the fused kernel,
``dequant``: ``dequant_kernel``, from ``quant_matmul`` or
``dequantize_weights``), ``SHAPE_LAUNCHES`` them by route and weight
shape (``shape_key``), ``quant_matmul_plain.calls`` plain runs of either
(``ops/counts.py`` keeps them true across graph replays).
"""

from __future__ import annotations

import torch

from oim_tpu_torch.ops import _build
from oim_tpu_torch.ops.quant import INT4_DTYPE, dequantize_weight, int4_din

# Rows an expert at most on the kernel route (four 16-row tiles, each
# reading the weights again); more go to the dequantized weight and
# torch.matmul.
GEMV_ROWS = 64
# The kernel's tiles: output columns a block owns, the reduction rows of
# one mma step (int4 groups must hold whole steps), the steps a split
# keeps at least (one a warp).
TILE_COLS = 128
STEP_K = 16
MIN_SPLIT_STEPS = 4
# quant_split aims for this many blocks an SM.
BLOCKS_PER_SM = 4
ROUTE_LAUNCHES = {"gemv": 0, "dequant": 0}
# Launches by route and weight shape, under ``shape_key``'s names.
SHAPE_LAUNCHES: dict = {}


def shape_key(route: str, shape) -> str:
    """The count name of ``route``'s launches on weights of logical
    ``shape`` ([E,] K, N), as ``counters()`` lists it."""
    return f"quant_matmul[{route} {'x'.join(map(str, shape))}]"


# Bytes of x a block stages at most (its 8 or 16 rows of its range).
STAGE_BYTES = 32 * 1024


def quant_route(x_dtype, rows: int, k: int, n: int, group: int = 0) -> str:
    """The route for ``rows`` rows an expert of ``x_dtype`` over a ``k`` x
    ``n`` weight (int4 in groups of ``group`` rows, 0 for int8):
    ``"gemv"`` (the fused kernel) for bf16 x, at most ``GEMV_ROWS`` rows,
    ``n`` a multiple of ``TILE_COLS`` and ``k`` (and an int4 group) of
    ``STEP_K``; else ``"dequant"``."""
    fits = (x_dtype == torch.bfloat16 and n % TILE_COLS == 0
            and k % STEP_K == 0 and group % STEP_K == 0)
    return "gemv" if rows <= GEMV_ROWS and fits else "dequant"


def quant_split(experts: int, rows: int, k: int, int4: bool, n: int,
                sms: int) -> int:
    """Reduction ranges of one kernel launch, from host-known sizes: the
    fewest that bring the grid (column tiles × row tiles of 16 × experts
    × splits) to ``BLOCKS_PER_SM`` blocks an SM, each range at least
    ``MIN_SPLIT_STEPS`` mma steps, and at least enough that a block's
    rows of bf16 x over its range (8, or 16 past 8 rows) fit
    ``STAGE_BYTES``."""
    row_tiles = -(-rows // 16)
    tiles = -(-n // TILE_COLS) * experts * row_tiles
    want = -(-BLOCKS_PER_SM * sms // tiles)
    least = -(-k * (8 if rows <= 8 else 16) * 2 // STAGE_BYTES)
    return max(1, least, min(want, k // (STEP_K * MIN_SPLIT_STEPS)))


def _geometry(x, q, scale):
    """(E, M, K, N, x's expert stride, out shape) of a product, or
    ValueError when the operands do not fit together."""
    k = x.shape[-1]
    n = q.shape[-1]
    rows = -(-k // 2) if q.dtype == INT4_DTYPE else k
    if q.dim() not in (2, 3) or q.shape[-2] != rows:
        raise ValueError(
            f"quant_matmul: weight {tuple(q.shape)} {q.dtype} does not take "
            f"x {tuple(x.shape)} (its rows must be {rows})")
    want = (*q.shape[:-2], n) if q.dtype != INT4_DTYPE else None
    if want is not None and tuple(scale.shape) != want:
        raise ValueError(f"quant_matmul: int8 scale {tuple(scale.shape)} "
                         f"must be {want}")
    if q.dtype == INT4_DTYPE and (
            tuple(scale.shape[:-2]) != tuple(q.shape[:-2])
            or scale.shape[-1] != n or k % scale.shape[-2]):
        raise ValueError(f"quant_matmul: int4 scale {tuple(scale.shape)} "
                         f"does not group {k} rows of {n} columns")
    if q.dim() == 2:
        m = x.numel() // k
        return 1, m, k, n, 0, (*x.shape[:-1], n)
    e = q.shape[0]
    if x.dim() == 2:
        return e, x.shape[0], k, n, 0, (e, x.shape[0], n)
    if x.dim() == 3 and x.shape[0] == e:
        return e, x.shape[1], k, n, x.shape[1] * k, (e, x.shape[1], n)
    raise ValueError(f"quant_matmul: x {tuple(x.shape)} against {e} experts")


def quant_matmul_plain(x, q, scale, *, dtype, out_dtype=None):
    """Plain PyTorch version of ``quant_matmul`` (same signature): the
    weight dequantized in f32, rounded to ``dtype``, then ``torch.matmul``
    in ``out_dtype`` — the reference's ``dequantize_named(...,
    dtype)`` followed by its product."""
    quant_matmul_plain.calls += 1
    out_dtype = out_dtype or x.dtype
    w = dequantize_weight(q, scale, din=x.shape[-1]).to(dtype)
    return torch.matmul(x.to(out_dtype), w.to(out_dtype))


quant_matmul_plain.calls = 0


def _count(route: str, q, k: int, n: int) -> None:
    ROUTE_LAUNCHES[route] += 1
    key = shape_key(route, (*q.shape[:-2], k, n))
    SHAPE_LAUNCHES[key] = SHAPE_LAUNCHES.get(key, 0) + 1


def dequantize(q, scale, k: int, dtype):
    """``dequantize_weight(q, scale)`` rounded to ``dtype`` ([..., k, N],
    ``k`` the reduction length): ``dequant_kernel`` on a CUDA tensor (a
    launch of the ``dequant`` route), the plain f32 dequant on the
    CPU."""
    if not q.is_cuda:
        quant_matmul_plain.calls += 1
        return dequantize_weight(q, scale, din=k).to(dtype)
    e = q.shape[0] if q.dim() == 3 else 1
    n = q.shape[-1]
    group = k // scale.shape[-2] if q.dtype == INT4_DTYPE else 0
    w = torch.empty((*q.shape[:-2], k, n), dtype=dtype, device=q.device)
    code = _build.library().oim_dequant_weight(
        _build.ptr(q), _build.DTYPE_CODES[q.dtype], _build.ptr(scale),
        _build.ptr(w), _build.DTYPE_CODES[dtype], e, k, n, group,
        _build.stream_of(q),
    )
    _build.check(code, "dequant_weight")
    _count("dequant", q, k, n)
    return w


def dequantize_weights(tree: dict, names, dtype) -> dict:
    """``tree`` with each weight-quantized entry of ``names`` dequantized
    to ``dtype`` (``dequantize``) and its ``_wscale`` dropped: one
    dequant for several products over the same weight."""
    out = {name: t for name, t in tree.items()
           if name.removesuffix("_wscale") not in names
           or not name.endswith("_wscale")}
    for name in names:
        scale = tree.get(f"{name}_wscale")
        if scale is not None:
            q = tree[name]
            k = int4_din(q, scale) if q.dtype == INT4_DTYPE else q.shape[-2]
            out[name] = dequantize(q, scale, k, dtype)
    return out


def quant_matmul(x, q, scale, *, dtype, out_dtype=None):
    """``x @ W``, ``W`` the dequantized ``q`` (int8, or packed int4 as
    ``torch.uint8``) with its ``scale``, rounded to ``dtype`` (x's
    dtype on the card); the result in ``out_dtype`` (default x's dtype;
    f32 from bf16 x is the unembedding).  CUDA tensors launch the route
    ``quant_route`` picks (one launch counted a call); CPU tensors run
    the plain version."""
    e, m, k, n, x_es, out_shape = _geometry(x, q, scale)
    if not x.is_cuda:
        return quant_matmul_plain(x, q, scale, dtype=dtype,
                                  out_dtype=out_dtype)
    out_dtype = out_dtype or x.dtype
    if x.dtype != dtype or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"quant_matmul: x {x.dtype} must be the weight's "
                         f"compute dtype {dtype}, bf16 or f32")
    if out_dtype not in (x.dtype, torch.float32):
        raise ValueError(f"quant_matmul: output {out_dtype} from {x.dtype}")
    if q.dtype not in (torch.int8, INT4_DTYPE) or scale.dtype != torch.float32:
        raise ValueError(f"quant_matmul: weight {q.dtype} with scale "
                         f"{scale.dtype}: int8 or packed int4, f32 scales")
    for name, t in (("q", q), ("scale", scale)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"quant_matmul: {name} must be contiguous on "
                             f"{x.device}")
    group = k // scale.shape[-2] if q.dtype == INT4_DTYPE else 0
    route = quant_route(x.dtype, m, k, n, group)
    if route == "dequant":
        w = dequantize(q, scale, k, dtype)
        out = torch.matmul(x.to(out_dtype), w.to(out_dtype))
    else:
        x = x.contiguous()
        if x.data_ptr() % 16:
            x = x.clone()
        if any(t.data_ptr() % 16 for t in (q, scale)):
            raise ValueError("quant_matmul: the kernel reads the weight and "
                             "its scales in 16-byte vectors: align them")
        splits = quant_split(e, m, k, q.dtype == INT4_DTYPE, n,
                             _build.sm_count(x.device))
        out = torch.empty((e, m, n), dtype=out_dtype, device=x.device)
        partials = None
        if splits > 1:
            partials = torch.empty(splits * e * m * n, dtype=torch.float32,
                                   device=x.device)
        code = _build.library().oim_quant_matmul(
            _build.ptr(x), _build.DTYPE_CODES[x.dtype], x_es, _build.ptr(q),
            _build.DTYPE_CODES[q.dtype], _build.ptr(scale), _build.ptr(out),
            _build.DTYPE_CODES[out_dtype], _build.ptr(partials), e, m, k, n,
            group, splits, _build.stream_of(x),
        )
        _build.check(code, "quant_matmul")
        _count("gemv", q, k, n)
        out = out.reshape(out_shape)
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0


def reset_counters() -> None:
    """Zero every launch, route and plain-call count."""
    replay_counts({name: -n for name, n in counters().items()})


def counters() -> dict:
    """Current launch, route and plain-call counts by name."""
    return {
        "quant_matmul": quant_matmul.launches,
        **{f"quant_matmul_{route}": n for route, n in ROUTE_LAUNCHES.items()},
        "quant_matmul_plain": quant_matmul_plain.calls,
        **SHAPE_LAUNCHES,
    }


def replay_counts(delta: dict) -> None:
    """Add ``delta``'s counts under ``counters()``'s names: a replay of a
    captured region adds what ``ops/counts.py::recording`` kept."""
    quant_matmul.launches += delta["quant_matmul"]
    for route in ROUTE_LAUNCHES:
        ROUTE_LAUNCHES[route] += delta[f"quant_matmul_{route}"]
    quant_matmul_plain.calls += delta["quant_matmul_plain"]
    for key, n in delta.items():
        if key.startswith("quant_matmul["):
            SHAPE_LAUNCHES[key] = SHAPE_LAUNCHES.get(key, 0) + n

