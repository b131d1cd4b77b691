"""Flash attention for training: the reference formula, plain PyTorch
versions of the three Hopper kernels, their wrappers, and the
differentiable ``flash_attention`` the training forward calls.

Kernels (``csrc/flash_attention.cu``), each replacing one TPU kernel of
``oim_tpu/ops/flash_attention.py``:

- ``flash_fwd`` → ``flash_fwd_tc_kernel`` in bf16, ``flash_fwd_kernel``
  in f32 (``_fwd_kernel``): causal online-softmax attention with GQA,
  sliding window and segment ids; returns the output and the per-row
  logsumexp ``lse`` [B·H, T] f32.
- ``flash_dq`` → ``flash_dq_tc_kernel`` in bf16, ``flash_dq_kernel`` in
  f32 (``_dq_kernel``): dq, recomputing the probabilities from (q, k,
  lse).
- ``flash_dkv`` → ``flash_dkv_tc_kernel`` (and ``dkv_sum_kernel``) in
  bf16, ``flash_dkv_kernel`` in f32 (``_dkv_kernel``): dk and dv
  together, summed over each kv head's group of q heads.

The bf16 route (the training path: forward and backward) runs on the
tensor cores, rounding P (and dS) to bf16 only as operands of their
products; f32 keeps exact f32 arithmetic on the CUDA cores.  The bf16 dkv cuts each kv
head's group into ``split`` partitions of q heads, one block each, and
sums their f32 partials in a fixed order (``dkv_split`` chooses
``split``).

``delta = rowsum(dout · out)`` is computed outside the kernels, in
PyTorch, as the reference computes it in XLA.  The kernels take any T
(ragged tails are masked), so unlike the reference there is no fallback
to ``reference_attention`` for T the tiles do not divide.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs
its plain version only for CPU tensors; ``<wrapper>.launches`` and
``<plain>.calls`` count which path ran.  Scores are ``(q / sqrt(hd)) ·
k``; masked pairs get probability 0 (the reference's ``-1e30``).
"""

from __future__ import annotations

import torch

from oim_tpu_torch.ops import _build

NEG_BIG = -1e30
# head_dim is a template parameter of the kernels.
HEAD_DIMS = (64, 128)
# Keys a block of the bf16 dkv kernel owns (csrc/flash_attention.cu
# kTcRows).
DKV_KEY_TILE = 64
# dkv_split splits a group until the grid has this many blocks per SM.
DKV_BLOCKS_PER_SM = 4


def reference_attention(q, k, v, causal: bool = True, segments=None,
                        window: int = 0):
    """O(T²) oracle (the reference's ``reference_attention``): q [B, T,
    H, D], k/v [B, T, KVH, D] broadcast over GQA groups; ``segments`` [B,
    T] restricts attention to same-segment pairs; ``window`` > 0 keeps
    the last ``window`` positions (causal only).  Output in q's
    dtype."""
    d = q.shape[-1]
    if k.shape[2] != q.shape[2]:
        group = q.shape[2] // k.shape[2]
        k = torch.repeat_interleave(k, group, dim=2)
        v = torch.repeat_interleave(v, group, dim=2)
    scores = torch.einsum(
        "bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32)
    ) / (d**0.5)
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        rows = torch.arange(tq, device=q.device)[:, None]
        cols = torch.arange(tk, device=q.device)[None, :]
        mask = rows >= cols
        if window:
            mask &= rows - cols < window
        scores = torch.where(mask, scores, NEG_BIG)
    elif window:
        raise ValueError("sliding window requires causal attention")
    if segments is not None:
        same = segments[:, :, None] == segments[:, None, :]  # [B, Tq, Tk]
        scores = torch.where(same[:, None, :, :], scores, NEG_BIG)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum(
        "bhqk,bkhd->bqhd", probs, v.to(torch.float32)).to(q.dtype)


def _keep(t, causal, window, segments, device):
    """[B or 1, 1, T, T] bool: query i attends key j."""
    rows = torch.arange(t, device=device)[:, None]
    cols = torch.arange(t, device=device)[None, :]
    keep = torch.ones((t, t), dtype=torch.bool, device=device)
    if causal:
        keep &= rows >= cols
    if window:
        keep &= rows - cols < window
    keep = keep[None, None]
    if segments is not None:
        keep = keep & (segments[:, :, None] == segments[:, None, :])[:, None]
    return keep


def _scores(q, k):
    """(q·scale in f32 [B, T, H, D], k repeated over the group in f32,
    scores [B, H, T, T]) in the kernels' order: q is scaled, then dotted
    with k."""
    group = q.shape[2] // k.shape[2]
    qs = q.to(torch.float32) * (1.0 / q.shape[-1]**0.5)
    kf = torch.repeat_interleave(k.to(torch.float32), group, dim=2)
    return qs, kf, torch.einsum("bqhd,bkhd->bhqk", qs, kf)


def _probs(q, k, lse, causal, window, segments):
    """(q·scale, k repeated, probabilities [B, H, T, T] from lse [B·H,
    T]) — the recomputation the dq and dkv kernels do."""
    b, t, h, _ = q.shape
    qs, kf, scores = _scores(q, k)
    keep = _keep(t, causal, window, segments, q.device)
    p = torch.where(keep, torch.exp(scores - lse.reshape(b, h, t, 1)), 0.0)
    return qs, kf, p


def _group_sum(x, kvh):
    """[B, T, H, D] per q head → [B, T, KVH, D] summed over each kv
    head's group."""
    b, t, h, d = x.shape
    return x.reshape(b, t, kvh, h // kvh, d).sum(dim=3)


def _check(what, q, k, v, causal, window, segments, *more) -> None:
    """Raise on shapes the kernels (and plain versions) do not share:
    q [B, T, H, D], k and v [B, T, KVH, D] with H % KVH == 0, segments
    [B, T], a window only with causal attention, and ``more`` ((name,
    tensor, shape) triples) of the given shapes."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or (
            k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]
            or q.shape[2] % k.shape[2]):
        raise ValueError(
            f"{what}: q {tuple(q.shape)} and k/v {tuple(k.shape)}, "
            f"{tuple(v.shape)} must be [B, T, H, D] and [B, T, KVH, D] "
            f"with H % KVH == 0")
    if window and not causal:
        raise ValueError("sliding window requires causal attention")
    if segments is not None and tuple(segments.shape) != tuple(q.shape[:2]):
        raise ValueError(
            f"{what}: segments {tuple(segments.shape)} must be "
            f"{tuple(q.shape[:2])}")
    for name, t, shape in more:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"{what}: {name} {tuple(t.shape)} must be {tuple(shape)}")


def _kernel_operands(what, tensors: dict, dtype, segments):
    """The operands as the kernels take them: every tensor contiguous on
    the first one's device, 16-byte aligned, of ``dtype`` (f32/bf16)
    except lse/delta (f32), head_dim 64 or 128; segments as int32."""
    first = next(iter(tensors.values()))
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what} kernel takes f32/bf16, got {dtype}")
    if first.shape[-1] not in HEAD_DIMS:
        raise ValueError(
            f"{what} kernel needs head_dim in {HEAD_DIMS}, got "
            f"{first.shape[-1]}")
    out = {}
    for name, t in tensors.items():
        want = torch.float32 if name in ("lse", "delta") else dtype
        if t.dtype != want:
            raise ValueError(f"{what}: {name} is {t.dtype}, expected {want}")
        if t.device != first.device:
            raise ValueError(
                f"{what}: {name} on {t.device}, expected {first.device}")
        t = t.contiguous()
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")
        out[name] = t
    if segments is not None:
        if segments.device != first.device:
            raise ValueError(
                f"{what}: segments on {segments.device}, expected "
                f"{first.device}")
        segments = segments.to(torch.int32).contiguous()
    return out, segments


# ---------------------------------------------------------------------------
# Forward


def flash_fwd_plain(q, k, v, causal=True, window=0, segments=None):
    """Plain PyTorch version of ``flash_fwd`` (same signature): the
    masked softmax in f32 with its logsumexp."""
    flash_fwd_plain.calls += 1
    b, t, h, _ = q.shape
    vf = torch.repeat_interleave(v.to(torch.float32), h // k.shape[2], dim=2)
    _, _, scores = _scores(q, k)
    keep = _keep(t, causal, window, segments, q.device)
    scores = torch.where(keep, scores, NEG_BIG)
    lse = torch.logsumexp(scores, dim=-1)  # [B, H, T]
    probs = torch.where(keep, torch.exp(scores - lse[..., None]), 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)
    return out, lse.reshape(b * h, t)


flash_fwd_plain.calls = 0


def flash_fwd(q, k, v, causal=True, window=0, segments=None):
    """Attention forward: q [B, T, H, D], k/v [B, T, KVH, D] (f32 or
    bf16), optional int segments [B, T] → (out [B, T, H, D] in q's
    dtype, lse [B·H, T] f32).  CUDA tensors launch the kernel; CPU
    tensors run the plain version."""
    _check("flash_fwd", q, k, v, causal, window, segments)
    if not q.is_cuda:
        return flash_fwd_plain(q, k, v, causal, window, segments)
    ops, seg = _kernel_operands("flash_fwd", dict(q=q, k=k, v=v), q.dtype,
                                segments)
    b, t, h, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=q.device)
    code = _build.library().oim_flash_fwd(
        _build.ptr(ops["q"]), _build.ptr(ops["k"]), _build.ptr(ops["v"]),
        _build.DTYPE_CODES[q.dtype], _build.ptr(seg), _build.ptr(out),
        _build.ptr(lse), b, t, h, k.shape[2], d, int(bool(causal)),
        int(window), _build.stream_of(q),
    )
    _build.check(code, "flash_fwd")
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


# ---------------------------------------------------------------------------
# Backward


def flash_delta(out, dout):
    """``rowsum(dout · out)`` in f32 as [B·H, T] — the softmax term of
    dS that both backward kernels read (computed outside them, as the
    reference does)."""
    b, t, h, _ = out.shape
    delta = (dout.to(torch.float32) * out.to(torch.float32)).sum(-1)
    return delta.transpose(1, 2).reshape(b * h, t).contiguous()


def flash_dq_plain(q, k, v, dout, lse, delta, causal=True, window=0,
                   segments=None):
    """Plain PyTorch version of ``flash_dq`` (same signature)."""
    flash_dq_plain.calls += 1
    b, t, h, d = q.shape
    group = h // k.shape[2]
    _, kf, p = _probs(q, k, lse, causal, window, segments)
    vf = torch.repeat_interleave(v.to(torch.float32), group, dim=2)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.to(torch.float32), vf)
    ds = p * (dp - delta.reshape(b, h, t, 1))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * (1.0 / d**0.5)
    return dq.to(q.dtype)


flash_dq_plain.calls = 0


def flash_dkv_plain(q, k, v, dout, lse, delta, causal=True, window=0,
                    segments=None):
    """Plain PyTorch version of ``flash_dkv`` (its signature less
    ``split``)."""
    flash_dkv_plain.calls += 1
    b, t, h, _ = q.shape
    kvh = k.shape[2]
    qs, _, p = _probs(q, k, lse, causal, window, segments)
    vf = torch.repeat_interleave(v.to(torch.float32), h // kvh, dim=2)
    dof = dout.to(torch.float32)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta.reshape(b, h, t, 1))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
    return (_group_sum(dk, kvh).to(k.dtype),
            _group_sum(dv, kvh).to(v.dtype))


flash_dkv_plain.calls = 0


def _backward_operands(what, q, k, v, dout, lse, delta, causal, window,
                       segments):
    b, t, h, _ = q.shape
    _check(what, q, k, v, causal, window, segments,
           ("dout", dout, q.shape), ("lse", lse, (b * h, t)),
           ("delta", delta, (b * h, t)))
    return _kernel_operands(
        what, dict(q=q, k=k, v=v, dout=dout, lse=lse, delta=delta),
        q.dtype, segments)


def flash_dq(q, k, v, dout, lse, delta, causal=True, window=0,
             segments=None):
    """dq [B, T, H, D] in q's dtype from the forward's inputs, the output
    cotangent ``dout`` [B, T, H, D], ``lse`` and ``delta`` [B·H, T] f32.
    CUDA tensors launch the kernel; CPU tensors run the plain version."""
    if not q.is_cuda:
        _check("flash_dq", q, k, v, causal, window, segments)
        return flash_dq_plain(q, k, v, dout, lse, delta, causal, window,
                              segments)
    ops, seg = _backward_operands("flash_dq", q, k, v, dout, lse, delta,
                                  causal, window, segments)
    b, t, h, d = q.shape
    dq = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    code = _build.library().oim_flash_dq(
        *(_build.ptr(ops[n]) for n in ("q", "k", "v", "dout", "lse",
                                       "delta")),
        _build.DTYPE_CODES[q.dtype], _build.ptr(seg), _build.ptr(dq),
        b, t, h, k.shape[2], d, int(bool(causal)), int(window),
        _build.stream_of(q),
    )
    _build.check(code, "flash_dq")
    flash_dq.launches += 1
    return dq


flash_dq.launches = 0


def dkv_split(batch_kv: int, group: int, t: int, sms: int) -> int:
    """Partitions of each kv head's group of q heads for the bf16 dkv
    kernel, given B·KVH, the group size, T and the card's SM count: the
    smallest divisor of ``group`` whose grid (key tiles × B·KVH ×
    split) reaches ``DKV_BLOCKS_PER_SM`` blocks an SM, else ``group``.
    A causal key tile's work grows with its distance from the end, so
    a grid of few, whole-group blocks waits on its heaviest; splitting
    cuts that chain at the cost of f32 partials (written and summed
    once per extra partition)."""
    tiles = -(-t // DKV_KEY_TILE) * batch_kv
    for split in range(1, group + 1):
        if group % split == 0 and tiles * split >= DKV_BLOCKS_PER_SM * sms:
            return split
    return group


def flash_dkv(q, k, v, dout, lse, delta, causal=True, window=0,
              segments=None, split=None):
    """(dk, dv) [B, T, KVH, D] in k's dtype, each summed over its kv
    head's group of q heads; operands as ``flash_dq``.  ``split`` (bf16
    kernel only; a divisor of the group) cuts the group into partitions
    whose partial sums are added in a fixed order; None takes
    ``dkv_split``'s choice, and f32 takes 1.  CUDA tensors launch the
    kernel; CPU tensors run the plain version (for any ``split``: it
    shapes only the kernel's grid)."""
    _check("flash_dkv", q, k, v, causal, window, segments)
    group = q.shape[2] // k.shape[2]
    if split is not None and (split < 1 or group % split):
        raise ValueError(
            f"flash_dkv: split {split} must divide the group of {group}")
    if not q.is_cuda:
        return flash_dkv_plain(q, k, v, dout, lse, delta, causal, window,
                               segments)
    ops, seg = _backward_operands("flash_dkv", q, k, v, dout, lse, delta,
                                  causal, window, segments)
    b, t, h, d = q.shape
    kvh = k.shape[2]
    if q.dtype != torch.bfloat16:
        if split not in (None, 1):
            raise ValueError("flash_dkv: the f32 kernel takes no split")
        split = 1
    elif split is None:
        split = dkv_split(b * kvh, group, t, _build.sm_count(q.device))
    dk = torch.empty_like(ops["k"])
    dv = torch.empty_like(ops["v"])
    partials = None
    if split > 1:
        partials = torch.empty((2, split, b * t * kvh * d),
                               dtype=torch.float32, device=q.device)
    code = _build.library().oim_flash_dkv(
        *(_build.ptr(ops[n]) for n in ("q", "k", "v", "dout", "lse",
                                       "delta")),
        _build.DTYPE_CODES[q.dtype], _build.ptr(seg), _build.ptr(dk),
        _build.ptr(dv), _build.ptr(partials), b, t, h, kvh, d,
        int(bool(causal)), int(window), split, _build.stream_of(q),
    )
    _build.check(code, "flash_dkv")
    flash_dkv.launches += 1
    return dk, dv


flash_dkv.launches = 0


# ---------------------------------------------------------------------------
# Autograd


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, segments, causal, window):
        out, lse = flash_fwd(q, k, v, causal, window, segments)
        ctx.save_for_backward(q, k, v, out, lse, segments)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, segments = ctx.saved_tensors
        dout = dout.contiguous()
        delta = flash_delta(out, dout)
        args = (ctx.causal, ctx.window, segments)
        dq = flash_dq(q, k, v, dout, lse, delta, *args)
        dk, dv = flash_dkv(q, k, v, dout, lse, delta, *args)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    segments=None):
    """Differentiable attention over q [B, T, H, D] and k/v [B, T, KVH,
    D] (the reference's ``flash_attention``): forward through
    ``flash_fwd``, saving (q, k, v, out, lse); backward through
    ``flash_dq`` and ``flash_dkv``.  Output in q's dtype."""
    if q.dtype != k.dtype or k.dtype != v.dtype:
        raise ValueError(
            f"flash_attention: q, k, v must share a dtype; got {q.dtype}, "
            f"{k.dtype}, {v.dtype}")
    return _FlashAttention.apply(q, k, v, segments, bool(causal),
                                 int(window))


def reset_counters() -> None:
    """Zero every launch and plain-call count."""
    replay_counts({name: -n for name, n in counters().items()})


def counters() -> dict:
    """Current launch and plain-call counts by name."""
    return {
        "flash_fwd": flash_fwd.launches,
        "flash_dq": flash_dq.launches,
        "flash_dkv": flash_dkv.launches,
        "flash_fwd_plain": flash_fwd_plain.calls,
        "flash_dq_plain": flash_dq_plain.calls,
        "flash_dkv_plain": flash_dkv_plain.calls,
    }


def replay_counts(delta: dict) -> None:
    """Add ``delta``'s counts under ``counters()``'s names (others are
    ignored): what a replay of a captured region launched
    (``ops/counts.py``)."""
    for fn in (flash_fwd, flash_dq, flash_dkv):
        fn.launches += delta[fn.__name__]
    for fn in (flash_fwd_plain, flash_dq_plain, flash_dkv_plain):
        fn.calls += delta[fn.__name__]
