"""Parity of the port's training kernels' plain versions with the JAX
package's kernels, on the CPU.

The same numpy inputs go through the reference's Pallas kernels, which
run in interpret mode here (``oim_tpu.ops.rmsnorm.rmsnorm``;
``oim_tpu.ops.flash_attention`` at T of 128 and 256, where its tiles
divide T — below that it silently takes the reference formula), and
through the port's differentiable wrappers, which run their plain
versions for CPU tensors.  The Hopper kernels themselves are held
against those plain versions on the card (``tests/test_torch_kernels.py``
and ``chip_smoke.py``).

Tolerances: in f32 the two sides differ only in summation order (dots of
16 terms, softmax sums of at most 256 keys of unit-scale data), far
below 1e-5; bf16 outputs may differ by one bf16 rounding step (2**-8 of
the value) where an f32 last bit rounds differently.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oim_tpu.ops.rmsnorm import rmsnorm as j_rmsnorm

from oim_tpu_torch.ops import flash_attention as tfa
from oim_tpu_torch.ops import rmsnorm as trms

# The package re-exports the function under the module's name.
jfa = importlib.import_module("oim_tpu.ops.flash_attention")

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("rows", [37, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_forward_and_grads_match_jax(dtype, rows):
    """Ragged row counts: 37 (one partial tile) and 300 (a full 256-row
    tile of the Pallas kernel plus a padded one)."""
    rng = np.random.RandomState(rows)
    x = (rng.randn(rows, 64) * 2).astype(np.float32)
    w = (rng.rand(64) + 0.5).astype(np.float32)
    g = rng.randn(rows, 64).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    want, vjp = jax.vjp(lambda x, w: j_rmsnorm(x, w, 1e-6), jx,
                        jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g, dtype))
    tx = _t(x).to(getattr(torch, dtype)).requires_grad_()
    tw = _t(w).requires_grad_()
    got = trms.rmsnorm(tx, tw, 1e-6)
    got_dx, got_dw = torch.autograd.grad(got, (tx, tw),
                                         _t(g).to(got.dtype))
    assert got.dtype == tx.dtype and got_dx.dtype == tx.dtype
    rtol = 1e-6 if dtype == "float32" else 2.0 ** -8
    for a, b in ((got, want), (got_dx, want_dx)):
        np.testing.assert_allclose(
            a.float().detach().numpy(), np.asarray(b.astype(jnp.float32)),
            rtol=rtol, atol=1e-5)
    # dw sums rows x g in f32 on both sides (from bf16 operands in bf16).
    np.testing.assert_allclose(got_dw.numpy(), np.asarray(want_dw),
                               rtol=1e-5, atol=1e-4)


# (T, GQA group, window, packed segments): every value of each axis, and
# MHA/GQA with and without window and segments, at T where the
# reference's Pallas kernels really run.
FLASH_CASES = [
    (128, 1, 0, False),
    (128, 2, 0, False),
    (128, 2, 64, True),
    (256, 1, 64, False),
    (256, 2, 0, True),
    (256, 2, 64, True),
]


@pytest.mark.parametrize("t,group,window,segmented", FLASH_CASES)
def test_flash_attention_matches_jax(t, group, window, segmented):
    """Forward output, per-row lse and the vjp (dq, dk, dv) against the
    reference's forward and backward kernels in interpret mode."""
    rng = np.random.RandomState(t + 10 * group + window + segmented)
    b, kvh, hd = 2, 2, 16
    h = kvh * group
    q = rng.randn(b, t, h, hd).astype(np.float32)
    k = rng.randn(b, t, kvh, hd).astype(np.float32)
    v = rng.randn(b, t, kvh, hd).astype(np.float32)
    g = rng.randn(b, t, h, hd).astype(np.float32)
    seg = None
    if segmented:
        seg = np.cumsum(rng.rand(b, t) < 0.03, axis=1).astype(np.int32)
    jseg = None if seg is None else jnp.asarray(seg)
    # The reference's custom_vjp halves: its forward returns the lse among
    # the residuals, its backward the three gradients.
    want, res = jfa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         True, 0, 0, window, jseg)
    assert res[4] is not None, "the reference fell back to its formula"
    want_lse = np.asarray(res[4])[..., 0]  # [B*H, T] of the 8-lane tile
    want_dq, want_dk, want_dv, _ = jfa._bwd(True, 0, 0, window, res,
                                            jnp.asarray(g))

    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    tseg = None if seg is None else _t(seg)
    before = tfa.counters()
    got = tfa.flash_attention(*leaves, True, window, tseg)
    dq, dk, dv = torch.autograd.grad(got, leaves, _t(g))
    _, lse = tfa.flash_fwd(*(_t(x) for x in (q, k, v)), True, window, tseg)
    after = tfa.counters()
    assert after["flash_fwd_plain"] == before["flash_fwd_plain"] + 2
    assert after["flash_dq_plain"] == before["flash_dq_plain"] + 1
    assert after["flash_dkv_plain"] == before["flash_dkv_plain"] + 1
    for a, w in ((got, want), (lse, want_lse), (dq, want_dq),
                 (dk, want_dk), (dv, want_dv)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(w),
                                   atol=ATOL, rtol=0)


def test_flash_attention_any_t_matches_reference_formula():
    """A T the reference's tiles do not divide (it falls back to its
    formula there): the port's one path agrees with that formula, in
    the forward and through autograd."""
    rng = np.random.RandomState(3)
    q = rng.randn(2, 50, 4, 16).astype(np.float32)
    k = rng.randn(2, 50, 2, 16).astype(np.float32)
    v = rng.randn(2, 50, 2, 16).astype(np.float32)
    seg = np.cumsum(rng.rand(2, 50) < 0.1, axis=1).astype(np.int32)
    want, vjp = jax.vjp(
        lambda q, k, v: jfa.reference_attention(q, k, v, True,
                                                jnp.asarray(seg), 7),
        *(jnp.asarray(x) for x in (q, k, v)))
    want_grads = vjp(jnp.ones_like(want))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    got = tfa.flash_attention(*leaves, True, 7, _t(seg))
    grads = torch.autograd.grad(got, leaves, torch.ones_like(got))
    ref = tfa.reference_attention(*(_t(x) for x in (q, k, v)), True,
                                  _t(seg), 7)
    for a, w in [(got, want), (ref, want), *zip(grads, want_grads)]:
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(w),
                                   atol=ATOL, rtol=0)


def test_flash_wrappers_refuse_mismatched_operands():
    q = torch.zeros(1, 8, 4, 16)
    kv = torch.zeros(1, 8, 3, 16)
    with pytest.raises(ValueError, match="H % KVH"):
        tfa.flash_fwd(q, kv, kv)
    with pytest.raises(ValueError, match="sliding window"):
        tfa.flash_attention(q, q, q, False, 4)
    with pytest.raises(ValueError, match="segments"):
        tfa.flash_fwd(q, q, q, True, 0, torch.zeros(1, 7, dtype=torch.int32))
    with pytest.raises(ValueError, match="share a dtype"):
        tfa.flash_attention(q, q.double(), q)


def test_reset_counters():
    q = torch.zeros(1, 8, 2, 16)
    tfa.flash_fwd(q, q, q)
    trms.rmsnorm_fwd(q, torch.ones(16))
    assert tfa.counters()["flash_fwd_plain"] > 0
    assert trms.counters()["rmsnorm_plain"] > 0
    tfa.reset_counters()
    trms.reset_counters()
    assert set(tfa.counters().values()) == {0}
    assert set(trms.counters().values()) == {0}


def test_every_kernel_entry_point_has_its_ctypes_signature():
    """Each ``extern "C"`` entry point the headers declare is bound with
    one argtype per parameter: ctypes would otherwise pass a pointer as a
    32-bit int and cut it."""
    import re

    from oim_tpu_torch.ops import _build

    declared = {}
    for header in _build.HEADERS:
        text = (_build.CSRC / header).read_text()
        for name, params in re.findall(r"int (oim_\w+)\(([^;]*)\);", text):
            declared[name] = len(params.split(","))
    assert declared and set(declared) == set(_build._SIGNATURES)
    assert {"oim_fused_ce_fwd", "oim_fused_ce_dx", "oim_fused_ce_dw"} <= set(
        declared)
    for name, n in declared.items():
        assert len(_build._SIGNATURES[name]) == n, name


@pytest.mark.parametrize("batch_kv,group,t,sms,want", [
    # Qwen2.5-1.5B's training shape on an H100: 16 key tiles x B*KVH 8 =
    # 128 blocks at split 1; 4 blocks an SM of 132 needs 528.
    (8, 6, 1024, 132, 6),
    (8, 6, 4096, 132, 2),  # 512 blocks: 528 needs split 2
    (8, 6, 2048, 132, 3),  # 256 blocks: split 2 gives 512, 3 gives 768
    (8, 1, 1024, 132, 1),  # no group to split
    (2, 4, 100, 8, 4),  # 2 key tiles x 2 = 4 blocks: every split short
])
def test_dkv_split_reaches_blocks_per_sm(batch_kv, group, t, sms, want):
    """The smallest divisor of the group whose dkv grid reaches
    DKV_BLOCKS_PER_SM blocks an SM, else the whole group."""
    assert tfa.dkv_split(batch_kv, group, t, sms) == want
    tiles = -(-t // tfa.DKV_KEY_TILE) * batch_kv
    smaller = [s for s in range(1, want) if group % s == 0]
    assert all(tiles * s < tfa.DKV_BLOCKS_PER_SM * sms for s in smaller)


def test_flash_dkv_split_is_checked_and_leaves_the_plain_result_alone():
    """``split`` must divide the group; on the CPU it changes nothing
    (it only shapes the kernel's grid)."""
    rng = np.random.default_rng(3)
    q, do = (torch.from_numpy(rng.standard_normal((1, 24, 6, 16),
                                                  np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, 24, 2, 16), np.float32))
            for _ in range(2))
    out, lse = tfa.flash_fwd(q, k, v)
    delta = tfa.flash_delta(out, do)
    want = tfa.flash_dkv(q, k, v, do, lse, delta)
    for split in (1, 3):
        got = tfa.flash_dkv(q, k, v, do, lse, delta, split=split)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    for split in (0, 2, 4):
        with pytest.raises(ValueError, match="must divide"):
            tfa.flash_dkv(q, k, v, do, lse, delta, split=split)


def _fwd_tc_emulation(q, k, v, window, segments, block_keys=32):
    """The bf16 tensor-core forward's arithmetic in plain PyTorch: raw
    q·k scores in f32 from bf16 operands, an online softmax in base 2
    over 32-key tiles with masked pairs exactly 0, P rounded to bf16 as
    the operand of P·V while the row sum takes the f32 probabilities,
    and one rounding of the output to bf16."""
    b, t, h, hd = q.shape
    group = h // k.shape[2]
    kf = torch.repeat_interleave(k.float(), group, dim=2)
    vt = torch.repeat_interleave(v.float(), group, dim=2).transpose(1, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf)
    keep = tfa._keep(t, True, window, segments, q.device).expand(
        b, h, t, t)
    s2 = torch.where(keep, s * ((1.0 / hd**0.5) * 1.4426950408889634),
                     tfa.NEG_BIG)
    m = torch.full((b, h, t, 1), tfa.NEG_BIG)
    l = torch.zeros((b, h, t, 1))
    acc = torch.zeros((b, h, t, hd))
    for k0 in range(0, t, block_keys):
        tile = s2[..., k0:k0 + block_keys]
        m_next = torch.maximum(m, tile.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_next)
        p = torch.where(keep[..., k0:k0 + block_keys],
                        torch.exp2(tile - m_next), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.bfloat16().float() @ vt[:, :, k0:k0 + block_keys]
        m = m_next
    return (acc / l.clamp_min(1e-30)).transpose(1, 2).bfloat16()


@pytest.mark.parametrize("segmented", [False, True], ids=["nosegs", "segs"])
@pytest.mark.parametrize("t", [200, 1024])
def test_bf16_forward_rounding_fits_the_kernel_tolerances(t, segmented):
    """The bf16 forward rounds P to bf16 as the A operand of P·V (as
    the TPU's MXU rounds f32 operands at default precision).  Emulated
    on the CPU at the kernel tests' shapes (B=2, 12 q heads on 2 kv
    heads, hd 128, window 64), that arithmetic stays within the limits
    the card's tests hold the kernel to: one bf16 step (2**-7 + 1e-5 of
    the max) of the plain version, and the autograd test's 2**-8 + 1e-5
    of the max of the f32 reference formula."""
    rng = np.random.default_rng(t + segmented)
    q = _t(rng.standard_normal((2, t, 12, 128), np.float32)).bfloat16()
    k, v = (_t(rng.standard_normal((2, t, 2, 128), np.float32)).bfloat16()
            for _ in range(2))
    seg = None
    if segmented:
        seg = _t(np.cumsum(rng.random((2, t)) < 0.03, axis=1,
                           dtype=np.int32))
    got = _fwd_tc_emulation(q, k, v, 64, seg)
    plain, _ = tfa.flash_fwd_plain(q, k, v, True, 64, seg)
    ref = tfa.reference_attention(q.float(), k.float(), v.float(), True,
                                  seg, 64)

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    assert rel(got, plain) <= 2.0**-7 + 1e-5
    assert rel(got, ref) <= 2.0**-8 + 1e-5
