"""The port's fused unembed+CE against the JAX package's, on the CPU.

The JAX ``fused_linear_ce`` runs its three Pallas kernels in interpret
mode (as ``tests/test_ops.py::TestFusedLinearCE`` runs them), with
explicit ``(8, 128)`` blocks so that several row and vocab tiles run;
the port's ``fused_linear_ce`` takes the plain versions of its Hopper
kernels for CPU tensors.  Inputs come from one numpy seed.

Tolerances.  The NLL is the same f32 function of the same
compute-dtype products (exact in f32) summed in another order over D
and V: 1e-5 absolute.  dx and dw: both sides round the dlogits to the
compute dtype before either product, so they differ where a recomputed
probability's last f32 bits round a dlogit the other way, and in f32
summation order.  dx comes back in the compute dtype, so in bf16 one
rounding step of its largest value (2**-7 of max |dx|) bounds it
(observed: one step), and 1e-5 of the max in f32.  dw sums the rows'
products in f32: 1e-4 of max |dw| covers a few flipped dlogits
(observed 3e-6).  Both sit well inside the reference's own 2e-3 against
its f32-dlogits oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oim_tpu.ops import fused_ce as jfc

from oim_tpu_torch.ops import fused_ce as fc
from torch_cpu_threads import one_torch_thread  # noqa: F401

NLL_ATOL = 1e-5
DX_REL = {"bf16": 2.0**-7, "f32": 1e-5}
DW_REL = 1e-4
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "f32": (jnp.float32, torch.float32)}


def _data(n, d, v, dtype, seed=0, w_scale=0.05):
    """x [n, d] rounded to ``dtype``, f32 w [d, v], int labels [n] and a
    per-row cotangent g [n] with zeros (masked rows), as numpy."""
    rng = np.random.RandomState(seed)
    x = np.asarray(jnp.asarray(rng.standard_normal((n, d)), dtype)
                   .astype(jnp.float32))
    w = (rng.standard_normal((d, v)) * w_scale).astype(np.float32)
    labels = rng.randint(0, v, n).astype(np.int32)
    g = rng.uniform(0.0, 2.0, n).astype(np.float32)
    g[::5] = 0.0
    return x, w, labels, g


def _jax(x, w, labels, g, dtype, blocks):
    """(nll, dx, dw) of the reference's fused kernels."""
    xj = jnp.asarray(x, dtype)
    nll, vjp = jax.vjp(
        lambda a, b: jfc.fused_linear_ce(a, b, jnp.asarray(labels), *blocks),
        xj, jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(g))
    return (np.asarray(nll), np.asarray(dx.astype(jnp.float32)),
            np.asarray(dw))


def _close(got, want, rel, what):
    """max |got - want| within ``rel`` of max |want|."""
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (what, err)


def _port(x, w, labels, g, dtype):
    """(nll, dx, dw) of the port's ``fused_linear_ce``, with dx in the
    compute dtype and dw f32 as the autograd Function returns them."""
    xt = torch.tensor(x).to(dtype).requires_grad_()
    wt = torch.tensor(w).requires_grad_()
    nll = fc.fused_linear_ce(xt, wt, torch.tensor(labels).long())
    nll.backward(torch.tensor(g))
    assert nll.dtype == torch.float32
    assert xt.grad.dtype == dtype and wt.grad.dtype == torch.float32
    return (nll.detach().numpy(), xt.grad.float().numpy(),
            wt.grad.numpy())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,v", [(64, 384), (32, 128), (256, 640)])
def test_fused_linear_ce_matches_jax_kernels(n, v, dtype):
    jdt, tdt = DTYPES[dtype]
    x, w, labels, g = _data(n, 128, v, jdt)
    want = _jax(x, w, labels, g, jdt, (8, 128))
    fc.reset_counters()
    got = _port(x, w, labels, g, tdt)
    assert fc.counters() == {
        "fused_ce_fwd": 0, "fused_ce_dx": 0, "fused_ce_dw": 0,
        "fused_ce_bwd": 0, "fused_ce_fwd_plain": 1, "fused_ce_dx_plain": 0,
        "fused_ce_dw_plain": 0, "fused_ce_bwd_plain": 1,
        "fused_ce_wgmma": 0, "fused_ce_mma_sync": 0}
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=NLL_ATOL)
    _close(got[1], want[1], DX_REL[dtype], "dx")
    _close(got[2], want[2], DW_REL, "dw")
    # Masked rows (g = 0) give no gradient.
    assert not got[1][::5].any()


def test_labels_on_tile_edges():
    """Labels at vocab-tile edges (0, 127, 128, 255, 256, 383) hit the
    target exactly once each."""
    x, w, _, g = _data(8, 128, 384, jnp.bfloat16)
    labels = np.asarray([0, 127, 128, 255, 256, 383, 1, 382], np.int32)
    want = _jax(x, w, labels, g, jnp.bfloat16, (8, 128))
    got = _port(x, w, labels, g, torch.bfloat16)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=NLL_ATOL)
    _close(got[1], want[1], DX_REL["bf16"], "dx")
    _close(got[2], want[2], DW_REL, "dw")


def test_extreme_logits_stay_finite():
    """Logits in the hundreds: the max-shifted sums stay finite.  The
    reference's own bound at this scale is rtol 1e-4 / atol 1e-3 (f32
    sums of scores in the hundreds)."""
    x, w, labels, g = _data(16, 128, 256, jnp.bfloat16, w_scale=20.0)
    want = _jax(x, w, labels, g, jnp.bfloat16, (16, 128))
    lse, target = fc.fused_ce_fwd(torch.tensor(x).to(torch.bfloat16),
                                  torch.tensor(w).to(torch.bfloat16),
                                  torch.tensor(labels))
    nll = (lse - target).numpy()
    assert np.isfinite(nll).all() and np.abs(target.numpy()).max() > 100
    np.testing.assert_allclose(nll, want[0], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ragged_shapes_match_the_reference_formula(dtype):
    """N = 33 and V = 100 have no tiles the reference takes: it falls back
    to ``reference_linear_ce``, which the port's plain versions match.
    In f32 the tolerances are the module's.  In bf16 the fallback
    differentiates through the cast of w, so its dw comes back rounded
    to bf16 like dx: one bf16 step of the largest value for both."""
    jdt, tdt = DTYPES[dtype]
    x, w, labels, g = _data(33, 64, 100, jdt)
    want = _jax(x, w, labels, g, jdt, (0, 0))
    got = _port(x, w, labels, g, tdt)
    ref = fc.reference_linear_ce(torch.tensor(x).to(tdt), torch.tensor(w),
                                 torch.tensor(labels))
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=NLL_ATOL)
    np.testing.assert_allclose(ref.numpy(), want[0], rtol=0, atol=NLL_ATOL)
    _close(got[1], want[1], DX_REL[dtype], "dx")
    _close(got[2], want[2], DW_REL if dtype == "f32" else DX_REL["bf16"],
           "dw")


def test_frozen_w_skips_the_dw_kernel():
    """A LoRA step freezes the unembedding: the backward launches dx and
    never dw, alone or in the joint backward."""
    x, w, labels, g = _data(16, 32, 128, jnp.bfloat16)
    xt = torch.tensor(x).to(torch.bfloat16).requires_grad_()
    fc.reset_counters()
    nll = fc.fused_linear_ce(xt, torch.tensor(w), torch.tensor(labels))
    nll.backward(torch.tensor(g))
    counts = fc.counters()
    assert counts["fused_ce_dx_plain"] == 1 and counts["fused_ce_dw_plain"] == 0
    assert counts["fused_ce_bwd_plain"] == 0
    assert xt.grad is not None


def test_wrappers_refuse_mismatched_operands():
    x = torch.zeros(4, 8)
    w = torch.zeros(8, 16)
    labels = torch.zeros(4, dtype=torch.long)
    with pytest.raises(ValueError, match="x's"):
        fc.fused_ce_fwd(x, w.to(torch.bfloat16), labels)
    with pytest.raises(ValueError, match=r"\[N, D\] and \[D, V\]"):
        fc.fused_ce_fwd(x, w.T.contiguous(), labels)
    with pytest.raises(ValueError, match="labels"):
        fc.fused_ce_fwd(x, w, labels[:3])
    with pytest.raises(ValueError, match="g "):
        fc.fused_ce_dx(x, w, labels, torch.zeros(4), torch.zeros(5))


def test_chunk_columns_cover_any_vocabulary():
    assert fc.chunk_columns(4096, 151936) == 32768
    assert fc.chunk_columns(64, 100) == 128
    assert fc.chunk_columns(10**7, 151936) == 128
    assert fc.chunk_columns(4096, 151936, "mma_sync") == 8192
    for n, v in ((4096, 151936), (1000, 100), (3, 129)):
        c = fc.chunk_columns(n, v)
        assert c % fc.TILE_V == 0 and c * n <= max(
            fc.SCRATCH_ELEMENTS, fc.TILE_V * n)
        c = fc.chunk_columns(n, v, "mma_sync")
        assert c % fc.TILE_V == 0 and c * n <= max(
            fc.MMA_SYNC_SCRATCH_ELEMENTS, fc.TILE_V * n)


def _torch_operands(x, w, labels, g, dtype):
    """The kernels' operands: x and w in ``dtype``, int32 labels, f32 g,
    and the plain forward's lse."""
    xt = torch.tensor(x).to(dtype)
    wt = torch.tensor(w).to(dtype)
    lt = torch.tensor(labels)
    lse, _ = fc.fused_ce_fwd_plain(xt, wt, lt)
    return xt, wt, lt, lse, torch.tensor(g)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,v", [(64, 384), (33, 100)])
def test_joint_backward_plain_equals_the_separate_gradients(n, v, dtype):
    """One dlogits pass for both gradients gives exactly what dx and dw
    give apart (the same dlogits, the same products), and counts a call
    of its own alone."""
    jdt, tdt = DTYPES[dtype]
    ops = _torch_operands(*_data(n, 64, v, jdt), tdt)
    fc.reset_counters()
    dx, dw = fc.fused_ce_bwd(*ops)
    assert fc.counters()["fused_ce_dx_plain"] == 0
    assert torch.equal(dx, fc.fused_ce_dx_plain(*ops))
    assert torch.equal(dw, fc.fused_ce_dw_plain(*ops))
    assert dx.dtype == tdt and dw.dtype == torch.float32
    counts = fc.counters()
    assert counts["fused_ce_bwd_plain"] == 1
    assert counts["fused_ce_dx_plain"] == counts["fused_ce_dw_plain"] == 1
    assert counts["fused_ce_bwd"] == 0  # CPU tensors launch nothing


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,v", [(64, 384), (256, 640)])
def test_joint_backward_plain_matches_jax_kernels(n, v, dtype):
    """The joint backward against the reference's dx and dw Pallas
    kernels in interpret mode, with the same limits as the autograd
    path."""
    jdt, tdt = DTYPES[dtype]
    x, w, labels, g = _data(n, 128, v, jdt, seed=3)
    xj, wj = jnp.asarray(x, jdt), jnp.asarray(w)
    lj = jnp.asarray(labels)
    _, vjp = jax.vjp(lambda a, b: jfc.fused_linear_ce(a, b, lj, 8, 128),
                     xj, wj)
    want_dx, want_dw = vjp(jnp.asarray(g))
    dx, dw = fc.fused_ce_bwd(*_torch_operands(x, w, labels, g, tdt))
    _close(dx.float().numpy(), np.asarray(want_dx.astype(jnp.float32)),
           DX_REL[dtype], "dx")
    _close(dw.numpy(), np.asarray(want_dw), DW_REL, "dw")


def test_full_step_runs_the_joint_backward():
    """A step that trains w and x takes the joint backward; one that
    trains w alone runs dw only."""
    x, w, labels, g = _data(16, 32, 128, jnp.bfloat16)
    fc.reset_counters()
    xt = torch.tensor(x).to(torch.bfloat16).requires_grad_()
    wt = torch.tensor(w).requires_grad_()
    fc.fused_linear_ce(xt, wt, torch.tensor(labels)).backward(
        torch.tensor(g))
    assert fc.counters()["fused_ce_bwd_plain"] == 1
    fc.reset_counters()
    wt = torch.tensor(w).requires_grad_()
    fc.fused_linear_ce(torch.tensor(x).to(torch.bfloat16), wt,
                       torch.tensor(labels)).backward(torch.tensor(g))
    counts = fc.counters()
    assert counts["fused_ce_bwd_plain"] == counts["fused_ce_dx_plain"] == 0
    assert counts["fused_ce_dw_plain"] == 1 and wt.grad is not None


def test_route_follows_the_shape():
    """bf16 rows of whole 16-byte chunks take the wgmma route; f32, odd
    widths and unaligned bases the mma.sync route."""
    x = torch.zeros((4, 64), dtype=torch.bfloat16)
    w = torch.zeros((64, 384), dtype=torch.bfloat16)
    assert fc.route(x, w) == "wgmma"
    assert fc.route(x.float(), w.float()) == "mma_sync"
    assert fc.route(x, w[:, :100]) == "mma_sync"
    assert fc.route(x[:, :60], w[:60]) == "mma_sync"
    shifted = torch.zeros(4 * 64 + 4, dtype=torch.bfloat16)[4:].view(4, 64)
    assert shifted.data_ptr() % 16 == 8
    assert fc.route(shifted, w) == "mma_sync"
