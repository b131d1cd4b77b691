"""MoE training in the port, on the CPU, against the JAX package.

Tiny f32 MoE models (drawn by the JAX package and handed over with
``from_jax_params``), numpy-seeded inputs.  Held against ``oim_tpu``:

- ``_capacity_dispatch`` bit-equal, dispatch and combine, including
  drops where an expert's queue overflows (the reference's hand-computed
  case from ``tests/test_model.py`` and random routings);
- ``_switch_moe``'s output and aux, with and without the router z-loss,
  within 1e-5 (f32 both sides: summation order only);
- the first training step: loss, ce and aux within 1e-5 and every
  gradient within 1e-4 of its largest entry, against the reference's
  value-and-grad on a one-device mesh (the port on its default path,
  fused CE and the kernels' plain versions, and on the logits path);
- three steps of the reference trainer's optimizer, at grad
  accumulation 1 and 2 (the aux's reduction over microbatches): losses
  within 1e-5, parameters within 2e-5 (``tests/test_torch_train.py``
  sets out why Adam needs the wider bound);
- ``train_main --n-experts``: logs aux, resumes bit-equal from an MoE
  checkpoint, exports, and ``serve_main --params-dir`` serves the export.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from oim_tpu.models import TrainState as JTrainState
from oim_tpu.models import TransformerConfig as JConfig
from oim_tpu.models import init_params as j_init_params
from oim_tpu.models import make_train_step as j_make_train_step
from oim_tpu.models import train as jtrain
from oim_tpu.models import transformer as jtransformer
from oim_tpu.models.transformer import forward_local as j_forward_local
from oim_tpu.models.transformer import manual_pspecs
from oim_tpu.models.train import data_pspec, shard_state
from oim_tpu.parallel import build_mesh

from oim_tpu_torch.checkpoint import load_params
from oim_tpu_torch.cli import serve_main, train_main
from oim_tpu_torch.models import decode as tdecode
from oim_tpu_torch.models import train as ttrain
from oim_tpu_torch.models import transformer as ttransformer
from oim_tpu_torch.models.transformer import TransformerConfig
from oim_tpu_torch.models.weights import from_jax_params, recast
from oim_tpu_torch.serve.engine import GenRequest
from torch_cpu_threads import one_torch_thread  # noqa: F401

BASE = dict(vocab_size=101, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=96, dtype="float32", n_experts=4, moe_top_k=2,
            router_z_loss=1e-3, expert_capacity_factor=1.0)
OPT = dict(lr=1e-2, warmup_steps=1, decay_steps=3, weight_decay=0.1,
           grad_clip=1.0)
B, T = 4, 32
# f32 both sides, the same formulas in another summation order.
VALUE_ATOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_ATOL = 2e-5
GEOMETRY = ["--vocab-size", "101", "--d-model", "32", "--n-layers", "2",
            "--n-heads", "4", "--n-kv-heads", "2", "--d-ff", "48",
            "--n-experts", "4", "--moe-top-k", "2", "--dtype", "float32"]
ARGS = ["--device", "cpu", "--synthetic", "20000", "--batch-global", "4",
        "--seq", "32", "--lr", "1e-2", "--log-every", "1",
        "--router-z-loss", "1e-3"] + GEOMETRY


def _tokens(seed: int, b: int = B, t: int = T) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 101, (b, t))


def _flat(tree: dict, n_layers: int) -> dict:
    """Reference params or grads (stacked [1, L, ...]) by the port's
    names."""
    out = {}
    for name, value in tree.items():
        value = np.asarray(value)
        if name in ("wte", "final_norm", "wlm"):
            out[name] = value
        else:
            value = value.reshape(n_layers, *value.shape[2:])
            for i in range(n_layers):
                out[f"layers.{i}.{name}"] = value[i]
    return out


def test_capacity_dispatch_hand_case():
    """The reference's hand-computed top-2 case (capacity 2, 4 tokens):
    first choices keep their slots, second choices fill what is left,
    token 3 and token 1's second choice drop."""
    idx = np.asarray([[0, 1], [0, 1], [1, 0], [0, 1]])
    gates = np.full((4, 2), 0.5, np.float32)
    got = ttransformer._capacity_dispatch(
        torch.from_numpy(idx), torch.from_numpy(gates), 2, 2)
    want = jtransformer._capacity_dispatch(jnp.asarray(idx),
                                           jnp.asarray(gates), e=2,
                                           capacity=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    d = got[0].numpy()
    assert d[0, 0, 0] == d[1, 0, 1] == d[2, 1, 0] == d[0, 1, 1] == 1
    assert d[3].sum() == d[1, 1].sum() == d[2, 0].sum() == 0
    assert d.sum() == 4


@pytest.mark.parametrize("e,k,capacity", [(4, 1, 3), (4, 2, 5), (8, 2, 2),
                                          (4, 3, 40)])
def test_capacity_dispatch_matches_reference(e, k, capacity):
    """Random routings of 40 tokens, most overflowing their experts'
    queues (the last case fits): bit-equal dispatch and combine."""
    rng = np.random.RandomState(e * 10 + k)
    probs = jax.nn.softmax(jnp.asarray(rng.randn(40, e), jnp.float32), -1)
    _, idx, gates = jtransformer._router_gates(probs, k)
    want = jtransformer._capacity_dispatch(idx, gates, e=e,
                                           capacity=capacity)
    got = ttransformer._capacity_dispatch(
        torch.tensor(np.array(idx)), torch.tensor(np.array(gates)), e,
        capacity)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    kept = got[0].numpy().sum()
    assert kept == 40 * k if capacity == 40 else kept < 40 * k


@pytest.mark.parametrize("z", [0.0, 1e-3], ids=["aux", "aux+z"])
@pytest.mark.parametrize("e,k", [(2, 1), (4, 2)], ids=["e2k1", "e4k2"])
def test_switch_moe_matches_reference(e, k, z):
    kw = {**BASE, "n_experts": e, "moe_top_k": k, "router_z_loss": z}
    jcfg = JConfig(**kw, use_pallas=False)
    tcfg = TransformerConfig(**kw, use_pallas=False)
    tree = jax.device_get(j_init_params(jax.random.PRNGKey(e), jcfg))
    params = from_jax_params(tree, tcfg, master=True)
    lp = {name: jnp.asarray(np.asarray(value)[0, 1]) for name, value in
          tree.items() if name not in ("wte", "wlm", "final_norm")}
    x = np.random.RandomState(k).randn(3, 11, 64).astype(np.float32)
    want, want_aux = jtransformer._switch_moe(jnp.asarray(x), lp, jcfg)
    got, aux = ttransformer._switch_moe(torch.from_numpy(x),
                                        params["layers"][1], tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=VALUE_ATOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=0,
                               atol=VALUE_ATOL)
    assert float(aux) > 0


def _reference_first_step(jcfg, tree, tokens):
    """(loss, ce, aux, grads by port name) of the reference's first step
    on a one-device mesh: its value-and-grad (the train step's), and the
    aux of ``forward_local`` under the same shard_map."""
    mesh = build_mesh(devices=jax.devices()[:1])
    loss, ce, grads = jax.jit(jtrain._build_value_and_grad(jcfg, mesh))(
        tree, tokens)
    aux_fn = jax.jit(jax.shard_map(
        lambda p, t: j_forward_local(p, t, jcfg)[1], mesh=mesh,
        in_specs=(manual_pspecs(jcfg), data_pspec()), out_specs=P(),
        axis_names={"dp", "sp", "pp", "tp", "ep"}, check_vma=False))
    aux = aux_fn(tree, tokens)
    return (float(loss), float(ce), float(aux),
            _flat(jax.device_get(grads), jcfg.n_layers))


@pytest.mark.parametrize("fused", [True, False], ids=["fused_ce", "logits"])
def test_first_step_matches_reference(fused):
    """Loss, ce, aux and gradients of the first step, router and experts
    included, with capacity drops (factor 1.0) and the z-loss on."""
    jcfg = JConfig(**BASE, use_pallas=False, fused_ce=False)
    tcfg = TransformerConfig(**BASE, use_pallas=fused, fused_ce=fused)
    tree = jax.device_get(j_init_params(jax.random.PRNGKey(1), jcfg))
    tokens = _tokens(3)
    loss, ce, aux, grads = _reference_first_step(jcfg, tree,
                                                 jnp.asarray(tokens))
    params = from_jax_params(tree, tcfg, master=True)
    leaves = dict(ttrain.named_parameters(params))
    for value in leaves.values():
        value.requires_grad_(True)
    obj, ce_sum, ce_count, got_aux = ttrain._objective_terms(
        params, torch.from_numpy(tokens).long(), tcfg)
    got_grads = torch.autograd.grad(obj, list(leaves.values()))
    np.testing.assert_allclose(
        [float(obj.detach()), float(ce_sum / ce_count),
         float(got_aux.detach())],
        [loss, ce, aux], rtol=0, atol=VALUE_ATOL)
    assert aux > 1.0  # load balance ≥ 1 at any routing, plus the z term
    assert set(leaves) == set(grads)
    for name, g in zip(leaves, got_grads):
        want = grads[name]
        np.testing.assert_allclose(
            g.numpy(), want, rtol=0,
            atol=GRAD_RTOL * max(np.abs(want).max(), 1e-30), err_msg=name)
    assert np.abs(grads["layers.0.router"]).max() > 0


def _optax_chain(opt: dict):
    """The reference trainer's optimizer (oim_tpu/cli/train_main.py)."""
    lr = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=opt["lr"],
        warmup_steps=max(opt["warmup_steps"], 1),
        decay_steps=opt["warmup_steps"] + opt["decay_steps"])
    adamw = optax.adamw(
        lr, weight_decay=opt["weight_decay"],
        mask=lambda params: {n: not n.endswith("_norm") for n in params})
    return optax.chain(optax.clip_by_global_norm(opt["grad_clip"]), adamw)


@pytest.mark.parametrize("accum", [1, 2], ids=["accum1", "accum2"])
def test_three_steps_match_reference(accum):
    """Three optimizer steps: the per-step loss (aux term included) and
    the parameters after them, at grad accumulation 1 and 2."""
    kw = {**BASE, "grad_accum": accum, "use_pallas": False,
          "fused_ce": False}
    jcfg, tcfg = JConfig(**kw), TransformerConfig(**kw)
    tree = j_init_params(jax.random.PRNGKey(2), jcfg)
    params = from_jax_params(jax.device_get(tree), tcfg, master=True)
    batches = [_tokens(10 + s) for s in range(3)]
    mesh = build_mesh(devices=jax.devices()[:1])
    chain = _optax_chain(OPT)
    jstate = shard_state(JTrainState.create(tree, chain), jcfg, mesh)
    jstep = j_make_train_step(jcfg, mesh, chain)
    want = []
    for tok in batches:
        jstate, metrics = jstep(jstate, jnp.asarray(tok))
        want.append((float(metrics["loss"]), float(metrics["ce"])))
    state = ttrain.TrainState.create(params, ttrain.OptimizerConfig(**OPT))
    step = ttrain.make_train_step(tcfg)
    got, auxes = [], []
    for tok in batches:
        state, metrics = step(state, torch.from_numpy(tok).long())
        got.append((float(metrics["loss"]), float(metrics["ce"])))
        auxes.append(float(metrics["aux"]))
    np.testing.assert_allclose(got, want, rtol=0, atol=VALUE_ATOL)
    # loss = ce + AUX_LOSS_WEIGHT · aux (no packing: count = b·(t-1)).
    np.testing.assert_allclose(
        [g[0] - g[1] for g in got],
        [ttransformer.AUX_LOSS_WEIGHT * a for a in auxes], rtol=0,
        atol=1e-6)
    want_params = _flat(jax.device_get(jstate.params), tcfg.n_layers)
    for name, value in ttrain.named_parameters(state.params):
        np.testing.assert_allclose(value.detach().numpy(), want_params[name],
                                   rtol=0, atol=PARAM_ATOL, err_msg=name)


def _train(*flags):
    return train_main.train(train_main.build_parser().parse_args(
        ARGS + list(flags)))


def test_train_main_moe_logs_aux(capsys):
    result = _train("--steps", "3", "--moe-top-k", "1")
    err = capsys.readouterr().err
    steps = [line for line in err.splitlines() if "oim-train step" in line]
    assert len(steps) == 3 and all(" aux=" in line for line in steps)
    assert all(np.isfinite(result["losses"])) and min(result["aux"]) > 0
    cfg = train_main.make_config(train_main.build_parser().parse_args(
        ARGS + ["--steps", "1"]))
    assert (cfg.n_experts, cfg.moe_top_k, cfg.router_z_loss) == (4, 2, 1e-3)


def test_moe_checkpoint_resume_export_and_serve(tmp_path, capsys):
    """An MoE run interrupted at step 2 and resumed to 4 is the
    uninterrupted run bit for bit; its export serves through
    ``serve_main --params-dir`` as ``generate`` on the exported
    weights."""
    full = _train("--steps", "4")
    ckpt, export = str(tmp_path / "ckpt"), str(tmp_path / "export")
    first = _train("--steps", "2", "--checkpoint-dir", ckpt,
                   "--save-every", "2")
    resumed = _train("--steps", "4", "--checkpoint-dir", ckpt,
                     "--save-every", "2", "--export-dir", export)
    assert "oim-train resumed step=2" in capsys.readouterr().err
    assert first["losses"] + resumed["losses"] == full["losses"]
    assert first["aux"] + resumed["aux"] == full["aux"]
    for (name, x), (_, y) in zip(
            ttrain.named_parameters(full["state"].params),
            ttrain.named_parameters(resumed["state"].params)):
        assert torch.equal(x, y), name
    args = serve_main.build_parser().parse_args(
        GEOMETRY + ["--device", "cpu", "--max-len", "64", "--n-slots", "2",
                    "--chunk", "4", "--params-dir", export])
    engine = serve_main.make_engine(args)
    cfg = engine.cfg
    assert (cfg.n_experts, cfg.moe_top_k) == (4, 2)
    exported = load_params(export)
    served, _ = recast(exported, cfg, cfg.dtype)
    for (name, x), (_, y) in zip(ttrain.named_parameters(engine.params),
                                 ttrain.named_parameters(served)):
        assert torch.equal(x, y), name
    prompt = [5, 17, 3, 99, 42]
    rid = engine.submit(GenRequest(tokens=prompt, max_new_tokens=6))
    want = tdecode.generate(served, torch.tensor([prompt]), cfg, 6)
    assert engine.run()[rid] == want[0, 5:].tolist()
