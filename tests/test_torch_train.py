"""Parity of the port's trainer with the JAX package's, on the CPU.

The centre is a three-step training run of one tiny f32 configuration
through both packages on the same weights and batches, once with the
logits path and once with fused unembed+CE (the usual configuration;
the reference's fused-CE Pallas kernels in interpret mode): the reference's
``make_train_step`` on a one-device mesh with the optax chain its
trainer builds (global-norm clip, adamw with the ``*_norm`` mask, a
warmup-cosine schedule), its Pallas RMSNorm and flash kernels in
interpret mode; the port's ``make_train_step`` over f32 masters with the
plain versions its kernel wrappers take for CPU tensors.  Around it:
the schedules, the clip, the data loader, the prefetcher, and the
``train_main`` entry point.

Tolerances: per-step losses are the same f32 computation in another
summation order, within 1e-5 (observed 2e-6).  After three AdamW steps
at lr 1e-2 the parameters may differ by more than the gradients do:
Adam divides by sqrt(v), so an element whose gradient is near zero
takes a step whose size depends on its last bits; 2e-5 (0.2 % of one
step) bounds that (observed 2.6e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from oim_tpu.cli import train_main as j_train_main
from oim_tpu.data import loader as j_loader
from oim_tpu.models import (
    TrainState as JTrainState,
    TransformerConfig as JConfig,
    init_params as j_init_params,
    make_train_step as j_make_train_step,
)
from oim_tpu.models.train import data_pspec, shard_state
from oim_tpu.parallel import build_mesh

from oim_tpu_torch.cli import train_main
from oim_tpu_torch.data import loader
from oim_tpu_torch.data.prefetch import device_prefetch
from oim_tpu_torch.models import train as ttrain
from oim_tpu_torch.models.transformer import TransformerConfig, init_params
from oim_tpu_torch.models.weights import from_jax_params
from oim_tpu_torch.ops import fused_ce

GEOMETRY = dict(vocab_size=101, d_model=64, n_layers=2, n_heads=4,
                n_kv_heads=2, d_ff=96, attn_bias=True, dtype="float32",
                use_pallas=True, fused_ce=False, doc_sep_id=0, grad_accum=2)
B, T, STEPS = 2, 256, 3
OPT = dict(lr=1e-2, warmup_steps=1, decay_steps=3, weight_decay=0.1,
           grad_clip=1.0)


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


def _flat(tree: dict, n_layers: int) -> dict:
    """Reference params (stacked [1, L, ...]) by the port's names."""
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


def _three_steps_match_jax(geometry: dict):
    jcfg = JConfig(**geometry)
    cfg = TransformerConfig(**geometry)
    args = train_main.build_parser().parse_args(
        ["--synthetic", "4000", "--steps", "3", "--vocab-size",
         str(geometry["vocab_size"])])
    corpus = train_main._load_corpus(args)
    np.testing.assert_array_equal(corpus, j_train_main._load_corpus(args))
    batches = loader.TokenBatches(corpus, B, T, seed=0)
    tokens = [batches.batch_at(s)[:, :T] for s in range(STEPS)]
    assert any((tok == 0).any() for tok in tokens)  # packed documents

    tree = j_init_params(jax.random.PRNGKey(0), jcfg)
    # Host copies first: the reference's step donates its state buffers.
    params = from_jax_params(jax.device_get(tree), cfg, master=True)
    mesh = build_mesh(devices=jax.devices()[:1])
    chain = _optax_chain(OPT)
    jstate = shard_state(JTrainState.create(tree, chain), jcfg, mesh)
    jstep = j_make_train_step(jcfg, mesh, chain)
    sharding = jax.sharding.NamedSharding(mesh, data_pspec())
    want = []
    for tok in tokens:
        jstate, metrics = jstep(jstate, jax.device_put(tok, sharding))
        want.append((float(metrics["loss"]), float(metrics["ce"])))

    state = ttrain.TrainState.create(params, ttrain.OptimizerConfig(**OPT))
    step = ttrain.make_train_step(cfg)
    got = []
    for tok in tokens:
        state, metrics = step(state, torch.from_numpy(tok).long())
        got.append((float(metrics["loss"]), float(metrics["ce"])))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert state.step == STEPS

    want_params = _flat(jax.device_get(jstate.params), cfg.n_layers)
    got_params = dict(ttrain.named_parameters(state.params))
    assert set(got_params) == set(want_params)
    for name, value in got_params.items():
        np.testing.assert_allclose(value.detach().numpy(), want_params[name],
                                   rtol=0, atol=2e-5, err_msg=name)


def test_three_train_steps_match_jax():
    _three_steps_match_jax(GEOMETRY)


def test_three_fused_ce_train_steps_match_jax():
    """The usual configuration, fused unembed+CE on: the reference's
    objective runs its three fused-CE Pallas kernels in interpret mode
    (vocab 256 and 256-token microbatches are tiles it takes, so it does
    not fall back to its logits path); the port's runs the kernels'
    plain versions.  Same tolerances as the unfused run: the fused
    numerics (f32 scores, dlogits rounded to the f32 compute dtype) are
    the same function in another summation order."""
    fused_ce.reset_counters()
    _three_steps_match_jax({**GEOMETRY, "vocab_size": 256, "fused_ce": True})
    counts = fused_ce.counters()
    # Two microbatches a step; the plain versions ran in the kernels' place,
    # the backward as the joint dx and dw of a full step.
    assert counts["fused_ce_fwd_plain"] == 2 * STEPS
    assert counts["fused_ce_bwd_plain"] == 2 * STEPS
    assert counts["fused_ce_dx_plain"] == counts["fused_ce_dw_plain"] == 0


@pytest.mark.parametrize("warmup,decay", [(0, 0), (3, 0), (0, 5), (2, 5)])
def test_schedules_match_optax(warmup, decay):
    opt = ttrain.OptimizerConfig(lr=0.3, warmup_steps=warmup,
                                 decay_steps=decay)
    if decay:
        want = optax.warmup_cosine_decay_schedule(
            0.0, 0.3, max(warmup, 1), warmup + decay)
    elif warmup:
        want = optax.linear_schedule(0.0, 0.3, warmup)
    else:
        def want(count):
            return 0.3
    for count in range(12):
        assert opt.learning_rate(count) == pytest.approx(
            float(want(count)), rel=1e-6, abs=1e-9)


@pytest.mark.parametrize("max_norm", [0.5, 50.0], ids=["clips", "passes"])
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.RandomState(0)
    grads = [rng.randn(5, 3).astype(np.float32),
             rng.randn(7).astype(np.float32)]
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    ttrain.clip_by_global_norm(got, max_norm)
    for a, w, g in zip(got, want, grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-6)
        if max_norm > 10:
            np.testing.assert_array_equal(a.numpy(), g)


def test_weight_decay_skips_norm_scales():
    cfg = TransformerConfig(**GEOMETRY)
    params = init_params(0, cfg, master=True)
    opt = ttrain.make_optimizer(params, ttrain.OptimizerConfig())
    decay, no_decay = opt.param_groups
    names = {id(v): n for n, v in ttrain.named_parameters(params)}
    assert {names[id(p)] for p in no_decay["params"]} == {
        "final_norm", "layers.0.attn_norm", "layers.0.mlp_norm",
        "layers.1.attn_norm", "layers.1.mlp_norm"}
    assert no_decay["weight_decay"] == 0.0
    assert decay["weight_decay"] == 1e-4
    assert opt.defaults["betas"] == (0.9, 0.999) and opt.defaults["eps"] == 1e-8


@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
def test_token_batches_match_jax(shard):
    corpus = np.arange(1000, dtype=np.int32) % 97
    spec = loader.ShardSpec(*shard)
    jspec = j_loader.ShardSpec(*shard)
    got = loader.TokenBatches(corpus, 4, 16, spec, seed=3)
    want = j_loader.TokenBatches(corpus, 4, 16, jspec, seed=3)
    assert got.steps_per_epoch == want.steps_per_epoch
    for step in (0, 1, got.steps_per_epoch, 2 * got.steps_per_epoch + 1):
        np.testing.assert_array_equal(got.batch_at(step),
                                      want.batch_at(step))
    assert loader.window_count(1000, 16) == j_loader.window_count(1000, 16)


def test_prefetch_yields_batches_in_order_and_surfaces_errors():
    batches = [np.full((2, 3), i, np.int32) for i in range(5)]
    got = list(device_prefetch(iter(batches), "cpu"))
    assert [int(b[0, 0]) for b in got] == list(range(5))
    assert all(isinstance(b, torch.Tensor) for b in got)

    def broken():
        yield batches[0]
        raise RuntimeError("source failed")

    it = device_prefetch(broken(), "cpu")
    assert int(next(it)[0, 0]) == 0
    with pytest.raises(RuntimeError, match="source failed"):
        next(it)


def test_fused_ce_is_refused_not_replaced():
    """``use_pallas`` with ``fused_ce`` takes the fused branch (its
    kernels' plain versions on the CPU), never the logits path, and
    gives the logits path's objective: the same f32 function, in f32
    compute, to summation order (1e-5)."""
    cfg = TransformerConfig(**{**GEOMETRY, "fused_ce": True})
    params = init_params(0, cfg, master=True)
    tokens = torch.from_numpy(
        np.random.RandomState(0).randint(0, 101, (2, 16))).long()
    fused_ce.reset_counters()
    obj, (ce_sum, count) = ttrain._local_objective(params, tokens, cfg)
    assert fused_ce.counters()["fused_ce_fwd_plain"] == 1
    unfused = TransformerConfig(**{**GEOMETRY, "fused_ce": False})
    want, (want_sum, want_count) = ttrain._local_objective(params, tokens,
                                                           unfused)
    assert fused_ce.counters()["fused_ce_fwd_plain"] == 1
    assert float(count) == float(want_count) == 2 * 15
    np.testing.assert_allclose(float(obj), float(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(ce_sum), float(want_sum), rtol=1e-6)


TINY_ARGS = ["--synthetic", "20000", "--steps", "3", "--batch-global", "2",
             "--seq", "32", "--vocab-size", "101", "--d-model", "64",
             "--n-layers", "2", "--n-heads", "4", "--n-kv-heads", "2",
             "--d-ff", "96", "--attn-bias", "--dtype", "float32",
             "--log-every", "1", "--eval-every", "3", "--lr", "1e-2"]


@pytest.mark.parametrize("source", ["synthetic", "corpus"])
def test_train_main_cpu_drive(source, tmp_path, capsys):
    args = TINY_ARGS + ["--device", "cpu"]
    if source == "corpus":
        path = tmp_path / "corpus.npy"
        np.save(path, np.arange(20000, dtype=np.int32) % 101)
        args = ["--corpus", str(path)] + args[2:]
    assert train_main.main(args) == 0
    err = capsys.readouterr().err
    assert "fused_ce=True" in err
    assert err.count("oim-train step ") == 3
    assert "oim-train eval step=3" in err
    assert err.strip().endswith("oim-train done steps=3")


@pytest.mark.parametrize("flag,item", [
    (["--pp", "2"], "parallelism"),
    (["--dp", "2"], "parallelism"),
    (["--zero1"], "sharding.py"),
    # LoRA and checkpoints are ported: what is refused now is a flag
    # without the one it needs (the ids are the cases' earlier names).
    pytest.param(["--lora-rank", "4"], "requires --lora-base",
                 id="flag3-lora.py"),
    pytest.param(["--export-dir", "x"], "requires --checkpoint-dir",
                 id="flag4-checkpoint/manager.py"),
    # MoE trains now: what stays refused is expert parallelism.
    pytest.param(["--n-experts", "4", "--ep", "2"], "Queue A12: parallelism",
                 id="flag5-_switch_moe"),
    (["--lora-base", "x"], "requires --lora-rank"),
])
def test_train_main_refuses_unported_flags(flag, item):
    with pytest.raises(ValueError, match=item):
        train_main.main(TINY_ARGS + ["--device", "cpu"] + flag)
