"""The port's training step as one CUDA graph (``models/train.py``):
what holds it on the CPU, and the graph route itself on the card.

On the CPU:

- ``make_train_loop`` against the reference's ``make_train_loop`` (n
  steps in one ``lax.scan`` dispatch) on the same weights and batches,
  with the reference trainer's optax chain: per-step loss and ce within
  1e-5, parameters within 2e-5 (``tests/test_torch_train.py``'s
  tolerances and reasons); on the CPU the loop is n eager steps, equal
  to stepping one by one;
- remat without the saved RNG state (what a capture needs) gives the
  gradients of remat with it, bit for bit: the layer draws no random
  numbers;
- a checkpoint written by the per-tensor AdamW that every checkpoint
  before the graphed step was written by (a float rate, step counts on
  the host) restores into the fused update with its moments and counts,
  keeps the fused update's settings, and continues as the per-tensor
  update would;
- ``ops/counts.py``: a captured region's counts over all four kernel
  modules are taken back and re-added per replay exactly, and a plain
  call inside a region raises, in each module.

Marked ``cuda`` (they skip without a GPU; JAX is imported only inside
the CPU tests, so on the GPU machine ``python -m pytest --noconftest
tests/test_torch_train_graph.py -q -m cuda`` runs them): graphed and
eager steps bit-equal over three distinct batches (dense, MoE, LoRA);
a replay reads the new batch; exactly one capture per step function,
another shape or state refused; the metrics a step returned survive
the next replay; launch counts over replays by the smoke's formulas.
"""

import numpy as np
import pytest
import torch

from oim_tpu_torch.checkpoint import Checkpointer
from oim_tpu_torch.models import lora as tlora
from oim_tpu_torch.models import train as ttrain
from oim_tpu_torch.models import transformer
from oim_tpu_torch.models.transformer import TransformerConfig, init_params
from oim_tpu_torch.ops import counts as kernel_counts
from oim_tpu_torch.ops import flash_attention as tfa
from oim_tpu_torch.ops import fused_ce as tce
from oim_tpu_torch.ops import paged_attention as tpa
from oim_tpu_torch.ops import rmsnorm as trn
from torch_cpu_threads import one_torch_thread  # noqa: F401

# f32 and the plain formulas on both sides: the loop is what is tested.
LOOP_GEOMETRY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                     n_kv_heads=2, d_ff=64, dtype="float32",
                     use_pallas=False, fused_ce=False, grad_accum=2)
OPT = dict(lr=1e-2, warmup_steps=1, decay_steps=3, weight_decay=0.1,
           grad_clip=1.0)
N, B, T = 4, 4, 16


def _batches(n, b, t, vocab, seed=0) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, vocab, (n, b, t))


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


def _stacked(params: dict) -> dict:
    """The port's masters as a reference params tree (layers stacked
    [1, L, ...]; the inverse of ``_flat``)."""
    tree = {name: params[name].detach().numpy()
            for name in ("wte", "final_norm", "wlm")}
    for leaf in params["layers"][0]:
        tree[leaf] = np.stack([lp[leaf].detach().numpy()
                               for lp in params["layers"]])[None]
    return tree


def test_train_loop_matches_reference_loop():
    """The reference's ``test_scanned_loop_matches_stepwise``, across
    packages: one ``lax.scan`` dispatch of N steps against the port's
    loop on the same batches, and the port's loop against its own N
    separate steps (equal on the CPU: the same eager steps)."""
    import jax
    import optax

    from oim_tpu.models import TrainState as JTrainState
    from oim_tpu.models import TransformerConfig as JConfig
    from oim_tpu.models import make_train_loop as j_make_train_loop
    from oim_tpu.models.train import data_pspec, shard_state
    from oim_tpu.parallel import build_mesh

    jcfg = JConfig(**LOOP_GEOMETRY)
    cfg = TransformerConfig(**LOOP_GEOMETRY)
    batches = _batches(N, B, T, cfg.vocab_size)

    def port_state():
        return ttrain.TrainState.create(init_params(0, cfg, master=True),
                                        ttrain.OptimizerConfig(**OPT))

    tree = _stacked(port_state().params)
    lr = optax.warmup_cosine_decay_schedule(
        0.0, OPT["lr"], OPT["warmup_steps"],
        OPT["warmup_steps"] + OPT["decay_steps"])
    chain = optax.chain(
        optax.clip_by_global_norm(OPT["grad_clip"]),
        optax.adamw(lr, weight_decay=OPT["weight_decay"],
                    mask=lambda p: {n: not n.endswith("_norm") for n in p}))
    mesh = build_mesh(devices=jax.devices()[:1])
    jstate = shard_state(JTrainState.create(tree, chain), jcfg, mesh)
    tokens = jax.device_put(batches, jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(None, *data_pspec())))
    jstate, want = j_make_train_loop(jcfg, mesh, chain)(jstate, tokens)
    assert int(jstate.step) == N

    loop = ttrain.make_train_loop(cfg)
    state, got = loop(port_state(), torch.from_numpy(batches).long())
    assert state.step == N
    assert {name: tuple(v.shape) for name, v in got.items()} == {
        "loss": (N,), "ce": (N,), "aux": (N,)}
    for name in ("loss", "ce"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=0, atol=1e-5, err_msg=name)
    assert not got["aux"].any()
    want_params = _flat(jax.device_get(jstate.params), cfg.n_layers)
    for name, value in ttrain.named_parameters(state.params):
        np.testing.assert_allclose(value.detach().numpy(), want_params[name],
                                   rtol=0, atol=2e-5, err_msg=name)
    # The CPU runs every step eagerly: no graph, the separate steps' bits.
    assert loop.stats()["graphed"] is False
    assert loop.stats()["captures"] == loop.stats()["replays"] == 0
    stepped, step = port_state(), ttrain.make_train_step(cfg)
    losses = [float(step(stepped, torch.from_numpy(b).long())[1]["loss"])
              for b in batches]
    assert losses == got["loss"].tolist()
    for (name, a), (_, b) in zip(ttrain.named_parameters(state.params),
                                 ttrain.named_parameters(stepped.params)):
        assert torch.equal(a, b), name


def test_remat_without_rng_state_gives_the_same_gradients(monkeypatch):
    """Every layer's remat runs with ``preserve_rng_state=False`` (a
    capture cannot read the CUDA RNG state); the layer draws no random
    numbers, so saving the state changes no gradient bit."""
    cfg = TransformerConfig(**{**LOOP_GEOMETRY, "use_pallas": True,
                               "fused_ce": True, "grad_accum": 1})
    assert cfg.remat
    params = init_params(0, cfg, master=True)
    leaves = [v.requires_grad_(True)
              for _, v in ttrain.named_parameters(params)]
    tokens = torch.from_numpy(_batches(1, B, T, cfg.vocab_size)[0]).long()

    def grads():
        obj, _ = ttrain._local_objective(params, tokens, cfg)
        return torch.autograd.grad(obj, leaves)

    real, seen = transformer.checkpoint, []

    def saving(*args, **kwargs):
        seen.append(kwargs["preserve_rng_state"])
        return real(*args, **{**kwargs, "preserve_rng_state": True})

    got = grads()
    monkeypatch.setattr(transformer, "checkpoint", saving)
    want = grads()
    assert seen == [False] * cfg.n_layers
    for name, g, w in zip(dict(ttrain.named_parameters(params)), got, want):
        assert torch.equal(g, w), name


def _per_tensor_optimizer(params: dict, opt: ttrain.OptimizerConfig):
    """The AdamW that wrote every checkpoint before the graphed step:
    one tensor at a time, a float rate, step counts on the host."""
    decay, no_decay = [], []
    for name, value in ttrain.named_parameters(params):
        (no_decay if name.endswith("_norm") else decay).append(value)
    return torch.optim.AdamW(
        [dict(params=decay, weight_decay=opt.weight_decay),
         dict(params=no_decay, weight_decay=0.0)],
        lr=opt.learning_rate(0), betas=(0.9, 0.999), eps=1e-8,
        foreach=False)


def test_per_tensor_checkpoint_restores_into_the_fused_update(tmp_path):
    """Two steps of the earlier per-tensor AdamW, saved; restored into
    the trainer's fused AdamW (its own rate tensor and settings kept,
    the moments and f32 step counts restored) it continues two steps as
    the per-tensor one does, within the parity tolerances."""
    cfg = TransformerConfig(**{**LOOP_GEOMETRY, "use_pallas": True,
                               "fused_ce": True, "grad_accum": 1})
    opt = ttrain.OptimizerConfig(**OPT)
    batches = torch.from_numpy(_batches(4, B, T, cfg.vocab_size)).long()
    old = ttrain.TrainState.create(init_params(0, cfg, master=True), opt)
    old.optimizer = _per_tensor_optimizer(old.params, opt)

    def old_step(tokens):
        """The step of that optimizer: a float rate set per step."""
        for _, value in ttrain.named_parameters(old.params):
            value.grad = None
        for group in old.optimizer.param_groups:
            group["lr"] = opt.learning_rate(old.step)
        loss, _, _ = ttrain._step_body(old, tokens, cfg, None, ())
        old.step += 1
        return float(loss)

    for tokens in batches[:2]:
        old_step(tokens)
    with Checkpointer(tmp_path) as ckpt:
        ckpt.save(old, {"next_step": 2})
    saved = {name: {k: v.clone() for k, v in old.optimizer.state[t].items()}
             for name, t in ttrain.named_parameters(old.params)}
    assert all(not s["step"].is_floating_point() or s["step"].device.type
               == "cpu" for s in saved.values())

    new, data = Checkpointer(tmp_path).restore(
        lambda: ttrain.TrainState.create(init_params(1, cfg, master=True),
                                         opt))
    assert new.step == 2 and data == {"next_step": 2}
    rate = new.optimizer.param_groups[0]["lr"]
    for group in new.optimizer.param_groups:
        assert group["fused"] and group["lr"] is rate
    assert torch.is_tensor(rate)
    for name, value in ttrain.named_parameters(new.params):
        state = new.optimizer.state[value]
        assert state["step"].dtype == torch.float32
        assert float(state["step"]) == 2.0
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(state[key], saved[name][key]), (name, key)

    want = [old_step(t) for t in batches[2:]]
    step = ttrain.make_train_step(cfg)
    got = [float(step(new, t)[1]["loss"]) for t in batches[2:]]
    assert new.step == old.step == 4
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for (name, a), (_, b) in zip(ttrain.named_parameters(new.params),
                                 ttrain.named_parameters(old.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=0, atol=2e-5, err_msg=name)


def _bump_launches(n: int) -> None:
    """Launch counts as each module's wrappers add them on the card."""
    trn.rmsnorm_fwd.launches += n
    trn.rmsnorm_fwd.wide_launches += n
    tfa.flash_fwd.launches += 2 * n
    tfa.flash_dq.launches += n
    tfa.flash_dkv.launches += n
    tce.fused_ce_fwd.launches += n
    tce.fused_ce_bwd.launches += n
    tce.ROUTE_LAUNCHES["wgmma"] += 2 * n
    tpa.paged_flash_decode.launches += n
    tpa.ROUTE_LAUNCHES["rows8"] += n


def test_recording_covers_every_kernel_module():
    """A stub region standing for the step's capture: counts in all four
    modules are taken back (a capture launches nothing) and kept; each
    replay adds exactly them again."""
    kernel_counts.reset_counters()
    _bump_launches(1)  # launched before the region (an eager step)
    before = kernel_counts.counters()
    with kernel_counts.recording() as delta:
        _bump_launches(3)
    assert kernel_counts.counters() == before
    assert {name: n for name, n in delta.items() if n} == {
        "rmsnorm": 3, "rmsnorm_wide": 3, "flash_fwd": 6, "flash_dq": 3,
        "flash_dkv": 3, "fused_ce_fwd": 3, "fused_ce_bwd": 3,
        "fused_ce_wgmma": 6, "paged_flash_decode": 3,
        "paged_flash_decode_rows8": 3}
    assert set(delta) == set(before)
    for _ in range(2):
        kernel_counts.replay_counts(delta)
    after = kernel_counts.counters()
    assert after == {name: before[name] + 2 * delta[name] for name in before}
    for module in kernel_counts.MODULES:
        assert all(after[name] == n for name, n in module.counters().items())
    kernel_counts.reset_counters()
    assert not any(kernel_counts.counters().values())


def _plain_call(module: str) -> None:
    """One call of a wrapper on CPU tensors: its plain version runs."""
    x = torch.randn(8, 64)
    if module == "rmsnorm":
        trn.rmsnorm_fwd(x, torch.ones(64), 1e-6)
    elif module == "flash_attention":
        q = torch.randn(1, 8, 2, 64)
        tfa.flash_fwd(q, q, q, True, 0, None)
    elif module == "fused_ce":
        tce.fused_ce_fwd(x, torch.randn(64, 16), torch.zeros(8,
                                                             dtype=torch.long))
    else:
        tpa.paged_flash_decode_plain.calls += 1


@pytest.mark.parametrize("module", ["rmsnorm", "flash_attention",
                                    "fused_ce", "paged_attention"])
def test_plain_call_in_a_recorded_region_raises(module):
    """A plain version inside a captured region would run on the host at
    capture and never at replay: recording refuses it, in every
    module."""
    kernel_counts.reset_counters()
    with pytest.raises(RuntimeError, match="plain versions ran"):
        with kernel_counts.recording():
            _plain_call(module)
    kernel_counts.reset_counters()


# ---------------------------------------------------------------------------
# On the card

# bf16 at head_dim 64, the narrowest the kernels take; two microbatches.
CARD_CFG = dict(vocab_size=512, d_model=256, n_layers=2, n_heads=4,
                n_kv_heads=2, d_ff=512, attn_bias=True, dtype="bfloat16",
                grad_accum=2)
CARD_OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=4, grad_clip=1.0)
CARD_B, CARD_T = 4, 128


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the kernels)")


def _card_batches(n: int, seed: int = 0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, CARD_CFG["vocab_size"], (n, CARD_B, CARD_T),
                         generator=gen, device="cuda")


def _card_state(cfg):
    return ttrain.TrainState.create(
        init_params(0, cfg, device="cuda", master=True),
        ttrain.OptimizerConfig(**CARD_OPT))


def _card_run(cfg, batches, cuda_graph=True):
    """(state, per-step metrics as floats, the step function) of one
    step function over ``batches`` from the seed-0 masters."""
    state = _card_state(cfg)
    step = ttrain.make_train_step(cfg, cuda_graph=cuda_graph)
    metrics = [step(state, tokens)[1] for tokens in batches]
    return state, [{k: float(v) for k, v in m.items()} for m in metrics], step


def _assert_states_equal(a, b) -> None:
    for (name, x), (_, y) in zip(ttrain.named_parameters(a.params),
                                 ttrain.named_parameters(b.params)):
        assert torch.equal(x, y), name
        sx, sy = a.optimizer.state[x], b.optimizer.state[y]
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sx[key], sy[key]), (name, key)


@pytest.mark.cuda
@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_graphed_steps_equal_eager_steps(moe):
    """Three distinct batches: the first step eager, then a capture and
    two replays, against three eager steps from the same masters —
    metrics, parameters and both moments bit-equal."""
    _need_gpu()
    cfg = TransformerConfig(**CARD_CFG, **(
        dict(n_experts=4, moe_top_k=2, router_z_loss=1e-3) if moe else {}))
    batches = _card_batches(3)
    eager, want, _ = _card_run(cfg, batches, cuda_graph=False)
    graphed, got, step = _card_run(cfg, batches)
    assert got == want
    assert step.stats()["captures"] == 1 and step.stats()["replays"] == 2
    _assert_states_equal(graphed, eager)


@pytest.mark.cuda
def test_graphed_lora_steps_equal_eager_steps():
    """LoRA: the merge inside the graph, the frozen base held by
    address; bit-equal to the eager LoRA steps."""
    _need_gpu()
    cfg = TransformerConfig(**CARD_CFG)
    base = init_params(0, cfg, device="cuda", master=True)
    batches = _card_batches(3)
    runs = []
    for cuda_graph in (False, True):
        adapters = tlora.init_lora(1, cfg, 4, device="cuda")
        state = ttrain.TrainState.create(adapters,
                                         ttrain.OptimizerConfig(**CARD_OPT))
        step = tlora.make_lora_train_step(cfg, 16.0, 4, cuda_graph)
        losses = [float(step(state, base, t)[1]["loss"]) for t in batches]
        runs.append((state, losses, step.stats()))
    (eager, want, _), (graphed, got, stats) = runs
    assert got == want and stats["replays"] == 2
    _assert_states_equal(graphed, eager)


@pytest.mark.cuda
def test_replay_reads_the_new_batch():
    """Two graphed runs that differ only in their third batch: equal for
    two steps, different at the third (the replay copied the new batch
    in), and each third step equal to the eager step on its batch."""
    _need_gpu()
    cfg = TransformerConfig(**CARD_CFG)
    first, other = _card_batches(3), _card_batches(1, seed=9)
    second = torch.cat([first[:2], other])
    _, a, _ = _card_run(cfg, first)
    _, b, _ = _card_run(cfg, second)
    assert a[:2] == b[:2] and a[2]["loss"] != b[2]["loss"]
    _, want, _ = _card_run(cfg, second, cuda_graph=False)
    assert b == want


@pytest.mark.cuda
def test_one_capture_per_step_function():
    """Five steps: one capture, four replays; a batch of another shape
    or another state is refused, and nothing is captured again."""
    _need_gpu()
    cfg = TransformerConfig(**CARD_CFG)
    state, _, step = _card_run(cfg, _card_batches(5))
    assert step.stats()["captures"] == 1 and step.stats()["replays"] == 4
    assert step.stats()["graphed"] and len(step.stats()["replay_ms"]) == 4
    with pytest.raises(ValueError, match="bound to"):
        step(state, _card_batches(1)[0][:, :64])
    with pytest.raises(ValueError, match="bound to"):
        step(_card_state(cfg), _card_batches(1)[0])
    assert step.stats()["captures"] == 1 and step.stats()["replays"] == 4


@pytest.mark.cuda
def test_metrics_survive_the_next_replay():
    """The metrics step N returned are its own tensors: step N+1's
    replay does not rewrite them."""
    _need_gpu()
    cfg = TransformerConfig(**CARD_CFG)
    state = _card_state(cfg)
    step = ttrain.make_train_step(cfg)
    batches = _card_batches(4)
    step(state, batches[0])
    _, kept = step(state, batches[1])
    copies = {k: v.clone() for k, v in kept.items()}
    _, later = step(state, batches[2])
    step(state, batches[3])
    torch.cuda.synchronize()
    for name in kept:
        assert torch.equal(kept[name], copies[name]), name
    assert float(kept["loss"]) != float(later["loss"])


@pytest.mark.cuda
def test_launch_counts_survive_replays():
    """Four graphed steps launch what four eager steps do, by the
    smoke's formulas per microbatch: the forward and the remat
    recompute run both norms and the attention of every layer, the
    final norm once, dq and dkv once a layer, fused CE's forward and
    joint backward once; no plain version."""
    _need_gpu()
    cfg = TransformerConfig(**CARD_CFG)
    kernel_counts.reset_counters()
    _card_run(cfg, _card_batches(4))
    got = kernel_counts.counters()
    micro, layers = 4 * cfg.grad_accum, cfg.n_layers
    want = {"rmsnorm": micro * (4 * layers + 1),
            "flash_fwd": micro * 2 * layers, "flash_dq": micro * layers,
            "flash_dkv": micro * layers, "fused_ce_fwd": micro,
            "fused_ce_bwd": micro, "fused_ce_dx": 0, "fused_ce_dw": 0}
    assert {name: got[name] for name in want} == want
    assert not any(n for name, n in got.items() if name.endswith("_plain"))
    kernel_counts.reset_counters()
