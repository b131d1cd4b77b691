"""LoRA fine-tuning in the port against the JAX package's, on the CPU,
and the fine-tune flow through the port's entry points.

- Three ``make_lora_train_step`` steps on the same base, adapters and
  batches as the reference's on a one-device mesh (its optax chain:
  clip, adamw with every adapter decayed, warmup-cosine), fused
  unembed+CE on (the usual configuration; the reference's fused-CE
  Pallas kernels in interpret mode).  Tolerances as
  ``tests/test_torch_train.py``: 1e-5 on losses (the same f32 function
  in another summation order; the port gets adapter gradients from
  autograd through ``W + s·A@B``, the reference from its
  merge-then-chain-rule), and 1e-4 on adapters after three AdamW steps
  at lr 1e-2: 1 % of one step.  That is looser than the full model's
  2e-5 for a stated reason: B starts at zero, so A's gradient at step 2
  is s·dW@Bᵀ with B one step (about lr) from zero — about a hundredth of
  a full weight gradient, with the same absolute summation noise — and
  Adam divides the magnitude out, so the noise reaches the update about
  a hundred times larger relative to it (observed 3.8e-5).
- ``merge_lora`` and ``_adapter_grads`` against the reference's.
- The CPU counterpart of ``tests/test_cli.py::
  test_lora_finetune_workflow``: pretrain with a checkpoint and an
  export, fine-tune LoRA on the export with eval, compare checkpoint
  bytes, serve the merged export, and refuse ``--lora-rank`` without
  ``--lora-base``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from oim_tpu.models import (
    TrainState as JTrainState,
    TransformerConfig as JConfig,
    init_params as j_init_params,
)
from oim_tpu.models import lora as jlora
from oim_tpu.models.train import data_pspec
from oim_tpu.parallel import build_mesh

from oim_tpu_torch.checkpoint import directory_bytes, load_params
from oim_tpu_torch.cli import serve_main, train_main
from oim_tpu_torch.models import lora
from oim_tpu_torch.models import train as ttrain
from oim_tpu_torch.models.transformer import TransformerConfig
from oim_tpu_torch.models.weights import from_jax_lora, from_jax_params
from oim_tpu_torch.ops import fused_ce
from oim_tpu_torch.serve.engine import GenRequest
from torch_cpu_threads import one_torch_thread  # noqa: F401

GEOMETRY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                n_kv_heads=2, d_ff=96, attn_bias=True, dtype="float32",
                grad_accum=2)
B, T, STEPS, RANK, ALPHA = 2, 128, 3, 4, 8.0
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


def _nonzero_b(adapters: dict, seed: int) -> dict:
    """Reference adapters with random B (B starts at zero: a merge of
    fresh adapters would test nothing)."""
    rng = np.random.RandomState(seed)
    out = dict(adapters)
    for name in jlora.LORA_TARGETS:
        shape = adapters[f"{name}_b"].shape
        out[f"{name}_b"] = jnp.asarray(
            rng.standard_normal(shape).astype(np.float32) * 0.1)
    return out


def test_three_lora_steps_match_jax():
    jcfg = JConfig(**GEOMETRY)
    cfg = TransformerConfig(**GEOMETRY)
    rng = np.random.RandomState(0)
    tokens = [rng.randint(0, GEOMETRY["vocab_size"], (B, T)).astype(np.int32)
              for _ in range(STEPS)]
    tree = jax.device_get(j_init_params(jax.random.PRNGKey(0), jcfg))
    jadapters = jlora.init_lora(jax.random.PRNGKey(1), jcfg, RANK)
    base = from_jax_params(tree, cfg, master=True)
    adapters = from_jax_lora(jax.device_get(jadapters), cfg)

    mesh = build_mesh(devices=jax.devices()[:1])
    chain = _optax_chain(OPT)
    jstate = JTrainState.create(jadapters, chain)
    jstep = jlora.make_lora_train_step(jcfg, mesh, chain, ALPHA, RANK)
    sharding = jax.sharding.NamedSharding(mesh, data_pspec())
    want = []
    for tok in tokens:
        jstate, metrics = jstep(jstate, tree, jax.device_put(tok, sharding))
        want.append((float(metrics["loss"]), float(metrics["ce"])))

    state = ttrain.TrainState.create(adapters, ttrain.OptimizerConfig(**OPT))
    step = lora.make_lora_train_step(cfg, ALPHA, RANK)
    fused_ce.reset_counters()
    got = []
    for tok in tokens:
        state, metrics = step(state, base, torch.from_numpy(tok).long())
        got.append((float(metrics["loss"]), float(metrics["ce"])))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # The unembedding is frozen: its gradient is never computed.
    counts = fused_ce.counters()
    assert counts["fused_ce_fwd_plain"] == counts["fused_ce_dx_plain"] == (
        2 * STEPS)
    assert counts["fused_ce_dw_plain"] == 0
    assert all(t.grad is None for _, t in ttrain.named_parameters(base))

    want_adapters = dict(ttrain.named_parameters(
        from_jax_lora(jax.device_get(jstate.params), cfg)))
    got_adapters = dict(ttrain.named_parameters(state.params))
    assert set(got_adapters) == set(want_adapters)
    for name, value in got_adapters.items():
        np.testing.assert_allclose(value.detach().numpy(),
                                   want_adapters[name].numpy(), rtol=0,
                                   atol=1e-4, err_msg=name)


def test_merge_lora_and_adapter_grads_match_jax():
    jcfg = JConfig(**GEOMETRY)
    cfg = TransformerConfig(**GEOMETRY)
    tree = jax.device_get(j_init_params(jax.random.PRNGKey(0), jcfg))
    jadapters = _nonzero_b(jlora.init_lora(jax.random.PRNGKey(1), jcfg,
                                           RANK), seed=2)
    adapters = from_jax_lora(jax.device_get(jadapters), cfg)
    jmerged = jax.device_get(jlora.merge_lora(tree, jadapters, ALPHA, RANK))
    merged = lora.merge_lora(from_jax_params(tree, cfg, master=True),
                             adapters, ALPHA, RANK)
    want = dict(ttrain.named_parameters(
        from_jax_params(jmerged, cfg, master=True)))
    for name, value in ttrain.named_parameters(merged):
        # f32 A@B of rank 4 plus W: summation order only.
        np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)

    rng = np.random.RandomState(3)
    jgrads = {name: jnp.asarray(rng.standard_normal(
        np.shape(tree[name])).astype(np.float32))
        for name in jlora.LORA_TARGETS}
    jout = jax.device_get(jlora._adapter_grads(jgrads, jadapters, ALPHA,
                                               RANK))
    grads_w = from_jax_lora(jax.device_get(jgrads), cfg)
    out = lora._adapter_grads(grads_w, adapters, ALPHA, RANK)
    ref = dict(ttrain.named_parameters(from_jax_lora(jout, cfg)))
    got = dict(ttrain.named_parameters(out))
    assert set(got) == set(ref)
    for name, value in got.items():
        np.testing.assert_allclose(value.numpy(), ref[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_init_lora_starts_at_the_base_model():
    cfg = TransformerConfig(**GEOMETRY)
    adapters = lora.init_lora(0, cfg, RANK)
    assert len(adapters["layers"]) == cfg.n_layers
    ad = adapters["layers"][0]
    assert ad["wq_a"].shape == (64, RANK) and ad["wo_b"].shape == (RANK, 64)
    assert ad["wk_b"].shape == (RANK, cfg.kv_heads * cfg.head_dim)
    assert all(float(ad[f"{n}_b"].abs().max()) == 0.0
               for n in lora.LORA_TARGETS)
    assert float(ad["wq_a"].abs().max()) <= 2.0 / 8.0  # ±2σ over sqrt(64)
    torch.testing.assert_close(lora.init_lora(0, cfg, RANK)["layers"][1],
                               adapters["layers"][1], rtol=0, atol=0)
    with pytest.raises(ValueError, match="rank must be >= 1"):
        lora.init_lora(0, cfg, 0)


DRIVE_GEOMETRY = ["--vocab-size", "128", "--d-model", "32", "--n-layers",
                  "2", "--n-heads", "4", "--dtype", "float32"]
DRIVE = ["--device", "cpu", "--synthetic", "100000", "--batch-global", "8",
         "--seq", "32", "--log-every", "1"] + DRIVE_GEOMETRY


def test_lora_finetune_workflow(tmp_path, capsys):
    """Pretrain -> export base -> LoRA fine-tune against the frozen base
    (small adapter checkpoints) -> merged export -> servable."""
    base_ckpt, base_export = tmp_path / "base-ckpt", tmp_path / "base-params"
    assert train_main.main(DRIVE + [
        "--steps", "2", "--save-every", "2", "--checkpoint-dir",
        str(base_ckpt), "--export-dir", str(base_export)]) == 0

    lora_ckpt, merged = tmp_path / "lora-ckpt", tmp_path / "merged-params"
    capsys.readouterr()
    assert train_main.main(DRIVE + [
        "--steps", "3", "--save-every", "3", "--lora-rank", "4",
        "--lora-base", str(base_export), "--checkpoint-dir", str(lora_ckpt),
        "--export-dir", str(merged), "--eval-every", "3"]) == 0
    err = capsys.readouterr().err
    assert "oim-train lora rank=4" in err and "eval_ce=" in err

    # Adapter checkpoints are a fraction of the base checkpoint.
    assert directory_bytes(lora_ckpt) < directory_bytes(base_ckpt) * 0.5

    # The merged export is base + s·A@B of the saved adapters.
    base = load_params(base_export)
    adapters = load_params(lora_ckpt / "3")  # a step's params.pt
    want = lora.merge_lora(base, adapters, 16.0, 4)
    want = dict(ttrain.named_parameters(want))
    got = dict(ttrain.named_parameters(load_params(merged)))
    assert set(got) == set(want)
    for name, value in got.items():
        torch.testing.assert_close(value, want[name], rtol=0, atol=0,
                                   msg=name)

    args = serve_main.build_parser().parse_args(
        DRIVE_GEOMETRY + ["--device", "cpu", "--max-len", "64",
                          "--n-slots", "1", "--kv-block", "8",
                          "--params-dir", str(merged)])
    engine = serve_main.make_engine(args)
    rid = engine.submit(GenRequest(tokens=[5, 6, 7], max_new_tokens=5))
    assert len(engine.run()[rid]) == 5

    # Missing --lora-base fails fast and names the flag.
    with pytest.raises(SystemExit, match="--lora-base"):
        train_main.main(DRIVE + ["--steps", "1", "--lora-rank", "4"])
