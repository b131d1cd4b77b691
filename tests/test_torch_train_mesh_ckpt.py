"""Sharded checkpoints of the port's mesh trainer, on the CPU.

Two spawned ranks (``tests/torch_tp_worker.py``'s ``RankGroup``, gloo)
run ``train_main``'s training as the ranks of the mesh its flags ask
for: a dp=2 ZeRO-1 run straight through three steps, the same run
interrupted after step 2 and resumed by the same command, which then
exports.  Around it, placement independence: that checkpoint restored
onto one device and onto tp=2, a one-device checkpoint in the layout
from before sharded saves resumed at dp=2, the mesh's export served by
the one-device ``serve_main`` and at ``--tp 2`` and fine-tuned by LoRA
at dp=2, and a save in which one rank fails, which must leave no step.

What must be exact is exact: a resume on the same mesh takes the
uninterrupted run's step bit for bit, and every restore puts back the
saved values themselves.  A one-device checkpoint resumed at dp=2 sums
its gradient over ranks in another order: within the one-device parity
test's 1e-5 on the loss.
"""

import json
import os

import numpy as np
import pytest
import torch

from oim_tpu_torch.checkpoint import Checkpointer, load_params
from oim_tpu_torch.checkpoint.manager import flatten_params
from oim_tpu_torch.cli import serve_main, train_main
from oim_tpu_torch.models import train as ttrain
from oim_tpu_torch.models.transformer import TransformerConfig, init_params
from oim_tpu_torch.serve.engine import GenRequest
from torch_cpu_threads import one_torch_thread  # noqa: F401
from torch_tp_cases import TRAIN_DENSE, assemble, train_batches, train_case
from torch_tp_worker import RankGroup

GEOMETRY = ["--vocab-size", "128", "--d-model", "32", "--n-layers", "2",
            "--n-heads", "4", "--n-kv-heads", "2", "--d-ff", "64",
            "--attn-bias", "--dtype", "float32"]
ARGS = ["--device", "cpu", "--synthetic", "20000", "--batch-global", "4",
        "--seq", "32", "--lr", "1e-2", "--warmup-steps", "1",
        "--decay-steps", "3", "--grad-clip", "1.0", "--log-every", "1",
        ] + GEOMETRY
OPT = dict(lr=1e-2, warmup_steps=1, decay_steps=3, weight_decay=1e-4,
           grad_clip=1.0)
CFG = dict(TRAIN_DENSE, doc_sep_id=-1)
SERVE = GEOMETRY + ["--device", "cpu", "--max-len", "64", "--n-slots", "2",
                    "--kv-block", "8"]
REQUESTS = [dict(tokens=[5, 9, 14, 2, 77], max_new_tokens=6),
            dict(tokens=list(range(30, 50)), max_new_tokens=5)]
DP2, TP2 = dict(dp=2), dict(tp=2)


def _one_device(*flags):
    return train_main.train(train_main.build_parser().parse_args(
        ARGS + list(flags)), cuda_graph=False)


def _legacy_checkpoint(path) -> dict:
    """A one-device run of two steps saved in the layout from before
    sharded saves: ``params.pt`` whole and ``optimizer.pt`` (the AdamW
    ``state_dict`` keyed by index, and the step)."""
    state = _one_device("--steps", "2")["state"]
    step = path / "2"
    step.mkdir(parents=True)
    torch.save({k: v.detach().clone() for k, v in
                flatten_params(state.params).items()}, step / "params.pt")
    torch.save({"step": 2, "optimizer": state.optimizer.state_dict()},
               step / "optimizer.pt")
    (step / "data.json").write_text(json.dumps({"next_step": 2}))
    return state


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh-ckpt")
    dirs = {k: str(root / k) for k in ("ckpt", "export", "legacy", "fail",
                                         "tp_ckpt", "tp_export")}
    legacy = _legacy_checkpoint(root / "legacy")
    dp2 = ARGS + ["--dp", "2", "--zero1"]
    cases = [
        train_case("full", DP2, "main", argv=dp2 + ["--steps", "3"]),
        train_case("first", DP2, "main", argv=dp2 + [
            "--steps", "2", "--checkpoint-dir", dirs["ckpt"],
            "--save-every", "100"]),
        train_case("resumed", DP2, "main", argv=dp2 + [
            "--steps", "3", "--checkpoint-dir", dirs["ckpt"],
            "--save-every", "100", "--export-dir", dirs["export"]]),
        train_case("lora_dp2", DP2, "main", argv=ARGS + [
            "--dp", "2", "--steps", "2", "--lora-rank", "4",
            "--lora-base", dirs["export"]]),
        train_case("legacy_dp2", DP2, "main", argv=ARGS + [
            "--dp", "2", "--steps", "3", "--checkpoint-dir",
            dirs["legacy"]]),
        train_case("failed_save", DP2, "failed_save", cfg=CFG, opt=OPT,
                   batches=train_batches(128, steps=1), dir=dirs["fail"],
                   timeout=2.0),
        train_case("restore_tp2", TP2, "restore", cfg=CFG, opt=OPT,
                   dir=dirs["ckpt"]),
        train_case("trained_tp2", TP2, "main", argv=ARGS + [
            "--tp", "2", "--steps", "2", "--checkpoint-dir",
            dirs["tp_ckpt"], "--export-dir", dirs["tp_export"]]),
        train_case("serve_tp2", TP2, "serve", requests=REQUESTS,
                   argv=SERVE + ["--tp", "2", "--params-dir",
                                 dirs["export"]]),
    ]
    group = RankGroup(2, str(root), **DP2)
    try:
        group.submit(cases)
        out = group.collect([c["name"] for c in cases])
    finally:
        group.close()
    for name, answers in out.items():
        for answer in answers:
            assert "error" not in answer, f"{name}: {answer['error']}"
    return out, dirs, legacy


def _restored_one_device(path, step=None):
    cfg = TransformerConfig(**CFG)
    return Checkpointer(path).restore(lambda: ttrain.TrainState.create(
        init_params(1, cfg, master=True), ttrain.OptimizerConfig(**OPT)),
        step)


def _moments(state) -> dict:
    return {name: (state.optimizer.state[t]["exp_avg"].numpy(),
                   state.optimizer.state[t]["exp_avg_sq"].numpy())
            for name, t in ttrain.named_parameters(state.params)}


def test_interrupted_zero1_run_resumes_bit_equal(runs):
    out, dirs, _ = runs
    full, first, resumed = out["full"], out["first"], out["resumed"]
    assert first[0]["losses"] + resumed[0]["losses"] == full[0]["losses"]
    assert resumed[0]["start_step"] == 2
    want, got = assemble(full), assemble(resumed)
    for name in want:
        assert got[name].tobytes() == want[name].tobytes(), name
    for part in (1, 2):
        want_m = assemble(full, "moments", part)
        got_m = assemble(resumed, "moments", part)
        for name in want_m:
            assert got_m[name].tobytes() == want_m[name].tobytes(), name
    ckpt = Checkpointer(dirs["ckpt"])
    assert ckpt.all_steps() == [2, 3]
    layout = json.loads((ckpt._dir / "3" / "layout.json").read_text())
    # ZeRO-1: each rank wrote its half of wte's moments, one rank the
    # replicated parameters.
    assert len(layout["moments"]["wte"]["blocks"]) == 2
    assert len(layout["params"]["wte"]["blocks"]) == 1


def test_zero1_checkpoint_restores_onto_one_device(runs):
    out, dirs, _ = runs
    state, data = _restored_one_device(dirs["ckpt"])
    assert state.step == 3 and data == {"next_step": 3}
    params = assemble(out["resumed"])
    for name, value in ttrain.named_parameters(state.params):
        assert value.detach().numpy().tobytes() == params[name].tobytes()
    avg, avg_sq = (assemble(out["resumed"], "moments", p) for p in (1, 2))
    for name, (m, v) in _moments(state).items():
        assert m.tobytes() == avg[name].tobytes(), name
        assert v.tobytes() == avg_sq[name].tobytes(), name
        assert float(state.optimizer.state[dict(ttrain.named_parameters(
            state.params))[name]]["step"]) == 3.0


def test_zero1_checkpoint_restores_onto_tp2(runs):
    """Column, row and vocab blocks of tp=2 built from dp=2's ZeRO-1
    halves: the saved values, bit for bit."""
    out, dirs, _ = runs
    state, _ = _restored_one_device(dirs["ckpt"])
    got = assemble(out["restore_tp2"])
    for name, value in ttrain.named_parameters(state.params):
        assert got[name].tobytes() == value.detach().numpy().tobytes(), name
    got_m = assemble(out["restore_tp2"], "moments")
    for name, (m, _) in _moments(state).items():
        assert got_m[name].tobytes() == m.tobytes(), name
    assert {a["step"] for a in out["restore_tp2"]} == {3}
    shapes = {n: a.shape for n, (_, a) in
              out["restore_tp2"][0]["blocks"].items()}
    assert shapes["wte"] == (64, 32) and shapes["layers.0.wq"] == (32, 16)


def test_one_device_checkpoint_resumes_at_dp2(runs, tmp_path):
    """The layout from before sharded saves, one device's, resumes at
    dp=2 (the third step within 1e-5 of the one-device run's) and
    restores onto one device as saved."""
    out, dirs, legacy = runs
    want = _one_device("--steps", "3")["losses"]
    np.testing.assert_allclose(out["legacy_dp2"][0]["losses"], want[2:],
                               rtol=0, atol=1e-5)
    state, data = _restored_one_device(dirs["legacy"], 2)
    assert data == {"next_step": 2} and state.step == 2
    for (name, x), (_, y) in zip(ttrain.named_parameters(state.params),
                                 ttrain.named_parameters(legacy.params)):
        assert torch.equal(x, y), name
    for (name, a), (_, b) in zip(_moments(state).items(),
                                 _moments(legacy).items()):
        assert a[0].tobytes() == b[0].tobytes(), name


def test_mesh_export_serves_on_one_device_and_at_tp2(runs):
    out, dirs, _ = runs
    exported = dict(ttrain.named_parameters(load_params(dirs["export"])))
    want = assemble(out["full"])
    assert sorted(os.listdir(dirs["export"])) == ["params.pt"]
    for name, value in exported.items():
        assert value.numpy().tobytes() == want[name].tobytes(), name
    engine = serve_main.make_engine(serve_main.build_parser().parse_args(
        SERVE + ["--params-dir", dirs["export"]]))
    rids = [engine.submit(GenRequest(**r)) for r in REQUESTS]
    done = engine.run()
    single = [list(done[rid]) for rid in rids]
    assert [len(t) for t in single] == [6, 5]
    assert out["serve_tp2"][0]["tokens"] == single


def test_a_rank_failing_mid_save_leaves_no_step(runs):
    out, dirs, _ = runs
    lead, failed = out["failed_save"]
    assert "TimeoutError" in lead["error_seen"]
    assert "did not finish" in lead["error_seen"]
    assert "disk lost mid-save" in failed["error_seen"]
    assert lead["steps"] == failed["steps"] == []
    assert not [d for d in os.listdir(dirs["fail"]) if d.isdigit()]


def test_lora_trains_on_a_dp_mesh(runs):
    """LoRA over the mesh's export at dp=2: adapters whole on both ranks,
    their gradients summed over dp — the one-device fine-tune's losses
    within 1e-5 and its adapters within 2e-5."""
    out, dirs, _ = runs
    want = _one_device("--steps", "2", "--lora-rank", "4", "--lora-base",
                       dirs["export"])
    got = out["lora_dp2"]
    np.testing.assert_allclose(got[0]["losses"], want["losses"], rtol=0,
                               atol=1e-5)
    assert got[0]["blocks"].keys() == got[1]["blocks"].keys()
    for name, value in ttrain.named_parameters(want["state"].params):
        for rank in got:
            np.testing.assert_allclose(rank["blocks"][name][1],
                                       value.detach().numpy(), rtol=0,
                                       atol=2e-5, err_msg=name)


def test_tp2_export_gathers_the_blocks(runs):
    """An export written on tp=2: each leaf gathered whole over the axis
    that cuts it (columns, rows, the vocab), written by rank 0."""
    out, dirs, _ = runs
    want = assemble(out["trained_tp2"])
    got = dict(ttrain.named_parameters(load_params(dirs["tp_export"])))
    assert set(got) == set(want)
    for name, value in got.items():
        assert value.numpy().tobytes() == want[name].tobytes(), name
    assert out["trained_tp2"][0]["blocks"]["wte"][1].shape == (64, 32)
