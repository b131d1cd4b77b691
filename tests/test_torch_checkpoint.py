"""The port's checkpoints, on the CPU: exact resume, retention,
atomicity, exports and the trainer's and server's use of them.

The centre: a run interrupted after 3 steps and resumed to 5 is bit for
bit the uninterrupted 5-step run — losses, parameters and both AdamW
moments (and each parameter's step count) — because the checkpoint
carries the whole optimizer state and the data cursor, and the CPU
computes the same steps in the same order.
"""

import json
import os

import pytest
import torch

from oim_tpu_torch.checkpoint import (
    Checkpointer,
    CheckpointerOptions,
    load_params,
)
from oim_tpu_torch.cli import serve_main, train_main
from oim_tpu_torch.models import train as ttrain
from oim_tpu_torch.models.transformer import TransformerConfig, init_params
from oim_tpu_torch.models.weights import recast
from oim_tpu_torch.serve.engine import GenRequest

GEOMETRY = ["--vocab-size", "101", "--d-model", "32", "--n-layers", "2",
            "--n-heads", "4", "--n-kv-heads", "2", "--d-ff", "48",
            "--attn-bias", "--dtype", "float32"]
ARGS = ["--device", "cpu", "--synthetic", "20000", "--batch-global", "4",
        "--seq", "32", "--lr", "1e-2", "--warmup-steps", "2",
        "--decay-steps", "4", "--grad-clip", "1.0", "--log-every", "1",
        ] + GEOMETRY


def _train(*flags):
    return train_main.train(train_main.build_parser().parse_args(
        ARGS + list(flags)))


def _optimizer_state(state):
    """Every optimizer tensor by (parameter name, key)."""
    names = [name for name, _ in ttrain.named_parameters(state.params)]
    leaves = [t for _, t in ttrain.named_parameters(state.params)]
    out = {}
    for name, leaf in zip(names, leaves):
        for key, value in state.optimizer.state[leaf].items():
            out[(name, key)] = value
    return out


def test_interrupted_run_resumes_bit_equal(tmp_path, capsys):
    full = _train("--steps", "5")
    ckpt = str(tmp_path / "ckpt")
    first = _train("--steps", "3", "--checkpoint-dir", ckpt,
                   "--save-every", "3")
    resumed = _train("--steps", "5", "--checkpoint-dir", ckpt,
                     "--save-every", "3")
    assert "oim-train resumed step=3" in capsys.readouterr().err
    assert resumed["start_step"] == 3
    assert first["losses"] + resumed["losses"] == full["losses"]
    a, b = full["state"], resumed["state"]
    assert a.step == b.step == 5
    for (name, x), (_, y) in zip(ttrain.named_parameters(a.params),
                                 ttrain.named_parameters(b.params)):
        assert torch.equal(x, y), name
    sa, sb = _optimizer_state(a), _optimizer_state(b)
    assert set(sa) == set(sb)
    assert {key for _, key in sa} == {"step", "exp_avg", "exp_avg_sq"}
    for key, value in sa.items():
        assert torch.equal(value, sb[key]), key
    # The rescue save at the end of the resumed run, with its cursor.
    ckptr = Checkpointer(ckpt)
    assert ckptr.all_steps() == [3, 5]
    assert json.loads((tmp_path / "ckpt" / "5" / "data.json").read_text()) \
        == {"next_step": 5}


def _tiny_state(step=0):
    cfg = TransformerConfig(vocab_size=11, d_model=8, n_layers=1, n_heads=2,
                            dtype="float32")
    state = ttrain.TrainState.create(init_params(0, cfg, master=True),
                                     ttrain.OptimizerConfig())
    state.step = step
    return state


@pytest.mark.parametrize("async_save", [True, False])
def test_max_to_keep_and_save_interval(tmp_path, async_save):
    opts = CheckpointerOptions(max_to_keep=2, save_interval_steps=2,
                               async_save=async_save)
    with Checkpointer(tmp_path, opts) as ckptr:
        saved = [ckptr.save(_tiny_state(step), {"next_step": step})
                 for step in range(1, 6)]
        assert saved == [False, True, False, True, False]
        assert ckptr.save(_tiny_state(5), {"next_step": 5}, force=True)
        assert not ckptr.save(_tiny_state(5), force=True)  # already saved
        ckptr.wait()
        assert ckptr.all_steps() == [4, 5]
        assert ckptr.latest_step() == 5


def test_async_save_snapshots_before_returning(tmp_path):
    state = _tiny_state(1)
    with Checkpointer(tmp_path) as ckptr:
        ckptr.save(state)
        with torch.no_grad():  # training goes on updating in place
            state.params["wte"].add_(1.0)
        ckptr.wait()
        restored = ckptr.restore_params()
    assert torch.equal(restored["wte"] + 1.0, state.params["wte"])


def test_leftover_temporary_directory_is_not_a_step(tmp_path):
    with Checkpointer(tmp_path) as ckptr:
        ckptr.save(_tiny_state(2), {"next_step": 2})
    # A crash mid-write leaves a temporary directory and no step.
    (tmp_path / ".tmp-7-12345").mkdir()
    (tmp_path / ".tmp-7-12345" / "params.pt").write_bytes(b"torn")
    ckptr = Checkpointer(tmp_path)
    assert ckptr.all_steps() == [2]
    state, data, resumed = ckptr.restore_or_init(lambda: _tiny_state(0))
    assert resumed and state.step == 2 and data == {"next_step": 2}


def test_restore_or_init_without_a_checkpoint(tmp_path):
    ckptr = Checkpointer(tmp_path / "fresh")
    state, data, resumed = ckptr.restore_or_init(lambda: _tiny_state(0))
    assert not resumed and data is None and state.step == 0
    with pytest.raises(FileNotFoundError):
        ckptr.restore(lambda: _tiny_state(0))
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path / "typo", CheckpointerOptions(create=False))
    assert not (tmp_path / "typo").exists()


def test_restore_refuses_another_geometry(tmp_path):
    with Checkpointer(tmp_path) as ckptr:
        ckptr.save(_tiny_state(1))
    cfg = TransformerConfig(vocab_size=11, d_model=16, n_layers=1,
                            n_heads=2, dtype="float32")
    with pytest.raises(ValueError, match="wte"):
        Checkpointer(tmp_path).restore(lambda: ttrain.TrainState.create(
            init_params(0, cfg, master=True), ttrain.OptimizerConfig()))


def test_export_refuses_an_existing_target_and_the_cli_skips_it(
        tmp_path, capsys):
    state = _tiny_state(3)
    ckptr = Checkpointer(tmp_path / "ckpt")
    ckptr.export_params(state, tmp_path / "export")
    loaded = load_params(tmp_path / "export")
    for (name, x), (_, y) in zip(ttrain.named_parameters(loaded),
                                 ttrain.named_parameters(state.params)):
        assert torch.equal(x, y), name
    assert sorted(os.listdir(tmp_path / "export")) == ["params.pt"]
    with pytest.raises(FileExistsError):
        ckptr.export_params(state, tmp_path / "export")

    export = tmp_path / "cli-export"
    flags = ["--steps", "2", "--checkpoint-dir", str(tmp_path / "c2"),
             "--export-dir", str(export)]
    _train(*flags)
    before = (export / "params.pt").read_bytes()
    capsys.readouterr()
    _train(*flags)  # the same command again: resumes at 2, skips export
    err = capsys.readouterr().err
    assert "export exists; skipping" in err
    assert (export / "params.pt").read_bytes() == before


def test_incomplete_run_exports_nothing_and_rescue_saves(tmp_path,
                                                         monkeypatch):
    """A run that fails mid-way saves its last completed step on the way
    out (the ``finally``) and exports nothing; the same command then
    resumes from that step."""
    real = train_main.make_train_step
    calls = []

    def failing(cfg):
        step = real(cfg)

        def wrapped(state, tokens):
            calls.append(1)
            if len(calls) == 3:
                raise RuntimeError("preempted")
            return step(state, tokens)

        return wrapped

    monkeypatch.setattr(train_main, "make_train_step", failing)
    flags = ["--steps", "4", "--save-every", "100", "--checkpoint-dir",
             str(tmp_path / "ckpt"), "--export-dir", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="preempted"):
        _train(*flags)
    assert Checkpointer(tmp_path / "ckpt").all_steps() == [2]
    assert json.loads((tmp_path / "ckpt" / "2" / "data.json").read_text()) \
        == {"next_step": 2}
    assert not (tmp_path / "out").exists()
    monkeypatch.setattr(train_main, "make_train_step", real)
    resumed = _train(*flags)
    assert resumed["start_step"] == 2 and len(resumed["losses"]) == 2
    assert (tmp_path / "out" / "params.pt").is_file()


def test_serve_main_from_a_training_checkpoint(tmp_path):
    ckpt = tmp_path / "ckpt"
    result = _train("--steps", "2", "--checkpoint-dir", str(ckpt),
                    "--save-every", "2")
    args = serve_main.build_parser().parse_args(
        GEOMETRY + ["--device", "cpu", "--max-len", "64", "--n-slots", "1",
                    "--kv-block", "8", "--d-ff", "48",
                    "--checkpoint-dir", str(ckpt)])
    engine = serve_main.make_engine(args)
    cfg = TransformerConfig(
        vocab_size=101, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=48, attn_bias=True, dtype="float32")
    want, _ = recast(result["state"].params, cfg, "float32")
    for (name, x), (_, y) in zip(ttrain.named_parameters(engine.params),
                                 ttrain.named_parameters(want)):
        assert torch.equal(x, y.detach()), name
    rid = engine.submit(GenRequest(tokens=[1, 2, 3], max_new_tokens=4))
    assert len(engine.run()[rid]) == 4

    # A missing checkpoint fails loudly: never random weights.
    bad = serve_main.build_parser().parse_args(
        GEOMETRY + ["--device", "cpu", "--checkpoint-dir",
                    str(tmp_path / "missing")])
    with pytest.raises(FileNotFoundError):
        serve_main.make_engine(bad)
    # Geometry that does not match the flags is refused.
    wrong = serve_main.build_parser().parse_args(
        GEOMETRY + ["--device", "cpu", "--d-ff", "64", "--checkpoint-dir",
                    str(ckpt)])
    with pytest.raises(ValueError, match="does not match"):
        serve_main.make_engine(wrong)
