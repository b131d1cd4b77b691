"""The PyTorch port stands alone, and never runs quietly on the CPU.

- No module of ``oim_tpu_torch`` and not ``chip_smoke.py`` imports JAX
  (``jax``, ``jaxlib``, ``flax``, ``optax``) or anything of the JAX
  package ``oim_tpu``: the port keeps its own copy of what it needs.
- Every port module carries a docstring, imports nothing it does not
  use, and prints only from ``cli/`` (the gates ``tests/test_quality.py``
  holds ``oim_tpu`` to).
- Without a GPU, the entry points raise unless the caller asks for the
  CPU: ``Engine`` with no ``device``, ``serve_main`` and ``train_main``
  with no ``--device``, and ``chip_smoke.py`` (which also refuses to run
  where the port's package is missing).
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "oim_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "oim_tpu"}
PRINT_ALLOWED = ("oim_tpu_torch/cli/",)

FILES = sorted(PORT.rglob("*.py"))
assert FILES, "port file discovery broke"
IDS = [str(p.relative_to(REPO)) for p in FILES]
# The port's modules plus the chip smoke that drives them.
SCRIPTS, SCRIPT_IDS = FILES + [REPO / "chip_smoke.py"], IDS + ["chip_smoke.py"]


def _tree(path):
    return ast.parse(path.read_text(encoding="utf-8"), filename=str(path))


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", SCRIPTS, ids=SCRIPT_IDS)
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(_tree(path))) & FORBIDDEN)
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", SCRIPTS, ids=SCRIPT_IDS)
def test_module_docstring(path):
    tree = _tree(path)
    assert ast.get_docstring(tree), "module lacks a docstring"


@pytest.mark.parametrize("path", FILES, ids=IDS)
def test_no_print_outside_cli(path):
    rel = str(path.relative_to(REPO))
    if rel.startswith(PRINT_ALLOWED):
        return
    calls = [
        node.lineno for node in ast.walk(_tree(path))
        if isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name) and node.func.id == "print"
    ]
    assert not calls, f"print() at lines {calls}"


@pytest.mark.parametrize("path", SCRIPTS, ids=SCRIPT_IDS)
def test_no_unused_imports(path):
    if path.name == "__init__.py":
        return
    tree = _tree(path)
    imported = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                imported[alias.asname or alias.name.split(".")[0]] = node
        elif isinstance(node, ast.ImportFrom) and node.module != "__future__":
            for alias in node.names:
                imported[alias.asname or alias.name] = node
    used = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    used |= {
        n.value.id for n in ast.walk(tree)
        if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
    }
    unused = sorted(set(imported) - used)
    assert not unused, f"unused imports: {unused}"


def _tiny():
    from oim_tpu_torch.models.transformer import TransformerConfig, init_params

    cfg = TransformerConfig(vocab_size=31, d_model=32, n_layers=1,
                            n_heads=2, dtype="float32")
    return cfg, init_params(0, cfg)


def test_engine_without_device_needs_a_gpu():
    from oim_tpu_torch.serve.engine import Engine

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    cfg, params = _tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(params, cfg, max_len=32, kv_block=8)
    # Asking for the CPU is the one way to run there.
    engine = Engine(params, cfg, max_len=32, kv_block=8, device="cpu")
    assert engine.info()["engine"]["attention"] == "plain"


def test_serve_main_without_device_needs_a_gpu():
    from oim_tpu_torch.cli import serve_main

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_main.main(["--vocab-size", "31", "--d-model", "32",
                         "--n-layers", "1", "--n-heads", "2", "--port", "0"])


def test_train_main_without_device_needs_a_gpu():
    from oim_tpu_torch.cli import train_main

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main.main(["--synthetic", "2000", "--steps", "1",
                         "--batch-global", "2", "--seq", "16",
                         "--vocab-size", "31", "--d-model", "32",
                         "--n-layers", "1", "--n-heads", "2"])


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120,
    )


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    for cwd in (REPO, tmp_path):
        if cwd == tmp_path:  # the script alone, without the program
            shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        proc = _run_smoke(cwd)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


def test_chip_smoke_counts_the_work_its_inputs_need():
    """The smoke's bound counts distinct K/V rows read once and (query,
    key) pairs attended, from the tables it was given."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    bs, n_blocks = chip_smoke.BS, 10
    tables = np.full((2, 4), n_blocks, np.int32)
    tables[0, :2] = [3, 5]  # slot 0 owns positions 0..31
    starts = np.array([20, 0], np.int32)
    # Slot 0, t=3 at 20..22: pairs 21+22+23, rows 0..22; slot 1 reads
    # nothing (all sentinel).
    assert chip_smoke.attend_work(starts, 3, tables, n_blocks, 0) == (66, 23)
    # A window of 4 keeps 4 keys per row and rows 17..22.
    assert chip_smoke.attend_work(starts, 3, tables, n_blocks, 4) == (12, 6)
    assert bs == 16
    ms, by = chip_smoke.bound(3_350_000_000, 0, torch.bfloat16)
    assert by == "bytes" and abs(ms - 1.0) < 1e-12


def test_chip_smoke_counts_the_attention_pairs_its_inputs_need(monkeypatch):
    """The train-kernel bound counts the (query, key) pairs the causal
    mask keeps under the window and the packed segments of its inputs."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    # T=4 causal: 1+2+3+4 pairs a row; a window of 2 keeps 1+2+2+2.
    assert chip_smoke.attended_pairs(2, 3, 4, 0, None) == 10 * 3 * 2
    assert chip_smoke.attended_pairs(2, 3, 4, 2, None) == 7 * 3 * 2
    # Documents [0, 0 | 1, 1] keep 1+2+1+2; one document keeps all 10.
    seg = torch.tensor([[0, 0, 1, 1], [0, 0, 0, 0]], dtype=torch.int32)
    assert chip_smoke.attended_pairs(2, 3, 4, 0, seg) == (6 + 10) * 3


def test_chip_smoke_counts_the_fused_ce_work():
    """The fused-CE bound counts x, w and the per-row vectors read once
    and the outputs written once, and 2·N·D·V operations for the forward,
    4·N·D·V for dx and dw (scores, then the product)."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    n, d, v = 4096, 1536, 151936
    ms, by = chip_smoke.ce_bound(n, d, v, torch.bfloat16, "fwd")
    assert by == "operations" and abs(ms - 2 * n * d * v / 989e12 * 1e3) < 1e-9
    ms, by = chip_smoke.ce_bound(n, d, v, torch.bfloat16, "dw")
    assert by == "operations" and abs(ms - 4 * n * d * v / 989e12 * 1e3) < 1e-9
    # One row of a wide vocabulary: bytes bound it.  x, w, labels, lse,
    # g read once; dx written once.
    ms, by = chip_smoke.ce_bound(1, 8, 1000, torch.float32, "dx")
    moved = (8 + 8 * 1000) * 4 + 4 + 2 * 4 + 8 * 4
    assert by == "bytes" and abs(ms - moved / 3.35e12 * 1e3) < 1e-12
