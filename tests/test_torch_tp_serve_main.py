"""``serve_main --tp/--ep/--bootstrap`` in the port, on the CPU.

- ``--device cpu --tp 2`` as its own process: one command starts its
  follower rank (spawned, gloo), serves ``/v1/generate`` with the tokens
  the single-device engine gives the same seed's weights, reports
  ``tp``/``ep`` in ``/v1/info``, refuses ``/v1/weights`` naming ROADMAP
  Queue A12's second part, and on SIGTERM drains, stops the follower
  (exit code 0) and exits 0.
- Too few GPUs fails before any process starts, with the reference's
  ``"need N devices, have M"``; ``make_engine`` alone refuses a mesh
  size it was not given a mesh for.
- ``--bootstrap`` applies a staged ``/dev/nvidiaN`` binding and logs
  it; fake paths bind nothing.
"""

import json
import os
import pathlib
import re
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import pytest
import torch

from oim_tpu_torch.cli import serve_main
from oim_tpu_torch.models.transformer import init_params
from oim_tpu_torch.serve.engine import Engine, GenRequest
from torch_cpu_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
TINY = ["--vocab-size", "128", "--d-model", "32", "--n-layers", "2",
        "--n-heads", "4", "--n-kv-heads", "2", "--d-ff", "64",
        "--attn-bias", "--dtype", "float32", "--n-slots", "2",
        "--max-len", "64", "--chunk", "4", "--seed", "3"]
PROMPT = [5, 17, 33, 2, 90, 61, 7]


def _get(port: int, path: str, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def test_serve_main_tp2_process(tmp_path):
    argv = [sys.executable, "-m", "oim_tpu_torch.cli.serve_main", *TINY,
            "--device", "cpu", "--tp", "2", "--port", "0", "--no-warmup",
            "--watchdog-interval", "0", "--drain-timeout", "5"]
    env = dict(os.environ, PYTHONPATH=str(REPO), TMPDIR=str(tmp_path),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(argv, cwd=str(REPO), env=env,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    lines, listening = [], threading.Event()

    def read():
        for line in proc.stderr:
            lines.append(line)
            if "oim-serve listening" in line:
                listening.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        assert listening.wait(120), "".join(lines[-10:])
        port = int(next(re.search(r"port=(\d+)", ln).group(1)
                        for ln in lines if "oim-serve listening" in ln))
        status, reply = _get(port, "/v1/generate",
                             {"tokens": PROMPT, "max_new_tokens": 6})
        assert status == 200, reply
        _, info = _get(port, "/v1/info")
        status, refused = _get(port, "/v1/weights")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        reader.join(timeout=10)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        proc.stderr.close()
    text = "".join(lines)
    assert (info["engine"]["tp"], info["engine"]["ep"]) == (2, 1)
    assert status == 501 and "A12, second part" in refused["error"]
    assert "mesh ranks stopped exitcodes=[0]" in text, text[-600:]
    args = serve_main.build_parser().parse_args(TINY + ["--device", "cpu"])
    cfg = serve_main.model_config(args)
    engine = Engine(init_params(3, cfg, device="cpu"), cfg, device="cpu",
                    n_slots=2, max_len=64, chunk=4)
    rid = engine.submit(GenRequest(tokens=PROMPT, max_new_tokens=6))
    assert reply["tokens"] == engine.run()[rid]


def test_too_few_devices_fail_before_any_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = serve_main.build_parser().parse_args(TINY + ["--tp", "2"])
    with pytest.raises(ValueError, match="need 2 devices, have 0"):
        serve_main.start_mesh(args, [])
    args = serve_main.build_parser().parse_args(
        TINY + ["--device", "cpu", "--tp", "2"])
    with pytest.raises(ValueError, match="runs on the mesh of ranks"):
        serve_main.make_engine(args)


def test_bootstrap_binds_before_cuda(tmp_path, monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.delenv("CUDA_DEVICE_ORDER", raising=False)
    path = tmp_path / "tpu-bootstrap.json"
    path.write_text(json.dumps({"volume_id": "v", "mesh": [1],
                                "chips": [{"device_path": "/dev/nvidia3"}]}))
    args = serve_main.build_parser().parse_args(
        TINY + ["--bootstrap", str(path)])
    try:
        assert serve_main.bind_bootstrap(args) == {
            "CUDA_VISIBLE_DEVICES": "3", "CUDA_DEVICE_ORDER": "PCI_BUS_ID"}
        assert os.environ["CUDA_VISIBLE_DEVICES"] == "3"
    finally:
        os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        os.environ.pop("CUDA_DEVICE_ORDER", None)
    path.write_text(json.dumps({"chips": [{"device_path": "/tmp/fake"}]}))
    monkeypatch.setenv("TPU_BOOTSTRAP", str(path))
    args = serve_main.build_parser().parse_args(TINY)
    assert serve_main.bind_bootstrap(args) == {}
    monkeypatch.delenv("TPU_BOOTSTRAP")
    assert serve_main.bind_bootstrap(args) == {}
