"""``serve_main --tp/--ep/--bootstrap`` in the port, on the CPU.

- ``--device cpu --tp 2`` as its own process: one command starts its
  follower rank (spawned, gloo), serves ``/v1/generate`` with the tokens
  the single-device engine gives the same seed's weights, reports
  ``tp``/``ep`` in ``/v1/info``, streams ``/v1/weights`` byte-equal to
  the single-device server's, and on SIGTERM drains, stops the follower
  (exit code 0) and exits 0.
- ``--tp 2 --params-peer URL --kv-block --kv-host-bytes``: the ranks
  take a single-device sibling's weights and serve its greedy tokens;
  SIGTERM with a live stream drains by migration — the stream ends
  "migrated", its ``/v1/slot`` record exports (every rank's part) until
  it is deleted — and then every rank exits.
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
from oim_tpu_torch.serve import disagg
from oim_tpu_torch.serve.engine import Engine
from oim_tpu_torch.serve.server import ServeServer
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


def _raw(port: int, path: str, method: str = "GET") -> tuple:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


class _Process:
    """``serve_main`` with ``args`` as its own process: its stderr lines
    (``lines``), the port it listens on; ``stop`` sends SIGTERM and
    returns its exit code and log."""

    def __init__(self, tmp_path, args):
        argv = [sys.executable, "-m", "oim_tpu_torch.cli.serve_main",
                *args, "--device", "cpu", "--tp", "2", "--port", "0",
                "--no-warmup", "--watchdog-interval", "0"]
        env = dict(os.environ, PYTHONPATH=str(REPO), TMPDIR=str(tmp_path),
                   OMP_NUM_THREADS="1")
        self.proc = subprocess.Popen(argv, cwd=str(REPO), env=env,
                                     stderr=subprocess.PIPE, text=True,
                                     start_new_session=True)
        self.lines, listening = [], threading.Event()

        def read():
            for line in self.proc.stderr:
                self.lines.append(line)
                if "oim-serve listening" in line:
                    listening.set()

        self.reader = threading.Thread(target=read, daemon=True)
        self.reader.start()
        if not listening.wait(120):
            self.kill()
            raise AssertionError("".join(self.lines[-10:]))
        self.port = int(next(re.search(r"port=(\d+)", ln).group(1)
                             for ln in self.lines
                             if "oim-serve listening" in ln))

    def signal(self) -> None:
        self.proc.send_signal(signal.SIGTERM)

    def wait(self) -> tuple:
        code = self.proc.wait(timeout=90)
        self.reader.join(timeout=10)
        return code, "".join(self.lines)

    def kill(self) -> None:
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()
        self.proc.stderr.close()


def _single_server(args: list, **engine) -> ServeServer:
    """The single-device server of ``TINY`` + ``args``' model (seed 3)."""
    parsed = serve_main.build_parser().parse_args(TINY + args)
    cfg = serve_main.model_config(parsed)
    return ServeServer(Engine(init_params(3, cfg, device="cpu"), cfg,
                              device="cpu", **engine)).start()


def test_serve_main_tp2_process(tmp_path):
    proc = _Process(tmp_path, TINY + ["--drain-timeout", "5"])
    try:
        status, reply = _get(proc.port, "/v1/generate",
                             {"tokens": PROMPT, "max_new_tokens": 6})
        assert status == 200, reply
        _, info = _get(proc.port, "/v1/info")
        status, weights = _raw(proc.port, "/v1/weights")
        proc.signal()
        code, text = proc.wait()
    finally:
        proc.kill()
    assert code == 0
    assert (info["engine"]["tp"], info["engine"]["ep"]) == (2, 1)
    assert "mesh ranks stopped exitcodes=[0]" in text, text[-600:]
    single = _single_server([], n_slots=2, max_len=64, chunk=4)
    try:
        _, want = _get(single.port, "/v1/generate",
                       {"tokens": PROMPT, "max_new_tokens": 6})
        assert reply["tokens"] == want["tokens"]
        assert status == 200
        assert weights == _raw(single.port, "/v1/weights")[1]
    finally:
        single.stop()


def test_serve_main_tp2_params_peer_drains_by_migration(tmp_path):
    """The ranks load a sibling's weights; SIGTERM suspends a live
    stream into a slot record, which every rank exports, and the
    followers stop once it is taken."""
    sibling = _single_server([], n_slots=2, max_len=256, chunk=1)
    try:
        proc = _Process(tmp_path, TINY + [
            "--params-peer", f"http://127.0.0.1:{sibling.port}",
            "--seed", "9", "--max-len", "256", "--chunk", "1",
            "--kv-block", "8", "--kv-host-bytes", str(1 << 20),
            "--drain-timeout", "60"])
        try:
            body = {"tokens": PROMPT, "max_new_tokens": 8}
            status, reply = _get(proc.port, "/v1/generate", body)
            assert status == 200
            assert reply["tokens"] == _get(sibling.port, "/v1/generate",
                                           body)[1]["tokens"]
            lines = _stream(proc, {"tokens": PROMPT, "max_new_tokens": 240})
            assert lines[-1].get("migrate") is True, lines[-1]
            rid = int(lines[-1]["request_id"])
            prior = [ln["token"] for ln in lines if "token" in ln]
            status, record = _raw(proc.port, f"/v1/slot?rid={rid}")
            manifest, _ = disagg.unpack_transfer(record)
            assert status == 200 and manifest["tokens"] == prior
            assert manifest["rows"] == len(PROMPT) + len(prior) - 1
            assert _raw(proc.port, f"/v1/slot?rid={rid}", "DELETE")[0] == 200
            code, text = proc.wait()
        finally:
            proc.kill()
    finally:
        sibling.stop()
    assert code == 0 and "drained remaining=0" in text
    assert "mesh ranks stopped exitcodes=[0]" in text, text[-600:]


def _stream(proc: _Process, body: dict) -> list:
    """A streaming generate on ``proc``, SIGTERM sent at its second
    token: every NDJSON line."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{proc.port}/v1/generate",
        json.dumps(dict(body, stream=True)).encode(),
        {"Content-Type": "application/json"})
    lines = []
    with urllib.request.urlopen(req, timeout=60) as resp:
        for raw in resp:
            if raw.strip():
                lines.append(json.loads(raw))
                if len(lines) == 2:
                    proc.signal()
    return lines


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
