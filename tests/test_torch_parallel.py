"""The port's parallel layer (``oim_tpu_torch/parallel/``) held to
``tests/test_parallel.py``'s semantics, on ``torch.distributed``.

- Meshes: the reference's checks and messages (sizes, too few devices,
  the bootstrap's divisibility rules), the canonical axes, dp inferred
  from a bootstrap; a mesh over a two-rank gloo group, and one whose
  size is not the group's refused.
- Sharding: ``partition_spec`` by the default rules against the
  reference's, ``shard`` taking each rank's block, ``fitted``
  replicating what an axis does not divide; ``logical_axes`` and
  ``param_pspecs`` equal the reference's for dense and MoE configs.
- Collectives: every wrapper over two spawned gloo ranks against numpy.
- The bootstrap: ``/dev/nvidiaN`` and ``cuda:N`` paths bind
  ``CUDA_VISIBLE_DEVICES``, fakes bind nothing, and two staged
  bootstraps form a real gloo group (the counterpart of
  ``tests/test_distributed.py::test_staged_bootstraps_form_real_process_group``).
"""

import json
import os

import numpy as np
import pytest
import torch

from oim_tpu.models import TransformerConfig as JaxConfig
from oim_tpu.models.transformer import logical_axes as jax_logical_axes
from oim_tpu.models.transformer import param_pspecs as jax_param_pspecs
from oim_tpu.parallel import partition_spec as jax_partition_spec

from oim_tpu_torch.models.transformer import (
    TransformerConfig,
    logical_axes,
    param_pspecs,
)
from oim_tpu_torch.parallel import (
    AXES,
    Bootstrap,
    apply_chip_binding,
    build_mesh,
    chip_binding_env,
    load_bootstrap,
    mesh_from_bootstrap,
    partition_spec,
    shard,
)
from oim_tpu_torch.parallel.mesh import mesh_devices
from oim_tpu_torch.parallel.sharding import PartitionSpec, fitted
from torch_cpu_threads import one_torch_thread  # noqa: F401
from torch_tp_worker import (
    _bootstrap_rank,
    _parallel_rank,
    _train_bootstrap_rank,
    spawn_all,
)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' answers from one spawned two-rank gloo group."""
    store = str(tmp_path_factory.mktemp("parallel") / "rendezvous")
    return spawn_all(_parallel_rank, [(r, 2, store) for r in range(2)])


class TestMesh:
    def test_sizes_checked(self):
        with pytest.raises(ValueError, match="tp=0 must be >= 1"):
            build_mesh(tp=0)

    def test_too_few_devices(self):
        with pytest.raises(ValueError, match="need 4 devices, have 2"):
            mesh_devices(4, ["cpu", "cpu"])
        assert [str(d) for d in mesh_devices(2, ["cpu"] * 3)] == ["cpu"] * 2

    def test_needs_a_process_group(self):
        with pytest.raises(RuntimeError, match="initialised default"):
            build_mesh(dp=1, devices=["cpu"])

    def test_from_bootstrap_mismatch(self):
        bootstrap = Bootstrap(mesh=[2, 2, 2], chips=[{}] * 8)
        with pytest.raises(ValueError, match="not divisible by"):
            mesh_from_bootstrap(bootstrap, tp=3)
        with pytest.raises(ValueError, match="does not match slice size 8"):
            mesh_from_bootstrap(bootstrap, dp=3, tp=2)

    def test_two_rank_group(self, ranks):
        assert AXES == ("dp", "pp", "sp", "tp", "ep")
        for rank, answer in enumerate(ranks):
            assert answer["shape"] == {"dp": 1, "pp": 1, "sp": 1, "tp": 2,
                                       "ep": 1}
            assert answer["coords"]["tp"] == rank
            assert answer["bootstrap_dp"]["dp"] == 2
            assert answer["bootstrap_ep"] == {"dp": 1, "pp": 1, "sp": 1,
                                              "tp": 1, "ep": 2}
            assert "needs a process group of 4, have 2" in answer[
                "world_error"]


class TestSharding:
    def test_partition_spec(self):
        assert partition_spec(("batch", "seq", None)) == ("dp", "sp", None)
        assert partition_spec(("experts", "mlp")) == ("ep", "tp")
        for dims in (("batch", "seq", None), ("experts", "mlp"),
                     ("vocab", "model"), ("stages", None, "heads")):
            assert tuple(partition_spec(dims)) == tuple(
                jax_partition_spec(dims))
        with pytest.raises(ValueError):
            partition_spec(("nope",))

    @pytest.mark.parametrize("moe", [False, True])
    def test_logical_axes_match_reference(self, moe):
        fields = dict(vocab_size=64, d_model=32, n_heads=4, attn_bias=True,
                      n_experts=4 if moe else 0, moe_top_k=2 if moe else 1)
        assert logical_axes(TransformerConfig(**fields)) == jax_logical_axes(
            JaxConfig(**fields))
        assert {k: tuple(v) for k, v in param_pspecs(
            TransformerConfig(**fields)).items()} == {
            k: tuple(v) for k, v in jax_param_pspecs(
                JaxConfig(**fields)).items()}

    def test_shard_and_fitted(self):
        class _Mesh:
            shape = {"tp": 2, "ep": 2}

            def axis_size(self, axes):
                axes = (axes,) if isinstance(axes, str) else axes
                return int(np.prod([self.shape[a] for a in axes]))

            def axis_index(self, axes):
                axes = (axes,) if isinstance(axes, str) else tuple(axes)
                return {("tp",): 1, ("ep",): 0, ("tp", "ep"): 2}[axes]

        x = torch.arange(32).reshape(4, 8)
        assert torch.equal(shard(x, PartitionSpec("tp", None), _Mesh()),
                           x[2:])
        assert torch.equal(shard(x, PartitionSpec(None, ("tp", "ep")),
                                 _Mesh()), x[:, 4:6])
        assert fitted((5, 6), PartitionSpec("tp", "tp"), _Mesh()) == (
            None, "tp")
        with pytest.raises(ValueError, match="does not divide"):
            shard(torch.zeros(5), PartitionSpec("tp"), _Mesh())


class TestCollectives:
    def test_against_numpy(self, ranks):
        xs = [np.arange(8, dtype=np.float32).reshape(4, 2) + 10 * i
              for i in range(2)]
        total = xs[0] + xs[1]
        for i, answer in enumerate(ranks):
            got = answer["collectives"]
            np.testing.assert_array_equal(got["psum"], total)
            np.testing.assert_array_equal(got["pmean"], total / 2)
            np.testing.assert_array_equal(got["all_gather0"],
                                          np.concatenate(xs, 0))
            np.testing.assert_array_equal(got["all_gather1"],
                                          np.concatenate(xs, 1))
            np.testing.assert_array_equal(got["reduce_scatter"],
                                          total[2 * i:2 * i + 2])
            np.testing.assert_array_equal(got["ppermute"], xs[1 - i])
            np.testing.assert_array_equal(
                got["all_to_all"],
                np.concatenate([x[2 * i:2 * i + 2] for x in xs], 1))
            counts = got["counts"]
            assert counts["collective.all_reduce"] >= 3
            assert counts["collective.all_gather"] >= 4


class TestChipBinding:
    def _bootstrap(self, paths, num_processes=1):
        return Bootstrap(volume_id="v",
                         chips=[{"device_path": p} for p in paths],
                         mesh=[len(paths)], num_processes=num_processes)

    def test_real_nvidia_devices(self):
        env = chip_binding_env(self._bootstrap(["/dev/nvidia5",
                                                "/dev/nvidia3"]))
        assert env == {"CUDA_VISIBLE_DEVICES": "3,5",
                       "CUDA_DEVICE_ORDER": "PCI_BUS_ID"}

    def test_runtime_enumerated_devices(self):
        env = chip_binding_env(self._bootstrap(["cuda:0", "cuda:1"]))
        assert env == {"CUDA_VISIBLE_DEVICES": "0,1"}

    def test_multiprocess_binds_its_own(self):
        env = chip_binding_env(self._bootstrap(["/dev/nvidia0"],
                                               num_processes=2))
        assert env["CUDA_VISIBLE_DEVICES"] == "0"

    def test_fake_devices_no_binding(self):
        assert chip_binding_env(self._bootstrap(["/tmp/x/nvidia0"])) == {}
        assert chip_binding_env(self._bootstrap(["/dev/nvidiactl"])) == {}
        assert chip_binding_env(self._bootstrap(["/dev/accel0"])) == {}
        # One fake path poisons the set.
        assert chip_binding_env(self._bootstrap(["/dev/nvidia0",
                                                 "/tmp/stub"])) == {}

    def test_apply_exports_env(self, monkeypatch):
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
        monkeypatch.delenv("CUDA_DEVICE_ORDER", raising=False)
        applied = apply_chip_binding(self._bootstrap(["/dev/nvidia1"]))
        try:
            assert os.environ["CUDA_VISIBLE_DEVICES"] == "1"
            assert applied["CUDA_VISIBLE_DEVICES"] == "1"
        finally:
            for key in applied:
                os.environ.pop(key, None)

    def test_apply_fake_is_noop(self, monkeypatch):
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
        assert apply_chip_binding(self._bootstrap(["/tmp/stub"])) == {}
        assert "CUDA_VISIBLE_DEVICES" not in os.environ


def test_bootstrap_roundtrip(tmp_path):
    path = tmp_path / "tpu-bootstrap.json"
    path.write_text(
        '{"volume_id": "v", "chips": [{"device_path": "/dev/nvidia0"}], '
        '"mesh": [1], "coordinator_address": "127.0.0.1:8476", '
        '"num_processes": 1, "process_id": 0}'
    )
    bootstrap = load_bootstrap(str(path))
    assert bootstrap.volume_id == "v"
    assert bootstrap.chip_count == 1
    assert bootstrap.mesh == [1]


def test_staged_bootstraps_form_real_process_group(tmp_path):
    """Two processes, each with its own staged bootstrap (one chip, a
    fake path: nothing to bind on the CPU), meet at the coordinator and
    sum over the mesh's dp axis."""
    paths = []
    for pid in range(2):
        path = tmp_path / f"bootstrap-{pid}.json"
        path.write_text(json.dumps({
            "volume_id": "dist-vol", "chips": [{"device_path": "/tmp/fake"}],
            "mesh": [1], "num_processes": 2, "process_id": pid,
            "coordinator_address": f"file://{tmp_path}/coordinator",
        }))
        paths.append((str(path),))
    reports = spawn_all(_bootstrap_rank, paths)
    for r in reports:
        assert r["world"] == 2
        assert r["shape"] == {"dp": 2, "pp": 1, "sp": 1, "tp": 1, "ep": 1}
        # 8 elements of 1.0 (process 0) + 8 of 2.0 (process 1).
        assert r["sum"] == 24.0


def test_train_main_bootstrap_forms_a_dp_mesh(tmp_path):
    """``train_main --bootstrap``: two processes, each with its own
    staged bootstrap, meet at the coordinator and train as the two dp
    ranks of the slice (dp inferred from it): the losses of the whole
    batch on both, the one-device run's within 1e-5."""
    from oim_tpu_torch.cli import train_main

    argv = ["--device", "cpu", "--synthetic", "4000", "--steps", "2",
            "--batch-global", "4", "--seq", "16", "--vocab-size", "64",
            "--d-model", "32", "--n-layers", "1", "--n-heads", "2",
            "--dtype", "float32", "--lr", "1e-2"]
    paths = []
    for pid in range(2):
        path = tmp_path / f"bootstrap-{pid}.json"
        path.write_text(json.dumps({
            "volume_id": "train-vol", "chips": [{"device_path": "/tmp/fake"}],
            "mesh": [1], "num_processes": 2, "process_id": pid,
            "coordinator_address": f"file://{tmp_path}/coordinator",
        }))
        paths.append((str(path), argv))
    reports = spawn_all(_train_bootstrap_rank, paths)
    want = train_main.train(train_main.build_parser().parse_args(argv))
    for r in reports:
        assert r["mesh"] == {"dp": 2, "pp": 1, "sp": 1, "tp": 1, "ep": 1}
        assert not r["initialized"]  # the run left its group
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=0,
                                   atol=1e-5)
