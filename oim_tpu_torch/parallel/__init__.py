"""The port's parallel layer: meshes, shardings, collectives and the
distributed bootstrap, on ``torch.distributed``.

The counterpart of ``oim_tpu/parallel/``.  The reference is one process
over a ``jax.sharding.Mesh`` with GSPMD placing the collectives; the
port runs one process a device, each holding its shard as a plain
tensor and calling the collectives itself (``collectives.py``), NCCL
between cards and gloo across processes on the CPU.  What serving and
dp·tp·ep training need is here: ``mesh.py``, ``sharding.py``
(``partition_spec``, ``shard``, ``block_slices``), ``collectives.py``
(with the differentiable ``copy_to``/``reduce_from``/``gather_from``
that training runs through) and ``coordinator.py``.  The rest of the
training part — ring attention, Ulysses, the pipeline schedules,
``constrain`` and ``shard_pytree`` — is ROADMAP Queue A12's third part,
second half; the all-reduce bandwidth harness comes after it.
"""

from oim_tpu_torch.parallel import collectives
from oim_tpu_torch.parallel.coordinator import (
    Bootstrap,
    apply_chip_binding,
    chip_binding_env,
    initialize,
    initialize_distributed,
    load_bootstrap,
)
from oim_tpu_torch.parallel.mesh import AXES, Mesh, build_mesh, mesh_from_bootstrap
from oim_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    PartitionSpec,
    ShardingRules,
    partition_spec,
    shard,
)

__all__ = [
    "AXES",
    "Mesh",
    "build_mesh",
    "mesh_from_bootstrap",
    "ShardingRules",
    "DEFAULT_RULES",
    "PartitionSpec",
    "partition_spec",
    "shard",
    "Bootstrap",
    "apply_chip_binding",
    "chip_binding_env",
    "initialize",
    "initialize_distributed",
    "load_bootstrap",
    "collectives",
]
