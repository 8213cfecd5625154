"""Distributed execution over a mesh of shards (the port of
``velox_tpu/parallel``).

The JAX package runs one SPMD program over a ``jax.sharding.Mesh`` under
``shard_map``, its hash shuffle one ``jax.lax.all_to_all``. The port keeps
the single controller: one process drives every shard of a ``Mesh``
(``mesh.py``), a list of torch devices, several shards to a device where
there are fewer devices than shards. A shard's work runs eagerly on its
device, shard after shard, and the collectives (``collectives.py``) move
tensors device to device, never through the host.
"""

from velox_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, device_count, make_mesh,
)
from velox_tpu_torch.parallel.shuffle import hash_repartition  # noqa: F401
from velox_tpu_torch.parallel.aggregate import (  # noqa: F401
    make_distributed_aggregate,
)
