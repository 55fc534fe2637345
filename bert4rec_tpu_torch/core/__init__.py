from bert4rec_tpu_torch.core.device import resolve_device
from bert4rec_tpu_torch.core.mesh import (
    MeshConfig,
    create_mesh,
    distributed_initialize,
    batch_sharding,
    replicated_sharding,
)
from bert4rec_tpu_torch.core.dtypes import DTypePolicy, enable_fast_prng
from bert4rec_tpu_torch.core.partitioning import (
    param_partition_specs,
    param_shardings,
    make_batch_specs,
)

__all__ = [
    "MeshConfig", "create_mesh", "distributed_initialize",
    "batch_sharding", "replicated_sharding",
    "DTypePolicy", "enable_fast_prng",
    "param_partition_specs", "param_shardings", "make_batch_specs",
    "resolve_device",
]
