from automl_tpu_torch.parallel.mesh import (  # noqa: F401
    DEFAULT_AXES, P, create_mesh, mesh_sharding, shard_batch, replicate,
)
from automl_tpu_torch.parallel.distributed import (  # noqa: F401
    initialize, local_slice, build_global_array, build_global_batch,
)
