"""Multi-process data parallelism: the process group and the data
layout."""

from musicvae_tpu_torch.parallel.distributed import (  # noqa: F401
    assert_hosts_identical, initialize_from_env, rank, world_size,
)
from musicvae_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, MODEL_AXIS, DataMesh, make_mesh, shard_batch,
)
