"""Multi-process training: the process group, the (data, model) layout and
tensor parallelism over the model axis."""

from musicvae_tpu_torch.parallel.distributed import (  # noqa: F401
    assert_hosts_identical, initialize_from_env, rank, world_size,
)
from musicvae_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, MODEL_AXIS, DataMesh, make_mesh, shard_batch,
)
from musicvae_tpu_torch.parallel.tp import (  # noqa: F401
    DEFAULT_TP_RULES, param_shardings, shard_params,
)
