"""Training: the ELBO train step, its state and the host loop."""

from musicvae_tpu_torch.train.preemption import GracefulStop  # noqa: F401
from musicvae_tpu_torch.train.trainer import (  # noqa: F401
    TrainState, create_state, elbo_from_outputs, init_state,
    make_optimizer, make_train_step, make_train_step_indexed,
    make_train_step_indexed_multi, make_train_step_multi, train,
)
