"""Training: the ELBO train step, its state and the host loop."""

from musicvae_tpu_torch.train.trainer import (TrainState, create_state,
                                              init_state, make_optimizer,
                                              make_train_step,
                                              make_train_step_indexed,
                                              make_train_step_indexed_multi,
                                              train)

__all__ = ["TrainState", "create_state", "init_state", "make_optimizer",
           "make_train_step", "make_train_step_indexed",
           "make_train_step_indexed_multi", "train"]
