"""musicvae_tpu_torch — the PyTorch / CUDA port of musicvae_tpu.

A package of its own beside the JAX one, imported from the repo root. It
imports torch and numpy, never jax or musicvae_tpu. Entry points run on
the card (``device="cuda"``) unless the caller asks for the CPU; the
first-conv and masked-BCE kernels are hand-written CUDA for sm_90a
(csrc/), built at first use.
"""

from musicvae_tpu_torch.config import (  # noqa: F401
    Config,
    C1_CONV_BAR,
    C2_GRU_4BAR,
    C3_HIER_16BAR,
    C4_COND,
    C5_GEN_SWEEP,
    get_config,
)
