"""Numerical ops: losses (plain torch and the CUDA masked-BCE/KL kernels),
binarize, bit-packing, and the first-conv kernel."""

from musicvae_tpu_torch.ops.binarize import (  # noqa: F401
    binarize_logits, sample_bernoulli_logits,
)
from musicvae_tpu_torch.ops.conv1 import first_conv_s2  # noqa: F401
from musicvae_tpu_torch.ops.losses import (  # noqa: F401
    bce_with_logits,
    beta_schedule,
    elbo_loss,
    kl_diag_gaussian,
    kl_free_bits,
    masked_bce_sum,
)
