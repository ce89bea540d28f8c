"""The VAE model family."""

from musicvae_tpu_torch.models.latent import reparameterize, slerp  # noqa: F401
from musicvae_tpu_torch.models.vae import (  # noqa: F401
    BarDecoder, PianoRollVAE, build_model, init_params,
)
