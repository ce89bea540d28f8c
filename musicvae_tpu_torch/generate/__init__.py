from musicvae_tpu_torch.generate.sampler import (  # noqa: F401
    bars_to_midi, latent_path, make_coalesced_generate_fn, make_encode_fn,
    make_generate_fn, reconstruct_fn,
)
