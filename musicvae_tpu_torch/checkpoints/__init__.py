from musicvae_tpu_torch.checkpoints.io import (  # noqa: F401
    config_from_json, config_to_json, make_manager, restore,
    restore_config, save,
)
