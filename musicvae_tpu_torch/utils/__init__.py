from musicvae_tpu_torch.utils.debug import debug_mode  # noqa: F401
from musicvae_tpu_torch.utils.logging import MetricsLogger  # noqa: F401
