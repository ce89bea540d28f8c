from musicvae_tpu_torch.data.dataset import (  # noqa: F401
    HostLocalBatches, PianoRollDataset,
)
from musicvae_tpu_torch.data.synthetic import (  # noqa: F401
    synth_corpus, synth_midi,
)
