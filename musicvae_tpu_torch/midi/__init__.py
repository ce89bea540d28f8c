"""MIDI codec and tensorization (normative semantics:
musicvae_tpu/midi/SEMANTICS.md)."""

from musicvae_tpu_torch.midi.smf import (  # noqa: F401
    MidiFile, Note, SMFError, parse_smf, write_smf,
)
from musicvae_tpu_torch.midi.tensorize import (  # noqa: F401
    bars_to_midi_bytes,
    chunk_bars,
    crop_view,
    events_to_roll,
    midi_bytes_to_bars,
    notes_to_events,
    pitch_mask,
    quantize_ticks,
    roll_to_notes,
)
