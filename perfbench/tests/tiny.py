"""Small shapes of the measured configurations for the CPU tests: every
width cut, f32 (or bf16 where asked), a corpus of a few pieces, and the
serve mix at a load a CPU serves."""

import copy

from perfbench import harness


def spec(config: str, dtype: str = "float32") -> dict:
    s = copy.deepcopy(harness.load_json(
        f"{harness.BENCH}/configs/{config}.json"))
    s["model"].update(enc_channels=[4, 8, 8, 8, 8],
                      dec_channels=[8, 8, 8, 8, 4], bar_feat_dim=16,
                      gru_hidden=16, z_dim=8, z_phrase_dim=12, dtype=dtype)
    if s["model"]["kind"] == "hier":
        s["model"]["num_bars"] = 4
    s["train"]["batch_size"] = 4
    return s


def ctx(workload: str, seed: int = 2 ** 31 + 12345, seconds: float = 0.1,
        trace: bool = False, dtype: str = "float32",
        traffic: str = None) -> harness.Ctx:
    """A CPU run of ``workload`` at small shapes (train cells) or small
    load (serve cells, whose server runs the configuration as it is);
    ``traffic`` puts another mix file in the cell's."""
    w, s, mix = harness.cell(harness.benchmark(), workload)
    if traffic is not None:
        mix = harness.load_json(f"{harness.BENCH}/mixes/{traffic}.json")
    if mix["runner"] == "train":
        s = spec(w["config"], dtype)
        mix = dict(mix, pieces=8, bars_per_piece=8, trace_dispatches=1)
    else:
        mix = dict(mix, coalesce=2, rate_per_s=1.0, connections=4,
                   warmup_requests=2, check_requests=2, trace_seconds=2.0)
        seconds = 2.0
    return harness.Ctx(workload, s, mix, seed, seconds, trace, "cpu", 1)
