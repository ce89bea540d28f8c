"""The MIDI export of one response: the spans the server records around
each call to ``bars_to_midi`` (generate/sampler.py → midi/tensorize.py,
midi/smf.py; one call a sample), summed over a response's samples and
averaged over the responses of the traced window."""


def read(run):
    t = run.trace
    spans = t.get("export_s")
    if not spans:
        return None
    return 1e3 * sum(spans) * t["samples"] / len(spans)
