"""Refreshes of the GTrXL core's key/value cache a training batch: the
program's ``gtrxl.kv_refresh`` spans (each normalises and projects every
layer's whole memory ring, inside ``gtrxl.core``) in the profiled stretch.
None where the stretch holds none: a net without the GTrXL core, or a
program without the cache, whose every rollout step projects the rings."""

from portbench.harness import program_spans


def read(raw):
    found = program_spans.program_spans(raw, "train")
    if found is None:
        return None
    prof, spans = found
    n = sum(1 for name, _, _ in spans if name == "gtrxl.kv_refresh")
    return n / prof["units"] if n else None
