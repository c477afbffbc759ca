"""Share of the profiled training stretch in which no device op ran, in %."""

from portbench.harness import readers


def read(raw):
    return readers.idle_pct(raw, "train")
