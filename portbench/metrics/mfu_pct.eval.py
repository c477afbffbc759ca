"""Model FLOPs of the window's suites (the policy's forward passes) at the
peak of each op's precision over the window's time, in %."""

from portbench.harness import readers


def read(raw):
    return readers.mfu(raw, "eval")
