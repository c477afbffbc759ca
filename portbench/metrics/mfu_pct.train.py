"""Model FLOPs of the window's batches at the peak of each op's precision
over the window's time, in %."""

from portbench.harness import readers


def read(raw):
    return readers.mfu(raw, "train")
