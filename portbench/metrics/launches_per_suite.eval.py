"""Kernel launches a suite evaluation, PyTorch's and the port's alike, from
the profile."""

from portbench.harness import readers


def read(raw):
    return readers.launches(raw, "eval")
