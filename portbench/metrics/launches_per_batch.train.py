"""Kernel launches a training batch, PyTorch's and the port's alike, from
the profile."""

from portbench.harness import readers


def read(raw):
    return readers.launches(raw, "train")
