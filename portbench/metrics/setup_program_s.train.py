"""Seconds of the run's set-up in the program's top-level setup.* spans:
the Trainer's build, the integrity guard and the kernel libraries' first
loads."""

from portbench.harness import program_spans


def read(raw):
    return program_spans.setup_s(raw, "train")
