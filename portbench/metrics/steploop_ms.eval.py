"""Milliseconds a suite in the step loop, run_benchmark's own wall_time."""

from portbench.harness import readers


def read(raw):
    return readers.mean_ms(raw, "eval", "suite_wall")
