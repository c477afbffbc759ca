"""Milliseconds a suite in side-effect scoring, run_benchmark's own
side_effect_time (co-evolution and Sinkhorn)."""

from portbench.harness import readers


def read(raw):
    return readers.mean_ms(raw, "eval", "side_effect")
