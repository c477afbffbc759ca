"""Copies to or from pageable host memory a suite evaluation (the
profile's Memcpy ops with Pageable in their name) in the profiled suite
that the program's spans cover."""

from portbench.harness import program_spans


def read(raw):
    return program_spans.pageable_copies(raw, "eval")
