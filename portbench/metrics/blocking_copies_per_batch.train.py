"""Copies to or from pageable host memory a training batch (the profile's
Memcpy ops with Pageable in their name) in the profiled stretch that the
program's spans cover: each one waits for the stream to drain."""

from portbench.harness import program_spans


def read(raw):
    return program_spans.pageable_copies(raw, "train")
