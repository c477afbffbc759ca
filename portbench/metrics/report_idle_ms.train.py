"""Device idle ms a training batch while the training loop gathers and
logs its report (the train.report span), from the profiled stretch."""

from portbench.harness import program_spans


def read(raw):
    idle = program_spans.idle_ms(raw, "train")
    return None if idle is None else idle["train.report"]
