"""Device idle ms a training batch while the program is in its PPO update
(the ppo.update span and its minibatches), from the profiled stretch."""

from portbench.harness import program_spans


def read(raw):
    idle = program_spans.idle_ms(raw, "train")
    return None if idle is None else idle["ppo.update"]
