"""Milliseconds a batch in the PPO rollout (training/ppo.py rollout,
rollout_recurrent), spanned by the benchmark and ended by a synchronise."""

from portbench.harness import readers


def read(raw):
    return readers.span_ms(raw, "train", ("rollout", "rollout_recurrent"))
