"""Milliseconds a batch in GAE and the PPO update (training/ppo.py
compute_gae, PPO.update, RecurrentPPO.update), spanned by the benchmark
and ended by a synchronise."""

from portbench.harness import readers


def read(raw):
    return readers.span_ms(raw, "train", ("compute_gae", "update"))
