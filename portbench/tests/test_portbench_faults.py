"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, each fault a cell can have planted in
the program at a size the CPU holds (B = 8, short eval episodes),
judged by the cells' own limits."""

import dataclasses

import pytest
import torch

from conftest import small_context
from portbench.harness import common


def _run(ctx):
    entry = common.load_module(
        f"portbench/entries/{ctx.traffic['entry']}.py")
    entry.run(ctx)
    return ctx


def test_sound_runs_are_correct():
    ctx = _run(small_context("cnn-eval-prune-spawn"))
    assert ctx.correct, ctx.checks


@pytest.mark.parametrize("cell,number", [
    ("cnn-train-append-still-4096", "change1_gap"),
    ("lstm-train-append-still-4096", "change_gap")])
def test_state_left_unchanged(monkeypatch, cell, number):
    from safelife_torch.training import ppo
    monkeypatch.setattr(ppo.Optimizer, "step", lambda self: None)
    ctx = _run(small_context(cell))
    assert not ctx.correct
    readings = dict((n, v) for n, v, _ in ctx.checks)
    assert readings[number] == 1.0 and readings["grad_gap"] == 1.0


def test_half_the_batch_left_out(monkeypatch):
    from safelife_torch.training import ppo
    real = ppo.minibatch_rows

    def half(perms, k, mb):
        rows = real(perms, k, mb)
        return rows[: max(1, len(rows) // 2)]
    monkeypatch.setattr(ppo, "minibatch_rows", half)
    ctx = _run(small_context("cnn-train-append-still-4096", envs=16))
    assert not ctx.correct, ctx.checks


@pytest.mark.parametrize("cell", ["lstm-train-append-still-4096",
                                  "cnn-eval-prune-spawn"])
def test_an_answer_altered_where_it_is_produced(monkeypatch, cell):
    from safelife_torch.env import env as E
    real = E.BatchedSafeLifeEnv.step
    calls = []

    def step(self, *a, **kw):
        state, ts = real(self, *a, **kw)
        one = torch.zeros_like(ts.reward)
        one[0] = 1.0
        calls.append(1)
        if len(calls) >= 7:  # env 0's reward, as the step reports it
            ts = dataclasses.replace(ts, reward=ts.reward + one,
                                     episode_reward=ts.episode_reward + one)
        return state, ts
    monkeypatch.setattr(E.BatchedSafeLifeEnv, "step", step)
    ctx = _run(small_context(cell))
    assert not ctx.correct
    counts = dict((n, v) for n, v, _ in ctx.checks)
    assert counts.get("env_mismatches", counts.get("level_mismatches")) > 0


def test_an_observation_altered_where_it_is_produced(monkeypatch):
    """The eval replays the program's actions, so an observation at fault
    changes no record: its fingerprint has to catch it."""
    from safelife_torch.env import env as E
    real = E.BatchedSafeLifeEnv.step
    calls = []

    def step(self, *a, **kw):
        state, ts = real(self, *a, **kw)
        calls.append(1)
        if len(calls) >= 5:  # one byte of env 0's view, as the step gives it
            obs = ts.obs.clone()
            obs[0, 0, 0, 0] ^= 1
            ts = dataclasses.replace(ts, obs=obs)
        return state, ts
    monkeypatch.setattr(E.BatchedSafeLifeEnv, "step", step)
    ctx = _run(small_context("cnn-eval-prune-spawn"))
    assert not ctx.correct
    assert dict((n, v) for n, v, _ in ctx.checks)["level_mismatches"] > 0


@pytest.mark.parametrize("cell", ["cnn-train-append-still-4096",
                                  "lstm-train-append-still-4096"])
def test_the_batches_run_inside_trainer_train(monkeypatch, cell):
    """Every batch of the run, the check batches and the window's, goes
    through one call of the program's own ``Trainer.train``."""
    from safelife_torch.training import driver
    real = driver.Trainer.train
    inside = {"calls": 0, "depth": 0, "outside": 0}

    def train(self, *a, **kw):
        inside["calls"] += 1
        inside["depth"] += 1
        try:
            return real(self, *a, **kw)
        finally:
            inside["depth"] -= 1
    monkeypatch.setattr(driver.Trainer, "train", train)
    from safelife_torch.training import ppo
    for cls in (ppo.PPO, ppo.RecurrentPPO):
        def wrap(fn):
            def batch(self, *a, **kw):
                inside["outside"] += inside["depth"] == 0
                return fn(self, *a, **kw)
            return batch
        monkeypatch.setattr(cls, "train_batch", wrap(cls.train_batch))
    ctx = _run(small_context(cell))
    # The env replays exactly; the learner's gaps at B = 8 are not the card's.
    assert dict((n, v) for n, v, _ in ctx.checks)["env_mismatches"] == 0
    assert inside == {"calls": 1, "depth": 0, "outside": 0}
    assert ctx.attempted >= 1
