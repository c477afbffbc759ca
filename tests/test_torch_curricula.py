"""The port's training curricula (``safelife_torch.training.curricula``)
against the JAX package's on the CPU, for every task of ``TASKS``: the
schedules at their ramp ends, ``lr_decay_steps``, the first procgen bank
bit for bit (the same host procgen and seed), the scheduled switch to the
next source through ``Trainer._maybe_switch_bank``, and one background
refresh through ``Trainer._maybe_refresh_bank``, each bank equal to the
JAX package's ``gen_bank`` with the next seed.  The JAX side's ``Trainer``
is replaced by a recorder of its arguments: only the curriculum is
compared here, each trainer has tests of its own.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from safelife_torch.training import curricula as tcur
from safelife_torch.training.ppo import PPOConfig as TPPOConfig
from safelife_tpu.training import curricula as jcur
from safelife_tpu.training.ppo import PPOConfig as JPPOConfig

torch.set_num_threads(1)

FLAGS = ("static_goals", "spawnless", "simple_goals", "spawn_simple_goals")
LEVELS = 1
SEED = 7
PPO = dict(steps_per_env=4, num_minibatches=2, epochs_per_batch=1)


class Recorder:
    """Stands in for the JAX package's Trainer: keeps its arguments."""

    def __init__(self, cfg, ppo_cfg, bank=None, bank_schedule=None,
                 bank_factory=None):
        self.cfg, self.ppo_cfg, self.bank = cfg, ppo_cfg, bank
        self.bank_schedule = bank_schedule or []
        self.bank_factory = bank_factory


def assert_same_bank(got, want):
    got = got.to_numpy()
    for f in dataclasses.fields(want):
        value = jax.device_get(getattr(want, f.name))
        if f.name in FLAGS:
            assert got[f.name] == value, f.name
        else:
            np.testing.assert_array_equal(got[f.name], np.asarray(value),
                                          err_msg=f.name)


def schedule_values(sched, ends):
    """A schedule at its ramp ends, between them and outside them."""
    if not callable(sched):
        return [sched]
    t0, t1 = ends
    steps = [0.0, t0, (t0 + t1) / 2, t1, 10 * t1]
    return [np.float32(sched(np.float32(s))) for s in steps]


@pytest.mark.parametrize("task", sorted(tcur.TASKS))
def test_curriculum_matches_jax(task, monkeypatch):
    assert (dataclasses.astuple(tcur.TASKS[task])
            == dataclasses.astuple(jcur.TASKS[task]))
    monkeypatch.setattr(jcur, "Trainer", Recorder)
    kw = dict(impact_penalty=0.5, num_envs=4, bank_levels=LEVELS,
              seed=SEED, fresh_levels_every=64, view_shape=(17, 17),
              record_videos=False)
    trainer, total = tcur.make_curriculum_trainer(
        task, ppo_cfg=TPPOConfig(**PPO), device="cpu", **kw)
    want, want_total = jcur.make_curriculum_trainer(
        task, ppo_cfg=JPPOConfig(**PPO), **kw)
    spec = tcur.TASKS[task]

    assert total == want_total
    assert trainer.ppo_cfg.lr_decay_steps == want.ppo_cfg.lr_decay_steps > 0
    for name in ("num_envs", "total_steps", "seed", "eval_suite",
                 "fresh_levels_every", "view_shape"):
        assert getattr(trainer.cfg, name) == getattr(want.cfg, name), name
    for name, ends in (("impact_penalty", spec.impact_penalty_ramp),
                       ("min_performance", spec.min_performance_ramp)):
        got = schedule_values(getattr(trainer.cfg, name), ends)
        np.testing.assert_array_equal(
            got, schedule_values(getattr(want.cfg, name), ends), name)
    assert trainer.device.type == "cpu"
    assert_same_bank(trainer.bank, want.bank)

    # JAX's factories share one seed counter, as the port's do: the
    # switch draws seed + 1, the refresh after it seed + 2.
    steps = [step for step, _ in trainer.bank_schedule]
    assert steps == [step for step, _ in want.bank_schedule]
    if steps:
        trainer._steps_offset = int(steps[0])
        trainer._maybe_switch_bank()
        assert not trainer.bank_schedule
        assert_same_bank(trainer.bank, want.bank_schedule[0][1]())
        next_bank = want.bank_schedule[0][1]
    else:
        next_bank = want.bank_factory
    step = trainer.global_step()
    trainer._next_refresh = step
    trainer._maybe_refresh_bank(step)  # starts the regeneration thread
    thread, _ = trainer._refresher
    thread.join(timeout=120)
    assert not thread.is_alive()
    before = trainer.bank
    trainer._maybe_refresh_bank(step)  # swaps the fresh bank in
    assert trainer.bank is not before
    assert_same_bank(trainer.bank, next_bank())
