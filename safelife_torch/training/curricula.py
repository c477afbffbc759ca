"""Per-task training curricula (port of
``safelife_tpu.training.curricula``).

Capability parity with the reference's ``start-training`` launcher
(``start-training:169-239``): each benchmark task gets scheduled impact
penalties, scheduled ``min_performance``, a training budget, and — for the
spawn tasks — a level curriculum that pre-trains on easy static levels
before switching to stochastic spawn levels (``spawn_loader``,
``start-training:169-184``).

In the batched world a curriculum is a schedule of level *banks* rather
than a generator swap; the Trainer swaps the device-resident bank when the
global step crosses a threshold.
"""

import dataclasses
from typing import Any, Optional, Tuple

from .. import resolve_device
from ..env.wrappers import linear_schedule
from .driver import Trainer, TrainerConfig
from .ppo import PPOConfig


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    total_steps: float
    impact_penalty_ramp: Tuple[float, float]   # steps over which penalty ramps
    min_performance_ramp: Optional[Tuple[float, float]]  # None = fixed
    level_sources: Tuple[Tuple[float, str], ...]  # (start_step, task name)


# Schedules mirror start-training:197-236.
TASKS = {
    "append-still": TaskSpec(
        total_steps=10e6,
        impact_penalty_ramp=(1.0e6, 2.0e6),
        min_performance_ramp=(1.0e6, 2.0e6),
        level_sources=((0, "append-still-easy"),),
    ),
    "prune-still": TaskSpec(
        total_steps=6e6,
        impact_penalty_ramp=(0.5e6, 1.5e6),
        min_performance_ramp=(0.5e6, 1.5e6),
        level_sources=((0, "prune-still-easy"),),
    ),
    "append-spawn": TaskSpec(
        total_steps=10e6,
        impact_penalty_ramp=(2.0e6, 3.5e6),
        min_performance_ramp=(1.0e6, 2.0e6),
        level_sources=((0, "append-still-easy"), (2.0e6, "append-spawn")),
    ),
    "prune-spawn": TaskSpec(
        total_steps=6e6,
        impact_penalty_ramp=(1.5e6, 2.5e6),
        min_performance_ramp=(0.5e6, 1.5e6),
        level_sources=((0, "prune-still-easy"), (1.5e6, "prune-spawn")),
    ),
    "navigation": TaskSpec(
        total_steps=6e6,
        impact_penalty_ramp=(1.0e6, 2.0e6),
        min_performance_ramp=None,
        level_sources=((0, "navigation"),),
    ),
    # The reference's launcher only covers the five env types above
    # (start-training:195-236); the remaining benchmark suites get
    # schedules analogous to their still/spawn counterparts.  The dynamic
    # tasks pre-train on easy static levels before switching, like the
    # spawn curriculum (start-training:169-184).
    "append-dynamic": TaskSpec(
        total_steps=10e6,
        impact_penalty_ramp=(1.0e6, 2.0e6),
        min_performance_ramp=(1.0e6, 2.0e6),
        level_sources=((0, "append-still-easy"), (1.5e6, "append-dynamic")),
    ),
    "prune-dynamic": TaskSpec(
        total_steps=6e6,
        impact_penalty_ramp=(0.5e6, 1.5e6),
        min_performance_ramp=(0.5e6, 1.5e6),
        level_sources=((0, "prune-still-easy"), (1.0e6, "prune-dynamic")),
    ),
    "prune-still-hard": TaskSpec(
        total_steps=6e6,
        impact_penalty_ramp=(0.5e6, 1.5e6),
        min_performance_ramp=(0.5e6, 1.5e6),
        level_sources=((0, "prune-still-easy"), (1.0e6, "prune-still-hard")),
    ),
}


def _bank_factory(source, num_levels, seed, device):
    from ..procgen import gen_bank

    def make():
        return gen_bank(source, num_levels=num_levels, seed=seed,
                        device=device)
    return make


def make_curriculum_trainer(
        task, impact_penalty=0.0, logdir=None, num_envs=16,
        bank_levels=100, seed=0, ppo_cfg: PPOConfig = PPOConfig(),
        fresh_levels_every=250_000, eval_suite="auto", device=None,
        mesh=None, **cfg_overrides) -> Tuple[Trainer, float]:
    """Build a Trainer configured for one benchmark task on ``device``
    (``cuda`` unless the caller passes another; the mesh's device on a
    ``mesh``, where rank 0 makes the banks and ``ppo_cfg.data_shards``
    must be the world size).

    Returns (trainer, total_steps).  The level banks are procedurally
    generated (``bank_levels`` levels each) and — unless
    ``fresh_levels_every=0`` — regenerated on a background thread every
    that many env steps, so training sees an endless level stream like the
    reference's ``safelife_loader`` (file_finder.py:143-201) rather than a
    closed 100-level set.  Spawn tasks switch banks at the reference's
    curriculum thresholds.  ``eval_suite="auto"`` evaluates on the task's
    frozen benchmark suite at every checkpoint.
    """
    device = resolve_device(
        device if device is not None or mesh is None else mesh.device)
    spec = TASKS[task]
    t0, t1 = spec.impact_penalty_ramp
    penalty_sched = linear_schedule([t0, t1], [0.0, impact_penalty])
    if spec.min_performance_ramp:
        m0, m1 = spec.min_performance_ramp
        min_perf_sched: Any = linear_schedule([m0, m1], [0.01, 0.3])
    else:
        min_perf_sched = 0.01

    if eval_suite == "auto":
        eval_suite = task if task != "navigation" else "navigation"

    if ppo_cfg.lr_decay_steps == 0:
        # Decay the LR to 10% over the run (in optimizer updates) — fixes
        # the late-run performance sag of the constant-LR reference config.
        updates_per_batch = ppo_cfg.epochs_per_batch * ppo_cfg.num_minibatches
        steps_per_batch = ppo_cfg.steps_per_env * num_envs
        total_updates = int(spec.total_steps / steps_per_batch
                            * updates_per_batch)
        ppo_cfg = dataclasses.replace(ppo_cfg, lr_decay_steps=total_updates)

    cfg = TrainerConfig(
        num_envs=num_envs,
        total_steps=int(spec.total_steps),
        impact_penalty=penalty_sched,
        min_performance=min_perf_sched,
        seed=seed,
        logdir=logdir,
        eval_suite=eval_suite,
        fresh_levels_every=int(fresh_levels_every),
        **cfg_overrides)

    start_step, first = spec.level_sources[0]
    assert start_step == 0
    # Fresh regenerations draw a new seed each time — an endless stream,
    # not 100 fixed levels reshuffled.
    seed_box = [seed]

    def factory_for(src):
        def make():
            seed_box[0] += 1
            return _bank_factory(src, bank_levels, seed_box[0], device)()
        return make

    bank = (_bank_factory(first, bank_levels, seed, device)()
            if mesh is None or mesh.rank == 0 else None)
    schedule = [(step, factory_for(src))
                for step, src in spec.level_sources[1:]]
    trainer = Trainer(cfg, ppo_cfg, bank=bank, bank_schedule=schedule,
                      bank_factory=factory_for(first), device=device,
                      mesh=mesh)
    return trainer, spec.total_steps
