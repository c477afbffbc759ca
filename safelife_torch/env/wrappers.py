"""Environment wrappers over batched state (port of
``safelife_tpu.env.wrappers``).

Capability parity with ``safelife/env_wrappers.py``: wrapper state wraps
the inner state, ``step`` stays ``(state, bank, action, generator) ->
(state, TimeStep)``, and per-board resets (auto-reset inside the core env)
are handled with masked selects on the ``done`` flags.

Schedulable parameters: any numeric parameter may instead be a callable of
the global step count (a 0-dim int32 tensor on the env's device) — the
reference's ``scheduled()`` semantics (``env_wrappers.py:29-36``) — e.g.
built with :func:`linear_schedule`.

The reference's ``ContinuingEnv`` is native here: the core env auto-resets;
:class:`ContinuingWrapper` merely reports ``done`` only on ``times_up`` so
that value bootstrapping continues across episode boundaries
(``env_wrappers.py:289-303``).
"""

import dataclasses
from typing import Any

import numpy as np
import torch


def scheduled(val, num_steps):
    """Evaluate a possibly-scheduled parameter at the global step count."""
    return val(num_steps) if callable(val) else val


def linear_schedule(t, y):
    """Piecewise-linear schedule of the global step count
    (reference: ``training/safelife_ppo.py:16-17``), clamped to the end
    values outside the knots ``t``.  The step count stays on its device:
    the knots are copied there once per device, and no value is read back
    to the host."""
    t = np.asarray(t, np.float32)
    y = np.asarray(y, np.float32)
    knots = {}

    def sched(step):
        step = torch.as_tensor(step)
        if step.device not in knots:
            knots[step.device] = (torch.as_tensor(t, device=step.device),
                                  torch.as_tensor(y, device=step.device))
        xp, fp = knots[step.device]
        x = step.to(torch.float32).reshape(-1)
        # jnp.interp's formula, so that both packages give the same bits;
        # XLA fuses its last multiply-add (one rounding), which float64
        # reproduces: the float32 product is exact there.
        i = torch.searchsorted(xp, x, right=True).clamp(1, len(xp) - 1)
        x0, x1, f0, f1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
        dx = x1 - x0
        flat = dx.abs() <= np.spacing(np.finfo(np.float32).eps)
        q = (x - x0) / torch.where(flat, 1.0, dx)
        f = torch.where(flat, f0, (f0.double() + q.double()
                                   * (f1 - f0).double()).float())
        f = torch.where(x < xp[0], fp[0], f)
        return torch.where(x > xp[-1], fp[-1], f).reshape(step.shape)
    return sched


class Wrapper:
    """Base: delegates everything to the inner env."""

    def __init__(self, env):
        self.env = env

    @property
    def config(self):
        return self.env.config

    def observe(self, state):
        return self.env.observe(unwrap(state))

    def reset_all(self, bank, batch_size, generator=None):
        return self.env.reset_all(bank, batch_size, generator)

    def reset_to_levels(self, bank, idx):
        return self.env.reset_to_levels(bank, idx)

    def step(self, state, bank, action, generator=None, **kw):
        return self.env.step(state, bank, action, generator, **kw)


def unwrap(state):
    """Peel all wrapper layers -> the core EnvState."""
    while isinstance(state, WrapperState):
        state = state.inner
    return state


def unwrap_env(env):
    """Peel all wrapper layers -> the core BatchedSafeLifeEnv."""
    while isinstance(env, Wrapper):
        env = env.env
    return env


def replace_core(state, new_core):
    """Replace the core EnvState under any wrapper nesting."""
    if isinstance(state, WrapperState):
        return state.replace(inner=replace_core(state.inner, new_core))
    return new_core


@dataclasses.dataclass(frozen=True)
class WrapperState:
    inner: Any
    extra: dict

    def __getattr__(self, name):
        # Delegate state attribute access (num_steps, batch_size, ...) so
        # wrappers compose transparently.
        if name in ("inner", "extra"):  # not yet set (copy, unpickle)
            raise AttributeError(name)
        return getattr(self.inner, name)

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)


def _per_env(value, batch, device):
    """A (possibly scheduled, so tensor) scalar as a (B,) float32 tensor."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32).expand(batch)
    return torch.full((batch,), value, dtype=torch.float32, device=device)


class ContinuingWrapper(Wrapper):
    """done only on times_up; episodes otherwise roll straight through
    (the core env has already auto-reset).  Reference
    ``env_wrappers.py:289-303``."""

    def step(self, state, bank, action, generator=None, **kw):
        state, ts = self.env.step(state, bank, action, generator, **kw)
        return state, dataclasses.replace(ts, done=ts.times_up)


class MovementBonusWrapper(Wrapper):
    """Reward bonus for agent movement (``env_wrappers.py:39-94``).

    speed = L1 distance between the agent's position now and ``period``
    steps ago, divided by ``period``; at episode start the agent is treated
    as if it had been moving continuously before entering.
    bonus = movement_bonus * speed ** movement_bonus_power.

    The extra state holds the last ``period`` positions, (period, B) int32
    each, a per-env count since the episode began, and the step index
    ``t`` since reset, a host int (it advances by one every step, so the
    ring slot needs no device read).
    """

    def __init__(self, env, movement_bonus=0.1, movement_bonus_power=0.01,
                 movement_bonus_period=4):
        super().__init__(env)
        self.movement_bonus = movement_bonus
        self.movement_bonus_power = movement_bonus_power
        self.period = movement_bonus_period

    def _fresh(self, inner_state):
        core = unwrap(inner_state)
        n = self.period
        return dict(
            buf_row=core.agent_row.expand(n, -1).clone(),
            buf_col=core.agent_col.expand(n, -1).clone(),
            count=torch.ones(core.batch_size, dtype=torch.int32,
                             device=core.device),
            t=0)

    def reset_all(self, bank, batch_size, generator=None):
        inner = self.env.reset_all(bank, batch_size, generator)
        return WrapperState(inner=inner, extra=self._fresh(inner))

    def reset_to_levels(self, bank, idx):
        inner = self.env.reset_to_levels(bank, idx)
        return WrapperState(inner=inner, extra=self._fresh(inner))

    def step(self, state, bank, action, generator=None, **kw):
        n = self.period
        ex = state.extra
        inner, ts = self.env.step(state.inner, bank, action, generator, **kw)
        # Only per-env values of the pre-reset state are read: on the
        # kernel path its boards are already post-reset.
        mid = ts.state_before_reset
        p0r, p0c = mid.agent_row, mid.agent_col

        slot = ex["t"] % n
        p1r, p1c = ex["buf_row"][slot], ex["buf_col"][slot]
        dist = ((p0r - p1r).abs() + (p0c - p1c).abs()).to(torch.float32)
        dist = dist + (n - ex["count"]).clamp(min=0).to(torch.float32)
        speed = dist / n
        num_steps = mid.num_steps
        bonus = (scheduled(self.movement_bonus, num_steps)
                 * speed ** scheduled(self.movement_bonus_power, num_steps))
        ts = dataclasses.replace(ts, reward=ts.reward + bonus)

        buf_row = ex["buf_row"].clone()
        buf_col = ex["buf_col"].clone()
        buf_row[slot] = p0r
        buf_col[slot] = p0c
        # Where an episode ended, refill the buffer with the fresh (post-
        # reset) agent position — the reference reseeds its deque on reset.
        core = unwrap(inner)
        done = ts.done
        buf_row = torch.where(done[None, :], core.agent_row[None, :], buf_row)
        buf_col = torch.where(done[None, :], core.agent_col[None, :], buf_col)
        count = torch.where(done, 1, ex["count"] + 1).to(torch.int32)
        new_extra = dict(buf_row=buf_row, buf_col=buf_col, count=count,
                         t=ex["t"] + 1)
        return WrapperState(inner=inner, extra=new_extra), ts


class SideEffectPenaltyWrapper(Wrapper):
    """Penalize departures from the starting board
    (reference ``SimpleSideEffectPenalty``, ``env_wrappers.py:306-346``).

    Each step, count cells differing from the initial board — ignoring the
    agent-ish bits everywhere, exit cells, removed red life, and live cells
    on blue goals — and subtract ``penalty_coef * delta`` from the reward.
    The count is the step's ``side_effect_count``, from K2 on the kernel
    path and from ``ops/scoring.py:side_effect_count`` on the plain path.
    Also overrides each fresh episode's ``min_performance`` with the
    (schedulable) ``min_performance`` parameter.
    """

    def __init__(self, env, penalty_coef=0.0, min_performance=0.01):
        super().__init__(env)
        self.penalty_coef = penalty_coef
        self.min_performance = min_performance

    def _override_min_perf(self, core, done=None):
        mp = _per_env(scheduled(self.min_performance, core.num_steps),
                      core.batch_size, core.device)
        if done is not None:
            mp = torch.where(done, mp, core.min_performance)
        return core.replace(min_performance=mp)

    def _wrap_fresh(self, inner):
        core = self._override_min_perf(unwrap(inner))
        return WrapperState(
            inner=replace_core(inner, core),
            extra=dict(last_side_effect=torch.zeros(
                core.batch_size, dtype=torch.int32, device=core.device)))

    def reset_all(self, bank, batch_size, generator=None):
        return self._wrap_fresh(
            self.env.reset_all(bank, batch_size, generator))

    def reset_to_levels(self, bank, idx):
        return self._wrap_fresh(self.env.reset_to_levels(bank, idx))

    def step(self, state, bank, action, generator=None, **kw):
        inner, ts = self.env.step(state.inner, bank, action, generator, **kw)
        mid = ts.state_before_reset
        effect = ts.side_effect_count
        delta = (effect - state.extra["last_side_effect"]).to(torch.float32)
        coef = scheduled(self.penalty_coef, mid.num_steps)
        ts = dataclasses.replace(ts, reward=ts.reward - delta * coef)
        last = torch.where(ts.done, 0, effect).to(torch.int32)
        # Fresh episodes get the scheduled min_performance.
        core = self._override_min_perf(unwrap(inner), done=ts.done)
        return (WrapperState(inner=replace_core(inner, core),
                             extra=dict(last_side_effect=last)), ts)
