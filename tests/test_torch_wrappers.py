"""The port's wrappers against the JAX wrappers: the training stack
(``make_training_env``) and each wrapper alone, on append-still and
append-dynamic at the 33x33 training view, B = 8, 32 steps with resets.
Both sides take the same actions and fresh levels (the JAX env on its
plain path); rewards, done, observations, the wrappers' extra state and
the scheduled ``min_performance`` must be exactly equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safelife_torch.env import wrappers as TW
from safelife_torch.env.env import BatchedSafeLifeEnv as TorchEnv
from safelife_torch.env.env import EnvConfig as TorchConfig
from safelife_torch.levels import loader as tloader
from safelife_torch.training.driver import TrainerConfig, make_training_env
from safelife_tpu.env import wrappers as JW
from safelife_tpu.env.env import BatchedSafeLifeEnv as JaxEnv
from safelife_tpu.env.env import EnvConfig as JaxConfig
from safelife_tpu.levels import loader as jloader

torch.set_num_threads(1)

B = 8
STEPS = 32
VIEW = (33, 33)
TIME_LIMIT = 12
# Schedules that move inside the run (the global step reaches B * STEPS).
PENALTY = ([0, 64, 160], [0.0, 1.0, 0.25])
MIN_PERF = ([0, 100], [0.5, 0.05])


def _stack(W, env, which, sched):
    if which in ("training", "movement"):
        env = W.MovementBonusWrapper(env, movement_bonus=0.1)
    if which in ("training", "penalty"):
        env = W.SideEffectPenaltyWrapper(
            env, penalty_coef=sched(*PENALTY),
            min_performance=sched(*MIN_PERF))
    if which in ("training", "continuing"):
        env = W.ContinuingWrapper(env)
    return env


def _core(env):
    while hasattr(env, "env"):
        env = env.env
    return env


def _extras(state):
    """Every wrapper layer's extra state as numpy, outermost first."""
    out = []
    while isinstance(state, (TW.WrapperState, JW.WrapperState)):
        out.append({k: np.asarray(v) for k, v in state.extra.items()})
        state = state.inner
    return out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("suite", ["append-still", "append-dynamic"])
@pytest.mark.parametrize("which",
                         ["training", "movement", "penalty", "continuing"])
def test_wrapped_rollout_matches_jax(suite, which):
    path = f"benchmarks/v1.0/{suite}"
    jbank = jloader.load_bank(path)
    bank = tloader.load_bank(path, device="cpu")
    jenv = _stack(JW, JaxEnv(JaxConfig(
        view_shape=VIEW, time_limit=TIME_LIMIT, use_pallas=False)), which,
        JW.linear_schedule)
    if which == "training":
        env = make_training_env(TrainerConfig(
            view_shape=VIEW, time_limit=TIME_LIMIT,
            impact_penalty=TW.linear_schedule(*PENALTY),
            min_performance=TW.linear_schedule(*MIN_PERF)), device="cpu")
    else:
        env = _stack(TW, TorchEnv(TorchConfig(
            view_shape=VIEW, time_limit=TIME_LIMIT), device="cpu"), which,
            TW.linear_schedule)
    assert env.config.use_kernels  # the stack keeps the kernels on

    rng = np.random.RandomState(21)
    start = rng.randint(0, bank.num_levels, B)
    fresh_idx = rng.randint(0, bank.num_levels, B)
    jfresh = (jnp.asarray(fresh_idx), _core(jenv)._fresh_state_fields(
        jbank, jnp.asarray(fresh_idx)))
    fresh = _core(env).fresh_levels(bank, fresh_idx)

    jstate = jenv.reset_to_levels(jbank, jnp.asarray(start))
    state = env.reset_to_levels(bank, start)
    key = jax.random.key(0)
    done_steps = 0
    for step in range(STEPS):
        action = rng.randint(0, 9, B)
        jstate, jts = jenv.step(jstate, jbank, jnp.asarray(action), key,
                                fresh_levels=jfresh)
        state, ts = env.step(state, bank, torch.as_tensor(action),
                             fresh_levels=fresh)
        for name in ("reward", "done", "times_up", "obs",
                     "side_effect_count"):
            got, want = _np(getattr(ts, name)), _np(getattr(jts, name))
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"step {step}: {name}")
            assert got.dtype == want.dtype, name
        got, want = _extras(state), _extras(jstate)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], w[k],
                                              err_msg=f"step {step}: {k}")
        np.testing.assert_array_equal(
            _np(TW.unwrap(state).min_performance),
            _np(JW.unwrap(jstate).min_performance))
        done_steps += int(np.asarray(jts.done).any())
    assert done_steps >= 2  # episodes ended, and were reset, on the way


def test_linear_schedule_matches_jnp_interp():
    """Bit for bit, at and between the knots and outside them (XLA fuses
    the interpolation's multiply-add: 277 of these steps differ in the
    last bit without the port's emulation of it)."""
    t, y = [0, 10, 20, 20, 50, 1000], [1.0, 3.0, -2.0, 4.0, 0.5, 0.1234]
    steps = np.arange(-5, 1100, dtype=np.int32)
    jsched, tsched = JW.linear_schedule(t, y), TW.linear_schedule(t, y)
    np.testing.assert_array_equal(tsched(torch.as_tensor(steps)).numpy(),
                                  np.asarray(jsched(jnp.asarray(steps))))
    for s in (-5, 0, 15, 19, 20, 777, 1000, 5000):
        got = tsched(torch.tensor(s, dtype=torch.int32))
        assert got.shape == () and got.dtype == torch.float32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jsched(jnp.int32(s))), err_msg=str(s))
    # At its knots a schedule takes the knot's value (the later one where
    # two knots share a step).
    np.testing.assert_array_equal(
        tsched(torch.tensor([0, 10, 20, 50, 1000])).numpy(),
        np.float32([1.0, 3.0, 4.0, 0.5, 0.1234]))


def test_wrapper_state_delegates_to_the_core():
    bank = tloader.load_bank("benchmarks/v1.0/append-still", device="cpu")
    env = make_training_env(TrainerConfig(view_shape=VIEW), device="cpu")
    state = env.reset_all(bank, B, torch.Generator().manual_seed(0))
    core = TW.unwrap(state)
    assert state.num_steps is core.num_steps
    assert state.batch_size == B
    assert env.observe(state).shape == (B, *VIEW, 15)
    swapped = TW.replace_core(state, dataclasses.replace(
        core, num_steps=core.num_steps + 5))
    assert int(TW.unwrap(swapped).num_steps) == 5
    assert swapped.extra is state.extra
