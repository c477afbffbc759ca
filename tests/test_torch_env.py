"""The port's environment as a whole against the JAX environment: 12-step
rollouts with auto-resets, every state leaf and every TimeStep field equal
at every step; on banks with dynamic goals and spawners both take the
same spawn fields."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safelife_torch.env.env import BatchedSafeLifeEnv as TorchEnv
from safelife_torch.env.env import EnvConfig as TorchConfig
from safelife_torch.levels import loader as tloader
from safelife_torch.levels import synth as tsynth
from safelife_tpu.env.env import BatchedSafeLifeEnv as JaxEnv
from safelife_tpu.env.env import EnvConfig as JaxConfig
from safelife_tpu.levels import loader as jloader
from safelife_tpu.levels import synth as jsynth

# The tensors here are small.  One thread keeps torch from leaving an
# OpenMP pool in the test process that slows the JAX tests run after it.
torch.set_num_threads(1)

B = 128
STEPS = 12


def _flat(prefix, obj):
    """{name: numpy} of a state or time step, nested fields prefixed."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None:
            continue
        if dataclasses.is_dataclass(v):
            out.update(_flat(f"{prefix}{f.name}.", v))
        elif isinstance(v, torch.Tensor):
            out[prefix + f.name] = v.numpy()
        else:
            out[prefix + f.name] = np.asarray(jax.device_get(v))
    return out


def _banks(suite):
    """The JAX bank and the port's bank on the CPU."""
    if suite == "stress":
        return (jsynth.synth_bank(8, spawners=True, dynamic_goals=True),
                tsynth.synth_bank(8, spawners=True, dynamic_goals=True,
                                  device="cpu"))
    path = f"benchmarks/v1.0/{suite}"
    return jloader.load_bank(path), tloader.load_bank(path, device="cpu")


def _assert_same(state, ts, jstate, jts, step):
    want = {**_flat("state.", jstate), **_flat("ts.", jts)}
    got = {**_flat("state.", state), **_flat("ts.", ts)}
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name],
                                      err_msg=f"step {step}: {name}")
        assert got[name].dtype == want[name].dtype, name


@pytest.mark.parametrize("suite,cfg", [
    ("append-still", dict(view_shape=(15, 15))),
    ("append-still", dict(view_shape=(33, 33))),
    ("prune-still", dict(view_shape=(15, 15))),
    ("append-still", dict(view_shape=(15, 15), auto_reset=False)),
])
def test_rollout_matches_jax(suite, cfg):
    path = f"benchmarks/v1.0/{suite}"
    cfg = dict(time_limit=6, **cfg)
    jbank = jloader.load_bank(path)
    bank = tloader.load_bank(path, device="cpu")
    jenv = JaxEnv(JaxConfig(use_pallas=False, **cfg))
    env = TorchEnv(TorchConfig(**cfg), device="cpu")
    rng = np.random.RandomState(9)
    start = rng.randint(0, bank.num_levels, B)
    fresh_idx = rng.randint(0, bank.num_levels, B)
    actions = rng.randint(0, 9, (STEPS, B))

    jstate = jenv.reset_to_levels(jbank, jnp.asarray(start))
    jfresh = (jnp.asarray(fresh_idx),
              jenv._fresh_state_fields(jbank, jnp.asarray(fresh_idx)))
    state = env.reset_to_levels(bank, start)
    fresh = env.fresh_levels(bank, fresh_idx)
    key = jax.random.key(0)
    resets = 0
    for step in range(STEPS):
        jstate, jts = jenv.step(jstate, jbank, jnp.asarray(actions[step]),
                                key, fresh_levels=jfresh)
        state, ts = env.step(state, bank, actions[step], fresh_levels=fresh)
        _assert_same(state, ts, jstate, jts, step)
        resets += int(ts.done.sum())
    assert resets > 0


@pytest.mark.parametrize("suite", ["append-dynamic", "navigation", "stress"])
def test_rollout_with_spawn_fields_matches_jax(suite):
    """Dynamic goals and spawners: the same numpy spawn fields go to both
    environments, for the board and for the goal board."""
    cfg = dict(time_limit=6, view_shape=(15, 15))
    jbank, bank = _banks(suite)
    assert not bank.static_goals
    jenv = JaxEnv(JaxConfig(use_pallas=False, **cfg))
    env = TorchEnv(TorchConfig(**cfg), device="cpu")
    rng = np.random.RandomState(10)
    start = rng.randint(0, bank.num_levels, B)
    fresh_idx = rng.randint(0, bank.num_levels, B)
    jstate = jenv.reset_to_levels(jbank, jnp.asarray(start))
    jfresh = (jnp.asarray(fresh_idx),
              jenv._fresh_state_fields(jbank, jnp.asarray(fresh_idx)))
    state = env.reset_to_levels(bank, start)
    fresh = env.fresh_levels(bank, fresh_idx)
    key = jax.random.key(0)
    for step in range(STEPS):
        action = rng.randint(0, 9, B)
        fb, fg = (rng.random(bank.board.shape[:2] + (B,)) < 0.3
                  for _ in range(2))
        jstate, jts = jenv.step(jstate, jbank, jnp.asarray(action), key,
                                spawn_board=jnp.asarray(fb),
                                spawn_goals=jnp.asarray(fg),
                                fresh_levels=jfresh)
        state, ts = env.step(state, bank, action,
                             spawn_board=torch.as_tensor(fb),
                             spawn_goals=torch.as_tensor(fg),
                             fresh_levels=fresh)
        _assert_same(state, ts, jstate, jts, step)
