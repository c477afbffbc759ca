"""The port's environment as a whole against the JAX environment: a
12-step rollout with auto-resets, every state leaf and every TimeStep
field equal at every step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safelife_torch.env.env import BatchedSafeLifeEnv as TorchEnv
from safelife_torch.env.env import EnvConfig as TorchConfig
from safelife_torch.levels import loader as tloader
from safelife_tpu.env.env import BatchedSafeLifeEnv as JaxEnv
from safelife_tpu.env.env import EnvConfig as JaxConfig
from safelife_tpu.levels import loader as jloader

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
        want = {**_flat("state.", jstate), **_flat("ts.", jts)}
        got = {**_flat("state.", state), **_flat("ts.", ts)}
        assert got.keys() == want.keys()
        for name in want:
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=f"step {step}: {name}")
            assert got[name].dtype == want[name].dtype, name
        resets += int(ts.done.sum())
    assert resets > 0
