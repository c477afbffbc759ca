"""The port's level banks and state containers against the JAX package's:
every leaf and all four rule flags, and the numpy round trips."""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import safelife_torch.cells as TC
import safelife_tpu.cells as C
from safelife_torch.env import state as tstate
from safelife_torch.env.env import BatchedSafeLifeEnv as TorchEnv
from safelife_torch.levels import loader as tloader
from safelife_tpu.env import state as jstate
from safelife_tpu.env.env import BatchedSafeLifeEnv as JaxEnv
from safelife_tpu.levels import loader as jloader
from safelife_tpu.levels import synth

# The tensors here are small.  One thread keeps torch from leaving an
# OpenMP pool in the test process that slows the JAX tests run after it.
torch.set_num_threads(1)

GOLDEN_V1 = os.path.join(os.path.dirname(__file__), "golden", "levels",
                         "benchmarks", "v1.0")
SUITES = (sorted(glob.glob(os.path.join(jloader.PACKAGED_LEVELS, "benchmarks",
                                        "v1.0", "*.npz")))
          + sorted(glob.glob(os.path.join(GOLDEN_V1, "*.npz"))))
FLAGS = ("static_goals", "spawnless", "simple_goals", "spawn_simple_goals")


def jax_fields(obj):
    """A JAX bank or state as {field: numpy array or flag}."""
    return {f.name: jax.device_get(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def assert_same_fields(got, want):
    assert set(got) == set(want)
    for name, value in want.items():
        if name in FLAGS:
            assert got[name] == value, name
        else:
            np.testing.assert_array_equal(got[name], np.asarray(value),
                                          err_msg=name)
            assert got[name].dtype == np.asarray(value).dtype, name


def test_cells_constants_equal():
    names = [n for n in dir(C) if n.isupper() and isinstance(
        getattr(C, n), int)]
    assert len(names) > 40
    for name in names:
        assert getattr(TC, name) == getattr(C, name), name
    np.testing.assert_array_equal(TC.POINT_TABLE, C.POINT_TABLE)


def test_suites_found():
    assert len(SUITES) == 16


@pytest.mark.parametrize("path", SUITES, ids=lambda p: (
    "golden-" if p.startswith(GOLDEN_V1) else "packaged-")
    + os.path.basename(p)[:-4])
def test_bank_matches_jax(path):
    want = jax_fields(jloader.load_bank(path))
    got = tloader.load_bank(path, device="cpu").to_numpy()
    assert_same_fields(got, want)


@pytest.mark.parametrize("spawners,dynamic_goals", [
    (False, False), (True, False), (False, True), (True, True)])
def test_synth_bank_matches_jax(spawners, dynamic_goals):
    levels = [synth.simple_level(26, 26, spawners=spawners, seed=i,
                                 dynamic_goals=dynamic_goals)
              for i in range(6)]
    want = jax_fields(jloader.build_bank(levels))
    got = tloader.build_bank(levels, device="cpu").to_numpy()
    assert_same_fields(got, want)


def test_bank_numpy_round_trip():
    jbank = jloader.load_bank("benchmarks/v1.0/prune-still")
    want = jax_fields(jbank)
    bank = tstate.LevelBank.from_numpy(want, device="cpu")
    assert_same_fields(bank.to_numpy(), want)
    assert bank.static_goals and bank.spawnless


def test_state_numpy_round_trip():
    jbank = jloader.load_bank("benchmarks/v1.0/append-still")
    idx = np.arange(16) % jbank.num_levels
    want = jax_fields(JaxEnv().reset_to_levels(jbank, jnp.asarray(idx)))
    state = tstate.EnvState.from_numpy(want, device="cpu")
    assert_same_fields(state.to_numpy(), want)
    # The port's own reset of the same levels gives the same state.
    bank = tloader.load_bank("benchmarks/v1.0/append-still", device="cpu")
    assert_same_fields(
        TorchEnv(device="cpu").reset_to_levels(bank, idx).to_numpy(), want)


def test_find_exits_matches_jax():
    rng = np.random.RandomState(4)
    board = np.zeros((9, 11, 32), np.uint16)
    board[rng.random(board.shape) < 0.03] = C.LEVEL_EXIT
    board[..., 0] = 0  # a board without exits
    for k in (1, 3):
        want = jstate.find_exits(jnp.asarray(board), k)
        got = tstate.find_exits(torch.as_tensor(board), k)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got = tstate.find_exits_np(board[..., 1], 3)
    for g, w in zip(got, jstate.find_exits_np(board[..., 1], 3)):
        np.testing.assert_array_equal(g, w)
