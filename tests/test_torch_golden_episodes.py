"""The port's plain environment against the reference C engine's golden
episodes: the nine-episode batch of ``tests/test_env_parity.py`` (every
v1.0 suite, spawners and dynamic goals included) replayed bit for bit,
with spawn fields drawn from the reference's MT19937 stream."""

import os

import numpy as np
import pytest
import torch

from safelife_torch.env.env import BatchedSafeLifeEnv, EnvConfig
from safelife_torch.levels import loader
from safelife_torch.ops import agent as agent_ops
from safelife_torch.ops import scoring
from safelife_tpu.ops.life_numpy import spawn_consumption_mask
from safelife_tpu.utils.rng import NumpyRandomBridge

# The tensors here are small.  One thread keeps torch from leaving an
# OpenMP pool in the test process that slows the JAX tests run after it.
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "episodes.npz")
EPISODES = [
    ("append-still-0", "benchmarks/v1.0/append-still", 0),
    ("append-still-7", "benchmarks/v1.0/append-still", 7),
    ("prune-still-0", "benchmarks/v1.0/prune-still", 0),
    ("append-spawn-0", "benchmarks/v1.0/append-spawn", 0),
    ("navigation-0", "benchmarks/v1.0/navigation", 0),
    ("prune-dynamic-0", "benchmarks/v1.0/prune-dynamic", 0),
    ("append-dynamic-0", "benchmarks/v1.0/append-dynamic", 0),
    ("prune-spawn-0", "benchmarks/v1.0/prune-spawn", 0),
    ("prune-still-hard-0", "benchmarks/v1.0/prune-still-hard", 0),
]


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _action_board(state, action):
    """The post-action board, the one the C engine draws spawns on first."""
    comp, poss = scoring.performance_ratio(
        state.board, state.goals, state.baseline_score)
    ce = scoring.can_exit(comp, poss, state.min_performance)
    return agent_ops.execute_action(
        state.board, state.agent_row, state.agent_col, state.orientation,
        action, ce, state.game_over).board


def _spawn_field(board, spawn_prob, rng):
    """Spawn decisions drawn exactly as the C engine: row-major float64."""
    mask = spawn_consumption_mask(board)
    f = np.zeros(board.shape, bool)
    n = int(mask.sum())
    if n:
        f[mask] = rng.draw(n) < spawn_prob
    return f


def test_episode_batch_matches_golden(golden):
    bank = loader.build_bank(
        [loader.load_levels(path)[idx] for _, path, idx in EPISODES],
        device="cpu")
    env = BatchedSafeLifeEnv(EnvConfig(auto_reset=False), device="cpu")
    names = [name for name, _, _ in EPISODES]
    n = len(names)
    state = env.reset_to_levels(bank, np.arange(n))
    obs0 = env.observe(state).numpy()
    for b, name in enumerate(names):
        np.testing.assert_array_equal(state.board[..., b].numpy(),
                                      golden[name + "/init_board"])
        np.testing.assert_array_equal(state.goals[..., b].numpy(),
                                      golden[name + "/init_goals"])
        assert int(state.points_last[b]) == golden[name + "/init_points"]
        np.testing.assert_array_equal(obs0[b], golden[name + "/obs0"])

    actions = np.stack([golden[name + "/actions"] for name in names], axis=1)
    spawn_probs = [float(golden[name + "/spawn_prob"]) for name in names]
    rngs = [NumpyRandomBridge(99) for _ in names]
    for t in range(actions.shape[0]):
        a = torch.as_tensor(actions[t])
        # Per episode, the post-action board consumes draws first, then the
        # goal board.
        ab = _action_board(state, a).numpy()
        goals = state.goals.numpy()
        fb = np.stack([_spawn_field(ab[..., b], spawn_probs[b], rngs[b])
                       for b in range(n)], axis=-1)
        fg = np.stack([_spawn_field(goals[..., b], spawn_probs[b], rngs[b])
                       for b in range(n)], axis=-1)
        state, ts = env.step(state, bank, a, spawn_board=torch.as_tensor(fb),
                             spawn_goals=torch.as_tensor(fg))
        for b, name in enumerate(names):
            msg = f"{name} step {t}"
            np.testing.assert_array_equal(
                state.board[..., b].numpy(), golden[name + "/board"][t], msg)
            np.testing.assert_array_equal(
                state.goals[..., b].numpy(), golden[name + "/goals"][t], msg)
            assert float(ts.reward[b]) == pytest.approx(
                float(golden[name + "/reward"][t])), msg
            assert (int(state.agent_col[b]), int(state.agent_row[b])) == \
                tuple(golden[name + "/agent_loc"][t]), msg
            assert int(state.orientation[b]) == \
                golden[name + "/orientation"][t], msg
            assert bool(state.game_over[b]) == \
                bool(golden[name + "/game_over"][t]), msg
            assert int(state.points_last[b]) == golden[name + "/points"][t], msg
            assert int(ts.perf_completed[b]) == \
                golden[name + "/perf_completed"][t], msg
            assert int(ts.perf_possible[b]) == \
                golden[name + "/perf_possible"][t], msg
