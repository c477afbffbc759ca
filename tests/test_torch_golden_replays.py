"""The port's plain environment against the reference C engine's golden
traces of ``tests/test_env_parity.py`` (toggle powers and colours) and
``tests/test_puzzle_parity.py`` (six hand-authored puzzles in one lockstep
batch), replayed bit for bit with spawn fields drawn from the reference's
MT19937 stream.  The toggle configurations run on the plain path: the
kernels do not take ``can_toggle_powers`` or ``can_toggle_colors``."""

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

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
PUZZLES = [
    ("corridor", "puzzles/01*"),
    ("block", "puzzles/02*"),
    ("breakout", "puzzles/08*"),
    ("pruning", "puzzles/10*"),
    ("chaos-contained", "puzzles/16*"),
    ("inside-out", "puzzles/18*"),
]


def _spawn_field(board, spawn_prob, rng):
    """Spawn decisions drawn exactly as the C engine: row-major float64."""
    mask = spawn_consumption_mask(board)
    f = np.zeros(board.shape, bool)
    n = int(mask.sum())
    if n:
        f[mask] = rng.draw(n) < spawn_prob
    return f


def _action_board(state, action, ce):
    """The post-action board, the one the C engine draws spawns on first."""
    return agent_ops.execute_action(
        state.board, state.agent_row, state.agent_col, state.orientation,
        action, ce, state.game_over).board.numpy()


def _check_step(golden, names, t, state, ts):
    for b, name in enumerate(names):
        msg = f"{name} step {t}"
        np.testing.assert_array_equal(
            state.board[..., b].numpy(), golden[name + "/board"][t], msg)
        np.testing.assert_array_equal(
            state.goals[..., b].numpy(), golden[name + "/goals"][t], msg)
        assert float(ts.reward[b]) == pytest.approx(
            float(golden[name + "/reward"][t])), msg
        assert (int(state.agent_col[b]), int(state.agent_row[b])) == tuple(
            golden[name + "/agent_loc"][t]), msg
        assert int(state.orientation[b]) == golden[name + "/orientation"][t], (
            msg)
        assert bool(state.game_over[b]) == bool(
            golden[name + "/game_over"][t]), msg
        assert int(state.points_last[b]) == golden[name + "/points"][t], msg


@pytest.mark.parametrize("name", ["powers", "colors", "both"])
def test_toggle_powers_colors_match_golden(name):
    """``test_env_parity.test_toggle_powers_colors_parity`` through the
    port: fountains, ice cubes, parasites and weeds absorbed and
    recoloured by toggles."""
    tg = np.load(os.path.join(GOLDEN, "toggles.npz"))
    level = loader._level_from_record(dict(
        board=tg[name + "/init_board"],
        goals=tg[name + "/init_goals"],
        agent_loc=np.asarray(tg[name + "/init_agent_loc"]),
        orientation=int(tg[name + "/init_orientation"]),
        min_performance=float(tg[name + "/min_performance"]),
        spawn_prob=float(tg[name + "/spawn_prob"]),
    ), name)
    bank = loader.build_bank([level], device="cpu")
    env = BatchedSafeLifeEnv(EnvConfig(
        auto_reset=False,
        can_toggle_powers=bool(tg[name + "/can_toggle_powers"]),
        can_toggle_colors=bool(tg[name + "/can_toggle_colors"])),
        device="cpu")
    assert not env.uses_kernels()
    state = env.reset_to_levels(bank, np.arange(bank.num_levels))
    np.testing.assert_array_equal(state.board[..., 0].numpy(),
                                  tg[name + "/init_board"])
    np.testing.assert_array_equal(state.goals[..., 0].numpy(),
                                  tg[name + "/init_goals"])
    assert int(state.points_last[0]) == tg[name + "/init_points"]

    actions = tg[name + "/actions"]
    spawn_prob = float(tg[name + "/spawn_prob"])
    rng = NumpyRandomBridge(63)
    for t in range(len(actions)):
        a = torch.full((bank.num_levels,), int(actions[t]), dtype=torch.int32)
        comp, poss = scoring.performance_ratio(state.board, state.goals,
                                               state.baseline_score)
        ce = scoring.can_exit(comp, poss, state.min_performance)
        ab = _action_board(state, a, ce)
        fb = _spawn_field(ab[..., 0], spawn_prob, rng)[..., None]
        fg = _spawn_field(state.goals[..., 0].numpy(), spawn_prob, rng)[
            ..., None]
        state, ts = env.step(state, bank, a, spawn_board=torch.as_tensor(fb),
                             spawn_goals=torch.as_tensor(fg))
        _check_step(tg, [name], t, state, ts)


def test_puzzle_batch_matches_golden():
    """``test_puzzle_parity.test_puzzle_batch_parity`` through the port:
    crates, plants, fragile patterns, spawner chaos and ice cubes, six
    puzzles in one lockstep batch."""
    golden = np.load(os.path.join(GOLDEN, "puzzles.npz"))
    names = [name for name, _ in PUZZLES]
    bank = loader.build_bank(
        [loader.load_levels(path)[0] for _, path in PUZZLES], device="cpu")
    env = BatchedSafeLifeEnv(EnvConfig(auto_reset=False), device="cpu")
    n = len(PUZZLES)
    state = env.reset_to_levels(bank, np.arange(n))
    obs0 = env.observe(state).numpy()
    for b, name in enumerate(names):
        np.testing.assert_array_equal(
            state.board[..., b].numpy(), golden[name + "/init_board"], name)
        assert int(state.points_last[b]) == golden[name + "/init_points"], (
            name)
        np.testing.assert_array_equal(obs0[b], golden[name + "/obs0"], name)

    steps = min(len(golden[name + "/actions"]) for name in names)
    actions = np.stack([golden[name + "/actions"][:steps] for name in names],
                       axis=1)
    spawn_probs = [float(golden[name + "/spawn_prob"]) for name in names]
    rngs = [NumpyRandomBridge(31) for _ in names]
    for t in range(steps):
        a = torch.as_tensor(actions[t])
        ce = scoring.can_exit(state.perf_completed, state.perf_possible,
                              state.min_performance)
        ab = _action_board(state, a, ce)
        goals = state.goals.numpy()
        fb = np.stack([_spawn_field(ab[..., b], spawn_probs[b], rngs[b])
                       for b in range(n)], axis=-1)
        fg = np.stack([_spawn_field(goals[..., b], spawn_probs[b], rngs[b])
                       for b in range(n)], axis=-1)
        state, ts = env.step(state, bank, a, spawn_board=torch.as_tensor(fb),
                             spawn_goals=torch.as_tensor(fg))
        _check_step(golden, names, t, state, ts)
