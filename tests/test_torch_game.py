"""The port's host game layer against the JAX package on the CPU:
``SafeLifeGame`` step by step on the first levels of append-still,
append-spawn and prune-dynamic and on a puzzle (both sides drawing spawns
from a ``NumpyRandomBridge`` of one seed, so the CA's consumption order
is held bit for bit), the reference C engine's golden episodes replayed
through the port's game, the game against the port's batched env, the
serialize round trip, the hand-made level, the editor commands, and
``GameOfLife``/``AsyncGame`` against the JAX ``alt_games``.  Every
comparison is exact: boards, scores and flags are integers.
"""

import os

import numpy as np
import pytest
import torch

from safelife_torch import alt_games as talt
from safelife_torch import cells as C
from safelife_torch import game as tgame
from safelife_torch.env.env import ACTION_NAMES, BatchedSafeLifeEnv, EnvConfig
from safelife_torch.levels import loader as tloader
from safelife_torch.ops import life_numpy as tlife
from safelife_torch.utils.rng import NumpyRandomBridge as TBridge
from safelife_tpu import alt_games as jalt
from safelife_tpu import game as jgame
from safelife_tpu.ops import life_numpy as jlife
from safelife_tpu.utils.rng import NumpyRandomBridge as JBridge

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
LEVELS = {"append-still": ("benchmarks/v1.0/append-still.npz", 0),
          "append-spawn": ("benchmarks/v1.0/append-spawn.npz", 0),
          "prune-dynamic": ("benchmarks/v1.0/prune-dynamic.npz", 0),
          "puzzle": ("puzzles/07*", None)}
STEPS = 60


def _record(name):
    path, index = LEVELS[name]
    fname = next(tloader.find_files(path))
    with np.load(fname) as data:
        if index is None:
            return {k: data[k] for k in data.files}
        rec = data["levels"][index]
        return {k: rec[k] for k in rec.dtype.fields}


def _game(module, record, rng=None):
    game = module.SafeLifeGame(board_size=None, rng=rng)
    game.deserialize(record)
    game.update_exit_colors()
    return game


def _play(game, action):
    """One step as the gym adapter and the interactive loop take it."""
    start = game.current_points()
    reward = game.execute_action(ACTION_NAMES[action])
    game.advance_board()
    reward += game.current_points() - start
    game.update_exit_colors()
    return reward


@pytest.mark.parametrize("name", list(LEVELS))
def test_game_matches_jax(name):
    """The same level and 60 seeded actions: board, goals, orientation,
    agent, reward, game_over and performance_ratio equal at every step.
    Both games draw their spawns from a bridge of seed 7."""
    record = _record(name)
    jg = _game(jgame, record, JBridge(7))
    tg = _game(tgame, record, TBridge(7))
    if name == "append-spawn":
        assert tg.is_stochastic
    if name == "prune-dynamic":
        assert tg.goals.any()
    actions = np.random.RandomState(5).randint(0, 9, STEPS)
    for t, a in enumerate(actions):
        want, got = _play(jg, a), _play(tg, a)
        msg = f"{name} step {t} ({ACTION_NAMES[a]})"
        assert got == want, msg
        np.testing.assert_array_equal(tg.board, jg.board, msg)
        np.testing.assert_array_equal(tg.goals, jg.goals, msg)
        assert tg.board.dtype == jg.board.dtype == np.uint16
        assert (tg.orientation, tg.agent_loc) == (jg.orientation,
                                                  jg.agent_loc), msg
        assert tg.game_over == jg.game_over, msg
        assert tg.performance_ratio() == jg.performance_ratio(), msg
        assert tg.num_steps == jg.num_steps == t + 1


def test_ca_oracle_rng_path_matches_c_engine():
    """The port's oracle drawing from the port's bridge replays the C
    engine's CA goldens (spawners included), as the JAX oracle does in
    ``tests/test_life_vs_golden.py``; the consumption mask equals the
    JAX package's."""
    golden = np.load(os.path.join(GOLDEN, "ca_steps.npz"))
    names = sorted({k.split("/")[0] for k in golden.files})
    for name in names:
        steps = golden[name + "/steps"]
        spawn_prob = float(golden[name + "/spawn_prob"])
        rng = TBridge(17)
        b = golden[name + "/input"]
        for t in range(steps.shape[0]):
            np.testing.assert_array_equal(tlife.spawn_consumption_mask(b),
                                          jlife.spawn_consumption_mask(b))
            b = tlife.advance_board_reference(b, spawn_prob=spawn_prob,
                                              rng=rng)
            np.testing.assert_array_equal(b, steps[t], f"{name} step {t}")


def test_oracle_positional_callers_unchanged():
    """``advance_board_reference(board, rand_field, spawn_prob)``, as the
    side-effect scorer and the integrity guard call it, against the JAX
    oracle given the same field."""
    rng = np.random.RandomState(3)
    flags = np.array([C.ALIVE, C.SPAWNING | C.FROZEN, C.INHIBITING, C.WALL,
                      C.PRESERVING, C.COLOR_R | C.ALIVE, C.DESTRUCTIBLE])
    board = (flags[rng.randint(0, len(flags), (20, 24))]
             * (rng.random_sample((20, 24)) < 0.4)).astype(np.uint16)
    field = rng.random_sample(board.shape)
    for p in (0.0, 0.3, 1.0):
        np.testing.assert_array_equal(
            tlife.advance_board_reference(board, field, p),
            jlife.advance_board_reference(board, p, rand_field=field))
    np.testing.assert_array_equal(
        tlife.advance_board_reference(board, np.ones(board.shape)),
        jlife.advance_board_reference(board, rand_field=np.ones(board.shape)))


def test_game_replays_golden_episodes():
    """The C engine's golden episodes (every v1.0 suite, spawners and
    dynamic goals, one long spawner episode) through the port's game and a
    bridge of seed 99 for each: boards, goals, rewards, points, agent,
    orientation and game_over at every step."""
    golden = np.load(os.path.join(GOLDEN, "episodes.npz"))
    names = sorted({k.split("/")[0] for k in golden.files} - {"obs"})
    assert len(names) == 10  # and 520 steps of append-spawn level 3
    for name in names:
        suite, index = name.removesuffix("-long").rsplit("-", 1)
        levels = tloader.load_levels(f"benchmarks/v1.0/{suite}")
        lv = levels[int(index)]
        game = tgame.SafeLifeGame(board_size=None, rng=TBridge(99))
        game.deserialize({
            "board": lv["board"], "goals": lv["goals"],
            "agent_loc": (int(lv["agent_col"]), int(lv["agent_row"])),
            "orientation": int(lv["orientation"]),
            "spawn_prob": float(lv["spawn_prob"]),
            "min_performance": float(lv["min_performance"])})
        game.update_exit_colors()
        np.testing.assert_array_equal(game.board, golden[name + "/init_board"])
        for t, a in enumerate(golden[name + "/actions"]):
            reward = _play(game, int(a))
            msg = f"{name} step {t}"
            np.testing.assert_array_equal(game.board,
                                          golden[name + "/board"][t], msg)
            np.testing.assert_array_equal(game.goals,
                                          golden[name + "/goals"][t], msg)
            assert reward == pytest.approx(
                float(golden[name + "/reward"][t])), msg
            assert game.agent_loc == tuple(golden[name + "/agent_loc"][t])
            assert game.orientation == golden[name + "/orientation"][t]
            assert bool(game.game_over) == bool(
                golden[name + "/game_over"][t]), msg
            assert game.current_points() == golden[name + "/points"][t]


def test_game_matches_batched_env():
    """The port's game against the port's batched env on the CPU, one
    level and 60 seeded actions (``tests/test_game_api.py``'s first case):
    boards and rewards equal at every step."""
    game = _game(tgame, _record("append-still"))
    bank = tloader.load_bank("benchmarks/v1.0/append-still.npz",
                             device="cpu")
    env = BatchedSafeLifeEnv(EnvConfig(view_shape=(15, 15), auto_reset=False),
                             device="cpu")
    state = env.reset_to_levels(bank, [0])
    spawn = torch.zeros(state.board.shape, dtype=torch.bool)
    rng = np.random.RandomState(5)
    for t in range(STEPS):
        a = int(rng.randint(0, 9))
        reward = _play(game, a)
        state, ts = env.step(state, bank, [a], spawn_board=spawn,
                             spawn_goals=spawn)
        np.testing.assert_array_equal(state.board[..., 0].numpy(), game.board,
                                      f"step {t} ({ACTION_NAMES[a]})")
        assert float(ts.reward[0]) == float(reward), t
        assert bool(ts.state_before_reset.game_over[0]) == bool(
            game.game_over)
        if game.game_over:
            break


def test_serialize_roundtrip_and_wire_format(tmp_path):
    record = _record("prune-dynamic")
    game = _game(tgame, record, TBridge(1))
    game.execute_action("MOVE RIGHT")
    game.advance_board()
    fname = os.path.join(str(tmp_path), "saved")
    game.save(fname)
    loaded = tgame.SafeLifeGame.load(fname + ".npz")
    np.testing.assert_array_equal(loaded.board, game.board)
    np.testing.assert_array_equal(loaded.goals, game.goals)
    assert loaded.agent_loc == game.agent_loc
    assert loaded.orientation == game.orientation
    assert loaded.min_performance == game.min_performance
    assert loaded.spawn_prob == game.spawn_prob
    # The JAX package reads the port's file, and the other way round.
    jloaded = jgame.SafeLifeGame.load(fname + ".npz")
    np.testing.assert_array_equal(jloaded.board, game.board)
    jloaded.save(os.path.join(str(tmp_path), "jax"))
    back = tgame.SafeLifeGame.load(os.path.join(str(tmp_path), "jax.npz"))
    assert {k: str(v) for k, v in back.serialize().items()
            if k != "class"} == {k: str(v) for k, v in
                                 jloaded.serialize().items() if k != "class"}


def test_load_reference_handmade_level():
    fname = next(tloader.find_files("puzzles/*.npz"))
    game = tgame.SafeLifeGame.load(fname)
    want = jgame.SafeLifeGame.load(fname)
    assert game.board.shape == game.goals.shape
    assert (game.board & C.AGENT).any()
    np.testing.assert_array_equal(game.board, want.board)
    assert game.title == want.title


def test_editor_commands():
    games = [tgame.SafeLifeGame(board_size=(8, 8)),
             jgame.SafeLifeGame(board_size=(8, 8))]
    commands = ["PUT WALL", "CHANGE COLOR", "PUT LIFE",
                "EDIT GOALS: PUT LIFE", "MOVE RIGHT", "PUT AGENT",
                "CHANGE COLOR FULL CYCLE", "MOVE DOWN", "PUT SPAWNER",
                "TOGGLE ALIVE", "EDIT GOALS: PUT EXIT", "MOVE LEFT",
                "PUT HARD SPAWNER", "REVERT", "PUT TREE", "ABORT LEVEL"]
    for g in games:
        g.edit_loc = (2, 3)
    for cmd in commands:
        got, want = (g.execute_edit(cmd) for g in games)
        assert got == want, cmd
        np.testing.assert_array_equal(games[0].board, games[1].board, cmd)
        np.testing.assert_array_equal(games[0].goals, games[1].goals, cmd)
        assert games[0].agent_loc == games[1].agent_loc, cmd
        assert games[0].edit_color == games[1].edit_color, cmd
    game = tgame.SafeLifeGame(board_size=(8, 8))
    game.edit_loc = (2, 3)
    game.execute_edit("PUT WALL")
    assert game.board[3, 2] == C.WALL
    game.execute_edit("CHANGE COLOR")
    assert game.edit_color == C.COLOR_R
    game.execute_edit("PUT LIFE")
    assert game.board[3, 2] == (C.LIFE | C.COLOR_R)
    game.execute_edit("EDIT GOALS: PUT LIFE")
    assert game.goals[3, 2] == (C.LIFE | C.COLOR_R)
    game.execute_edit("MOVE RIGHT")
    assert game.edit_loc == (3, 3)
    game.execute_edit("PUT AGENT")
    assert game.agent_loc == (3, 3)
    assert game.board[3, 3] & C.AGENT
    game.shift_board(2, -1)
    game.resize_board(-1, 2)
    game.clip_board(left=1, top=1)
    assert game.board.shape == (9, 6)


@pytest.mark.parametrize("kind", ["GameOfLife", "AsyncGame"])
def test_alt_games_match_jax(kind):
    """Both engines draw from numpy's global stream: seeded alike before
    each side's step, they give the same boards."""
    record = _record("append-spawn")
    games = []
    for module in (talt, jalt):
        game = getattr(module, kind)(board_size=None)
        game.deserialize(record)
        if kind == "AsyncGame":
            game.temperature = 0.5
        games.append(game)
    if kind == "AsyncGame":
        assert "energy_rules" in games[0].serialize()
    state = np.random.get_state()
    try:
        for t in range(8):
            for game in games:
                np.random.seed(100 + t)
                game.advance_board()
            np.testing.assert_array_equal(games[0].board, games[1].board,
                                          f"{kind} step {t}")
            assert games[0].num_steps == games[1].num_steps == t + 1
    finally:
        np.random.set_state(state)
    assert not np.array_equal(games[0].board,
                              np.asarray(record["board"], np.uint16))
