"""The port's interactive ``GameLoop``: the cases of
``tests/test_interactive.py`` (play keys, undo, edit mode, restart, the
in-play recording and its GIF) driven through the frontend-agnostic
``handle_key`` without a TTY, a key sequence against the JAX package's
loop (the same boards, points and messages), ``games_from_files`` and the
print-only loop against the JAX package's, and the fall back to the
terminal when pyglet is missing.
"""

import glob
import os

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from safelife_torch import cells as C
from safelife_torch.game import SafeLifeGame
from safelife_torch.interactive import play as tplay
from safelife_torch.levels import synth
from safelife_torch.render.graphics import render_board, render_file
from safelife_tpu.game import SafeLifeGame as JaxGame
from safelife_tpu.interactive import play as jplay

torch.set_num_threads(1)


def make_game(cls=SafeLifeGame):
    lv = synth.simple_level(12, 12, seed=3)
    game = cls(board_size=None)
    game.deserialize({k: v for k, v in lv.items() if k not in ("name",)
                      and not k.startswith("agent")}
                     | {"agent_loc": (int(lv["agent_col"]),
                                      int(lv["agent_row"])),
                        "orientation": int(lv["orientation"]),
                        "spawn_prob": float(lv["spawn_prob"]),
                        "min_performance": float(lv["min_performance"])})
    return game


def make_loop(game, module=tplay):
    loop = module.GameLoop(iter([]))
    loop.start_level(game)
    return loop


def test_play_keys_advance_and_undo():
    game = make_game()
    loop = make_loop(game)
    board0 = game.board.copy()
    loc0 = game.agent_loc
    loop.handle_key("UP")
    assert game.num_steps == 1
    loop.handle_key("z")  # undo
    assert game.num_steps == 0
    np.testing.assert_array_equal(game.board, board0)
    assert game.agent_loc == loc0
    loop.handle_key("z")
    assert loop.message == "nothing to undo"


def test_edit_mode_places_cells():
    game = make_game()
    loop = make_loop(game)
    loop.handle_key("e")
    assert loop.edit_mode == "BOARD"
    loop.handle_key("RIGHT")           # move cursor off the agent
    x, y = game.edit_loc
    loop.handle_key("w")               # put wall
    assert game.board[y, x] & ~np.uint16(C.COLORS) == C.WALL
    loop.handle_key("c")               # cycle color
    assert "EDIT COLOR" in loop.message
    loop.handle_key("g")
    assert loop.edit_mode == "GOALS"
    loop.handle_key("l")               # put life into the goal board
    assert game.goals[y, x] & C.ALIVE
    loop.handle_key("\x1b")
    assert loop.edit_mode is None


def test_restart_reverts():
    game = make_game()
    loop = make_loop(game)
    for k in ("UP", "UP", "RIGHT"):
        loop.handle_key(k)
    assert game.num_steps == 3
    loop.handle_key("R")
    assert game.num_steps == 0 and not loop.history


def test_recording_saves_trajectory(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    game = make_game()
    loop = make_loop(game)
    loop.handle_key("*")
    assert loop.message == "nothing to record"
    for k in ("UP", "RIGHT", "UP"):
        loop.handle_key(k)
    loop.handle_key("*")
    files = glob.glob(os.path.join("plays", "rec-*.npz"))
    assert files == [os.path.join("plays", "rec-001.npz")], loop.message
    with np.load(files[0]) as data:
        assert data["board"].shape[0] == 4          # 3 moves + final frame
        assert data["board"].shape[1:] == game.board.shape
        assert data["goals"].shape == data["board"].shape
        assert data["agent_loc"].shape == (4, 2)
        boards, goals, orients = (data["board"], data["goals"],
                                  data["orientation"])
    # renders to a gif via the standard renderer
    out = render_file(files[0])
    assert out.endswith(".gif") and os.path.exists(out)
    frames = imageio.mimread(out)
    assert len(frames) == 4
    for t, frame in enumerate(frames):
        np.testing.assert_array_equal(
            frame[..., :3], render_board(boards[t], goals[t], orients[t]))
    loop.handle_key("UP")
    loop.handle_key("*")
    assert os.path.exists(os.path.join("plays", "rec-002.npz"))


def test_key_sequence_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    loops = [make_loop(make_game(), tplay),
             make_loop(make_game(JaxGame), jplay)]
    keys = ["UP", "RIGHT", " ", ",", "UP", "c", ".", "z", "DOWN", "LEFT",
            "e", "RIGHT", "RIGHT", "w", "c", "l", "g", "s", "DOWN", "x",
            "e", "LEFT", "LEFT", "UP", "z", "z", "RIGHT", "R", "UP", "UP",
            "e", "DOWN", "a", "e", "RIGHT", "n"]
    for t, key in enumerate(keys):
        for loop in loops:
            loop.handle_key(key)
        got, want = (loop.game for loop in loops)
        msg = f"key {t} ({key!r})"
        np.testing.assert_array_equal(got.board, want.board, msg)
        np.testing.assert_array_equal(got.goals, want.goals, msg)
        assert (got.agent_loc, got.orientation, got.num_steps) == (
            want.agent_loc, want.orientation, want.num_steps), msg
        assert [(lp.total_points, lp.edit_mode, lp.message, lp.status,
                 len(lp.history)) for lp in loops][0] == (
            loops[1].total_points, loops[1].edit_mode, loops[1].message,
            loops[1].status, len(loops[1].history)), msg
    assert loops[0].status == "NEXT"


def test_games_from_files_and_print_match_jax(capsys):
    got = list(tplay.games_from_files("puzzles", "benchmarks/v1.0/"
                                      "append-still.npz"))
    want = list(jplay.games_from_files("puzzles", "benchmarks/v1.0/"
                                       "append-still.npz"))
    assert len(got) == len(want) > 100
    for g, w in zip(got, want):
        assert g.file_name == w.file_name
        np.testing.assert_array_equal(g.board, w.board)
        np.testing.assert_array_equal(g.goals, w.goals)
        assert (g.agent_loc, g.orientation) == (w.agent_loc, w.orientation)
    tplay.GameLoop(tplay.games_from_files("puzzles/02*"), view_size=(7, 9),
                   print_only=True).run()
    out = capsys.readouterr().out
    jplay.GameLoop(jplay.games_from_files("puzzles/02*"), view_size=(7, 9),
                   print_only=True).run()
    assert out == capsys.readouterr().out and out


def test_run_gl_falls_back_to_the_terminal(monkeypatch, capsys):
    import builtins
    real_import = builtins.__import__

    def no_pyglet(name, *args, **kw):
        if name.split(".")[0] == "pyglet":
            raise ImportError("no pyglet here")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pyglet)
    ran = []
    loop = tplay.GameLoop(iter([make_game()]))
    monkeypatch.setattr(loop, "run", lambda: ran.append(True))
    loop.run_gl()
    assert ran == [True]
    assert "pyglet is not installed" in capsys.readouterr().out


def test_gl_module_imports_without_pyglet():
    from safelife_torch.interactive import gl
    with pytest.raises(ImportError):
        import pyglet  # noqa: F401  (neither test machine has it)
    assert callable(gl.run_gl_loop)
