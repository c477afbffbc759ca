"""Interactive play + level editor (terminal frontend; GL in .gl; port of
``safelife_tpu.interactive.play``).

Capability parity with ``safelife/interactive_game.py`` (GameLoop): play
keys, undo history, full board/goal editor (PUT/TOGGLE/color-cycle), save,
in-play trajectory recording (``*`` saves the frames since the last
restart to ``plays/rec-NNN.npz``, the reference's recording format,
``interactive_game.py:126-173``), an embedded IPython shell (``\\``), and
per-level stats with side-effect scores.  The key handling is frontend-
agnostic (:meth:`GameLoop.handle_key`); the terminal loop lives here and
the optional pyglet window in :mod:`safelife_torch.interactive.gl`.

Key bindings (play mode):
    arrows      move (absolute direction)
    space / c   toggle (create/destroy) in facing direction
    , / .       turn left / right
    z           undo one step
    R           restart level
    *           save recording of this attempt (plays/rec-NNN.npz)
    \\           IPython shell (game in scope)
    e           enter/leave board edit mode, g goal edit mode
    n           next level
    q           quit
In edit mode:
    arrows      move cursor
    letters     put cells (l=life, w=wall, r=crate, s=spawner, x=exit,
                t=tree, p=plant, i=icecube, f=fountain, u=weed, a=agent,
                k=parasite, SPACE=empty)
    c           cycle edit color
    g/b         toggle goal/board editing
    S           save level (prompts for filename)
"""

import glob
import os
import sys

import numpy as np

from .. import cells as C  # noqa: F401  (handy inside the embedded shell)
from ..game import SafeLifeGame
from ..render import text as render_text
from ..side_effects import side_effect_score
from .keyboard import getkey

PLAY_KEYS = {
    "UP": "MOVE UP",
    "DOWN": "MOVE DOWN",
    "LEFT": "MOVE LEFT",
    "RIGHT": "MOVE RIGHT",
    " ": "TOGGLE",
    "c": "TOGGLE",
    ",": "TURN LEFT",
    ".": "TURN RIGHT",
}

EDIT_PUTS = {
    " ": "PUT EMPTY",
    "l": "PUT LIFE",
    "L": "PUT HARD LIFE",
    "w": "PUT WALL",
    "r": "PUT CRATE",
    "s": "PUT SPAWNER",
    "S": "PUT HARD SPAWNER",
    "x": "PUT EXIT",
    "i": "PUT ICECUBE",
    "p": "PUT PLANT",
    "t": "PUT TREE",
    "f": "PUT FOUNTAIN",
    "k": "PUT PARASITE",
    "u": "PUT WEED",
    "a": "PUT AGENT",
}

EDIT_MOVES = {"UP": "MOVE UP", "DOWN": "MOVE DOWN",
              "LEFT": "MOVE LEFT", "RIGHT": "MOVE RIGHT"}


class GameLoop:
    """Play through a sequence of levels; frontend-agnostic key handling."""

    recording_directory = "plays"

    def __init__(self, levels, view_size=None, print_only=False,
                 undo_limit=10_000):
        self.levels = iter(levels)
        self.view_size = view_size
        self.print_only = print_only
        self.undo_limit = undo_limit
        self.game = None
        self.message = ""
        self.edit_mode = None
        self.total_points = 0
        self.history = []
        self.status = None  # None | "NEXT" | "QUIT" | "DONE"

    # -- per-level state ---------------------------------------------------

    def start_level(self, game):
        self.game = game
        self.history = []
        self.total_points = 0
        self.edit_mode = None
        self.message = ""
        self.status = None
        game.update_exit_colors()

    def next_level(self):
        try:
            self.start_level(next(self.levels))
            return True
        except StopIteration:
            self.game = None
            self.status = "DONE"
            return False

    # -- recording (reference interactive_game.py:126-173) -----------------

    def save_recording(self):
        """Dump this attempt's frames (since the last restart) to
        ``plays/rec-NNN.npz`` in the reference's recording wire format
        (board/goals/orientation/agent_loc stacks — renderable with
        ``python -m safelife_torch render``)."""
        frames = list(self.history)
        snap = self.game.serialize()
        snap["num_steps"] = self.game.num_steps
        frames.append(snap)
        if len(frames) < 2:
            return None
        data = {
            "board": np.stack([f["board"] for f in frames]),
            "goals": np.stack([f["goals"] for f in frames]),
            "orientation": np.array([f["orientation"] for f in frames]),
            "agent_loc": np.stack([np.asarray(f["agent_loc"])
                                   for f in frames]),
        }
        os.makedirs(self.recording_directory, exist_ok=True)
        taken = glob.glob(os.path.join(self.recording_directory, "rec-*.npz"))
        n = 1 + max((int(os.path.basename(f)[4:-4]) for f in taken),
                    default=0)
        fname = os.path.join(self.recording_directory, f"rec-{n:03d}.npz")
        np.savez_compressed(fname, **data)
        return fname

    # -- key handling (shared by terminal + GL frontends) ------------------

    def handle_key(self, key):
        """Apply one key press; updates game/self state and ``status``."""
        game = self.game
        self.message = ""
        if key in ("q", "INTERRUPT", "EOF"):
            self.status = "QUIT"
            return
        if key == "*":
            fname = self.save_recording()
            self.message = f"recording saved: {fname}" if fname \
                else "nothing to record"
            return
        if key == "\\":
            self.run_shell()
            return
        if self.edit_mode:
            self._handle_edit_key(key)
            return
        if key == "e":
            self.edit_mode = "BOARD"
            game.edit_loc = game.agent_loc
        elif key == "z":
            if self.history:
                data = self.history.pop()
                game.deserialize(data, as_initial_state=False)
                game.num_steps = data["num_steps"]
                self.total_points = data["points"]
            else:
                self.message = "nothing to undo"
        elif key == "R":
            game.revert()
            self.total_points = 0
            self.history.clear()
        elif key == "n":
            self.status = "NEXT"
        elif key in PLAY_KEYS:
            if len(self.history) >= self.undo_limit:
                self.history.pop(0)
            snap = game.serialize()
            snap["num_steps"] = game.num_steps
            snap["points"] = self.total_points
            self.history.append(snap)
            start_points = game.current_points()
            reward = game.execute_action(PLAY_KEYS[key])
            game.advance_board()
            self.total_points += \
                reward + game.current_points() - start_points
            game.update_exit_colors()
            if game.game_over:
                self.status = "NEXT"

    def _handle_edit_key(self, key):
        game = self.game
        if key == "e" or key == "\x1b":
            self.edit_mode = None
        elif key == "g":
            self.edit_mode = "GOALS" if self.edit_mode == "BOARD" else "BOARD"
        elif key in EDIT_MOVES:
            game.execute_edit(EDIT_MOVES[key])
        elif key == "c":
            self.message = game.execute_edit("CHANGE COLOR") or ""
        elif key == "S":
            fname = input("\nSave as: ")
            if fname:
                game.save(fname)
                self.message = f"saved to {game.file_name}"
        elif key in EDIT_PUTS:
            cmd = EDIT_PUTS[key]
            if self.edit_mode == "GOALS":
                cmd = "EDIT GOALS: " + cmd
            self.message = game.execute_edit(cmd) or ""

    def run_shell(self):
        """Embedded IPython shell with the game in scope (reference
        ``interactive_game.py:375-387``)."""
        game = self.game  # noqa: F841 — teed up for the shell user
        loop = self       # noqa: F841
        try:
            from IPython import embed
        except ImportError:  # pragma: no cover
            self.message = "IPython not available"
            return
        print("\nEntering IPython; `game` and `loop` are in scope. "
              "Ctrl-D returns to the game.")
        embed(colors="neutral")

    # -- terminal frontend -------------------------------------------------

    def play(self, game, out=sys.stdout):
        self.start_level(game)
        while True:
            self._draw(out)
            self.handle_key(getkey())
            if self.status == "QUIT":
                return "QUIT"
            if self.status == "NEXT":
                if self.game.game_over:
                    self._finish(out)
                return "NEXT"

    def _draw(self, out):
        game = self.game
        out.write("\x1b[H\x1b[J")  # clear screen
        title = game.title or "SafeLife"
        mode = f" [EDIT {self.edit_mode}]" if self.edit_mode else ""
        out.write(f"{title}{mode}   steps: {game.num_steps}  "
                  f"points: {self.total_points}\n")
        out.write(render_text.render_game(
            game, self.view_size, self.edit_mode))
        comp, poss = game.performance_ratio()
        out.write(f"progress: {comp}/{poss}   "
                  f"powers: {render_text.agent_powers(game)}\n")
        if self.message:
            out.write(self.message + "\n")
        out.flush()

    def _finish(self, out):
        game = self.game
        comp, poss = game.performance_ratio()
        out.write(f"\nLevel complete!  points={self.total_points}  "
                  f"performance={comp}/{poss}\n")
        out.write("computing side effects...\n")
        out.flush()
        try:
            scores = side_effect_score(game, num_samples=200)
            for key, (emd, mass) in sorted(scores.items()):
                out.write(f"  {render_text.cell_name(key)}: "
                          f"{emd:.2f} (of {mass:.1f})\n")
        except Exception as exc:  # pragma: no cover
            out.write(f"  side effect scoring failed: {exc}\n")
        out.flush()

    # -- entry points ------------------------------------------------------

    def run(self):
        for game in self.levels:
            if self.print_only:
                print(render_text.render_game(game, self.view_size))
                continue
            if self.play(game) == "QUIT":
                break

    def run_gl(self):
        """Open the pyglet window frontend; falls back to the terminal
        when pyglet is unavailable (like the reference's run_gl)."""
        try:
            import pyglet  # noqa: F401  (the window's toolkit)
        except ImportError:
            print("pyglet is not installed; running in the terminal "
                  "instead (pip install pyglet for the graphical window).")
            return self.run()
        from .gl import run_gl_loop
        return run_gl_loop(self)


def games_from_files(*paths):
    """Yield SafeLifeGame objects from level files (npz archives too) and
    procgen parameter files (one fresh game each)."""
    from ..levels import loader
    from ..levels.iterator import FILE_TYPES

    for fname in loader.find_files(*paths, file_types=FILE_TYPES):
        if fname.endswith((".yaml", ".json")):
            from ..procgen import gen_game_from_file
            yield gen_game_from_file(fname)
            continue
        with np.load(fname) as data:
            if "levels" in data:
                for rec in data["levels"]:
                    game = SafeLifeGame(board_size=None)
                    game.deserialize(rec)
                    game.file_name = os.path.join(
                        fname, str(rec["name"]))
                    yield game
            else:
                yield SafeLifeGame.load(fname)
