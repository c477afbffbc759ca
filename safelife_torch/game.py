"""Single-board host-side game: the interactive, editing and file-format
API (the port's copy of ``safelife_tpu.game``).

Capability parity with the reference's ``GameState`` / ``GameWithGoals`` /
``SafeLifeGame`` stack (``safelife/safelife_game.py:123-664``): actions
(absolute and relative moves, turns, toggles), movement with push/pull and
exit detection, the full board editor, npz serialize/save/load in the
reference wire format, revert, board shift/resize/clip, scoring and exit
gating.

This is plain numpy on the host, as in the JAX package: the batched
environment (:mod:`safelife_torch.env.env`) is the training and benchmark
path on the card; this class serves interactive play, level editing, file
IO and the gym adapter.  Physics goes through the numpy oracle
(:mod:`safelife_torch.ops.life_numpy`), driven by the reference-compatible
buffered MT19937 stream (:mod:`safelife_torch.utils.rng`), so fixed-seed
games replay the reference C engine exactly.
"""

import os

import numpy as np

from . import cells as C
from .cells import CellTypes, NAMED_CELLS, POINT_TABLE
from .ops import life_numpy
from .utils.rng import NumpyRandomBridge

ORIENTATION = {
    "UP": 0,
    "RIGHT": 1,
    "DOWN": 2,
    "LEFT": 3,
    "FORWARD": 4,
    "BACKWARD": 6,
}

# Forward step vector (row, col) per orientation; the right-hand vector of
# orientation o is the forward vector of (o + 1) % 4.
_DIR = ((-1, 0), (0, 1), (1, 0), (0, -1))

_EDIT_TOGGLES = {
    "ALIVE": C.ALIVE,
    "INHIBITING": C.INHIBITING,
    "PRESERVING": C.PRESERVING,
    "SPAWNING": C.SPAWNING,
}

# Module-level RNG mirroring the reference's global numpy stream
# (speedups_src/random.c): `seed()` reseeds it; games draw from it unless
# given their own bridge.
_global_rng = NumpyRandomBridge()


def seed(value):
    """Seed the global CA random stream (reference: ``speedups.seed``)."""
    _global_rng.seed(value)


class SafeLifeGame:
    """One game board with goals — play, edit, save, load."""

    spawn_prob = 0.3
    orientation = 1
    agent_loc = (0, 0)
    edit_loc = (0, 0)
    edit_color = 0
    board = None
    goals = None
    file_name = None
    game_over = False
    points_on_level_exit = +1
    num_steps = 0
    min_performance = -1

    can_toggle_powers = False
    can_toggle_colors = False

    def __init__(self, board_size=(10, 10), rng=None):
        self.exit_locs = (np.array([], dtype=int), np.array([], dtype=int))
        self.rng = rng or _global_rng
        if board_size is not None:
            self.make_default_board(board_size)
            self._init_data = self.serialize()

    def make_default_board(self, board_size):
        self.board = np.zeros(board_size, dtype=np.uint16)
        self.goals = np.zeros_like(self.board)
        self.agent_loc = (board_size[1] // 2, board_size[0] // 2)
        self.board[self.agent_loc[1], self.agent_loc[0]] = C.PLAYER

    # -- geometry ---------------------------------------------------------

    @property
    def width(self):
        return self.board.shape[1]

    @property
    def height(self):
        return self.board.shape[0]

    @property
    def title(self):
        if self.file_name is None:
            return None
        fname = os.path.split(self.file_name)[-1]
        return ".".join(fname.split(".")[:-1])

    @property
    def edit_color_name(self):
        return C.COLOR_INDEX_NAMES[
            (self.edit_color & C.COLORS) >> C.COLOR_BIT]

    def relative_loc(self, n_forward, n_right=0):
        """(x, y) of the cell ``n_forward``/``n_right`` of the agent,
        torus-wrapped (reference ``relative_loc`` semantics)."""
        fr, fc = _DIR[self.orientation]
        rr, rc = _DIR[(self.orientation + 1) % 4]
        x0, y0 = self.agent_loc
        row = (y0 + n_forward * fr + n_right * rr) % self.height
        col = (x0 + n_forward * fc + n_right * rc) % self.width
        return col, row

    # -- serialization (wire-compatible with the reference) ----------------

    def serialize(self):
        cls = self.__class__
        return {
            "spawn_prob": self.spawn_prob,
            "orientation": self.orientation,
            "agent_loc": self.agent_loc,
            "board": self.board.copy(),
            "goals": self.goals.copy(),
            "class": "%s.%s" % (cls.__module__, cls.__name__),
            "min_performance": self.min_performance,
        }

    def deserialize(self, data, as_initial_state=True):
        keys = data.dtype.fields if hasattr(data, "dtype") else data
        if as_initial_state:
            self._init_data = data
        self.board = np.array(data["board"], dtype=np.uint16)
        self.goals = np.array(data["goals"], dtype=np.uint16) \
            if "goals" in keys else np.zeros_like(self.board)
        if "spawn_prob" in keys:
            self.spawn_prob = float(data["spawn_prob"])
        if "orientation" in keys:
            self.orientation = int(data["orientation"])
        if "agent_loc" in keys:
            self.agent_loc = tuple(int(v) for v in data["agent_loc"])
        if "min_performance" in keys:
            self.min_performance = float(data["min_performance"])
        self.update_exit_locs()
        self.game_over = False
        self.num_steps = 0

    def save(self, file_name=None):
        file_name = file_name or self.file_name
        if file_name is None:
            raise ValueError("Must specify a file name")
        file_name = os.path.abspath(os.path.expanduser(file_name))
        if not file_name.endswith(".npz"):
            file_name += ".npz"
        self.file_name = file_name
        self._init_data = self.serialize()
        self.num_steps = 0
        np.savez_compressed(file_name, **self._init_data)

    def revert(self):
        if hasattr(self, "_init_data"):
            self.deserialize(self._init_data)
            return True
        return False

    @classmethod
    def loaddata(cls, data):
        obj = cls(board_size=None)
        obj.deserialize(data)
        return obj

    @classmethod
    def load(cls, file_name):
        file_name = os.path.abspath(os.path.expanduser(file_name))
        obj = cls.loaddata(np.load(file_name))
        obj.file_name = file_name
        return obj

    # -- actions ------------------------------------------------------------

    def move_agent(self, direction):
        """One-cell move along ``direction`` (+1 forward, -1 backward) with
        push/pull and exit detection; returns the exit reward.

        Same classify-then-apply structure as the batched masked-write
        model (``ops/agent.py``), specialized to one board: read the
        four cells on the movement axis, decide the outcome, then apply
        the writes front-to-back.
        """
        board = self.board
        x0, y0 = self.agent_loc
        x1, y1 = self.relative_loc(direction)
        x3, y3 = self.relative_loc(2 * direction)
        front = board[y1, x1]

        if front & C.EXIT and self.can_exit():
            self.game_over = True
            return self.points_on_level_exit

        # Outcome: step into empty space, push a movable into empty space,
        # or push a movable out through an exit (it vanishes).  Anything
        # else blocks.
        step = front == C.EMPTY
        push = push_out = False
        if not step and front & C.PUSHABLE:
            beyond = board[y3, x3]
            push = beyond == C.EMPTY
            push_out = not push and bool(beyond & C.EXIT)
        if not (step or push or push_out):
            return 0

        x2, y2 = self.relative_loc(-direction)  # before agent_loc moves
        if push:
            board[y3, x3] = front
        board[y1, x1] = board[y0, x0]
        board[y0, x0] = C.EMPTY
        self.agent_loc = (x1, y1)
        # Anything pullable behind the agent follows into the vacated cell.
        trailing = board[y2, x2]
        if trailing & C.PULLABLE:
            board[y0, x0] = trailing
            board[y2, x2] = C.EMPTY
        return 0

    def execute_action(self, action):
        """Execute a named action (MOVE/TURN/FACE/TOGGLE/RESTART); returns
        the reward (reference ``execute_action`` semantics)."""
        if self.game_over:
            return 0
        verb, _, arg = action.partition(" ")
        if verb == "MOVE":
            d = ORIENTATION[arg]
            if d < 4:  # absolute move: face the direction, then step
                self.orientation = d
                return self.move_agent(1)
            return self.move_agent(5 - d)  # FORWARD -> +1, BACKWARD -> -1
        if verb == "TURN":  # TURN RIGHT -> +1, TURN LEFT -> -1
            self.orientation = (self.orientation + 2 - ORIENTATION[arg]) % 4
        elif verb == "FACE":
            self.orientation = ORIENTATION[arg]
        elif verb == "TOGGLE":
            if arg:
                self.orientation = ORIENTATION[arg]
            self._toggle_front()
        elif action == "RESTART":
            self.game_over = "RESTART"
        return 0

    def _toggle_front(self):
        """Create life in the empty cell ahead, destroy a destructible one,
        or absorb toggleable powers/colors from an indestructible one."""
        board = self.board
        x0, y0 = self.agent_loc
        x1, y1 = self.relative_loc(1)
        front = board[y1, x1]
        if front == C.EMPTY:
            board[y1, x1] = C.LIFE | (board[y0, x0] & C.COLORS)
        elif front & C.DESTRUCTIBLE:
            board[y1, x1] = C.EMPTY
        else:
            absorbable = (C.POWERS * self.can_toggle_powers
                          | C.COLORS * self.can_toggle_colors)
            board[y0, x0] ^= front & absorbable

    # -- editing ------------------------------------------------------------

    def _cycle_edit_color(self, full_cycle):
        """Advance the editor's paint color; returns the status message."""
        if full_cycle:
            # Counting in color-space walks all 8 colors (R is the low bit).
            self.edit_color += C.COLOR_R
        else:
            # Primary cycle: black -> red -> green -> blue -> black.
            self.edit_color = self.edit_color << 1 if self.edit_color \
                else C.COLOR_R
        self.edit_color &= C.COLORS
        return "EDIT COLOR: " + self.edit_color_name

    def execute_edit(self, command):
        """Board editor commands (reference ``execute_edit`` semantics);
        returns an optional status message."""
        goal_prefix = "EDIT GOALS: "
        if command.startswith(goal_prefix):
            # Apply the rest of the command against the goal board by
            # swapping the two planes around the edit (the reference's
            # GameWithGoals does the same swap dance).
            self.board, self.goals = self.goals, self.board
            try:
                return self.execute_edit(command[len(goal_prefix):])
            finally:
                self.board, self.goals = self.goals, self.board

        board = self.board
        x0, y0 = self.agent_loc
        x1, y1 = self.edit_loc
        verb, _, arg = command.partition(" ")

        if verb == "MOVE":
            dr, dc = _DIR[ORIENTATION[arg]]
            self.edit_loc = ((x1 + dc) % self.width,
                             (y1 + dr) % self.height)
        elif command == "PUT AGENT":
            # Relocate the agent, painting it with the edit color.
            body = board[y0, x0] & ~np.uint16(C.COLORS)
            board[y0, x0] = C.EMPTY
            board[y1, x1] = body | self.edit_color
            self.agent_loc = self.edit_loc
        elif verb == "PUT" and arg in NAMED_CELLS \
                and self.edit_loc != self.agent_loc:
            cell = NAMED_CELLS[arg]
            board[y1, x1] = cell | self.edit_color if cell else cell
        elif verb == "CHANGE" and arg.startswith("COLOR"):
            return self._cycle_edit_color(arg.endswith("FULL CYCLE"))
        elif verb == "TOGGLE" and arg in _EDIT_TOGGLES:
            board[y0, x0] ^= np.uint16(_EDIT_TOGGLES[arg])
        elif command == "REVERT":
            if not self.revert():
                return "No saved state; cannot revert."
        elif command == "ABORT LEVEL":
            self.game_over = "ABORT LEVEL"
        self.update_exit_locs()

    # -- board utilities ------------------------------------------------------

    def shift_board(self, dx, dy):
        """Translate the whole game (both planes + agent) on the torus."""
        self.board = np.roll(self.board, (dy, dx), axis=(0, 1))
        self.goals = np.roll(self.goals, (dy, dx), axis=(0, 1))
        x, y = self.agent_loc
        self.agent_loc = ((x + dx) % self.width, (y + dy) % self.height)
        self.update_exit_locs()

    def resize_board(self, dx, dy):
        """Grow (zero-pad bottom/right) or shrink (crop) both planes."""
        h2, w2 = self.height + dy, self.width + dx
        if h2 <= 0 or w2 <= 0:
            raise ValueError("Cannot resize to zero.")

        def refit(plane):
            out = np.zeros((h2, w2), plane.dtype)
            hh = min(h2, plane.shape[0])
            ww = min(w2, plane.shape[1])
            out[:hh, :ww] = plane[:hh, :ww]
            return out

        self.board = refit(self.board)
        self.goals = refit(self.goals)
        x, y = self.agent_loc
        self.agent_loc = (x % w2, y % h2)
        self.update_exit_locs()

    def clip_board(self, left=0, right=0, top=0, bottom=0):
        """Crop margins off all four sides."""
        if left + right >= self.width or top + bottom >= self.height:
            raise ValueError("Board clipped to zero")
        self.shift_board(-left, -top)
        self.resize_board(-(left + right), -(top + bottom))

    # -- physics / scoring ----------------------------------------------------

    def advance_board(self):
        """One physics step for both board and goals (reference
        SafeLifeGame.advance_board, :657-660)."""
        self.board = life_numpy.advance_board_reference(
            self.board, spawn_prob=self.spawn_prob, rng=self.rng)
        self.goals = life_numpy.advance_board_reference(
            self.goals, spawn_prob=self.spawn_prob, rng=self.rng)
        self.num_steps += 1

    @property
    def is_stochastic(self):
        return (self.board & C.SPAWNING).any()

    def current_points(self, board=None, goals=None):
        board = self.board if board is None else board
        goals = self.goals if goals is None else goals
        goal_colors = (goals & C.COLORS) >> C.COLOR_BIT
        cell_colors = (board & C.COLORS) >> C.COLOR_BIT
        alive = board & C.ALIVE
        return int(np.sum(POINT_TABLE[goal_colors, cell_colors] * alive))

    def performance_ratio(self, unit_rewards=True):
        """(completed, possible) with unit rewards and frozen-immovable
        masking (reference GameWithGoals.performance_ratio, :601-631)."""
        if not hasattr(self, "_init_data"):
            return 0, 1
        sign_table = np.sign(POINT_TABLE) if unit_rewards else POINT_TABLE

        def score(board, goals):
            goal_colors = (goals & C.COLORS) >> C.COLOR_BIT
            cell_colors = (board & C.COLORS) >> C.COLOR_BIT
            alive = (board & C.ALIVE) != 0
            frozen_immovable = (board & (
                C.FROZEN | C.PUSHABLE | C.PULLABLE)) == C.FROZEN
            mask = alive & ~frozen_immovable
            return int(np.sum(sign_table[goal_colors, cell_colors] * mask))

        b0 = np.asarray(self._init_data["board"], np.uint16)
        g0 = np.asarray(self._init_data["goals"], np.uint16)
        baseline = score(b0, g0)
        completed = score(self.board, self.goals) - baseline
        goal_colors = (self.goals & C.COLORS) >> C.COLOR_BIT
        possible = int(np.sum(sign_table.max(axis=1)[goal_colors])) - baseline
        return completed, possible

    def can_exit(self):
        if self.min_performance < 0:
            return True
        completed, total = self.performance_ratio()
        return completed >= self.min_performance * total

    def update_exit_locs(self):
        self.exit_locs = np.nonzero(self.board & C.EXIT)

    def update_exit_colors(self):
        if self.can_exit():
            exit_type = C.LEVEL_EXIT | C.COLOR_R
        else:
            exit_type = C.LEVEL_EXIT
        i1, i2 = self.exit_locs
        self.board[i1, i2] = exit_type

    def check(self, condition):
        x, y = self.relative_loc(1)
        if condition == "IFEMPTY":
            return self.board[y, x] == C.EMPTY
        raise ValueError(f"Unknown condition '{condition}'")


# Alias matching the reference's class split; all functionality lives in one
# class here (CellTypes/GameState/GameWithGoals layering is a namespace
# concern, not a capability one).
GameState = SafeLifeGame
GameWithGoals = SafeLifeGame
