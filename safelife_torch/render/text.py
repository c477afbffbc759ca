"""ANSI terminal renderer for SafeLife boards (the port's copy of
``safelife_tpu.render.text``, numpy only).

Capability parity with ``safelife/render_text.py``: per-cell glyph + color
mapping (foreground = cell color, background = goal color), bordered board
rendering, agent-centered views, the edit cursor, and ``cell_name`` used by
logs.  Glyphs follow the reference's conventions so levels look familiar.
"""

import numpy as np

from .. import cells as C
from ..cells import POINT_TABLE

# 256-color ANSI: light pastel backgrounds for goals, strong foregrounds
# for cells, indexed KRGYBMCW.
BACKGROUND_COLORS = [
    "\x1b[48;5;251m", "\x1b[48;5;217m", "\x1b[48;5;114m", "\x1b[48;5;229m",
    "\x1b[48;5;117m", "\x1b[48;5;183m", "\x1b[48;5;123m", "\x1b[48;5;255m",
]
FOREGROUND_COLORS = [
    "\x1b[38;5;0m", "\x1b[38;5;1m", "\x1b[38;5;2m", "\x1b[38;5;172m",
    "\x1b[38;5;12m", "\x1b[38;5;129m", "\x1b[38;5;39m", "\x1b[38;5;244m",
]

GLYPHS = {
    C.EMPTY: " ",
    C.LIFE: "z",
    C.HARD_LIFE: "Z",
    C.WALL: "#",
    C.CRATE: "%",
    C.PLANT: "&",
    C.TREE: "T",
    C.ICE_CUBE: "=",
    C.PARASITE: "!",
    C.WEED: "@",
    C.SPAWNER: "s",
    C.HARD_SPAWNER: "S",
    C.LEVEL_EXIT: "X",
    C.FOUNTAIN: "\x1b[1m+",
}

TYPE_NAMES = {
    C.EMPTY: "empty",
    C.LIFE: "life",
    C.HARD_LIFE: "hard-life",
    C.WALL: "wall",
    C.CRATE: "crate",
    C.PLANT: "plant",
    C.TREE: "tree",
    C.ICE_CUBE: "ice-cube",
    C.PARASITE: "parasite",
    C.WEED: "weed",
    C.SPAWNER: "spawner",
    C.HARD_SPAWNER: "hard-spawner",
    C.LEVEL_EXIT: "exit",
    C.FOUNTAIN: "fountain",
}

COLOR_WORDS = {0: "gray", C.COLORS: "white"}
COLOR_WORDS.update({v: k for k, v in C.COLOR_NAMES.items()
                    if v not in (0, C.COLORS)})

AGENT_ARROWS = "⋀>⋁<"


def cell_name(cell):
    """Readable 'type-color' name of a cell value (used in logs)."""
    cell = int(cell)
    ctype = TYPE_NAMES.get(cell & ~C.COLORS, "unknown")
    color = COLOR_WORDS.get(cell & C.COLORS, "x")
    return f"{ctype}-{color}"


def render_cell(cell, goal=0, orientation=0, edit_color=None):
    """One cell -> a two-character ANSI string (cursor slot + glyph)."""
    cell = int(cell)
    goal_color = (int(goal) & C.COLORS) >> C.COLOR_BIT
    cell_color = (cell & C.COLORS) >> C.COLOR_BIT
    out = BACKGROUND_COLORS[goal_color]
    out += " " if edit_color is None else FOREGROUND_COLORS[edit_color] + "∎"
    out += FOREGROUND_COLORS[cell_color]
    if cell & C.AGENT:
        out += "\x1b[1m" + AGENT_ARROWS[orientation % 4]
    else:
        gray = cell & ~C.COLORS
        glyph = GLYPHS.get(gray, "?")
        if gray == C.EMPTY and cell_color:
            glyph = "."
        out += glyph
    return out + "\x1b[0m"


def recenter_view(board, view_size, center, move_to_perimeter=None):
    """Torus crop of ``board`` centered at ``center`` (row, col); optional
    indices moved to the view perimeter when out of sight (reference
    ``helper_utils.recenter_view``)."""
    h, w = view_size
    bh, bw = board.shape
    y0, x0 = center
    rows = (np.arange(h) + y0 - h // 2) % bh
    cols = (np.arange(w) + x0 - w // 2) % bw
    view = board[np.ix_(rows, cols)].copy()
    if move_to_perimeter is not None:
        iy, ix = move_to_perimeter
        jy = (np.asarray(iy) - y0 + bh // 2) % bh - bh // 2
        jx = (np.asarray(ix) - x0 + bw // 2) % bw - bw // 2
        jy = np.clip(jy + h // 2, 0, h - 1)
        jx = np.clip(jx + w // 2, 0, w - 1)
        view[jy, jx] = board[iy, ix]
    return view


def render_board(board, goals=0, orientation=0, edit_loc=None, edit_color=0):
    """Render a raw board (+goals) to an ANSI string with a box border."""
    board = np.asarray(board)
    goals = np.broadcast_to(np.asarray(goals), board.shape)
    h, w = board.shape
    lines = [" +" + " -" * w + " +"]
    for y in range(h):
        row = " |"
        for x in range(w):
            ec = edit_color if edit_loc is not None and \
                (edit_loc[0], edit_loc[1]) == (x, y) else None
            row += render_cell(board[y, x], goals[y, x], orientation, ec)
        lines.append(row + " |")
    lines.append(" +" + " -" * w + " +")
    return "\n".join(lines) + "\n"


def render_game(game, view_size=None, edit_mode=None):
    """Render a SafeLifeGame (optionally agent/cursor-centered view)."""
    if view_size is not None:
        center = game.edit_loc if edit_mode else game.agent_loc
        center_rc = (center[1], center[0])
        board = recenter_view(game.board, view_size, center_rc,
                              game.exit_locs)
        goals = recenter_view(game.goals, view_size, center_rc)
        edit_loc = (view_size[1] // 2, view_size[0] // 2) if edit_mode \
            else None
    else:
        board = game.board
        goals = game.goals
        edit_loc = game.edit_loc if edit_mode else None
    if edit_mode == "GOALS":
        board, goals = goals, board
    edit_color = (game.edit_color & C.COLORS) >> C.COLOR_BIT
    return render_board(board, goals, game.orientation, edit_loc, edit_color)


def agent_powers(game):
    x0, y0 = game.agent_loc
    agent = int(game.board[y0, x0])
    names = [(C.ALIVE, "alive"), (C.PRESERVING, "preserving"),
             (C.INHIBITING, "inhibiting"), (C.SPAWNING, "spawning")]
    powers = [txt for bit, txt in names if agent & bit]
    return ", ".join(powers) or "none"


def print_reward_table():
    text = ""
    for r in range(8):
        text += BACKGROUND_COLORS[r]
        for c in range(8):
            text += FOREGROUND_COLORS[c] + "{:2d} ".format(POINT_TABLE[r, c])
        text += "\x1b[0m\n"
    print(text)
