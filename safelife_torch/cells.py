"""Cell-type bit flags of the SafeLife cellular automaton.

Every cell on a board is one ``uint16`` bit field.  The layout is the wire
format shared by the level archives, the CA rule, the agent ops and the
CUDA kernels (``csrc/safelife_rule.cuh`` repeats the constants it needs).

Bit layout::

    bit  0  alive        cell obeys Game-of-Life rules
    bit  1  agent        cell occupied by the agent (rendering only)
    bit  2  pushable     agent can push the cell
    bit  3  destructible agent can destroy the cell
    bit  4  frozen       cell never changes during evolution
    bit  5  preserving   neighbors of this cell never die
    bit  6  inhibiting   neighbors of this cell are never born
    bit  7  spawning     stochastically creates living neighbors
    bit  8  exit         level exit marker
    bit  9  color_r
    bit 10  color_g
    bit 11  color_b
    bit 15  pullable     agent can pull the cell
"""

import numpy as np

ALIVE_BIT = 0
AGENT_BIT = 1
PUSHABLE_BIT = 2
DESTRUCTIBLE_BIT = 3
FROZEN_BIT = 4
PRESERVING_BIT = 5
INHIBITING_BIT = 6
SPAWNING_BIT = 7
EXIT_BIT = 8
COLOR_BIT = 9
PULLABLE_BIT = 15

ALIVE = 1 << ALIVE_BIT
AGENT = 1 << AGENT_BIT
PUSHABLE = 1 << PUSHABLE_BIT
DESTRUCTIBLE = 1 << DESTRUCTIBLE_BIT
FROZEN = 1 << FROZEN_BIT
PRESERVING = 1 << PRESERVING_BIT
INHIBITING = 1 << INHIBITING_BIT
SPAWNING = 1 << SPAWNING_BIT
EXIT = 1 << EXIT_BIT
COLOR_R = 1 << COLOR_BIT
COLOR_G = 1 << (COLOR_BIT + 1)
COLOR_B = 1 << (COLOR_BIT + 2)
PULLABLE = 1 << PULLABLE_BIT

COLORS = COLOR_R | COLOR_G | COLOR_B  # a.k.a. rainbow_color

EMPTY = 0
FREEZING = INHIBITING | PRESERVING
# The player is destructible so it never parents indestructible offspring.
PLAYER = AGENT | FREEZING | FROZEN | DESTRUCTIBLE
WALL = FROZEN
MOVABLE = PUSHABLE | PULLABLE
CRATE = FROZEN | MOVABLE
SPAWNER = FROZEN | SPAWNING | DESTRUCTIBLE
HARD_SPAWNER = FROZEN | SPAWNING
LEVEL_EXIT = FROZEN | EXIT
LIFE = ALIVE | DESTRUCTIBLE
HARD_LIFE = ALIVE
ICE_CUBE = FROZEN | FREEZING | MOVABLE
PLANT = FROZEN | ALIVE | MOVABLE
TREE = FROZEN | ALIVE
FOUNTAIN = PRESERVING | FROZEN
PARASITE = INHIBITING | ALIVE | PUSHABLE | FROZEN
WEED = PRESERVING | ALIVE | PUSHABLE | FROZEN
POWERS = ALIVE | FREEZING | SPAWNING  # absorbable "powers" bits

COLOR_TUPLE = (COLOR_R, COLOR_G, COLOR_B)

COLOR_NAMES = {
    "black": 0,
    "red": COLOR_R,
    "green": COLOR_G,
    "blue": COLOR_B,
    "yellow": COLOR_R | COLOR_G,
    "magenta": COLOR_R | COLOR_B,
    "cyan": COLOR_G | COLOR_B,
    "white": COLORS,
}

# Index (0..7) -> color name, ordered KRGYBMCW by the 3-bit color value.
COLOR_INDEX_NAMES = (
    "black", "red", "green", "yellow", "blue", "magenta", "cyan", "white")

NAMED_CELLS = {
    "EMPTY": EMPTY,
    "LIFE": LIFE,
    "HARD LIFE": HARD_LIFE,
    "WALL": WALL,
    "CRATE": CRATE,
    "SPAWNER": SPAWNER,
    "HARD SPAWNER": HARD_SPAWNER,
    "EXIT": LEVEL_EXIT,
    "ICECUBE": ICE_CUBE,
    "PLANT": PLANT,
    "TREE": TREE,
    "FOUNTAIN": FOUNTAIN,
    "PARASITE": PARASITE,
    "WEED": WEED,
}

# Goal-color (row) x cell-color (column) -> points per live cell, colors
# ordered KRGYBMCW by their 3-bit value.  Part of the wire format: levels
# are only interchangeable if scoring matches.
POINT_TABLE = np.array([
    #  k   r   g   y   b   m   c   w
    [+0, -1, +0, +0, +0, +0, +0, +0],   # black / no goal
    [-3, +3, -3, +0, -3, +0, -3, -3],   # red goal
    [+0, -3, +5, +0, +0, +0, +3, +0],   # green goal
    [-3, +0, +0, +3, +0, +0, +0, +0],   # yellow goal
    [+3, -3, +3, +0, +5, +3, +3, +3],   # blue goal
    [-3, +3, -3, +0, -3, +5, -3, -3],   # magenta goal
    [+3, -3, +3, +0, +3, +0, +5, +3],   # cyan goal
    [+0, -1, +0, +0, +0, +0, +0, +0],   # white / rainbow goal
], dtype=np.int32)
POINT_TABLE.setflags(write=False)


class CellTypes:
    """Namespace mirroring the reference ``CellTypes`` attribute API."""

    alive_bit = ALIVE_BIT
    agent_bit = AGENT_BIT
    pushable_bit = PUSHABLE_BIT
    pullable_bit = PULLABLE_BIT
    destructible_bit = DESTRUCTIBLE_BIT
    frozen_bit = FROZEN_BIT
    preserving_bit = PRESERVING_BIT
    inhibiting_bit = INHIBITING_BIT
    spawning_bit = SPAWNING_BIT
    exit_bit = EXIT_BIT
    color_bit = COLOR_BIT

    alive = np.uint16(ALIVE)
    agent = np.uint16(AGENT)
    pushable = np.uint16(PUSHABLE)
    pullable = np.uint16(PULLABLE)
    destructible = np.uint16(DESTRUCTIBLE)
    frozen = np.uint16(FROZEN)
    preserving = np.uint16(PRESERVING)
    inhibiting = np.uint16(INHIBITING)
    spawning = np.uint16(SPAWNING)
    exit = np.uint16(EXIT)
    color_r = np.uint16(COLOR_R)
    color_g = np.uint16(COLOR_G)
    color_b = np.uint16(COLOR_B)

    empty = np.uint16(EMPTY)
    freezing = np.uint16(FREEZING)
    player = np.uint16(PLAYER)
    wall = np.uint16(WALL)
    movable = np.uint16(MOVABLE)
    crate = np.uint16(CRATE)
    spawner = np.uint16(SPAWNER)
    hard_spawner = np.uint16(HARD_SPAWNER)
    level_exit = np.uint16(LEVEL_EXIT)
    life = np.uint16(LIFE)
    colors = tuple(np.uint16(c) for c in COLOR_TUPLE)
    rainbow_color = np.uint16(COLORS)
    ice_cube = np.uint16(ICE_CUBE)
    plant = np.uint16(PLANT)
    tree = np.uint16(TREE)
    fountain = np.uint16(FOUNTAIN)
    parasite = np.uint16(PARASITE)
    weed = np.uint16(WEED)
    powers = np.uint16(POWERS)
