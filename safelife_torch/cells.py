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
