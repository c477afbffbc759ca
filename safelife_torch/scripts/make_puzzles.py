"""Build the hand-made teaching puzzles 01-08 (the port of
``scripts/make_puzzles.py``).

    python -m safelife_torch.scripts.make_puzzles [--out DIR] [--check]

Small single-idea boards introducing movement, building, pruning,
pushing, pulling, preservation, spawners and oscillator timing, written
to ``<out>/puzzles`` (default ``results/torch/levels``).  ``--check``
compares them with the packaged ``puzzles/`` archives and exits 1 on any
difference.
"""

import numpy as np

from .. import cells as C
from .level_archives import main as archive_main
from .level_archives import room, save

S = "puzzles"


def p01_first_steps(out):
    board, goals = room(13, 13)
    board[6, 2] = C.PLAYER
    board[6, 10] = C.LEVEL_EXIT | C.COLOR_R
    # a couple of walls to steer around
    board[3:10, 6] = C.WALL
    board[6, 6] = 0
    save(out, S, "01 - first steps", board, goals, (6, 2))


def p02_gardener(out):
    board, goals = room(13, 13)
    board[6, 2] = C.PLAYER | C.COLOR_B
    board[6, 10] = C.LEVEL_EXIT
    # build a 2x2 block of blue life on the goal pad (a still life!)
    goals[5:7, 5:7] = C.COLOR_B
    save(out, S, "02 - gardener", board, goals, (6, 2), min_perf=0.5)


def p03_weeding(out):
    board, goals = room(13, 13)
    board[6, 2] = C.PLAYER
    board[6, 10] = C.LEVEL_EXIT
    # a red still-life block and beehive to remove
    board[3:5, 5:7] = C.LIFE | C.COLOR_R
    rr, cc = np.array([8, 9, 9, 10, 8, 9]), np.array([5, 4, 6, 5, 6, 7])
    board[rr, cc] = 0
    board[8, 5:7] = C.LIFE | C.COLOR_R
    board[9, 4] = board[9, 7] = C.LIFE | C.COLOR_R
    board[10, 5:7] = C.LIFE | C.COLOR_R
    save(out, S, "03 - weeding", board, goals, (6, 2), min_perf=0.5)


def p04_warehouse(out):
    board, goals = room(13, 13)
    board[6, 2] = C.PLAYER
    board[6, 10] = C.LEVEL_EXIT | C.COLOR_R
    # a walled corridor with a crate in the way: push it all the way down
    # the corridor and out through the exit (it vanishes)
    board[5, 1:12] = C.WALL
    board[7, 1:12] = C.WALL
    board[6, 6] = C.CRATE
    save(out, S, "04 - warehouse", board, goals, (6, 2))


def p05_tug(out):
    board, goals = room(13, 13)
    board[6, 2] = C.PLAYER
    board[6, 10] = C.LEVEL_EXIT | C.COLOR_R
    # a green plant stuck in a dead-end pocket against the top wall: it
    # cannot be pushed (nowhere to go), only PULLED out — walk under it,
    # then walk backwards.  Parking it on the green goal pad opens the
    # exit.
    board[2, 5] = board[2, 7] = C.WALL
    board[3, 5] = board[3, 7] = C.WALL
    board[2, 6] = C.PLANT | C.COLOR_G
    goals[6, 6] = C.COLOR_G
    save(out, S, "05 - tug", board, goals, (6, 2), min_perf=0.5)


def p06_china_shop(out):
    board, goals = room(13, 13)
    board[6, 2] = C.PLAYER | C.COLOR_B
    board[6, 10] = C.LEVEL_EXIT
    # fragile green still lifes on both sides of the path: leave them be
    for r in (3, 9):
        board[r:r + 2, 5:7] = C.LIFE | C.COLOR_G
        goals[r:r + 2, 5:7] = C.COLOR_G
    goals[6:8, 3:5] = C.COLOR_B  # build a blue block, gently
    save(out, S, "06 - china shop", board, goals, (6, 2), min_perf=0.4)


def p07_the_hatchery(out):
    board, goals = room(13, 13)
    board[6, 2] = C.PLAYER
    board[6, 10] = C.LEVEL_EXIT | C.COLOR_R
    # a fenced spawner spews yellow life into the room's center
    board[3, 6] = C.SPAWNER | C.COLOR_G
    for dr, dc in ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1)):
        board[3 + dr, 6 + dc] = C.WALL
    save(out, S, "07 - the hatchery", board, goals, (6, 2), spawn_prob=0.3)


def p08_metronome(out):
    board, goals = room(13, 13)
    board[6, 2] = C.PLAYER
    board[6, 10] = C.LEVEL_EXIT
    # a red blinker: it flips orientation every step, so removing it
    # means hitting cells as they appear — timing against the CA clock
    board[3, 5:8] = C.LIFE | C.COLOR_R
    save(out, S, "08 - metronome", board, goals, (6, 2), min_perf=0.5)


PUZZLES = (p01_first_steps, p02_gardener, p03_weeding, p04_warehouse,
           p05_tug, p06_china_shop, p07_the_hatchery, p08_metronome)


def build(out):
    for fn in PUZZLES:
        fn(out)


if __name__ == "__main__":
    archive_main(build, (S,), "Build the teaching puzzles 01-08.")
