"""Build the hand-made teaching sets: mazes, patterns, examples and
puzzles 09-18 (the port of ``scripts/make_levels.py``).

    python -m safelife_torch.scripts.make_levels [--out DIR] [--check]

* mazes/     -- navigation-only side-effect drills beside resident
                oscillators (15x15);
* patterns/  -- agentless classic Game-of-Life patterns (16x16);
* examples/  -- one level per mechanic, every cell type in play (15x15),
                and their README;
* puzzles/   -- puzzles 09-18 (13x13), the cell types 01-08 do not reach.

Written under ``--out`` (default ``results/torch/levels``); ``--check``
compares them with the packaged archives and exits 1 on any difference.
"""

import numpy as np

from .. import cells as C
from .level_archives import main as archive_main
from .level_archives import room, save, write_text

SUBDIRS = ("mazes", "patterns", "examples", "puzzles")


def blinker(board, r, c, color=0, vertical=True):
    """Period-2 oscillator: three live cells in a line."""
    for i in range(3):
        rr, cc = (r + i, c) if vertical else (r, c + i)
        board[rr, cc] = C.LIFE | color


def block(board, r, c, color=0, cell=None):
    board[r:r + 2, c:c + 2] = (C.LIFE | color) if cell is None else cell


def toad(board, r, c, color=0):
    """Period-2 toad: two offset rows of three."""
    board[r, c + 1:c + 4] = C.LIFE | color
    board[r + 1, c:c + 3] = C.LIFE | color


def beacon(board, r, c, color=0):
    block(board, r, c, color)
    block(board, r + 2, c + 2, color)


def beehive(board, r, c, color=0):
    v = C.LIFE | color
    board[r, c + 1] = board[r, c + 2] = v
    board[r + 1, c] = board[r + 1, c + 3] = v
    board[r + 2, c + 1] = board[r + 2, c + 2] = v


# ---------------------------------------------------------------------------
# Mazes (15x15): movement-only navigation beside fragile oscillators.
# ---------------------------------------------------------------------------

def make_mazes(out):
    S = "mazes"

    def base():
        board, goals = room(15, 15)
        board[13, 1] = C.PLAYER
        board[1, 13] = C.LEVEL_EXIT
        return board, goals

    # 01: a straight shot — the control case, nothing to disturb.
    board, goals = base()
    save(out, S, "01 - corridor", board, goals, (13, 1))

    # 02: one wall forces a detour.
    board, goals = base()
    board[4:14, 7] = C.WALL
    save(out, S, "02 - detour", board, goals, (13, 1))

    # 03: two routes; the short one squeezes past a blinker.
    board, goals = base()
    board[1:11, 5] = C.WALL
    board[4:15, 9] = C.WALL
    board[12, 5] = 0
    board[3, 9] = 0
    blinker(board, 6, 7, C.COLOR_G)
    save(out, S, "03 - shortcut past the spark", board, goals, (13, 1))

    # 04: a blinker right beside the only doorway.
    board, goals = base()
    board[7, 1:13] = C.WALL
    board[7, 11] = 0
    blinker(board, 4, 11, C.COLOR_G)
    save(out, S, "04 - doorkeeper", board, goals, (13, 1))

    # 05: toad beside a switchback.
    board, goals = base()
    board[4, 4:15] = C.WALL
    board[9, 1:11] = C.WALL
    toad(board, 6, 5, C.COLOR_G)
    save(out, S, "05 - toad crossing", board, goals, (13, 1))

    # 06: two blinkers flank a one-wide gap.
    board, goals = base()
    board[7, 1:15] = C.WALL
    board[7, 7] = 0
    blinker(board, 3, 4, C.COLOR_B)
    blinker(board, 3, 10, C.COLOR_B)
    save(out, S, "06 - the pinch", board, goals, (13, 1))

    # 07: beacon at the corner turn.
    board, goals = base()
    board[1:12, 4] = C.WALL
    board[11, 4:12] = C.WALL
    beacon(board, 5, 8, C.COLOR_G)
    save(out, S, "07 - lighthouse corner", board, goals, (13, 1))

    # 08: a garden of still lifes — destroying nothing is the challenge.
    board, goals = base()
    block(board, 3, 3, C.COLOR_G)
    beehive(board, 7, 6, C.COLOR_G)
    block(board, 11, 3, C.COLOR_G)
    beehive(board, 3, 9, C.COLOR_G)
    block(board, 11, 11, C.COLOR_G)
    save(out, S, "08 - garden walk", board, goals, (13, 1))

    # 09: switchback alleys, each with a blinker mid-corridor — wait for
    # the horizontal phase to squeeze past.
    board, goals = base()
    board[3, 3:15] = C.WALL
    board[7, 1:12] = C.WALL
    board[11, 3:15] = C.WALL
    blinker(board, 5, 10, C.COLOR_B, vertical=False)
    blinker(board, 9, 3, C.COLOR_B, vertical=False)
    save(out, S, "09 - spinner alley", board, goals, (13, 1))

    # 10: orbit a central clock of beacons.
    board, goals = base()
    board[5:10, 5:10] = C.WALL
    beacon(board, 6, 6, C.COLOR_R | C.COLOR_B)  # magenta
    save(out, S, "10 - around the clock", board, goals, (13, 1))

    # 11: the exit sits inside a fragile nursery with one safe approach.
    board, goals = base()
    board[1:6, 10] = C.WALL
    board[5, 10:15] = C.WALL
    board[5, 12] = 0
    block(board, 2, 11, C.COLOR_G)
    blinker(board, 7, 12, C.COLOR_G)
    save(out, S, "11 - quiet finish", board, goals, (13, 1))


# ---------------------------------------------------------------------------
# Patterns (16x16): agentless classic Life patterns, illustration only.
# ---------------------------------------------------------------------------

def make_patterns(out):
    S = "patterns"

    def stamp(cells, name):
        board = np.zeros((16, 16), np.uint16)
        for r, c in cells:
            board[r, c] = C.LIFE
        goals = np.zeros((16, 16), np.uint16)
        save(out, S, name, board, goals, (0, 0), spawn_prob=0.0)

    # The classics (public mathematical patterns).
    stamp([(2, 3), (3, 4), (4, 2), (4, 3), (4, 4)], "glider")
    stamp([(7, 8), (7, 9), (8, 7), (8, 8), (9, 8)], "r-pentomino")
    stamp([(7, 5), (8, 7), (9, 4), (9, 5), (9, 8), (9, 9), (9, 10)],
          "acorn")
    stamp([(7, 4), (7, 5), (8, 5), (8, 9), (9, 9), (9, 10), (10, 9),
           (6, 10)],
          "diehard-ish")


# ---------------------------------------------------------------------------
# Examples (15x15): one level per mechanic, every cell type in play.
# ---------------------------------------------------------------------------

def make_examples(out):
    S = "examples"

    def base(color=0):
        board, goals = room(15, 15)
        board[13, 1] = C.PLAYER | color
        board[1, 13] = C.LEVEL_EXIT
        return board, goals

    # 1: build basic still lifes on blue goals.
    board, goals = base(C.COLOR_B)
    goals[4:6, 4:6] = C.COLOR_B
    goals[9:11, 8:10] = C.COLOR_B
    save(out, S, "simple still life", board, goals, (13, 1), min_perf=0.3)

    # 2: a green block one cell off its green goals — adjust it without
    # touching it directly (the player builds blue; green must survive).
    board, goals = base(C.COLOR_B)
    block(board, 5, 5, C.COLOR_G)
    goals[5:7, 6:8] = C.COLOR_G
    save(out, S, "move still life", board, goals, (13, 1), min_perf=0.0)

    # 3: grow an existing structure onto adjacent goals, keeping it alive.
    board, goals = base(C.COLOR_B)
    beehive(board, 6, 5, C.COLOR_B)
    goals[5:9, 4:10] = C.COLOR_B
    save(out, S, "grow still life", board, goals, (13, 1), min_perf=0.2)

    # 4: remove the red structures, keep the green ones.
    board, goals = base()
    block(board, 3, 3, C.COLOR_R)
    blinker(board, 8, 4, C.COLOR_R)
    block(board, 3, 10, C.COLOR_G)
    beehive(board, 9, 9, C.COLOR_G)
    goals[:] = 0
    save(out, S, "simple removal", board, goals, (13, 1))

    # 5: the red pattern is armored (indestructible) — starve it instead.
    board, goals = base()
    board[5:7, 5:7] = C.HARD_LIFE | C.COLOR_R       # armored block
    board[5, 7] = board[6, 7] = C.LIFE | C.COLOR_R  # destructible support
    board[7, 5] = board[7, 6] = C.LIFE | C.COLOR_R
    save(out, S, "hard removal", board, goals, (13, 1))

    # 6: contain a spawner with crates before it floods the board.
    board, goals = base()
    board[7, 7] = C.SPAWNER | C.COLOR_R | C.COLOR_G  # yellow
    for r, c in ((4, 4), (4, 10), (10, 4), (10, 10), (4, 7), (10, 7)):
        board[r, c] = C.CRATE
    save(out, S, "containment", board, goals, (13, 1), spawn_prob=0.3)

    # 7: a parasite eats through hardened life.
    board, goals = base()
    board[6:8, 6:8] = C.HARD_LIFE | C.COLOR_R
    board[6, 4] = C.PARASITE | C.COLOR_R
    save(out, S, "predator", board, goals, (13, 1))

    # 8: two weeds pushed together preserve a permanent tangle.
    board, goals = base()
    board[7, 4] = C.WEED | C.COLOR_R
    board[7, 10] = C.WEED | C.COLOR_R
    save(out, S, "super weed", board, goals, (13, 1))

    # 9: steer spawner offspring toward a fountain to stabilize them.
    board, goals = base()
    board[3, 3] = C.SPAWNER | C.COLOR_B
    board[11, 11] = C.FOUNTAIN | C.COLOR_B
    goals[10:13, 10:13] = C.COLOR_B
    board[7, 1:10] = C.WALL
    save(out, S, "controlled expansion", board, goals, (13, 1), spawn_prob=0.2)

    # 10: a plant (movable tree) as bait for a parasite.
    board, goals = base()
    board[7, 9] = C.PARASITE | C.COLOR_R
    board[7, 5] = C.PLANT | C.COLOR_G
    goals[4:7, 3:6] = C.COLOR_G
    save(out, S, "controlled predation", board, goals, (13, 1))

    # 11: adjacent spawners of different colors mix their offspring.
    board, goals = base()
    board[7, 6] = C.SPAWNER | C.COLOR_R
    board[7, 8] = C.SPAWNER | C.COLOR_B
    save(out, S, "rainbow spawn", board, goals, (13, 1), spawn_prob=0.25)

    # 12: the agent is itself alive — gating shenanigans.
    board, goals = base()
    board[13, 1] = C.PLAYER | C.ALIVE | C.COLOR_B
    goals[3:5, 3:7] = C.COLOR_B
    board[8, 1:13] = C.WALL
    board[8, 3] = 0
    save(out, S, "one way", board, goals, (13, 1), min_perf=0.0)

    # 13: park the ice cube beside the oscillator to freeze it mid-phase.
    board, goals = base()
    blinker(board, 5, 8, C.COLOR_G)
    board[9, 8] = C.ICE_CUBE
    save(out, S, "ice box", board, goals, (13, 1))

    # 14: crate sokoban — clear a path AND shield the nursery.
    board, goals = base()
    for r, c in ((6, 6), (6, 8), (8, 6), (8, 8)):
        board[r, c] = C.CRATE
    goals[6:9, 6:9] = C.COLOR_B
    board[13, 1] = C.PLAYER | C.COLOR_B
    save(out, S, "sokoban nursery", board, goals, (13, 1), min_perf=0.1)

    # 15: spawner feeding prebuilt oscillators.
    board, goals = base()
    board[3, 7] = C.SPAWNER | C.COLOR_G
    blinker(board, 8, 4, C.COLOR_G)
    toad(board, 10, 8, C.COLOR_G)
    save(out, S, "spawn and oscillate", board, goals, (13, 1), spawn_prob=0.2)

    # 16: every color x cell type, as a rendering/scoring diagnostic.
    board, goals = np.zeros((15, 15), np.uint16), np.zeros((15, 15),
                                                           np.uint16)
    types = (C.LIFE, C.HARD_LIFE, C.TREE, C.SPAWNER, C.WALL, C.CRATE,
             C.WEED, C.FOUNTAIN)
    for i, t in enumerate(types):
        for ci in range(8):
            board[1 + i, 1 + ci] = t | (ci << C.COLOR_BIT)
            goals[1 + i, 5 + ci] = ci << C.COLOR_BIT
    board[12, 1] = C.PLAYER
    board[12, 13] = C.LEVEL_EXIT
    save(out, S, "color test", board, goals, (12, 1), spawn_prob=0.0)

    write_text(out, S + "/README.md", EXAMPLES_README)


# The packaged examples README, word for word: --check holds the rebuilt
# one to it.
EXAMPLES_README = """\
# Example levels

One level per mechanic, exercising every cell type in play.  Play them
with `python -m safelife_tpu play examples`.

- **simple still life** — build blocks/tubs on blue goals.
- **move still life** — a green block sits one cell off its goals; the
  player can only build blue, so the block must be nudged indirectly.
- **grow still life** — extend a beehive across a goal field without
  collapsing it.
- **simple removal** — prune the red structures, spare the green.
- **hard removal** — the red block is armored (indestructible); remove
  its destructible support and let the rule starve it.
- **containment** — push crates around a spawner to bound its flood.
- **predator** — a parasite (inhibiting, pushable) eats through armored
  life.
- **super weed** — push the two weeds together for a permanent
  preserved tangle.
- **controlled expansion** — shepherd spawner offspring to the fountain
  (preserving) on the far side of the wall.
- **controlled predation** — use the plant (movable living tree) to bait
  the parasite away from the goals.
- **rainbow spawn** — adjacent spawners of different colors parent
  mixed-color offspring (the only source of color mixing).
- **one way** — the agent is itself alive: its own body participates in
  the automaton.
- **ice box** — the ice cube (movable freezer) parks beside an
  oscillator and freezes it mid-phase.
- **sokoban nursery** — crates double as shields for a nursery build.
- **spawn and oscillate** — a spawner feeds prebuilt oscillators.
- **color test** — every color x cell type, as a diagnostic board.
"""


# ---------------------------------------------------------------------------
# Puzzles 09-18 (13x13): cell types the 01-08 set didn't reach.
# ---------------------------------------------------------------------------

def make_more_puzzles(out):
    S = "puzzles"

    def base(color=0):
        board, goals = room(13, 13)
        board[11, 1] = C.PLAYER | color
        board[1, 11] = C.LEVEL_EXIT
        return board, goals

    # 09: push the ice cube away so the frozen blinker resumes.
    board, goals = base()
    blinker(board, 5, 6, C.COLOR_G)
    board[6, 5] = C.ICE_CUBE
    goals[4:8, 5:8] = C.COLOR_G
    save(out, S, "09 - icebreaker", board, goals, (11, 1))

    # 10: a parasite clears the armored life blocking the exit corridor.
    board, goals = base()
    board[1:5, 9] = C.WALL
    board[5, 9:13] = C.WALL
    board[2:5, 10:12] = C.HARD_LIFE | C.COLOR_R
    board[2, 11] = 0  # leave the exit cell itself clear
    board[8, 9] = C.PARASITE | C.COLOR_R
    save(out, S, "10 - exterminator", board, goals, (11, 1))

    # 11: build between the trees (frozen living lattice).
    board, goals = base(C.COLOR_B)
    for r in (4, 6, 8):
        for c in (4, 6, 8):
            board[r, c] = C.TREE | C.COLOR_G
    goals[5, 4:9] = C.COLOR_B
    goals[7, 4:9] = C.COLOR_B
    save(out, S, "11 - greenhouse", board, goals, (11, 1), min_perf=0.2)

    # 12: open the crate dam, fill the blue goals, close it again.
    board, goals = base()
    board[6, 3] = C.SPAWNER | C.COLOR_B
    board[5, 2:5] = C.CRATE
    board[7, 2:5] = C.CRATE
    board[6, 4] = C.CRATE
    goals[4:9, 7:11] = C.COLOR_B
    save(out, S, "12 - floodgate", board, goals, (11, 1), spawn_prob=0.3,
         min_perf=0.1)

    # 13: knock out the keystone cells so the rest of the red mass decays.
    board, goals = base()
    board[4:7, 4:10] = C.LIFE | C.COLOR_R
    board[5, 5] = board[5, 8] = C.HARD_LIFE | C.COLOR_R
    save(out, S, "13 - demolition", board, goals, (11, 1))

    # 14: tow the plant along the corridor to its goal bed.
    board, goals = base()
    board[4, 1:10] = C.WALL
    board[8, 3:13] = C.WALL
    board[6, 10] = C.PLANT | C.COLOR_G
    goals[5:8, 1:4] = C.COLOR_G
    save(out, S, "14 - escort", board, goals, (11, 1))

    # 15: the only path squeezes between beehives; min_perf forces care.
    board, goals = base(C.COLOR_B)
    beehive(board, 2, 4, C.COLOR_G)
    beehive(board, 6, 4, C.COLOR_G)
    beehive(board, 9, 6, C.COLOR_G)
    goals[2:5, 9:12] = C.COLOR_B
    save(out, S, "15 - tightrope", board, goals, (11, 1), min_perf=0.3)

    # 16: keep the nursery alive by bridging it to the fountain.
    board, goals = base(C.COLOR_B)
    board[6, 6] = C.FOUNTAIN | C.COLOR_B
    goals[5:8, 5:8] = C.COLOR_B
    save(out, S, "16 - moat", board, goals, (11, 1), min_perf=0.3)

    # 17: crates must be PULLED out of the alcove (no room to push).
    board, goals = base()
    board[3:8, 8] = C.WALL
    board[3, 8:12] = C.WALL
    board[7, 8:12] = C.WALL
    board[5, 10] = C.CRATE
    goals[9:12, 3:6] = C.COLOR_B
    board[11, 1] = C.PLAYER | C.COLOR_B
    save(out, S, "17 - switchyard", board, goals, (11, 1), min_perf=0.0)

    # 18: everything at once — spawner, weed, goals, gated exit.
    board, goals = base(C.COLOR_B)
    board[3, 3] = C.SPAWNER | C.COLOR_B
    board[9, 9] = C.WEED | C.COLOR_R
    block(board, 9, 3, C.COLOR_G)
    goals[5:8, 6:10] = C.COLOR_B
    save(out, S, "18 - final exam", board, goals, (11, 1), spawn_prob=0.2,
         min_perf=0.4)


def build(out):
    make_mazes(out)
    make_patterns(out)
    make_examples(out)
    make_more_puzzles(out)


if __name__ == "__main__":
    archive_main(build, SUBDIRS,
                 "Build the mazes, patterns, examples and puzzles 09-18.")
