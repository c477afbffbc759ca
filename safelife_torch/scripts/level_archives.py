"""What the level-data scripts share (``make_puzzles``, ``make_levels``,
``make_v01_levels``): single-level archives in the packaged wire format,
written under an output folder that mirrors the packaged level data
(``levels/loader.PACKAGED_LEVELS``), and ``--check``, which compares what
a script wrote with the packaged files, array for array.

Each writes where ``--out`` points (default
``results/torch/levels``), never into the packaged tree.
"""

import argparse
import os
import sys

import numpy as np

from .. import cells as C
from ..game import SafeLifeGame
from ..levels.loader import PACKAGED_LEVELS
from . import RESULTS

DEFAULT_OUT = os.path.join(RESULTS, "levels")
# The game class the packaged archives name.  It is a label the loaders
# ignore; the scripts write it so that their archives equal the packaged
# ones field for field.
ARCHIVE_CLASS = "safelife_tpu.game.SafeLifeGame"


def room(h, w):
    """An (h, w) board walled on its border, and empty goals."""
    board = np.zeros((h, w), np.uint16)
    board[0, :] = board[-1, :] = board[:, 0] = board[:, -1] = C.WALL
    return board, np.zeros((h, w), np.uint16)


def write_game(out, subdir, name, game):
    """``game``'s archive ``<out>/<subdir>/<name>.npz``."""
    os.makedirs(os.path.join(out, subdir), exist_ok=True)
    np.savez_compressed(os.path.join(out, subdir, name + ".npz"),
                        **dict(game.serialize(), **{"class": ARCHIVE_CLASS}))
    print("wrote", subdir + "/" + name)


def save(out, subdir, name, board, goals, agent, min_perf=-1.0,
         spawn_prob=0.3, orientation=1):
    """A hand-made level: ``agent`` is (row, col)."""
    game = SafeLifeGame(board_size=None)
    game.deserialize({
        "board": board, "goals": goals,
        "agent_loc": (agent[1], agent[0]),  # (x, y)
        "orientation": orientation,
        "spawn_prob": spawn_prob,
        "min_performance": min_perf,
    })
    write_game(out, subdir, name, game)


def write_text(out, path, text):
    os.makedirs(os.path.dirname(os.path.join(out, path)), exist_ok=True)
    with open(os.path.join(out, path), "w") as fh:
        fh.write(text)
    print("wrote", path)


def differences(out, subdirs):
    """Each file under ``<out>/<subdir>`` that differs from its packaged
    counterpart (a missing file, another field set, a field of another
    dtype, shape or value, other text), as (path, reason)."""
    found = []
    for subdir in subdirs:
        for name in sorted(os.listdir(os.path.join(out, subdir))):
            path = os.path.join(subdir, name)
            packaged = os.path.join(PACKAGED_LEVELS, path)
            if not os.path.isfile(packaged):
                found.append((path, "not packaged"))
            elif name.endswith(".npz"):
                with np.load(os.path.join(out, path)) as got, \
                        np.load(packaged) as want:
                    if sorted(got.files) != sorted(want.files):
                        found.append((path, f"fields {got.files}"))
                        continue
                    for key in want.files:
                        a, b = got[key], want[key]
                        if a.dtype != b.dtype or not np.array_equal(a, b):
                            found.append((path, key))
            else:
                with open(os.path.join(out, path)) as a, open(packaged) as b:
                    if a.read() != b.read():
                        found.append((path, "text"))
    return found


def main(build, subdirs, description, argv=None):
    """A level-data script's command line: ``build(out)`` into ``--out``;
    with ``--check``, exit 1 when anything written under ``subdirs``
    differs from the packaged level data."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--out", default=DEFAULT_OUT,
                        help="the level-data folder to write into")
    parser.add_argument("--check", action="store_true",
                        help="compare what was written with the packaged "
                             "level data")
    args = parser.parse_args(argv)
    build(args.out)
    if args.check:
        found = differences(args.out, subdirs)
        for path, reason in found:
            print(f"differs: {path} ({reason})")
        print(f"check: {len(found)} differences from {PACKAGED_LEVELS}")
        if found:
            sys.exit(1)
