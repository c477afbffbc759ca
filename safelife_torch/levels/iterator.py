"""Level iteration and archive utilities (port of
``safelife_tpu.levels.iterator``, static level files only).

Capability parity with the generator half of ``safelife/file_finder.py``:
``safelife_loader`` yielding ``SafeLifeGame`` objects with repeat/shuffle
semantics over level files, and the archive utilities ``combine_levels``
and ``expand_levels`` used to build frozen benchmark suites.

The batched path doesn't iterate games one at a time — it gathers levels
from a device bank (``loader.build_bank``); this module serves the
host-side surfaces (the gym adapter, interactive play, benchmark
authoring).  Procedural generation (task names, yaml/json parameter files,
``gen_many``, ``gen_benchmarks``) is ROADMAP item A6 and raises
``NotImplementedError`` until it is ported.
"""

import glob
import itertools
import os
import random

import numpy as np

from ..game import SafeLifeGame
from . import loader

# Level files, and the procgen parameter files that A6 will read.
FILE_TYPES = ("npz", "yaml", "json")


def procgen_unported(what):
    """The error of every entry point that needs procedural generation."""
    return NotImplementedError(
        f"{what}: procedural level generation is ROADMAP item A6, not "
        f"ported yet; pass level files (npz) instead")


def _load_entries(paths):
    """Resolve paths to (name, level data) entries."""
    if not paths:
        raise procgen_unported("no level files given (the default procgen "
                               "task)")
    entries = []
    for path in paths:
        try:
            fnames = list(loader.find_files(path, file_types=FILE_TYPES))
        except FileNotFoundError:
            raise procgen_unported(
                f"'{path}' is no level file (a procgen task name?)") from None
        for fname in fnames:
            if not fname.endswith(".npz"):
                raise procgen_unported(f"procgen parameter file '{fname}'")
            with np.load(fname) as data:
                if "levels" in data:
                    for rec in data["levels"]:
                        name = os.path.join(fname[:-4], str(rec["name"]))
                        entries.append(
                            (name, {k: rec[k] for k in rec.dtype.fields}))
                else:
                    entries.append(
                        (fname, {k: data[k] for k in data.files}))
    return entries


def _game_from_entry(name, payload):
    game = SafeLifeGame.loaddata(payload)
    game.file_name = name
    return game


def safelife_loader(*paths, repeat="auto", shuffle=False):
    """An iterator of SafeLifeGame instances from level files (single-level
    npz files and ``levels`` archives, globs and directories, as
    ``loader.find_files`` resolves them).

    ``repeat``: True repeats forever, an int that many times, False once;
    "auto" repeats forever only a single procgen entry, so level files
    play once.  ``shuffle`` reshuffles the levels before each pass.  The
    paths are resolved here, so a path that is no level file raises at
    once.
    """
    entries = _load_entries(paths)
    if repeat == "auto":
        repeat = False
    if isinstance(repeat, bool):
        loop = itertools.count() if repeat else range(1)
    else:
        loop = range(repeat)

    def games():
        for _ in loop:
            if shuffle:
                random.shuffle(entries)
            for entry in entries:
                yield _game_from_entry(*entry)
    return games()


# --- archive utilities ------------------------------------------------------

def gen_many(param_file, out_dir, num_gen, num_workers=8, max_queue=100):
    """Generate and save many levels as individual npz files (A6)."""
    raise procgen_unported("gen_many")


def combine_levels(directory, out_file=None):
    """Merge a directory of single-level npz files into one archive with a
    structured 'levels' array (the benchmark wire format)."""
    files = sorted(glob.glob(os.path.join(directory, "*.npz")))
    if not files:
        raise FileNotFoundError(f"no levels in {directory}")
    all_data = []
    max_name_len = 0
    for fname in files:
        with np.load(fname) as data:
            name = os.path.split(fname)[1]
            max_name_len = max(max_name_len, len(name))
            all_data.append(
                [(k, np.asarray(data[k])) for k in data.files
                 if k != "class"] + [("name", name)])
    dtype = [(key, val.dtype, val.shape) for key, val in all_data[0][:-1]]
    dtype.append(("name", str, max_name_len))
    combo = np.array(
        [tuple(val for _, val in row) for row in all_data], dtype=dtype)
    out_file = out_file or directory + ".npz"
    np.savez_compressed(out_file, levels=combo)
    return out_file


def expand_levels(filename):
    """Opposite of combine_levels: split an archive into single files."""
    with np.load(filename) as data:
        directory = filename[:-4]
        os.makedirs(directory, exist_ok=True)
        for level in data["levels"]:
            level_data = {k: level[k] for k in level.dtype.fields
                          if k != "name"}
            np.savez_compressed(
                os.path.join(directory, str(level["name"])), **level_data)
    return directory


def gen_benchmarks(out_root, tasks=None, num_levels=100, num_workers=8):
    """Build frozen benchmark suites from procgen tasks (A6)."""
    raise procgen_unported("gen_benchmarks")
