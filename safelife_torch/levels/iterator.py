"""Level iteration and archive utilities (port of
``safelife_tpu.levels.iterator``).

Capability parity with the generator half of ``safelife/file_finder.py``:
``safelife_loader`` yielding ``SafeLifeGame`` objects with repeat/shuffle
semantics and procedural generation in a pool of worker processes, plus
the archive utilities (``gen_many`` / ``combine_levels`` /
``expand_levels`` / ``gen_benchmarks``) used to build frozen benchmark
suites.

The batched path doesn't iterate games one at a time — it gathers levels
from a device bank (``loader.build_bank``); this module serves the
host-side surfaces (the gym adapter, interactive play, benchmark
authoring) and streams of procgen levels.  The pool's workers are started
with the ``spawn`` method, never ``fork``: forking a process that runs
threads can hang the child.
"""

import collections
import concurrent.futures
import glob
import itertools
import multiprocessing
import os
import random

import numpy as np

from ..game import SafeLifeGame
from . import loader

# Level files, and the procgen parameter files.
FILE_TYPES = ("npz", "yaml", "json")


def _load_entries(paths):
    """Resolve paths to (name, kind, payload) entries; kind is 'procgen'
    (yaml params) or 'static' (level data)."""
    from ..procgen import load_params

    if not paths:
        return [[None, "procgen", None]]
    entries = []
    fnames = []
    for path in paths:
        try:
            fnames.extend(loader.find_files(path, file_types=FILE_TYPES))
        except FileNotFoundError:
            # Not a file: maybe a procgen task name (yaml on the search
            # path or a built-in preset).
            entries.append([str(path), "procgen", load_params(path)])
    for fname in fnames:
        if fname.endswith((".yaml", ".json")):
            entries.append([fname, "procgen", load_params(fname)])
        else:
            with np.load(fname) as data:
                if "levels" in data:
                    for rec in data["levels"]:
                        name = os.path.join(fname[:-4], str(rec["name"]))
                        entries.append([
                            name, "static",
                            {k: rec[k] for k in rec.dtype.fields}])
                else:
                    entries.append([
                        fname, "static", {k: data[k] for k in data.files}])
    return entries


def _game_from_entry(name, kind, payload, set_seed=False):
    if set_seed:
        np.random.seed(int.from_bytes(os.urandom(4), "little"))
    if kind == "procgen":
        from ..procgen import gen_game, load_params
        params = payload if payload is not None else load_params(None)
        game = gen_game(**params)
    else:
        game = SafeLifeGame.loaddata(payload)
    game.file_name = name
    return game


def _set_rng_state(state):
    """A worker's numpy global generator starts where this process's was."""
    np.random.set_state(state)


# How long the pool's next game may take before its workers are killed and
# the loader raises TimeoutError (a game takes seconds).
WORKER_TIMEOUT_S = 300.0


def _kill_workers(pool):
    """Kill a process pool's workers (``ProcessPoolExecutor`` has no public
    call for it before Python 3.14)."""
    kill = getattr(pool, "kill_workers", None)
    if kill is not None:
        kill()
        return
    for proc in list((getattr(pool, "_processes", None) or {}).values()):
        proc.kill()


def safelife_loader(*paths, repeat="auto", shuffle=False, num_workers=1,
                    max_queue=10):
    """Yield SafeLifeGame instances from level files / procgen params.

    repeat: "auto" repeats forever iff paths resolve to a single procgen
    parameter file; True/False/int otherwise.  With ``num_workers >= 1``
    procgen runs asynchronously in a pool of that many spawned worker
    processes: with one worker it continues numpy's global stream of this
    process (so ``np.random.seed`` before the first game gives the same
    games as ``num_workers=0``), with more each game is reseeded from
    urandom.  The paths are resolved when the first game is asked for;
    the pool closes when the iterator ends or is closed.  A game the pool
    does not deliver within ``WORKER_TIMEOUT_S`` seconds kills the workers
    and raises TimeoutError.
    """
    entries = _load_entries(paths)
    if not entries:
        return
    if repeat == "auto":
        repeat = len(entries) == 1 and entries[0][1] == "procgen"
    if isinstance(repeat, bool):
        loop = itertools.count() if repeat else range(1)
    else:
        loop = range(repeat)

    def entry_stream():
        for _ in loop:
            if shuffle:
                random.shuffle(entries)
            yield from entries

    use_pool = num_workers >= 1 and any(e[1] == "procgen" for e in entries)
    if not use_pool:
        for entry in entry_stream():
            yield _game_from_entry(*entry)
        return

    # A worker that dies takes the pool down with BrokenProcessPool (a
    # multiprocessing.Pool would wait forever for its result).
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=num_workers,
        mp_context=multiprocessing.get_context("spawn"),
        initializer=_set_rng_state, initargs=(np.random.get_state(),))
    timeout = WORKER_TIMEOUT_S
    try:
        kwargs = {"set_seed": num_workers > 1}
        pending = collections.deque()
        for entry in entry_stream():
            next_game = None
            if len(pending) >= max_queue or (pending and pending[0].done()):
                next_game = pending.popleft().result(timeout)
            pending.append(pool.submit(_game_from_entry, *entry, **kwargs))
            if next_game is not None:
                yield next_game
        while pending:
            yield pending.popleft().result(timeout)
    except concurrent.futures.TimeoutError:
        _kill_workers(pool)
        raise
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


# --- archive utilities ------------------------------------------------------

def gen_many(param_file, out_dir, num_gen, num_workers=8, max_queue=100):
    """Generate and save many levels as individual npz files."""
    out_dir = os.path.abspath(out_dir)
    base_name = os.path.basename(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    num_digits = int(np.log10(max(num_gen, 1))) + 1
    fmt = os.path.join(out_dir, f"{base_name}-{{:0{num_digits}d}}.npz")
    games = safelife_loader(param_file, repeat=True,
                            num_workers=num_workers, max_queue=max_queue)
    try:
        for k in range(1, num_gen + 1):
            fname = fmt.format(k)
            if os.path.exists(fname):
                continue
            next(games).save(fname)
    finally:
        games.close()  # stops the worker pool


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
    """Build frozen benchmark suites (reference gen_benchmarks): generate
    ``num_levels`` levels per task and combine each into one archive."""
    tasks = tasks or (
        "append-still append-dynamic append-spawn prune-dynamic "
        "prune-spawn prune-still prune-still-hard navigation").split()
    outputs = []
    for name in tasks:
        directory = os.path.join(out_root, name)
        gen_many(name, directory, num_levels, num_workers=num_workers)
        outputs.append(combine_levels(directory))
    return outputs
