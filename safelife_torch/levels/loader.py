"""Level loading: npz archives -> level banks on a device
(port of ``safelife_tpu.levels.loader``).

Supported file formats (the reference's wire format):
  * combined archives: ``{"levels": structured_array}`` with fields
    ``spawn_prob, orientation, agent_loc, board, class, min_performance,
    goals, name`` (benchmarks/v1.0/*.npz),
  * single-level npz files with those fields as separate arrays.

Search order for bare names: the cwd, ``$SAFELIFE_LEVELS`` (a
colon-separated list of level directories), then the level data that ships
with the JAX package (``safelife_tpu/levels/data``, found beside this
package; the archives are data, nothing of that package is imported).
"""

import glob
import os

import numpy as np
import torch

from .. import cells as C
from .. import bits16, resolve_device
from ..env.state import LevelBank, find_exits_np
from ..ops import scoring
from ..ops.life_kernels import advance_spawnless

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PACKAGED_LEVELS = os.path.join(_ROOT, "safelife_tpu", "levels", "data")

FILE_TYPES = ("npz",)


def level_directories():
    env_dirs = os.environ.get("SAFELIFE_LEVELS", "")
    dirs = [d for d in env_dirs.split(os.pathsep) if d]
    dirs.append(PACKAGED_LEVELS)
    return dirs


def find_files(*paths, file_types=FILE_TYPES):
    """Resolve level paths: direct, globbed, extensionless, or directories,
    searching the cwd first and the level directories as fallback."""
    for path in paths:
        found = _find_one(os.path.expanduser(path), file_types)
        if not found:
            for base in level_directories():
                found = _find_one(os.path.join(base, path), file_types)
                if found:
                    break
        if not found:
            raise FileNotFoundError(f"No level files found for '{path}'")
        yield from found


def _find_one(path, file_types):
    def ok(p):
        return os.path.isfile(p) and p.rsplit(".", 1)[-1] in file_types

    hits = sorted(filter(ok, glob.glob(path, recursive=True)))
    if hits:
        return hits
    for ext in file_types:
        hits = sorted(filter(ok, glob.glob(path + "." + ext, recursive=True)))
        if hits:
            return hits
    if os.path.isdir(path):
        return sorted(p for p in glob.glob(os.path.join(path, "*")) if ok(p))
    return []


def _fields(rec):
    if hasattr(rec, "dtype") and rec.dtype.fields:
        return rec.dtype.fields
    return rec.keys() if hasattr(rec, "keys") else ()


def _level_from_record(rec, name):
    """Normalize one level record to a plain dict of numpy arrays."""
    fields = _fields(rec)
    agent_loc = np.asarray(rec["agent_loc"])  # (x, y) in the wire format
    return dict(
        board=np.ascontiguousarray(rec["board"], np.uint16),
        goals=np.ascontiguousarray(rec["goals"], np.uint16),
        agent_col=np.int32(agent_loc[0]),
        agent_row=np.int32(agent_loc[1]),
        orientation=np.int32(rec["orientation"])
        if "orientation" in fields else np.int32(1),
        spawn_prob=np.float32(rec["spawn_prob"])
        if "spawn_prob" in fields else np.float32(0.3),
        min_performance=np.float32(rec["min_performance"])
        if "min_performance" in fields else np.float32(-1.0),
        name=str(name),
    )


def load_levels(*paths):
    """Load all matching files into a list of level dicts (host numpy)."""
    levels = []
    for fname in find_files(*paths):
        with np.load(fname) as data:
            if "levels" in data:
                for rec in data["levels"]:
                    name = os.path.join(
                        os.path.basename(fname)[:-4], str(rec["name"]))
                    levels.append(_level_from_record(rec, name))
            else:
                rec = {k: data[k] for k in data.files}
                levels.append(_level_from_record(
                    rec, os.path.basename(fname)[:-4]))
    return levels


def build_bank(levels, max_exits=4, device=None):
    """Stack uniform-shape level dicts into a LevelBank on ``device``
    (``cuda`` unless the caller passes another).

    Precomputes every reset-time quantity that is a pure function of the
    level (exit locations, baseline/initial scores, reset exit gate) and
    the four rule flags of the bank.
    """
    device = resolve_device(device)
    if not levels:
        raise ValueError("No levels to build a bank from.")
    shapes = {lv["board"].shape for lv in levels}
    if len(shapes) > 1:
        raise ValueError(
            f"Levels of mixed board shapes {shapes} cannot share a bank "
            "(torus dynamics depend on the shape). Group them with "
            "group_by_shape() first.")
    h, w = shapes.pop()
    for lv in levels:
        if not (0 <= lv["agent_row"] < h and 0 <= lv["agent_col"] < w):
            raise ValueError(f"level {lv['name']}: agent outside the board")

    def stack(key):
        return torch.as_tensor(np.stack([lv[key] for lv in levels], axis=-1),
                               device=device)

    # One exit slot per exit of the level with the most (at least one).
    n_exits = max(int(((lv["board"] & C.EXIT) != 0).sum()) for lv in levels)
    max_exits = max(1, min(max_exits, n_exits))
    exits = [find_exits_np(lv["board"], max_exits) for lv in levels]
    exit_gcol = [
        np.where(e[2], (lv["goals"][e[0], e[1]].astype(np.int32)
                        >> C.COLOR_BIT) & 7, 0)
        for lv, e in zip(levels, exits)]
    board_np = np.stack([lv["board"] for lv in levels], axis=-1)
    goals_np = np.stack([lv["goals"] for lv in levels], axis=-1)
    goals = torch.as_tensor(goals_np, device=device)
    # Goals are static when no goal board holds a spawner and every one is
    # a fixed point of the CA rule; without spawners the spawnless rule is
    # the full rule.
    static_goals = (not (goals_np & C.SPAWNING).any()
                    and torch.equal(bits16(advance_spawnless(goals)),
                                    bits16(goals)))
    # The numpy scoring twins reduce over the last two axes; ours are
    # (H, W, N), so move the level axis first.
    b_nf = np.moveaxis(board_np, -1, 0)
    g_nf = np.moveaxis(goals_np, -1, 0)
    baseline = scoring.performance_score_np(b_nf, g_nf).astype(np.int32)
    possible0 = scoring.possible_score_np(g_nf).astype(np.int32) - baseline
    points0 = scoring.current_points_np(b_nf, g_nf).astype(np.int32)
    min_perf = np.stack([lv["min_performance"] for lv in levels])
    can_exit0 = (min_perf < 0) | (0 >= min_perf * possible0)

    spawnless = not ((board_np & C.SPAWNING).any()
                     or (goals_np & C.SPAWNING).any())
    simple_goals = not bool(
        (goals_np & (C.PRESERVING | C.INHIBITING | C.SPAWNING | C.EXIT)).any())
    spawn_simple = not bool(
        (goals_np & (C.PRESERVING | C.INHIBITING | C.EXIT)).any())

    def put(x):
        return torch.as_tensor(np.asarray(x), device=device)

    return LevelBank(
        board=put(board_np),
        goals=goals,
        agent_row=stack("agent_row"),
        agent_col=stack("agent_col"),
        orientation=stack("orientation"),
        spawn_prob=stack("spawn_prob"),
        min_performance=stack("min_performance"),
        exit_row=put(np.stack([e[0] for e in exits], axis=-1)),
        exit_col=put(np.stack([e[1] for e in exits], axis=-1)),
        exit_valid=put(np.stack([e[2] for e in exits], axis=-1)),
        exit_gcol=put(np.stack(exit_gcol, axis=-1)),
        baseline_score=put(baseline),
        possible0=put(possible0),
        points0=put(points0),
        can_exit0=put(can_exit0),
        static_goals=bool(static_goals),
        spawnless=bool(spawnless),
        simple_goals=simple_goals,
        spawn_simple_goals=spawn_simple,
    )


def group_by_shape(levels):
    """Split a mixed list of levels into shape -> list of levels."""
    groups = {}
    for lv in levels:
        groups.setdefault(lv["board"].shape, []).append(lv)
    return groups


def load_bank(*paths, device=None):
    """Find, load and stack levels into a bank on ``device`` (``cuda``
    unless the caller passes another)."""
    return build_bank(load_levels(*paths), device=device)


def level_names(*paths):
    """The names of the levels :func:`load_levels` finds, in its order
    (``<archive>/<level>`` for a combined archive)."""
    return [lv["name"] for lv in load_levels(*paths)]
