"""Procedural level generation (Python orchestration; a copy of
``safelife_tpu.procgen.generate`` on the port's game and cells).

Capability parity with ``safelife/proc_gen.py``: Dirichlet-process board
partitioning, fence construction, recursive parameter randomization
(``choices`` / ``uniform``), layered region painting (fences, spawners,
tree lattices, annealed patterns, movable walls/trees, hardened life,
buffer zones, fountains, board-vs-goals targeting), top-level ``gen_game``
(partition -> player + farthest exit -> regions -> white buffer goals) and
``stability_mask``.  The annealing pattern synthesizer and toroidal
labeling run in the native C++ core (:mod:`safelife_torch.procgen.native`).

Implementation notes: all torus morphology here is expressed with
``np.roll`` stencils (:func:`torus_dilate` / :func:`torus_erode` /
:func:`torus_count`) and flat-index tables rather than scipy filters; the
greedy passes (partition growth, fencing) work on flat cell indices.  The
level *distribution* matches the reference pipeline; individual RNG
streams do not (nothing depends on them — procgen levels are freshly
random by construction).  The copy draws from numpy's global generator
exactly as the JAX package's does, so one ``np.random.seed`` gives the same
levels from both.
"""

import logging

import numpy as np

from .. import cells as C
from ..cells import COLOR_NAMES
from ..game import SafeLifeGame
from . import native
from .native import (
    NEW_CELL_MASK, CAN_OSCILLATE_MASK, INCLUDE_VIOLATIONS_MASK)

logger = logging.getLogger(__name__)

_FULL_GEN_MASK = NEW_CELL_MASK | CAN_OSCILLATE_MASK | INCLUDE_VIOLATIONS_MASK


def coinflip(p, shape=None):
    """Bernoulli(p) samples (reference helper_utils.coinflip)."""
    return np.random.random(shape) < p


# ---------------------------------------------------------------------------
# Torus stencils (np.roll expressions of wrap-mode morphology).
# ---------------------------------------------------------------------------

def _ring_offsets(radius):
    return [(di, dj)
            for di in range(-radius, radius + 1)
            for dj in range(-radius, radius + 1)]


def torus_dilate(m, radius=1):
    """Binary dilation with a (2r+1)^2 box on a torus (OR of rolls)."""
    m = np.asarray(m, bool)
    out = np.zeros_like(m)
    for di, dj in _ring_offsets(radius):
        out |= np.roll(m, (di, dj), axis=(0, 1))
    return out


def torus_erode(m, radius=1):
    """Binary erosion with a (2r+1)^2 box on a torus (AND of rolls)."""
    return ~torus_dilate(~np.asarray(m, bool), radius)


def torus_count(x, radius=1):
    """Self-inclusive box sum on a torus (sum of rolls)."""
    x = np.asarray(x)
    out = np.zeros_like(x, dtype=np.int32)
    for di, dj in _ring_offsets(radius):
        out += np.roll(x, (di, dj), axis=(0, 1)).astype(np.int32)
    return out


def _flat_box9(shape):
    """(H*W, 9) flat indices of every cell's own 3x3 torus neighborhood."""
    h, w = shape
    ii, jj = np.divmod(np.arange(h * w), w)
    cols = [((ii + di) % h) * w + (jj + dj) % w
            for di, dj in _ring_offsets(1)]
    return np.stack(cols, axis=1)


# ---------------------------------------------------------------------------
# Parameter randomization.
# ---------------------------------------------------------------------------

def _sample_choices(spec):
    if isinstance(spec, dict):
        options = list(spec.keys())
        w = np.array(list(spec.values()), float)
    elif isinstance(spec, list):
        options = spec
        w = np.ones(len(spec))
    else:
        raise ValueError("'choices' must be a list or a dict of weights")
    if (w < 0).any() or w.sum() <= 0:
        raise ValueError("choice weights must be non-negative, sum > 0")
    return options[np.random.choice(len(options), p=w / w.sum())]


def _sample_uniform(bounds):
    lo, hi = np.asarray(bounds, float)
    return float(lo + np.random.random() * (hi - lo))


def fix_random_values(val):
    """Recursively resolve ``{'choices': ...}`` / ``{'uniform': [lo, hi]}``
    nodes anywhere in a parameter tree (reference
    ``proc_gen._fix_random_values`` semantics)."""
    if not isinstance(val, dict):
        return val
    if "choices" in val:
        return _sample_choices(val["choices"])
    if "uniform" in val:
        return _sample_uniform(val["uniform"])
    return {k: fix_random_values(v) for k, v in val.items()}


# ---------------------------------------------------------------------------
# Board partitioning.
# ---------------------------------------------------------------------------

def make_partitioned_regions(shape, alpha=1.0, max_regions=5, min_regions=2):
    """Grow distinct 4-connected regions separated by >= 2 cells.

    A Dirichlet-process growth (reference ``make_partioned_regions``
    semantics): at each draw, a region is picked with probability
    proportional to its frontier size — or, with weight ``alpha``, a brand
    new region is seeded from the untouched pool (while fewer than
    ``max_regions`` exist; below ``min_regions`` only the pool may win).
    A candidate cell joins only if that keeps every pair of regions at
    least two cells apart.  Returns an int board; 0 is the buffer.
    """
    h, w = shape
    owner = np.zeros(shape, np.int16)
    # Frontier sets hold FLAT indices.  frontiers[0] is the untouched pool
    # (every cell not yet claimed or rejected); frontiers[k>=1] are cells
    # adjacent to region k.  A cell rejected for region k may never be
    # re-proposed for k (the `tried` sets).
    frontiers = [set(range(h * w))]
    tried = [set()]

    def window5(i, j):
        rows = np.arange(i - 2, i + 3) % h
        cols = np.arange(j - 2, j + 3) % w
        return owner[rows[:, None], cols[None, :]].copy()

    def ring8(x):
        """8-neighbor counts for the inner 3x3 of a 5x5 boolean window."""
        acc = np.zeros((3, 3), np.int32)
        for di, dj in _ring_offsets(1):
            if di or dj:
                acc += x[1 + di:4 + di, 1 + dj:4 + dj]
        return acc

    while any(frontiers):
        sizes = np.array([len(f) for f in frontiers], float)
        if len(frontiers) <= max_regions:
            sizes[0] = min(alpha, sizes[0])
        else:
            sizes[0] = 1e-10
        if len(frontiers) <= min_regions:
            sizes[1:] = 1e-10
        k = int(np.random.choice(len(frontiers), p=sizes / sizes.sum()))
        members = list(frontiers[k])
        cand = members[np.random.randint(len(members))]
        frontiers[0].discard(cand)
        frontiers[k].discard(cand)
        if cand in tried[k]:
            continue
        tried[0].add(cand)
        tried[k].add(cand)
        i, j = divmod(cand, w)

        # Accepting (i, j) into region k must not put any two different
        # regions within two cells of each other: inspect the 5x5 window
        # with the candidate provisionally placed.
        win = window5(i, j)
        win[2, 2] = k if k else -1
        crowd = ring8(win != 0)
        foreign = ring8((win > 0) & (win != k))
        if foreign[1, 1] or ((foreign > 0) & (crowd > 2)).any():
            continue

        if k == 0:  # seed a brand-new region
            k = len(frontiers)
            frontiers.append(set())
            tried.append(set())
        owner[i, j] = k
        for di, dj in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            i2, j2 = (i + di) % h, (j + dj) % w
            if owner[i2, j2] == 0:
                frontiers[k].add(i2 * w + j2)
    return owner


# ---------------------------------------------------------------------------
# Fencing.
# ---------------------------------------------------------------------------

def build_fence(mask, shuffle=True):
    """Wall in a region so life inside cannot escape.

    Reference ``build_fence`` semantics: every *outside* cell tracks its
    "exposure" (number of region cells in its 3x3 box).  Pass 1 walks the
    region's edge cells in random order and fences any whose box still
    contains an outside cell with exposure >= 3 (a fence soaks up one unit
    of exposure in its whole box).  Pass 2 walks the placed fences and
    removes those whose box has no exposure >= 2 left.  Slightly
    over-aggressive by design, like the reference.
    """
    inside = np.asarray(mask) > 0
    h, w = inside.shape
    box = _flat_box9((h, w))
    cover = torus_count(inside)                     # region cells per box
    edge = np.flatnonzero(inside & (cover < 9))     # region cells near edge
    exposure = np.where(inside, 0, cover).reshape(-1)
    fence = np.zeros(h * w, np.int32)
    if edge.size == 0:
        return fence.reshape(h, w)

    order = np.random.permutation(edge) if shuffle else edge
    for c in order:
        if (exposure[box[c]] >= 3).any():
            exposure[box[c]] -= 1
            fence[c] = 1

    placed = np.flatnonzero(fence)
    order = np.random.permutation(placed) if shuffle else placed
    for c in order:
        if (exposure[box[c]] < 2).all():
            exposure[box[c]] += 1
            fence[c] = 0
    return fence.reshape(h, w)


# ---------------------------------------------------------------------------
# Pattern layer (native annealer wrapper).
# ---------------------------------------------------------------------------

def _gen_pattern(board, mask, seeds=None, num_retries=10, **kwargs):
    """Call the native annealer, adapting fill bounds on failure.

    Iterative retry loop (reference ``_gen_pattern`` semantics): a
    non-converging anneal lowers ``min_fill`` by 6% and retries; an
    overfull result raises ``max_fill`` by 7% and retries; region-too-small
    or other generation errors return the board unchanged.
    """
    min_fill = kwargs.pop("min_fill", 0.2)
    max_fill = kwargs.pop("max_fill", min_fill * 2)
    working = (mask & NEW_CELL_MASK) > 0
    area = max(int(working.sum()), 1)
    for attempt in range(num_retries + 1):
        last = attempt == num_retries
        try:
            out = native.gen_pattern(board, mask, seeds=seeds,
                                     min_fill=min_fill, **kwargs)
        except native.MaxIterException:
            if last:
                logger.debug("gen_pattern did not converge; nothing added")
                return board
            min_fill *= 0.94
            continue
        except native.BoardGenException:
            # includes InsufficientAreaException
            return board
        fill = float(((out != 0) & working).sum()) / area
        if fill <= max_fill:
            return out
        if last:
            logger.debug("gen_pattern overfull; nothing added")
            return board
        max_fill *= 1.07
    return board  # pragma: no cover


def _make_lattice(h, w, col_skip, row_skip, stagger):
    """True on a staggered lattice: every ``row_skip``-th row, every
    ``col_skip``-th column, successive row bands offset by ``stagger``."""
    r = np.arange(h)
    on_row = (r % row_skip) < 1
    offset = (r // row_skip) * stagger
    on_col = (np.arange(w)[None, :] + offset[:, None]) % col_skip < 1
    return on_row[:, None] & on_col


def _lattice_cells(shape, spec):
    """Tree-lattice geometry table (reference populate_region semantics)."""
    if not isinstance(spec, dict):
        spec = {}
    h, w = shape
    spacing = float(spec.get("spacing", 5))
    if not spec.get("stagger", True):
        return _make_lattice(h, w, spacing, spacing, 0)
    if spacing <= 3:
        return _make_lattice(h, w, 3, 3, 1)
    if spacing == 4:
        return _make_lattice(h, w, 10, 1, 3)
    if spacing == 5:
        return _make_lattice(h, w, 13, 1, 5)
    return _make_lattice(h, w, 6, 3, 3)


# ---------------------------------------------------------------------------
# Region painting.
# ---------------------------------------------------------------------------

class _RegionPainter:
    """Mutable state for painting one region layer by layer.

    Tracks the working board, the annealer's per-cell permission mask
    (``gen_mask``), which cells end up on the board (``foreground``) vs the
    goal board (``background``, with ``keep_color``), pattern seeds, and
    the largest oscillator period so far.
    """

    def __init__(self, mask):
        self.mask = np.asarray(mask, bool)
        shape = self.mask.shape
        halo = torus_dilate(self.mask) & ~self.mask
        self.gen_mask = (self.mask * _FULL_GEN_MASK
                         + halo * INCLUDE_VIOLATIONS_MASK).astype(np.int32)
        self.board = np.zeros(shape, np.uint16)
        self.foreground = np.zeros(shape, bool)
        self.background = np.zeros(shape, bool)
        self.keep_color = np.zeros(shape, bool)
        self.seeds = None
        self.max_period = 1

    @property
    def workable(self):
        return (self.gen_mask & NEW_CELL_MASK) > 0

    def forbid(self, cells, bits=NEW_CELL_MASK):
        self.gen_mask[cells] &= ~np.int32(bits)

    # -- layer features ----------------------------------------------------

    def add_fences(self, fraction):
        fences = (build_fence(self.gen_mask & NEW_CELL_MASK)
                  * coinflip(fraction, self.mask.shape)).astype(bool)
        self.forbid(fences, NEW_CELL_MASK | CAN_OSCILLATE_MASK)
        self.board[fences] += np.uint16(C.WALL)

    def add_spawners(self, fraction, eligible):
        cells = eligible & coinflip(fraction, self.mask.shape)
        if not cells.any() and eligible.any():
            # Guarantee at least one spawner when the layer asks for them.
            flat = np.flatnonzero(eligible)
            cells.flat[flat[np.random.randint(len(flat))]] = True
        self.gen_mask[cells] ^= NEW_CELL_MASK
        self.board[cells] = C.SPAWNER + self.color

    def add_tree_lattice(self, spec):
        cells = _lattice_cells(self.mask.shape, spec) & self.workable
        self.board[cells] = C.TREE + self.color

    def run_pattern(self, args):
        """Anneal a still-life/oscillator layer, then freeze its cells
        (and the oscillators' neighborhoods) against later layers."""
        args = dict(args)
        period = args.get("period", 1)
        layer_mask = self.gen_mask
        if period in (0, 1):
            # Still (1) or unstable (0) layers anneal at the region's
            # current max period with no oscillation bonus; period-0
            # additionally drops the violation requirement.
            drop = CAN_OSCILLATE_MASK if period == 1 \
                else INCLUDE_VIOLATIONS_MASK
            layer_mask = self.gen_mask & ~drop
            args.update(period=self.max_period, osc_bonus=0)
        elif period < self.max_period:
            raise ValueError(
                "Periods for sequential layers must be 0, 1, or >= the "
                "largest period in prior layers.")
        else:
            self.max_period = period

        before = self.board.copy()
        self.board = _gen_pattern(self.board, layer_mask, self.seeds, **args)

        # Cycle the board through one full oscillation period: cells that
        # are always occupied are still; cells occupied only sometimes are
        # oscillating.  Still cells may not be touched again; oscillating
        # cells and their neighbors may not be touched or even counted for
        # violations (edits there would propagate into the oscillator).
        frames = [self.board]
        for _ in range(1, self.max_period):
            frames.append(native.advance_board(frames[-1]))
        occupied = np.array(frames) != 0
        still = occupied.all(axis=0)
        oscillating = occupied.any(axis=0) & ~still
        self.forbid(oscillating, NEW_CELL_MASK | INCLUDE_VIOLATIONS_MASK)
        self.forbid(still | torus_dilate(oscillating),
                    NEW_CELL_MASK | CAN_OSCILLATE_MASK)

        fresh_life = ((self.board & C.ALIVE) != 0) & (self.board != before)
        self.board[fresh_life] |= self.color
        # Seed the next pattern layer near this one's live cells.
        self.seeds = ((self.board & C.ALIVE) != 0) & self.mask
        return period

    def decorate(self, layer, new_cells):
        """Movable walls/trees and hardened life among this layer's cells."""
        base = self.board & ~np.uint16(C.COLORS)
        for param, cell_type in (("movable_walls", C.WALL),
                                 ("movable_trees", C.TREE)):
            frac = layer.get(param, 0)
            if frac > 0:
                hit = new_cells & (base == cell_type) \
                    & coinflip(frac, base.shape)
                self.board[hit] |= np.uint16(C.MOVABLE)
        frac = layer.get("hardened_life", 0)
        if frac > 0:
            hit = new_cells & (base == C.LIFE) & coinflip(frac, base.shape)
            self.board[hit] &= ~np.uint16(C.DESTRUCTIBLE)

    def apply_buffer(self, radius):
        """No later layer may build within ``radius`` of any live cell."""
        self.forbid(torus_dilate((self.board & C.ALIVE) != 0, radius))

    def mark_targets(self, target, new_cells, period):
        if target == "board":
            self.foreground[new_cells] = True
            if period > 0:
                self.background[new_cells] = True
        elif target == "goals":
            self.background[new_cells] = True
            self.keep_color[new_cells] = True
            # Walls etc. still land on the board; only live cells are
            # goal-only.
            self.foreground[new_cells & ((self.board & C.ALIVE) == 0)] = True
        elif target == "both":
            self.foreground[new_cells] = True
            if period > 0:
                self.background[new_cells] = True
                self.keep_color[new_cells] = True
        else:
            raise ValueError(f"Unexpected value for 'target': {target}")

    def add_fountains(self, fraction, buffer_radius):
        cells = coinflip(fraction, self.mask.shape) & self.workable
        ring = torus_dilate(cells) & self.workable
        self.gen_mask[ring] = INCLUDE_VIOLATIONS_MASK
        if buffer_radius > 0:
            self.forbid(torus_dilate(ring, buffer_radius))
        self.board[ring] = C.WALL + self.color
        self.board[cells] = C.FOUNTAIN + self.color
        self.foreground[cells] = True
        self.background[ring] = True
        self.keep_color[ring] = True

    # -- driver --------------------------------------------------------------

    def paint_layer(self, layer):
        layer = fix_random_values(layer)
        before = self.board.copy()
        eligible_interior = torus_erode(self.workable)
        self.color = np.uint16(COLOR_NAMES.get(layer.get("color"), 0))

        if layer.get("fences", 0.0) > 0:
            self.add_fences(layer["fences"])
        if layer.get("spawners", 0) > 0:
            self.add_spawners(layer["spawners"], eligible_interior)
        if layer.get("tree_lattice") is not None:
            self.add_tree_lattice(layer["tree_lattice"])
        period = 1
        if "pattern" in layer:
            period = self.run_pattern(layer["pattern"])

        new_cells = self.board != before
        self.decorate(layer, new_cells)
        buffer_radius = int(layer.get("buffer_zone", 0))
        self.apply_buffer(buffer_radius)
        self.mark_targets(layer.get("target", "board"), new_cells, period)
        if layer.get("fountains", 0) > 0:
            self.add_fountains(layer["fountains"], buffer_radius)

    def finish(self):
        board = np.where(self.foreground, self.board, 0).astype(np.uint16)
        goals = np.where(self.background, self.board, 0).astype(np.uint16)
        goals &= ~np.uint16(C.SPAWNING)
        goals[~self.keep_color] &= ~np.uint16(C.COLORS)
        return board, goals


def populate_region(mask, layer_params):
    """Paint one isolated region layer by layer; returns (board, goals).

    See the yaml parameter files / presets for the per-layer vocabulary
    (color, fences, spawners, tree_lattice, pattern, movable_walls,
    movable_trees, hardened_life, buffer_zone, target, fountains) —
    reference ``populate_region`` semantics throughout.
    """
    painter = _RegionPainter(mask)
    for layer in layer_params:
        if not isinstance(layer, dict):
            raise ValueError("layer_params must be a list of dicts")
        painter.paint_layer(layer)
    return painter.finish()


# ---------------------------------------------------------------------------
# Top-level generation.
# ---------------------------------------------------------------------------

def _torus_l1(shape, i0, j0):
    """Torus manhattan distance of every cell from (i0, j0)."""
    di = np.abs(np.arange(shape[0])[:, None] - i0)
    dj = np.abs(np.arange(shape[1])[None, :] - j0)
    return np.minimum(di, shape[0] - di) + np.minimum(dj, shape[1] - dj)


def gen_game(board_shape=(25, 25), min_performance=-1, partitioning={},
             starting_region=None, later_regions=None, buffer_region=None,
             named_regions={}, **etc):
    """Generate a SafeLifeGame: partition the board, place the player and
    the farthest-away exit in the buffer region, populate every region from
    ``named_regions``, and color the leftover buffer goals white
    (reference ``gen_game`` semantics)."""
    board_shape = tuple(fix_random_values(board_shape))
    min_performance = fix_random_values(min_performance)
    partitioning = fix_random_values(partitioning)
    h, w = board_shape

    regions = make_partitioned_regions(board_shape, **partitioning)
    board = np.zeros(board_shape, np.uint16)
    goals = np.zeros(board_shape, np.uint16)

    # Player: a uniform buffer cell.  Exit: the buffer cell farthest from
    # the player in torus manhattan distance.
    buffer_flat = np.flatnonzero(regions == 0)
    ai, aj = divmod(int(buffer_flat[np.random.choice(len(buffer_flat))]), w)
    board[ai, aj] = C.PLAYER
    dist = np.where(regions == 0, _torus_l1(board_shape, ai, aj), -1)
    ei, ej = divmod(int(np.argmax(dist)), w)
    board[ei, ej] = C.LEVEL_EXIT | C.COLOR_R

    # Reserve a 3x3 apron around the player and exit so no region touches
    # them (marked -1: stays buffer but is never painted).
    for ci, cj in ((ai, aj), (ei, ej)):
        rows = np.arange(ci - 1, ci + 2) % h
        cols = np.arange(cj - 1, cj + 2) % w
        regions[rows[:, None], cols[None, :]] = -1

    region_ids = [int(k) for k in np.unique(regions) if k > 0]
    for n, k in enumerate(region_ids):
        if n == 0 and starting_region is not None:
            name = fix_random_values(starting_region)
        else:
            name = fix_random_values(later_regions)
        if name not in named_regions:
            logger.error("No region parameters for name '%s'", name)
            continue
        rboard, rgoals = populate_region(regions == k, named_regions[name])
        board += rboard
        goals += rgoals

    buffer_region = fix_random_values(buffer_region)
    if buffer_region in named_regions:
        rboard, rgoals = populate_region(regions == 0,
                                         named_regions[buffer_region])
        board += rboard
        goals += rgoals

    # White buffer goals: a visual hint for humans.
    uncolored_buffer = (regions <= 0) & ((goals & C.COLORS) == 0)
    goals[uncolored_buffer] |= np.uint16(C.COLORS)

    game = SafeLifeGame(board_size=None)
    game.deserialize({
        "board": board,
        "goals": goals,
        "agent_loc": (int(aj), int(ai)),
        "min_performance": min_performance,
        "orientation": 1,
    })
    return game


def stability_mask(board, period=6, remove_agent=True):
    """Mark separable regions that are stable with the given period
    (reference ``stability_mask`` semantics): advance ``period`` steps,
    split the board at frozen cells and at cells that never held or
    neighbored life, and keep the components that returned to their
    original state."""
    board = np.asarray(board, np.uint16)
    if remove_agent:
        board = np.where((board & C.AGENT) != 0, np.uint16(0), board)

    frames = [board]
    for _ in range(period):
        frames.append(native.advance_board(frames[-1]))
    alive = np.array([(f & C.ALIVE) != 0 for f in frames])
    crowding = np.max([torus_count(a) for a in alive], axis=0)
    final = frames[-1]

    # Component boundaries: frozen cells, and dead zones life never came
    # near (<= 2 live box-neighbors at every step).
    boundary = (final & C.FROZEN) != 0
    boundary |= ~alive.any(axis=0) & (crowding <= 2)
    labels, _ = native.wrapped_label(~boundary)
    unstable_ids = np.unique(labels[final != board])
    return (labels > 0) & ~np.isin(labels, unstable_ids)
