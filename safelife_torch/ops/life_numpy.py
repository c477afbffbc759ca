"""The SafeLife CA step in plain numpy: the host oracle of the integrity
guard and the physics of the host game (the port's copy of
``safelife_tpu.ops.life_numpy``).

Whole-board vector ops, no per-cell loops.  Every 3x3 Moore neighbourhood
lies on a torus and includes the cell itself:

* ``count``: live cells in the neighbourhood, so a live cell survives iff
  ``count`` is 3 or 4 (Life B3/S23);
* PRESERVING, INHIBITING and SPAWNING act on a cell when any cell of its
  neighbourhood carries the flag;
* a newborn cell inherits a colour when the weighted number of
  neighbourhood cells carrying it is at least 2 (live cells count once,
  spawners twice), and is destructible when at least 2 live neighbours
  are destructible (or carry the exit bit, a quirk of the reference);
* alive: kept if frozen, preserved or ``count`` is 3 or 4, else cleared;
  dead: kept if frozen or inhibited, else born at ``count == 3``, else a
  destructible live cell spawns next to a spawner where the draw is below
  ``spawn_prob``, else kept.

RNG contract of the host game: uniforms are consumed in row-major order,
one at each cell that reaches the spawn test (dead, not frozen, not
inhibited, ``count != 3``, next to a spawner), the reference C engine's
order, so that a fixed-seed :class:`..utils.rng.NumpyRandomBridge` replays
its games bit for bit.
"""

import numpy as np

from .. import cells as C


def _neighborhood_sum(x):
    """Self-inclusive 3x3 torus sum, as two separable passes."""
    r = x + np.roll(x, 1, axis=-1) + np.roll(x, -1, axis=-1)
    return r + np.roll(r, 1, axis=-2) + np.roll(r, -1, axis=-2)


def _neighborhood_any(x):
    """Self-inclusive 3x3 torus logical OR."""
    r = x | np.roll(x, 1, axis=-1) | np.roll(x, -1, axis=-1)
    return r | np.roll(r, 1, axis=-2) | np.roll(r, -1, axis=-2)


def advance_board_reference(board, rand_field=None, spawn_prob=0.3, *,
                            rng=None):
    """Advance one ``(H, W)`` uint16 board one step; returns a new array.

    ``rand_field`` is an ``(H, W)`` field of uniform draws in [0, 1); a
    spawn fires where the draw is below ``spawn_prob``.  Without it the
    draws are taken only at the cells of :func:`spawn_consumption_mask`,
    in row-major order, from ``rng`` (anything with ``draw(n)``, such as
    :class:`..utils.rng.NumpyRandomBridge`) or else from ``np.random``.
    """
    board = np.asarray(board, dtype=np.uint16)
    alive = (board & C.ALIVE).astype(np.int32)
    frozen = (board & C.FROZEN) != 0

    count = _neighborhood_sum(alive)
    preserved = _neighborhood_any((board & C.PRESERVING) != 0)
    inhibited = _neighborhood_any((board & C.INHIBITING) != 0)
    spawning = (board & C.SPAWNING) != 0
    near_spawner = _neighborhood_any(spawning)

    def doubled(flag, spawner_double):
        has = ((board & flag) != 0).astype(np.int32)
        w = has * alive
        if spawner_double:
            w = w + 2 * has * spawning.astype(np.int32)
        return _neighborhood_sum(w) >= 2

    inherit = np.zeros_like(board)
    for color in (C.COLOR_R, C.COLOR_G, C.COLOR_B):
        inherit |= np.uint16(color) * doubled(color, spawner_double=True)
    destr2 = doubled(C.DESTRUCTIBLE | C.EXIT, spawner_double=False)

    is_alive = alive.astype(bool)
    survives = frozen | preserved | (count == 3) | (count == 4)
    born = (count == 3) & ~frozen & ~inhibited

    spawn_eligible = ~is_alive & ~frozen & ~inhibited & ~born & near_spawner
    if rand_field is None:
        rand_field = np.ones(board.shape)
        n = int(spawn_eligible.sum())
        if n:
            rand_field[spawn_eligible] = (
                rng.draw(n) if rng is not None else np.random.random(n))
    spawned = spawn_eligible & (rand_field < spawn_prob)

    born_cell = (np.uint16(C.ALIVE) | inherit
                 | np.uint16(C.DESTRUCTIBLE) * destr2)
    spawn_cell = np.uint16(C.ALIVE | C.DESTRUCTIBLE) | inherit

    return np.where(
        is_alive,
        np.where(survives, board, np.uint16(0)),
        np.where(born, born_cell, np.where(spawned, spawn_cell, board)),
    ).astype(np.uint16)


def spawn_consumption_mask(board):
    """Boolean mask of the cells that consume one uniform draw this step.

    It depends on the board alone, not on the drawn values, so a caller
    can pre-draw exactly the uniforms the step consumes, in the
    reference's order.
    """
    board = np.asarray(board, dtype=np.uint16)
    alive = (board & C.ALIVE).astype(np.int32)
    frozen = (board & C.FROZEN) != 0
    count = _neighborhood_sum(alive)
    inhibited = _neighborhood_any((board & C.INHIBITING) != 0)
    near_spawner = _neighborhood_any((board & C.SPAWNING) != 0)
    born = (count == 3) & ~frozen & ~inhibited
    return ~alive.astype(bool) & ~frozen & ~inhibited & ~born & near_spawner
