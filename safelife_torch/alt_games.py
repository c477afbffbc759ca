"""Alternative rule engines: generalized B/S Life and asynchronous updates
(the port's copy of ``safelife_tpu.alt_games``).

Capability parity with the reference's experimental classes
(``safelife/safelife_game.py:667-832``): :class:`GameOfLife` exposes
configurable born/survive rules via a whole-board vectorized step, and
:class:`AsyncGame` updates cells one at a time with energy rules + a
temperature (conway / ising / vine rule sets).

Both engines here are expressed with ``np.roll`` torus stencils and
rule-membership tests rather than scipy convolutions; the update semantics
match the reference classes.
"""

import numpy as np

from . import cells as C
from .game import SafeLifeGame


def _ring_sum(x):
    """Sum over the 8 torus neighbors (self EXCLUDED — B/S rules count
    neighbors only)."""
    acc = np.zeros(x.shape, np.int32)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            if di or dj:
                acc += np.roll(x, (di, dj), axis=(0, 1)).astype(np.int32)
    return acc


class GameOfLife(SafeLifeGame):
    """Generalized B/S cellular automaton (default B3/S23).

    One vectorized step: count live/spawner neighbors, apply the
    born/survive membership rules gated by freezing powers, draw spawn
    events, then rebuild the changed cells with inherited colors and
    destructibility.
    """

    survive_rule = (2, 3)
    born_rule = (3,)

    def advance_board(self):
        self.num_steps += 1
        board = self.board
        alive = (board & C.ALIVE) != 0
        spawning = (board & C.SPAWNING) != 0
        frozen = (board & C.FROZEN) != 0

        # Freezing powers act on the 8 neighbors (a cell's own preserving /
        # inhibiting flag does not protect itself).
        may_die = ~frozen & (_ring_sum(board & C.PRESERVING) == 0)
        may_grow = ~frozen & (_ring_sum(board & C.INHIBITING) == 0)

        n_alive = _ring_sum(alive)
        n_spawn = _ring_sum(spawning)
        # Each neighboring spawner is an independent spawn chance.
        spawn_hit = np.random.random(board.shape) \
            < 1 - (1 - self.spawn_prob) ** n_spawn

        births = (np.isin(n_alive, self.born_rule) | spawn_hit) \
            & ~alive & may_grow
        deaths = ~np.isin(n_alive, self.survive_rule) & alive & may_die

        # New cells inherit any color carried by >= 2 weighted neighbors
        # (live cells weigh 1, spawners 2), and are destructible unless
        # >= 2 neighbors are indestructible life.
        weight = alive + 2 * spawning
        inherited = np.zeros_like(board)
        for color in C.COLOR_TUPLE:
            carried = _ring_sum(((board & color) != 0) * weight) >= 2
            inherited |= np.uint16(color) * carried
        hard = alive & ((board & C.DESTRUCTIBLE) == 0)
        inherited |= np.uint16(C.DESTRUCTIBLE) * (_ring_sum(hard) < 2)

        self.board = np.where(
            births, np.uint16(C.ALIVE) | inherited,
            np.where(deaths, np.uint16(C.EMPTY), board)).astype(np.uint16)

    @property
    def is_stochastic(self):
        return (self.board & C.SPAWNING).any()


# Neighbor offsets (row, col) for the Von Neumann, hexagonal and Moore
# neighborhoods used by the async energy rules.
_NEIGHBOR_OFFSETS = {
    4: ((-1, 0), (0, -1), (0, 1), (1, 0)),
    6: ((-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0)),
    8: ((-1, -1), (-1, 0), (-1, 1), (0, -1),
        (0, 1), (1, -1), (1, 0), (1, 1)),
}


class AsyncGame(SafeLifeGame):
    """Asynchronous per-cell stochastic updates with energy rules.

    Each board update touches ``cells_per_update * board.size`` random
    cells; a touched cell flips alive/dead with a logistic probability of
    the energy difference given its live-neighbor count, boosted by
    adjacent spawners.  Frozen cells and cells next to freezing powers
    never change.
    """

    energy_rule_sets = {
        "conway": (
            (-1, -1, +1, +1, -1, -1, -1, -1, -1),
            (-1, -1, -1, +1, -1, -1, -1, -1, -1),
        ),
        "ising": (
            (-2, -1, 0, +1, +2),
            (-2, -1, 0, +1, +2),
        ),
        "vine": (
            (-1, -1, +1, +1, +1),
            (-1, +1, -1, -1, -1),
        ),
    }
    energy_rules = energy_rule_sets["conway"]
    temperature = 0
    cells_per_update = 0.3

    def serialize(self):
        data = super().serialize()
        data["energy_rules"] = self.energy_rules
        return data

    def deserialize(self, data, *args, **kw):
        super().deserialize(data, *args, **kw)
        keys = data.dtype.fields if hasattr(data, "dtype") else data
        if "energy_rules" in keys:
            self.energy_rules = data["energy_rules"]

    def advance_board(self):
        board = self.board
        live_energy, dead_energy = self.energy_rules
        n_neighbors = len(live_energy) - 1
        if n_neighbors not in _NEIGHBOR_OFFSETS:
            raise RuntimeError("async rules must have length 5, 7, or 9")
        offsets = _NEIGHBOR_OFFSETS[n_neighbors]
        h, w = board.shape
        beta = 1.0 / max(1e-20, self.temperature)
        self.num_steps += 1

        for _ in range(int(board.size * self.cells_per_update)):
            x = np.random.randint(w)
            y = np.random.randint(h)
            cell = board[y, x]
            if cell & C.FROZEN:
                continue
            ring = [board[(y + dy) % h, (x + dx) % w] for dy, dx in offsets]
            if any(v & C.FREEZING for v in ring):
                continue
            n_alive = sum(bool(v & C.ALIVE) for v in ring)
            n_spawn = sum(bool(v & C.SPAWNING) for v in ring)
            energy = (live_energy if cell & C.ALIVE else dead_energy)[n_alive]
            p_live = 0.5 * (1 + np.tanh(energy * beta))
            p_live = 1 - (1 - p_live) * (1 - self.spawn_prob) ** n_spawn
            board[y, x] = C.LIFE if np.random.random() < p_live else C.EMPTY
