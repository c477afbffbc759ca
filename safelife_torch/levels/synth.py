"""Tiny synthetic levels for tests, self-tests and benchmarks (the port's
copy of ``safelife_tpu.levels.synth``).

Minimal hand-built boards exercising the full cell-type vocabulary
without any file dependency.
"""

import numpy as np

from .. import cells as C


def simple_level(h=26, w=26, spawners=False, seed=0, dynamic_goals=False):
    """A walled level with some life, a goal patch, an agent and an exit.

    Returns a level dict compatible with ``loader.build_bank``.
    ``dynamic_goals`` puts live cells and a spawner on the GOAL board so it
    is not a CA fixed point: the bank then exercises the goals half of the
    CA advance.
    """
    rng = np.random.RandomState(seed)
    board = np.zeros((h, w), np.uint16)
    goals = np.zeros((h, w), np.uint16)
    # Border walls.
    board[0, :] = board[-1, :] = board[:, 0] = board[:, -1] = C.WALL
    # A few live cells in the interior.
    n_life = max(3, (h * w) // 40)
    rr = rng.randint(2, h - 2, n_life)
    cc = rng.randint(2, w - 2, n_life)
    board[rr, cc] = C.LIFE
    # Blue goal patch.
    gh, gw = max(2, h // 5), max(2, w // 5)
    goals[2:2 + gh, 2:2 + gw] = C.COLOR_B
    if spawners:
        board[h // 2, w // 2] = C.SPAWNER | C.COLOR_G
    if dynamic_goals:
        # A blinker plus a spawner keep the goal board evolving forever.
        goals[h - 4, 2:5] = C.LIFE | C.COLOR_G
        goals[3, w - 4] = C.SPAWNER | C.COLOR_B
    # Agent bottom-left-ish, exit top-right corner.
    ar, ac = h - 2, 1
    board[ar, ac] = C.PLAYER
    board[1, w - 2] = C.LEVEL_EXIT
    return dict(
        board=board, goals=goals,
        agent_row=np.int32(ar), agent_col=np.int32(ac),
        orientation=np.int32(1),
        spawn_prob=np.float32(0.3 if spawners else 0.0),
        min_performance=np.float32(-1.0),
        name=f"synth-{h}x{w}-{seed}",
    )


def synth_bank(num_levels=8, h=26, w=26, spawners=False, dynamic_goals=False,
               device=None):
    """A bank of ``num_levels`` synthetic levels on ``device`` (``cuda``
    unless the caller passes another)."""
    from .loader import build_bank
    return build_bank(
        [simple_level(h, w, spawners=spawners, seed=i,
                      dynamic_goals=dynamic_goals)
         for i in range(num_levels)], device=device)


def general_level(h=26, w=26, seed=0):
    """:func:`simple_level` with spawners on both boards and PRESERVING
    and INHIBITING cells on the goal board: no bank flag certifies such
    goals, so a bank of these takes the general pair rule (no shipped
    suite does)."""
    level = simple_level(h, w, spawners=True, seed=seed, dynamic_goals=True)
    goals = level["goals"]
    goals[h // 3, w // 3] = C.FOUNTAIN | C.COLOR_R
    goals[h // 2 + 2, 3] = C.INHIBITING | C.FROZEN
    goals[h - 5, 6:8] = C.PRESERVING | C.LIFE
    return level


def general_bank(num_levels=8, h=26, w=26, device=None):
    """A bank of ``num_levels`` :func:`general_level` levels."""
    from .loader import build_bank
    return build_bank([general_level(h, w, seed=i)
                       for i in range(num_levels)], device=device)
