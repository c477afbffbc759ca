"""Batched SafeLife CA step on tensors (port of ``safelife_tpu.ops.life``).

Boards are ``(H, W, ...)`` uint16 with the batch trailing.  The rule needs
five neighborhood counts (alive, three color-inheritance weights,
destructible weight); they are packed into 5-bit fields of one int32 plane
so that one 3x3 torus sum produces all of them.  Flag presence
(preserving / inhibiting / spawning) is one bitwise-OR stencil.

Randomness is an input: :func:`advance_board` takes a boolean ``spawn``
field, so the caller decides where it comes from.

All arithmetic is int32: the CPU build of torch has no ``>>`` or ``<`` for
uint16.  Results are stored back as uint16.
"""

import torch

from .. import cells as C


def nb_sum(x):
    """Self-inclusive 3x3 torus sum over the leading (H, W) axes."""
    r = x + torch.roll(x, 1, dims=1) + torch.roll(x, -1, dims=1)
    return r + torch.roll(r, 1, dims=0) + torch.roll(r, -1, dims=0)


def nb_or(x):
    """Self-inclusive 3x3 torus bitwise-OR over the leading (H, W) axes."""
    r = x | torch.roll(x, 1, dims=1) | torch.roll(x, -1, dims=1)
    return r | torch.roll(r, 1, dims=0) | torch.roll(r, -1, dims=0)


def advance_board(board, spawn):
    """Advance boards one CA step.

    board: uint16 ``(H, W, ...)``.  spawn: bool, same shape — True where a
    spawn event fires *if* the cell is spawn-eligible.  Returns uint16.
    """
    b = board.to(torch.int32)
    alive = b & 1
    spawning = (b >> C.SPAWNING_BIT) & 1
    has_r = (b >> C.COLOR_BIT) & 1
    has_g = (b >> (C.COLOR_BIT + 1)) & 1
    has_b = (b >> (C.COLOR_BIT + 2)) & 1
    # Live cells weigh once, spawners twice ("spawner colors always
    # inherit"); the destructible weight counts live cells whose
    # destructible-or-exit bit is set (the reference's exit aliasing).
    cw = alive + 2 * spawning
    has_d = ((b >> C.DESTRUCTIBLE_BIT) | (b >> C.EXIT_BIT)) & 1

    packed = (alive
              + ((has_r * cw) << 5)
              + ((has_g * cw) << 10)
              + ((has_b * cw) << 15)
              + ((has_d * alive) << 20))
    counts = nb_sum(packed)

    n_alive = counts & 31
    inherit = ((((counts >> 5) & 31) >= 2).to(torch.int32) * C.COLOR_R
               | (((counts >> 10) & 31) >= 2).to(torch.int32) * C.COLOR_G
               | (((counts >> 15) & 31) >= 2).to(torch.int32) * C.COLOR_B)
    destr2 = ((counts >> 20) & 31) >= 2

    flags = nb_or(b)
    preserved = (flags & C.PRESERVING) != 0
    inhibited = (flags & C.INHIBITING) != 0
    near_spawner = (flags & C.SPAWNING) != 0

    is_alive = alive != 0
    frozen = (b & C.FROZEN) != 0
    three = n_alive == 3
    survives = frozen | preserved | three | (n_alive == 4)
    born = three & ~frozen & ~inhibited
    spawned = (~frozen & ~inhibited & ~born & near_spawner
               & spawn.to(torch.bool))

    born_cell = C.ALIVE | inherit | destr2.to(torch.int32) * C.DESTRUCTIBLE
    spawn_cell = (C.ALIVE | C.DESTRUCTIBLE) | inherit

    zero = torch.zeros_like(b)
    out = torch.where(
        is_alive,
        torch.where(survives, b, zero),
        torch.where(born, born_cell,
                    torch.where(spawned, spawn_cell, b)))
    return out.to(torch.uint16)
