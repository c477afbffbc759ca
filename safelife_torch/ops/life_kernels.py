"""The spawnless CA rule as one packed neighbor-sum (counterpart of
``safelife_tpu.ops.life_pallas``).

Every count the rule needs on a board without spawners fits one int32 word
of 4-bit fields (alive@0, r@4, g@8, b@12, destructible@16, preserving@20,
inhibiting@24); one 3x3 torus sum of that word gives them all, and no
field carries into the next (counts <= 9).  This is the rule of the banks
with static goals and no spawners (the ``*-still`` suites).

:func:`advance_spawnless` launches kernel K4 (``csrc/life_kernels.cu``)
on a CUDA tensor and runs the plain version below on a CPU tensor.  The
other rules of ``life_pallas`` (spawn fields, simple goals, pairs) are not
ported yet.
"""

import torch

from .. import cells as C
from . import _build
from .life import nb_sum


def _fold_ge2(counts, mask):
    """OR-fold each masked count field's bits-above-unit onto its base bit:
    after this, ``m & (1 << base)`` tests "field value >= 2"."""
    m = (counts >> 1) & mask
    m = m | (m >> 2)
    return m | (m >> 1)


def _pack_full4(board):
    """Spawnless full-rule board -> one 28-bit count word (4-bit fields)."""
    alive = board & 1
    c3 = (board >> C.COLOR_BIT) & 7
    spread = (c3 * 0x49) & 0x111                      # r@0, g@4, b@8
    has_d = ((board >> C.DESTRUCTIBLE_BIT) | (board >> C.EXIT_BIT)) & 1
    pi2 = (board >> C.PRESERVING_BIT) & 3
    # pi deposit: partial products of 2^20 + 2^23 land uniquely on {20, 24}.
    return (alive + ((spread * alive) << 4) + ((has_d * alive) << 16)
            + ((pi2 * 0x900000) & 0x1100000))


def _extract4(counts):
    n_alive = counts & 15
    m = _fold_ge2(counts, (7 << 4) | (7 << 8) | (7 << 12) | (7 << 16))
    t = m & ((1 << 4) | (1 << 8) | (1 << 12))
    inherit = ((t >> 3) * 0x124) & C.COLORS
    born_d = (m >> 13) & C.DESTRUCTIBLE
    preserved = ((counts >> 20) & 15) != 0
    inhibited = ((counts >> 24) & 15) != 0
    return n_alive, inherit, born_d, preserved, inhibited


def _core_full(board, n_alive, inherit, born_d, preserved, inhibited):
    """The spawnless CA rule given the extracted neighborhood quantities."""
    is_alive = (board & 1) != 0
    frozen = (board & C.FROZEN) != 0
    three = n_alive == 3
    survives = frozen | three | (n_alive == 4) | preserved
    born = three & ~frozen & ~inhibited
    born_cell = C.ALIVE | inherit | born_d
    return torch.where(
        is_alive, torch.where(survives, board, torch.zeros_like(board)),
        torch.where(born, born_cell, board))


def _advance_spawnless(board):
    """Full-rule advance of an int32 spawnless board in ONE neighbor-sum."""
    return _core_full(board, *_extract4(nb_sum(_pack_full4(board))))


def advance_spawnless_plain(board):
    """The plain version of kernel K4: uint16 boards in and out, on any
    device."""
    return _advance_spawnless(board.to(torch.int32)).to(torch.uint16)


def advance_spawnless(board):
    """Advance spawner-free ``(H, W, B)`` uint16 boards one CA step.

    Equal to ``life.advance_board`` with a never-firing spawn field on
    such boards.  A CUDA tensor goes through kernel K4; a CPU tensor
    through the plain version.
    """
    if board.device.type == "cpu":
        return advance_spawnless_plain(board)
    _build.check_cuda(board, dtypes=(torch.uint16,))
    h, w, b = board.shape
    out = torch.empty_like(board)
    if b:
        _build.launch("K4_advance_spawnless", "life_kernels",
                      "sl_advance_spawnless", board.data_ptr(),
                      out.data_ptr(), h, w, b)
    return out
