"""Vectorized agent action execution over a batch of boards
(port of ``safelife_tpu.ops.agent``).

Action encoding (matches ``ACTION_NAMES`` in ``env/env.py``)::

    0        NULL
    1 - 4    MOVE UP / RIGHT / DOWN / LEFT
    5 - 8    TOGGLE UP / RIGHT / DOWN / LEFT

Both MOVE and TOGGLE first set the agent's orientation to the named
direction.  Cells touched (relative to the agent at ``p0``, facing ``d``):
``p1`` = 1 forward, ``p2`` = 1 backward (pull source), ``p3`` = 2 forward
(push target).  Each board reads four cells and writes at most four.
"""

from typing import NamedTuple

import torch

from .. import cells as C

# Orientation 0..3 = UP, RIGHT, DOWN, LEFT; rows grow downward.
_DR = (-1, 0, 1, 0)
_DC = (0, 1, 0, -1)


class ActionResult(NamedTuple):
    board: torch.Tensor        # (H, W, B) uint16
    agent_row: torch.Tensor    # (B,) int32
    agent_col: torch.Tensor    # (B,) int32
    orientation: torch.Tensor  # (B,) int32
    exited: torch.Tensor       # (B,) bool — agent stepped onto an open exit
    reward: torch.Tensor       # (B,) float32 — exit reward only


def direction(orient):
    """(dr, dc) per board for orientations 0..3."""
    dr = torch.as_tensor(_DR, dtype=torch.int32, device=orient.device)
    dc = torch.as_tensor(_DC, dtype=torch.int32, device=orient.device)
    return dr[orient.long()], dc[orient.long()]


def gather_cells(flat, idx):
    """Cells of a flattened ``(H*W, B)`` board at ``idx`` (..., B)."""
    return flat.gather(0, idx.reshape(-1, idx.shape[-1]).long()).reshape(
        idx.shape)


def masked_set(flat, idx, value, active):
    """In ``flat`` (H*W, B), set the cell at ``idx`` (B,) to ``value`` (B,)
    on boards where ``active``."""
    cur = gather_cells(flat, idx)
    flat.scatter_(0, idx.long()[None], torch.where(active, value, cur)[None])


def execute_action(board, agent_row, agent_col, orientation, action,
                   can_exit, game_over,
                   points_on_level_exit=1.0,
                   can_toggle_powers=False, can_toggle_colors=False):
    """Execute one action per board.  All args batched over trailing B."""
    h, w, b = board.shape
    action = action.to(torch.int32)
    act_dir = torch.remainder(action - 1, 4)

    is_move = (action >= 1) & (action <= 4) & ~game_over
    is_toggle = (action >= 5) & (action <= 8) & ~game_over
    new_orient = torch.where(is_move | is_toggle, act_dir,
                             orientation.to(torch.int32))

    dr, dc = direction(new_orient)
    r0, c0 = agent_row.to(torch.int32), agent_col.to(torch.int32)
    r1, c1 = torch.remainder(r0 + dr, h), torch.remainder(c0 + dc, w)
    r2, c2 = torch.remainder(r0 - dr, h), torch.remainder(c0 - dc, w)
    r3, c3 = torch.remainder(r0 + 2 * dr, h), torch.remainder(c0 + 2 * dc, w)
    i0, i1, i2, i3 = r0 * w + c0, r1 * w + c1, r2 * w + c2, r3 * w + c3

    flat = board.reshape(h * w, b).to(torch.int32, copy=True)
    v0, v1, v2, v3 = gather_cells(flat, torch.stack([i0, i1, i2, i3]))

    # ---- MOVE ----------------------------------------------------------
    front_empty = v1 == 0
    front_exit = ~front_empty & ((v1 & C.EXIT) != 0) & can_exit
    pushable = ~front_empty & ~front_exit & ((v1 & C.PUSHABLE) != 0)
    push_to_empty = pushable & (v3 == 0)
    push_out_exit = pushable & (v3 != 0) & ((v3 & C.EXIT) != 0)
    moved = is_move & (front_empty | push_to_empty | push_out_exit)
    exited = is_move & front_exit
    pulled = moved & ((v2 & C.PULLABLE) != 0)

    # ---- TOGGLE --------------------------------------------------------
    player_color = v0 & C.COLORS
    tgl_create = is_toggle & (v1 == 0)
    tgl_destroy = is_toggle & (v1 != 0) & ((v1 & C.DESTRUCTIBLE) != 0)
    toggle_bits = (C.POWERS * bool(can_toggle_powers)
                   | C.COLORS * bool(can_toggle_colors))
    tgl_absorb = is_toggle & (v1 != 0) & ((v1 & C.DESTRUCTIBLE) == 0)

    # ---- masked writes, in this order (positions may coincide on boards
    # narrower than four cells, and then the later write wins) ------------
    zero = torch.zeros_like(v0)
    # p3: pushed cell lands (only when pushing into empty space).
    masked_set(flat, i3, v1, is_move & push_to_empty)
    # p1: agent moves in, or toggle creates/destroys.
    p1_val = torch.where(moved, v0,
                         torch.where(tgl_create, C.LIFE | player_color, zero))
    masked_set(flat, i1, p1_val, moved | tgl_create | tgl_destroy)
    # p2: pulled cell leaves.
    masked_set(flat, i2, zero, pulled)
    # p0: agent leaves (possibly replaced by pulled cell), or absorbs powers.
    p0_val = torch.where(pulled, v2,
                         torch.where(tgl_absorb, v0 ^ (v1 & toggle_bits),
                                     zero))
    masked_set(flat, i0, p0_val, moved | tgl_absorb)

    return ActionResult(
        board=flat.reshape(h, w, b).to(torch.uint16),
        agent_row=torch.where(moved, r1, r0),
        agent_col=torch.where(moved, c1, c0),
        orientation=new_orient,
        exited=exited,
        reward=exited.to(torch.float32) * points_on_level_exit,
    )
