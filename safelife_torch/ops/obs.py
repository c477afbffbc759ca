"""Agent-centered observations for batched boards
(port of ``safelife_tpu.ops.obs``).

* goal *colors* are merged into bits 12-14 of the board word (white goals
  optionally removed),
* the view is a torus crop centered on the agent (views larger than the
  board tile it),
* off-view exits are projected onto the view perimeter so their direction
  stays observable,
* the word is unpacked into binary channels (bits 0-14 by default).

The crop is a direct gather ``view[i, j] = x[(rs + i) % H, (cs + j) % W]``
per board; the GPU has no use for the TPU's barrel roll.
"""

import functools

import torch

from .. import bits16
from .. import cells as C


def combine_board_goals(board, goals, remove_white_goals=True):
    """Merge goal colors into bits 12-14 of the board word -> uint16.

    An add, not an OR, as in the reference (it wraps at 16 bits)."""
    gcol = goals.to(torch.int32) & C.COLORS
    if remove_white_goals:
        gcol = torch.where(gcol == C.COLORS, torch.zeros_like(gcol), gcol)
    return ((board.to(torch.int32) + (gcol << 3)) & 0xFFFF).to(torch.uint16)


def exit_offsets(exit_row, exit_col, agent_row, agent_col, board_shape,
                 view_shape):
    """View coordinates (K, B) of exits, clipped onto the view perimeter."""
    h, w = board_shape
    vh, vw = view_shape
    jy = torch.remainder(exit_row - agent_row[None, :] + h // 2, h) - h // 2
    jx = torch.remainder(exit_col - agent_col[None, :] + w // 2, w) - w // 2
    return (torch.clamp(jy + vh // 2, 0, vh - 1),
            torch.clamp(jx + vw // 2, 0, vw - 1))


def recenter(combined, agent_row, agent_col, view_shape,
             exit_row=None, exit_col=None, exit_valid=None):
    """Crop an agent-centered (vh, vw, B) view out of (H, W, B) boards."""
    h, w, b = combined.shape
    vh, vw = view_shape
    dev = combined.device
    rs = torch.remainder(agent_row - vh // 2, h)
    cs = torch.remainder(agent_col - vw // 2, w)
    rows = torch.remainder(
        rs[None, :] + torch.arange(vh, device=dev)[:, None], h)  # (vh, B)
    cols = torch.remainder(
        cs[None, :] + torch.arange(vw, device=dev)[:, None], w)  # (vw, B)
    lanes = torch.arange(b, device=dev)
    view = bits16(combined)[rows[:, None, :].long(), cols[None, :, :].long(),
                            lanes[None, None, :]].view(combined.dtype)

    if exit_row is not None:
        # Project exits onto the view perimeter; in row-major exit order
        # the last exit wins.
        jy, jx = exit_offsets(exit_row, exit_col, agent_row, agent_col,
                              (h, w), view_shape)
        vals = bits16(combined)[exit_row.long(), exit_col.long(),
                                lanes].view(combined.dtype)  # (K, B)
        view = put_exits(view, jy, jx, exit_valid, vals)
    return view


def put_exits(view, jy, jx, valid, vals):
    """``view`` (vh, vw, B) with ``vals[i]`` written at (jy[i], jx[i]) of
    the boards where ``valid[i]``, for i in order (the last one wins)."""
    lanes = torch.arange(view.shape[-1], device=view.device)
    out = view.to(torch.int32)  # the CPU has no index_put for uint16
    for i in range(jy.shape[0]):
        at = (jy[i].long(), jx[i].long(), lanes)
        out[at] = torch.where(valid[i] != 0, vals[i].to(torch.int32), out[at])
    return out.to(view.dtype)


@functools.lru_cache(maxsize=None)
def _channel_masks(channels, device):
    """The channels' bits as int16 words on ``device``, made once: a
    blocking copy from the host in every step would wait for the stream
    and cannot be captured in a CUDA graph."""
    return torch.tensor([1 << c for c in channels], dtype=torch.int32,
                        device=device).to(torch.int16)


def unpack_channels(view, channels):
    """(vh, vw, B) uint16 -> (B, vh, vw, C) uint8 binary channels.

    Transposes the packed view first and tests each channel's bit in
    16-bit words, so no intermediate is wider than the packed word."""
    masks = _channel_masks(tuple(channels), view.device)
    packed = bits16(view).permute(2, 0, 1).contiguous()
    return ((packed[..., None] & masks) != 0).view(torch.uint8)


def observe(board, goals, agent_row, agent_col,
            exit_row, exit_col, exit_valid,
            view_shape, output_channels=tuple(range(15)),
            remove_white_goals=True):
    """Full observation -> (B, vh, vw, C) uint8 (or packed uint16
    (B, vh, vw) when ``output_channels`` is None)."""
    combined = combine_board_goals(board, goals, remove_white_goals)
    view = recenter(combined, agent_row, agent_col, view_shape,
                    exit_row, exit_col, exit_valid)
    if output_channels is None:
        return transpose_view(view)
    return unpack_channels(view, output_channels)


def transpose_view(view):
    """(vh, vw, B) -> contiguous (B, vh, vw), dtype kept."""
    return bits16(view).permute(2, 0, 1).contiguous().view(view.dtype)
