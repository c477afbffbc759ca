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

On the card, :func:`unpack_channels` and :func:`transpose_view` take the
packed ``(vh, vw, B)`` view batch-major in one hand-written kernel
(``csrc/view_kernels.cu``, its UNPACK and KEEP epilogues, with the launch
geometry of :func:`view_geometry`), and :func:`obs_sum` sums an
observation in one read (``csrc/obs_sum.cu``); on CPU tensors they run
their plain versions, ``*_plain``.
"""

import functools

import torch

from .. import bits16
from .. import cells as C
from . import _build


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


def unpack_channels_plain(view, channels):
    """The plain version of :func:`unpack_channels`.

    Transposes the packed view first and tests each channel's bit in
    16-bit words, so no intermediate is wider than the packed word."""
    masks = _channel_masks(tuple(channels), view.device)
    packed = bits16(view).permute(2, 0, 1).contiguous()
    return ((packed[..., None] & masks) != 0).view(torch.uint8)


def unpack_channels(view, channels):
    """(vh, vw, B) uint16 -> (B, vh, vw, C) uint8 binary channels: channel
    ``c`` is bit ``channels[c]`` of the word.  The view kernel's UNPACK
    epilogue on CUDA, the plain version on the CPU."""
    if view.device.type == "cpu":
        return unpack_channels_plain(view, channels)
    return launch_view(view, tuple(channels), "S4_view_unpack")


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


def transpose_view_plain(view):
    """The plain version of :func:`transpose_view`."""
    return bits16(view).permute(2, 0, 1).contiguous().view(view.dtype)


def transpose_view(view):
    """(vh, vw, B) uint16 -> contiguous (B, vh, vw): the view kernel's KEEP
    epilogue on CUDA, the plain version on the CPU."""
    if view.device.type == "cpu":
        return transpose_view_plain(view)
    return launch_view(view, None, "S4_view_keep")


# ---------------------------------------------------------------------------
# The view kernel (csrc/view_kernels.cu)
# ---------------------------------------------------------------------------

# Its launch limits, which the kernel checks: staged slab widths E (each
# divides VIEW_THREADS), threads a staged block and of the streamed
# variant, and the most channels.
VIEW_ENVS = (32, 16, 8)
VIEW_THREADS = 256
VIEW_STREAM_THREADS = 128
MAX_CHANNELS = 16


def view_smem(cells, envs, channels):
    """Shared bytes of a staged block: the slab and its transpose (2 bytes
    a cell and environment each), then for UNPACK the output buffer (C
    bytes a cell), with room for the last group of 16 cells when the
    block's cells are not a multiple of 16."""
    c = 0 if channels is None else len(channels)
    return cells * envs * (4 + c) + 16 * c


def view_geometry(vh, vw, b, channels, vector=True):
    """The launch geometry of the view kernel on a (``vh``, ``vw``, ``b``)
    view: KEEP for ``channels`` None, else UNPACK of those bit positions.

    A staged block keeps E environments' slab, its transpose and (UNPACK)
    its output in shared memory, ``smem`` bytes (:func:`view_smem`); E is
    the :func:`_build.widest_slab` of the multiples of 16 in
    :data:`VIEW_ENVS` that fit, else of the rest, so that a block's output
    range starts on a 16-byte boundary whatever C is.  ``vector``: the
    slab is staged in 16-byte copies, where the view is 16-byte aligned
    (``vector``) and ``b % 8 == 0``.  ``bulk``: a block writes its output
    range with one bulk copy (``cp.async.bulk``) where the range, E * vh *
    vw * C bytes (2 a cell for KEEP), is a multiple of 16; else narrow
    stores (1 byte for UNPACK, 2 for KEEP).  Where no slab of 8 fits, the
    streamed variant reads the view in device memory (``staged`` false).

    Returns a dict of envs, threads, smem, blocks (None when streamed),
    staged, vector and bulk.
    """
    cells = vh * vw
    c = 0 if channels is None else len(channels)
    slab = None
    for widths in ([e for e in VIEW_ENVS if e % 16 == 0],
                   [e for e in VIEW_ENVS if e % 16]):
        slab = slab or _build.pick_slab(cells, 4 + c, widths, 16 * c)
    if slab is None:
        return dict(envs=VIEW_STREAM_THREADS, threads=VIEW_STREAM_THREADS,
                    smem=0, blocks=None, staged=False, vector=False,
                    bulk=False)
    return dict(slab, smem=view_smem(cells, slab["envs"], channels),
                threads=VIEW_THREADS, staged=True,
                vector=bool(vector and b % 8 == 0),
                bulk=slab["envs"] * cells * (c or 2) % 16 == 0)


def launch_view(view, channels, kernel):
    """The view kernel on a CUDA ``(vh, vw, B)`` uint16 view, counted
    under ``kernel``: KEEP for ``channels`` None, else UNPACK.  The output
    is made here, so it starts on the caching allocator's 512-byte
    boundary, as the bulk copy needs."""
    if channels is not None and (not 1 <= len(channels) <= MAX_CHANNELS
                                 or not all(0 <= c < 16 for c in channels)):
        raise ValueError(f"the view kernel takes 1 to {MAX_CHANNELS} "
                         f"channels of bits 0-15, not {channels}")
    _build.check_cuda(view, dtypes=(torch.uint16,))
    vh, vw, b = view.shape
    if channels is None:
        out = torch.empty((b, vh, vw), dtype=torch.uint16, device=view.device)
        bits = 0
    else:
        out = torch.empty((b, vh, vw, len(channels)), dtype=torch.uint8,
                          device=view.device)
        bits = sum(c << (4 * i) for i, c in enumerate(channels))
    geo = view_geometry(vh, vw, b, channels, _build.vector_path(b, view))
    if out.numel():
        _build.launch(kernel, "view_kernels", "sl_view", view.data_ptr(),
                      out.data_ptr(), vh, vw, b,
                      0 if channels is None else len(channels), bits,
                      geo["envs"], int(geo["vector"]), int(geo["bulk"]),
                      int(geo["staged"]))
    return out


# ---------------------------------------------------------------------------
# The observation sum (csrc/obs_sum.cu)
# ---------------------------------------------------------------------------

# Threads a block and 16-byte vectors in flight a thread (csrc/obs_sum.cu),
# and resident blocks an SM the grid is capped at.
SUM_THREADS = 256
SUM_UNROLL = 4
SUM_BLOCKS_PER_SM = 8


def sum_blocks(nbytes):
    """The grid of the sum kernel over ``nbytes`` bytes: a block for each
    SUM_THREADS * SUM_UNROLL vectors of 16 bytes, at most
    SUM_BLOCKS_PER_SM a streaming multiprocessor (the grid-stride loop
    takes the rest), at least one."""
    per_block = SUM_THREADS * SUM_UNROLL * 16
    return max(1, min(-(-nbytes // per_block),
                      SUM_BLOCKS_PER_SM * _build.SM_COUNT))


def obs_sum_plain(obs):
    """The plain version of :func:`obs_sum`: torch's int32 sum (uint16,
    which has no sum on CUDA, widened first)."""
    if obs.dtype == torch.uint8:
        return obs.sum(dtype=torch.int32)
    return obs.to(torch.int32).sum(dtype=torch.int32)


def obs_sum(obs):
    """The int32 sum (wrapping) of a uint8 or uint16 tensor of any shape,
    as a 0-d tensor: the sum kernel on CUDA, one read of the tensor; the
    plain version on the CPU."""
    if obs.device.type == "cpu":
        return obs_sum_plain(obs)
    if obs.dtype not in (torch.uint8, torch.uint16):
        raise ValueError(f"obs_sum takes uint8 or uint16, not {obs.dtype}")
    _build.check_cuda(obs, dtypes=(obs.dtype,))
    out = torch.zeros((), dtype=torch.int32, device=obs.device)
    n = obs.numel()
    if n:
        elem = obs.element_size()
        _build.launch("R1_obs_sum", "obs_sum", "sl_obs_sum", obs.data_ptr(),
                      n, elem, sum_blocks(n * elem), out.data_ptr())
    return out
