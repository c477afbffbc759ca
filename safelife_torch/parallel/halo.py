"""Sharded-board CA: the halo exchange for boards larger than one device
(port of ``safelife_tpu.parallel.halo``).

SafeLife's benchmark boards are small and scale by batching; this module
covers the other axis: boards whose HEIGHT is split over the ranks of the
mesh's data axis.  Each step every rank sends its first and last rows to
its ring neighbours (one row each way, the 1-cell toroidal border), pads
its block with the rows it received, and advances the padded block with
K5 (``ops/life_kernels.advance_with_field``), keeping the inner rows.

Why K5 on the padded block is right: a cell's next state reads only the
3x3 neighbourhood around it and its own spawn draw.  K5 wraps the padded
block of h + 2 rows as a torus, but that wrap reaches only the two halo
rows, whose outputs are dropped; every inner row sees the rows above and
below it exactly as on the whole board.  The halo rows get a zero spawn
field (their draw is not read).  The JAX package advances the block with
an open-boundary rule instead (``_advance_open_rows``); the CPU tests hold
the two against each other.
"""

import torch

from ..ops import life_kernels


def shard_rows(board, mesh):
    """This rank's block of rows of a whole ``(H, W[, B])`` board."""
    return board[mesh.rows(board.shape[0])].contiguous()


def gather_rows(block, mesh):
    """The whole board from every rank's block of rows."""
    return mesh.all_gather(block, dim=0)


def halo_rows(block, mesh):
    """(top, bottom): the row above this rank's block (the previous rank's
    last row) and the row below it (the next rank's first row), around
    the ring.  On one rank they are the block's own last and first rows,
    which closes the torus."""
    if mesh.world_size == 1:
        return block[-1:], block[:1]
    nxt = (mesh.rank + 1) % mesh.world_size
    prv = (mesh.rank - 1) % mesh.world_size
    # Tag 0 travels down the ring (a last row to the next rank's top),
    # tag 1 up it; with two ranks both go to the same peer.
    top, bottom = mesh.exchange(
        sends=[(block[-1:], nxt, 0), (block[:1], prv, 1)],
        recvs=[(block[-1:], prv, 0), (block[:1], nxt, 1)])
    return top, bottom


def advance_board_sharded(block, spawn, mesh):
    """One CA step of a ``(H, W[, B])`` uint16 board split by rows over the
    mesh: ``block`` and ``spawn`` (bool) are this rank's rows (see
    :func:`shard_rows`), and the advanced block is returned.  Equal to
    ``ops.life.advance_board`` on the whole board; communication is one
    row in each ring direction."""
    flat = block.dim() == 2
    if flat:
        block, spawn = block[..., None], spawn[..., None]
    top, bottom = halo_rows(block, mesh)
    padded = torch.cat([top, block, bottom]).contiguous()
    none = torch.zeros_like(spawn[:1], dtype=torch.bool)
    pad_spawn = torch.cat([none, spawn.to(torch.bool), none]).contiguous()
    out = life_kernels.advance_with_field(padded, pad_spawn)[1:-1]
    return out[..., 0] if flat else out
