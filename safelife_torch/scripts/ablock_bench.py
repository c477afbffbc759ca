"""Block-width sweep of the action kernel K1 alone on the card (the port of
``scripts/ablock_bench.py``, S2).

    python -m safelife_torch.scripts.ablock_bench

K1 runs one thread per (environment, row); the sweep launches it at 64,
128, 256, 512 and 1024 threads per block, the board fed back STEPS times
with action 2 (MOVE RIGHT) on every environment.  The TPU script swept
128-2048 lanes per block; a lane there is an environment in a vector
register, a thread here is an environment in one row, so the widths have
no one-to-one counterpart.  1024 threads is a CUDA block's limit.
"""

import torch

from .. import resolve_device
from ..levels import loader
from ..ops import env_step_kernels as esk
from . import best_of

B = 16384
STEPS = 64


def action_loop(si, block):
    """STEPS launches of K1 at ``block`` threads, the board fed back."""
    def run(board):
        total = torch.zeros((), dtype=torch.int64, device=board.device)
        for _ in range(STEPS):
            board, act_i = esk.apply_action(si, board, block=block)
            total += act_i[0].sum()
        return board, total
    return run


def main(device=None):
    dev = resolve_device(device)
    bank = loader.load_bank("benchmarks/v1.0/append-still", device=dev)
    board = bank.take(torch.arange(B, device=dev) % bank.num_levels).board
    si = torch.zeros((9, B), dtype=torch.int32, device=dev)
    si[0] = 2
    rows = {}
    for block in esk.ACTION_BLOCKS:
        best = best_of(dev, action_loop(si, block), board)
        print(f"block={block:5d}  {best/STEPS*1e6:9.1f} us/step", flush=True)
        rows[block] = best / STEPS * 1e6
    return rows


if __name__ == "__main__":
    main()
