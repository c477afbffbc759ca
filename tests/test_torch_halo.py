"""The port's sharded-board CA (``safelife_torch.parallel.halo``) against
the JAX package on the CPU, bit for bit.

* The padded-block argument: K5's plain version on a block padded with
  one halo row above and below (a zero spawn field there), rows 1 to h,
  equals the JAX package's open-boundary step ``_advance_open_rows`` on
  the same padded block, on random soups with spawners on the block's
  edge rows and in the halo rows.
* ``advance_board_sharded`` at world size 1 (no process group) against
  ``safelife_tpu.ops.life.advance_board``: ``tests/test_halo.py``'s two
  cases, a 64x32 soup (one step) and two blinkers across shard borders (4
  steps); ``tests/test_torch_parallel.py`` holds the same cases on two
  gloo ranks (in the same launch as its other two-rank cases).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from safelife_torch import cells as C
from safelife_torch.ops import life_kernels
from safelife_torch.parallel import halo, mesh as pmesh
from safelife_tpu.ops import life as jlife
from safelife_tpu.parallel.halo import _advance_open_rows

torch.set_num_threads(1)


_advance_board = jax.jit(jlife.advance_board)


def jax_advance(board, spawn, steps=1):
    """``steps`` steps of the JAX package's CA on an (H, W) board."""
    b = jnp.asarray(board.numpy())[..., None]
    s = jnp.asarray(spawn.numpy())[..., None]
    for _ in range(steps):
        b = _advance_board(b, s)
    return np.asarray(b)[..., 0]


@pytest.mark.parametrize("seed,shape", [(0, (8, 12, 5)), (1, (3, 9, 4)),
                                        (2, (1, 16, 3)), (3, (26, 26, 2))])
def test_padded_block_k5_matches_open_rows(seed, shape):
    h, w, b = shape
    rng = np.random.RandomState(seed)
    padded = np.zeros((h + 2, w, b), np.uint16)
    padded[rng.rand(h + 2, w, b) < 0.35] = C.LIFE | C.COLOR_G
    padded[rng.rand(h + 2, w, b) < 0.05] = C.WALL
    padded[rng.rand(h + 2, w, b) < 0.03] = C.TREE
    padded[rng.rand(h + 2, w, b) < 0.03] = C.PLANT
    # Spawners on the block's first and last rows and in the halo rows.
    for row in {0, 1, h, h + 1}:
        padded[row, rng.rand(w, b) < 0.3] = C.SPAWNER
    spawn = rng.rand(h + 2, w, b) < 0.3
    spawn[0] = spawn[-1] = False
    want = np.asarray(jax.jit(_advance_open_rows)(
        jnp.asarray(padded), jnp.asarray(spawn)))[1:-1]
    got = life_kernels.advance_with_field(
        torch.as_tensor(padded), torch.as_tensor(spawn))[1:-1]
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(padded[1:-1], got.numpy())  # a real step


def test_sharded_advance_one_rank():
    mesh = pmesh.make_mesh(device="cpu")
    board, spawn = torch_ranks.halo_soup()
    got = halo.advance_board_sharded(board, spawn, mesh)
    np.testing.assert_array_equal(got.numpy(), jax_advance(board, spawn))
    block = torch_ranks.blinkers()
    none = torch.zeros_like(block, dtype=torch.bool)
    for _ in range(4):
        block = halo.advance_board_sharded(block, none, mesh)
    np.testing.assert_array_equal(
        block.numpy(), jax_advance(torch_ranks.blinkers(), none, 4))
    # Batch-trailing boards (H, W, B) too.
    batch = torch.stack([board, torch.flip(board, (0,))], -1)
    fields = torch.stack([spawn, spawn], -1)
    got = halo.advance_board_sharded(batch, fields, mesh)
    for i in range(2):
        np.testing.assert_array_equal(
            got[..., i].numpy(), jax_advance(batch[..., i], fields[..., i]))
    assert not mesh.collective_bytes  # one rank: its own rows close the ring


