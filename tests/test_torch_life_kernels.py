"""The plain version of kernel K4 (the spawnless CA rule in one packed
neighbor-sum) against the TPU kernel run in interpret mode, and against
the general rule, bit for bit."""

import jax.numpy as jnp
import numpy as np
import torch

import safelife_tpu.cells as C
from safelife_torch.ops import life as tlife
from safelife_torch.ops import life_kernels
from safelife_tpu.ops import life_pallas

# The tensors here are small.  One thread keeps torch from leaving an
# OpenMP pool in the test process that slows the JAX tests run after it.
torch.set_num_threads(1)

FLAGS = [C.ALIVE, C.AGENT, C.PUSHABLE, C.DESTRUCTIBLE, C.FROZEN,
         C.PRESERVING, C.INHIBITING, C.EXIT, C.COLOR_R, C.COLOR_G, C.COLOR_B,
         C.PULLABLE]


def spawnless_soup(rng, shape, density=0.15):
    """Random boards with every flag except spawning."""
    board = np.zeros(shape, np.uint16)
    for f in FLAGS:
        board |= np.uint16(f) * (rng.random(shape) < density).astype(
            np.uint16)
    return board


def test_advance_spawnless_matches_pallas_interpret():
    rng = np.random.RandomState(41)
    board = spawnless_soup(rng, (26, 26, 128))
    jb, tb = jnp.asarray(board), torch.as_tensor(board)
    interp = life_pallas.interpret_params()
    for step in range(6):
        jb = life_pallas.advance_spawnless(jb, interpret=interp)
        tb = life_kernels.advance_spawnless(tb)
        assert tb.dtype == torch.uint16
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb),
                                      err_msg=f"step {step}")


def test_advance_spawnless_matches_general_rule():
    rng = np.random.RandomState(42)
    board = torch.as_tensor(spawnless_soup(rng, (17, 23, 37), density=0.2))
    no_spawn = torch.zeros(board.shape, dtype=torch.bool)
    for step in range(6):
        want = tlife.advance_board(board, no_spawn)
        board = life_kernels.advance_spawnless_plain(board)
        assert torch.equal(board, want), f"step {step}"
