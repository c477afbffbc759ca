"""The plain versions of S1-S5 against the TPU kernels of the JAX package's
measurement scripts, run in interpret mode on the CPU, bit for bit:

* S3-S5: ``scripts/obs_micro.py``'s chained crop, transpose and
  neighbour-sum loops (its Pallas kernels under
  ``force_tpu_interpret_mode``) against the chained loops of
  ``safelife_torch.scripts.obs_micro``, every variant the script times,
  the uint8 wrap included;
* S1/S2: the ``pallas_call`` of ``env_step_pallas._action_kernel`` that
  ``scripts/stepbench.py`` and ``scripts/ablock_bench.py`` build, chained,
  against ``action_plain``.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from safelife_torch.ops import env_step_kernels, obs_micro as om
from safelife_torch.scripts import obs_micro as tscript
from safelife_tpu.levels import loader as jloader
from safelife_tpu.ops import env_step_pallas as esp

# The tensors here are small.  One thread keeps torch from leaving an
# OpenMP pool in the test process that slows the JAX tests run after it.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 256
STEPS = 2
DTYPES = {"int32": jnp.int32, "uint16": jnp.uint16, "uint8": jnp.uint8}


@pytest.fixture(scope="module")
def script():
    """``scripts/obs_micro.py`` at B = 256, 2 chained steps."""
    spec = importlib.util.spec_from_file_location(
        "jax_obs_micro", os.path.join(ROOT, "scripts", "obs_micro.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.B, module.STEPS = B, STEPS
    return module


@pytest.fixture
def port(monkeypatch):
    monkeypatch.setattr(tscript, "B", B)
    monkeypatch.setattr(tscript, "STEPS", STEPS)
    return tscript


def _inputs(seed, shape, high):
    rng = np.random.RandomState(seed)
    return rng.randint(0, high, shape).astype(np.uint16)


def _run_script(fn, *args):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(*(jnp.asarray(a) for a in args)))


@pytest.mark.parametrize("compute", om.COMPUTES)
def test_view_crop_loop_matches_script(script, port, compute):
    x = _inputs(1, (26, 26, B), 2**15)
    si = np.random.RandomState(2).randint(0, 26, (2, B)).astype(np.int32)
    want = _run_script(script.make_roll_kernel(DTYPES[compute]), x, si)
    got = port.roll_loop(compute)(torch.as_tensor(x), torch.as_tensor(si))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("compute", om.COMPUTES)
def test_view_crop_wraps_any_shift(compute):
    """S3's plain version at shifts beyond the board both ways and a view
    that is neither square nor smaller than the board along one axis,
    against per-environment numpy rolls."""
    x = _inputs(6, (7, 5, 33), 2**16)
    si = np.random.RandomState(7).randint(-40, 40, (2, 33)).astype(np.int32)
    got = om.view_crop(torch.as_tensor(x), torch.as_tensor(si), compute,
                       (4, 9)).numpy()
    for b in range(33):
        rolled = np.roll(x[..., b], (-si[0, b], -si[1, b]), axis=(0, 1))
        np.testing.assert_array_equal(got[..., b],
                                      np.tile(rolled, (1, 2))[:4, :9])


@pytest.mark.parametrize("compute", om.COMPUTES)
def test_view_transpose_loop_matches_script(script, port, compute):
    v = _inputs(3, (15, 15, B), 2**15)
    want = _run_script(script.make_transpose_kernel(DTYPES[compute]), v)
    got = port.transpose_loop(compute)(torch.as_tensor(v))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        port.library_transpose_loop(torch.as_tensor(v)).numpy(), want)


# The script's five rows on its small values (x & 15; uint8 x4 wraps),
# then uint16 x4 and full-range inputs that wrap at 8 and 16 bits.
@pytest.mark.parametrize("dtype,planes,high", [
    (dtype, planes, 16) for _, dtype, planes in tscript.NB_SUM_ROWS]
    + [("uint16", 4, 16), ("uint8", 4, 2**16), ("int32", 4, 2**16)])
def test_nb_sum_loop_matches_script(script, port, dtype, planes, high):
    x = _inputs(4, (26, 26, B), high)
    want = _run_script(script.make_nbsum_kernel(DTYPES[dtype], planes), x)
    got = port.nbsum_loop(dtype, planes)(torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), want)
    if dtype == "uint8" and planes == 4:
        # The first step already overflows 8 bits.
        wide = om.nb_sum_planes_plain(torch.as_tensor(x), "int32", planes)
        assert int(wide.to(torch.int32).max()) > 255 >= want.max()


def _action_si(kind):
    """``si`` as ``stepbench.py`` builds it (action 2 everywhere, rows 6
    and 7 unused), or random actions, agents, game-over flags and exit
    gates."""
    si = np.zeros((8, B), np.int32)
    if kind == "stepbench":
        si[0] = 2
        return si
    rng = np.random.RandomState(5)
    si[0] = rng.randint(0, 9, B)
    si[1] = rng.randint(0, 26, B)
    si[2] = rng.randint(0, 26, B)
    si[3] = rng.randint(0, 4, B)
    si[4] = rng.random(B) < 0.1
    si[5] = rng.random(B) < 0.5
    return si


@pytest.mark.parametrize("kind", ["stepbench", "random"])
def test_action_kernel_chain_matches_script(kind):
    """S1/S2: ``scripts/stepbench.py:111``'s ``pallas_call``, interpret
    mode, the board fed back 4 times."""
    bank = jloader.load_bank("benchmarks/v1.0/append-still")
    board = np.asarray(bank.board)[..., np.arange(B) % bank.num_levels]
    si = _action_si(kind)
    h, w, _ = board.shape
    block = esp.LANES
    board_spec = pl.BlockSpec((h, w, block), lambda i: (0, 0, i),
                              memory_space=pltpu.VMEM)
    lane_spec = lambda rows: pl.BlockSpec(  # noqa: E731
        (rows, block), lambda i: (0, i), memory_space=pltpu.VMEM)
    call = jax.jit(pl.pallas_call(
        esp._action_kernel, grid=(B // block,),
        in_specs=[lane_spec(8), board_spec],
        out_specs=(board_spec, lane_spec(4)),
        out_shape=(jax.ShapeDtypeStruct((h, w, B), jnp.uint16),
                   jax.ShapeDtypeStruct((4, B), jnp.int32)),
        interpret=True))
    jb, tb = jnp.asarray(board), torch.as_tensor(board)
    tsi = torch.as_tensor(si)
    for step in range(4):
        jb, jact = call(jnp.asarray(si), jb)
        tb, tact = env_step_kernels.apply_action(tsi, tb)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb),
                                      err_msg=f"board, step {step}")
        np.testing.assert_array_equal(tact.numpy(), np.asarray(jact),
                                      err_msg=f"act_i, step {step}")
