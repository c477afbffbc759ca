"""The port's plain tensor ops against the JAX package's ops and the C
engine's golden traces, bit for bit."""

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import safelife_tpu.cells as C
from safelife_torch.ops import agent as tagent
from safelife_torch.ops import life as tlife
from safelife_torch.ops import obs as tobs
from safelife_torch.ops import scoring as tscoring
from safelife_tpu.env.state import find_exits
from safelife_tpu.ops import agent as jagent
from safelife_tpu.ops import life as jlife
from safelife_tpu.ops import obs as jobs
from safelife_tpu.ops import scoring as jscoring
from safelife_tpu.ops.life_numpy import spawn_consumption_mask
from safelife_tpu.utils.rng import NumpyRandomBridge

# The tensors here are small.  One thread keeps torch from leaving an
# OpenMP pool in the test process that slows the JAX tests run after it.
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "ca_steps.npz")
FLAGS = np.array(
    [C.ALIVE, C.AGENT, C.PUSHABLE, C.DESTRUCTIBLE, C.FROZEN,
     C.PRESERVING, C.INHIBITING, C.SPAWNING, C.EXIT,
     C.COLOR_R, C.COLOR_G, C.COLOR_B, C.PULLABLE], dtype=np.uint16)


def rich_soup(rng, shape, density=0.15):
    """Random boards exercising every cell flag (incl. exotic combos)."""
    board = np.zeros(shape, np.uint16)
    for f in FLAGS:
        board |= f * (rng.random(shape) < density).astype(np.uint16)
    return board


def t(x):
    return torch.as_tensor(np.array(x))


def assert_equal(got, want, msg=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=msg)


@pytest.mark.parametrize("shape", [(26, 26, 64), (13, 19, 5)])
def test_advance_board_matches_jax_on_soups(shape):
    rng = np.random.RandomState(11)
    adv = jax.jit(jlife.advance_board)
    for trial in range(3):
        board = rich_soup(rng, shape)
        spawn = rng.random(shape) < 0.4
        got = tlife.advance_board(t(board), t(spawn))
        assert got.dtype == torch.uint16
        assert_equal(got, adv(jnp.asarray(board), jnp.asarray(spawn)),
                     f"trial {trial}")


def _golden_cases():
    with np.load(GOLDEN) as data:
        return sorted({k.split("/")[0] for k in data.files})


@pytest.mark.parametrize("name", _golden_cases())
def test_advance_board_matches_c_engine(name):
    with np.load(GOLDEN) as golden:
        board = golden[name + "/input"]
        steps = golden[name + "/steps"]
        spawn_prob = float(golden[name + "/spawn_prob"])
    rng = NumpyRandomBridge(17)
    b = board
    for step in range(steps.shape[0]):
        # The spawn decisions drawn as the C engine draws them.
        mask = spawn_consumption_mask(b)
        field = np.zeros(b.shape, bool)
        if mask.any():
            field[mask] = rng.draw(int(mask.sum())) < spawn_prob
        b = tlife.advance_board(t(b), t(field)).numpy()
        np.testing.assert_array_equal(b, steps[step],
                                      err_msg=f"{name} step {step}")


def _action_inputs(rng, shape=(26, 26, 128)):
    h, w, b = shape
    board = rich_soup(rng, shape)
    ar = rng.randint(0, h, b).astype(np.int32)
    ac = rng.randint(0, w, b).astype(np.int32)
    board[ar, ac, np.arange(b)] = np.uint16(C.PLAYER | C.COLOR_G)
    return dict(board=board, agent_row=ar, agent_col=ac,
                orientation=rng.randint(0, 4, b).astype(np.int32),
                action=np.arange(b, dtype=np.int32) % 9,
                can_exit=rng.random(b) < 0.5,
                game_over=rng.random(b) < 0.1)


@pytest.mark.parametrize("powers,colors", [
    (False, False), (True, False), (False, True), (True, True)])
def test_execute_action_matches_jax(powers, colors):
    rng = np.random.RandomState(5 + 2 * powers + colors)
    inputs = _action_inputs(rng)
    want = jax.jit(partial(jagent.execute_action, points_on_level_exit=2.5,
                           can_toggle_powers=powers,
                           can_toggle_colors=colors))(
        **{k: jnp.asarray(v) for k, v in inputs.items()})
    got = tagent.execute_action(
        **{k: t(v) for k, v in inputs.items()}, points_on_level_exit=2.5,
        can_toggle_powers=powers, can_toggle_colors=colors)
    for name in want._fields:
        assert_equal(getattr(got, name), getattr(want, name), name)


def test_scoring_matches_jax():
    rng = np.random.RandomState(8)
    shape = (26, 26, 96)
    board = rich_soup(rng, shape)
    goals = rich_soup(rng, shape, density=0.2)
    init = rich_soup(rng, shape)
    baseline = rng.randint(-5, 6, shape[-1]).astype(np.int32)
    min_perf = np.where(rng.random(shape[-1]) < 0.3, -1.0,
                        rng.random(shape[-1])).astype(np.float32)
    jb, jg, ji = jnp.asarray(board), jnp.asarray(goals), jnp.asarray(init)
    tb, tg, ti = t(board), t(goals), t(init)
    assert_equal(tscoring.current_points(tb, tg),
                 jscoring.current_points(jb, jg))
    assert_equal(tscoring.performance_score(tb, tg),
                 jscoring.performance_score(jb, jg))
    assert_equal(tscoring.possible_score(tg), jscoring.possible_score(jg))
    comp, poss = tscoring.performance_ratio(tb, tg, t(baseline))
    jcomp, jposs = jscoring.performance_ratio(jb, jg, jnp.asarray(baseline))
    assert_equal(comp, jcomp)
    assert_equal(poss, jposs)
    assert_equal(tscoring.can_exit(comp, poss, t(min_perf)),
                 jscoring.can_exit(jcomp, jposs, jnp.asarray(min_perf)))
    assert_equal(tscoring.side_effect_count(tb, ti, tg),
                 jscoring.side_effect_count(jb, ji, jg))
    nf_b, nf_g = np.moveaxis(board, -1, 0), np.moveaxis(goals, -1, 0)
    for name in ("current_points_np", "performance_score_np"):
        np.testing.assert_array_equal(getattr(tscoring, name)(nf_b, nf_g),
                                      getattr(jscoring, name)(nf_b, nf_g))
    np.testing.assert_array_equal(tscoring.possible_score_np(nf_g),
                                  jscoring.possible_score_np(nf_g))


@pytest.mark.parametrize("view", [(15, 15), (33, 33), (9, 31)])
@pytest.mark.parametrize("channels", [tuple(range(15)), None])
def test_observe_matches_jax(view, channels):
    rng = np.random.RandomState(view[0] + view[1])
    shape = (26, 26, 64)
    board = rich_soup(rng, shape)
    goals = rich_soup(rng, shape, density=0.3)
    board[rng.random(shape) < 0.004] = C.LEVEL_EXIT
    ar = rng.randint(0, 26, shape[-1]).astype(np.int32)
    ac = rng.randint(0, 26, shape[-1]).astype(np.int32)
    er, ec, ev = (np.asarray(x) for x in find_exits(jnp.asarray(board), 3))
    args = (board, goals, ar, ac, er, ec, ev)
    want = jax.jit(partial(jobs.observe, view_shape=view,
                           output_channels=channels))(
        *(jnp.asarray(a) for a in args))
    got = tobs.observe(*(t(a) for a in args), view_shape=view,
                       output_channels=channels)
    assert got.dtype == (torch.uint8 if channels else torch.uint16)
    assert_equal(got, want)
