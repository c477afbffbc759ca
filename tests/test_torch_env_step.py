"""The plain version of the fused env-step core (kernels K1 and K2/K3)
against the TPU kernels run in interpret mode, bit for bit, on
append-still boards."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import safelife_tpu.cells as C
from safelife_torch.ops import env_step_kernels
from safelife_tpu.levels import loader as jloader
from safelife_tpu.ops import env_step_pallas, life_pallas

# The tensors here are small.  One thread keeps torch from leaving an
# OpenMP pool in the test process that slows the JAX tests run after it.
torch.set_num_threads(1)

B = 128
FRESH_KEYS = ("board", "goals", "init_board", "agent_row", "agent_col",
              "exit_row", "exit_col", "exit_valid", "exit_gcol",
              "min_performance", "perf_possible")


def _levels(bank, idx):
    """Per-env fields of bank levels ``idx``, as the env's fresh levels."""
    take = lambda x: np.asarray(x)[..., idx]  # noqa: E731
    init = take(bank.board)
    return dict(board=init.copy(), goals=take(bank.goals), init_board=init,
                agent_row=take(bank.agent_row), agent_col=take(bank.agent_col),
                exit_row=take(bank.exit_row), exit_col=take(bank.exit_col),
                exit_valid=take(bank.exit_valid),
                exit_gcol=take(bank.exit_gcol),
                min_performance=take(bank.min_performance),
                perf_possible=take(bank.possible0),
                baseline_score=take(bank.baseline_score))


def step_inputs(seed, time_limit, view):
    """fused_step keyword arguments (numpy) on append-still boards: live
    levels with an agent that has moved and random actions, game-over
    flags and exit gates, episode lengths straddling the time limit."""
    rng = np.random.RandomState(seed)
    bank = jloader.load_bank("benchmarks/v1.0/append-still")
    live = _levels(bank, rng.randint(0, bank.num_levels, B))
    fresh = _levels(bank, rng.randint(0, bank.num_levels, B))
    board = live["board"]
    # Open exits on some boards, and a few cells of life around.
    open_ = rng.random(B) < 0.5
    board[(board & C.EXIT) != 0] = C.LEVEL_EXIT
    ex = (live["init_board"] & C.EXIT) != 0
    board[ex & open_[None, None, :]] |= np.uint16(C.COLOR_R)
    board |= (rng.random(board.shape) < 0.1).astype(np.uint16) * np.uint16(
        C.LIFE) * (board == 0)
    kw = dict(
        board=board, goals=live["goals"], init_board=live["init_board"],
        action=rng.randint(0, 9, B).astype(np.int32),
        agent_row=live["agent_row"], agent_col=live["agent_col"],
        orientation=rng.randint(0, 4, B).astype(np.int32),
        game_over=rng.random(B) < 0.1, can_exit0=open_,
        baseline_score=live["baseline_score"],
        spawn_prob=np.zeros(B, np.float32),
        min_performance=live["min_performance"],
        perf_possible=live["perf_possible"],
        exit_row=live["exit_row"], exit_col=live["exit_col"],
        exit_valid=live["exit_valid"], exit_gcol=live["exit_gcol"])
    static = dict(static_goals=True, spawnless=True, time_limit=time_limit,
                  obs_view=view)
    if time_limit:
        kw["episode_length"] = rng.randint(
            time_limit - 3, time_limit + 1, B).astype(np.int32)
        kw["fresh"] = {k: fresh[k] for k in FRESH_KEYS}
    return kw, static


def _convert(kw, fn):
    return {k: ({kk: fn(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else fn(v)) for k, v in kw.items()}


@pytest.mark.parametrize("time_limit,view", [
    (0, None), (6, None), (6, (15, 15)), (6, (33, 33))])
def test_fused_step_matches_pallas_interpret(time_limit, view):
    kw, static = step_inputs(7 + time_limit + (view or (0,))[0], time_limit,
                             view)
    want = env_step_pallas.fused_step(
        **_convert(kw, jnp.asarray), **static, seed=3,
        interpret=life_pallas.interpret_params())
    got = env_step_kernels.fused_step(
        **_convert(kw, lambda x: torch.as_tensor(np.array(x))), **static,
        seed=3)
    assert len(got) == len(want) == 11 + (time_limit > 0) + (view is not None)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"output {i}")
    if time_limit:
        done = ((kw["episode_length"] + 1 > time_limit) | kw["game_over"]
                | np.asarray(got[5]))
        assert 0 < done.sum() < B


@pytest.mark.parametrize("flags,item", [
    (dict(static_goals=True), "K5"),
    (dict(spawnless=True, simple_goals=True), "K6"),
    (dict(spawn_simple_goals=True), "K7"),
    (dict(), "K8")])
def test_unported_rules_raise(flags, item):
    kw, _ = step_inputs(1, 0, None)
    with pytest.raises(NotImplementedError, match=item):
        env_step_kernels.fused_step(
            **_convert(kw, lambda x: torch.as_tensor(np.array(x))), **flags)
