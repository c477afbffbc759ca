"""Chained-latency decomposition of the fused env step on the card (the
port of ``scripts/stepbench.py``).

    python -m safelife_torch.scripts.stepbench

Every timing feeds each iteration's output back into the next and
consumes all outputs, so no launch is timed apart from the work it feeds.
Rows, at B = 16384 on append-still unless named: the full step and three
cut-down configurations; K1 alone (S1: the board fed back, action 2,
MOVE RIGHT, on every environment); K1 + K3 through ``fused_step`` with
``time_limit=0``; the observation unpack alone; the full step on
append-dynamic and on the synthetic goal-spawner bank.
"""

import torch

from .. import resolve_device
from ..env.env import BatchedSafeLifeEnv, EnvConfig
from ..levels import loader, synth
from ..ops import env_step_kernels as esk
from ..ops import obs as obs_ops
from . import add_u16, env_loop, timeit

B = 16384
STEPS = 60  # a multiple of ROLLOUT
ROLLOUT = 20


def main(device=None):
    dev = resolve_device(device)
    bank = loader.load_bank("benchmarks/v1.0/append-still", device=dev)
    print(f"bank: static_goals={bank.static_goals} spawnless={bank.spawnless}"
          f" B={B}")
    rows = {}
    for name, cfg in [
        ("full step (obs, reset, fresh)",
         EnvConfig(view_shape=(15, 15))),
        ("step packed-obs (output_channels=None)",
         EnvConfig(view_shape=(15, 15), output_channels=None)),
        ("step no obs",
         EnvConfig(compute_obs=False)),
        ("step no obs no reset",
         EnvConfig(compute_obs=False, auto_reset=False)),
    ]:
        env = BatchedSafeLifeEnv(cfg, device=dev)
        rows[name] = timeit(name, STEPS, dev,
                            *env_loop(env, bank, B, STEPS, ROLLOUT), batch=B)

    # --- raw kernels, chained ------------------------------------------
    lv = bank.take(torch.arange(B, device=dev) % bank.num_levels)

    # K1 alone, the board fed back.
    si = torch.zeros((8, B), dtype=torch.int32, device=dev)
    si[0] = 2

    def action_only(board):
        total = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(STEPS):
            board, act_i = esk.apply_action(si, board)
            total += act_i[0].sum()
        return board, total
    rows["action kernel only"] = timeit("action kernel only", STEPS, dev,
                                        action_only, lv.board, batch=B)

    # K1 + K3: fused_step without the reset fold.
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    zf = torch.zeros(B, dtype=torch.float32, device=dev)

    def fused_noreset(board):
        total = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(STEPS):
            out = esk.fused_step(
                board, lv.goals, lv.board, zeros, lv.agent_row,
                lv.agent_col, zeros, zeros, zeros, lv.baseline_score, zf, zf,
                3, static_goals=bank.static_goals, spawnless=bank.spawnless,
                simple_goals=bank.simple_goals,
                spawn_simple_goals=bank.spawn_simple_goals,
                perf_possible=lv.possible0 if bank.static_goals else None)
            board = out[0]
            total += out[6].sum()
        return board, total
    rows["action+advance kernels (no fold)"] = timeit(
        "action+advance kernels (no fold)", STEPS, dev, fused_noreset,
        lv.board, batch=B)

    # The observation unpack alone, chained.
    channels = tuple(range(15))

    def unpack_loop(view):
        total = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(STEPS):
            u = obs_ops.unpack_channels(view, channels)
            view = add_u16(view, u.sum((1, 2, 3), dtype=torch.int32))
            total += u.sum(dtype=torch.int32)
        return view, total
    rows["obs unpack_channels (transpose+bits)"] = timeit(
        "obs unpack_channels (transpose+bits)", STEPS, dev, unpack_loop,
        torch.ones((15, 15, B), dtype=torch.uint16, device=dev), batch=B)

    # Dynamic goals.
    env = BatchedSafeLifeEnv(EnvConfig(view_shape=(15, 15)), device=dev)
    dyn_real = loader.load_bank("benchmarks/v1.0/append-dynamic", device=dev)
    print(f"append-dynamic: simple_goals={dyn_real.simple_goals} "
          f"spawnless={dyn_real.spawnless}")
    rows["full step append-dynamic suite"] = timeit(
        "full step append-dynamic suite", STEPS, dev,
        *env_loop(env, dyn_real, B, STEPS, ROLLOUT), batch=B)
    dyn = synth.synth_bank(64, h=26, w=26, spawners=True, dynamic_goals=True,
                           device=dev)
    rows["full step synth dyn (goal spawner)"] = timeit(
        "full step synth dyn (goal spawner)", STEPS, dev,
        *env_loop(env, dyn, B, STEPS, ROLLOUT), batch=B)
    return rows


if __name__ == "__main__":
    main()
