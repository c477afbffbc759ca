"""Decompose the stress (goal-spawner) step on the card (the port of
``scripts/stress_micro.py``).

    python -m safelife_torch.scripts.stress_micro

At the bench's batch (65536), on the synthetic stress bank (spawners on
the board and on the goal board, so both CA advances run the full rule
with a live spawn draw), chained:

  a) the full env step;
  b) ``advance_both`` alone (K8: the general pair rule with the paired
     Philox draw), spawn_prob 0.3;
  c) ``advance_both`` at spawn_prob 0 (the draws are made, none fires),
     which isolates the cost of the spawns themselves;
  d) the same step on append-dynamic (simple goals) and append-still.
"""

import torch

from .. import bits16, resolve_device
from ..env.env import BatchedSafeLifeEnv, EnvConfig
from ..levels import loader, synth
from ..ops import life_kernels
from . import env_loop, timeit

B = 65536
STEPS = 64
ROLLOUT = 16


def advance_loop(spawn_prob, device):
    """K8 chained over STEPS steps, step i drawing with seed i."""
    probs = torch.full((B,), spawn_prob, dtype=torch.float32, device=device)
    seeds = torch.arange(STEPS, dtype=torch.int32, device=device)

    def run(board, goals):
        total = torch.zeros((), dtype=torch.int64, device=device)
        for i in range(STEPS):
            board, goals = life_kernels.advance_both(board, goals, probs,
                                                     seeds[i:i + 1])
            total += bits16(board)[0, 0, 0].to(torch.int32)
        return board, goals, total
    return run


def main(device=None):
    dev = resolve_device(device)
    stress = synth.synth_bank(64, h=26, w=26, spawners=True,
                              dynamic_goals=True, device=dev)
    rows = {}
    env = BatchedSafeLifeEnv(EnvConfig(view_shape=(15, 15)), device=dev)
    rows["stress step default"] = timeit(
        "stress step default", STEPS, dev,
        *env_loop(env, stress, B, STEPS, ROLLOUT), batch=B)

    lv = stress.take(torch.arange(B, device=dev) % stress.num_levels)
    rows["advance_both p=0.3 (2 spawn draws)"] = timeit(
        "advance_both p=0.3 (2 spawn draws)", STEPS, dev,
        advance_loop(0.3, dev), lv.board, lv.goals, batch=B)
    rows["advance_both p=0.0 (draws, never fire)"] = timeit(
        "advance_both p=0.0 (draws, never fire)", STEPS, dev,
        advance_loop(0.0, dev), lv.board, lv.goals, batch=B)

    for suite in ("append-dynamic", "append-still"):
        bank = loader.load_bank(f"benchmarks/v1.0/{suite}", device=dev)
        name = f"{suite} step default"
        rows[name] = timeit(name, STEPS, dev,
                            *env_loop(env, bank, B, STEPS, ROLLOUT), batch=B)
    return rows


if __name__ == "__main__":
    main()
