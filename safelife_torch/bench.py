"""The port's benchmark: lockstep SafeLife env-steps/s on one CUDA card
(the counterpart of the repo's ``bench.py`` for the JAX package).

    python -m safelife_torch.bench

It times the full environment step (agent action, the CA advance of the
board and of the goal board, scoring, exit recolouring, the side-effect
count, auto-reset from the level bank, and the observation, consumed every
step) for B lockstep environments on three banks: append-still (the
headline), append-dynamic (the goal board is not a CA fixed point, the
``*-dynamic`` training regime) and a synthetic stress bank with spawners
on the board and on the goal board (both CA advances run the full rule
with a live spawn draw).  Fresh levels are drawn every ``ROLLOUT`` steps.

Before timing, the device integrity check (``utils/integrity.py``: the
card's ops against host goldens), then a selftest on the card; a failure
exits nonzero:

1. kernel rollouts against plain rollouts, 12 steps at B = 256 with
   auto-reset on and off, on append-still and on a synthetic bank whose
   goal boards hold spawners at ``spawn_prob`` 0 (the stress bank's rule,
   deterministic);
2. the Philox spawn draw through K8 (``advance_both``): the same seed
   gives the same output, different seeds differ, and the spawn rate is
   within 5 sigma;
3. the rules the advance kernel inlines, standalone (K5, K6, K7), against
   their plain versions with Philox spawn fields at ``spawn_prob`` 0.3.

Prints ONE JSON line on stdout::

    {"metric": "env_steps_per_sec", "value": N, "unit": "steps/s",
     "vs_baseline": N / 10e6}

then '#' lines on stderr: the device, the dynamic-goals and the stress
figures.  Environment: ``BENCH_BATCH`` (65536), ``BENCH_STEPS`` (160),
``BENCH_REPEATS`` (5; the best run counts), ``BENCH_SELFTEST`` (0 skips).
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from . import cells as C
from . import bits16, resolve_device
from .env.env import BatchedSafeLifeEnv, EnvConfig
from .levels import loader, synth
from .ops import _build, life_kernels, rng
from .ops import obs as obs_ops
from .utils import integrity

BASELINE_STEPS_PER_S = 10e6  # the north star of BASELINE.md
BATCH = int(os.environ.get("BENCH_BATCH", 65536))
STEPS = int(os.environ.get("BENCH_STEPS", 160))
REPEATS = int(os.environ.get("BENCH_REPEATS", 5))
ROLLOUT = 20  # fresh-level cadence == PPO steps_per_env
VIEW = (15, 15)
CONFIGS = ("append-still", "append-dynamic", "stress")
SPAWN_P = 0.3  # the selftest's spawn rate, the v1.0 suites' own


def load_banks(device):
    """The three timed banks, by name, on ``device``."""
    banks = {
        "append-still": loader.load_bank("benchmarks/v1.0/append-still",
                                         device=device),
        "append-dynamic": loader.load_bank("benchmarks/v1.0/append-dynamic",
                                           device=device),
        # Spawners on the board AND on the goal board: no shipped suite
        # puts spawners in goals.
        "stress": synth.synth_bank(64, h=26, w=26, spawners=True,
                                   dynamic_goals=True, device=device),
    }
    assert banks["append-still"].static_goals
    assert not banks["append-dynamic"].static_goals
    stress = banks["stress"]
    assert not stress.static_goals and not stress.simple_goals
    return banks


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# --------------------------------------------------------------------------
# Selftest.
# --------------------------------------------------------------------------

def _flatten(prefix, obj):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_flatten(f"{prefix}{f.name}.", v))
        elif v is not None:
            out[prefix + f.name] = v
    return out


def _rollout(env, bank, actions):
    dev = bank.device
    b = actions.shape[1]
    lanes = torch.arange(b, device=dev)
    state = env.reset_to_levels(bank, lanes % bank.num_levels)
    fresh = env.fresh_levels(bank, (lanes * 7 + 3) % bank.num_levels)
    trace = []
    for t in range(actions.shape[0]):
        state, ts = env.step(state, bank, actions[t], fresh_levels=fresh)
        trace.append({**_flatten("state.", state), **_flatten("ts.", ts)})
    return trace


def compare_rollouts(bank, actions):
    """Kernel rollouts equal plain rollouts on ``bank``, every leaf at
    every step, with auto-reset on and off."""
    dev = bank.device
    for cfg in (dict(time_limit=6, auto_reset=True),
                dict(time_limit=20, auto_reset=False)):
        kern = BatchedSafeLifeEnv(EnvConfig(**cfg), device=dev)
        plain = BatchedSafeLifeEnv(EnvConfig(use_kernels=False, **cfg),
                                   device=dev)
        assert kern.uses_kernels() == (dev.type == "cuda")
        assert not plain.uses_kernels()
        for t, (got, want) in enumerate(zip(_rollout(kern, bank, actions),
                                            _rollout(plain, bank, actions))):
            assert got.keys() == want.keys()
            keep = ~want["ts.done"]
            for name in want:
                g, w = got[name], want[name]
                if cfg["auto_reset"] and name in (
                        "ts.state_before_reset.board",
                        "ts.state_before_reset.goals"):
                    # The kernel path folds the reset into these two.
                    g, w = (x.to(torch.int32)[..., keep] for x in (g, w))
                assert g.dtype == w.dtype and torch.equal(g, w), (
                    f"kernel != plain at step {t}, field {name}, cfg {cfg}")


def check_rollouts(still_bank, batch=256, steps=12):
    """Kernel rollouts against plain rollouts on append-still and on a
    bank whose goal boards hold spawners at spawn_prob 0."""
    dev = still_bank.device
    gs_bank = synth.synth_bank(8, h=26, w=26, spawners=False,
                               dynamic_goals=True, device=dev)
    assert gs_bank.spawn_simple_goals and not gs_bank.simple_goals
    assert float(gs_bank.spawn_prob.max()) == 0.0
    actions = torch.as_tensor(
        np.random.RandomState(9).randint(0, 9, (steps, batch)), device=dev)
    for bank in (still_bank, gs_bank):
        compare_rollouts(bank, actions)
    return steps


def check_prng(device, batch=256):
    """The paired Philox draw through K8 (``bench.py:158-183``): seed
    determinism, seed sensitivity and the spawn rate within 5 sigma."""
    h = w = 8
    p = SPAWN_P
    board = torch.zeros((h, w, batch), dtype=torch.int16, device=device)
    board[3, 3, :] = C.SPAWNER
    board = board.view(torch.uint16)
    goals = torch.zeros_like(board)
    probs = torch.full((batch,), p, dtype=torch.float32, device=device)
    outs = {}
    for seed in (0, 1, 2, 3, 4, 0):
        out, _ = life_kernels.advance_both(board, goals, probs, seed)
        outs.setdefault(seed, []).append(out.view(torch.int16).to(torch.int32))
    assert torch.equal(outs[0][0], outs[0][1]), "same seed must reproduce"
    assert not torch.equal(outs[0][0], outs[1][0]), "seeds must differ"
    spawned = total = 0
    for out, *_ in outs.values():
        neigh = out[2:5, 2:5, :]
        born = (neigh & 1) != 0  # the spawner itself is dead and frozen
        assert not born[1, 1].any()
        assert (neigh[born] == (C.ALIVE | C.DESTRUCTIBLE)).all()
        spawned += int(born.sum())
        total += 8 * batch
    rate = spawned / total
    sigma = (p * (1 - p) / total) ** 0.5
    assert abs(rate - p) < 5 * sigma, f"spawn rate {rate:.4f} vs p={p}"
    return rate


def check_rules(banks, batch=256, steps=4):
    """K5, K6 and K7 against their plain versions on the timed banks'
    boards, with Philox spawn fields at ``spawn_prob`` 0.3."""
    still, dyn, stress = (banks[k] for k in CONFIGS)
    dev = stress.device

    def levels(bank):
        return bank.take(torch.arange(batch, device=dev) % bank.num_levels)

    probs = torch.full((batch,), SPAWN_P, dtype=torch.float32, device=dev)
    boards = (levels(still).board, levels(stress).board)
    goals = levels(dyn).goals
    pair = (levels(stress).board, levels(stress).goals)
    spawned = 0
    for t in range(steps):
        seed = torch.tensor([t], dtype=torch.int32, device=dev)
        field = rng.spawn_field24(seed, probs, goals.shape)
        fb, fg = rng.spawn_field_pair(seed, probs, goals.shape)
        new = []
        for board in boards:
            got = life_kernels.advance_with_field(board, field)
            assert torch.equal(got, life_kernels.advance_with_field_plain(
                board, field)), f"K5 != plain at step {t}"
            new.append(got)
        boards = tuple(new)
        got = life_kernels.advance_simple(goals)
        assert torch.equal(got, life_kernels.advance_simple_plain(goals)), (
            f"K6 != plain at step {t}")
        goals = got
        got = life_kernels.advance_pair_spawnsimple_with_fields(
            pair[0], fb, pair[1], fg)
        want = life_kernels.advance_pair_spawnsimple_with_fields_plain(
            pair[0], fb, pair[1], fg)
        assert all(map(torch.equal, got, want)), f"K7 != plain at step {t}"
        no = torch.zeros_like(fb)
        quiet = life_kernels.advance_pair_spawnsimple_with_fields_plain(
            pair[0], no, pair[1], no)
        spawned += sum(int((bits16(g) != bits16(q)).sum())
                       for g, q in zip(got, quiet))
        pair = got
    assert spawned > 0, "no spawn fired at p = 0.3"
    return spawned


def selftest(banks, batch=256):
    """Run the three checks; raises AssertionError on the first failure."""
    steps = check_rollouts(banks["append-still"], batch)
    rate = check_prng(banks["append-still"].device, batch)
    check_rules(banks, batch)
    print(f"# selftest OK: kernels == plain over {steps} steps x {batch} "
          f"envs; spawn rate {rate:.4f} (p={SPAWN_P}); K5-K7 == plain at "
          f"p={SPAWN_P}",
          file=sys.stderr)


# --------------------------------------------------------------------------
# Timing.
# --------------------------------------------------------------------------

def run_steps(env, bank, state, generator, steps):
    """``steps`` env steps (fresh levels every ``ROLLOUT``), consuming the
    observation and the reward of every step as a real actor would."""
    dev, b = state.device, state.batch_size
    total = torch.zeros((), dtype=torch.float64, device=dev)
    for _ in range(steps // ROLLOUT):
        fresh = env.sample_fresh_levels(bank, b, generator)
        for _ in range(ROLLOUT):
            action = torch.randint(0, 9, (b,), generator=generator,
                                   device=dev, dtype=torch.int32)
            state, ts = env.step(state, bank, action, generator,
                                 fresh_levels=fresh)
            total += obs_ops.obs_sum(ts.obs) + ts.reward.sum()
    return state, total


def time_env(bank, batch=BATCH, steps=STEPS, repeats=REPEATS):
    """Env-steps/s of the best of ``repeats`` runs of ``steps`` steps
    (host clock between synchronisations); returns it with the final
    state."""
    dev = bank.device
    env = BatchedSafeLifeEnv(EnvConfig(view_shape=VIEW), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = env.reset_all(bank, batch, gen)
    best = float("inf")
    for _ in range(repeats):
        _sync(dev)
        t0 = time.perf_counter()
        state, total = run_steps(env, bank, state, gen, steps)
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
        assert torch.isfinite(total), "non-finite observation sum"
    return batch * (steps // ROLLOUT) * ROLLOUT / best, state


def main():
    dev = resolve_device()  # the card; raises when there is none
    _build.build_all()
    banks = load_banks(dev)
    if os.environ.get("BENCH_SELFTEST", "1") != "0":
        # Host goldens first (a card that computes wrong values at full
        # speed), then the kernels against their plain versions.
        integrity.check_device_integrity(dev)
        selftest(banks)
    rates = {}
    for name in CONFIGS:
        rates[name], state = time_env(banks[name])
        if name == "append-still":
            print(json.dumps({
                "metric": "env_steps_per_sec",
                "value": round(rates[name]),
                "unit": "steps/s",
                "vs_baseline": round(rates[name] / BASELINE_STEPS_PER_S, 4),
            }), flush=True)
            print(f"# device={torch.cuda.get_device_name(dev)} "
                  f"batch={BATCH} steps={STEPS} "
                  f"global_steps={int(state.num_steps)}", file=sys.stderr)
    print(f"# dynamic_goals_env_steps_per_sec={round(rates['append-dynamic'])}"
          f" ({rates['append-dynamic'] / BASELINE_STEPS_PER_S:.4f}x baseline)"
          f" [append-dynamic suite]", file=sys.stderr)
    print(f"# stress_goalspawner_env_steps_per_sec="
          f"{round(rates['stress'])} "
          f"({rates['stress'] / BASELINE_STEPS_PER_S:.4f}x baseline)",
          file=sys.stderr)


if __name__ == "__main__":
    main()
