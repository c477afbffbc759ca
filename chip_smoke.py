"""Drive the PyTorch port of SafeLife on one CUDA card and hold its
hand-written kernels to their plain PyTorch versions.

    python3 chip_smoke.py

Phases, each an assertion that ends the run on failure:

1. build every kernel from ``safelife_torch/csrc`` (one ``nvcc`` each, in
   parallel);
2. print the card's name and power limit (``nvidia-smi``);
3. each kernel against its plain version on the card, bit for bit: K4 on
   spawnless soups; K5-K8 on soups with spawners at spawn_prob 0.3; K1 on
   random states and all nine actions; K2 (fold and view) and K3 (no
   reset) along rollouts with resets on append-still, prune-still,
   append-dynamic, append-spawn, navigation, the goal-spawner stress bank
   and a general-pair bank, which take all five CA rules, spawn draws at
   the banks' rates included; then the Philox draws (24-bit and paired):
   same seed same field, seeds differ, rate within 5 sigma, edges exact;
4. 12-step rollouts through the kernels against the plain env path;
5. the main path, ``safelife_torch.bench``: its selftest, then its timing
   of append-still, append-dynamic and the stress bank at B = 65536 for 160
   steps each (fresh levels every 20 steps, the observation consumed every
   step); then the evaluation path (no auto-reset) for 20 steps, and a few
   steps of each v1.0 suite and of the general-pair bank with and without
   auto-reset, with the launch counts read around it all;
6. each kernel's time at the main path's shapes beside its bound and its
   plain version's time (K2 and K3 under each rule), and a profile of 20
   steps of each configuration (device time by kernel, idle share);
7. one JSON line listing the kernels, and last the result line.

Exits nonzero, printing no result, when no CUDA device is present.
"""

import collections
import json
import subprocess
import sys
import time

import numpy as np
import torch

from safelife_torch import bench, bits16
from safelife_torch import cells as C
from safelife_torch.env.env import BatchedSafeLifeEnv, EnvConfig
from safelife_torch.levels import loader, synth
from safelife_torch.ops import _build, env_step_kernels as esk, life_kernels
from safelife_torch.ops import rng
from safelife_torch.ops.life import nb_sum

MAIN_BATCH = 65536
MAIN_STEPS = 160
EVAL_STEPS = 20
SUITE_STEPS = 5
ROLLOUT = 20
VIEW = (15, 15)
SUITES = ("append-still", "prune-still", "prune-still-hard", "append-dynamic",
          "prune-dynamic", "append-spawn", "prune-spawn", "navigation")
# The bank each K2 rule is timed on.
RULE_BANKS = {"static_spawnless": "append-still", "static": "append-spawn",
              "simple": "append-dynamic", "spawn_simple": "stress",
              "general": "general"}
# 32-bit operations outside the tensor cores, H100 SXM data sheet.
PEAK_OPS = 67e12
# Integer operations per board cell, counted from the kernel sources (a
# lower bound: loads, stores and loop control are left out), and per
# Philox draw (ten rounds of two multiplies, two multiply-highs, three
# XORs and two key additions).
RULE_OPS = {"static_spawnless": 75, "static": 105, "simple": 115,
            "spawn_simple": 165, "general": 170}
OPS_PER_CELL = {
    "K1_action": 6, "K4_advance_spawnless": 40, "K5_advance_with_field": 70,
    "K6_advance_simple": 40, "K7_advance_pair_fields": 130,
    "K8_advance_both": 140,
    **{f"K2_advance_fold[{r}]": n for r, n in RULE_OPS.items()},
    # K3 skips the fold's selects.
    **{f"K3_advance_noreset[{r}]": n - 5 for r, n in RULE_OPS.items()}}
OPS_PER_DRAW = 90
STEP_SOURCE = "safelife_torch/csrc/env_step_kernels.cu"
LIFE_SOURCE = "safelife_torch/csrc/life_kernels.cu"
KERNELS = {
    "K1_action": (STEP_SOURCE, "safelife_tpu/ops/env_step_pallas.py:177"),
    **{f"K2_advance_fold[{rule}]": (
        STEP_SOURCE, "safelife_tpu/ops/env_step_pallas.py:250")
       for rule in esk.RULES},
    **{f"K3_advance_noreset[{rule}]": (
        STEP_SOURCE, "safelife_tpu/ops/env_step_pallas.py:250")
       for rule in esk.RULES},
    "K4_advance_spawnless": (LIFE_SOURCE,
                             "safelife_tpu/ops/life_pallas.py:489"),
    "K5_advance_with_field": (LIFE_SOURCE,
                              "safelife_tpu/ops/life_pallas.py:513"),
    "K6_advance_simple": (LIFE_SOURCE, "safelife_tpu/ops/life_pallas.py:432"),
    "K7_advance_pair_fields": (LIFE_SOURCE,
                               "safelife_tpu/ops/life_pallas.py:458"),
    "K8_advance_both": (LIFE_SOURCE, "safelife_tpu/ops/life_pallas.py:387"),
}


def memory_rate(name):
    """The card's memory bandwidth in bytes/s, from its data sheet."""
    if "H200" in name:
        return 4.8e12
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    return 3.35e12  # H100 SXM


def max_abs_err(got, want):
    """Largest absolute difference over matching tensors (0 = bit-equal)."""
    err = 0
    for g, w in zip(got, want):
        if g is None and w is None:
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape)
        err = max(err, (g.to(torch.float64) - w.to(torch.float64)).abs()
                  .max().item() if g.numel() else 0)
    return err


def assert_bit_equal(got, want, what):
    err = max_abs_err(got, want)
    assert err == 0, f"{what}: kernel differs from plain (max abs err {err})"
    return err


def soup(rng_, shape, flags, density=0.15):
    board = np.zeros(shape, np.uint16)
    for f in flags:
        board |= np.uint16(f) * (rng_.random(shape) < density).astype(
            np.uint16)
    return board


SPAWNLESS_FLAGS = (C.ALIVE, C.AGENT, C.PUSHABLE, C.DESTRUCTIBLE, C.FROZEN,
                   C.PRESERVING, C.INHIBITING, C.EXIT, C.COLOR_R, C.COLOR_G,
                   C.COLOR_B, C.PULLABLE)
# Certified simple goals (no PRESERVING, INHIBITING, SPAWNING or EXIT) and
# spawn-simple goals (SPAWNING allowed).
SIMPLE_FLAGS = (C.ALIVE, C.DESTRUCTIBLE, C.FROZEN, C.PUSHABLE, C.PULLABLE,
                C.COLOR_R, C.COLOR_G, C.COLOR_B)
SPAWN_SIMPLE_FLAGS = SIMPLE_FLAGS + (C.SPAWNING,)


def action_inputs(rng_, shape, dev):
    """A random board with an agent on every board, and si rows 0-5."""
    h, w, b = shape
    board = soup(rng_, shape, SPAWNLESS_FLAGS + (C.SPAWNING,))
    ar = rng_.randint(0, h, b)
    ac = rng_.randint(0, w, b)
    board[ar, ac, np.arange(b)] = C.PLAYER | C.COLOR_G
    rows = [np.arange(b) % 9, ar, ac, rng_.randint(0, 4, b),
            rng_.random(b) < 0.1, rng_.random(b) < 0.5]
    si = np.concatenate([np.stack(rows), np.zeros((3, b))]).astype(np.int32)
    return (torch.as_tensor(si, device=dev),
            torch.as_tensor(board, device=dev))


def load_bank(name, dev, num_levels=64):
    """A v1.0 suite, the stress bank or the general-pair bank."""
    if name == "stress":
        return synth.synth_bank(num_levels, spawners=True, dynamic_goals=True,
                                device=dev)
    if name == "general":
        return synth.general_bank(num_levels, device=dev)
    return loader.load_bank(f"benchmarks/v1.0/{name}", device=dev)


def rule_of(bank):
    return esk.pick_rule(bank.static_goals, bank.spawnless, bank.simple_goals,
                         bank.spawn_simple_goals)


def as_i32(board):
    return bits16(board).to(torch.int32)


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version.
# ---------------------------------------------------------------------------

def check_k4(dev):
    rng_ = np.random.RandomState(1)
    for shape, steps in (((26, 26, 4096), 6), ((7, 3, 300), 4)):
        board = torch.as_tensor(soup(rng_, shape, SPAWNLESS_FLAGS), device=dev)
        for step in range(steps):
            got = life_kernels.advance_spawnless(board)
            assert_bit_equal([got], [life_kernels.advance_spawnless_plain(
                board)], f"K4 {shape} step {step}")
            board = got
    print("K4 advance_spawnless == plain: (26,26,4096) x 6 steps, "
          "(7,3,300) x 4 steps")


def check_k5_k8(dev, p=0.3):
    """K5-K8 along 6-step soups with spawners, Philox fields at ``p``."""
    rng_ = np.random.RandomState(5)
    for shape in ((26, 26, 4096), (7, 3, 300)):
        full = SPAWNLESS_FLAGS + (C.SPAWNING,)
        b5 = torch.as_tensor(soup(rng_, shape, full), device=dev)
        g6 = torch.as_tensor(soup(rng_, shape, SIMPLE_FLAGS, 0.2), device=dev)
        b7 = torch.as_tensor(soup(rng_, shape, full), device=dev)
        g7 = torch.as_tensor(soup(rng_, shape, SPAWN_SIMPLE_FLAGS, 0.2),
                             device=dev)
        b8 = torch.as_tensor(soup(rng_, shape, full), device=dev)
        g8 = torch.as_tensor(soup(rng_, shape, full), device=dev)
        probs = torch.full((shape[2],), p, dtype=torch.float32, device=dev)
        fired = 0
        for step in range(6):
            seed = torch.tensor([100 + step], dtype=torch.int32, device=dev)
            f5 = rng.spawn_field24(seed, probs, shape)
            fb, fg = rng.spawn_field_pair(seed, probs, shape)
            got = life_kernels.advance_with_field(b5, f5)
            assert_bit_equal([got], [life_kernels.advance_with_field_plain(
                b5, f5)], f"K5 {shape} step {step}")
            fired += int((bits16(got) != bits16(
                life_kernels.advance_with_field_plain(
                    b5, torch.zeros_like(f5)))).sum())
            b5 = got
            got = life_kernels.advance_simple(g6)
            assert_bit_equal([got], [life_kernels.advance_simple_plain(g6)],
                             f"K6 {shape} step {step}")
            g6 = got
            got = life_kernels.advance_pair_spawnsimple_with_fields(
                b7, fb, g7, fg)
            assert_bit_equal(
                got, life_kernels.advance_pair_spawnsimple_with_fields_plain(
                    b7, fb, g7, fg), f"K7 {shape} step {step}")
            b7, g7 = got
            got = life_kernels.advance_both(b8, g8, probs, seed)
            assert_bit_equal(got, life_kernels.advance_both_plain(
                b8, g8, probs, seed), f"K8 {shape} step {step}")
            b8, g8 = got
        assert fired > 0, "no spawn fired in K5's run"
    print(f"K5-K8 == plain: (26,26,4096) and (7,3,300) soups x 6 steps, "
          f"spawn_prob {p} ({fired} cells of K5's last soup spawned)")


def check_k1(dev):
    rng_ = np.random.RandomState(2)
    for shape in ((26, 26, 4096), (3, 5, 1001)):
        for trial in range(3):
            si, board = action_inputs(rng_, shape, dev)
            assert_bit_equal(esk.apply_action(si, board),
                             esk.action_plain(si, board),
                             f"K1 {shape} trial {trial}")
    print("K1 action == plain: random states, all nine actions, "
          "(26,26,4096) and (3,5,1001)")


def check_k2_k3(dev):
    gen = torch.Generator(device=dev)
    rules = set()
    for suite in ("append-still", "prune-still", "append-dynamic",
                  "append-spawn", "navigation", "stress", "general"):
        bank = load_bank(suite, dev)
        rules.add(rule_of(bank))
        for b, cfg in ((4096, dict(time_limit=6, view_shape=VIEW)),
                       (4096, dict(time_limit=6, view_shape=(33, 33))),
                       (4096, dict(time_limit=6, compute_obs=False)),
                       (4096, dict(time_limit=6, auto_reset=False)),
                       (1001, dict(time_limit=6, view_shape=(9, 40)))):
            env = BatchedSafeLifeEnv(EnvConfig(**cfg), device=dev)
            gen.manual_seed(3)
            state = env.reset_all(bank, b, gen)
            fresh = env.sample_fresh_levels(bank, b, gen)
            resets = 0
            for step in range(10):
                action = torch.randint(0, 9, (b,), generator=gen,
                                       device=dev, dtype=torch.int32)
                kw = env.fused_inputs(
                    state, bank, action,
                    fresh[1] if env.config.auto_reset else None,
                    env.step_seed(gen))
                assert_bit_equal(esk.fused_step(**kw),
                                 esk.fused_step_plain(**kw),
                                 f"K1+K2/K3 {suite} {cfg} step {step}")
                state, ts = env.step(state, bank, action, gen,
                                     fresh_levels=fresh)
                resets += int(ts.done.sum())
            assert resets > 0
            print(f"K2/K3 advance == plain: {suite} ({rule_of(bank)} rule) "
                  f"B={b} {cfg}, 10 steps, {resets} resets")
    assert rules == set(esk.RULES), rules


def check_philox(dev, p=0.3):
    """The plain draws on the card (the kernels equal them bit for bit):
    determinism, seed sensitivity, the rate within 5 sigma, exact edges;
    then the paired draw through K8 as the bench's selftest runs it."""
    shape = (8, 8, 256)
    probs = torch.full((shape[2],), p, dtype=torch.float32, device=dev)

    def seed(s):
        return torch.tensor([s], dtype=torch.int32, device=dev)

    draws = {"24-bit": lambda s, q: (rng.spawn_field24(seed(s), q, shape),),
             "pair": lambda s, q: rng.spawn_field_pair(seed(s), q, shape)}
    for name, draw in draws.items():
        a, b, c = draw(0, probs), draw(0, probs), draw(1, probs)
        assert all(map(torch.equal, a, b)), f"{name}: same seed must repeat"
        assert not any(map(torch.equal, a, c)), f"{name}: seeds must differ"
        if name == "pair":
            assert not torch.equal(a[0], a[1]), "pair: halves must differ"
        total = a[0].numel()
        sigma = (p * (1 - p) / total) ** 0.5
        for field in a:
            rate = field.float().mean().item()
            assert abs(rate - p) < 5 * sigma, f"{name}: rate {rate} vs {p}"
        for q, want in ((0.0, False), (1.0, True)):
            edge = draw(2, torch.full_like(probs, q))
            assert all(bool((f == want).all()) for f in edge), (name, q)
        print(f"Philox {name} draw: same seed same field, seeds differ, "
              f"rate {a[0].float().mean().item():.4f} (p={p}, 5 sigma = "
              f"{5 * sigma:.4f}) over {total} cells; p=0 never, p=1 always")
    rate = bench.check_prng(dev)
    print(f"Philox paired draw through K8: spawn rate {rate:.4f} (p={p})")


# ---------------------------------------------------------------------------
# Phase 4: kernel rollout against the plain rollout.
# ---------------------------------------------------------------------------

def check_rollouts(dev):
    actions = torch.as_tensor(
        np.random.RandomState(9).randint(0, 9, (12, 256)), device=dev)
    # Spawnless banks: the plain env's spawn fields never fire there.
    for suite in ("append-still", "prune-still", "append-dynamic"):
        bench.compare_rollouts(load_bank(suite, dev), actions)
        print(f"rollout kernels == plain: {suite} B=256, 12 steps, "
              "auto-reset on and off")


# ---------------------------------------------------------------------------
# Phase 5: the main path, the evaluation path and every suite.
# ---------------------------------------------------------------------------

def counted(fn):
    """Run ``fn`` and return its result with the launches it made."""
    before = collections.Counter(_build.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    return out, dict(collections.Counter(_build.LAUNCHES) - before)


def main_path(dev):
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    banks = bench.load_banks(dev)
    bench.selftest(banks)
    print(f"bench selftest passed in {time.perf_counter() - t0:.1f} s "
          "(bank loads included)")
    results = {}
    for name in bench.CONFIGS:
        bank = banks[name]
        rule = rule_of(bank)
        (rate, state), launches = counted(lambda: bench.time_env(
            bank, MAIN_BATCH, MAIN_STEPS, repeats=1))
        assert launches.get("K1_action") == MAIN_STEPS, launches
        assert launches.get(f"K2_advance_fold[{rule}]") == MAIN_STEPS, (
            launches)
        assert int(state.num_steps) > 0
        assert int(state.episodes_started) >= MAIN_BATCH
        results[name] = (rate, state)
        print(f"main path: {name} ({rule} rule) B={MAIN_BATCH} view={VIEW} "
              f"{MAIN_STEPS} steps: {rate:.0f} env-steps/s "
              f"({MAIN_BATCH / rate * 1e3:.3f} ms/step); launches "
              f"{launches}; episodes completed "
              f"{int(state.episodes_completed)}")

    eval_env = BatchedSafeLifeEnv(EnvConfig(
        view_shape=VIEW, auto_reset=False, sequential_levels=True),
        device=dev)
    still = banks["append-still"]

    def evaluate():
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        state = eval_env.reset_all(still, MAIN_BATCH)
        for _ in range(EVAL_STEPS):
            action = torch.randint(0, 9, (MAIN_BATCH,), generator=gen,
                                   device=dev, dtype=torch.int32)
            state, ts = eval_env.step(state, still, action, gen)
            assert ts.obs.shape == (MAIN_BATCH, *VIEW, 15)

    _, eval_launches = counted(evaluate)
    assert eval_launches.get("K3_advance_noreset[static_spawnless]") == (
        EVAL_STEPS), eval_launches
    print(f"evaluation path (no auto-reset): B={MAIN_BATCH} {EVAL_STEPS} "
          f"steps; launches {eval_launches}")

    for name in SUITES + ("general",):
        bank = load_bank(name, dev)
        rule = rule_of(bank)
        for auto_reset, kernel in ((True, "K2_advance_fold"),
                                   (False, "K3_advance_noreset")):
            env = BatchedSafeLifeEnv(EnvConfig(
                view_shape=VIEW, auto_reset=auto_reset), device=dev)
            _, launches = counted(lambda: suite_steps(env, bank, dev))
            assert launches.get("K1_action") == SUITE_STEPS, launches
            assert launches.get(f"{kernel}[{rule}]") == SUITE_STEPS, launches
        print(f"suite {name}: {SUITE_STEPS} steps at B=4096 through K1 and "
              f"K2, and through K1 and K3 ({rule} rule, draw "
              f"{esk.pick_draw(rule, bank.spawnless)})")
    launches = dict(_build.LAUNCHES)
    for name in KERNELS:
        assert launches.get(name, 0) > 0, (name, launches)
    print(f"launches on the main path: {launches}")
    return banks, results, launches


def suite_steps(env, bank, dev, b=4096):
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    state = env.reset_all(bank, b, gen)
    fresh = env.sample_fresh_levels(bank, b, gen)
    for _ in range(SUITE_STEPS):
        action = torch.randint(0, 9, (b,), generator=gen, device=dev,
                               dtype=torch.int32)
        state, ts = env.step(state, bank, action, gen, fresh_levels=fresh)
        assert torch.isfinite(ts.reward).all()
        assert int(ts.obs.max()) <= 1


# ---------------------------------------------------------------------------
# Phase 6: kernel timings at the main path's shapes.
# ---------------------------------------------------------------------------

def time_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def draw_cells(*boards):
    """Cells where a spawn draw is read: dead, not frozen, a spawner in the
    3x3 neighbourhood (an upper bound on the draws the rules make)."""
    n = 0
    for board in boards:
        x = as_i32(board)
        near = nb_sum((x >> C.SPAWNING_BIT) & 1) != 0
        n += int((near & ((x & (C.ALIVE | C.FROZEN)) == 0)).sum())
    return n


def step_inputs(bank, dev, seed=4):
    """A state of the main path's width one step in, the step's kernel
    arguments (fold and no reset) and K1's outputs."""
    env = BatchedSafeLifeEnv(EnvConfig(view_shape=VIEW), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = env.reset_all(bank, MAIN_BATCH, gen)
    fresh = env.sample_fresh_levels(bank, MAIN_BATCH, gen)
    action = torch.randint(0, 9, (MAIN_BATCH,), generator=gen, device=dev,
                           dtype=torch.int32)
    state, _ = env.step(state, bank, action, gen, fresh_levels=fresh)
    action = torch.randint(0, 9, (MAIN_BATCH,), generator=gen, device=dev,
                           dtype=torch.int32)
    step_seed = env.step_seed(gen)
    fold = esk.kernel_args(**env.fused_inputs(state, bank, action, fresh[1],
                                              step_seed))
    noreset = esk.kernel_args(**dict(
        env.fused_inputs(state, bank, action, seed=step_seed),
        time_limit=0, obs_view=None))
    board1, act_i = esk.apply_action(fold["si"], fold["board"])
    return fold, noreset, board1, act_i


def kernel_timings(banks, dev, rate):
    """{kernel: (max_abs_err, ms, plain_ms, bound_ms, bound_by)}."""
    runs = {}

    def adv(args, fn, board1, act_i):
        return lambda: fn(args["si"], args["sf"], act_i, args["obs_i"],
                          board1, args["goals"], args["init_board"],
                          args["fresh"], args["time_limit"], args["obs_view"],
                          args["remove_white_goals"], args["rule"],
                          args["draw"], args["seed"])

    for rule, name in RULE_BANKS.items():
        bank = banks[name] if name in banks else load_bank(name, dev)
        fold, noreset, board1, act_i = step_inputs(bank, dev)
        assert fold["rule"] == rule, (rule, fold["rule"])
        si = fold["si"]
        done = ((si[7] + 1 > fold["time_limit"]) | (si[4] != 0)
                | (act_i[3] != 0))
        h, w, b = board1.shape
        out = adv(fold, esk.advance, board1, act_i)()
        draws = draw_cells(board1) if fold["draw"] != "none" else 0
        if fold["draw"] == "pair":
            draws += draw_cells(fold["goals"])
        runs[f"K2_advance_fold[{rule}]"] = (
            adv(fold, esk.advance, board1, act_i),
            adv(fold, esk.advance_plain, board1, act_i),
            nbytes(fold["seed"], si, fold["sf"], act_i, fold["obs_i"], board1,
                   fold["goals"], fold["init_board"], *out)
            + 3 * h * w * int(done.sum()) * 2, draws,
            f"{name} (H,W,B)=({h},{w},{b}), {int(done.sum())} resetting")
        out = adv(noreset, esk.advance, board1, act_i)()
        runs[f"K3_advance_noreset[{rule}]"] = (
            adv(noreset, esk.advance, board1, act_i),
            adv(noreset, esk.advance_plain, board1, act_i),
            nbytes(noreset["seed"], noreset["si"], noreset["sf"], board1,
                   noreset["goals"], noreset["init_board"], *out), draws,
            name)
        if rule == "static_spawnless":
            board = fold["board"]
            runs["K1_action"] = (
                lambda: esk.apply_action(si, board),
                lambda: esk.action_plain(si, board),
                nbytes(board, si, board1, act_i), 0, name)
            runs["K4_advance_spawnless"] = (
                lambda: life_kernels.advance_spawnless(board1),
                lambda: life_kernels.advance_spawnless_plain(board1),
                2 * nbytes(board1), 0, name)
        if rule == "simple":
            goals = fold["goals"]
            runs["K6_advance_simple"] = (
                lambda: life_kernels.advance_simple(goals),
                lambda: life_kernels.advance_simple_plain(goals),
                2 * nbytes(goals), 0, f"{name} goals")
        if rule == "spawn_simple":
            runs.update(rule_kernel_runs(fold, board1, name))
    out = {}
    for name, (kernel, plain, moved, draws, what) in runs.items():
        got, want = kernel(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = assert_bit_equal(got, want, f"{name} at the main shapes")
        ms = time_ms(kernel, 50)
        plain_ms = time_ms(plain, 3)
        bytes_ms = moved / rate * 1e3
        cells = 26 * 26 * MAIN_BATCH
        ops = OPS_PER_CELL[name] * cells + OPS_PER_DRAW * draws
        ops_ms = ops / PEAK_OPS * 1e3
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        out[name] = (err, ms, plain_ms, max(bytes_ms, ops_ms), bound_by)
        print(f"timing {name}: max abs err {err} vs plain; "
              f"{ms:.4f} ms (plain {plain_ms:.4f} ms), "
              f"bound {max(bytes_ms, ops_ms):.4f} ms by {bound_by} "
              f"({moved / 1e6:.1f} MB, {ops / 1e9:.2f} G ops, {draws} draw "
              f"cells), {bytes_ms / ms:.1%} of the memory rate; {what}")
    return out


def rule_kernel_runs(fold, board1, name):
    """K5, K7 and K8 on the stress bank's post-action boards and goals,
    with Philox fields of the step's seed at the bank's spawn_prob."""
    goals, probs, seed = fold["goals"], fold["sf"][0], fold["seed"]
    f5 = rng.spawn_field24(seed, probs, board1.shape)
    fb, fg = rng.spawn_field_pair(seed, probs, board1.shape)
    draws_b, draws_g = draw_cells(board1), draw_cells(goals)
    what = f"{name} post-action boards and goals, spawn_prob 0.3"
    return {
        "K5_advance_with_field": (
            lambda: life_kernels.advance_with_field(board1, f5),
            lambda: life_kernels.advance_with_field_plain(board1, f5),
            2 * nbytes(board1) + nbytes(f5), 0, what),
        "K7_advance_pair_fields": (
            lambda: life_kernels.advance_pair_spawnsimple_with_fields(
                board1, fb, goals, fg),
            lambda: life_kernels.advance_pair_spawnsimple_with_fields_plain(
                board1, fb, goals, fg),
            4 * nbytes(board1) + 2 * nbytes(fb), 0, what),
        "K8_advance_both": (
            lambda: life_kernels.advance_both(board1, goals, probs, seed),
            lambda: life_kernels.advance_both_plain(board1, goals, probs,
                                                    seed),
            4 * nbytes(board1) + nbytes(probs, seed), draws_b + draws_g,
            what),
    }


def profile(name, bank, state, steps=ROLLOUT):
    """Device time by kernel over ``steps`` main-path steps, and the share
    of the host-clock wall time in which the device ran no kernel."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    dev = state.device
    env = BatchedSafeLifeEnv(EnvConfig(view_shape=VIEW), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bench.run_steps(env, bank, state, gen, steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.elapsed_us() / 1e3)
    busy_ms = sum(by_name.values())
    assert busy_ms > 0, "the profiler recorded no device time"
    print(f"profile {name}: {steps} main-path steps, wall {wall_ms:.3f} ms "
          f"({wall_ms / steps:.3f} ms/step), device busy {busy_ms:.3f} ms "
          f"({busy_ms / steps:.3f} ms/step), idle share "
          f"{1 - busy_ms / wall_ms:.1%}")
    print("  by kernel:")
    for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {ms / steps:8.4f} ms/step  {ms / busy_ms:6.1%}  {kname[:90]}")
    print("  by the torch op that launched it:")
    ops = [(e.self_device_time_total / 1e3, e.key)
           for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]
    for ms, op in sorted(ops, reverse=True)[:8]:
        print(f"  {ms / steps:8.4f} ms/step  {ms / busy_ms:6.1%}  {op}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda", torch.cuda.current_device())

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(built)} "
          f"libraries (one nvcc each, in parallel)")
    for name, (path, log) in built.items():
        print(f"  {name}: {path}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"    {line.strip()}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    rate = memory_rate(kind)

    print("kernels against their plain versions: tolerance 0, bit for bit "
          "(integer state; the reward is a float32 difference of integers; "
          "both sides draw the same Philox bits)")
    t = time.perf_counter()
    check_k4(dev)
    check_k5_k8(dev)
    check_k1(dev)
    check_k2_k3(dev)
    check_philox(dev)
    check_rollouts(dev)
    print(f"phases 3-4: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    banks, results, launches = main_path(dev)
    print(f"phase 5: {time.perf_counter() - t:.1f} s")
    for name, (steps_per_s, _) in results.items():
        print(f"env-steps/s {name} {steps_per_s:.0f} on {smi}")
    t = time.perf_counter()
    timings = kernel_timings(banks, dev, rate)
    for name, (_, state) in results.items():
        profile(name, banks[name], state)
    print(f"phase 6: {time.perf_counter() - t:.1f} s")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        err, ms, plain_ms, bound_ms, bound_by = timings[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
