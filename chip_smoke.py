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
   Then the kernels of the measurement scripts against their plain
   versions, bit for bit: S3-S5 (crop, transpose, neighbour sum) in every
   variant at (26, 26, 16384), K1 at every block width, T1 (the Philox
   word field; its word at the zero counter and key against Random123's
   known answer); and the integrity guard (``utils/integrity.py``)
   on the card: both checks pass and a corrupted output raises;
4. 12-step rollouts through the kernels against the plain env path;
5. the main path, ``safelife_torch.bench``: the integrity check and the
   selftest that its ``main`` runs, then its timing
   of append-still, append-dynamic and the stress bank at B = 65536 for 160
   steps each (fresh levels every 20 steps, the observation consumed every
   step); then the evaluation path (no auto-reset) for 20 steps, and a few
   steps of each v1.0 suite and of the general-pair bank with and without
   auto-reset, with the launch counts read around it all;
6. each kernel's time at the main path's shapes beside its bound and its
   plain version's time (K2 and K3 under each rule), and a profile of 20
   steps of each configuration (device time by kernel, idle share);
7. the measurement entry points ``python -m safelife_torch.scripts.*``
   (stepbench, ablock_bench, obs_micro, stress_micro), each run once with
   the launch counts read around it, then the times of their kernels
   (S1-S5, T1) beside bounds, plain versions and library calls, K1's
   time on one state with its agents where they are and moved to a corner,
   and a profile of stepbench's full step at its batch;
8. one JSON line listing the kernels, and last the result line.

Exits nonzero, printing no result, when no CUDA device is present.
"""

import collections
import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

from safelife_torch import bench, bits16, scripts
from safelife_torch import cells as C
from safelife_torch.env.env import BatchedSafeLifeEnv, EnvConfig
from safelife_torch.levels import loader, synth
from safelife_torch.ops import _build, env_step_kernels as esk, life_kernels
from safelife_torch.ops import obs_micro as om
from safelife_torch.ops import rng
from safelife_torch.ops.life import nb_sum
from safelife_torch.scripts import (ablock_bench, obs_micro, stepbench,
                                    stress_micro)
from safelife_torch.utils import integrity

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
OBS_SOURCE = "safelife_torch/csrc/obs_micro.cu"
PHILOX_SOURCE = "safelife_torch/csrc/philox_words.cu"
# The batch of the measurement scripts (all but stress_micro's).
SCRIPT_BATCH = 16384
ENTRY_POINTS = {"stepbench": stepbench, "ablock_bench": ablock_bench,
                "obs_micro": obs_micro, "stress_micro": stress_micro}
# The kernels of the measurement scripts and of the PRNG probe: JSON name
# -> (source, the TPU kernel, the launch counter, the path that launches
# it: an entry point, or one of its rows after a colon).  S1 is K1
# relaunched alone, so it counts under K1's key in its own row.
SCRIPT_KERNELS = {
    "S1_action_only": (STEP_SOURCE, "scripts/stepbench.py:111", "K1_action",
                       "stepbench: action kernel only"),
    **{f"S2_action_block[{n}]": (STEP_SOURCE, "scripts/ablock_bench.py:42",
                                 f"S2_action_block[{n}]", "ablock_bench")
       for n in esk.ACTION_BLOCKS},
    **{f"S3_view_crop[{c}]": (OBS_SOURCE, "scripts/obs_micro.py:77",
                              f"S3_view_crop[{c}]", "obs_micro")
       for c in om.COMPUTES},
    **{f"S4_view_transpose[{c}]": (OBS_SOURCE, "scripts/obs_micro.py:103",
                                   f"S4_view_transpose[{c}]", "obs_micro")
       for c in om.COMPUTES},
    **{f"S5_nb_sum[{d}x{p}]": (OBS_SOURCE, "scripts/obs_micro.py:133",
                               f"S5_nb_sum[{d}x{p}]", "obs_micro")
       for _, d, p in obs_micro.NB_SUM_ROWS},
    "T1_philox_words": (PHILOX_SOURCE, "tests/test_fused_step.py:256",
                        "T1_philox_words", "bench"),
}
# Kernels of the main path that each entry point must launch as well.
ENTRY_KERNELS = {
    "stepbench": ("K2_advance_fold[static_spawnless]",
                  "K3_advance_noreset[static_spawnless]",
                  "K2_advance_fold[simple]", "K2_advance_fold[spawn_simple]"),
    "stress_micro": ("K8_advance_both", "K1_action",
                     "K2_advance_fold[spawn_simple]",
                     "K2_advance_fold[simple]",
                     "K2_advance_fold[static_spawnless]"),
}
# The first word of Random123's known answer for Philox4x32-10 at counter
# (0, 0, 0, 0) and key (0, 0): T1's word at cell 0, environment 0, seed 0.
PHILOX_KAT_ZERO = 0x6627e8d5


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


def check_obs_micro(dev, b=SCRIPT_BATCH):
    """S3-S5 in every variant against their plain versions: full-range
    and small boards, shifts beyond the board both ways, odd batches."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)

    def u16(shape, high=2**16):
        return torch.randint(0, high, shape, generator=gen, device=dev,
                             dtype=torch.int32).to(torch.uint16)

    for batch in (b, 1004, 1001):
        x = u16((26, 26, batch))
        si = torch.randint(-40, 40, (2, batch), generator=gen, device=dev,
                           dtype=torch.int32)
        for compute in om.COMPUTES:
            for view in (om.VIEW, (9, 31)):
                assert_bit_equal(
                    [om.view_crop(x, si, compute, view)],
                    [om.view_crop_plain(x, si, compute, view)],
                    f"S3 {compute} view {view} B={batch}")
            window = bits16(x)[:15, :15].contiguous().view(torch.uint16)
            for v in (window, u16((33, 33, batch))):
                assert_bit_equal([om.view_transpose(v, compute)],
                                 [om.view_transpose_plain(v, compute)],
                                 f"S4 {compute} {tuple(v.shape)}")
        small = (x.to(torch.int32) & 15).to(torch.uint16)
        for dtype in om.WIDTHS:
            if batch % om._LANES[dtype]:
                continue
            for planes in om.PLANES:
                for board in (small, x):
                    assert_bit_equal(
                        [om.nb_sum_planes(board, dtype, planes)],
                        [om.nb_sum_planes_plain(board, dtype, planes)],
                        f"S5 {dtype} x{planes} B={batch}")
    print(f"S3 crop, S4 transpose, S5 neighbour sum == plain: every variant "
          f"at (26,26,{b}), 1004 and 1001 environments")


def check_k1_blocks(dev):
    """K1 at every block width against its plain version."""
    rng_ = np.random.RandomState(8)
    for shape in ((26, 26, SCRIPT_BATCH), (3, 5, 1001)):
        si, board = action_inputs(rng_, shape, dev)
        want = esk.action_plain(si, board)
        for block in esk.ACTION_BLOCKS:
            assert_bit_equal(esk.apply_action(si, board, block=block), want,
                             f"K1 block {block} {shape}")
    print(f"K1 action == plain at block widths {esk.ACTION_BLOCKS}: random "
          f"states, (26,26,{SCRIPT_BATCH}) and (3,5,1001)")


def check_t1(dev):
    """T1 against its plain version (whose Philox the CPU tests hold to
    Random123's known answers), and T1's first word at seed 0 against
    Random123's answer for the zero counter and key."""
    for seed, shape in ((integrity.PROBE_SEED, integrity.PROBE_SHAPE),
                        (123456789, (26, 26, SCRIPT_BATCH)),
                        (-5, (3, 5, 1001))):
        s = torch.tensor([seed], dtype=torch.int32, device=dev)
        assert_bit_equal([rng.philox_words(s, shape)],
                         [rng.philox_words_plain(s, shape)],
                         f"T1 seed {seed} {shape}")
    zero = rng.philox_words(torch.zeros(1, dtype=torch.int32, device=dev),
                            (1, 1, 1))
    assert int(zero) & rng.MASK32 == PHILOX_KAT_ZERO, hex(int(zero))
    print("T1 Philox words == plain: the probe (seed 7, 8 cells x 128 "
          f"environments), (26,26,{SCRIPT_BATCH}) and (3,5,1001); its word "
          "at the zero counter and key is Random123's known answer")


def check_integrity(dev):
    """Both integrity checks pass on the card, and a corrupted output (the
    score chain zeroed, the signature of the incident the guard exists
    for) raises."""
    assert integrity.check_device_integrity(dev)
    names = ("append-still", "append-dynamic", "stress", "general")
    for name in names:
        assert integrity.check_bank_reset_integrity(load_bank(name, dev))
    real = integrity._device_outputs

    def corrupted(*args):
        out = dict(real(*args))
        out["points"] = out["points"] * 0
        return out

    integrity._device_outputs = corrupted
    try:
        integrity.check_device_integrity(dev)
    except integrity.DeviceIntegrityError as err:
        assert "points" in str(err), err
        print(f"integrity: a zeroed score chain raises: {str(err)[:120]}...")
    else:
        raise AssertionError("a corrupted output passed the integrity check")
    finally:
        integrity._device_outputs = real
    print(f"integrity: device check (CA, K4, scoring, side effects, reset "
          f"gather, T1 probe) and bank reset check on {', '.join(names)} "
          "passed")


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
    # What bench.main runs before its timing.
    integrity.check_device_integrity(dev)
    bench.selftest(banks)
    print(f"bench integrity check and selftest passed in "
          f"{time.perf_counter() - t0:.1f} s (bank loads included)")
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
    for name in list(KERNELS) + ["T1_philox_words"]:
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


def draw_cells(board, inhibit=True):
    """Cells where the full rule asks for a spawn draw (``FullRule::rule``
    in ``csrc/safelife_rule.cuh``): dead, not frozen, not three live
    cells in the 3x3 neighbourhood, a spawner there, and with ``inhibit``
    (the rule's PI) no inhibiting cell there."""
    x = as_i32(board)

    def near(bit):
        return nb_sum((x >> bit) & 1)

    asked = (((x & (C.ALIVE | C.FROZEN)) == 0) & (near(C.ALIVE_BIT) != 3)
             & (near(C.SPAWNING_BIT) != 0))
    if inhibit:
        asked &= near(C.INHIBITING_BIT) == 0
    return int(asked.sum())


def row_bytes(table, rows):
    """Bytes of ``rows`` rows of a (rows, B) table."""
    return rows * table.shape[1] * table.element_size()


def action_bytes(si, board, out, act_i):
    """Bytes K1 must move (``action_kernel`` in
    ``csrc/env_step_kernels.cu``): the board read and written, ``act_i``
    written, ``si`` rows 0-2, 4 and 5 read, and row 3 (the orientation)
    only for the environments whose action neither moves nor turns."""
    turned = (si[0] >= 1) & (si[0] <= 8) & (si[4] == 0)
    return (nbytes(board, out, act_i) + row_bytes(si, 5)
            + int((~turned).sum()) * si.element_size())


def advance_bytes(args, board1, act_i, out, done):
    """Bytes K2 (``time_limit > 0``) or K3 must move on this step's data
    (``advance_kernel`` in ``csrc/env_step_kernels.cu``): every board
    input read once and every output written once, the fresh levels'
    three boards of the resetting environments, and the rows of the
    tables that the kernel reads for them: ``si`` rows 6, 8 (static
    goals), 4 and 7 (fold); ``sf`` row 1 and row 0 with a draw; ``act_i``
    row 3 (fold) and rows 0-1 where the view is of a live environment;
    ``obs_i``: each environment's exit flags, and for each valid exit its
    row and column (and its goal colour on static goals); for a
    resetting one the fresh agent cell and, with a valid exit on static
    goals, the fresh gate."""
    fold = args["time_limit"] > 0
    static = args["rule"] in ("static_spawnless", "static")
    draw = args["draw"] != "none"
    si, sf, obs_i = args["si"], args["sf"], args["obs_i"]
    b = board1.shape[-1]
    n_done = int(done.sum())
    moved = nbytes(board1, args["goals"], args["init_board"], *out)
    moved += row_bytes(si, 1 + static + 2 * fold)
    moved += row_bytes(sf, 1 + draw) + 4 * draw
    if fold:
        moved += 3 * nbytes(board1) // b * n_done + row_bytes(act_i, 1)
    if obs_i is not None:
        k = (obs_i.shape[0] - 3) // 8
        valid = torch.where(done, obs_i[2 + 5 * k:2 + 6 * k],
                            obs_i[2 + 2 * k:2 + 3 * k]) != 0
        n_valid = valid.sum(0)
        words = (k * b + int(n_valid.sum()) * (2 + static) + 2 * n_done
                 + static * int((done & (n_valid > 0)).sum())
                 + 2 * (b - n_done))
        moved += words * obs_i.element_size()
    return moved


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
            draws += draw_cells(fold["goals"], inhibit=rule == "general")
        runs[f"K2_advance_fold[{rule}]"] = (
            adv(fold, esk.advance, board1, act_i),
            adv(fold, esk.advance_plain, board1, act_i),
            advance_bytes(fold, board1, act_i, out, done), draws,
            f"{name} (H,W,B)=({h},{w},{b}), {int(done.sum())} resetting")
        out = adv(noreset, esk.advance, board1, act_i)()
        runs[f"K3_advance_noreset[{rule}]"] = (
            adv(noreset, esk.advance, board1, act_i),
            adv(noreset, esk.advance_plain, board1, act_i),
            advance_bytes(noreset, board1, act_i, out, done), draws, name)
        # Default arguments bind append-still's tensors: the loop rebinds
        # si and board1 for the next rule.
        if rule == "static_spawnless":
            board = fold["board"]
            runs["K1_action"] = (
                lambda si=si, board=board: esk.apply_action(si, board),
                lambda si=si, board=board: esk.action_plain(si, board),
                action_bytes(si, board, board1, act_i), 0, name)
            runs["K4_advance_spawnless"] = (
                lambda b=board1: life_kernels.advance_spawnless(b),
                lambda b=board1: life_kernels.advance_spawnless_plain(b),
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
    # A given field is read (one byte) only where the rule asks for a draw.
    draws_b, draws_g = draw_cells(board1), draw_cells(goals)
    spawn_simple_g = draw_cells(goals, inhibit=False)
    what = f"{name} post-action boards and goals, spawn_prob 0.3"
    return {
        "K5_advance_with_field": (
            lambda: life_kernels.advance_with_field(board1, f5),
            lambda: life_kernels.advance_with_field_plain(board1, f5),
            2 * nbytes(board1) + draws_b, 0, what),
        "K7_advance_pair_fields": (
            lambda: life_kernels.advance_pair_spawnsimple_with_fields(
                board1, fb, goals, fg),
            lambda: life_kernels.advance_pair_spawnsimple_with_fields_plain(
                board1, fb, goals, fg),
            4 * nbytes(board1) + draws_b + spawn_simple_g, 0, what),
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


# ---------------------------------------------------------------------------
# Phase 7: the measurement entry points and their kernels.
# ---------------------------------------------------------------------------

def entry_points(dev):
    """Run each entry point once, its launch counts read around it and
    around each of its timed rows; returns {path: launches}, a path being
    an entry point or "entry point: row"."""
    out = {}
    for name, module in ENTRY_POINTS.items():
        print(f"python -m safelife_torch.scripts.{name}:", flush=True)
        _build.LAUNCHES.clear()
        scripts.ROW_LAUNCHES.clear()
        t = time.perf_counter()
        rows = module.main(dev)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        assert all(us > 0 for us in rows.values()), rows
        for counter in ENTRY_KERNELS.get(name, ()):
            assert launches.get(counter, 0) > 0, (name, counter, launches)
        print(f"{name}: {len(rows)} rows in {time.perf_counter() - t:.1f} s;"
              f" launches {launches}")
        out[name] = launches
        out.update({f"{name}: {row}": n
                    for row, n in scripts.ROW_LAUNCHES.items()})
    # T1's path is the main path, checked in phase 5.
    for kernel, (_, _, counter, path) in SCRIPT_KERNELS.items():
        if path in out:
            assert out[path].get(counter, 0) > 0, (kernel, path, out[path])
    print(f"stepbench row 'action kernel only' (S1): launches "
          f"{out['stepbench: action kernel only']}")
    return out


def time_chain(fn, x, iters, chain, graph=False):
    """ms per launch of ``fn(x)`` over ``iters`` launches between CUDA
    events; with ``chain`` each output is the next input.  With ``graph``
    the launches are captured in one CUDA graph and replayed, so no host
    time separates them: the time of the kernels themselves, where a
    Python loop would time the host's launch rate."""
    def loop(x):
        for _ in range(iters):
            y = fn(x)
            x = y if chain else x

    fn(x)
    torch.cuda.synchronize()
    run = functools.partial(loop, x)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            loop(x)
        run = g.replay
        run()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def script_runs(dev):
    """{kernel: (kernel fn, plain fn, input, chained, library fn or None,
    bytes moved, operations, what)} at the scripts' shapes."""
    b = SCRIPT_BATCH
    cells = 26 * 26 * b
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    still = load_bank("append-still", dev)
    board = still.take(torch.arange(b, device=dev) % still.num_levels).board
    runs = {}
    for name, rows, block in [("S1_action_only", 8, None)] + [
            (f"S2_action_block[{n}]", 9, n) for n in esk.ACTION_BLOCKS]:
        si = torch.zeros((rows, b), dtype=torch.int32, device=dev)
        si[0] = 2
        out, act_i = esk.apply_action(si, board, block)
        runs[name] = (
            lambda x, si=si, block=block: esk.apply_action(si, x, block)[0],
            lambda x, si=si: esk.action_plain(si, x)[0], board, True, None,
            action_bytes(si, board, out, act_i),
            OPS_PER_CELL["K1_action"] * cells,
            f"append-still boards, action 2 (MOVE RIGHT), block "
            f"{block or 128}, the board fed back")
    x = torch.randint(0, 2**15, (26, 26, b), generator=gen, device=dev,
                      dtype=torch.int32).to(torch.uint16)
    si = torch.randint(0, 26, (2, b), generator=gen, device=dev,
                       dtype=torch.int32)
    vh, vw = om.VIEW
    rows = torch.remainder(si[0][None, :] + torch.arange(vh, device=dev)[
        :, None], 26)[:, None, :].long()
    cols = torch.remainder(si[1][None, :] + torch.arange(vw, device=dev)[
        :, None], 26)[None, :, :].long()
    lanes = torch.arange(b, device=dev)
    v = torch.randint(0, 2**15, (vh, vw, b), generator=gen, device=dev,
                      dtype=torch.int32).to(torch.uint16)
    view_bytes = vh * vw * b * 2
    for c in om.COMPUTES:
        runs[f"S3_view_crop[{c}]"] = (
            lambda x, c=c: om.view_crop(x, si, c),
            lambda x, c=c: om.view_crop_plain(x, si, c), x, False,
            lambda: bits16(x)[rows, cols, lanes],
            2 * view_bytes + nbytes(si), 4 * vh * vw * b,
            "random boards, random shifts: the window read, the view written")
        runs[f"S4_view_transpose[{c}]"] = (
            lambda v, c=c: om.view_transpose(v, c),
            lambda v, c=c: om.view_transpose_plain(v, c), v, False,
            lambda: bits16(v).permute(2, 0, 1).contiguous(),
            2 * view_bytes, vh * vw * b, "random (15,15,B) views")
    small = (x.to(torch.int32) & 15).to(torch.uint16)
    for _, d, p in obs_micro.NB_SUM_ROWS:
        runs[f"S5_nb_sum[{d}x{p}]"] = (
            lambda x, d=d, p=p: om.nb_sum_planes(x, d, p),
            lambda x, d=d, p=p: om.nb_sum_planes_plain(x, d, p), small, True,
            None, 2 * nbytes(small), 8 * p * cells,
            "random boards & 15, the output fed back")
    seed = torch.tensor([integrity.PROBE_SEED], dtype=torch.int32,
                        device=dev)
    probe = integrity.PROBE_SHAPE
    words = int(np.prod(probe))
    runs["T1_philox_words"] = (
        lambda s: rng.philox_words(s, probe),
        lambda s: rng.philox_words_plain(s, probe), seed, False, None,
        4 * words + 4, OPS_PER_DRAW * words,
        f"the integrity probe: seed {integrity.PROBE_SEED}, {probe}")
    return runs


def script_timings(dev, rate):
    """{kernel: (max_abs_err, ms, plain_ms, bound_ms, bound_by,
    library_ms)} at the scripts' shapes."""
    out = {}
    for name, (kernel, plain, x, chain, library, moved, ops,
               what) in script_runs(dev).items():
        err = assert_bit_equal([kernel(x)], [plain(x)],
                               f"{name} at the scripts' shapes")
        ms = time_chain(kernel, x, 200, chain, graph=True)
        loop_ms = time_chain(kernel, x, 200, chain)
        plain_ms = time_chain(plain, x, 3, False)
        library_ms = (time_chain(lambda _: library(), None, 200, False,
                                 graph=True) if library else None)
        bytes_ms = moved / rate * 1e3
        ops_ms = ops / PEAK_OPS * 1e3
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        bound = max(bytes_ms, ops_ms)
        out[name] = (err, ms, plain_ms, bound, bound_by, library_ms)
        lib = f", library {library_ms:.4f} ms" if library else ""
        print(f"timing {name}: max abs err {err} vs plain; {ms:.4f} ms in "
              f"a CUDA graph, {loop_ms:.4f} ms launched from Python "
              f"(plain {plain_ms:.4f} ms{lib}), bound {bound:.6f} ms by "
              f"{bound_by} ({moved / 1e6:.3f} MB, {ops / 1e9:.3f} G ops), "
              f"{bytes_ms / ms:.1%} of the memory rate; {what}")
    return out


def k1_state_probe(bank, dev):
    """K1 at the main path's width on the phase-6 state, in a CUDA graph:
    as it is, with every agent moved to (0, 0) (the four cells a thread
    reads around its agent are then one address for the whole warp), and
    with the board fed back (each launch reads the last one's output)."""
    fold = step_inputs(bank, dev)[0]
    si, board = fold["si"], fold["board"]
    corner = si.clone()
    corner[1:3] = 0
    for what, s, chain in (("agents where they are", si, False),
                           ("agents where they are, board fed back", si,
                            True),
                           ("every agent at (0, 0)", corner, False)):
        ms = time_chain(lambda x, s=s: esk.apply_action(s, x)[0], board, 50,
                        chain, graph=True)
        print(f"K1 state probe, (26,26,{MAIN_BATCH}) append-still one step "
              f"in: {ms:.4f} ms, {what}")


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
    check_obs_micro(dev)
    check_k1_blocks(dev)
    check_t1(dev)
    check_integrity(dev)
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

    t = time.perf_counter()
    paths = dict(entry_points(dev), bench=launches)
    script = script_timings(dev, rate)
    still = banks["append-still"]
    k1_state_probe(still, dev)
    # The step that stepbench's first row times in a graph, launched from
    # Python at its batch: the device's busy share there.
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    env = BatchedSafeLifeEnv(EnvConfig(view_shape=VIEW), device=dev)
    profile(f"append-still B={SCRIPT_BATCH} (stepbench's full step)", still,
            env.reset_all(still, SCRIPT_BATCH, gen))
    print(f"phase 7: {time.perf_counter() - t:.1f} s")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        err, ms, plain_ms, bound_ms, bound_by = timings[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None))
    for name, (source, replaces, counter, path) in SCRIPT_KERNELS.items():
        err, ms, plain_ms, bound_ms, bound_by, library_ms = script[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=paths[path][counter], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
