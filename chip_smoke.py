"""Drive the PyTorch port of SafeLife on one CUDA card and hold its
hand-written kernels to their plain PyTorch versions.

    python3 chip_smoke.py

Phases, each an assertion that ends the run on failure:

1. build every kernel from ``safelife_torch/csrc`` (one ``nvcc`` each, in
   parallel);
2. print the card's name and power limit (``nvidia-smi``);
3. each kernel against its plain version on the card, bit for bit: K4-K8
   on soups (spawners and spawn_prob 0.3 for K5-K8) at (26, 26, 4096),
   ragged batches 4097, 1001, 33 and 7, and 40x40, 64x64 and 72x72 boards
   (each kernel both staged and streamed), every shape also on tensors 2
   bytes off a 16-byte boundary; K1 on
   random states and all nine actions; K2 (fold and view) and K3 (no
   reset) along rollouts with resets on append-still, prune-still,
   append-dynamic, append-spawn, navigation, the goal-spawner stress bank
   and a general-pair bank, which take all five CA rules, spawn draws at
   the banks' rates included, and on 40x40 boards (a staged slab of 8
   environments) and 64x64 boards (no slab fits: the streamed variant)
   under every rule; then the Philox draws (24-bit and paired):
   same seed same field, seeds differ, rate within 5 sigma, edges exact;
   then the observation sum R1 (uint8 and uint16, the main path's
   observation at B = 65536, lengths that are not a multiple of 16 and
   tensors one element off a 16-byte boundary) and the view kernel, S4's
   KEEP and the step's UNPACK (views 15x15, 7x9, 33x33 and 40x40 (the
   streamed variant), channels range(15), (0, 3, 12), (14, 2, 7),
   range(16), B = 65536, 4096, 1001, 33 and 7, misaligned views, bulk
   and narrow stores); then the kernels of the measurement scripts against
   their plain versions, bit for bit: S3 and S5 (crop, neighbour sum) in
   every variant at (26, 26, 16384) and ragged batches (S3 at views 15x15,
   33x33 and 9x31, misaligned, and streamed on 128x128 boards; S5 also at
   B = 65536, on 25x27, 72x72, 100x100, 1x1 and 3x5 boards (staged) and
   128x128 (streamed), each also misaligned), K1 at
   every block width, T1 (the Philox
   word field; its word at the zero counter and key against Random123's
   known answer); and the integrity guard (``utils/integrity.py``)
   on the card: both checks pass and a corrupted output raises;
4. 12-step rollouts through the kernels against the plain env path;
5. the main path, ``safelife_torch.bench``: the integrity check and the
   selftest that its ``main`` runs, then its timing
   of append-still, append-dynamic and the stress bank at B = 65536 for 160
   steps each (fresh levels every 20 steps, the observation consumed every
   step through the view kernel's UNPACK and summed by R1); then the
   evaluation path (no auto-reset) for 20 steps, a few steps with the
   packed observation (KEEP), and a few steps of each v1.0 suite and of
   the general-pair bank with and without auto-reset, with the launch
   counts read around it all;
6. each kernel's time at the main path's shapes beside its bound and its
   plain version's time (K2 and K3 under each rule; the unpack and R1 on
   the step's packed view and observation), and a profile of 20 steps of
   each configuration (device time by kernel, idle share), then 20 more
   of append-still with input shapes recorded (copies, masks and tests);
7. the measurement entry points ``python -m safelife_torch.scripts.*``
   (stepbench, ablock_bench, obs_micro, stress_micro), each run once with
   the launch counts read around it, then the times of their kernels
   (S1-S5, T1) beside bounds, plain versions and library calls, S3-S5
   again at B = 65536 (inputs larger than the L2), T1's launch floor (an
   empty kernel launched as T1 is), K1's time on one state with its agents
   where they are and moved to a corner, and a profile of stepbench's full
   step at its batch;
8. the training path (``safelife_torch.training``) at the 33x33 training
   view: the training wrapper stack (movement bonus, side-effect penalty
   with scheduled coefficients, continuing) through K1, K2 and the view
   kernel's UNPACK against the same stack on the plain step, bit for bit,
   on append-still and append-dynamic at B = 4096, 1001 and 7 for 20
   steps with resets; the policy net on the card against the CPU (float32
   with TF32 off, and the bfloat16 trunk against float32, each within its
   stated tolerance); ``Trainer`` with ``PPOConfig()`` defaults on
   append-still for 3 batches at 64 and at 4096 environments (finite
   losses, every parameter and ``spe`` changed, a checkpoint restored bit
   for bit, ``load_policy`` drawing actions, K1, K2 and UNPACK launched by
   the run); then the learner's env-steps/s (rollout + GAE + update) at
   both widths, ms a batch of the rollout and of the update, and a
   profile of one batch at 4096 (top device ops, K2's and UNPACK's share,
   idle share);
9. the evaluation path (``safelife_torch.benchmarking``,
   ``safelife_torch.side_effects``) and the recurrent policy: every v1.0
   suite through ``run_benchmark`` on the kernels (K1, K3 under the
   suite's rule, UNPACK, and K5 for the side-effect co-evolution) and on
   the plain path with the same generator seeds (view 25x25, time limit
   50, 16 side-effect samples, a deterministic policy): records and
   occupancy distributions bit for bit, scores within rtol 1e-5, launches
   counted; K5 at the co-evolution's shape against its plain version; the
   Sinkhorn EMD on the card against float64 on the CPU, TF32 off inside
   it whatever the caller set; ``run_benchmark`` at full width on
   append-still and prune-spawn (100 levels, view 33x33, time limit 1000,
   250 samples, a ``SafeLifeCNN`` policy) with the seconds of the step
   loop, the co-evolution and the Sinkhorn EMD; the LSTM net on the card
   against the CPU; a recurrent ``Trainer`` for 3 batches at 64 and 4096
   environments (checkpoint round trip, learner env-steps/s) and
   ``load_policy`` of its run driving ``run_benchmark`` with its carry;
   and a ``Trainer`` with ``eval_suite`` evaluating once;
10. one JSON line listing the kernels (the launches of phases 5, 8 and
   9), and last the result line; before it the run fails if the build
   log shows a K1-K8, S3-S5, R1 or view kernel instantiation that spills.

Exits nonzero, printing no result, when no CUDA device is present.
"""

import collections
import dataclasses
import functools
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from safelife_torch import bench, bits16, scripts
from safelife_torch import cells as C
from safelife_torch.env import wrappers as W
from safelife_torch.env.env import BatchedSafeLifeEnv, EnvConfig
from safelife_torch.levels import loader, synth
from safelife_torch.ops import _build, env_step_kernels as esk, life_kernels
from safelife_torch.ops import obs as obs_ops
from safelife_torch.ops import obs_micro as om
from safelife_torch.ops import rng
from safelife_torch.ops.life import nb_sum
from safelife_torch.scripts import (ablock_bench, obs_micro, stepbench,
                                    stress_micro)
from safelife_torch.training import driver, model, ppo
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
# The card's peak rate for 32-bit operations outside the tensor cores
# (NVIDIA's data sheet, H100 SXM: 67 T/s, an FMA counted as two): the
# operation term of every bound, so that no bound exceeds the least time.
PEAK_OPS = 67e12
# INT32 results an SM's ALU issues per clock on Hopper.  Times the SM
# count and the highest SM clock (int_rate) it gives an estimate of the
# time the counted integer operations take, printed beside each bound but
# not one: IMAD can also issue on the FMA pipe, an SM issues up to 128
# thread-instructions a clock, and one LOP3 or IADD3 does two or three of
# the counted operations.
INT32_PER_SM_CLOCK = 64
# Integer operations per board cell, counted from the kernel sources as C
# operations (loads, stores, address arithmetic and loop control left
# out), and per Philox draw (ten rounds of two multiplies, two
# multiply-highs, three XORs and two key additions).  K2/K3's counts hold
# for the shared-memory slab design: the rule, scoring and side-effect
# work per cell is the same, and what the slab removed (64-bit offsets, a
# second pass over init) was address arithmetic and loads.
RULE_OPS = {"static_spawnless": 75, "static": 105, "simple": 115,
            "spawn_simple": 165, "general": 170}
OPS_PER_CELL = {
    # K1 copies the board with no arithmetic a cell; its decode is about
    # 60 operations per environment, 0.1 a cell of a 26x26 board.
    "K1_action": 0.1, "K4_advance_spawnless": 40, "K5_advance_with_field": 70,
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
VIEW_SOURCE = "safelife_torch/csrc/view_kernels.cu"
SUM_SOURCE = "safelife_torch/csrc/obs_sum.cu"
# Main-path kernels that replace no TPU kernel: the view kernel's UNPACK
# replaces the XLA part of the jitted step after the advance kernel, and
# the observation sum the reference bench's consumer.
KERNELS.update({
    "S4_view_unpack": (VIEW_SOURCE, "safelife_tpu/ops/obs.py:79"),
    "R1_obs_sum": (SUM_SOURCE, "bench.py:215"),
})
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
    **{f"S4_view_transpose[{c}]": (VIEW_SOURCE, "scripts/obs_micro.py:103",
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


def int_rate(smi_clock_mhz):
    """The card's ALU rate for INT32 operations per second (an estimate,
    not a bound): INT32_PER_SM_CLOCK per SM and clock at its highest SM
    clock (``nvidia-smi`` clocks.max.sm)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return INT32_PER_SM_CLOCK * sms * smi_clock_mhz * 1e6


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

# The shapes K4-K8 are held at: the main one, ragged batches, and boards
# of 40x40 (a staged slab on every rule), 64x64 (staged on the one-word
# rules K4 and K6, streamed on the others) and 72x72 (streamed on every
# rule).
RULE_SHAPES = ((26, 26, 4096), (26, 26, 4097), (26, 26, 1001), (26, 26, 33),
               (26, 26, 7), (7, 3, 300), (40, 40, 1000), (64, 64, 256),
               (72, 72, 96))


def rule_steps(dev, shape, rng_, p, steps, place=lambda x: x):
    """K4-K8 along ``steps`` steps of soups with spawners at ``shape``
    (``place`` applied to every input), each against its plain version;
    returns each kernel's launch geometry and the cells K5 spawned."""
    full = SPAWNLESS_FLAGS + (C.SPAWNING,)

    def board(flags, density=0.15):
        return place(torch.as_tensor(soup(rng_, shape, flags, density),
                                     device=dev))

    b4, b5, b7, b8 = (board(f) for f in (SPAWNLESS_FLAGS, full, full, full))
    g6 = board(SIMPLE_FLAGS, 0.2)
    g7 = board(SPAWN_SIMPLE_FLAGS, 0.2)
    g8 = board(full)
    probs = torch.full((shape[2],), p, dtype=torch.float32, device=dev)
    fired = 0
    for step in range(steps):
        seed = torch.tensor([100 + step], dtype=torch.int32, device=dev)
        f5 = place(rng.spawn_field24(seed, probs, shape))
        fb, fg = map(place, rng.spawn_field_pair(seed, probs, shape))
        what = f"{shape} step {step}"
        got = life_kernels.advance_spawnless(b4)
        assert_bit_equal([got], [life_kernels.advance_spawnless_plain(b4)],
                         f"K4 {what}")
        b4 = place(got)
        got = life_kernels.advance_with_field(b5, f5)
        assert_bit_equal([got], [life_kernels.advance_with_field_plain(
            b5, f5)], f"K5 {what}")
        fired += int((bits16(got) != bits16(
            life_kernels.advance_with_field_plain(
                b5, torch.zeros_like(f5)))).sum())
        b5 = place(got)
        got = life_kernels.advance_simple(g6)
        assert_bit_equal([got], [life_kernels.advance_simple_plain(g6)],
                         f"K6 {what}")
        g6 = place(got)
        got = life_kernels.advance_pair_spawnsimple_with_fields(
            b7, fb, g7, fg)
        assert_bit_equal(
            got, life_kernels.advance_pair_spawnsimple_with_fields_plain(
                b7, fb, g7, fg), f"K7 {what}")
        b7, g7 = map(place, got)
        got = life_kernels.advance_both(b8, g8, probs, seed)
        assert_bit_equal(got, life_kernels.advance_both_plain(
            b8, g8, probs, seed), f"K8 {what}")
        b8, g8 = map(place, got)
    vec = _build.vector_path(shape[2], b4)
    geos = {k: life_kernels.rule_geometry(*shape[:2], k, shape[2], vec)
            for k in life_kernels.RULE_WORD_BYTES}
    return geos, fired


def variant(geo):
    """How a staged kernel ran: its slab width and access path."""
    if not geo["staged"]:
        return "streamed"
    return f"E={geo['envs']} " + ("vec" if geo["vector"] else "2-byte")


def check_rule_kernels(dev, p=0.3):
    """K4-K8 against their plain versions at every shape of RULE_SHAPES,
    each on tensors 2 bytes off a 16-byte boundary too (the 2-byte path),
    spawn fields and Philox draws at ``p``; both variants on every
    kernel."""
    rng_ = np.random.RandomState(5)
    variants = collections.defaultdict(set)
    for shape in RULE_SHAPES:
        steps = 6 if shape == (26, 26, 4096) else 2
        for place, how in ((lambda x: x, ""), (misaligned, ", misaligned")):
            geos, fired = rule_steps(dev, shape, rng_, p, steps, place)
            assert fired > 0, f"no spawn fired in K5's run at {shape}"
            for kernel, geo in geos.items():
                variants[kernel].add(geo["staged"])
            print(f"K4-K8 == plain: {shape}{how}, {steps} steps, spawn_prob "
                  f"{p} ({fired} cells of K5 spawned); " + ", ".join(
                      f"{k[:2]} {variant(g)}" for k, g in geos.items()))
    assert all(v == {True, False} for v in variants.values()), variants


def misaligned(x):
    """A contiguous copy of ``x`` whose storage starts 2 bytes past a
    16-byte boundary: the kernels take their 2-byte path on it."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    bits16(out).copy_(bits16(x))
    assert out.data_ptr() % 16 != 0
    return out


def check_k1(dev):
    """K1 on random states: the main shape, B % 8 != 0 (1001), less than
    one block (7), one block and one (33), and a misaligned board."""
    rng_ = np.random.RandomState(2)
    for shape in ((26, 26, 4096), (3, 5, 1001), (26, 26, 7), (26, 26, 33)):
        for trial in range(3):
            si, board = action_inputs(rng_, shape, dev)
            assert_bit_equal(esk.apply_action(si, board),
                             esk.action_plain(si, board),
                             f"K1 {shape} trial {trial}")
    si, board = action_inputs(rng_, (26, 26, 4096), dev)
    board = misaligned(board)
    assert_bit_equal(esk.apply_action(si, board), esk.action_plain(si, board),
                     "K1 misaligned board")
    print("K1 action == plain: random states, all nine actions, "
          "(26,26,4096), (3,5,1001), (26,26,7), (26,26,33) and a board "
          "2 bytes off a 16-byte boundary")


def rollout_check(env, bank, b, gen, what, misaligned_step=None, steps=10):
    """K1 + K2/K3 against their plain versions along ``steps`` steps of
    ``env`` at batch ``b`` (every input board 2 bytes off a 16-byte
    boundary too at ``misaligned_step``); returns the resets seen."""
    dev = bank.board.device
    gen.manual_seed(3)
    state = env.reset_all(bank, b, gen)
    fresh = env.sample_fresh_levels(bank, b, gen)
    resets = 0
    for step in range(steps):
        action = torch.randint(0, 9, (b,), generator=gen, device=dev,
                               dtype=torch.int32)
        kw = env.fused_inputs(state, bank, action,
                              fresh[1] if env.config.auto_reset else None,
                              env.step_seed(gen))
        assert_bit_equal(esk.fused_step(**kw), esk.fused_step_plain(**kw),
                         f"K1+K2/K3 {what} step {step}")
        if step == misaligned_step:
            check_misaligned(kw, what)
        state, ts = env.step(state, bank, action, gen, fresh_levels=fresh)
        resets += int(ts.done.sum())
    assert resets > 0, what
    return resets


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
                       (1001, dict(time_limit=6, view_shape=(9, 40))),
                       (7, dict(time_limit=6, view_shape=VIEW)),
                       (33, dict(time_limit=6, view_shape=(33, 33))),
                       (33, dict(time_limit=6, auto_reset=False))):
            env = BatchedSafeLifeEnv(EnvConfig(**cfg), device=dev)
            resets = rollout_check(env, bank, b, gen, f"{suite} {cfg}",
                                   5 if b == 4096 else None)
            print(f"K2/K3 advance == plain: {suite} ({rule_of(bank)} rule) "
                  f"B={b} {cfg}, 10 steps, {resets} resets")
    assert rules == set(esk.RULES), rules


def large_bank(rule, side, dev, num_levels=8):
    """Synthetic (side, side) levels that take ``rule``: the goal spawner
    cleared for certified simple goals, spawners on the board for the
    rules that draw."""
    if rule == "general":
        return synth.general_bank(num_levels, side, side, device=dev)
    levels = [synth.simple_level(
        side, side, seed=i, spawners=rule in ("static", "spawn_simple"),
        dynamic_goals=rule in ("simple", "spawn_simple"))
        for i in range(num_levels)]
    if rule == "simple":
        for level in levels:
            level["goals"][(level["goals"] & C.SPAWNING) != 0] = 0
    return loader.build_bank(levels, device=dev)


def check_k2_k3_large(dev):
    """K1 + K2/K3 on boards larger than the suites': 40x40 (a staged slab
    of 8 environments) and 64x64 (no slab fits: the streamed variant)
    under every rule, with and without auto-reset, ragged batches too."""
    gen = torch.Generator(device=dev)
    for side in (40, 64):
        for rule in esk.RULES:
            bank = large_bank(rule, side, dev)
            assert rule_of(bank) == rule, (rule, rule_of(bank))
            geo = esk.advance_geometry(side, side, rule, 1000)
            assert geo["staged"] == (side == 40), geo
            variant = (f"staged E={geo['envs']}" if geo["staged"]
                       else "streamed")
            for b, cfg in ((1000, dict(time_limit=6, view_shape=VIEW)),
                           (33, dict(time_limit=6, view_shape=(33, 33))),
                           (1000, dict(time_limit=6, auto_reset=False))):
                env = BatchedSafeLifeEnv(EnvConfig(**cfg), device=dev)
                resets = rollout_check(env, bank, b, gen,
                                       f"{side}x{side} {rule} {cfg}",
                                       steps=8)
                print(f"K2/K3 advance == plain: {side}x{side} ({rule} rule, "
                      f"{variant}) B={b} {cfg}, 8 steps, {resets} resets")


def check_misaligned(kw, what):
    """K1 + K2/K3 with every input board 2 bytes off a 16-byte boundary:
    the 2-byte path of both kernels."""
    args = esk.kernel_args(**kw)
    for key in ("board", "goals", "init_board"):
        args[key] = misaligned(args[key])
    if args["fresh"] is not None:
        args["fresh"] = tuple(map(misaligned, args["fresh"]))
    assert_bit_equal(esk.run_kernels(args), esk.run_kernels(args, plain=True),
                     f"K1+K2/K3 misaligned boards, {what}")


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
    """S3 and S5 in every variant against their plain versions: full-range
    and small values, shifts beyond the board both ways, odd batches; S3
    also on boards 2 bytes off a 16-byte boundary (the 2-byte path) and
    on 128x128 boards (no slab fits: the streamed variant); S5 also at B
    = 65536, on 25x27, 72x72 and 100x100 boards and on 1x1 and 3x5 boards
    (a block of fewer walks than environments), all staged, and on
    128x128 boards (streamed), each board also 2 bytes off a 16-byte
    boundary."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)

    def u16(shape, high=2**16):
        return torch.randint(0, high, shape, generator=gen, device=dev,
                             dtype=torch.int32).to(torch.uint16)

    def shifts(batch):
        return torch.randint(-40, 40, (2, batch), generator=gen, device=dev,
                             dtype=torch.int32)

    s5 = collections.defaultdict(set)
    for shape in ((26, 26, b), (26, 26, MAIN_BATCH), (26, 26, 1004),
                  (26, 26, 1001), (26, 26, 33), (26, 26, 7), (25, 27, 104),
                  (72, 72, 96), (100, 100, 64), (1, 1, 8), (3, 5, 12),
                  (128, 128, 64)):
        batch = shape[2]
        x = u16(shape)
        if shape[:2] == (26, 26) and batch != MAIN_BATCH:
            si = shifts(batch)
            for compute in om.COMPUTES:
                for view in (om.VIEW, (33, 33), (9, 31)):
                    for board in (x, misaligned(x)):
                        assert_bit_equal(
                            [om.view_crop(board, si, compute, view)],
                            [om.view_crop_plain(board, si, compute, view)],
                            f"S3 {compute} view {view} B={batch}")
        small = (x.to(torch.int32) & 15).to(torch.uint16)
        for dtype in om.WIDTHS:
            if batch % om._LANES[dtype]:
                continue
            for planes in om.PLANES:
                geo = om.nbsum_geometry(*shape, dtype, planes)
                s5[f"{dtype}x{planes}"].add(
                    f"{shape}: " + (f"E={geo['envs']}" if geo["staged"]
                                    else "streamed"))
                for board in (small, x, misaligned(x)):
                    assert_bit_equal(
                        [om.nb_sum_planes(board, dtype, planes)],
                        [om.nb_sum_planes_plain(board, dtype, planes)],
                        f"S5 {dtype} x{planes} {shape}")
    big = u16((128, 128, 64))
    assert not om.crop_geometry(128, 128, 64)["staged"]
    assert not om.nbsum_geometry(128, 128, 64, "int32", 1)["staged"]
    si = shifts(64)
    for compute in om.COMPUTES:
        assert_bit_equal([om.view_crop(big, si, compute)],
                         [om.view_crop_plain(big, si, compute)],
                         f"S3 {compute} streamed")
    geo = om.crop_geometry(26, 26, b)
    print(f"S3 crop, S5 neighbour sum == plain: every variant at "
          f"(26,26,{b}), 1004, 1001, 33 and 7 environments; S3 at views "
          f"15x15, 33x33 and 9x31, staged (E={geo['envs']}) on aligned and "
          "misaligned boards, streamed on (128,128,64); S5 on aligned and "
          "misaligned boards, by variant: "
          + "; ".join(f"{k} {sorted(v)}" for k, v in s5.items()))


def check_obs_sum(dev):
    """R1 against its plain version: the main path's observation at B =
    65536, uint8 and uint16 tensors of full-range values (the int32 sum
    wraps) whose lengths are not multiples of 16, each also one element
    off a 16-byte boundary."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    bank = load_bank("append-still", dev)
    env = BatchedSafeLifeEnv(EnvConfig(view_shape=VIEW), device=dev)
    state = env.reset_all(bank, MAIN_BATCH, gen)
    action = torch.randint(0, 9, (MAIN_BATCH,), generator=gen, device=dev,
                           dtype=torch.int32)
    obs = env.step(state, bank, action, gen)[1].obs
    tensors = {"the step's observation": obs,
               "the step's observation, one byte off":
                   obs.reshape(-1)[1:]}
    for dtype, high in ((torch.uint8, 256), (torch.uint16, 2**16)):
        for n in (1, 15, 17, 12345, 221184013):
            x = torch.randint(0, high, (n + 1,), generator=gen, device=dev,
                              dtype=torch.int32).to(dtype)
            tensors[f"{dtype} n={n}"] = x[:n]
            tensors[f"{dtype} n={n}, one element off"] = x[1:]
    for what, x in tensors.items():
        assert_bit_equal([obs_ops.obs_sum(x)], [obs_ops.obs_sum_plain(x)],
                         f"R1 {what}")
    print(f"R1 observation sum == plain: {', '.join(tensors)}")


# The view kernel's checks: views, channel lists and batches.
VIEW_SHAPES = ((15, 15), (7, 9), (33, 33), (40, 40))
VIEW_CHANNELS = (tuple(range(15)), (0, 3, 12), (14, 2, 7), tuple(range(16)))
VIEW_BATCHES = (MAIN_BATCH, 4096, 1001, 33, 7)


def check_view(dev):
    """The view kernel against its plain versions: S4 (KEEP, both compute
    names) and the step's unpack (UNPACK) under every channel list, at
    every view and batch of VIEW_SHAPES and VIEW_BATCHES (33x33: narrow
    stores; 40x40: the streamed variant), on aligned and misaligned
    views."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    paths = set()
    for vh, vw in VIEW_SHAPES:
        for b in VIEW_BATCHES:
            if vh * vw > 15 * 15 and b == MAIN_BATCH:
                continue
            v = torch.randint(0, 2**16, (vh, vw, b), generator=gen,
                              device=dev, dtype=torch.int32).to(torch.uint16)
            for view in (v, misaligned(v)):
                what = f"{vh}x{vw} B={b}" + (
                    "" if view is v else ", misaligned")
                want = obs_ops.transpose_view_plain(view)
                assert_bit_equal([obs_ops.transpose_view(view)], [want],
                                 f"KEEP {what}")
                for c in om.COMPUTES:
                    assert_bit_equal([om.view_transpose(view, c)],
                                     [om.view_transpose_plain(view, c)],
                                     f"S4 {c} {what}")
                for channels in VIEW_CHANNELS:
                    want = obs_ops.unpack_channels_plain(view, channels)
                    assert_bit_equal(
                        [obs_ops.unpack_channels(view, channels)], [want],
                        f"UNPACK {channels} {what}")
                    geo = obs_ops.view_geometry(
                        vh, vw, b, channels, _build.vector_path(b, view))
                    paths.add(("E={envs} {stage} staging, {store} stores"
                               .format(envs=geo["envs"],
                                       stage=("16-byte" if geo["vector"]
                                              else "2-byte"),
                                       store=("bulk" if geo["bulk"]
                                              else "narrow")))
                              if geo["staged"] else "streamed")
    print(f"S4 KEEP and the step's UNPACK == plain: views "
          f"{VIEW_SHAPES}, channels {VIEW_CHANNELS}, B {VIEW_BATCHES}, "
          f"aligned and misaligned; paths {sorted(paths)}")


def check_k1_blocks(dev):
    """K1 at every block width against its plain version."""
    rng_ = np.random.RandomState(8)
    for shape in ((26, 26, SCRIPT_BATCH), (3, 5, 1001), (26, 26, 33)):
        si, board = action_inputs(rng_, shape, dev)
        want = esk.action_plain(si, board)
        for block in esk.ACTION_BLOCKS:
            assert_bit_equal(esk.apply_action(si, board, block), want,
                             f"K1 block {block} {shape}")
    print(f"K1 action == plain at block widths {esk.ACTION_BLOCKS}: random "
          f"states, (26,26,{SCRIPT_BATCH}), (3,5,1001) and (26,26,33)")


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
        # The observation of every step unpacked by the view kernel and
        # summed by R1.
        assert launches.get("S4_view_unpack") == MAIN_STEPS, launches
        assert launches.get("R1_obs_sum") == MAIN_STEPS, launches
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
    assert eval_launches.get("S4_view_unpack") == EVAL_STEPS, eval_launches
    print(f"evaluation path (no auto-reset): B={MAIN_BATCH} {EVAL_STEPS} "
          f"steps; launches {eval_launches}")

    packed_env = BatchedSafeLifeEnv(EnvConfig(
        view_shape=VIEW, output_channels=None), device=dev)
    _, packed_launches = counted(lambda: suite_steps(packed_env, still, dev))
    assert packed_launches.get("S4_view_keep") == SUITE_STEPS, (
        packed_launches)
    print(f"packed observation (output_channels=None): {SUITE_STEPS} steps "
          f"at B=4096 through the view kernel's KEEP; launches "
          f"{packed_launches}")

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
        if env.config.output_channels is None:
            assert ts.obs.shape == (b, *VIEW), ts.obs.shape
        else:
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


def bound_and_estimate(moved, ops, rate, int32_rate):
    """(bound ms, "bytes" or "operations", INT32 estimate ms): the bound
    is the larger of ``moved`` bytes at the memory ``rate`` and ``ops`` at
    PEAK_OPS; the estimate is ``ops`` at ``int32_rate``."""
    bytes_ms = moved / rate * 1e3
    ops_ms = ops / PEAK_OPS * 1e3
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), bound_by, ops / int32_rate * 1e3


def kernel_timings(banks, dev, rate, int32_rate):
    """{kernel: (max_abs_err, ms, plain_ms, bound_ms, bound_by)}."""
    runs = {}

    def adv(args, fn, board1, act_i):
        return lambda: fn(
            args["si"], args["sf"], act_i, args["obs_i"], board1,
            args["goals"], args["init_board"], args["fresh"],
            args["time_limit"], args["obs_view"], args["remove_white_goals"],
            args["rule"], args["draw"], args["seed"])

    for rule, name in RULE_BANKS.items():
        bank = banks[name] if name in banks else load_bank(name, dev)
        fold, noreset, board1, act_i = step_inputs(bank, dev)
        assert fold["rule"] == rule, (rule, fold["rule"])
        si = fold["si"]
        done = ((si[7] + 1 > fold["time_limit"]) | (si[4] != 0)
                | (act_i[3] != 0))
        h, w, b = board1.shape
        out = adv(fold, esk.advance, board1, act_i)()
        if rule == "static_spawnless":
            runs.update(observation_runs(out[3], name))
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
    for name, (kernel, plain, moved, draws, what, *ops) in runs.items():
        got, want = kernel(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = assert_bit_equal(got, want, f"{name} at the main shapes")
        ms = time_ms(kernel, 50)
        plain_ms = time_ms(plain, 3)
        cells = 26 * 26 * MAIN_BATCH
        ops = ops[0] if ops else (OPS_PER_CELL[name] * cells
                                  + OPS_PER_DRAW * draws)
        bound, bound_by, int32_ms = bound_and_estimate(moved, ops, rate,
                                                     int32_rate)
        out[name] = (err, ms, plain_ms, bound, bound_by)
        print(f"timing {name}: max abs err {err} vs plain; "
              f"{ms:.4f} ms (plain {plain_ms:.4f} ms), "
              f"bound {bound:.4f} ms by {bound_by} "
              f"({moved / 1e6:.1f} MB, {ops / 1e9:.2f} G ops, {draws} draw "
              f"cells), {bound / ms:.1%} of the bound; INT32 estimate "
              f"{int32_ms:.4f} ms ({int32_ms / ms:.1%}); {what}")
    return out


def observation_runs(packed, name):
    """The step's unpack (the view kernel's UNPACK) on the packed view K2
    wrote, and R1 on its output; their operations: a shift and a mask an
    output byte, an addition an element."""
    channels = tuple(range(15))
    obs = obs_ops.unpack_channels(packed, channels)
    what = f"{name}'s packed view {tuple(packed.shape)}, 15 channels"
    return {
        "S4_view_unpack": (
            lambda: obs_ops.unpack_channels(packed, channels),
            lambda: obs_ops.unpack_channels_plain(packed, channels),
            nbytes(packed, obs), 0, what, 2 * obs.numel()),
        "R1_obs_sum": (
            lambda: obs_ops.obs_sum(obs), lambda: obs_ops.obs_sum_plain(obs),
            nbytes(obs) + 4, 0, f"its observation {tuple(obs.shape)}",
            obs.numel()),
    }


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


def profile(name, bank, state, steps=ROLLOUT, shapes=False):
    """Device time by kernel over ``steps`` main-path steps (a multiple of
    ROLLOUT), and the share of the host-clock wall time in which the
    device ran no kernel; with ``shapes``, also the step's copies, masks
    and tests by input shape (recording shapes slows the host, so that
    run's wall is not the step's)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    dev = state.device
    env = BatchedSafeLifeEnv(EnvConfig(view_shape=VIEW), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       record_shapes=shapes) as prof:
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
    for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {ms / steps:8.4f} ms/step  {ms / busy_ms:6.1%}  {kname[:90]}")
    print("  by the torch op that launched it:")
    ops = [(e.self_device_time_total / 1e3, e.key)
           for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]
    for ms, op in sorted(ops, reverse=True)[:8]:
        print(f"  {ms / steps:8.4f} ms/step  {ms / busy_ms:6.1%}  {op}")
    if not shapes:
        return
    print("  copies, masks and tests by input shapes:")
    shaped = [(e.self_device_time_total / 1e3, e.key, e.input_shapes)
              for e in prof.key_averages(group_by_input_shape=True)
              if e.key in ("aten::copy_", "aten::bitwise_and", "aten::ne")
              and e.self_device_time_total > 0]
    for ms, op, shapes in sorted(shaped, reverse=True)[:6]:
        print(f"  {ms / steps:8.4f} ms/step  {op} {str(shapes)[:100]}")


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


def script_runs(dev, b=SCRIPT_BATCH):
    """{kernel: (kernel fn, plain fn, input, chained, library fn or None,
    bytes moved, operations, what)} at the scripts' shapes, or only S3-S5
    at another batch ``b``."""
    cells = 26 * 26 * b
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    still = load_bank("append-still", dev)
    board = still.take(torch.arange(b, device=dev) % still.num_levels).board
    runs = {}
    actions = [("S1_action_only", 8, None)] + [
        (f"S2_action_block[{n}]", 9, n) for n in esk.ACTION_BLOCKS]
    for name, rows, block in actions if b == SCRIPT_BATCH else ():
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


def script_timings(dev, rate, int32_rate, b=SCRIPT_BATCH):
    """{kernel: (max_abs_err, ms, plain_ms, bound_ms, bound_by,
    library_ms)} at the scripts' shapes, or S3-S5 at batch ``b``."""
    out = {}
    for name, (kernel, plain, x, chain, library, moved, ops,
               what) in script_runs(dev, b).items():
        if b != SCRIPT_BATCH and name[:2] not in ("S3", "S4", "S5"):
            continue
        err = assert_bit_equal([kernel(x)], [plain(x)],
                               f"{name} at B={b}")
        ms = time_chain(kernel, x, 200, chain, graph=True)
        loop_ms = time_chain(kernel, x, 200, chain)
        plain_ms = time_chain(plain, x, 3, False)
        library_ms = (time_chain(lambda _: library(), None, 200, False,
                                 graph=True) if library else None)
        bound, bound_by, int32_ms = bound_and_estimate(moved, ops, rate,
                                                     int32_rate)
        out[name] = (err, ms, plain_ms, bound, bound_by, library_ms)
        lib = f", library {library_ms:.4f} ms" if library else ""
        at = "" if b == SCRIPT_BATCH else f" B={b}"
        print(f"timing {name}{at}: max abs err {err} vs plain; {ms:.4f} ms "
              f"in a CUDA graph, {loop_ms:.4f} ms launched from Python "
              f"(plain {plain_ms:.4f} ms{lib}), bound {bound:.6f} ms by "
              f"{bound_by} ({moved / 1e6:.3f} MB, {ops / 1e9:.3f} G ops), "
              f"{bound / ms:.1%} of the bound; INT32 estimate "
              f"{int32_ms:.6f} ms; {what}")
    return out


def t1_floor(dev):
    """T1's launch floor: an empty kernel with T1's grid, block and
    arguments (``sl_philox_floor``), launched and graphed as T1 is timed in
    phase 7."""
    seed = torch.tensor([integrity.PROBE_SEED], dtype=torch.int32,
                        device=dev)
    h, w, b = integrity.PROBE_SHAPE
    out = torch.empty((h, w, b), dtype=torch.int32, device=dev)

    def empty(s):
        _build.launch("T1_launch_floor", "philox_words", "sl_philox_floor",
                      s.data_ptr(), out.data_ptr(), h, w, b)
        return out

    ms = time_chain(empty, seed, 200, False, graph=True)
    t1 = time_chain(lambda s: rng.philox_words(s, (h, w, b)), seed, 200,
                    False, graph=True)
    print(f"T1 launch floor: an empty kernel of T1's grid ({(h, w, b)}) in "
          f"a CUDA graph {ms:.6f} ms; T1 {t1:.6f} ms in the same way")


def k1_state_probe(bank, dev):
    """K1 at the main path's width on the phase-6 state, in a CUDA graph:
    as it is, with every agent moved to (0, 0) (the four cells the decode
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


# ---------------------------------------------------------------------------
# Phase 8: the training path.
# ---------------------------------------------------------------------------

TRAIN_VIEW = (33, 33)
TRAIN_ENVS = (64, 4096)   # the CLI's default, and a wide batch
TRAIN_BATCHES = 3
# Schedules of the global step, evaluated on the device every step.
TRAIN_PENALTY = W.linear_schedule([0, 40_000], [0.0, 1.0])
TRAIN_MIN_PERF = W.linear_schedule([0, 40_000], [0.5, 0.1])
# The trunk's float32 convolutions and matmuls on the card (TF32 off)
# against the CPU's: cuDNN sums in other orders.
F32_TOL = dict(rtol=1e-4, atol=1e-5)
# The trunk in bfloat16 (8 significant bits) against float32.
BF16_TOL = dict(rtol=3e-2, atol=2e-2)


def core_env(env):
    while hasattr(env, "env"):
        env = env.env
    return env


def step_fields(state, ts):
    """The step's outputs (obs, rewards after the wrappers, done, the
    side-effect count, episode stats), the wrappers' extra state and the
    core state's leaves, by name."""
    out = {f"ts.{f.name}": getattr(ts, f.name)
           for f in dataclasses.fields(ts) if f.name != "state_before_reset"}
    depth = 0
    while isinstance(state, W.WrapperState):
        # (The movement bonus's step index is a host int.)
        out.update({f"extra{depth}.{k}": torch.as_tensor(v)
                    for k, v in state.extra.items()})
        state, depth = state.inner, depth + 1
    out.update({f"state.{f.name}": getattr(state, f.name)
                for f in dataclasses.fields(state)})
    return out


def check_training_env(dev, steps=ROLLOUT):
    """The training wrapper stack at the 33x33 view through K1, K2 and the
    view kernel's UNPACK against the same stack on the plain step, bit for
    bit: the same actions, fresh levels and generator seeds."""
    cfg = driver.TrainerConfig(view_shape=TRAIN_VIEW, time_limit=8,
                               impact_penalty=TRAIN_PENALTY,
                               min_performance=TRAIN_MIN_PERF)
    for suite in ("append-still", "append-dynamic"):
        bank = load_bank(suite, dev)
        for b in (4096, 1001, 7):
            kern = driver.make_training_env(cfg, dev)
            plain = driver.make_training_env(cfg, dev)
            core_env(plain).config = dataclasses.replace(
                core_env(plain).config, use_kernels=False)
            assert core_env(kern).uses_kernels()
            assert not core_env(plain).uses_kernels()
            gen = torch.Generator(device=dev)
            gen.manual_seed(7)
            actions = torch.randint(0, 9, (steps, b), generator=gen,
                                    device=dev)
            fresh = core_env(kern).sample_fresh_levels(bank, b, gen)
            states = [env.reset_all(bank, b, gen.manual_seed(8))
                      for env in (kern, plain)]
            gens = [torch.Generator(device=dev).manual_seed(9)
                    for _ in range(2)]
            resets = 0
            for t in range(steps):
                out = []
                for i, env in enumerate((kern, plain)):
                    states[i], ts = env.step(states[i], bank, actions[t],
                                             gens[i], fresh_levels=fresh)
                    out.append(step_fields(states[i], ts))
                got, want = out
                assert got.keys() == want.keys()
                for name in want:
                    assert_bit_equal([got[name]], [want[name]],
                                     f"training stack {suite} B={b} step "
                                     f"{t}: {name}")
                resets += int(got["ts.done"].sum())
            assert resets > 0
        print(f"training stack (MovementBonus, SideEffectPenalty with "
              f"scheduled coefficients, Continuing) at view {TRAIN_VIEW}: "
              f"{suite}, B = 4096, 1001, 7, {steps} steps with resets, "
              f"kernels == plain step bit for bit (obs, rewards, done, "
              f"side effects, episode stats, extras, state)")


def check_model(dev, b=1024):
    """The net on the card against the net on the CPU, the same weights:
    float32 with TF32 off, and the bfloat16 trunk (autocast) against
    float32."""
    gen = torch.Generator().manual_seed(3)
    obs = (torch.rand((b, *TRAIN_VIEW, 15), generator=gen) < 0.2).to(
        torch.uint8)
    cpu = model.SafeLifeCNN(view_shape=TRAIN_VIEW,
                            compute_dtype=torch.float32, generator=gen)
    with torch.no_grad():
        want = cpu(obs)
    errs = {}
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            net = model.SafeLifeCNN(view_shape=TRAIN_VIEW,
                                    compute_dtype=dtype).to(dev)
            net.load_state_dict(cpu.state_dict())
            with torch.no_grad():
                got = net(obs.to(dev))
            for g, w, what in zip(got, want, ("logits", "values")):
                torch.testing.assert_close(g.cpu(), w, **tol,
                                           msg=f"{dtype} {what}")
            errs[str(dtype)] = max(max_abs_err([g.cpu()], [w])
                                   for g, w in zip(got, want))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    print(f"model on the card against the CPU at B={b}, view {TRAIN_VIEW}: "
          f"float32 (TF32 off) max abs err {errs['torch.float32']:.3g} "
          f"(tolerance {F32_TOL}); bfloat16 trunk {errs['torch.bfloat16']:.3g}"
          f" (tolerance {BF16_TOL})")


def make_trainer(dev, num_envs, logdir, **kw):
    return driver.Trainer(
        driver.TrainerConfig(num_envs=num_envs, view_shape=TRAIN_VIEW,
                             report_every=num_envs * ROLLOUT,
                             save_every=10**9, record_videos=False,
                             logdir=logdir, **kw),
        ppo.PPOConfig(), level_paths=("benchmarks/v1.0/append-still",),
        device=dev)


def train_path(dev, logdir):
    """Trainer on append-still at the 33x33 view: TRAIN_BATCHES batches at
    each of TRAIN_ENVS, with PPOConfig() defaults; returns the launches of
    those runs."""
    launches = collections.Counter()
    for n in TRAIN_ENVS:
        run = f"{logdir}/run{n}"
        trainer = make_trainer(dev, n, run)
        before = {k: v.clone() for k, v in trainer.net.state_dict().items()}
        reports = []
        t = time.perf_counter()
        # Two batches leave the global step short of this; the third
        # passes it (only episodes that ended drop steps from the count).
        _, run_launches = counted(lambda: trainer.train(
            total_steps=(TRAIN_BATCHES - 1) * ROLLOUT * n + 1,
            progress_fn=lambda s, m: reports.append(m)))
        seconds = time.perf_counter() - t
        launches.update(run_launches)
        assert trainer.train_state.update_step == TRAIN_BATCHES
        assert len(reports) == TRAIN_BATCHES
        for m in reports:
            for k in ("policy_loss", "value_loss", "entropy",
                      "pseudo_entropy", "mean_reward"):
                assert np.isfinite(m[k]).all(), (k, m[k])
        after = trainer.net.state_dict()
        changed = [k for k in after if not torch.equal(before[k], after[k])]
        assert len(changed) == len(after), changed
        assert trainer.train_state.spe.item() != 1.0
        for name in ("K1_action", "K2_advance_fold[static_spawnless]",
                     "S4_view_unpack"):
            assert run_launches.get(name, 0) >= TRAIN_BATCHES * ROLLOUT, (
                name, run_launches)
        # The checkpoint train() wrote at its end restores the same net.
        again = make_trainer(dev, n, run)
        assert again.restore_checkpoint()
        for k, v in after.items():
            assert torch.equal(again.net.state_dict()[k], v), k
        assert again.train_state.spe.item() == trainer.train_state.spe.item()
        assert again.global_step() == trainer.global_step()
        policy, view = driver.load_policy(run, dev)
        actions = policy(trainer.obs, torch.Generator(dev).manual_seed(0))
        assert view == TRAIN_VIEW and actions.shape == (n,)
        assert 0 <= int(actions.min()) and int(actions.max()) < 9
        last = reports[-1]
        print(f"trainer: append-still, {n} envs, view {TRAIN_VIEW}, "
              f"PPOConfig() defaults: {TRAIN_BATCHES} batches "
              f"({trainer.global_step()} env steps) in {seconds:.2f} s with "
              f"the integrity checks and a checkpoint; last batch "
              f"policy_loss {float(last['policy_loss']):.5g}, value_loss "
              f"{float(last['value_loss']):.5g}, entropy "
              f"{float(last['entropy']):.5g}, spe "
              f"{trainer.train_state.spe.item():.5g}; checkpoint restored "
              f"bit for bit; load_policy drew {n} actions; launches "
              f"{run_launches}")
    return launches


def learner_throughput(dev, smi, batches=3):
    """Env-steps/s of train_batch (rollout + GAE + update) at each of
    TRAIN_ENVS, ms a batch of the rollout and of the update, and a profile
    of one batch at the widest."""
    for n in TRAIN_ENVS:
        trainer = make_trainer(dev, n, None)
        ts, ppo_ = trainer.train_state, trainer.ppo
        state, obs, gen = trainer.env_state, trainer.obs, trainer.generator
        state, obs, _ = ppo_.train_batch(ts, state, obs, trainer.bank, gen)
        torch.cuda.synchronize()

        def run():
            out = state, obs
            for _ in range(batches):
                out = ppo_.train_batch(ts, *out, trainer.bank, gen)[:2]
            return out

        t = time.perf_counter()
        (state, obs), launched = counted(run)
        wall = (time.perf_counter() - t) / batches
        per_batch = {k: v / batches for k, v in launched.items()}
        roll_ms = upd_ms = 0.0
        for _ in range(batches):
            t = time.perf_counter()
            state, obs, traj, _ = ppo.rollout(ppo_.cfg, ts.net, ppo_.env,
                                              trainer.bank, state, obs, gen)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            ret, adv = ppo.compute_gae(ppo_.cfg, traj.reward, traj.done,
                                       traj.value)
            ppo_.update(ts, traj, ret, adv, gen)
            torch.cuda.synchronize()
            roll_ms += (t2 - t) * 1e3 / batches
            upd_ms += (time.perf_counter() - t2) * 1e3 / batches
        print(f"learner env-steps/s (rollout + GAE + update, PPOConfig() "
              f"defaults, view {TRAIN_VIEW}, append-still) at {n} envs: "
              f"{n * ROLLOUT / wall:.0f} ({wall * 1e3:.2f} ms a batch of "
              f"{n * ROLLOUT} env steps; rollout {roll_ms:.2f} ms, GAE + "
              f"update {upd_ms:.2f} ms); launches a batch {per_batch} on "
              f"{smi}")
    profile_batch(trainer, state, obs)


def profile_batch(trainer, state, obs):
    """Device time by kernel over one train_batch, K2's and the unpack's
    shares, and the idle share of the wall."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.ppo.train_batch(trainer.train_state, state, obs,
                                trainer.bank, trainer.generator)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    assert busy > 0, "the profiler recorded no device time"
    share = lambda frag: sum(ms for k, ms in by_name.items()  # noqa: E731
                             if frag in k) / busy
    n = trainer.cfg.num_envs
    print(f"profile of one train_batch at {n} envs: wall {wall_ms:.2f} ms, "
          f"device busy {busy:.2f} ms, idle share {1 - busy / wall_ms:.1%}; "
          f"K2 advance_kernel {share('advance_kernel'):.2%}, view kernel "
          f"(UNPACK) {share('view_kernel'):.2%}, K1 action_kernel "
          f"{share('action_kernel'):.2%} of the device time")
    print("  top device ops:")
    for kname, ms in by_name.most_common(12):
        print(f"  {ms:9.3f} ms  {ms / busy:6.1%}  {kname[:100]}")


def training(dev, smi):
    """Phase 8; returns the training path's launches."""
    check_training_env(dev)
    check_model(dev)
    with tempfile.TemporaryDirectory() as logdir:
        launches = train_path(dev, logdir)
        learner_throughput(dev, smi)
    return launches


# ---------------------------------------------------------------------------
# Phase 9: suite evaluation, side-effect scoring and the recurrent policy.
# ---------------------------------------------------------------------------

# Kernel path against plain path on every v1.0 suite.
EVAL_VIEW = (25, 25)
EVAL_TIME_LIMIT = 50
EVAL_SAMPLES = 16
# Both paths run the same draws, so the distributions are bit-equal and
# the Sinkhorn chains see the same inputs on one device.
EVAL_SCORE_RTOL = 1e-5
# Full width: the training view, the time limit and TrainerConfig's
# side-effect samples, on a static spawnless suite and a Philox-draw one.
FULL_SUITES = ("append-still", "prune-spawn")
FULL_TIME_LIMIT = 1000
FULL_SAMPLES = driver.TrainerConfig().eval_side_effect_samples
# Sinkhorn in float32 on the card against float64 on the CPU (200
# iterations of a contraction; the Gibbs kernel reaches 2e-22, which
# float32 holds).
SINKHORN_RTOL = 1e-5
# The LSTM net on the card against the CPU in float32 (TF32 off): cuDNN
# and cuBLAS sum in other orders.
LSTM_F32_TOL = dict(rtol=1e-5, atol=1e-5)
EVAL_KERNELS = ("K1_action", "S4_view_unpack", "K5_advance_with_field")


def hash_policy(obs, generator=None):
    """A deterministic policy: a weighted sum of the observation, mod 9."""
    c = obs.shape[-1]
    weights = 1 + torch.arange(c, dtype=torch.int32, device=obs.device)
    return (obs.to(torch.int32) * weights).sum((1, 2, 3)) % 9


def eval_launches(launched, bank, steps, catch_up, samples):
    """Assert the launches of one suite eval on the kernels: K1 and K3 once
    a step, UNPACK once a step and once for the first observation, K5 once
    a catch-up step and twice a sample."""
    rule = rule_of(bank)
    want = {"K1_action": steps, f"K3_advance_noreset[{rule}]": steps,
            "S4_view_unpack": steps + 1,
            "K5_advance_with_field": catch_up + 2 * samples if samples else 0}
    for name, n in want.items():
        assert launched.get(name, 0) == n, (name, n, launched)


def check_eval_paths(dev, smi):
    """Every v1.0 suite through run_benchmark on the kernels and on the
    plain path (the plain step with the kernels' Philox fields, the plain
    co-evolution), the same generator seeds: records and occupancy
    distributions bit for bit, scores within EVAL_SCORE_RTOL."""
    from safelife_torch import benchmarking, side_effects as se
    launches = collections.Counter()
    kw = dict(view_shape=EVAL_VIEW, time_limit=EVAL_TIME_LIMIT,
              side_effect_samples=EVAL_SAMPLES, device=dev)
    worst = 0.0
    for suite in SUITES:
        bank = load_bank(suite, dev, num_levels=100)
        out = {}
        for use_kernels in (True, False):
            gen = torch.Generator(dev).manual_seed(11)
            out[use_kernels] = counted(lambda: benchmarking.run_benchmark(
                suite, hash_policy, generator=gen, use_kernels=use_kernels,
                **kw))
            # The same play again for the distributions.
            env = BatchedSafeLifeEnv(EnvConfig(
                view_shape=EVAL_VIEW, time_limit=EVAL_TIME_LIMIT,
                auto_reset=False, use_kernels=use_kernels), device=dev)
            gen.manual_seed(11)
            _, state = benchmarking.play_suite(env, bank, hash_policy,
                                               bank.num_levels, gen)
            dists = se.accumulate_distributions(
                state.init_board, state.board, state.spawn_prob,
                state.episode_length, EVAL_SAMPLES, gen,
                catch_up_steps=EVAL_TIME_LIMIT, use_kernels=use_kernels)
            out[use_kernels] += (dists,)
        (kern, launched, kdist), (plain, plain_launched, pdist) = (
            out[True], out[False])
        for name in ("length", "reward", "completed", "possible",
                     "performance"):
            assert kern[name].dtype == plain[name].dtype, name
            assert np.array_equal(kern[name], plain[name]), (suite, name)
        assert_bit_equal(kdist, pdist, f"occupancy distributions {suite}")
        for name in ("side_effects", "side_effect_mass"):
            np.testing.assert_allclose(kern[name], plain[name],
                                       rtol=EVAL_SCORE_RTOL, atol=0,
                                       err_msg=f"{suite} {name}")
            diff = np.abs(kern[name] - plain[name])
            worst = max(worst, float((diff / np.maximum(
                np.abs(plain[name]), 1e-30)).max()))
        steps = launched["K1_action"]
        assert steps % 64 == 0 and steps >= EVAL_TIME_LIMIT, launched
        eval_launches(launched, bank, steps, EVAL_TIME_LIMIT, EVAL_SAMPLES)
        for name in ("K1_action", "K5_advance_with_field"):
            assert name not in plain_launched, (name, plain_launched)
        assert not any(k.startswith("K3") for k in plain_launched)
        launches.update(launched)
        print(f"eval {suite} ({rule_of(bank)} rule): 100 levels, view "
              f"{EVAL_VIEW}, time limit {EVAL_TIME_LIMIT}, "
              f"{EVAL_SAMPLES} side-effect samples: kernels == plain "
              f"(records and occupancy distributions bit for bit); mean "
              f"performance {kern['performance'].mean():.4f}, mean side "
              f"effects {kern['side_effects'].mean():.4f}; launches "
              f"{launched} on {smi}")
    print(f"eval kernel path against plain path on the {len(SUITES)} v1.0 "
          f"suites: largest relative score difference {worst:.3g} "
          f"(tolerance rtol {EVAL_SCORE_RTOL}) on {smi}")
    return launches


def check_k5_eval_shape(dev, bank, smi):
    """K5 at the co-evolution's shape (one board a level) against its plain
    version, with a torch.rand field at the suite's spawn rates; and its
    time beside the plain version's."""
    gen = torch.Generator(dev).manual_seed(12)
    board = bank.board
    prob = bank.spawn_prob.to(torch.float32)[None, None, :]
    field = torch.rand(board.shape, generator=gen, device=dev) < prob
    got = life_kernels.advance_with_field(board, field)
    want = life_kernels.advance_with_field_plain(board, field)
    assert_bit_equal([got], [want], "K5 at the co-evolution's shape")
    ms = time_ms(lambda: life_kernels.advance_with_field(board, field), 200)
    plain_ms = time_ms(
        lambda: life_kernels.advance_with_field_plain(board, field), 20)
    print(f"K5 at the co-evolution's shape {tuple(board.shape)}: bit-equal "
          f"to plain; {ms:.4f} ms a launch (plain {plain_ms:.4f} ms) on "
          f"{smi}")


def check_sinkhorn(dev, smi):
    """The Sinkhorn EMD on the card (float32) against a float64 CPU
    computation of the same iteration, on 26x26 grids; TF32 stays off
    inside it whatever the caller set."""
    from safelife_torch import side_effects as se
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 is on"
    rng_ = np.random.RandomState(13)
    n, rows = 26 * 26, 64
    a = np.zeros((rows, n), np.float32)
    b = np.zeros((rows, n), np.float32)
    for r in range(rows):
        for x in (a, b):
            pts = rng_.choice(n, rng_.randint(1, 40), replace=False)
            x[r, pts] = rng_.rand(len(pts))
    b[5] = a[5]
    a[7] = 0.0
    cost = se.torus_distances((26, 26))
    got = se.sinkhorn_emd(torch.as_tensor(a, device=dev),
                          torch.as_tensor(b, device=dev), cost)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        again = se.sinkhorn_emd(torch.as_tensor(a, device=dev),
                                torch.as_tensor(b, device=dev), cost)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert_bit_equal([again], [got], "Sinkhorn with TF32 asked for")
    want = sinkhorn_f64(a.astype(np.float64), b.astype(np.float64), cost)
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=SINKHORN_RTOL,
                               atol=0)
    rel = np.abs(got.cpu().numpy() - want) / np.maximum(np.abs(want), 1e-30)
    print(f"Sinkhorn EMD on the card (float32, TF32 off) against float64 "
          f"on the CPU, {rows} rows of 26x26: largest relative difference "
          f"{rel.max():.3g} (tolerance rtol {SINKHORN_RTOL}); the same bits "
          f"when the caller turns TF32 on; on {smi}")


def sinkhorn_f64(a, b, cost, eps=0.02, iters=200, penalty=1.0):
    """The Sinkhorn iteration of ``side_effects.sinkhorn_emd`` in float64
    numpy, written out again as the reference."""
    n = cost.shape[0]
    sum_a, sum_b = a.sum(-1, keepdims=True), b.sum(-1, keepdims=True)
    a1 = np.concatenate([a, np.maximum(sum_b - sum_a, 0)], -1)
    b1 = np.concatenate([b, np.maximum(sum_a - sum_b, 0)], -1)
    cost1 = np.full((n + 1, n + 1), penalty)
    cost1[:n, :n] = cost
    cost1[n, n] = 0.0
    total = a1.sum(-1, keepdims=True)
    scale = np.where(total > 0, total, 1.0)
    a1, b1 = a1 / scale, b1 / scale
    kern = np.exp(-cost1 / eps)
    u = np.ones_like(a1)
    for _ in range(iters):
        v = b1 / (u @ kern + 1e-30)
        u = a1 / (v @ kern.T + 1e-30)
    v = b1 / (u @ kern + 1e-30)
    return ((u @ (kern * cost1)) * v).sum(-1) * scale[..., 0]


def full_width_eval(dev, smi):
    """run_benchmark at full width: every level, the 33x33 view, time limit
    1000, TrainerConfig's side-effect samples, a SafeLifeCNN policy."""
    from safelife_torch import benchmarking
    launches = collections.Counter()
    for suite in FULL_SUITES:
        net = model.SafeLifeCNN(
            view_shape=TRAIN_VIEW,
            generator=torch.Generator().manual_seed(0)).to(dev)
        gen = torch.Generator(dev).manual_seed(0)
        t = time.perf_counter()
        res, launched = counted(lambda: benchmarking.run_benchmark(
            suite, driver._sampling_policy(net), generator=gen,
            view_shape=TRAIN_VIEW, time_limit=FULL_TIME_LIMIT,
            side_effect_samples=FULL_SAMPLES, device=dev))
        seconds = time.perf_counter() - t
        bank = load_bank(suite, dev, num_levels=100)
        eval_launches(launched, bank, launched["K1_action"], FULL_TIME_LIMIT,
                      FULL_SAMPLES)
        for name in ("performance", "reward", "side_effects",
                     "side_effect_mass"):
            assert np.isfinite(res[name]).all(), name
        assert len(res["performance"]) == 100
        coevolution, sinkhorn = res["side_effect_time"]
        launches.update(launched)
        print(f"suite eval at full width: {suite}, 100 levels, view "
              f"{TRAIN_VIEW}, time limit {FULL_TIME_LIMIT}, {FULL_SAMPLES} "
              f"side-effect samples, SafeLifeCNN policy (seed 0): "
              f"{seconds:.2f} s in all; step loop {res['wall_time']:.2f} s "
              f"({launched['K1_action']} steps); side effects "
              f"{coevolution + sinkhorn:.2f} s (co-evolution "
              f"{coevolution:.3f} s, Sinkhorn {sinkhorn:.3f} s); mean "
              f"performance {res['performance'].mean():.4f}, reward "
              f"{res['reward'].mean():.4f}, side effects "
              f"{res['side_effects'].mean():.4f}, length "
              f"{res['length'].mean():.1f}; launches "
              f"{ {k: launched[k] for k in sorted(launched)} } on {smi}")
        if suite == "append-still":
            check_k5_eval_shape(dev, bank, smi)
            profile_eval(suite, driver._sampling_policy(net), dev, smi)
    return launches


def profile_eval(suite, policy, dev, smi):
    """Device time by kernel over one suite eval at full width but a
    quarter of the time limit, the shares of the step's kernels, of the
    net and of the side-effect scoring, and the idle share of the wall.
    Device activity only, and the shorter eval: reading the trace of a
    whole one (about 90,000 kernels) took 23 s of host time beside an
    H100."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from safelife_torch import benchmarking
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        benchmarking.run_benchmark(
            suite, policy, generator=torch.Generator(dev).manual_seed(0),
            view_shape=TRAIN_VIEW, time_limit=FULL_TIME_LIMIT // 4,
            side_effect_samples=FULL_SAMPLES, device=dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    by_name = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    assert busy > 0, "the profiler recorded no device time"
    share = lambda *frags: sum(ms for k, ms in by_name.items()  # noqa: E731
                               if any(f in k for f in frags)) / busy
    print(f"profile of one suite eval at full width, time limit "
          f"{FULL_TIME_LIMIT // 4} ({suite}; read in "
          f"{time.perf_counter() - t0:.1f} s): wall "
          f"{wall_ms:.1f} ms, device busy {busy:.2f} ms, idle share "
          f"{1 - busy / wall_ms:.1%}; K3 advance_kernel "
          f"{share('advance_kernel'):.2%}, K1 action_kernel "
          f"{share('action_kernel'):.2%}, view kernel (UNPACK) "
          f"{share('view_kernel'):.2%}, K5 rule_kernel "
          f"{share('rule_kernel'):.2%}, GEMMs (Sinkhorn, the net's dense "
          f"layers) {share('gemm', 'sgemm', 'Kernel2'):.2%} of the device "
          f"time; on {smi}")
    print("  top device ops:")
    for kname, ms in by_name.most_common(12):
        print(f"  {ms:9.3f} ms  {ms / busy:6.1%}  {kname[:100]}")


def check_lstm_model(dev, smi, b=1024):
    """The LSTM net on the card against the CPU, the same weights: float32
    with TF32 off, and the bfloat16 trunk against float32; nn.LSTMCell
    against the plain step on the card."""
    gen = torch.Generator().manual_seed(3)
    obs = (torch.rand((b, *TRAIN_VIEW, 15), generator=gen) < 0.2).to(
        torch.uint8)
    carry = tuple(torch.randn((b, model.LSTM_UNITS), generator=gen) * 0.5
                  for _ in range(2))
    cpu = model.SafeLifeLSTMNet(view_shape=TRAIN_VIEW,
                                compute_dtype=torch.float32, generator=gen)
    with torch.no_grad():
        (c, h), (logits, values) = cpu(obs, carry)
    want = (c, h, logits, values)
    errs = {}
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        for dtype, tol in ((torch.float32, LSTM_F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            net = model.SafeLifeLSTMNet(view_shape=TRAIN_VIEW,
                                        compute_dtype=dtype).to(dev)
            net.load_state_dict(cpu.state_dict())
            with torch.no_grad():
                (c, h), (logits, values) = net(
                    obs.to(dev), tuple(x.to(dev) for x in carry))
            got = (c, h, logits, values)
            for g, w, what in zip(got, want, ("c", "h", "logits", "values")):
                torch.testing.assert_close(g.cpu(), w, **tol,
                                           msg=f"LSTM {dtype} {what}")
            errs[str(dtype)] = max_abs_err([g.cpu() for g in got], want)
        x = torch.randn((b, 1600), generator=gen).to(dev)
        cell = net.lstm
        hc = tuple(t.to(dev) for t in carry)
        with torch.no_grad():
            (c2, h2), _ = model.lstm_step(x, hc, cell.weight_ih,
                                          cell.weight_hh, cell.bias_ih,
                                          cell.bias_hh)
            h1, c1 = cell(x, (hc[1], hc[0]))
        torch.testing.assert_close(c1, c2, **LSTM_F32_TOL)
        torch.testing.assert_close(h1, h2, **LSTM_F32_TOL)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    print(f"LSTM net on the card against the CPU at B={b}, view "
          f"{TRAIN_VIEW}: float32 (TF32 off) max abs err "
          f"{errs['torch.float32']:.3g} (tolerance {LSTM_F32_TOL}); "
          f"bfloat16 trunk {errs['torch.bfloat16']:.3g} (tolerance "
          f"{BF16_TOL}); nn.LSTMCell == plain step within {LSTM_F32_TOL}; "
          f"on {smi}")


def recurrent_path(dev, smi, logdir):
    """A recurrent Trainer on append-still for TRAIN_BATCHES batches at each
    of TRAIN_ENVS, its checkpoint round trip, its learner env-steps/s, and
    load_policy of the run driving run_benchmark with its carry."""
    from safelife_torch import benchmarking
    launches = collections.Counter()
    for n in TRAIN_ENVS:
        run = f"{logdir}/lstm{n}"
        trainer = make_trainer(dev, n, run, recurrent=True)
        before = {k: v.clone() for k, v in trainer.net.state_dict().items()}
        reports = []
        t = time.perf_counter()
        _, run_launches = counted(lambda: trainer.train(
            total_steps=(TRAIN_BATCHES - 1) * ROLLOUT * n + 1,
            progress_fn=lambda s, m: reports.append(m)))
        seconds = time.perf_counter() - t
        launches.update(run_launches)
        assert trainer.train_state.update_step == TRAIN_BATCHES
        for m in reports:
            for k in ("policy_loss", "value_loss", "entropy", "mean_reward"):
                assert np.isfinite(m[k]).all(), (k, m[k])
        after = trainer.net.state_dict()
        changed = {k for k in after if not torch.equal(before[k], after[k])}
        assert changed == set(after) - {"lstm.bias_ih"}, changed
        for name in ("K1_action", "K2_advance_fold[static_spawnless]",
                     "S4_view_unpack"):
            assert run_launches.get(name, 0) >= TRAIN_BATCHES * ROLLOUT, (
                name, run_launches)
        again = make_trainer(dev, n, run, recurrent=True)
        assert again.restore_checkpoint()
        for k, v in after.items():
            assert torch.equal(again.net.state_dict()[k], v), k

        # Learner env-steps/s: TRAIN_BATCHES more batches, timed.
        state, obs, carry = trainer.env_state, trainer.obs, trainer.carry
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(TRAIN_BATCHES):
            state, obs, carry, _ = trainer.ppo.train_batch(
                trainer.train_state, state, obs, carry, trainer.bank,
                trainer.generator)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) / TRAIN_BATCHES
        last = reports[-1]
        print(f"recurrent trainer: append-still, {n} envs, view "
              f"{TRAIN_VIEW}, PPOConfig() defaults: {TRAIN_BATCHES} batches "
              f"in {seconds:.2f} s with the integrity checks and a "
              f"checkpoint (restored bit for bit); last batch policy_loss "
              f"{float(last['policy_loss']):.5g}, value_loss "
              f"{float(last['value_loss']):.5g}, entropy "
              f"{float(last['entropy']):.5g}; learner env-steps/s "
              f"(rollout + GAE + update) {n * ROLLOUT / wall:.0f} "
              f"({wall * 1e3:.2f} ms a batch of {n * ROLLOUT} env steps) on "
              f"{smi}; launches {run_launches}")

    policy, view = driver.load_policy(run, dev)
    assert policy.recurrent and view == TRAIN_VIEW
    gen = torch.Generator(dev).manual_seed(5)
    res, launched = counted(lambda: benchmarking.run_benchmark(
        "append-still", policy, generator=gen, view_shape=view,
        time_limit=EVAL_TIME_LIMIT, side_effect_samples=EVAL_SAMPLES,
        device=dev))
    eval_launches(launched, load_bank("append-still", dev, 100),
                  launched["K1_action"], EVAL_TIME_LIMIT, EVAL_SAMPLES)
    assert np.isfinite(res["reward"]).all()
    assert np.isfinite(res["side_effects"]).all()
    launches.update(launched)
    print(f"load_policy of the recurrent run drove run_benchmark with its "
          f"carry: append-still, time limit {EVAL_TIME_LIMIT}: "
          f"{benchmarking.summarize(res)}; launches {launched} on {smi}")
    return launches


def trainer_eval(dev, smi, logdir):
    """Trainer with eval_suite at 64 envs for 2 batches: evaluate runs once
    (after the last batch), eval.yaml holds the suite's 100 records."""
    import yaml
    run = f"{logdir}/eval"
    trainer = make_trainer(dev, TRAIN_ENVS[0], run,
                           eval_suite="benchmarks/v1.0/append-still")
    evaluated = []
    evaluate = trainer.evaluate
    trainer.evaluate = lambda: (evaluated.append(trainer.global_step())
                                or evaluate())
    t = time.perf_counter()
    _, launched = counted(lambda: trainer.train(
        total_steps=ROLLOUT * TRAIN_ENVS[0] + 1))
    seconds = time.perf_counter() - t
    assert trainer.train_state.update_step == 2
    assert evaluated == [trainer.global_step()], evaluated
    with open(f"{run}/eval.yaml") as fh:
        records = yaml.safe_load(fh)
    assert len(records) == 100, len(records)
    assert all("side_effects_by_type" in r for r in records)
    assert launched.get("K5_advance_with_field") == (
        FULL_TIME_LIMIT + 2 * FULL_SAMPLES), launched
    print(f"trainer with eval_suite append-still: {TRAIN_ENVS[0]} envs, 2 "
          f"batches, {seconds:.2f} s with the eval; evaluate ran once at "
          f"step {evaluated[0]}; eval.yaml holds {len(records)} records; "
          f"integrity checks passed; launches {launched} on {smi}")
    return launched


def evaluation(dev, smi):
    """Phase 9; returns its launches."""
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 is on"
    launches = check_eval_paths(dev, smi)
    check_sinkhorn(dev, smi)
    launches.update(full_width_eval(dev, smi))
    check_lstm_model(dev, smi)
    with tempfile.TemporaryDirectory() as logdir:
        launches.update(recurrent_path(dev, smi, logdir))
        launches.update(trainer_eval(dev, smi, logdir))
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 was left on"
    return launches


# The kernels held to 0 spills, by library: entry-function name fragments
# and how many instantiations the build log must show.  K1: 5 block
# widths; K2/K3: 7 rule pairs x 3 modes x staged or streamed; K4-K8: 5
# kernels x staged or streamed; S3: 2 COMPUTE variants x staged or
# streamed; S5: 3 widths x 2 plane counts x staged or streamed; the view
# kernel: KEEP and UNPACK of 1 to 16 channels staged, KEEP and UNPACK
# streamed; R1: uint8 and uint16.
SPILL_CHECKED = {"env_step_kernels": (("action_kernel", "advance_kernel"), 47),
                 "life_kernels": (("rule_kernel",), 10),
                 "obs_micro": (("crop_kernel", "nbsum_kernel"), 16),
                 "view_kernels": (("view_kernel",), 19),
                 "obs_sum": (("sum_kernel",), 2)}


def spills(built):
    """The checked instantiations of the ``-Xptxas -v`` logs that spill, as
    (entry function, ptxas line)."""
    out = []
    for lib, (names, expected) in SPILL_CHECKED.items():
        kernel, seen = None, 0
        for line in built[lib][1].splitlines():
            if "Compiling entry function" in line:
                kernel = line if any(n in line for n in names) else None
            elif kernel and "spill stores" in line:
                seen += 1
                if " 0 bytes spill stores, 0 bytes spill loads" not in line:
                    out.append((kernel.split("'")[1], line.strip()))
        assert seen == expected, f"{seen} {names} instantiations in {lib}"
        print(f"build log: {seen} {'/'.join(names)} instantiations in {lib}")
    print(f"build log: {len(out)} of them spill {out}")
    return out


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
    # A spill fails the run at its end, after every measurement.
    spilled = spills(built)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    kind = torch.cuda.get_device_name(0)
    rate = memory_rate(kind)
    int32_rate = int_rate(clock)
    print(f"bounds: memory {rate / 1e12:.2f} TB/s, 32-bit operations "
          f"{PEAK_OPS / 1e12:.0f} T/s; INT32 estimate {int32_rate / 1e12:.2f}"
          f" T ops/s ({INT32_PER_SM_CLOCK} a clock x "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs x"
          f" {clock:.0f} MHz)")

    print("kernels against their plain versions: tolerance 0, bit for bit "
          "(integer state; the reward is a float32 difference of integers; "
          "both sides draw the same Philox bits)")
    t = time.perf_counter()
    check_rule_kernels(dev)
    check_k1(dev)
    check_k2_k3(dev)
    check_k2_k3_large(dev)
    check_philox(dev)
    check_obs_sum(dev)
    check_view(dev)
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
    timings = kernel_timings(banks, dev, rate, int32_rate)
    for name, (_, state) in results.items():
        profile(name, banks[name], state)
    profile("append-still, input shapes recorded", banks["append-still"],
            results["append-still"][1], shapes=True)
    print(f"phase 6: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    paths = dict(entry_points(dev), bench=launches)
    for name in KERNELS:
        # The bench's path, then the entry points' rows (the S rows' way of
        # counting: each row's warm-up and captured run).
        rows = {path: n[name] for path, n in paths.items()
                if ":" in path and n.get(name)}
        print(f"launches {name}: main path {launches[name]}; entry point "
              f"rows {rows}")
    script = script_timings(dev, rate, int32_rate)
    # S3-S5 on inputs larger than the 50 MB L2: shares of an HBM bound.
    script_timings(dev, rate, int32_rate, MAIN_BATCH)
    t1_floor(dev)
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

    t = time.perf_counter()
    trained = training(dev, smi)
    print(f"phase 8: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    evaluated = evaluation(dev, smi)
    print(f"phase 9: {time.perf_counter() - t:.1f} s")
    for name in EVAL_KERNELS:
        assert evaluated.get(name, 0) > 0, (name, evaluated)
    assert any(k.startswith("K3_advance_noreset") for k in evaluated)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        err, ms, plain_ms, bound_ms, bound_by = timings[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            # The main path's launches, the training path's and the
            # evaluation path's.
            launches=launches[name] + trained.get(name, 0)
            + evaluated.get(name, 0), max_abs_err=err,
            ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            # R1's plain version is one PyTorch call (a sum).
            library_ms=plain_ms if name == "R1_obs_sum" else None))
    for name, (source, replaces, counter, path) in SCRIPT_KERNELS.items():
        err, ms, plain_ms, bound_ms, bound_by, library_ms = script[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=paths[path][counter], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms))
    print(json.dumps({"kernels": kernels}))
    assert not spilled, f"kernel instantiations spill: {spilled}"
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
