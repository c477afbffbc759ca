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
10. the host game layer, episode videos and the command line: at B = 1,
   2 and 3 (the recorder's width) the training stack through K1, K2 and
   UNPACK against the same stack on the plain step drawing the kernels'
   spawns, on append-still, append-dynamic and prune-spawn, 20 steps
   with resets, bit for bit, and K1 + K2 and K1 + K3 against their plain
   versions along rollouts at those widths; ``record_episode`` through
   the training stack at B = 1 on the kernels (a ``SafeLifeCNN`` of seed
   0, view 33x33, time limit 1000, append-still and prune-spawn) with the
   seconds of its step loop, of ``render_board`` over its frames and of
   the GIF encoder, and the file sizes, its first 250 steps against the
   plain step's, bit for bit (frames and each step's reward); the host
   ``SafeLifeGame`` against the card's env at B = 1 on 8 append-still
   levels, 60 seeded steps each; and ``python -m
   safelife_torch`` in process: ``train`` (3 batches at 64 environments,
   ``TrainerConfig``'s ``record_videos``) writing a checkpoint and the
   episode's npz and GIF, ``bench --side-effects 16`` of that run,
   ``render`` of the episode, ``selftest`` and ``print``, with their
   launches of K1, K2, K3, UNPACK, K4, K5 and T1;
11. the level supply: K5 against its plain version at the annealer's
   shapes ((26, 26, 256), (26, 26, 4096), (16, 16, 48)) on mid-anneal
   boards with spawners; ``gen_still_lifes`` at 16x16 (B = 4096, 2000
   iterations; and period 2 at B = 1024): convergence, every converged
   board a cycle under K5, the still-life ensemble against the C++
   annealer's 48 seeds on the card's host, seconds, boards/s and
   launches an iteration from a profile; ``gen_partitioned_levels`` for
   all 10 task specs (128 levels, 1200 iterations): convergence, the
   archive gates and invariants of ``tests/test_procgen_distribution.py``,
   the bank flags and the levels that break them, levels/s; two factory
   banks through K1 + K2 against the plain step at B = 4096; the host
   pipeline (every preset, ``gen_bank`` onto the card); and in process
   ``train --task append-spawn``, a curriculum trainer whose bank switches
   after its first batch (K2's rule changes in the counts), ``new`` and
   ``gen-benchmarks`` on its spawned pool;
12. data-parallel training (``safelife_torch.parallel``) at the training
   width (``PPOConfig()``, view 33x33, append-still, 4096 environments in
   all): K1 + K2 and K1 + K3 with the spawn draw's counter at environment
   3001 against their plain versions (append-spawn, the stress bank, the
   general-pair bank); ``Trainer`` with ``PPOConfig(data_shards=2)`` in
   one process for 3 batches (finite losses, K1, K2 and UNPACK launched)
   and the learner's env-steps/s beside ``data_shards=1``;
   ``distributed.initialize()`` through the SAFELIFE_* variables on NCCL
   at world size 1, ``Trainer(mesh=make_global_mesh())`` for 3 batches
   with parameters bit-equal to the same-seed Trainer without a mesh,
   ``collective_stats`` of one update (all-reduce bytes at most 1.5x the
   parameters', every other collective under 100 kB) and the learner's
   env-steps/s with and without the mesh; two gloo ranks on the one card
   as subprocesses of this script (``--rank``), 2048 environments each:
   parameters bit-equal across ranks after 3 batches, each rank's
   rollout of append-still and append-spawn with injected actions bit for
   bit its shard of the one-process run, the all-reduced gradient within
   ``GRAD_RTOL`` of the one-process gradient, all-reduce times at 1x and
   8x the gradient's bytes; ``advance_board_sharded`` at world size 1
   and on the two ranks, (64, 32, 8) soups with spawners and (512, 512,
   64) boards, 4 steps, bit-equal to K5 on the whole board; and
   ``PhaseTimer`` and ``trace`` around one batch, the program's spans
   within 100 us of the profile's events of their names;
13. the JAX round's scripts (``python -m safelife_torch.scripts.*``):
   ``microbench`` in both modes at its own sizes (B = 4096, 64 chained
   steps in a CUDA graph), every row's loop then against the same loop on
   the plain path, bit for bit; ``validate_sinkhorn`` on append-still and
   prune-spawn at full width (100 levels, time limit 1000, 250 samples)
   with the seconds of the rollout, the co-evolution, the Sinkhorn EMD
   and the exact LP, its errors beside the JAX round's; ``eval_backend_
   diff --keys 1`` and ``cpu_verify_finals`` (both at time limit 200) on phase 8's
   64-environment run (each eval configuration in a subprocess on its own
   device, the card's plain path equal to its kernel path); ``scaling_report`` at
   sizes 1 (NCCL) and 2 (gloo ranks sharing the card); the three level-data
   scripts into a temporary folder with ``--check``, and the rebuilt v0.1
   suite through ``run_benchmark`` on the card;
14. the launch tooling (``python -m safelife_torch.scripts.{launch,
   remote_job,sweep,summarize_runs,run_tb}``): ``launch pod`` (2 hosts x 1
   card), ``remote_job start`` and ``sweep --round r5`` with
   ``--dry-run``; a sweep of two runs (append-still-s0 and
   append-still+penalty0.5+lstm-s1, 64 environments, 2 batches each, the
   final eval and video) each through ``launch local --nproc 1``, one
   NCCL rank in a subprocess of ``launch local`` (the command line
   ``--dry-run`` prints), the first run's final parameters bit-equal to
   ``train`` in this process with its arguments (which skips the video
   after its final checkpoint), with both runs' env-steps/s of the second batch and NCCL's bring-up
   seconds; a second sweep call that skips both; the tail
   (``cpu_verify_finals`` at time limit 200, ``summarize_runs`` into a
   temporary RESULTS.md holding both rows) and ``run_tb``'s summary;
15. one JSON line listing the kernels (the launches of phases 5 and 8-14,
   both ranks' of phase 12 included), and last the result line; before it
   the run fails if the build log shows a K1-K8, S3-S5, R1 or view kernel
   instantiation that spills.

Exits nonzero, printing no result, when no CUDA device is present.
"""

import collections
import contextlib
import dataclasses
import functools
import io
import json
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from safelife_torch import bench, bits16, scripts
from safelife_torch import cells as C
from safelife_torch.env import wrappers as W
from safelife_torch.env.env import (GRAPH_CAPTURE, GRAPH_REPLAY,
                                    BatchedSafeLifeEnv, EnvConfig)
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
# The dense bf16 tensor-core peak (the same data sheet), against which
# phase 12 states the learner's utilization.
PEAK_BF16_FLOPS = 989e12
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
            W.unwrap_env(plain).config = dataclasses.replace(
                W.unwrap_env(plain).config, use_kernels=False)
            assert W.unwrap_env(kern).uses_kernels()
            assert not W.unwrap_env(plain).uses_kernels()
            gen = torch.Generator(device=dev)
            gen.manual_seed(7)
            actions = torch.randint(0, 9, (steps, b), generator=gen,
                                    device=dev)
            fresh = W.unwrap_env(kern).sample_fresh_levels(bank, b, gen)
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


def training(dev, smi, keep):
    """Phase 8; returns the training path's launches.  The run at
    TRAIN_ENVS[0] environments is copied to ``keep`` (phase 13 replays
    it)."""
    check_training_env(dev)
    check_model(dev)
    with tempfile.TemporaryDirectory() as logdir:
        launches = train_path(dev, logdir)
        shutil.copytree(f"{logdir}/run{TRAIN_ENVS[0]}", keep)
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
    """Assert the launches of one suite eval on the kernels: one replay a
    step of the env step's CUDA graph and one capture; K1, K3 and UNPACK
    counted by their wrappers at the capture's warm-up run and at the
    capture, UNPACK once more for the first observation; K5 once a
    catch-up step and twice a sample."""
    rule = rule_of(bank)
    want = {GRAPH_REPLAY: steps, GRAPH_CAPTURE: 1, "K1_action": 2,
            f"K3_advance_noreset[{rule}]": 2, "S4_view_unpack": 3,
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
        steps = launched[GRAPH_REPLAY]
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
        eval_launches(launched, bank, launched[GRAPH_REPLAY], FULL_TIME_LIMIT,
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
              f"({launched[GRAPH_REPLAY]} steps); side effects "
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
                  launched[GRAPH_REPLAY], EVAL_TIME_LIMIT, EVAL_SAMPLES)
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


# ---------------------------------------------------------------------------
# Phase 10: the host game layer, episode videos and the command line.
# ---------------------------------------------------------------------------

# The smallest batches, which the recorder (B = 1) and the host game's
# counterpart run, on a static, a dynamic-goal and a spawner suite.
SMALL_BATCHES = (1, 2, 3)
SMALL_SUITES = ("append-still", "append-dynamic", "prune-spawn")
RECORD_SUITES = ("append-still", "prune-spawn")
# The recording held to the plain step: its first 250 steps, cut from the
# video's 1000 (the plain step takes 10-15 s for 1000 at B = 1; draws are
# per step, so a shorter episode is the longer one's prefix).
RECORD_CHECK_STEPS = 250
GAME_LEVELS = 8
GAME_STEPS = 60
CLI_ENVS = 64
CLI_STEPS = 3 * CLI_ENVS * ROLLOUT  # 3 batches of PPOConfig's 20 steps
CLI_KERNELS = ("K1_action", "S4_view_unpack", "K4_advance_spawnless",
               "K5_advance_with_field", "T1_philox_words",
               "K2_advance_fold[static_spawnless]",
               "K3_advance_noreset[static_spawnless]")


class KernelDraws(W.Wrapper):
    """The plain step of a wrapped env drawing what the kernel step draws
    from the same generator: the auto-reset's levels, then the step's
    seed, whose Philox spawn fields it is given (benchmarking's plain
    path does the same)."""

    def step(self, state, bank, action, generator=None, **kw):
        core = W.unwrap_env(self.env)
        b = action.shape[0]
        fresh = core.fresh_levels(bank, torch.randint(
            0, bank.num_levels, (b,), generator=generator,
            device=core.device, dtype=torch.int32))
        board, goals = core.kernel_spawn_fields(
            W.unwrap(state), bank, core.step_seed(generator))
        return self.env.step(state, bank, action, generator,
                             spawn_board=board, spawn_goals=goals,
                             fresh_levels=fresh, **kw)


def plain_stack(cfg, dev):
    """make_training_env on the plain step (the core config's
    use_kernels=False) drawing the kernels' spawns."""
    env = driver.make_training_env(cfg, dev)
    core = W.unwrap_env(env)
    core.config = dataclasses.replace(core.config, use_kernels=False)
    return KernelDraws(env)


def check_small_batches(dev, steps=ROLLOUT):
    """B = 1, 2, 3: the training stack at the 33x33 view through K1, K2 and
    UNPACK against the same stack on the plain step drawing the same
    spawns, bit for bit, 20 steps with resets; then K1 + K2 and K1 + K3
    against their plain versions along rollouts at the same widths."""
    cfg = driver.TrainerConfig(view_shape=TRAIN_VIEW, time_limit=8,
                               impact_penalty=TRAIN_PENALTY,
                               min_performance=TRAIN_MIN_PERF)
    launches = collections.Counter()
    for suite in SMALL_SUITES:
        t0 = time.perf_counter()
        bank = load_bank(suite, dev)
        for b in SMALL_BATCHES:
            kern = driver.make_training_env(cfg, dev)
            plain = plain_stack(cfg, dev)
            assert W.unwrap_env(kern).uses_kernels()
            actions = torch.randint(0, 9, (steps, b), device=dev,
                                    generator=torch.Generator(dev)
                                    .manual_seed(7))
            gens = [torch.Generator(dev).manual_seed(9) for _ in range(2)]
            states = [env.reset_all(bank, b, g) for env, g in
                      zip((kern, plain), gens)]
            resets = 0
            for t in range(steps):
                out = []
                for i, env in enumerate((kern, plain)):
                    (states[i], ts), launched = counted(
                        lambda: env.step(states[i], bank, actions[t],
                                         gens[i]))
                    launches.update(launched)
                    out.append(step_fields(states[i], ts))
                got, want = out
                assert got.keys() == want.keys()
                for name in want:
                    assert_bit_equal([got[name]], [want[name]],
                                     f"training stack {suite} B={b} step "
                                     f"{t}: {name}")
                resets += int(got["ts.done"].sum())
            assert resets > 0, (suite, b)
            gen = torch.Generator(dev)
            for env_cfg in (dict(time_limit=6, view_shape=TRAIN_VIEW),
                            dict(time_limit=6, auto_reset=False)):
                env = BatchedSafeLifeEnv(EnvConfig(**env_cfg), device=dev)
                rollout_check(env, bank, b, gen, f"{suite} B={b} {env_cfg}")
        print(f"B = {SMALL_BATCHES}: the training stack at view {TRAIN_VIEW} "
              f"on {suite} ({rule_of(bank)} rule), {steps} steps with "
              f"resets: kernels == plain step bit for bit; K1 + K2 (view "
              f"{TRAIN_VIEW}) and K1 + K3 == plain along 10-step rollouts "
              f"({time.perf_counter() - t0:.1f} s)")
    rule = rule_of(load_bank("prune-spawn", dev))
    assert launches[f"K2_advance_fold[{rule}]"] == (
        steps * len(SMALL_BATCHES)), launches


def gif_info(path):
    """(frames, width, height, the delays in hundredths of a second) of a
    GIF89a file, from its blocks."""
    with open(path, "rb") as fh:
        data = fh.read()
    assert data[:6] == b"GIF89a", data[:6]
    width, height, packed = struct.unpack("<HHB", data[6:11])
    pos = 13 + (3 << ((packed & 7) + 1) if packed & 0x80 else 0)
    frames, delays = 0, []

    def skip_sub_blocks(pos):
        while data[pos]:
            pos += data[pos] + 1
        return pos + 1

    while data[pos] != 0x3B:
        if data[pos] == 0x21:  # extension
            if data[pos + 1] == 0xF9:
                delays.append(struct.unpack("<H", data[pos + 4:pos + 6])[0])
            pos = skip_sub_blocks(pos + 2)
        elif data[pos] == 0x2C:  # image descriptor
            frames += 1
            local = data[pos + 9]
            pos += 10 + (3 << ((local & 7) + 1) if local & 0x80 else 0)
            pos = skip_sub_blocks(pos + 1)  # after the LZW code size
        else:
            raise AssertionError(f"unexpected GIF block {data[pos]:#x}")
    return frames, width, height, delays


def check_recording(dev, smi, logdir):
    """record_episode through the training stack at B = 1 on the kernels
    (a SafeLifeCNN of seed 0, the 33x33 view, time limit 1000) with the
    seconds of the step loop, of render_board over the frames and of the
    GIF encoder, and the file sizes; and its first RECORD_CHECK_STEPS steps
    against the plain step's episode of that length (the same generator),
    bit for bit: frames and each step's reward."""
    from safelife_torch.metrics import recording
    from safelife_torch.render import graphics
    cfg = driver.TrainerConfig(view_shape=TRAIN_VIEW)
    launches = collections.Counter()
    for suite in RECORD_SUITES:
        bank = load_bank(suite, dev)
        rule = rule_of(bank)
        net = model.SafeLifeCNN(
            view_shape=TRAIN_VIEW,
            generator=torch.Generator().manual_seed(0)).to(dev)
        policy = driver._sampling_policy(net)
        trajs = []
        for env, steps in ((driver.make_training_env(cfg, dev),
                            cfg.time_limit),
                           (plain_stack(cfg, dev), RECORD_CHECK_STEPS)):
            gen = torch.Generator(dev).manual_seed(5)
            torch.cuda.synchronize()
            t = time.perf_counter()
            traj, launched = counted(lambda: recording.record_episode(
                env, bank, policy, gen, level_idx=3, max_steps=steps))
            trajs.append((traj, launched, time.perf_counter() - t))
        (kern, launched, seconds), (plain, plain_launched, plain_s) = trajs
        assert plain["length"] == RECORD_CHECK_STEPS
        for name in ("board", "goals", "orientation", "rewards"):
            assert kern[name].dtype == plain[name].dtype, name
            assert np.array_equal(kern[name][:RECORD_CHECK_STEPS],
                                  plain[name]), (suite, name)
        steps = cfg.time_limit
        assert kern["length"] == steps  # the continuing stack never ends
        want = {"K1_action": steps, f"K2_advance_fold[{rule}]": steps,
                "S4_view_unpack": steps + 1}
        for name, n in want.items():
            assert launched.get(name, 0) == n, (name, n, launched)
        assert not any(k.startswith(("K1", "K2", "K3"))
                       for k in plain_launched), plain_launched
        launches.update(launched)
        t = time.perf_counter()
        frames = [graphics.render_board(b, g, int(o)) for b, g, o in zip(
            kern["board"], kern["goals"], kern["orientation"])]
        render_s = time.perf_counter() - t
        (npz,) = recording.save_trajectory(kern, f"{logdir}/{suite}",
                                           render=False)
        gif = npz[:-4] + ".gif"
        t = time.perf_counter()
        graphics.write_gif(gif, frames)
        encode_s = time.perf_counter() - t
        count, width, height, delays = gif_info(gif)
        assert (count, height, width) == (steps, *frames[0].shape[:2])
        assert set(delays) == {10}
        print(f"record_episode {suite} ({rule} rule) at B = 1 through the "
              f"training stack, view {TRAIN_VIEW}, SafeLifeCNN (seed 0), "
              f"{steps} steps, reward {kern['reward']:.4f}: its first "
              f"{RECORD_CHECK_STEPS} steps == the plain step's bit for bit "
              f"(boards, goals, orientations, each step's reward; reward "
              f"{plain['reward']:.4f} over them); step loop and its one transfer {seconds:.3f} s "
              f"({seconds / steps * 1e3:.3f} ms a step; plain "
              f"{plain_s:.3f} s for {RECORD_CHECK_STEPS}); render_board over {steps} frames {render_s:.3f} s; GIF "
              f"encoder {encode_s:.3f} s; npz {os.path.getsize(npz)} bytes, "
              f"GIF {os.path.getsize(gif)} bytes ({count} frames of "
              f"{width}x{height}, 10 cs each); launches {launched} on {smi}")
    return launches


def check_host_game(dev, smi):
    """The port's SafeLifeGame against BatchedSafeLifeEnv on the kernels at
    B = 1 (K1 and K3), first levels of append-still, seeded actions:
    boards and rewards equal at every step (tests/test_game_api.py's case
    on the card)."""
    from safelife_torch.env.env import ACTION_NAMES
    from safelife_torch.game import SafeLifeGame
    levels = loader.load_levels("benchmarks/v1.0/append-still")
    bank = loader.build_bank(levels, device=dev)
    env = BatchedSafeLifeEnv(EnvConfig(view_shape=VIEW, auto_reset=False),
                             device=dev)
    assert env.uses_kernels()
    rng_ = np.random.RandomState(5)
    launches = collections.Counter()
    steps = 0
    t0 = time.perf_counter()
    for i in range(GAME_LEVELS):
        lv = levels[i]
        game = SafeLifeGame(board_size=None)
        game.deserialize({
            "board": lv["board"], "goals": lv["goals"],
            "agent_loc": (int(lv["agent_col"]), int(lv["agent_row"])),
            "orientation": int(lv["orientation"]),
            "spawn_prob": float(lv["spawn_prob"]),
            "min_performance": float(lv["min_performance"])})
        game.update_exit_colors()
        state = env.reset_to_levels(bank, [i])
        assert np.array_equal(bits16(state.board[..., 0]).cpu().numpy()
                              .view(np.uint16), game.board)
        for t in range(GAME_STEPS):
            a = int(rng_.randint(0, 9))
            start = game.current_points()
            reward = game.execute_action(ACTION_NAMES[a])
            game.advance_board()
            reward += game.current_points() - start
            game.update_exit_colors()
            (state, ts), launched = counted(lambda: env.step(
                state, bank, torch.tensor([a], device=dev)))
            launches.update(launched)
            steps += 1
            board = bits16(state.board[..., 0]).cpu().numpy().view(np.uint16)
            assert np.array_equal(board, game.board), (i, t, ACTION_NAMES[a])
            assert float(ts.reward[0]) == float(reward), (i, t)
            assert bool(ts.state_before_reset.game_over[0]) == bool(
                game.game_over), (i, t)
            if game.game_over:
                break
    assert launches["K1_action"] == steps, launches
    assert launches["K3_advance_noreset[static_spawnless]"] == steps
    print(f"host game == the card's env at B = 1: {GAME_LEVELS} append-still "
          f"levels, {steps} seeded steps, boards and rewards equal at every "
          f"step ({time.perf_counter() - t0:.1f} s); launches "
          f"{dict(launches)} on {smi}")
    return launches


def check_cli(dev, smi, logdir):
    """python -m safelife_torch, in process: train -> episode video ->
    bench -> render -> selftest, and print; the launches of the run."""
    import contextlib
    import io
    from safelife_torch.__main__ import main as cli
    run = f"{logdir}/cli-run"
    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        _, launches = counted(lambda: cli([
            "train", run, "--levels", "benchmarks/v1.0/append-still.npz",
            "--num-envs", str(CLI_ENVS), "--steps", str(CLI_STEPS)]))
    train_s = time.perf_counter() - t
    ckpts = sorted(int(f[:-3]) for f in os.listdir(f"{run}/checkpoints"))
    step = ckpts[-1]
    assert step >= CLI_STEPS, ckpts
    npz, gif = f"{run}/episode-{step}.npz", f"{run}/episode-{step}.gif"
    with np.load(npz) as data:
        frames = len(data["board"])
        shape = data["board"].shape[1:]
    count, width, height, delays = gif_info(gif)
    assert frames == driver.TrainerConfig().time_limit
    assert (count, height, width) == (frames, shape[0] * 14, shape[1] * 14)
    assert set(delays) == {10}
    print(f"cli train: {CLI_ENVS} envs, --steps {CLI_STEPS}, checkpoints "
          f"{ckpts}, {train_s:.2f} s with the integrity checks, the "
          f"checkpoint and the episode video ({frames} frames; GIF "
          f"{os.path.getsize(gif)} bytes, {count} frames of {width}x{height},"
          f" 10 cs each); launches {launches} on {smi}")
    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        _, launched = counted(lambda: cli([
            "bench", "append-still", "--policy", run, "--side-effects",
            "16"]))
    launches = collections.Counter(launches) + collections.Counter(launched)
    line = out.getvalue().strip()
    assert line.startswith("levels=100 ") and "mean_side_effects" in line
    assert launched.get("K5_advance_with_field") == 1000 + 2 * 16, launched
    print(f"cli bench append-still --policy <run> --side-effects 16 "
          f"({time.perf_counter() - t:.2f} s): {line}")
    os.remove(gif)
    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        _, launched = counted(lambda: cli(["render", npz]))
        assert gif_info(gif)[0] == frames
        counted_selftest = counted(lambda: cli(["selftest"]))[1]
        cli(["print", "puzzles/01*"])
    launches += collections.Counter(launched) + collections.Counter(
        counted_selftest)
    seconds = time.perf_counter() - t
    text = out.getvalue()
    assert f"-> {gif}" in text
    assert f"integrity OK on {torch.cuda.get_device_name(0)}" in text
    assert "\x1b[" in text
    print(f"cli render, selftest and print ({seconds:.2f} s): "
          f"{text.splitlines()[1]}; selftest launches {counted_selftest}")
    for name in CLI_KERNELS:
        assert launches.get(name, 0) > 0, (name, launches)
    return launches


def game_layer(dev, smi):
    """Phase 10; returns its launches (the recording's, the host game's
    counterpart's and the command line's; not those of the comparisons at
    B = 1, 2, 3)."""
    check_small_batches(dev)
    with tempfile.TemporaryDirectory() as logdir:
        launches = check_recording(dev, smi, logdir)
        launches.update(check_host_game(dev, smi))
        launches.update(check_cli(dev, smi, logdir))
    return launches


# ---------------------------------------------------------------------------
# Phase 11: level supply (procgen on the host, the batched annealer on K5,
# the device banks, the curricula).
# ---------------------------------------------------------------------------

ANNEAL_SHAPES = ((26, 26, 256), (26, 26, 4096), (16, 16, 48))
# gen_still_lifes at full width: 16x16 boards, the mask [3:13, 3:13].
STILL_BATCH = 4096
STILL_ITERS = 2000
OSC_BATCH = 1024
NATIVE_SEEDS = 48
# Levels a factory bank holds here: 128, not the 256 the phase was
# planned with (the scaffolds' host time grows with the levels; the
# annealer's does not).
FACTORY_LEVELS = 128
# The share of converged levels each factory bank must reach: 0.5, the
# gate of tests/test_procgen_distribution.py, but for navigation, whose
# reference factory converges 0.48 at its default 1200 iterations
# (safelife_tpu on the CPU, 256 levels, tests/procgen_convergence.py):
# there the reference's share less three standard errors at
# FACTORY_LEVELS levels.
REFERENCE_CONVERGENCE = {"navigation": 0.48}


def convergence_gate(task):
    ref = REFERENCE_CONVERGENCE.get(task)
    if ref is None:
        return 0.5
    return ref - 3 * np.sqrt(ref * (1 - ref) / FACTORY_LEVELS)
FACTORY_TASKS = ("append-still", "append-still-easy", "append-dynamic",
                 "append-spawn", "prune-still", "prune-still-easy",
                 "prune-still-hard", "prune-dynamic", "prune-spawn",
                 "navigation")
FACTORY_ROLLOUTS = ("append-still", "prune-spawn")
EASY_REF_LEVELS = 24
HOST_LEVELS = 2
HOST_BANK = ("append-still", 100)
# The curriculum trainer's width and levels: the CLI's 64 environments.
CURRICULUM_ENVS = 64
CURRICULUM_LEVELS = 16
# What train --task append-spawn launches: the rollout on the first
# (spawnless) bank, the frozen-suite eval on append-spawn (static goals,
# spawners) with its co-evolution, the bank load, the integrity guard.
TASK_RUN_KERNELS = ("K1_action", "K2_advance_fold[static_spawnless]",
                    "K3_advance_noreset[static]", "K4_advance_spawnless",
                    "K5_advance_with_field", "T1_philox_words")
SUPPLY_KERNELS = TASK_RUN_KERNELS + ("K2_advance_fold[static]",)


def level_stats(board, goals, min_perf):
    """tests/test_procgen_distribution.py's per-level statistics (the copy
    here imports nothing of the JAX package)."""
    base = board & ~np.uint16(C.COLORS)
    alive = (board & C.ALIVE) != 0
    from safelife_torch.ops import life_numpy, scoring
    stats = dict(
        alive=alive.sum(),
        walls=((base & ~np.uint16(C.MOVABLE)) == C.WALL).sum(),
        trees=((base & ~np.uint16(C.MOVABLE)) == C.TREE).sum(),
        spawners=((board & C.SPAWNING) != 0).sum(),
        goal_cells=((goals & C.COLORS) != 0).sum(),
        blue_goals=((goals & C.COLORS) == C.COLOR_B).sum(),
        red_life=(alive & ((board & C.COLOR_R) != 0)).sum(),
        possible=(scoring.possible_score_np(goals[None])[0]
                  - scoring.performance_score_np(board[None], goals[None])[0]),
        min_perf=min_perf,
    )
    b1 = life_numpy.advance_board_reference(board, spawn_prob=0.0)
    stats["oscillates"] = float((b1 != board).any())
    return stats


def ensemble_stats(levels):
    rows = [level_stats(lv["board"], lv["goals"],
                        float(lv["min_performance"])) for lv in levels]
    return {k: np.array([float(r[k]) for r in rows]) for k in rows[0]}


def compare_ensembles(ref, gen, what):
    """The gate of tests/test_procgen_distribution.py: per statistic, a
    5-sigma z-test on the means or a relative band of 0.35."""
    worst = 0.0
    for key in ref:
        r, g = ref[key], gen[key]
        se = np.sqrt(r.var() / len(r) + g.var() / len(g)) + 1e-9
        z = abs(r.mean() - g.mean()) / se
        rel = abs(r.mean() - g.mean()) / (abs(r.mean()) + 1.0)
        assert z < 5.0 or rel < 0.35, (
            f"{what}/{key}: reference {r.mean():.2f}±{r.std():.2f} vs "
            f"generated {g.mean():.2f}±{g.std():.2f} (z={z:.1f}, "
            f"rel={rel:.2f})")
        worst = max(worst, min(z / 5.0, rel / 0.35))
    return worst


def still_life_stats(boards):
    """Structural statistics of a still-life ensemble (fill, live-neighbour
    histogram, components), as tests/test_procgen_distribution.py's."""
    from scipy import ndimage
    rows = []
    for board in boards:
        alive = (np.asarray(board) & C.ALIVE) != 0
        n = sum(np.roll(alive, (di, dj), (0, 1))
                for di in (-1, 0, 1) for dj in (-1, 0, 1) if di or dj)
        live_n = n[alive]
        n_comp = ndimage.label(
            alive, structure=np.ones((3, 3)))[1] if alive.any() else 0
        rows.append(dict(
            fill=alive.mean(),
            mean_neighbors=live_n.mean() if len(live_n) else 0.0,
            frac_n2=(live_n == 2).mean() if len(live_n) else 0.0,
            frac_n3=(live_n == 3).mean() if len(live_n) else 0.0,
            components=n_comp))
    return {k: np.array([r[k] for r in rows]) for k in rows[0]}


def anneal_mask(h=16, w=16):
    mask = np.zeros((h, w), bool)
    mask[3:h - 3, 3:w - 3] = True
    return mask


def check_k5_anneal_shapes(dev, smi):
    """K5 at the annealer's shapes on mid-anneal boards (spawner soups
    annealed 40 iterations), against its plain version, bit for bit, with
    the all-false spawn field of the violation field and a random one."""
    from safelife_torch.procgen import batched
    rng_ = np.random.default_rng(11)
    gen = torch.Generator(dev)
    gen.manual_seed(11)
    for shape in ANNEAL_SHAPES:
        h, w, b = shape
        start = soup(rng_, shape, (C.SPAWNER, C.WALL, C.TREE), density=0.02)
        mask = torch.as_tensor(rng_.random(shape) < 0.6, device=dev)
        boards, _ = batched.gen_still_lifes(
            gen, mask, b, board=torch.as_tensor(start, device=dev), iters=40)
        assert bool((bits16(boards) & C.SPAWNING).ne(0).any()), shape
        for field in (torch.zeros(shape, dtype=torch.bool, device=dev),
                      torch.rand(shape, generator=gen, device=dev) < 0.3):
            assert_bit_equal(
                life_kernels.advance_with_field(boards, field),
                life_kernels.advance_with_field_plain(boards, field),
                f"K5 at the annealer's shape {shape}")
        zeros = torch.zeros(shape, dtype=torch.bool, device=dev)
        k5 = time_ms(lambda: life_kernels.advance_with_field(boards, zeros),
                     50)
        print(f"K5 == plain on mid-anneal boards {shape} (spawners, walls, "
              f"trees; zero and random spawn fields): bit for bit; "
              f"{k5:.4f} ms a launch, on {smi}")


def anneal_profile(gen, mask, batch, period, **kw):
    """Device kernels a gen_still_lifes iteration launches, from a profile
    of 20 iterations at ``batch``; and the idle share of their wall."""
    from safelife_torch.procgen import batched
    from torch.profiler import ProfilerActivity, profile as torch_profile
    iters = 20
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        batched.gen_still_lifes(gen, mask, batch, iters=iters,
                                period=period, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    assert kernels, "the profiler recorded no device kernel"
    # The anneal loop, less the final statistics (a violation field).
    per_iter = (len(kernels) - 2 * period) / iters
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
    top = ", ".join(f"{k[:40]} {ms / busy:.0%}"
                    for k, ms in by_name.most_common(3))
    return per_iter, wall_ms / iters, busy / iters, 1 - busy / wall_ms, top


def check_still_lifes(dev, smi):
    """gen_still_lifes at full width on its own draws: convergence, every
    converged board a still life (one K5 step, bit for bit) / a period-2
    oscillator, the still-life ensemble against the C++ annealer's on the
    card's host; seconds, boards/s, launches an iteration."""
    from safelife_torch.procgen import batched, native
    mask = anneal_mask()
    gen_mask = np.where(mask, native.NEW_CELL_MASK | native.CAN_OSCILLATE_MASK
                        | native.INCLUDE_VIOLATIONS_MASK, 0)
    halo = np.zeros_like(gen_mask)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            halo |= np.roll(gen_mask & 1, (di, dj), (0, 1))
    gen_mask = np.where((halo > 0) & (gen_mask == 0),
                        native.INCLUDE_VIOLATIONS_MASK, gen_mask)
    t0 = time.perf_counter()
    native_boards = []
    for seed in range(NATIVE_SEEDS):
        try:
            native_boards.append(native.gen_pattern(
                np.zeros((16, 16), np.uint16), gen_mask.astype(np.int32),
                period=1, min_fill=0.15, temperature=0.45, rng=seed))
        except native.BoardGenException:
            pass
    native_s = time.perf_counter() - t0
    assert len(native_boards) >= 0.8 * NATIVE_SEEDS
    launches = collections.Counter()
    for period, batch, kw in (
            (1, STILL_BATCH, dict(min_fill=0.15, temperature=0.45)),
            (2, OSC_BATCH, dict(min_fill=0.1, temperature=0.7,
                                osc_bonus=0.5))):
        gen = torch.Generator(dev)
        gen.manual_seed(period)
        t0 = time.perf_counter()
        (boards, conv), launched = counted(lambda: batched.gen_still_lifes(
            gen, mask, batch, iters=STILL_ITERS, period=period, **kw))
        seconds = time.perf_counter() - t0
        launches.update(launched)
        k5 = launched["K5_advance_with_field"]
        assert k5 == (STILL_ITERS + 1) * period, launched
        conv_np = conv.cpu().numpy()
        rate = conv_np.mean()
        assert rate >= (0.8 if period == 1 else 0.5), (period, rate)
        # Every converged board returns to itself after `period` K5 steps.
        zeros = torch.zeros(boards.shape, dtype=torch.bool, device=dev)
        cycled = boards
        for _ in range(period):
            cycled = life_kernels.advance_with_field(cycled, zeros)
        same = (bits16(cycled) == bits16(boards)).all(0).all(0)
        assert bool(same[conv].all()), f"period {period}: a converged board "\
            "is no cycle"
        boards_np = boards.cpu().numpy()
        assert not (boards_np[~mask] != 0).any()
        msg = ""
        if period == 1:
            worst = compare_ensembles(
                still_life_stats(native_boards),
                still_life_stats([boards_np[..., i]
                                  for i in np.flatnonzero(conv_np)]),
                "still lifes: port annealer vs C++")
            msg = (f"; ensemble == the C++ annealer's {len(native_boards)} "
                   f"boards (host {native_s:.2f} s) within the gate (worst "
                   f"statistic at {worst:.2f} of its bound)")
        else:
            moved = life_kernels.advance_with_field(boards, zeros)
            osc = (bits16(moved) != bits16(boards)).any(0).any(0) & conv
            assert bool(osc.any()), "no converged board oscillates"
            msg = f"; {int(osc.sum())} converged boards oscillate"
        per_iter, wall_ms, busy_ms, idle, top = anneal_profile(
            gen, mask, batch, period, **kw)
        print(f"gen_still_lifes 16x16 period {period} B={batch} "
              f"{STILL_ITERS} iterations: {seconds:.2f} s, converged "
              f"{rate:.4f} ({conv_np.sum() / seconds:.1f} converged boards/s)"
              f", every converged board a cycle under K5{msg}; K5 launches "
              f"{k5} (= (iterations + 1) x period); profile of 20 "
              f"iterations: {per_iter:.1f} kernel launches an iteration, "
              f"{wall_ms:.3f} ms an iteration of wall, {busy_ms:.3f} ms "
              f"of device, idle share {idle:.1%} ({top}); on {smi}")
    return launches


def flag_breaks(bank, conv):
    """Levels whose board or goals break a flag the bank certifies, all
    and the converged among them: goal boards K5 does not leave fixed
    under ``static_goals``, boards or goals holding a spawner under
    ``spawnless``."""
    goals = bank.goals
    zeros = torch.zeros(goals.shape, dtype=torch.bool, device=goals.device)
    conv = torch.as_tensor(conv, device=goals.device)
    out = {}
    if bank.static_goals:
        moved = (bits16(life_kernels.advance_with_field(goals, zeros))
                 != bits16(goals)).any(0).any(0)
        out["static_goals"] = (int(moved.sum()), int((moved & conv).sum()))
    if bank.spawnless:
        spawners = (((bits16(bank.board) | bits16(goals)) & C.SPAWNING)
                    != 0).any(0).any(0)
        out["spawnless"] = (int(spawners.sum()), int((spawners & conv).sum()))
    return out


def check_factories(dev, smi):
    """gen_partitioned_levels for every task spec at 26x26, its default
    iterations, FACTORY_LEVELS levels: convergence, the archive gates and
    invariants of tests/test_procgen_distribution.py, the bank flags,
    how many levels break them, seconds and levels/s; then two factory
    banks through K1 + K2 against the plain step."""
    from safelife_torch import procgen
    from safelife_torch.procgen import batched
    launches = collections.Counter()
    banks = {}
    breaks = {}
    for task in FACTORY_TASKS:
        t0 = time.perf_counter()
        (bank, conv), launched = counted(
            lambda: batched.gen_partitioned_levels(
                task, FACTORY_LEVELS, seed=0, device=dev))
        seconds = time.perf_counter() - t0
        launches.update(launched)
        conv = conv.cpu().numpy()
        assert conv.mean() >= convergence_gate(task), (task, conv.mean())
        board, goals = bank.board.cpu().numpy(), bank.goals.cpu().numpy()
        mp = bank.min_performance.cpu().numpy()
        gen = [dict(board=board[..., i], goals=goals[..., i],
                    min_performance=float(mp[i]))
               for i in np.flatnonzero(conv)]
        if task.endswith("-easy"):
            np.random.seed(77)
            ref_levels = procgen.gen_levels(task, num_levels=EASY_REF_LEVELS)
        else:
            ref_levels = loader.load_levels(f"benchmarks/v1.0/{task}")
        got = ensemble_stats(gen)
        worst = compare_ensembles(ensemble_stats(ref_levels), got,
                                  f"factory/{task}")
        if "dynamic" in task or task == "navigation":
            assert got["oscillates"].mean() > 0.5, task
            assert not bank.static_goals and bank.simple_goals, task
        else:
            assert bank.static_goals, task
        if task.endswith("spawn") or task == "navigation":
            assert (got["spawners"] > 0).all(), task
            assert not bank.spawnless, task
            assert np.allclose(bank.spawn_prob.cpu().numpy()[conv], 0.3)
        else:
            assert bank.spawnless, task
        if task in ("prune-still-hard", "prune-dynamic"):
            red = ((board & C.COLOR_R) != 0) & ((board & C.ALIVE) != 0) \
                & ((board & C.COLOR_G) == 0)
            hard = red & ((board & C.DESTRUCTIBLE) == 0)
            assert hard[..., conv].any() and (red & ~hard)[..., conv].any()
        breaks[task] = flag_breaks(bank, conv)
        banks[task] = bank
        print(f"factory {task}: {FACTORY_LEVELS} levels in {seconds:.2f} s "
              f"({FACTORY_LEVELS / seconds:.1f} levels/s), converged "
              f"{conv.mean():.4f} (gate {convergence_gate(task):.3f}), "
              f"archive gate passed (worst statistic at "
              f"{worst:.2f} of its bound), rule {rule_of(bank)}; levels "
              f"breaking a certified flag (all, converged): {breaks[task]}; "
              f"K5 launches "
              f"{launched.get('K5_advance_with_field', 0)}; on {smi}")
    gen = torch.Generator(dev)
    for task in FACTORY_ROLLOUTS:
        env = BatchedSafeLifeEnv(EnvConfig(view_shape=VIEW, time_limit=8),
                                 device=dev)
        resets = rollout_check(env, banks[task], 4096, gen,
                               f"factory bank {task}", steps=ROLLOUT)
        print(f"factory bank {task} ({rule_of(banks[task])} rule): K1 + K2 "
              f"== plain along {ROLLOUT} steps at B=4096, {resets} resets")
    return launches, breaks


def check_host_pipeline(dev, smi):
    """The host pipeline on the card's host: every reference preset, and
    the curriculum's bank on the card."""
    from safelife_torch import procgen
    from safelife_torch.procgen import presets
    t0 = time.perf_counter()
    times = {}
    for task in sorted(k for k in presets.TASKS if not k.endswith("-tiny")):
        t = time.perf_counter()
        levels = procgen.gen_levels(task, HOST_LEVELS, seed=0)
        times[task] = time.perf_counter() - t
        assert all((lv["board"] & C.AGENT).any() for lv in levels), task
    assert len(times) == 11
    print(f"host gen_levels, {HOST_LEVELS} levels of each of the 11 presets:"
          f" {time.perf_counter() - t0:.2f} s ("
          + ", ".join(f"{k} {v:.2f}" for k, v in times.items())
          + f") on the card's host")
    name, n = HOST_BANK
    t0 = time.perf_counter()
    bank, launched = counted(lambda: procgen.gen_bank(name, n, seed=0,
                                                      device=dev))
    seconds = time.perf_counter() - t0
    assert bank.num_levels == n and bank.board.device == dev
    assert bank.static_goals and bank.spawnless
    print(f"host gen_bank('{name}', {n}, seed=0, device=cuda): {seconds:.2f}"
          f" s ({n / seconds:.1f} levels/s), launches {launched}; on {smi}")
    return launched


def check_supply_entry_points(dev, smi, logdir):
    """The entry points in process: train --task, a curriculum trainer
    whose bank switches after its first batch, new, gen-benchmarks."""
    import contextlib
    import io
    from safelife_torch.__main__ import main as cli
    from safelife_torch.training import curricula
    launches = collections.Counter()
    run = f"{logdir}/task-run"
    steps = 3 * CURRICULUM_ENVS * ROLLOUT
    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        _, launched = counted(lambda: cli([
            "train", run, "--task", "append-spawn", "--num-envs",
            str(CURRICULUM_ENVS), "--steps", str(steps)]))
    seconds = time.perf_counter() - t
    launches.update(launched)
    ckpts = sorted(int(f[:-3]) for f in os.listdir(f"{run}/checkpoints"))
    assert ckpts and ckpts[-1] >= steps, ckpts
    with open(f"{run}/eval.yaml") as fh:
        assert "performance" in fh.read()
    for name in TASK_RUN_KERNELS:
        assert launched.get(name, 0) > 0, (name, launched)
    print(f"cli train --task append-spawn: {CURRICULUM_ENVS} envs, --steps "
          f"{steps}, checkpoints {ckpts}, the frozen-suite eval and the "
          f"episode video at the last: {seconds:.2f} s; launches "
          f"{launched}")

    trainer, _ = curricula.make_curriculum_trainer(
        "append-spawn", num_envs=CURRICULUM_ENVS,
        bank_levels=CURRICULUM_LEVELS, seed=1, eval_suite=None,
        record_videos=False, device=dev)
    batch = CURRICULUM_ENVS * ROLLOUT
    trainer.bank_schedule = [(batch, f) for _, f in trainer.bank_schedule]
    rules = []
    t = time.perf_counter()
    for k in range(3):
        _, launched = counted(lambda: trainer.train((k + 1) * batch))
        launches.update(launched)
        rules.append(sorted(n for n in launched if n.startswith("K2")))
    seconds = time.perf_counter() - t
    assert rules[0] == ["K2_advance_fold[static_spawnless]"], rules
    assert rules[1] == rules[2] == ["K2_advance_fold[static]"], rules
    assert not trainer.bank.spawnless and trainer.bank.static_goals
    print(f"curriculum append-spawn, first threshold moved to step {batch}: "
          f"K2 launched as {rules[0]} in batch 1, {rules[1]} in batches 2 "
          f"and 3 (the bank switched to append-spawn); {seconds:.2f} s")

    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli(["new", "append-dynamic", "--seed", "4"])
    text = out.getvalue()
    assert text.count("\n") > 20
    print(f"cli new append-dynamic --seed 4: {time.perf_counter() - t:.2f} "
          f"s, {text.count(chr(10))} lines")

    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli(["gen-benchmarks", f"{logdir}/suites", "--tasks", "append-still",
             "--num-levels", "3", "--workers", "2"])
    archive = out.getvalue().strip()
    bank = loader.load_bank(archive, device=dev)
    assert bank.num_levels == 3
    print(f"cli gen-benchmarks --tasks append-still --num-levels 3 --workers "
          f"2 (spawned pool): {time.perf_counter() - t:.2f} s, {archive} "
          f"loads as a bank of {bank.num_levels} on the card")
    return launches


def level_supply(dev, smi):
    """Phase 11; returns its launches (the factories', the host pipeline's
    bank, the entry points'; not those of the comparisons) and the
    levels that break a certified bank flag, by task."""
    t0 = time.perf_counter()
    check_k5_anneal_shapes(dev, smi)
    print(f"phase 11 K5 checks: {time.perf_counter() - t0:.1f} s")
    _build.LAUNCHES.clear()
    launches = collections.Counter()
    t = time.perf_counter()
    launches.update(check_still_lifes(dev, smi))
    print(f"phase 11 still lifes: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    factory, breaks = check_factories(dev, smi)
    launches.update(factory)
    print(f"phase 11 factories: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    launches.update(check_host_pipeline(dev, smi))
    print(f"phase 11 host pipeline: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as logdir:
        launches.update(check_supply_entry_points(dev, smi, logdir))
    print(f"phase 11 entry points: {time.perf_counter() - t:.1f} s")
    for name in SUPPLY_KERNELS:
        assert launches.get(name, 0) > 0, (name, launches)
    print(f"phase 11 launches {dict(launches)}; levels breaking a "
          f"certified flag {breaks}")
    return launches


# ---------------------------------------------------------------------------
# Phase 12: data-parallel training on torch.distributed.
# ---------------------------------------------------------------------------

# The whole batch of the sharded runs (two ranks hold 2048 each), their
# batches, and the halo exchange's boards and steps.
SHARD_ENVS = 4096
SHARD_BATCHES = 3
HALO_BOARDS = ((64, 32, 8), (512, 512, 64))
HALO_STEPS = 4
# Each rank's all-reduced gradient against the one-process gradient of the
# same minibatch, a float32 net with TF32 off: the ranks' rows are summed
# in another order, by weight-gradient algorithms cuDNN picks per batch
# size, over 10^5-10^6 terms an element that largely cancel.  Bound on
# max |diff| / max |gradient| per tensor (7.78e-5 on both ranks in every
# run so far; a wrong average or wrong rows is off by order 1).
GRAD_RTOL = 2e-4
# The two-rank run's deadline (its group's timeout is below it).
RANKS_TIMEOUT_S = 600
RANK_GROUP_TIMEOUT_S = 300


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def shard_trainer(dev, ppo_cfg, mesh=None, net=None):
    """Trainer at the training width: append-still, view 33x33,
    SHARD_ENVS environments in all, no files."""
    return driver.Trainer(
        driver.TrainerConfig(num_envs=SHARD_ENVS, view_shape=TRAIN_VIEW,
                             report_every=SHARD_ENVS * ROLLOUT,
                             save_every=10**9, record_videos=False),
        ppo_cfg, level_paths=("benchmarks/v1.0/append-still",), device=dev,
        mesh=mesh, net=net)


def shard_steps():
    # Two batches leave the global step short of this; the third passes.
    return (SHARD_BATCHES - 1) * ROLLOUT * SHARD_ENVS + 1


def learner_rate(trainer, batches=3):
    """Seconds a train_batch (after one to warm up), and the whole batch's
    env-steps/s."""
    ppo_, ts, gen = trainer.ppo, trainer.train_state, trainer.generator
    state, obs = trainer.env_state, trainer.obs
    state, obs, _ = ppo_.train_batch(ts, state, obs, trainer.bank, gen)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(batches):
        state, obs, _ = ppo_.train_batch(ts, state, obs, trainer.bank, gen)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) / batches
    trainer.env_state, trainer.obs = state, obs
    return wall, SHARD_ENVS * ROLLOUT / wall


def check_trained(trainer, reports, launched, what):
    assert trainer.train_state.update_step == SHARD_BATCHES, what
    assert len(reports) == SHARD_BATCHES, what
    for m in reports:
        for k in ("policy_loss", "value_loss", "entropy", "pseudo_entropy",
                  "mean_reward"):
            assert np.isfinite(m[k]).all(), (what, k, m[k])
    for name in ("K1_action", "K2_advance_fold[static_spawnless]",
                 "S4_view_unpack"):
        assert launched.get(name, 0) >= SHARD_BATCHES * ROLLOUT, (
            what, name, launched)


def check_k2_k3_offset(dev):
    """K1 + K2 (fold and view) and K1 + K3 with the spawn draw's counter
    starting at a nonzero environment, against their plain versions at
    the same offset, on the three drawing rules; and at offset 0."""
    gen = torch.Generator(device=dev)
    for suite in ("append-spawn", "stress", "general"):
        bank = load_bank(suite, dev)
        for auto_reset in (True, False):
            env = BatchedSafeLifeEnv(EnvConfig(
                time_limit=6, view_shape=TRAIN_VIEW, auto_reset=auto_reset),
                device=dev)
            gen.manual_seed(3)
            b = 1001
            state = env.reset_all(bank, b, gen)
            fresh = env.sample_fresh_levels(bank, b, gen)
            for step in range(6):
                action = torch.randint(0, 9, (b,), generator=gen, device=dev,
                                       dtype=torch.int32)
                kw = env.fused_inputs(state, bank, action,
                                      fresh[1] if auto_reset else None,
                                      env.step_seed(gen))
                for env0 in (0, 3001):
                    kw["env0"] = env0
                    assert_bit_equal(
                        esk.fused_step(**kw), esk.fused_step_plain(**kw),
                        f"K1+K2/K3 {suite} env0={env0} step {step}")
                state, _ = env.step(state, bank, action, gen,
                                    fresh_levels=fresh)
        print(f"K2/K3 with the draw's first environment at 0 and at 3001 == "
              f"plain: {suite} ({rule_of(bank)} rule) B=1001, fold and no "
              f"reset, 6 steps")


def one_process_shards(dev, smi):
    """Step 1: data_shards=2 in one process; returns its launches."""
    trainer = shard_trainer(dev, ppo.PPOConfig(data_shards=2))
    reports = []
    t = time.perf_counter()
    _, launched = counted(lambda: trainer.train(
        total_steps=shard_steps(),
        progress_fn=lambda s, m: reports.append(m)))
    seconds = time.perf_counter() - t
    check_trained(trainer, reports, launched, "data_shards=2")
    rates = {}
    for shards in (1, 2):
        rates[shards] = learner_rate(shard_trainer(
            dev, ppo.PPOConfig(data_shards=shards)))
    print(f"trainer, PPOConfig(data_shards=2) in one process: append-still, "
          f"{SHARD_ENVS} envs, view {TRAIN_VIEW}, {SHARD_BATCHES} batches in "
          f"{seconds:.2f} s, last policy_loss "
          f"{float(reports[-1]['policy_loss']):.5g}; launches {launched}")
    for shards, (wall, rate) in rates.items():
        print(f"learner env-steps/s at data_shards={shards}, {SHARD_ENVS} "
              f"envs: {rate:.0f} ({wall * 1e3:.2f} ms a batch) on {smi}")
    return launched


def update_stats(trainer, mesh):
    """collective_stats of one update: one Adam step on one minibatch of
    PPOConfig()'s size (a quarter of the environments)."""
    cfg = dataclasses.replace(trainer.ppo_cfg, epochs_per_batch=1,
                              num_minibatches=1)
    learner = ppo.PPO(cfg, trainer.env, mesh=mesh)
    _, _, traj, _ = ppo.rollout(cfg, trainer.net, trainer.env, trainer.bank,
                                trainer.env_state, trainer.obs,
                                trainer.generator)
    n = trainer.local_envs // trainer.ppo_cfg.num_minibatches
    traj = ppo.Trajectory(**{f.name: getattr(traj, f.name)[:, :n]
                             for f in dataclasses.fields(traj)})
    ret, adv = ppo.compute_gae(cfg, traj.reward, traj.done, traj.value)
    from safelife_torch.parallel import distributed
    stats = distributed.collective_stats(
        lambda: learner.update(trainer.train_state, traj, ret, adv,
                               trainer.generator), mesh)
    param_bytes = sum(4 * p.numel() for p in trainer.train_state.optimizer
                      .params)
    return stats, param_bytes


def halo_check(dev, mesh):
    """advance_board_sharded for HALO_STEPS steps on each of HALO_BOARDS
    (soups with spawners, a spawn field of rate 0.2) against K5 on the
    whole board; returns the sharded runs' launches and seconds."""
    from safelife_torch.parallel import halo
    launches, seconds = collections.Counter(), {}
    for shape in HALO_BOARDS:
        board = torch.as_tensor(soup(np.random.default_rng(shape[0]), shape,
                                     SPAWNLESS_FLAGS + (C.SPAWNING,)),
                                device=dev)
        spawn = torch.rand(shape, generator=torch.Generator(dev).manual_seed(
            shape[1]), device=dev) < 0.2
        whole = board
        for _ in range(HALO_STEPS):
            whole = life_kernels.advance_with_field(whole, spawn)
        block, field = halo.shard_rows(board, mesh), halo.shard_rows(spawn,
                                                                     mesh)

        def run(block=block):
            for _ in range(HALO_STEPS):
                block = halo.advance_board_sharded(block, field, mesh)
            return block

        t = time.perf_counter()
        block, launched = counted(run)
        seconds[shape] = time.perf_counter() - t
        assert launched == {"K5_advance_with_field": HALO_STEPS}, launched
        launches.update(launched)
        assert_bit_equal([halo.gather_rows(block, mesh)], [whole],
                         f"advance_board_sharded {shape} on "
                         f"{mesh.world_size} ranks")
    return launches, seconds


def nccl_world_one(dev, smi):
    """Step 2 and step 4 at world size 1: initialize() on NCCL through the
    SAFELIFE_* variables, Trainer(mesh=) against the same-seed Trainer,
    collective_stats, the learner with and without the mesh, the halo
    exchange; returns the mesh trainer's and the halo's launches."""
    import torch.distributed as dist
    from safelife_torch.parallel import distributed
    os.environ.update(SAFELIFE_COORDINATOR=f"127.0.0.1:{free_port()}",
                      SAFELIFE_NUM_PROCS="1", SAFELIFE_PROC_ID="0")
    flags = torch.backends.cudnn.deterministic
    try:
        t = time.perf_counter()
        assert distributed.initialize(timeout=RANK_GROUP_TIMEOUT_S)
        assert dist.get_backend() == "nccl", dist.get_backend()
        mesh = distributed.make_global_mesh()
        assert (mesh.world_size, mesh.device) == (1, dev), mesh
        print(f"initialize(): NCCL, world size 1, {mesh.device}, "
              f"{time.perf_counter() - t:.2f} s")
        # Equal inputs must give equal bits: deterministic convolutions.
        torch.backends.cudnn.deterministic = True
        plain = shard_trainer(dev, ppo.PPOConfig())
        plain.train(total_steps=shard_steps())
        meshed = shard_trainer(dev, ppo.PPOConfig(), mesh=mesh)
        reports = []
        _, launched = counted(lambda: meshed.train(
            total_steps=shard_steps(),
            progress_fn=lambda s, m: reports.append(m)))
        check_trained(meshed, reports, launched, "mesh of 1")
        want = plain.net.state_dict()
        for k, v in meshed.net.state_dict().items():
            assert_bit_equal([v], [want[k]], f"mesh of 1 against no mesh {k}")
        assert meshed.train_state.spe.item() == plain.train_state.spe.item()
        assert meshed.global_step() == plain.global_step()
        print(f"Trainer(mesh=make_global_mesh()) on NCCL at world size 1: "
              f"{SHARD_BATCHES} batches at {SHARD_ENVS} envs, parameters and "
              f"spe bit-equal to the same-seed Trainer without a mesh "
              f"(cuDNN deterministic); launches {launched}")
        torch.backends.cudnn.deterministic = flags

        stats, param_bytes = update_stats(meshed, mesh)
        moved = stats["collective_bytes"]
        other = {k: v for k, v in moved.items() if k != "all-reduce"}
        assert 0 < moved.get("all-reduce", 0) <= 1.5 * param_bytes, moved
        assert sum(other.values()) < 100_000, moved
        print(f"collective_stats of one update (one Adam step on "
              f"{meshed.local_envs // 4} envs x {ROLLOUT} steps), NCCL world "
              f"size 1: {moved} bytes (parameters {param_bytes} bytes), "
              f"{stats['flops']:.4g} FLOPs (FlopCounterMode)")

        for name, trainer in (("without", plain), ("with", meshed)):
            wall, rate = learner_rate(trainer)
            print(f"learner env-steps/s {name} the NCCL mesh of 1, "
                  f"{SHARD_ENVS} envs: {rate:.0f} ({wall * 1e3:.2f} ms a "
                  f"batch) on {smi}")
        for name, trainer in (("without", plain), ("with", meshed)):
            wall, rate = learner_rate(trainer)
            print(f"learner env-steps/s {name} the NCCL mesh of 1, again: "
                  f"{rate:.0f} ({wall * 1e3:.2f} ms a batch)")

        halo_launched, seconds = halo_check(dev, mesh)
        print(f"advance_board_sharded, NCCL world size 1 (the block's own "
              f"rows close the torus), {HALO_STEPS} steps == K5 on the whole "
              f"board: " + ", ".join(f"{s} {t * 1e3:.2f} ms"
                                     for s, t in seconds.items()))
        launched = collections.Counter(launched)
        launched.update(halo_launched)
        return launched
    finally:
        torch.backends.cudnn.deterministic = flags
        distributed.shutdown()
        for k in ("SAFELIFE_COORDINATOR", "SAFELIFE_NUM_PROCS",
                  "SAFELIFE_PROC_ID"):
            os.environ.pop(k, None)


def rank_trajectories(dev, mesh, suite, net):
    """Rollouts of SHARD_ENVS environments (one process) and of this rank's
    shard, the same injected actions and seeds, time limit 8 (every
    environment resets): the env's side bit for bit, the net's outputs
    within F32_TOL; returns the whole run's trajectory and its resets."""
    bank = load_bank(suite, dev)
    cfg = driver.TrainerConfig(view_shape=TRAIN_VIEW, time_limit=8)
    learner = ppo.PPOConfig(data_shards=mesh.world_size)
    actions = torch.randint(0, 9, (ROLLOUT, SHARD_ENVS),
                            generator=torch.Generator(dev).manual_seed(5),
                            device=dev)
    runs = []
    for shard in ((0, 1), (mesh.rank, mesh.world_size)):
        env = driver.make_training_env(cfg, dev, shard=shard)
        b = SHARD_ENVS // shard[1]
        first = shard[0] * b
        gen = torch.Generator(dev).manual_seed(2)
        state = env.reset_all(bank, b, gen)
        _, obs, traj, eps = ppo.rollout(
            learner, net, env, bank, state, env.observe(state), gen,
            actions=actions[:, first:first + b])
        runs.append((traj, obs, eps))
    (whole, wobs, weps), (part, obs, eps) = runs
    rows = mesh.rows(SHARD_ENVS)
    cut = lambda x: x[:, rows]  # noqa: E731
    assert_bit_equal([part.obs, part.reward, part.done, obs],
                     [cut(whole.obs), cut(whole.reward), cut(whole.done),
                      wobs[rows]], f"rank {mesh.rank} rollout {suite}")
    assert_bit_equal(list(eps.values()), [cut(v) for v in weps.values()],
                     f"rank {mesh.rank} episode stats {suite}")
    for name in ("old_pi", "value"):
        torch.testing.assert_close(getattr(part, name),
                                   cut(getattr(whole, name)), **F32_TOL)
    return whole, int(whole.done.sum())


def rank_gradient(dev, mesh, whole, net):
    """This rank's all-reduced gradient of its rows of minibatch 0 against
    the one-process gradient of the whole minibatch; returns the largest
    max |diff| / max |gradient| over the tensors."""
    cfg = ppo.PPOConfig(data_shards=mesh.world_size)
    local = SHARD_ENVS // mesh.world_size
    mb = local // cfg.num_minibatches
    ret, adv = ppo.compute_gae(cfg, whole.reward, whole.done, whole.value)
    data = (whole.obs, whole.action, whole.old_pi, whole.value[:-1], ret, adv)
    perms = torch.stack([torch.randperm(
        local, generator=torch.Generator(dev).manual_seed(s), device=dev)
        for s in range(mesh.world_size)])
    spe = torch.nn.Parameter(torch.ones((), device=dev))
    params = list(net.parameters()) + [spe]
    grads = []
    for rows, m in ((ppo.minibatch_rows(perms, 0, mb), None),
                    (perms[mesh.rank, :mb] + mesh.rank * local, mesh)):
        for p in params:
            p.grad = None
        loss, _ = ppo.ppo_loss(cfg, net, spe, *(x[:, rows] for x in data),
                               mesh=m)
        loss.backward()
        if m is not None:
            m.average_gradients(params)
        grads.append([p.grad.clone() for p in params])
    return max((g - w).abs().max().item() / w.abs().max().item()
               for g, w in zip(*grads[::-1]))


def time_allreduce(mesh, n, iters=8):
    """ms of one all-reduce of ``n`` float32 on the card, chained."""
    x = torch.ones(n, device=mesh.device)
    mesh.all_reduce(x)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        mesh.all_reduce(x)
        x /= mesh.world_size
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / iters * 1e3


def rank_work(dev, mesh):
    """One rank of step 3 and step 4: Trainer(mesh=) on append-still, the
    rollouts of append-still and append-spawn against the one-process
    run, the all-reduced gradient, all-reduce times, the halo exchange;
    returns the rank's results (its launches among them)."""
    out = {"rank": mesh.rank}
    trainer = shard_trainer(dev, ppo.PPOConfig(data_shards=mesh.world_size),
                            mesh=mesh)
    reports = []
    t = time.perf_counter()
    _, launched = counted(lambda: trainer.train(
        total_steps=shard_steps(),
        progress_fn=lambda s, m: reports.append(m)))
    out["train_s"] = time.perf_counter() - t
    check_trained(trainer, reports, launched, f"rank {mesh.rank}")
    out["launches"] = collections.Counter(launched)
    out["params"] = {k: v.cpu() for k, v in trainer.net.state_dict().items()}
    out["spe"] = trainer.train_state.spe.item()
    out["global_step"] = trainer.global_step()
    out["local_envs"] = W.unwrap(trainer.env_state).board.shape[-1]
    out["policy_loss"] = float(reports[-1]["policy_loss"])
    out["batch_s"], _ = learner_rate(trainer, batches=2)
    n_params = sum(p.numel() for p in trainer.train_state.optimizer.params)
    del trainer

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        net = model.SafeLifeCNN(view_shape=TRAIN_VIEW,
                                compute_dtype=torch.float32,
                                generator=torch.Generator().manual_seed(0)
                                ).to(dev)
        for suite in ("append-still", "append-spawn"):
            whole, out[f"resets {suite}"] = rank_trajectories(dev, mesh,
                                                              suite, net)
            assert out[f"resets {suite}"] > 0, suite
            if suite == "append-still":
                out["grad_rel_err"] = rank_gradient(dev, mesh, whole, net)
            del whole
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    out["allreduce_ms"] = {k: time_allreduce(mesh, k * n_params)
                           for k in (1, 8)}
    out["n_params"] = n_params
    halo_launched, out["halo_s"] = halo_check(dev, mesh)
    out["launches"].update(halo_launched)
    out["collective_bytes"] = dict(mesh.collective_bytes)
    return out


def rank_main(outdir):
    """A rank of the two-rank run (``chip_smoke.py --rank <outdir>``, the
    SAFELIFE_* variables set): gloo on the one card."""
    from safelife_torch.parallel import distributed
    dev = torch.device("cuda", 0)
    _build.build_all()  # the parent built them: this loads
    assert distributed.initialize(backend="gloo", device=dev,
                                  timeout=RANK_GROUP_TIMEOUT_S)
    try:
        mesh = distributed.make_global_mesh(device=dev)
        out = rank_work(dev, mesh)
        torch.save(out, os.path.join(outdir, f"rank{mesh.rank}.pt"))
        mesh.barrier()
    finally:
        distributed.shutdown()


def two_ranks(dev, smi):
    """Step 3 and step 4 on two gloo ranks sharing the card, as
    subprocesses of this script; returns their launches."""
    with tempfile.TemporaryDirectory() as outdir:
        env = dict(os.environ, SAFELIFE_COORDINATOR=f"127.0.0.1:{free_port()}",
                   SAFELIFE_NUM_PROCS="2")
        procs = []
        t = time.perf_counter()
        try:
            for r in range(2):
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--rank",
                     outdir], env=dict(env, SAFELIFE_PROC_ID=str(r)),
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            logs = [p.communicate(timeout=RANKS_TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        seconds = time.perf_counter() - t
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {r} failed:\n{log[-6000:]}"
        r0, r1 = (torch.load(os.path.join(outdir, f"rank{r}.pt"),
                             weights_only=False) for r in range(2))
    for k, v in r0["params"].items():
        assert_bit_equal([r1["params"][k]], [v], f"two ranks' parameter {k}")
    assert r0["spe"] == r1["spe"]
    for r in (r0, r1):
        assert r["global_step"] == SHARD_BATCHES * ROLLOUT * SHARD_ENVS
        assert r["local_envs"] == SHARD_ENVS // 2
        assert r["grad_rel_err"] <= GRAD_RTOL, r["grad_rel_err"]
        moved = r["collective_bytes"]
        print(f"rank {r['rank']} of 2 (gloo, one card): {SHARD_BATCHES} "
              f"batches of {r['local_envs']} envs in {r['train_s']:.2f} s "
              f"with the integrity checks; {r['batch_s'] * 1e3:.2f} ms a "
              f"batch ({SHARD_ENVS * ROLLOUT / r['batch_s']:.0f} env-steps/s "
              f"of the whole batch); rollouts of append-still and "
              f"append-spawn == its shard of one process bit for bit "
              f"({r['resets append-still']} / {r['resets append-spawn']} "
              f"resets in the whole run), net outputs within {F32_TOL}; "
              f"all-reduced gradient max |diff| / max |g| "
              f"{r['grad_rel_err']:.3g} (bound {GRAD_RTOL}); all-reduce of "
              f"{r['n_params']} float32 {r['allreduce_ms'][1]:.3f} ms, 8x "
              f"{r['allreduce_ms'][8]:.3f} ms; halo "
              + ", ".join(f"{s} {t * 1e3:.2f} ms"
                          for s, t in r["halo_s"].items())
              + f"; bytes moved {moved}; launches {dict(r['launches'])}")
    print(f"two gloo ranks on one card: parameters and spe bit-equal after "
          f"{SHARD_BATCHES} batches, last policy_loss {r0['policy_loss']:.5g};"
          f" {seconds:.1f} s with the processes' start on {smi}")
    return r0["launches"] + r1["launches"]


def profiled_batch(dev, smi):
    """Step 5: PhaseTimer and trace around one batch at SHARD_ENVS, the
    program's spans of that batch on the profile's clock (``span_clock``);
    then one more update timed without the profiler, its utilization of the
    card's dense bf16 peak, and ``dp_efficiency_model`` at that
    utilization."""
    from safelife_torch.parallel import distributed
    from safelife_torch.utils import profiling
    trainer = shard_trainer(dev, ppo.PPOConfig(data_shards=2))
    learner, ts, gen = trainer.ppo, trainer.train_state, trainer.generator
    from safelife_torch.parallel import mesh as pmesh
    stats, param_bytes = update_stats(trainer, pmesh.make_mesh(device=dev))
    timer = profiling.PhaseTimer()
    profiling.clear()
    with tempfile.TemporaryDirectory() as logdir:
        with profiling.trace(logdir) as prof:
            with timer.phase("rollout", block=True) as out:
                state, obs, traj, _ = ppo.rollout(
                    learner.cfg, ts.net, learner.env, trainer.bank,
                    trainer.env_state, trainer.obs, gen)
                out.append(traj.obs)
            with timer.phase("gae", block=True) as out:
                ret, adv = ppo.compute_gae(learner.cfg, traj.reward,
                                           traj.done, traj.value)
                out.append(adv)
            with timer.phase("update", block=True) as out:
                learner.update(ts, traj, ret, adv, gen)
                out.append(ts.spe)
        files = [f for f in os.listdir(logdir)
                 if f.endswith(".pt.trace.json")]
        assert len(files) == 1, files
        size = os.path.getsize(os.path.join(logdir, files[0]))
    summary = timer.summary()
    assert list(summary) == ["gae", "rollout", "update"], summary
    span_clock(prof)
    wall_ms = sum(v["total_s"] for v in summary.values()) * 1e3
    busy_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    assert busy_ms > 0, "the trace holds no device time"
    print(f"PhaseTimer over one batch at {SHARD_ENVS} envs (data_shards=2), "
          f"profiled: {summary}; trace {files[0]} {size} bytes; device busy "
          f"{busy_ms:.2f} ms of {wall_ms:.2f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.1%}")
    torch.cuda.synchronize()
    t = time.perf_counter()
    learner.update(ts, traj, ret, adv, gen)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t
    adam_steps = learner.cfg.epochs_per_batch * learner.cfg.num_minibatches
    util = adam_steps * stats["flops"] / update_s / PEAK_BF16_FLOPS
    model = {n: distributed.dp_efficiency_model(
        n, stats["flops"], param_bytes, util=util) for n in (2, 8)}
    print(f"update of {adam_steps} Adam steps at {stats['flops']:.4g} FLOPs "
          f"each: {update_s * 1e3:.2f} ms, {util:.4f} of the dense bf16 peak "
          f"{PEAK_BF16_FLOPS:.4g} FLOP/s on {smi}; dp_efficiency_model at "
          f"that utilization, {param_bytes} gradient bytes an Adam step and "
          f"the H100 SXM's 450 GB/s of NVLink: {model} (a model, not a "
          f"measurement)")


def span_clock(prof):
    """The program's spans of a profiled batch against the profile's own
    events of their names: each within 100 us of its event at both ends
    (one clock), and none on the device's rows."""
    from safelife_torch.utils import profiling
    mine = collections.defaultdict(list)
    for s in profiling.spans():
        mine[s.name].append(s)
    host = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name() in mine:
            assert e.device_type() == torch.autograd.DeviceType.CPU, (
                f"span {e.name()} on the device's rows")
            host[e.name()].append(e)
    offsets = collections.defaultdict(list)
    for name, records in mine.items():
        events = sorted(host[name], key=lambda e: e.start_ns())
        assert len(events) == len(records), (name, len(events), len(records))
        for s, e in zip(records, events):
            offsets[name] += [(s.start_ns - e.start_ns()) * 1e-3,
                              (s.end_ns - e.end_ns()) * 1e-3]
    worst = {name: max(v, key=abs) for name, v in offsets.items()}
    assert "ppo.update" in worst and all(
        abs(v) < 100 for v in worst.values()), worst
    count = sum(map(len, mine.values()))
    print(f"program spans against the profile's events, {count} spans: "
          f"largest offset (us) by name {worst}; ppo.update start "
          f"{offsets['ppo.update'][0]:+.2f} us, end "
          f"{offsets['ppo.update'][1]:+.2f} us")


def data_parallel(dev, smi):
    """Phase 12; returns its launches (the trainers' runs and the sharded
    halo steps, both ranks' included; not the comparisons')."""
    t = time.perf_counter()
    check_k2_k3_offset(dev)
    print(f"phase 12 K2/K3 offsets: {time.perf_counter() - t:.1f} s")
    launches = collections.Counter()
    for step, fn in (("one process", one_process_shards),
                     ("NCCL world size 1", nccl_world_one),
                     ("two gloo ranks", two_ranks)):
        t = time.perf_counter()
        launches.update(fn(dev, smi))
        print(f"phase 12 {step}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    profiled_batch(dev, smi)
    print(f"phase 12 profiled batch: {time.perf_counter() - t:.1f} s")
    for name in ("K1_action", "K2_advance_fold[static_spawnless]",
                 "S4_view_unpack", "K5_advance_with_field",
                 "K4_advance_spawnless", "T1_philox_words"):
        assert launches.get(name, 0) > 0, (name, launches)
    print(f"phase 12 launches {dict(launches)}")
    return launches


# ---------------------------------------------------------------------------
# Phase 13: the JAX round's scripts on the card.
# ---------------------------------------------------------------------------

# The suites validate_sinkhorn runs at full width (100 levels, time limit
# 1000, 250 samples): one spawnless, one whose spawns make the
# co-evolution random.  The JAX round's CPU figures for the same
# (random-policy) validation are read from its results file beside them.
VALIDATE_SUITES = ("append-still", "prune-spawn")
JAX_SINKHORN = "results/sinkhorn_validation.json"
# A gate on the card's Sinkhorn against the exact LP, per suite: the mean
# and largest relative error of the per-episode totals (the JAX round's
# largest over its eight suites: mean 0.0031, max 0.0289).
SINKHORN_MEAN_REL, SINKHORN_MAX_REL = 0.01, 0.05
# The run of phase 8 that phase 13's eval scripts replay, under a run
# directory with its .done marker.
SCRIPT_RUN = "append-still-s0"
SCALING_SIZES = (1, 2)
# The episodes of cpu_verify_finals (on the card's host CPU) and of
# eval_backend_diff (whose slowest configuration also runs on that CPU),
# cut from the eval's 1000 steps (25-34 s at full depth): the one depth
# phases 13 and 14 cut.
FINALS_TIME_LIMIT = 200
V01_TIME_LIMIT = 100
V01_LEVELS = 30


@contextlib.contextmanager
def stage_seconds(seconds, *targets):
    """Add the seconds of every call of each ``(module, name)`` function
    (the card synchronised before and after) to ``seconds[name]`` while
    inside; the functions are restored on exit."""
    saved = [(m, n, getattr(m, n)) for m, n in targets]

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t
            return out
        return run
    try:
        for m, n, fn in saved:
            setattr(m, n, timed(n, fn))
        yield seconds
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def state_tensors(out):
    """An env loop's (state, obs) as a list of tensors to compare."""
    state, obs = out
    return [getattr(state, f.name) for f in dataclasses.fields(state)
            if torch.is_tensor(getattr(state, f.name))] + [obs]


def check_microbench(dev, smi):
    """Both modes of ``scripts.microbench`` at their own sizes, then each
    row's chained loop against the same loop on the plain path, bit for
    bit (the uniform row's fields drawn before, outside a graph); returns
    the rows' launches (each row's warm-up and captured run)."""
    from safelife_torch.scripts import microbench as mb
    rows, launched = counted(lambda: {**mb.main(), **mb.op_bench()})
    for name, us in rows.items():
        route = mb.OP_ROUTES.get(name)
        print(f"microbench {name}{f' [{route}]' if route else ''}: "
              f"{us:.2f} us/step, {mb.B / us:.3f} M env-steps/s (B = "
              f"{mb.B}, {mb.STEPS} chained steps in a CUDA graph, best of "
              f"{scripts.REPEATS}); launches {scripts.ROW_LAUNCHES[name]} on "
              f"{smi}")
    bank, lv = mb.load(dev)
    spawn = torch.zeros(lv.board.shape, dtype=torch.bool, device=dev)
    assert_bit_equal([mb.ca_fixed(spawn)(lv.board)],
                     [mb.ca_fixed(spawn, plain=True)(lv.board)],
                     "microbench CA advance (fixed spawn field)")
    gen = torch.Generator(dev).manual_seed(3)
    fields = torch.rand((mb.STEPS,) + tuple(lv.board.shape), generator=gen,
                        device=dev) < mb.SPAWN_RATE
    assert_bit_equal([mb.ca_uniform(fields)(lv.board)],
                     [mb.ca_uniform(fields, plain=True)(lv.board)],
                     "microbench CA advance + uniform field")
    for name, cfg in mb.ENV_ROWS:
        env = BatchedSafeLifeEnv(EnvConfig(**cfg), device=dev)
        state = env.reset_all(bank, mb.B, torch.Generator(dev).manual_seed(0))
        got, want = (state_tensors(mb.env_steps(
            env, bank, torch.Generator(dev).manual_seed(4), plain=plain)(
                state)) for plain in (False, True))
        assert_bit_equal(got, want, f"microbench {name}")
    agents = mb.op_inputs(lv, torch.Generator(dev).manual_seed(0))
    kernels = mb.op_loops(bank, lv.goals, *agents)
    plain = mb.op_loops(bank, lv.goals, *agents, plain=True)
    for name, run in kernels.items():
        x = (torch.arange(mb.B, dtype=torch.int32, device=dev) % 100
             if name == "bank.take" else lv.board)
        assert_bit_equal([run(x)], [plain[name](x)], f"microbench {name}")
    print(f"microbench: every row's chained loop == the same loop on the "
          f"plain path, bit for bit (the CA rows, the three env rows' final "
          f"states and observations, the six ops rows); launches {launched}")
    return launched


def check_validate_sinkhorn(dev, smi, outdir):
    """``validate_sinkhorn.main`` at full width on VALIDATE_SUITES, the
    seconds of its four stages, its errors beside the JAX round's."""
    from safelife_torch import side_effects as se
    from safelife_torch.scripts import validate_sinkhorn as vs
    with open(JAX_SINKHORN) as fh:
        jax_round = json.load(fh)
    out = os.path.join(outdir, "sinkhorn_validation.json")
    launches = collections.Counter()
    for suite in VALIDATE_SUITES:
        seconds = {}
        with stage_seconds(seconds, (vs, "rollout"),
                           (se, "accumulate_distributions"),
                           (vs, "sinkhorn_scores"), (vs, "exact_scores")):
            results, launched = counted(lambda: vs.main([suite], out=out,
                                                         device=dev))
        launches.update(launched)
        r, ref = results[suite], jax_round[suite]
        assert r["episodes"] == 100 and r["scored_pairs"] > 0, r
        assert r["mean_rel_err"] < SINKHORN_MEAN_REL, r
        assert r["max_rel_err"] < SINKHORN_MAX_REL, r
        print(f"validate_sinkhorn {suite} (100 levels, time limit 1000, "
              f"{vs.SAMPLES} samples, random policy): rollout "
              f"{seconds['rollout']:.3f} s, co-evolution "
              f"{seconds['accumulate_distributions']:.3f} s, Sinkhorn "
              f"{seconds['sinkhorn_scores']:.3f} s, exact LP on the host "
              f"{seconds['exact_scores']:.3f} s ({r['scored_pairs']} pairs);"
              f" Sinkhorn vs LP rel err mean {r['mean_rel_err']:.4f}, p95 "
              f"{r['p95_rel_err']:.4f}, max {r['max_rel_err']:.4f} (the JAX "
              f"round's CPU run: {ref['mean_rel_err']:.4f} / "
              f"{ref['p95_rel_err']:.4f} / {ref['max_rel_err']:.4f}); mean "
              f"exact {r['mean_exact']:.3f}, Sinkhorn {r['mean_sinkhorn']:.3f}"
              f"; launches {launched} on {smi}")
    with open(out) as fh:
        assert sorted(json.load(fh)) == sorted(VALIDATE_SUITES)
    return launches


def check_eval_scripts(dev, smi, runs, outdir):
    """``eval_backend_diff --keys 1`` and ``cpu_verify_finals`` on phase 8's
    run: every configuration on its own device, and the card's plain path
    giving the kernel path's result for the same key."""
    from safelife_torch.scripts import cpu_verify_finals
    from safelife_torch.scripts import eval_backend_diff as ebd
    logdir = os.path.join(runs, SCRIPT_RUN)
    t = time.perf_counter()
    report = ebd.main(logdir, keys=1,
                      out=os.path.join(outdir, "eval_backend_diff.json"),
                      time_limit=FINALS_TIME_LIMIT)
    seconds = time.perf_counter() - t
    rows = {r["config"]: r for r in report["rows"]}
    assert sorted(rows) == sorted(ebd.CONFIGS), rows
    for config, r in rows.items():
        assert len(r["perf"]) == 100 and np.isfinite(r["perf"]).all(), config
        print(f"eval_backend_diff {config} key 0: mean_perf "
              f"{r['mean_perf']:.4f}, mean_reward {r['mean_reward']:.4f}, "
              f"mean_length {r['mean_length']:.1f}")
    same = ("perf", "mean_length", "mean_reward")
    assert all(rows["card plain path"][k] == rows["card default"][k]
               for k in same), (rows["card plain path"], rows["card default"])
    print(f"eval_backend_diff of {SCRIPT_RUN} (phase 8's 64-env run, view "
          f"{TRAIN_VIEW}), 5 configurations x 1 key, time limit "
          f"{FINALS_TIME_LIMIT}, each a subprocess, five at once: "
          f"{seconds:.1f} s; the card's plain path == its kernel path level "
          f"for level (same key) on {smi}")
    t = time.perf_counter()
    finals = cpu_verify_finals.main(runs, time_limit=FINALS_TIME_LIMIT)
    seconds = time.perf_counter() - t
    assert list(finals) == [SCRIPT_RUN], finals
    assert all(np.isfinite(v) for v in finals[SCRIPT_RUN].values())
    assert cpu_verify_finals.main(runs) == finals
    print(f"cpu_verify_finals on the CPU: {finals[SCRIPT_RUN]} in "
          f"{seconds:.1f} s (time limit {FINALS_TIME_LIMIT}: cut from 1000, "
          f"the CPU's depth); a rerun keeps the entry")


def check_scaling(dev, smi, outdir):
    """``scaling_report`` at SCALING_SIZES: one NCCL rank, then two gloo
    ranks sharing the card."""
    from safelife_torch.scripts import scaling_report as sr
    t = time.perf_counter()
    report = sr.main(SCALING_SIZES, device=dev,
                     out=os.path.join(outdir, "scaling.json"))
    seconds = time.perf_counter() - t
    base = report["sizes"][0]["hlo_flops_per_device"]
    for row in report["sizes"]:
        for f in row["flops_per_rank"]:
            assert abs(f - base) <= 0.10 * base, report
        moved = row["collective_bytes"]
        assert 0 < row["allreduce_bytes_per_sync"] <= 1.5 * report[
            "param_bytes"], row
        assert sum(v for k, v in moved.items() if k != "all-reduce") < 100_000
    print(f"scaling_report sizes {SCALING_SIZES} ({sr.ENVS_PER_DEVICE} envs "
          f"a rank; NCCL at 1, gloo ranks sharing the card at 2): flops a "
          f"rank {[r['flops_per_rank'] for r in report['sizes']]}, "
          f"all-reduce a sync "
          f"{[r['allreduce_bytes_per_sync'] for r in report['sizes']]} "
          f"bytes (parameters {report['param_bytes']}), nothing else; model "
          f"efficiency at {sr.PROD_ENVS_PER_DEVICE} envs "
          f"{[r['model_efficiency_prod'] for r in report['sizes']]}; "
          f"{seconds:.1f} s on {smi}")


def check_level_scripts(dev, smi, outdir):
    """The three level-data scripts into a temporary folder with
    ``--check``, then the rebuilt v0.1 suite through ``run_benchmark`` on
    the card."""
    from safelife_torch import benchmarking
    from safelife_torch.scripts import (level_archives, make_levels,
                                        make_puzzles, make_v01_levels)
    out = os.path.join(outdir, "levels")
    for maker, subdirs in ((make_puzzles, ("puzzles",)),
                             (make_levels, make_levels.SUBDIRS),
                             (make_v01_levels, (make_v01_levels.S,))):
        log = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(log):
            level_archives.main(maker.build, subdirs, "",
                                ["--out", out, "--check"])
        lines = log.getvalue().splitlines()
        print(f"{maker.__name__.rsplit('.', 1)[1]} --check: "
              f"{sum(ln.startswith('wrote') for ln in lines)} files in "
              f"{time.perf_counter() - t:.2f} s; {lines[-1]}")
    archives = [f for _, _, files in os.walk(out) for f in files
                if f.endswith(".npz")]
    assert len(archives) == 79, len(archives)
    bank = loader.load_bank(os.path.join(out, "benchmarks", "v0.1"),
                            device=dev)
    assert bank.num_levels == V01_LEVELS
    t = time.perf_counter()
    res, launched = counted(lambda: benchmarking.run_benchmark(
        bank, benchmarking.random_policy(),
        generator=torch.Generator(dev).manual_seed(0),
        time_limit=V01_TIME_LIMIT))
    assert len(res["performance"]) == V01_LEVELS
    for name in ("performance", "reward", "length"):
        assert np.isfinite(res[name]).all(), name
    print(f"the rebuilt v0.1 suite ({V01_LEVELS} levels, 25x25) through "
          f"run_benchmark on the card, random policy, time limit "
          f"{V01_TIME_LIMIT}: {time.perf_counter() - t:.2f} s, mean "
          f"performance {res['performance'].mean():.4f}, length "
          f"{res['length'].mean():.1f}; launches {launched} on {smi}")
    return launched


def jax_round_files():
    """A digest of each file the JAX round's scripts write (SCALING.json,
    results/*.json, the packaged levels): the ports write elsewhere."""
    import glob
    import hashlib
    paths = ["SCALING.json", *glob.glob("results/*.json"), *glob.glob(
        os.path.join(loader.PACKAGED_LEVELS, "**", "*"), recursive=True)]
    out = {}
    for path in sorted(p for p in paths if os.path.isfile(p)):
        with open(path, "rb") as fh:
            out[path] = hashlib.sha256(fh.read()).hexdigest()
    return out


def scripts_phase(dev, smi, runs):
    """Phase 13; returns its launches in this process (the bank loads, the
    microbench rows, the validation, the v0.1 eval; not the comparisons',
    nor those of the subprocesses the eval and scaling scripts start)."""
    launches = collections.Counter()
    before = jax_round_files()
    with tempfile.TemporaryDirectory() as outdir:
        for step, fn in (
                ("microbench", lambda: check_microbench(dev, smi)),
                ("validate_sinkhorn",
                 lambda: check_validate_sinkhorn(dev, smi, outdir)),
                ("eval_backend_diff and cpu_verify_finals",
                 lambda: check_eval_scripts(dev, smi, runs, outdir)),
                ("scaling_report", lambda: check_scaling(dev, smi, outdir)),
                ("level data", lambda: check_level_scripts(dev, smi, outdir))):
            t = time.perf_counter()
            launches.update(fn() or {})
            print(f"phase 13 {step}: {time.perf_counter() - t:.1f} s")
    for name in ("K1_action", "K2_advance_fold[static_spawnless]",
                 "K3_advance_noreset[static_spawnless]",
                 "K5_advance_with_field", "S4_view_unpack",
                 "K4_advance_spawnless"):
        assert launches.get(name, 0) > 0, (name, launches)
    assert jax_round_files() == before, "a script wrote the JAX round's files"
    print(f"phase 13 launches {dict(launches)}; the {len(before)} files of "
          f"the JAX round's scripts (SCALING.json, results/*.json, the "
          f"packaged levels) unchanged")
    return launches


# ---------------------------------------------------------------------------
# Phase 14: the launch tooling.
# ---------------------------------------------------------------------------

# The sweep phase 14 runs through launch local (one NCCL rank): 64
# environments (the sweep's), two batches of PPOConfig's 20 steps each.
LAUNCH_RUNS = ("append-still-s0", "append-still+penalty0.5+lstm-s1")
LAUNCH_STEPS = ROLLOUT * CLI_ENVS + 1
LAUNCH_TIMEOUT_S = 300
LOG_TIME = "%Y-%m-%d %H:%M:%S,%f"


def log_times(lines):
    """(seconds, message) of each ``asctime`` line of a training log."""
    import datetime
    out = []
    for line in lines:
        try:
            stamp = datetime.datetime.strptime(line[:23], LOG_TIME)
        except ValueError:
            continue
        out.append((stamp.timestamp(), line[24:]))
    return out


def batch_rate(records):
    """Env-steps/s of the second batch from a training log's clock: the
    first batch's report to the final checkpoint; and NCCL's bring-up
    seconds where the run joined a group (else None)."""
    report = next((t, int(m[1])) for t, msg in records
                  if (m := re.search(r"step (\d+)/\d+ ", msg)))
    saved = next((t, int(m[1])) for t, msg in records
                 if (m := re.search(r"saved checkpoint at step (\d+)", msg)))
    up = next((float(m[1]) for _, msg in records
               if (m := re.search(r"nccl on cuda:\d+ in ([\d.]+) s", msg))),
              None)
    return (saved[1] - report[1]) / (saved[0] - report[0]), up


# A training log's milestones, in order.
MILESTONES = (("group up", "process group up"), ("first report", "step "),
              ("checkpoint", "saved checkpoint"), ("eval", "eval @"),
              ("done", "training done"))


def timeline(records, start):
    """Seconds from ``start`` (the wall clock) to each milestone a log
    shows."""
    out = []
    for label, text in MILESTONES:
        t = next((t for t, msg in records if text in msg), None)
        if t is not None:
            out.append(f"{label} +{t - start:.1f} s")
    return ", ".join(out)


def run_checkpoint(logdir):
    root = os.path.join(logdir, "checkpoints")
    (name,) = os.listdir(root)
    return torch.load(os.path.join(root, name), map_location="cpu",
                      weights_only=True)


def launch_dry_runs(runs):
    """``launch pod`` (2 hosts x 1 card), ``remote_job start`` and ``sweep
    --round r5``, each with ``--dry-run``: the commands they print, and
    nothing run or written."""
    import shlex
    from safelife_torch.scripts import launch, remote_job, sweep
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert launch.main(["pod", "h1,h2", "us-z", "/data/run",
                            "--gpus-per-host", "1", "--dry-run", "--",
                            "--task", "append-still"]) == 0
    lines = out.getvalue().splitlines()
    assert len(lines) == 4, lines
    for host, line in zip(("h1", "h2"), lines[:2]):
        assert line.endswith(f" {launch.REPO} '{host}:~/safelife_torch_job'")
    for rank, (host, line) in enumerate(zip(("h1", "h2"), lines[2:])):
        assert shlex.split(line)[:4] == ["+", "gcloud", "compute", "ssh"]
        assert (f"SAFELIFE_COORDINATOR=h1:29500 SAFELIFE_NUM_PROCS=2 "
                f"SAFELIFE_PROC_ID={rank} nohup python -m safelife_torch "
                f"train /data/run --task append-still > train-{host}-{rank}"
                f".log") in line, line
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert remote_job.main(["start", "inst", "job", "--zone", "us-z",
                                "--dry-run", "--", "--task",
                                "append-still"]) == 0
    lines = out.getvalue().splitlines()
    assert [shlex.split(x)[1] for x in lines] == ["rsync", "gcloud",
                                                   "gcloud"], lines
    assert "python -m safelife_torch train ~/job/data/job --task " \
           "append-still" in lines[1]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert sweep.main(["--runs-dir", runs, "--round", "r5",
                           "--dry-run"]) == 0
    lines = out.getvalue().splitlines()
    assert len(lines) == len(sweep.ROUNDS["r5"]) + 2, lines
    assert not os.path.exists(runs)
    print(f"dry runs: launch pod 2 hosts x 1 card (2 syncs, "
          f"2 starts, ranks 0 and 1 on h1:29500), remote_job start (rsync, "
          f"tmux + tensorboard, attach), sweep --round r5 "
          f"({len(sweep.ROUNDS['r5'])} runs and the tail); nothing run")


def launch_phase(dev, smi):
    """Phase 14: the dry runs, a two-run sweep through ``launch local``
    (one NCCL rank a run) against a direct ``train`` in this process with
    the first run's arguments, a second sweep call that skips both runs,
    the tail (CPU finals at FINALS_TIME_LIMIT steps, ``summarize_runs``)
    and ``run_tb``'s summary; returns the direct run's launches."""
    import logging
    from safelife_torch.__main__ import main as cli
    from safelife_torch.scripts import (cpu_verify_finals, run_tb,
                                        summarize_runs, sweep)
    steps = {}
    with tempfile.TemporaryDirectory() as tmp:
        runs, results = os.path.join(tmp, "runs"), os.path.join(
            tmp, "RESULTS.md")
        t = time.perf_counter()
        launch_dry_runs(runs)
        steps["dry runs"] = time.perf_counter() - t

        # The sweep through launch local, each run timed.
        argv = ["--runs-dir", runs, "--only", *LAUNCH_RUNS, "--steps",
                str(LAUNCH_STEPS), "--nproc", "1", "--timeout",
                str(LAUNCH_TIMEOUT_S), "--results", results,
                "--finals-time-limit", str(FINALS_TIME_LIMIT)]
        trained, starts = [], {}
        saved = [(sweep, "train"), (cpu_verify_finals, "main"),
                 (summarize_runs, "main")]
        saved = [(m, n, getattr(m, n)) for m, n in saved]

        def timed(module, fn):
            def run(*args, **kwargs):
                t = time.perf_counter()
                out = fn(*args, **kwargs)
                name = module.__name__.rsplit(".", 1)[1]
                if fn is saved[0][2]:  # sweep.train(logdir, ...)
                    name = f"launched {os.path.basename(args[0])}"
                    trained.append(os.path.basename(args[0]))
                    starts[trained[-1]] = time.time() - (
                        time.perf_counter() - t)
                steps[name] = steps.get(name, 0) + time.perf_counter() - t
                return out
            return run
        try:
            for m, n, fn in saved:
                setattr(m, n, timed(m, fn))
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = sweep.main(argv)
            assert rc == 0, out.getvalue()[-4000:]
            assert trained == list(LAUNCH_RUNS), trained
            t = time.perf_counter()
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                assert sweep.main(argv) == 0
            steps["second sweep call"] = time.perf_counter() - t
        finally:
            for m, n, fn in saved:
                setattr(m, n, fn)
        assert trained == list(LAUNCH_RUNS), trained
        for name in LAUNCH_RUNS:
            assert f"skip {os.path.join(runs, name)}" in out.getvalue()
            assert os.path.exists(os.path.join(runs, name + ".done"))
        logs = {}
        for name in LAUNCH_RUNS:
            with open(os.path.join(runs, name + ".log")) as fh:
                logs[name] = fh.read().splitlines()
            assert any(re.search(r"eval @ \d+: levels=100 ", x)
                       for x in logs[name]), logs[name][-20:]
            assert any("process group up: rank 0/1, nccl on cuda:" in x
                       for x in logs[name]), logs[name][-20:]

        # The direct run: python -m safelife_torch train with run 1's
        # arguments, in this process, without the episode video (it comes
        # after the final checkpoint from a generator of its own, and no
        # check reads it).
        first = sweep.parse_name(LAUNCH_RUNS[0])
        direct = os.path.join(tmp, "direct", LAUNCH_RUNS[0])
        records = []
        handler = logging.Handler()
        handler.emit = lambda r: records.append((r.created, r.getMessage()))
        log = logging.getLogger("safelife_torch")
        level = log.level
        log.addHandler(handler)
        log.setLevel(logging.INFO)
        video = driver.Trainer.maybe_record_video
        driver.Trainer.maybe_record_video = lambda self: None
        try:
            t = time.perf_counter()
            starts["direct"] = time.time()
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                _, launches = counted(lambda: cli([
                    "train", direct, *sweep.train_args(first, 0,
                                                       LAUNCH_STEPS)]))
            steps["direct train in process"] = time.perf_counter() - t
        finally:
            driver.Trainer.maybe_record_video = video
            log.removeHandler(handler)
            log.setLevel(level)
        got, want = (run_checkpoint(os.path.join(runs, LAUNCH_RUNS[0])),
                     run_checkpoint(direct))
        assert got["net"].keys() == want["net"].keys()
        for k, v in want["net"].items():
            assert_bit_equal([got["net"][k]], [v],
                             f"launched against direct {k}")
        assert torch.equal(got["spe"], want["spe"])
        assert got["counters"] == want["counters"], (got["counters"],
                                                     want["counters"])
        for name in ("K1_action", "S4_view_unpack", "K5_advance_with_field"):
            assert launches.get(name, 0) > 0, (name, launches)
        assert any(k.startswith("K2_advance_fold") for k in launches)
        assert any(k.startswith("K3_advance_noreset") for k in launches)
        rates = {name: batch_rate(log_times(logs[name]))
                 for name in LAUNCH_RUNS}
        direct_rate, _ = batch_rate(records)
        print(f"launch local --nproc 1 (NCCL, world size 1) of "
              f"{LAUNCH_RUNS[0]} ({CLI_ENVS} envs, {got['update_step']} "
              f"batches, {got['counters']['num_steps']} env steps): final "
              f"parameters and spe bit-equal to train in this process with "
              f"the same arguments; launches of the direct run {launches}")
        for name, (rate, up) in rates.items():
            print(f"launched {name}: second batch {rate:.0f} env-steps/s "
                  f"(the log's clock), NCCL bring-up {up:.3f} s, "
                  f"{steps['launched ' + name]:.1f} s in all ("
                  f"{timeline(log_times(logs[name]), starts[name])}), on "
                  f"{smi}")
        print(f"direct {LAUNCH_RUNS[0]}: second batch {direct_rate:.0f} "
              f"env-steps/s (the log's clock), "
              f"{steps['direct train in process']:.1f} s in all, no video ("
              f"{timeline(records, starts['direct'])}), on {smi}")

        # The tail's products and run_tb's summary.
        with open(os.path.join(runs, "cpu_finals.json")) as fh:
            finals = json.load(fh)
        assert sorted(finals) == sorted(LAUNCH_RUNS), finals
        with open(results) as fh:
            text = fh.read()
        for name in LAUNCH_RUNS:
            task = name.rsplit("-s", 1)[0]
            assert f"## {task} (1 seeds)" in text, text[-2000:]
        assert text.count("**CPU-verified final mean_perf:") == 2
        t = time.perf_counter()
        summary = run_tb.summarize([os.path.join(runs, n)
                                    for n in LAUNCH_RUNS])
        steps["run_tb summary"] = time.perf_counter() - t
        jsonl = [n for n in LAUNCH_RUNS if os.path.exists(
            os.path.join(runs, n, "scalars.jsonl"))]
        assert sum(line.endswith(":") for line in summary) == len(jsonl)
        print(f"tail: cpu_verify_finals (time limit {FINALS_TIME_LIMIT}) "
              f"{finals}; RESULTS.md holds both rows; run_tb summarizes "
              f"{len(jsonl)} scalars.jsonl streams "
              f"({len(summary) - len(jsonl)} tags; the others' tensorboard "
              f"event files are tensorboard's to read)")
    for name, seconds in steps.items():
        print(f"phase 14 {name}: {seconds:.1f} s")
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
    if sys.argv[1:2] == ["--rank"]:  # a rank of phase 12's two-rank run
        rank_main(sys.argv[2])
        return
    pycache = tempfile.mkdtemp(prefix="chip-smoke-pyc-")
    try:
        run_all(pycache)
    finally:
        shutil.rmtree(pycache, ignore_errors=True)


def run_all(pycache):
    """Every phase; the result lines at the end."""
    dev = torch.device("cuda", torch.cuda.current_device())
    # Where Python is told not to write bytecode (PYTHONDONTWRITEBYTECODE),
    # each process this run starts (phases 11-14: pool workers, ranks,
    # eval and training subprocesses) compiles the sources of torch and its
    # imports anew, 10-20 s a process.  The run's processes share one
    # bytecode cache instead: the first to import a module writes it.
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix = pycache
    sys.dont_write_bytecode = False

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

    # Phase 8's run, finished (its .done marker), for phase 13's scripts.
    runs = tempfile.mkdtemp()
    try:
        t = time.perf_counter()
        trained = training(dev, smi, os.path.join(runs, SCRIPT_RUN))
        open(os.path.join(runs, SCRIPT_RUN + ".done"), "w").close()
        print(f"phase 8: {time.perf_counter() - t:.1f} s")
        kernels = later_phases(dev, smi, runs, trained, launches, timings,
                               paths, script)
    finally:
        shutil.rmtree(runs)
    print(json.dumps({"kernels": kernels}))
    assert not spilled, f"kernel instantiations spill: {spilled}"
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


def later_phases(dev, smi, runs, trained, launches, timings, paths, script):
    """Phases 9-14, then the kernels line's entries: each kernel's
    launches on the main path and phases 8-14 beside its times."""
    t = time.perf_counter()
    evaluated = evaluation(dev, smi)
    print(f"phase 9: {time.perf_counter() - t:.1f} s")
    for name in EVAL_KERNELS:
        assert evaluated.get(name, 0) > 0, (name, evaluated)
    assert any(k.startswith("K3_advance_noreset") for k in evaluated)

    t = time.perf_counter()
    played = game_layer(dev, smi)
    print(f"phase 10: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    supplied = level_supply(dev, smi)
    print(f"phase 11: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    sharded = data_parallel(dev, smi)
    print(f"phase 12: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    scripted = scripts_phase(dev, smi, runs)
    print(f"phase 13: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    launched = launch_phase(dev, smi)
    print(f"phase 14: {time.perf_counter() - t:.1f} s")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        err, ms, plain_ms, bound_ms, bound_by = timings[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            # The main path's launches, the training path's, the
            # evaluation path's, the game layer's, the level supply's, the
            # data-parallel training's, the scripts' and the launch
            # tooling's.
            launches=launches[name] + trained.get(name, 0)
            + evaluated.get(name, 0) + played.get(name, 0)
            + supplied.get(name, 0) + sharded.get(name, 0)
            + scripted.get(name, 0) + launched.get(name, 0),
            max_abs_err=err,
            ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            # R1's plain version is one PyTorch call (a sum).
            library_ms=plain_ms if name == "R1_obs_sum" else None))
    for name, (source, replaces, counter, path) in SCRIPT_KERNELS.items():
        err, ms, plain_ms, bound_ms, bound_by, library_ms = script[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            # T1 also runs in the game layer's selftest and training, in
            # the level supply's and the data-parallel trainers, and in
            # the scripts' and the launch tooling's phases.
            launches=paths[path][counter] + (
                played.get(counter, 0) + supplied.get(counter, 0)
                + sharded.get(counter, 0) + scripted.get(counter, 0)
                + launched.get(counter, 0) if path == "bench" else 0),
            max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms))
    return kernels


if __name__ == "__main__":
    main()
