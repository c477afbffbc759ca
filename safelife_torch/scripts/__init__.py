"""Measurement entry points of the port on the card, one per script of the
JAX package's ``scripts/`` that launches a Pallas kernel:

    python -m safelife_torch.scripts.stepbench      # the env step, decomposed
    python -m safelife_torch.scripts.ablock_bench   # K1 over block widths
    python -m safelife_torch.scripts.obs_micro      # the crop, transpose and stencil kernels
    python -m safelife_torch.scripts.stress_micro   # the stress step and K8

Each keeps its script's sizes, rows and printed names, runs on ``cuda``
(raising without a card; ``main(device="cpu")`` runs the plain versions)
and times chained loops: every iteration's output feeds the next.  On the
card a loop is captured once in a CUDA graph and its replays are timed
between CUDA events, so a row is the device's time for the chained work
with no host launch gaps between kernels, as the JAX scripts' jit + scan
were.

One more reads the built kernels' machine code (``cuobjdump``), on the
machine that builds them:

    python -m safelife_torch.scripts.sass_count     # SASS instructions a loop and cell

The ports of the JAX round's other scripts, each writing where its
``--out`` points (by default under :data:`RESULTS`):

    python -m safelife_torch.scripts.microbench         # the step's parts
    python -m safelife_torch.scripts.validate_sinkhorn  # Sinkhorn vs the LP
    python -m safelife_torch.scripts.cpu_verify_finals  # finals on the CPU
    python -m safelife_torch.scripts.eval_backend_diff  # an eval gap's causes
    python -m safelife_torch.scripts.scaling_report     # data-parallel profile
    python -m safelife_torch.scripts.make_puzzles       # the level data
    python -m safelife_torch.scripts.make_levels
    python -m safelife_torch.scripts.make_v01_levels

The launch tooling (the ports of ``scripts/launch-pod``, ``remote-job``,
``run-tb``, ``sweep_r*.sh`` and ``summarize_runs.py``):

    python -m safelife_torch.scripts.launch          # train as ranks: local, or GPU VMs
    python -m safelife_torch.scripts.remote_job      # one VM: rsync, tmux, tensorboard
    python -m safelife_torch.scripts.sweep           # the JAX round's sweeps
    python -m safelife_torch.scripts.summarize_runs  # RESULTS.md from the logs
    python -m safelife_torch.scripts.run_tb          # tensorboard over run dirs
"""

import collections
import os
import time

import torch

from ..ops import _build
from ..ops.obs import obs_sum

# Where the scripts write their results by default (the JAX round's files
# under results/ and SCALING.json stay as they are).
RESULTS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "results", "torch")
# Timed runs per row after one warm-up run; the best counts.
REPEATS = 3
# Row name -> the kernel launches its wrappers counted in that row: the
# warm-up run and the captured run (a replay launches the captured kernels
# without passing through their wrappers).
ROW_LAUNCHES = {}


def best_of(device, fn, *args):
    """Seconds of the fastest of :data:`REPEATS` runs of ``fn(*args)``
    after one warm-up run: on CUDA, replays of one CUDA graph of the run
    between CUDA events; on the CPU, the host clock."""
    fn(*args)
    best = float("inf")
    if device.type != "cuda":
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            fn(*args)
            best = min(best, time.perf_counter() - t0)
        return best
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(REPEATS):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def timeit(name, steps, device, fn, *args, batch=None):
    """Print and return the microseconds per chained iteration of
    ``fn(*args)`` (``steps`` iterations a run), with the env-steps/s of
    ``batch`` environments when given; records the row's launches in
    :data:`ROW_LAUNCHES`."""
    before = collections.Counter(_build.LAUNCHES)
    best = best_of(device, fn, *args)
    ROW_LAUNCHES[name] = dict(collections.Counter(_build.LAUNCHES) - before)
    rate = (f"  {batch * steps / best / 1e6:8.2f} M env-steps/s"
            if batch else "")
    print(f"{name:44s} {best / steps * 1e6:9.1f} us/step{rate}", flush=True)
    return best / steps * 1e6


def env_loop(env, bank, batch, steps, rollout):
    """A chained run of ``steps`` env steps (fresh levels every
    ``rollout``) from one reset state of ``batch`` environments, summing
    every reward and observation: ``(run, state)`` for :func:`best_of`."""
    dev = env.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = env.reset_all(bank, batch, gen)
    # A CUDA graph captures draws from the device's default generator only.
    gen = None if dev.type == "cuda" else gen

    def run(state):
        total = torch.zeros((), dtype=torch.float64, device=dev)
        for _ in range(steps // rollout):
            fresh = env.sample_fresh_levels(bank, batch, gen)
            for _ in range(rollout):
                action = torch.randint(0, 9, (batch,), generator=gen,
                                       device=dev, dtype=torch.int32)
                state, ts = env.step(state, bank, action, gen,
                                     fresh_levels=fresh)
                total += ts.reward.sum()
                if ts.obs is not None:
                    total += obs_sum(ts.obs)
        return state, total
    return run, state


def add_u16(x, fed):
    """``x + fed`` in uint16 arithmetic (wrapping) for a uint16 tensor
    ``x`` and an integer tensor ``fed`` broadcast against it."""
    return ((x.to(torch.int32) + fed) & 0xFFFF).to(torch.uint16)
