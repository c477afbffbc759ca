"""Benchmark runner: evaluate a policy over frozen benchmark suites (port
of ``safelife_tpu.benchmarking``).

Capability parity with ``safelife/benchmarking.py`` (``run_benchmark``
over ``benchmarks/v1.0/<name>`` with YAML logging and ``load_benchmarks``
for analysis), in lockstep: all levels of the suite run at once as one
device batch, and each level's stats are captured at its first episode
end.  The step is ``EnvConfig(auto_reset=False)``: on a CUDA device
kernels K1 and K3 under the suite's rule, then the view kernel's UNPACK.
Side effects are scored by :mod:`.side_effects` (its co-evolution through
kernel K5 on the card).
"""

import os
import time

import numpy as np
import torch

from . import resolve_device
from .env.env import BatchedSafeLifeEnv, EnvConfig
from .levels import loader
from .utils.integrity import check_bank_reset_integrity

BENCHMARK_ROOT = "benchmarks/v1.0"
RECORDS = ("length", "reward", "completed", "possible")


def random_policy(num_actions=9):
    """``policy(obs, generator=None)``: uniform random actions."""
    def policy(obs, generator=None):
        return torch.randint(0, num_actions, (obs.shape[0],),
                             generator=generator, device=obs.device)
    return policy


def _step(env, state, bank, action, generator):
    """One suite step.  The plain path takes the spawn fields the kernels
    draw from the same seed, so both paths see the same spawns."""
    if env.uses_kernels():
        return env.step(state, bank, action, generator)
    board, goals = env.kernel_spawn_fields(state, bank,
                                           env.step_seed(generator))
    return env.step(state, bank, action, spawn_board=board,
                    spawn_goals=goals)


def play_suite(env, bank, policy, batch, generator=None, chunk=64):
    """Play ``batch`` environments of ``env`` (``auto_reset=False``),
    environment b on level ``b % num_levels``, until every episode has
    ended, in chunks of ``chunk`` steps: ``done`` is read on the host once
    a chunk, never once a step.

    ``policy(obs, generator=None) -> actions``; a recurrent one
    (``policy.recurrent``) is ``policy(obs, carry, generator=None) ->
    (actions, carry)`` starting from ``policy.init_carry(batch)`` (eval
    episodes do not reset, so the carry is never masked).  Returns (the
    records of each environment's first episode, as device tensors under
    ``done`` and :data:`RECORDS`; the final state).
    """
    dev = env.device
    state = env.reset_to_levels(
        bank, torch.arange(batch, device=dev) % bank.num_levels)
    obs = env.observe(state)
    recurrent = bool(getattr(policy, "recurrent", False))
    carry = policy.init_carry(batch) if recurrent else None
    i32 = dict(dtype=torch.int32, device=dev)
    rec = dict(done=torch.zeros(batch, dtype=torch.bool, device=dev),
               length=torch.zeros(batch, **i32),
               reward=torch.zeros(batch, dtype=torch.float32, device=dev),
               completed=torch.zeros(batch, **i32),
               possible=torch.zeros(batch, **i32))
    fields = dict(length="episode_length", reward="episode_reward",
                  completed="perf_completed", possible="perf_possible")
    time_limit = env.config.time_limit
    for _ in range(0, time_limit + chunk, chunk):
        for _ in range(chunk):
            if recurrent:
                action, carry = policy(obs, carry, generator=generator)
            else:
                action = policy(obs, generator=generator)
            state, ts = _step(env, state, bank, action, generator)
            newly = ts.done & ~rec["done"]
            for key, name in fields.items():
                rec[key] = torch.where(newly, getattr(ts, name), rec[key])
            rec["done"] = rec["done"] | ts.done
            obs = ts.obs
        if bool(rec["done"].all()):
            break
    return rec, state


def run_benchmark(benchmark_name, policy, logfile=None, generator=None,
                  view_shape=(25, 25), time_limit=1000, chunk=64,
                  side_effect_samples=0, pad_to_lanes=False, device=None,
                  use_kernels=True):
    """Run ``policy(obs, generator=None) -> actions`` over every level of a
    suite on ``device`` (``cuda`` unless the caller passes another; a
    given bank's own device).

    benchmark_name: suite name (e.g. "append-still"), a path, or a
    prebuilt LevelBank.  ``generator`` (a ``torch.Generator`` on the
    device; default seed 0) draws the policy's actions, the spawns and
    the side-effect co-evolution's fields.  A recurrent policy (with
    ``.recurrent`` and ``.init_carry``) is called as ``policy(obs, carry,
    generator=None) -> (actions, carry)``.  ``use_kernels=False`` runs
    the plain step and co-evolution instead of the kernels (the same
    draws).

    Returns a dict of numpy arrays (one entry per level): length, reward,
    completed, possible, performance (+ side_effects, side_effect_mass
    and side_effects_by_type when side_effect_samples > 0), the names,
    ``wall_time`` (seconds of the step loop) and, with side effects,
    ``side_effect_time`` (seconds of the co-evolution, of the Sinkhorn
    EMD).

    ``pad_to_lanes`` tiles the level batch up to a multiple of 128 and
    drops the padding from the results (padding lanes replay real
    levels).  The JAX package pads by default on a TPU to stay on its
    fused step; the kernels here take any batch, so the default is no
    padding.  Per-level results do not depend on it, except through a
    policy's batched random draws.
    """
    if isinstance(benchmark_name, str):
        device = resolve_device(device)
        path = benchmark_name if os.sep in benchmark_name or \
            benchmark_name.endswith(".npz") else \
            f"{BENCHMARK_ROOT}/{benchmark_name}.npz"
        levels = loader.load_levels(path)
        bank = loader.build_bank(levels, device=device)
        names = [lv["name"] for lv in levels]
    else:
        bank = benchmark_name
        device = bank.board.device
        names = [f"level-{i}" for i in range(bank.num_levels)]
    # Levels must survive the device reset gather bit for bit before any
    # reported number is trusted (utils/integrity.py).
    check_bank_reset_integrity(bank)

    env = BatchedSafeLifeEnv(EnvConfig(
        view_shape=view_shape, time_limit=time_limit, auto_reset=False,
        use_kernels=use_kernels), device=device)
    n = bank.num_levels
    b = -(-n // 128) * 128 if pad_to_lanes else n
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)

    t0 = time.perf_counter()
    rec, state = play_suite(env, bank, policy, b, generator, chunk)
    rec = {k: rec[k][:n].cpu().numpy() for k in RECORDS}
    results = {
        "name": names,
        **rec,
        "performance": rec["completed"] / np.maximum(rec["possible"], 1),
        "wall_time": time.perf_counter() - t0,
    }

    if side_effect_samples > 0:
        from . import side_effects as se
        from .render.text import cell_name
        t0 = time.perf_counter()
        action, inaction = se.accumulate_distributions(
            state.init_board, state.board, state.spawn_prob,
            state.episode_length, side_effect_samples, generator,
            catch_up_steps=time_limit, use_kernels=use_kernels)
        if device.type == "cuda":
            torch.cuda.synchronize(device)  # the co-evolution's time
        t1 = time.perf_counter()
        scores, mass = se.score_distributions(action, inaction)
        sc, ms = scores[:, :n].cpu().numpy(), mass[:, :n].cpu().numpy()
        results["side_effect_time"] = (t1 - t0, time.perf_counter() - t1)
        results["side_effects"] = sc.sum(axis=0)
        results["side_effect_mass"] = ms.sum(axis=0)
        # Per-cell-type structure, the form the reference reports and the
        # safety analysis consumes (reference side_effects.py:152-161):
        # canonical type name -> ((B,) emd, (B,) inaction mass).
        results["side_effects_by_type"] = {
            cell_name(k): (sc[j], ms[j])
            for j, k in enumerate(se.DEFAULT_TRACKED)}

    if logfile:
        _append_log(logfile, results, n)
    return results


def _append_log(logfile, results, n):
    """Append one YAML flow mapping a level, the JAX package's text form."""
    os.makedirs(os.path.dirname(os.path.abspath(logfile)), exist_ok=True)
    with open(logfile, "a") as fh:
        for i in range(n):
            entry = {
                "name": str(results["name"][i]),
                "length": int(results["length"][i]),
                "reward": round(float(results["reward"][i]), 3),
                "completed": int(results["completed"][i]),
                "possible": int(results["possible"][i]),
                "performance": round(float(results["performance"][i]), 4),
            }
            if "side_effects" in results:
                entry["side_effects"] = round(
                    float(results["side_effects"][i]), 3)
            items = ", ".join(f"{k}: {v}" for k, v in entry.items())
            if "side_effects_by_type" in results:
                # (emd, inaction-mass) pairs per canonical cell type
                # present on this level, reference YAML form.
                per = ", ".join(
                    f"{name}: [{float(s[i]):.3f}, {float(m[i]):.3f}]"
                    for name, (s, m)
                    in results["side_effects_by_type"].items()
                    if m[i] > 0 or s[i] > 0)
                items += f", side_effects_by_type: {{{per}}}"
            fh.write(f"- {{{items}}}\n")


def load_benchmarks(logfile):
    """Parse a benchmark YAML log back into numpy arrays."""
    import yaml

    with open(logfile) as fh:
        records = yaml.safe_load(fh) or []
    if not records:
        return {}
    keys = records[0].keys()
    out = {}
    for k in keys:
        vals = [r.get(k) for r in records]
        out[k] = np.array(vals) if not isinstance(vals[0], str) \
            else np.array(vals, dtype=object)
    return out


def summarize(results):
    """One-line human summary of a run_benchmark result dict."""
    perf = np.asarray(results["performance"], float)
    line = (f"levels={len(perf)} mean_perf={perf.mean():.3f} "
            f"median_perf={np.median(perf):.3f} "
            f"mean_reward={np.mean(results['reward']):.2f} "
            f"mean_length={np.mean(results['length']):.1f}")
    if "side_effects" in results:
        line += f" mean_side_effects={np.mean(results['side_effects']):.3f}"
    return line
