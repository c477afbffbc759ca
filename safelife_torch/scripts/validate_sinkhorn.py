"""Per-suite validation of the Sinkhorn EMD against the exact LP solver (the
port of ``scripts/validate_sinkhorn.py``).

    python -m safelife_torch.scripts.validate_sinkhorn [suite ...]
    python -m safelife_torch.scripts.validate_sinkhorn --runs <run dir>

Side effects are reported from ``side_effects.sinkhorn_emd`` (entropic OT,
eps = 0.02, float32 with TF32 off); the reference reports the exact EMD,
matched here by the host ``earth_mover_distance`` (scipy HiGHS).  For each
suite this rolls every level to its end with a random policy (or, with
``--runs``, each finished run's trained sampling policy) through K1 + K3,
accumulates the action and inaction occupancy distributions as an eval
does (250 samples, the co-evolution on K5), scores every (cell type,
episode) pair both ways and reports the relative error of the per-episode
total.  Writes ``results/torch/sinkhorn_validation.json`` (``--runs``:
``sinkhorn_validation_trained.json``; ``--out`` names another file),
resumable, and prints a markdown table.  Runs on ``cuda`` unless given
``--device``.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

from .. import resolve_device
from .. import side_effects as se
from ..benchmarking import BENCHMARK_ROOT, _step
from ..env.env import BatchedSafeLifeEnv, EnvConfig
from ..levels import loader
from . import RESULTS
from .cpu_verify_finals import finished_runs

SUITES = ["append-still", "append-dynamic", "append-spawn",
          "prune-still", "prune-still-hard", "prune-dynamic",
          "prune-spawn", "navigation"]
SAMPLES = 250           # the trainer's eval default (TrainerConfig)
EPS, ITERS = 0.02, 200  # side_effect_score_batched's defaults


def rollout(bank, time_limit=1000, generator=None, policy=None,
            view_shape=None):
    """Every level of ``bank`` from its start, no auto reset, until every
    episode has ended or ``time_limit`` steps: random actions from
    ``generator``, or ``policy``'s (``policy(obs, generator)``, a
    recurrent one with its carry).  Returns the final state."""
    n = bank.num_levels
    dev = bank.board.device
    env = BatchedSafeLifeEnv(EnvConfig(
        auto_reset=False, time_limit=time_limit,
        compute_obs=policy is not None, view_shape=view_shape or (15, 15)),
        device=dev)
    state = env.reset_to_levels(bank, torch.arange(n, device=dev))
    recurrent = bool(getattr(policy, "recurrent", False))
    carry = policy.init_carry(n) if recurrent else None
    obs = env.observe(state) if policy is not None else None
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    for _ in range(time_limit):
        if policy is None:
            actions = torch.randint(0, 9, (n,), generator=generator,
                                    device=dev)
        elif recurrent:
            actions, carry = policy(obs, carry, generator=generator)
        else:
            actions = policy(obs, generator=generator)
        state, ts = _step(env, state, bank, actions, generator)
        obs = ts.obs
        done |= ts.done
        if bool(done.all()):
            break
    return state


def sinkhorn_scores(action, inaction):
    """(K, B) float32 Sinkhorn EMDs of the (K, H, W, B) distributions, on
    their device, as the eval scores them."""
    k, h, w, n = action.shape
    cost = torch.as_tensor(se.torus_distances((h, w)), dtype=torch.float32,
                           device=action.device)
    return se.sinkhorn_emd(
        inaction.reshape(k, h * w, n).transpose(1, 2),
        action.reshape(k, h * w, n).transpose(1, 2),
        cost, eps=EPS, iters=ITERS).cpu().numpy()


def exact_scores(action, inaction):
    """(K, B) exact EMDs (host LP) of the pairs where either distribution
    holds mass, and the number of such pairs."""
    act, inact = action.cpu().numpy(), inaction.cpu().numpy()
    exact = np.zeros(act.shape[:1] + act.shape[3:], np.float32)
    pairs = 0
    for k in range(act.shape[0]):
        for b in range(act.shape[3]):
            a2, b2 = inact[k, :, :, b], act[k, :, :, b]
            if a2.max() == 0 and b2.max() == 0:
                continue
            exact[k, b] = se.earth_mover_distance(a2, b2)
            pairs += 1
    return exact, pairs


def report(sink, exact, pairs):
    """The per-suite figures of the per-episode total scores."""
    tot_sink = sink.sum(axis=0)
    tot_exact = exact.sum(axis=0)
    nz = tot_exact > 1e-6
    rel = np.abs(tot_sink[nz] - tot_exact[nz]) / tot_exact[nz]
    return dict(
        episodes=int(sink.shape[1]), scored_pairs=int(pairs),
        mean_exact=float(tot_exact.mean()),
        mean_sinkhorn=float(tot_sink.mean()),
        mean_rel_err=float(rel.mean()) if nz.any() else 0.0,
        p95_rel_err=float(np.percentile(rel, 95)) if nz.any() else 0.0,
        max_rel_err=float(rel.max()) if nz.any() else 0.0,
        episodes_with_effects=int(nz.sum()))


def score_episodes(init_board, board, spawn_prob, episode_length, generator,
                   catch_up_steps=1000, samples=SAMPLES):
    """The scoring half: the co-evolution's distributions (K5 on a CUDA
    board), the Sinkhorn and exact EMD of every pair, and the report."""
    action, inaction = se.accumulate_distributions(
        init_board, board, spawn_prob, episode_length, samples, generator,
        se.DEFAULT_TRACKED, catch_up_steps=catch_up_steps)
    return report(sinkhorn_scores(action, inaction),
                  *exact_scores(action, inaction))


def validate_suite(suite, time_limit=1000, seed=0, policy=None,
                   view_shape=None, device=None):
    """Roll ``suite``'s levels and score them both ways; None when the
    suite has no archive."""
    device = resolve_device(device)
    try:
        bank = loader.load_bank(f"{BENCHMARK_ROOT}/{suite}.npz",
                                device=device)
    except FileNotFoundError:
        print(f"  {suite}: no suite archive, skipped", file=sys.stderr)
        return None
    generator = torch.Generator(device).manual_seed(seed)
    state = rollout(bank, time_limit, generator, policy, view_shape)
    return dict(suite=suite, **score_episodes(
        state.init_board, state.board, state.spawn_prob,
        state.episode_length, generator, catch_up_steps=time_limit))


def _load(path):
    if os.path.exists(path):
        with open(path) as fh:
            return json.load(fh)
    return {}


def _write(path, results):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(results, fh, indent=1, sort_keys=True)


def _table(first, results, path):
    print(f"\n| {first} | episodes scored | mean exact EMD | mean Sinkhorn | "
          "mean rel err | p95 rel err |")
    print("|---|---|---|---|---|---|")
    for s, r in sorted(results.items()):
        print(f"| {s} | {r['episodes_with_effects']}/{r['episodes']} "
              f"| {r['mean_exact']:.2f} | {r['mean_sinkhorn']:.2f} "
              f"| {r['mean_rel_err'] * 100:.1f}% "
              f"| {r['p95_rel_err'] * 100:.1f}% |")
    print("wrote", path)


def main(suites=SUITES, out=None, device=None):
    """Validate each of ``suites`` with a random policy; results go to
    ``out`` (default ``results/torch/sinkhorn_validation.json``)."""
    out = out or os.path.join(RESULTS, "sinkhorn_validation.json")
    results = _load(out)
    for suite in suites:
        print(f"validating {suite} ...", file=sys.stderr, flush=True)
        r = validate_suite(suite, device=device)
        if r is None:
            continue
        results[suite] = r
        _write(out, results)
        print(f"  {suite}: mean_rel_err={r['mean_rel_err']:.4f} "
              f"p95={r['p95_rel_err']:.4f} max={r['max_rel_err']:.4f} "
              f"({r['episodes_with_effects']}/{r['episodes']} episodes, "
              f"{r['scored_pairs']} pairs)", flush=True)
    _table("suite", results, out)
    return results


def main_runs(run_dir, out=None, device=None):
    """Validate on trained policies: every finished run under ``run_dir``
    replays its task's suite with its final checkpoint's sampling policy
    (``training.driver.load_policy``; the runs ``cpu_verify_finals``
    finds)."""
    from ..training.driver import load_policy

    out = out or os.path.join(RESULTS, "sinkhorn_validation_trained.json")
    results = _load(out)
    for run, logdir, task in finished_runs(run_dir, results):
        print(f"validating {run} (suite {task}) ...", file=sys.stderr,
              flush=True)
        try:
            policy, view = load_policy(logdir, device=device)
        except (OSError, KeyError, RuntimeError) as e:
            print(f"  {run}: SKIP ({type(e).__name__}: {e})", flush=True)
            continue
        r = validate_suite(task, policy=policy, view_shape=view,
                           device=device)
        if r is None:
            continue
        r["run"] = run
        results[run] = r
        _write(out, results)
        print(f"  {run}: mean_rel_err={r['mean_rel_err']:.4f} "
              f"p95={r['p95_rel_err']:.4f} max={r['max_rel_err']:.4f} "
              f"({r['episodes_with_effects']}/{r['episodes']} episodes)",
              flush=True)
    _table("run", results, out)
    return results


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("suites", nargs="*", default=SUITES)
    parser.add_argument("--runs", help="validate the runs under this dir")
    parser.add_argument("--out", help="the results file")
    parser.add_argument("--device", help="cuda (default) or cpu")
    args = parser.parse_args()
    if args.runs:
        main_runs(args.runs, args.out, args.device)
    else:
        main(args.suites, args.out, args.device)
