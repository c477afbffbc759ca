"""Summarize training sweeps into RESULTS.md (the port's own copy of
``scripts/summarize_runs.py``).

Parses the `eval @ N: ...` lines that Trainer.evaluate logs (frozen-suite
evaluation at every checkpoint) from a set of run logs, merges them into a
persistent curves archive (so runs from earlier sweeps survive log
deletion), and writes per-task eval curves + final-score tables plus the
impact-penalty safety summary.

Usage: python -m safelife_torch.scripts.summarize_runs RUN_DIR [RESULTS.md]
    [archive.json]

RESULTS.md defaults to ``results/torch/RESULTS.md`` (``scripts.RESULTS``):
the JAX round's RESULTS.md and curves archive stay as they are.  The
archive (default results/curves.json next to the output file) is the
source of truth: fresh logs override same task+seed entries, everything
else is carried forward.  Keep it together with RESULTS.md (git ignores
the default place, results/torch/).  The
RESULTS.md text is the JAX script's, word for word: both write the same
file from the same logs.
"""

import json
import os
import re
import sys
from collections import defaultdict

LINE = re.compile(
    r"eval @ (\d+): levels=(\d+) mean_perf=([\d.]+) median_perf=([\d.]+) "
    r"mean_reward=([\d.-]+) mean_length=([\d.]+)"
    r"(?: mean_side_effects=([\d.]+))?")

HEADER = """# Training results (anchored PPO curves)

Frozen-suite evaluation during training: periodically (every 500k env
steps for rounds 3-4, every 1M for the round-5 sweep — checkpoints stay
at 500k and the final always evaluates) the current policy runs over
the task's 100-level benchmark suite (sampling policy, full episodes)
and per-level EMD side-effect scores are computed on device.  Mean performance = completed /
possible averaged over the suite; a random policy scores ~0.04.
Config: reference hyperparameters + linear LR decay to 10%,
endless procgen levels (bank regenerated every 250k steps),
curriculum per `training/curricula.py`.

Navigation levels carry no goal patterns (perf_possible = 0, so
mean_perf reads 0 by construction); success there is reaching the
exit: mean episode length and reward are the metrics (length
1000 = never exits; the trained policy exits in ~200 steps with
reward ~0.9 = 90% of episodes reach the exit).

Prune-task performance counts red-cell removal only (losses of
green life do not subtract — green scores 0 on empty goals), so
an unpenalized policy can reach high prune-dynamic performance by
destabilizing patterns indiscriminately; read those numbers
together with the side-effects column, and compare the
`+penalty` runs where the impact penalty is on.

Side-effect scores are entropic-OT (Sinkhorn, eps=0.02) approximations
of the reference's exact EMD, validated against the exact LP solver two
ways (`scripts/validate_sinkhorn.py`): per suite with a random policy
(`results/sinkhorn_validation.json`: 0.2-0.4% mean relative error on
per-episode totals, p95 <= 1%), and — because trained policies
concentrate occupancy far more than a random walk — on the TRAINED
final checkpoints' own episode distributions
(`results/sinkhorn_validation_trained.json`).  On trained episodes the
per-episode error can be larger (navigation+penalty: 2.7-3.4% mean,
p95 ~13%) but the signed errors cancel in the suite mean: the REPORTED
per-task side-effect numbers (suite means) agree with exact EMD to
~0.3% on every validated checkpoint.

Integrity: final scores marked *CPU-verified* were re-computed by
restoring the run's last checkpoint in a CPU process and replaying
the frozen suite there (`scripts/cpu_verify_finals.py`).  This
cross-check exists because on 2026-08-17 a degrading remote TPU
returned all-zero goal scores at full speed, fabricating perfect
prune-task results; those runs were quarantined and retrained, and
the trainer now hard-aborts on such corruption
(`safelife_tpu/utils/integrity.py`).  Accelerator-computed curve
points from a degraded window can read low for append tasks (a
zeroed score floors the eval at 0), so the CPU-verified final is
authoritative where the two disagree.
"""

SAFETY_PROSE = """## The impact-penalty safety experiment

The headline experiment of the SafeLife paper (arXiv:1912.01217;
reference `env_wrappers.py:306-346`): add `SimpleSideEffectPenalty`
with impact_penalty=0.5 (ramped in per the task's reference schedule,
`training/curricula.py` impact_penalty_ramp — e.g. 1M-2M steps for
append-still, as in the reference `start-training`) and compare side
effects against the unpenalized baseline.  Perf is the CPU-verified final; side effects
are the final-checkpoint suite mean (EMD vs the inaction rollout,
lower = safer).  Negative change = the penalty reduced side effects.

**Read the spawn/dynamic rows carefully: the penalty INCREASES the
measured side effects there, and the reference documents exactly this
failure mode.**  The `SimpleSideEffectPenalty` baselines against the
STARTING state, so on boards that evolve on their own it "will also
penalize [the agent] for allowing the environment to dynamically
evolve, and will encourage it to disable any features that cause
dynamic evolution" (reference `README.md:236`).  On prune-spawn the
reference describes its own ε=0.5 agent this way: "it quickly destroys
the spawner cells ... The agent never actually completes the level by
going to the level exit because it doesn't want to reach the next
level and be further penalized" (`README.md:243`).  Our penalized
prune-spawn seeds reproduce that signature — episode length ~1000
(never exits) and inflated EMD-vs-inaction scores from suppressing the
spawner output the inaction baseline preserves.  The penalty "works"
only where the paper says it should: the still-board tasks.  For
navigation the reference predicts the penalty "completely destroys the
agents' abilities to find the level exit" (`README.md:259`) — compare
the navigation rows' reward/length rather than side effects alone.
"""


def parse_log(path):
    rows = []
    with open(path) as fh:
        for ln in fh:
            m = LINE.search(ln)
            if m:
                rows.append(dict(
                    step=int(m.group(1)),
                    mean_perf=float(m.group(3)),
                    median_perf=float(m.group(4)),
                    mean_reward=float(m.group(5)),
                    mean_length=float(m.group(6)),
                    side_effects=float(m.group(7)) if m.group(7) else None))
    return rows


def metric_for(task):
    return "mean_reward" if task.startswith("navigation") else "mean_perf"


def load_runs(run_dir):
    """task -> seed -> rows from fresh logs, + CPU-verified finals."""
    import glob

    runs = defaultdict(dict)
    for log in sorted(glob.glob(os.path.join(run_dir, "*.log"))):
        name = os.path.basename(log)[:-4]
        m = re.match(r"(.+)-s(\d+)$", name)
        if not m:
            continue
        rows = parse_log(log)
        if rows:
            runs[m.group(1)][int(m.group(2))] = rows

    cpu_finals = {}
    cpu_path = os.path.join(run_dir, "cpu_finals.json")
    if os.path.exists(cpu_path):
        with open(cpu_path) as fh:
            cpu_finals = json.load(fh)
    return runs, cpu_finals


def merge_archive(archive_path, runs, cpu_finals):
    """Merge fresh runs over the archived ones; persist; return merged."""
    arch = {"runs": {}, "cpu_finals": {}, "notes": {}}
    if os.path.exists(archive_path):
        with open(archive_path) as fh:
            arch = json.load(fh)
        arch.setdefault("notes", {})
    merged = {t: {int(s): r for s, r in seeds.items()}
              for t, seeds in arch.get("runs", {}).items()}
    for task, seeds in runs.items():
        merged.setdefault(task, {}).update(seeds)
    cpu = dict(arch.get("cpu_finals", {}))
    cpu.update(cpu_finals)
    arch["runs"] = merged
    arch["cpu_finals"] = cpu
    os.makedirs(os.path.dirname(archive_path) or ".", exist_ok=True)
    with open(archive_path, "w") as fh:
        json.dump(arch, fh, indent=1, sort_keys=True)
    return merged, cpu, arch.get("notes", {})


def emit_safety_summary(lines, runs, cpu):
    import numpy as np

    pairs = []
    for task in sorted(runs):
        m = re.match(r"(.+)\+penalty([\d.]+)$", task)
        if m and m.group(1) in runs:
            pairs.append((m.group(1), task, m.group(2)))
    if not pairs:
        return

    def final(task, field):
        vals = [rows[-1][field] for rows in runs[task].values()
                if rows[-1].get(field) is not None]
        return np.mean(vals) if vals else None

    def cpu_final(task, metric):
        vals = [cpu[f"{task}-s{s}"][metric] for s in runs[task]
                if f"{task}-s{s}" in cpu]
        return np.mean(vals) if vals else final(task, metric)

    lines.append(SAFETY_PROSE)
    lines.append("| task | perf (penalty 0) | side effects (penalty 0) | "
                 "perf (+penalty) | side effects (+penalty) | "
                 "side-effect change |")
    lines.append("|---|---|---|---|---|---|")
    for base, pen, _amt in pairs:
        metric = metric_for(base)
        b_p, b_e = cpu_final(base, metric), final(base, "side_effects")
        p_p, p_e = cpu_final(pen, metric), final(pen, "side_effects")
        if b_e and p_e:
            delta = (p_e / b_e - 1) * 100  # negative = penalty reduced them
            red = f"**{delta:+.0f}%**"
        else:
            red = "—"
        lines.append(
            f"| {base} | {b_p:.3f} | {b_e:.1f} | {p_p:.3f} | {p_e:.1f} "
            f"| {red} |")
    lines.append("")


def main(run_dir, out=None, archive_path=None):
    import numpy as np

    if out is None:
        from . import RESULTS
        out = os.path.join(RESULTS, "RESULTS.md")
    if archive_path is None:
        archive_path = os.path.join(
            os.path.dirname(os.path.abspath(out)), "results", "curves.json")

    runs_new, cpu_new = load_runs(run_dir)
    runs, cpu_finals, notes = merge_archive(archive_path, runs_new, cpu_new)

    lines = [HEADER]
    emit_safety_summary(lines, runs, cpu_finals)
    for task in sorted(runs):
        seeds = runs[task]
        lines.append(f"## {task} ({len(seeds)} seeds)")
        lines.append("")
        metric = metric_for(task)
        lines.append("| step | " + " | ".join(
            f"seed {s} {metric}" for s in sorted(seeds)) +
            " | mean ± std | length | side effects |")
        lines.append("|---" * (len(seeds) + 4) + "|")
        steps = sorted({r["step"] for rows in seeds.values() for r in rows})
        for step in steps:
            perfs, effs, lens = [], [], []
            cells = []
            for s in sorted(seeds):
                row = next((r for r in seeds[s] if r["step"] == step), None)
                cells.append(f"{row[metric]:.3f}" if row else "—")
                if row:
                    perfs.append(row[metric])
                    lens.append(row["mean_length"])
                    if row["side_effects"] is not None:
                        effs.append(row["side_effects"])
            mean = np.mean(perfs)
            std = np.std(perfs)
            eff = f"{np.mean(effs):.1f}" if effs else "—"
            lines.append(
                f"| {step:,} | " + " | ".join(cells)
                + f" | {mean:.3f} ± {std:.3f} | {np.mean(lens):.0f} | {eff} |")
        finals = [rows[-1][metric] for rows in seeds.values()]
        lines.append("")
        lines.append(
            f"**Final {metric}: {np.mean(finals):.3f} ± "
            f"{np.std(finals):.3f}** "
            f"(seeds: {', '.join(f'{f:.3f}' for f in finals)})")
        cpu = [cpu_finals[f"{task}-s{s}"][metric]
               for s in sorted(seeds) if f"{task}-s{s}" in cpu_finals]
        if cpu:
            lines.append(
                f"**CPU-verified final {metric}: {np.mean(cpu):.3f} ± "
                f"{np.std(cpu):.3f}** "
                f"(seeds: {', '.join(f'{f:.3f}' for f in cpu)})")
        if task in notes:
            lines.append("")
            lines.append(f"*{notes[task]}*")
        lines.append("")
    with open(out, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    print("wrote", out, "and", archive_path)


if __name__ == "__main__":
    if not 2 <= len(sys.argv) <= 4:
        sys.exit(__doc__)
    main(*sys.argv[1:])
