"""Re-verify every finished run's final score on the host CPU (the port of
``scripts/cpu_verify_finals.py``).

    python -m safelife_torch.scripts.cpu_verify_finals <run dir>
        [--time-limit 1000]

The in-training evals run on the card.  This tool restores each finished
run's last checkpoint on the CPU and replays its frozen-suite benchmark
there through the plain step (``device="cpu"``, ``use_kernels=False``: a
CPU tool by purpose, whatever devices the machine has), as the integrity
re-check of reported finals.  A run is ``<run dir>/<task>[+mods]-s<seed>``
with a ``checkpoints`` folder and a ``<run>.done`` marker beside it; runs
without the marker are still training and are skipped.  Results
accumulate in ``<run dir>/cpu_finals.json`` (resumable: runs already
there are skipped).
"""

import argparse
import glob
import json
import os
import re

from ..benchmarking import run_benchmark
from ..training.driver import load_policy


def finished_runs(run_dir, done=()):
    """(run, logdir, task) of every run under ``run_dir`` named
    ``<task>[+mods]-s<seed>`` with checkpoints and a ``.done`` marker,
    skipping those in ``done``; a run without the marker is reported and
    skipped (its newest checkpoint is not a final one)."""
    for logdir in sorted(glob.glob(os.path.join(run_dir, "*-s[0-9]*"))):
        run = os.path.basename(logdir)
        m = re.match(r"(.+)-s(\d+)$", run)
        if not m or not os.path.isdir(os.path.join(logdir, "checkpoints")):
            continue
        if run in done:
            continue
        if not os.path.exists(logdir + ".done"):
            print(f"{run}: SKIP (no .done marker: run not finished)")
            continue
        # "<task>+penalty<p>-sN" runs evaluate on the base task's suite.
        yield run, logdir, m.group(1).split("+")[0]


def main(run_dir, time_limit=1000):
    """Replay each finished run's suite on the CPU (episodes cut at
    ``time_limit`` steps, the eval's); returns the finals."""
    out_path = os.path.join(run_dir, "cpu_finals.json")
    finals = {}
    if os.path.exists(out_path):
        with open(out_path) as fh:
            finals = json.load(fh)
    for run, logdir, task in finished_runs(run_dir, finals):
        try:
            policy, view = load_policy(logdir, device="cpu")
            res = run_benchmark(task, policy, view_shape=view,
                                time_limit=time_limit, device="cpu",
                                use_kernels=False)
        except (OSError, KeyError, RuntimeError) as e:
            # A missing checkpoint or suite, an interrupted run.
            print(f"{run}: SKIP ({type(e).__name__}: {e})")
            continue
        finals[run] = {
            "mean_perf": round(float(res["performance"].mean()), 4),
            "mean_reward": round(float(res["reward"].mean()), 3),
            "mean_length": round(float(res["length"].mean()), 1),
        }
        print(run, finals[run], flush=True)
        with open(out_path, "w") as fh:
            json.dump(finals, fh, indent=1, sort_keys=True)
    print("wrote", out_path)
    return finals


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("run_dir")
    parser.add_argument("--time-limit", type=int, default=1000)
    args = parser.parse_args()
    main(args.run_dir, args.time_limit)
