"""Training sweeps: the JAX round's ``scripts/sweep_r3.sh``,
``sweep_r4.sh``, ``sweep_r4b.sh`` and ``sweep_r5.sh`` as one runner and
their run lists as data.

    python -m safelife_torch.scripts.sweep --runs-dir DIR [--round R]
        [--only NAME ...] [--steps S] [--nproc N] [--timeout S]
        [--results PATH] [--finals-time-limit 1000] [--dry-run]

Each run is ``python -m safelife_torch train DIR/NAME --task TASK
--num-envs 64 --steps BUDGET --seed SEED --impact-penalty P --algo ALGO
--eval-every E``, named ``TASK[+penaltyP][+ALGO]-sSEED``, its output
appended to ``DIR/NAME.log`` and ``DIR/NAME.done`` touched when it exits
0.  A run whose ``.done`` exists is skipped, so a sweep resumes where it
stopped; before each run the sweep waits while ``DIR/PAUSE`` exists (touch
it to take the cards back for a while, remove it to go on).  A failed run
does not stop the sweep; the sweep exits 1 after its tail if any failed.
``--nproc N`` runs each as N ranks, one a card, through ``launch local``.
The tail re-verifies every finished run's final on the CPU
(``cpu_verify_finals``, resumable) and writes ``--results`` from the
logs (``summarize_runs``; by default ``results/torch/RESULTS.md``, with its
curves archive in ``results/torch/results/``: the JAX round's RESULTS.md
and ``results/curves.json`` stay as they are).

``--round`` takes a round's runs in its script's order, with its eval
cadence (r5: ``--eval-every 1e6``; the others evaluate at every
checkpoint, train's default).  ``--only`` keeps the named runs; a name
outside the round (or without ``--round``) is a run of its own, with the
task's budget from ``training/curricula.py``.  ``--steps`` cuts every
run's budget, and ``--finals-time-limit`` the CPU finals' episodes, for a
smoke run.  ``--dry-run`` prints the command line of each run (the one a
run executes, under ``--timeout``) and the tail's, and runs nothing.
"""

import argparse
import dataclasses
import os
import re
import shlex
import sys
import time

from . import RESULTS, launch

NUM_ENVS = 64
RESULTS_MD = os.path.join(RESULTS, "RESULTS.md")
# How often a paused sweep looks for its PAUSE file.
PAUSE_POLL_S = 30


@dataclasses.dataclass(frozen=True)
class Run:
    task: str
    seed: int
    steps: float
    penalty: float = 0.0
    algo: str = "cnn"

    @property
    def name(self):
        name = self.task
        if self.penalty:
            name += f"+penalty{self.penalty:g}"
        if self.algo != "cnn":
            name += f"+{self.algo}"
        return f"{name}-s{self.seed}"


NAME = re.compile(r"(?P<task>.+?)(?:\+penalty(?P<penalty>[\d.]+))?"
                  r"(?:\+(?P<algo>lstm))?-s(?P<seed>\d+)$")


def parse_name(name):
    """The run a name denotes, with its task's full budget."""
    from ..training.curricula import TASKS
    m = NAME.match(name)
    if not m or m["task"] not in TASKS:
        raise ValueError(f"{name!r} is not TASK[+penaltyP][+lstm]-sSEED of "
                         f"a task of training/curricula.py")
    return Run(m["task"], int(m["seed"]), TASKS[m["task"]].total_steps,
               float(m["penalty"] or 0), m["algo"] or "cnn")


def _runs(*groups):
    """Runs from (task, seeds, steps[, penalty[, algo]]) groups, the
    scripts' ``for seed in ...; do run ...; done`` lines."""
    return tuple(Run(task, seed, *rest) for task, seeds, *rest in groups
                 for seed in seeds)


ROUNDS = {
    # Never-trained suites at 3 seeds, two more seeds for the single-seed
    # tasks, then the side-effect-penalized counterparts.
    "r3": _runs(
        ("append-dynamic", (0, 1, 2), 10e6),
        ("prune-dynamic", (0, 1, 2), 6e6),
        ("prune-still-hard", (0, 1, 2), 6e6),
        ("append-spawn", (1, 2), 10e6),
        ("prune-spawn", (1, 2), 6e6),
        ("navigation", (1, 2), 6e6),
        ("append-still", (0,), 10e6, 0.5),
        ("prune-still", (0,), 6e6, 0.5)),
    # The 8-suite x 3-seed matrix, the impact-penalty safety experiment,
    # the recurrent anchor, then extra penalty coverage.
    "r4": _runs(
        ("prune-still-hard", (0, 1, 2), 6e6),
        ("append-still", (0,), 10e6, 0.5),
        ("prune-still", (0,), 6e6, 0.5),
        ("append-spawn", (1, 2), 10e6),
        ("prune-spawn", (1, 2), 6e6),
        ("navigation", (1, 2), 6e6),
        ("prune-dynamic", (1, 2), 6e6),
        ("append-still", (0,), 10e6, 0.0, "lstm"),
        ("prune-dynamic", (0,), 6e6, 0.5),
        ("append-spawn", (0,), 10e6, 0.5),
        ("prune-spawn", (0,), 6e6, 0.5)),
    # Round 4 again, the matrix gaps first.
    "r4b": _runs(
        ("prune-still-hard", (0, 1, 2), 6e6),
        ("append-spawn", (1, 2), 10e6),
        ("prune-spawn", (1, 2), 6e6),
        ("navigation", (1, 2), 6e6),
        ("prune-dynamic", (1, 2), 6e6),
        ("append-still", (0,), 10e6, 0.5),
        ("prune-still", (0,), 6e6, 0.5),
        ("append-still", (0,), 10e6, 0.0, "lstm"),
        ("prune-dynamic", (0,), 6e6, 0.5),
        ("append-spawn", (0,), 10e6, 0.5),
        ("prune-spawn", (0,), 6e6, 0.5)),
    # The safety matrix to 3 seeds, the LSTM replication, the 10M-budget
    # append penalty cells, the append-dynamic dead-start rerun.
    "r5": _runs(
        ("navigation", (0, 1, 2), 6e6, 0.5),
        ("prune-spawn", (1, 2), 6e6, 0.5),
        ("prune-still", (1, 2), 6e6, 0.5),
        ("prune-dynamic", (1, 2), 6e6, 0.5),
        ("append-still", (1, 2), 10e6, 0.0, "lstm"),
        ("append-still", (1, 2), 10e6, 0.5),
        ("append-spawn", (1, 2), 10e6, 0.5),
        ("append-dynamic", (2,), 10e6)),
}
# Frozen-suite eval cadence in env steps (0: at every checkpoint).  Round 5
# evaluated every 1M steps (checkpoints stay at 500k; finals always
# evaluate): a full eval costs about two 500k training segments at 64
# environments.
EVAL_EVERY = {"r5": 1e6}


def select(round_name=None, only=None):
    """The runs of ``round_name`` in order, kept to the names in ``only``
    (a name the round lacks is a run of its own)."""
    runs = ROUNDS[round_name] if round_name else ()
    if only is None:
        return runs
    known = {r.name: r for r in runs}
    return tuple(known.get(n) or parse_name(n) for n in only)


def train_args(run, eval_every=0, steps=None):
    return ["--task", run.task, "--num-envs", str(NUM_ENVS),
            "--steps", str(steps or int(run.steps)), "--seed",
            str(run.seed), "--impact-penalty", f"{run.penalty:g}",
            "--algo", run.algo, "--eval-every", str(int(eval_every))]


def command(logdir, args, nproc=None):
    """The argv that trains one run: ``train`` itself, or its ``nproc``
    ranks under ``launch local``."""
    if nproc:
        return [sys.executable, "-m", "safelife_torch.scripts.launch",
                "local", "--nproc", str(nproc), logdir, "--", *args]
    return launch.train_command(logdir, args)


def train(logdir, args, nproc=None, timeout=None):
    """Run :func:`command`, its output appended to ``<logdir>.log``;
    returns the exit code (124 when ``timeout`` seconds pass: the launcher
    stops its ranks on the way out)."""
    with open(logdir + ".log", "a") as log:
        return launch.run_processes(command(logdir, args, nproc), [{}],
                                    timeout, stdout=log)


def wait_while_paused(runs_dir):
    pause = os.path.join(runs_dir, "PAUSE")
    if os.path.exists(pause):
        print(f"{pause} exists: waiting", flush=True)
    while os.path.exists(pause):
        time.sleep(PAUSE_POLL_S)


def sweep(runs_dir, runs, eval_every=0, steps=None, nproc=None,
          timeout=None, results=RESULTS_MD, finals_time_limit=1000,
          dry_run=False):
    """Train every run not yet done, then the tail; returns the names of
    the runs that failed."""
    if not dry_run:
        os.makedirs(runs_dir, exist_ok=True)
    failed = []
    for run in runs:
        logdir = os.path.join(runs_dir, run.name)
        if os.path.exists(logdir + ".done"):
            print(f"skip {logdir}", flush=True)
            continue
        args = train_args(run, eval_every, steps)
        if dry_run:
            print("+", shlex.join(command(logdir, args, nproc)),
                  f">> {shlex.quote(logdir)}.log 2>&1 && touch "
                  f"{shlex.quote(logdir)}.done", flush=True)
            continue
        wait_while_paused(runs_dir)
        print(f"run {run.name}", flush=True)
        rc = train(logdir, args, nproc, timeout)
        if rc == 0:
            open(logdir + ".done", "w").close()
        else:
            print(f"{run.name}: exit code {rc}", flush=True)
            failed.append(run.name)
    if dry_run:
        print(f"+ cpu_verify_finals {runs_dir} --time-limit "
              f"{finals_time_limit}\n+ summarize_runs {runs_dir} {results}")
        return failed
    from . import cpu_verify_finals, summarize_runs
    cpu_verify_finals.main(runs_dir, time_limit=finals_time_limit)
    summarize_runs.main(runs_dir, results)
    return failed


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m safelife_torch.scripts.sweep",
                                description=__doc__.split("\n")[0])
    p.add_argument("--runs-dir", required=True)
    p.add_argument("--round", choices=sorted(ROUNDS), default=None)
    p.add_argument("--only", nargs="+", default=None, metavar="NAME",
                   help="just these runs, TASK[+penaltyP][+lstm]-sSEED")
    p.add_argument("--steps", default=None,
                   help="every run's budget (a smoke run)")
    p.add_argument("--nproc", type=int, default=None,
                   help="each run as N ranks, one a card (launch local)")
    p.add_argument("--timeout", type=float, default=None,
                   help="seconds before a run is killed")
    p.add_argument("--results", default=RESULTS_MD,
                   help="the summary (default: under results/torch/)")
    p.add_argument("--finals-time-limit", type=int, default=1000,
                   help="steps of the CPU finals' episodes")
    p.add_argument("--dry-run", action="store_true")
    args = p.parse_args(argv)
    if not (args.round or args.only):
        p.error("give --round, --only or both")
    failed = sweep(args.runs_dir, select(args.round, args.only),
                   EVAL_EVERY.get(args.round, 0), args.steps, args.nproc,
                   args.timeout, args.results, args.finals_time_limit,
                   args.dry_run)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
