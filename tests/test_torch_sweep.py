"""The port's sweep runner and its tail on the CPU.

* ``safelife_torch.scripts.sweep``'s run lists against the JAX round's
  ``scripts/sweep_r{3,4,4b,5}.sh``, read as text (their ``run`` lines and
  ``for seed in`` loops; the scripts ``cd`` into a fixed path and train, so
  they are never run): the same runs in the same order, the same names,
  round 5's eval cadence.
* The runner with its training replaced by a fake: a ``.done`` run is
  skipped, nothing starts while ``PAUSE`` exists, a run that exits 0 gets
  its ``.done``, a failed one does not and the sweep exits 1, ``--only``
  and ``--steps`` cut a sweep, ``--dry-run`` prints and runs nothing.
* ``summarize_runs``: the port's copy and the JAX script write the same
  RESULTS.md and curves archive from the same logs.
"""

import importlib.util
import json
import os
import re
import threading
import time

import pytest
import torch

from safelife_torch.scripts import summarize_runs, sweep

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = re.compile(r"^\s*(?:for seed in ([\d ]+); do )?run ([a-z-]+) +"
                 r"([^\s;]+) +([^\s;]+)(?: +([^\s;]+))?(?: +([^\s;]+))?"
                 r" *;?(?: *done)?\s*$")


def jax_runs(round_name):
    """(task, seed, steps, penalty, algo, name) of each run the round's
    script makes, in order, named as its ``run`` function names them."""
    out = []
    path = os.path.join(ROOT, "scripts", f"sweep_{round_name}.sh")
    with open(path) as fh:
        for line in fh:
            m = RUN.match(line.split("#")[0])
            if not m:
                continue
            seeds, task, seed, steps, penalty, algo = m.groups()
            penalty, algo = penalty or "0", algo or "cnn"
            for s in (seeds.split() if seeds else [seed]):
                name = task
                if penalty != "0":
                    name = f"{name}+penalty{penalty}"
                if algo != "cnn":
                    name = f"{name}+{algo}"
                out.append((task, int(s), float(steps), float(penalty), algo,
                            f"{name}-s{s}"))
    return out


@pytest.mark.parametrize("round_name", ["r3", "r4", "r4b", "r5"])
def test_round_runs_match_the_jax_sweep(round_name):
    want = jax_runs(round_name)
    assert len(want) > 10
    got = [(r.task, r.seed, r.steps, r.penalty, r.algo, r.name)
           for r in sweep.ROUNDS[round_name]]
    assert got == want
    with open(os.path.join(ROOT, "scripts",
                           f"sweep_{round_name}.sh")) as fh:
        m = re.search(r"--eval-every (\S+)", fh.read())
    assert sweep.EVAL_EVERY.get(round_name, 0) == (float(m[1]) if m else 0)
    args = sweep.train_args(sweep.ROUNDS[round_name][0],
                            sweep.EVAL_EVERY.get(round_name, 0))
    run = sweep.ROUNDS[round_name][0]
    assert args == ["--task", run.task, "--num-envs", "64", "--steps",
                    str(int(run.steps)), "--seed", str(run.seed),
                    "--impact-penalty", f"{run.penalty:g}", "--algo",
                    run.algo, "--eval-every",
                    "1000000" if round_name == "r5" else "0"]


def test_names_parse_back_into_runs():
    for runs in sweep.ROUNDS.values():
        for run in runs:
            assert sweep.parse_name(run.name) == run
    run = sweep.parse_name("append-still+penalty0.5+lstm-s1")
    assert (run.task, run.seed, run.penalty, run.algo, run.steps) == (
        "append-still", 1, 0.5, "lstm", 10e6)
    for bad in ("append-still", "no-such-task-s0", "append-still+gru-s0"):
        with pytest.raises(ValueError):
            sweep.parse_name(bad)


@pytest.fixture
def fake_train(monkeypatch):
    """Training replaced by a fake that records (name, args, nproc),
    appends a line to the run's log and exits with ``codes[name]`` (0 by
    default)."""
    calls, codes = [], {}

    def train(logdir, args, nproc=None, timeout=None):
        name = os.path.basename(logdir)
        calls.append((name, args, nproc))
        with open(logdir + ".log", "a") as fh:
            fh.write(f"trained {name}\n")
        return codes.get(name, 0)
    monkeypatch.setattr(sweep, "train", train)
    monkeypatch.setattr(sweep, "PAUSE_POLL_S", 0.02)
    return calls, codes


def test_runner_skips_done_runs_and_waits_while_paused(tmp_path, fake_train,
                                                       capsys):
    calls, codes = fake_train
    runs = str(tmp_path / "runs")
    os.makedirs(runs)
    names = [r.name for r in sweep.ROUNDS["r4"][:4]]
    open(os.path.join(runs, names[1] + ".done"), "w").close()
    open(os.path.join(runs, "PAUSE"), "w").close()
    codes[names[3]] = 1
    argv = ["--runs-dir", runs, "--round", "r4", "--only", *names,
            "--steps", "1281", "--nproc", "2",
            "--results", str(tmp_path / "RESULTS.md")]
    result = []
    thread = threading.Thread(target=lambda: result.append(sweep.main(argv)))
    thread.start()
    time.sleep(0.3)
    assert calls == [] and thread.is_alive()  # paused
    os.remove(os.path.join(runs, "PAUSE"))
    thread.join(timeout=60)
    assert not thread.is_alive()
    assert result == [1]  # names[3] failed
    assert [c[0] for c in calls] == [names[0], names[2], names[3]]
    for name, args, nproc in calls:
        run = sweep.parse_name(name)
        assert args == sweep.train_args(run, 0, "1281") and nproc == 2
    for name in names:
        assert os.path.exists(os.path.join(runs, name + ".done")) == (
            name != names[3])
    with open(os.path.join(runs, names[0] + ".log")) as fh:
        assert fh.read() == f"trained {names[0]}\n"
    out = capsys.readouterr().out
    assert f"skip {os.path.join(runs, names[1])}" in out
    assert f"{names[3]}: exit code 1" in out
    # The tail: nothing finished with a checkpoint, an empty results file.
    with open(tmp_path / "RESULTS.md") as fh:
        assert fh.read().startswith("# Training results")

    # Again: only the failed run is left, and it trains now.
    del codes[names[3]]
    calls.clear()
    assert sweep.main(argv) == 0
    assert [c[0] for c in calls] == [names[3]]
    calls.clear()
    assert sweep.main(argv) == 0 and calls == []


def test_dry_run_prints_each_run_and_runs_nothing(tmp_path, fake_train,
                                                  capsys):
    calls, _ = fake_train
    runs = str(tmp_path / "runs")
    assert sweep.main(["--runs-dir", runs, "--round", "r5",
                       "--dry-run"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(sweep.ROUNDS["r5"]) + 2
    for run, line in zip(sweep.ROUNDS["r5"], lines):
        logdir = os.path.join(runs, run.name)
        assert f"-m safelife_torch train {logdir} --task {run.task} " in line
        assert line.endswith(f">> {logdir}.log 2>&1 && touch {logdir}.done")
        assert "--eval-every 1000000" in line
    # The summary lands under results/torch/, never on the JAX round's
    # RESULTS.md and results/curves.json.
    assert sweep.RESULTS_MD == os.path.join(ROOT, "results", "torch",
                                            "RESULTS.md")
    assert lines[-2:] == [f"+ cpu_verify_finals {runs} --time-limit 1000",
                          f"+ summarize_runs {runs} {sweep.RESULTS_MD}"]
    # A smoke sweep of runs outside any round, each through launch local.
    assert sweep.main(["--runs-dir", runs, "--only", "append-still-s0",
                       "append-still+penalty0.5+lstm-s1", "--steps", "1281",
                       "--nproc", "1", "--dry-run"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert "-m safelife_torch.scripts.launch local --nproc 1 " in lines[1]
    assert ("-- --task append-still --num-envs 64 --steps 1281 --seed 1 "
            "--impact-penalty 0.5 --algo lstm --eval-every 0 >>") in lines[1]
    assert calls == [] and not os.path.exists(runs)
    with pytest.raises(SystemExit):
        sweep.main(["--runs-dir", runs])


def test_a_run_executes_its_printed_command(tmp_path, monkeypatch):
    """``train`` runs exactly :func:`sweep.command`, the line ``--dry-run``
    prints, under the sweep's deadline, its output into the run's log."""
    ran = []

    def run_processes(cmd, envs, timeout=None, stdout=None):
        ran.append((cmd, envs, timeout, stdout.name))
        return 0
    monkeypatch.setattr(sweep.launch, "run_processes", run_processes)
    logdir = str(tmp_path / "append-still-s0")
    args = sweep.train_args(sweep.parse_name("append-still-s0"), 0, "1281")
    for nproc in (None, 2):
        assert sweep.train(logdir, args, nproc, timeout=30) == 0
        assert ran.pop() == (sweep.command(logdir, args, nproc), [{}], 30,
                             logdir + ".log")
    assert sweep.command(logdir, args, 2)[1:] == [
        "-m", "safelife_torch.scripts.launch", "local", "--nproc", "2",
        logdir, "--", *args]


def _eval_line(step, perf, seed, side=True):
    extra = f" mean_side_effects={3.5 + seed + step / 1e6:.3f}" if side else ""
    return (f"2026-01-01 INFO safelife_torch.training.driver: eval @ {step}: "
            f"levels=100 mean_perf={perf:.3f} median_perf={perf / 2:.3f} "
            f"mean_reward={perf - 0.2:.3f} mean_length={900 - step / 1e4:.1f}"
            f"{extra}\n")


def test_summarize_runs_writes_the_jax_results(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "jax_summarize_runs", os.path.join(ROOT, "scripts",
                                           "summarize_runs.py"))
    jax_summarize = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_summarize)
    assert jax_summarize.LINE.pattern == summarize_runs.LINE.pattern

    runs = tmp_path / "runs"
    os.makedirs(runs)
    logs = {"append-still-s0": 0.41, "append-still-s1": 0.38,
            "append-still+penalty0.5-s0": 0.33,
            "navigation-s2": 0.52, "prune-still-s0": 0.61}
    for i, (name, perf) in enumerate(logs.items()):
        with open(runs / f"{name}.log", "w") as fh:
            fh.write("INFO step 500/1000 reward=0.1\n")
            for step in (500_000, 1_000_000):
                fh.write(_eval_line(step, perf * step / 1e6, i,
                                    side=name != "prune-still-s0"))
    (runs / "not-a-run.log").write_text(_eval_line(5, 0.5, 0))
    (runs / "cpu_finals.json").write_text(json.dumps({
        "append-still-s0": {"mean_perf": 0.4012, "mean_reward": 0.2,
                            "mean_length": 880.0},
        "append-still+penalty0.5-s0": {"mean_perf": 0.3, "mean_reward": 0.1,
                                       "mean_length": 870.5}}))
    archived = {"runs": {"prune-dynamic": {"0": jax_summarize.parse_log(
        str(runs / "append-still-s0.log"))}}, "cpu_finals": {},
        "notes": {"prune-dynamic": "an archived note"}}
    outs = {}
    for side, module in (("jax", jax_summarize), ("port", summarize_runs)):
        out = tmp_path / side
        os.makedirs(out / "results")
        (out / "results" / "curves.json").write_text(json.dumps(archived))
        module.main(str(runs), str(out / "RESULTS.md"))
        outs[side] = ((out / "RESULTS.md").read_text(),
                      (out / "results" / "curves.json").read_text())
    assert outs["port"] == outs["jax"]
    text = outs["port"][0]
    for task in ("append-still (2 seeds)", "append-still+penalty0.5 (1 "
                 "seeds)", "navigation (1 seeds)", "prune-dynamic (1 seeds)",
                 "prune-still (1 seeds)"):
        assert f"## {task}" in text
    assert "The impact-penalty safety experiment" in text
    assert "*an archived note*" in text
