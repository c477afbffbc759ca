"""The port's launch tooling on the CPU: ``safelife_torch.scripts.launch``
(``local`` and ``pod``), ``remote_job`` and ``run_tb``, and ``train``
joining a process group.

* ``train`` on a tiny configuration (8 environments, view 17x17, one
  batch, four synthetic 13x13 levels): without the SAFELIFE_* variables it
  trains bit for bit as the parent's ``cmd_train`` built its Trainer, and
  as the one rank of a gloo group (in process) bit for bit as without.
  ``launch local --nproc 2 --device cpu`` starts two gloo ranks of
  ``python -m safelife_torch train``: they train as one process with
  ``PPOConfig(data_shards=2)`` (and not as one with ``data_shards=1``),
  and only rank 0 writes.  The ranks run where tensorboard cannot be
  imported, so the trainer writes ``scalars.jsonl``, which ``run_tb``
  summarizes when the ``tensorboard`` program is absent.
* ``train --task append-still`` as two gloo ranks (this file run as a
  script, a rank): rank 0 alone builds the curriculum's bank, both train
  on it to equal parameters, rank 0 alone writes, evaluates on the frozen
  suite, and both leave the group.
* ``run_processes`` stops at the first failure and at its deadline, and
  stops what it started.
* Fake ``gcloud``, ``rsync``, ``tmux`` and ``nohup`` (each records its
  argv) stand alone on ``PATH``: the port's ``remote_job`` runs the JAX
  ``scripts/remote-job``'s commands with ``safelife_tpu`` read as
  ``safelife_torch``, and ``launch pod`` syncs to the JAX
  ``scripts/launch-pod``'s target and passes ``train`` the same arguments.

Tolerance: the two-rank parameters against the one-process run's within
atol ``NET_ATOL`` = 1e-5.  The two-rank job's net computes in float32
(``FLOAT32_NET``, installed in the ranks by a ``sitecustomize`` on their
path; ``tests/torch_ranks.py`` holds its ranks so): one process and two
ranks then differ only by float32 summation order.  The default bfloat16
trunk rounds each rank's gradient sums to 8 bits and Adam turns a
rounding into a step of about the learning rate, which hides a wrong
shard split (1.2e-3 against 4.2e-3 with ``data_shards=1``).  ``spe``, the
counters and everything else bit for bit.
"""

import functools
import json
import os
import shlex
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from safelife_torch import __main__ as cli
from safelife_torch.game import SafeLifeGame
from safelife_torch.levels import synth
from safelife_torch.levels.iterator import combine_levels
from safelife_torch.metrics import logging as tlogging
from safelife_torch.parallel import distributed
from safelife_torch.scripts import launch, remote_job, run_tb
from safelife_torch.training import driver, ppo

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENVS, VIEW, STEPS = 8, 17, 160  # one batch of PPOConfig's 20 steps
LAUNCH_TIMEOUT_S = 150
FAKE_TOOLS = ("gcloud", "rsync", "tmux", "nohup")
NET_ATOL = 1e-5
# The task job: the curriculum's first bank cut to TASK_LEVELS levels,
# episodes and the final suite eval to TASK_TIME_LIMIT steps.
TASK_LEVELS, TASK_TIME_LIMIT = 4, 12
# The trainer's CNN computing in float32: the two-rank job's ranks and the
# one-process runs it is held to.
FLOAT32_NET = """
import torch
from safelife_torch.training import driver


class Float32CNN(driver.SafeLifeCNN):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, compute_dtype=torch.float32, **kwargs)
"""


def _archive(root):
    """Four synthetic 13x13 levels combined into one archive."""
    os.makedirs(root / "levels")
    for i in range(4):
        lv = synth.simple_level(13, 13, seed=i)
        game = SafeLifeGame(board_size=None)
        game.deserialize({
            "board": lv["board"], "goals": lv["goals"],
            "agent_loc": (int(lv["agent_col"]), int(lv["agent_row"])),
            "orientation": int(lv["orientation"]),
            "spawn_prob": float(lv["spawn_prob"]),
            "min_performance": float(lv["min_performance"])})
        game.save(str(root / "levels" / f"level-{i}.npz"))
    return combine_levels(str(root / "levels"))


def _train_args(archive):
    return ["--levels", archive, "--num-envs", str(ENVS), "--steps",
            str(STEPS), "--view", str(VIEW)]


def _start(nproc, logdir, archive, env):
    return subprocess.Popen(
        [sys.executable, "-m", "safelife_torch.scripts.launch", "local",
         "--nproc", str(nproc), "--device", "cpu", "--timeout",
         str(LAUNCH_TIMEOUT_S), logdir, "--", *_train_args(archive)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _start_task(outdir, env):
    """The two ranks of the task job (this file as a script), each logging
    to ``rank<r>.log`` in ``outdir``."""
    coordinator = f"127.0.0.1:{launch._free_port()}"
    procs = []
    for rank in range(2):
        with open(os.path.join(outdir, f"rank{rank}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), outdir],
                env=dict(env, **launch.rank_env(coordinator, 2, rank)),
                cwd=ROOT, stdout=log, stderr=subprocess.STDOUT))
    return procs


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The two-rank job of ``train`` and the task job, started and left
    running (the tests that need no result run meanwhile); killed at the
    module's end if they still run.  Their archive, dirs and processes,
    and a retry of each."""
    root = tmp_path_factory.mktemp("launch")
    # tensorboard made unimportable, as on a machine without it, and the
    # float32 net installed.
    shadow = root / "no-tensorboard" / "tensorboard"
    os.makedirs(shadow)
    (shadow / "__init__.py").write_text(
        "raise ImportError('tensorboard is not installed')\n")
    (shadow.parent / "sitecustomize.py").write_text(
        FLOAT32_NET + "\ndriver.SafeLifeCNN = Float32CNN\n")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(shadow.parent), ROOT]))
    out = dict(archive=_archive(root), logdir=str(root / "ranks2"),
               task=str(root / "task"))
    os.makedirs(out["task"])
    procs = []

    def start():
        procs.append(_start(2, out["logdir"], out["archive"], env))
        return procs[-1]

    def start_task():
        procs.extend(_start_task(out["task"], dict(
            os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)))
        return procs[-2:]
    out["proc"], out["start"] = start(), start
    out["task_procs"], out["start_task"] = start_task(), start_task
    yield out
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def launched(job):
    """The two-rank job waited for with a deadline (one retry when the
    port was taken meanwhile): its logdir and output."""
    proc = job["proc"]
    for attempt in range(2):
        out = proc.communicate(timeout=LAUNCH_TIMEOUT_S + 30)[0]
        if proc.returncode == 0:
            break
        clash = "EADDRINUSE" in out or "Address already in use" in out
        if not clash or attempt:
            raise AssertionError(f"rc {proc.returncode}:\n{out[-4000:]}")
        proc = job["start"]()
    return dict(job, out=out)


@pytest.fixture(scope="module")
def task_launched(job):
    """The task job waited for with a deadline, the first failure stopping
    the other rank (one retry when the port was taken meanwhile): each
    rank's results."""
    procs = job["task_procs"]
    for attempt in range(2):
        launch.wait_all(procs, LAUNCH_TIMEOUT_S)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        rcs = [p.returncode for p in procs]
        logs = []
        for rank in range(2):
            with open(os.path.join(job["task"], f"rank{rank}.log")) as fh:
                logs.append(fh.read())
        if rcs == [0, 0]:
            break
        clash = any("EADDRINUSE" in x or "Address already in use" in x
                    for x in logs)
        if not clash or attempt:
            raise AssertionError("\n".join(
                f"--- rank {r} (rc {rc}) ---\n{x[-4000:]}"
                for r, (rc, x) in enumerate(zip(rcs, logs))))
        procs = job["start_task"]()
    return [torch.load(os.path.join(job["task"], f"rank{r}.pt"),
                       weights_only=False) for r in range(2)]


def _task_rank(outdir):
    """One rank of the task job: ``train --task append-still`` through the
    command line (which joins the group and leaves it), cut to
    TASK_LEVELS and TASK_TIME_LIMIT, into a logdir of the rank's own.
    Saves the bank it trained on, the sources its bank factories built,
    its parameters, global step and eval suite, its logdir's files and
    whether it left the group."""
    from safelife_torch.training import curricula
    rank = int(os.environ["SAFELIFE_PROC_ID"])
    # No tensorboard writer: its import alone takes seconds.
    driver.make_summary_writer = lambda logdir: None
    made, trainers = [], []
    factory, make = curricula._bank_factory, curricula.make_curriculum_trainer

    def counted_factory(source, *args):
        build = factory(source, *args)

        def run():
            made.append(source)
            return build()
        return run

    def tracked(*args, **kwargs):
        trainer, total = make(*args, bank_levels=TASK_LEVELS,
                              time_limit=TASK_TIME_LIMIT,
                              eval_side_effect_samples=2, **kwargs)
        trainers.append(trainer)
        return trainer, total
    curricula._bank_factory = counted_factory
    curricula.make_curriculum_trainer = tracked
    logdir = os.path.join(outdir, f"run{rank}")
    cli.main(["train", logdir, "--task", "append-still", "--device", "cpu",
              "--num-envs", str(ENVS), "--steps", str(STEPS), "--view",
              str(VIEW)])
    (tr,) = trainers
    files = sorted(os.path.relpath(os.path.join(d, f), logdir)
                   for d, _, names in os.walk(logdir) for f in names)
    torch.save(dict(bank=tr.bank.to_numpy(), made=made,
                    params=tr.net.state_dict(), step=tr.global_step(),
                    eval_suite=tr.cfg.eval_suite, files=files,
                    left=not dist.is_initialized()),
               os.path.join(outdir, f"rank{rank}.pt"))


def _checkpoint(logdir):
    (name,) = os.listdir(os.path.join(logdir, "checkpoints"))
    return torch.load(os.path.join(logdir, "checkpoints", name),
                      weights_only=True)


def _assert_net_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _trainer(archive, ppo_cfg, **kw):
    cfg = driver.TrainerConfig(
        num_envs=ENVS, total_steps=STEPS, view_shape=(VIEW, VIEW),
        impact_penalty=0.0, min_performance=0.01, seed=0,
        record_videos=False, **kw)
    return driver.Trainer(cfg, ppo_cfg, level_paths=(archive,), device="cpu")


def test_train_in_a_group_of_one_as_without(job, tmp_path, monkeypatch):
    """``train`` without the SAFELIFE_* variables writes the checkpoint of
    the parent's ``cmd_train`` (``Trainer(TrainerConfig(...),
    PPOConfig())``); with them, as the one rank of a gloo group, it writes
    the same checkpoint and leaves the group (in process, the JSONL
    writer and no video)."""
    for k in ("SAFELIFE_COORDINATOR", "SAFELIFE_NUM_PROCS",
              "SAFELIFE_PROC_ID"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(driver, "make_summary_writer",
                        tlogging.JsonlSummaryWriter)
    monkeypatch.setattr(driver, "TrainerConfig", functools.partial(
        driver.TrainerConfig, record_videos=False))
    argv = [*_train_args(job["archive"]), "--device", "cpu"]
    cli.main(["train", str(tmp_path / "alone"), *argv])
    direct = _checkpoint(str(tmp_path / "alone"))
    monkeypatch.setenv("SAFELIFE_COORDINATOR", f"127.0.0.1:"
                                               f"{launch._free_port()}")
    monkeypatch.setenv("SAFELIFE_NUM_PROCS", "1")
    monkeypatch.setenv("SAFELIFE_PROC_ID", "0")
    try:
        cli.main(["train", str(tmp_path / "grouped"), *argv])
        assert not dist.is_initialized()
    finally:
        distributed.shutdown()
    one = _checkpoint(str(tmp_path / "grouped"))
    monkeypatch.undo()
    today = _trainer(job["archive"], ppo.PPOConfig())
    today.train()
    _assert_net_equal(direct["net"], today.net.state_dict())
    assert direct["spe"].item() == today.train_state.spe.item()
    assert direct["counters"]["num_steps"] == today.global_step()

    _assert_net_equal(one["net"], direct["net"])
    assert torch.equal(one["spe"], direct["spe"])
    assert one["update_step"] == direct["update_step"]
    assert one["counters"] == direct["counters"]


def test_local_refuses_more_ranks_than_cards(monkeypatch):
    monkeypatch.setattr(launch, "visible_cards", lambda: 1)
    with pytest.raises(ValueError, match="2 ranks on 1 visible cards"):
        launch.local("unused", nproc=2)
    monkeypatch.setattr(launch, "visible_cards", lambda: 0)
    with pytest.raises(ValueError, match="1 ranks on 0 visible cards"):
        launch.local("unused", nproc=1)
    with pytest.raises(ValueError, match="0 ranks on 0 visible cards"):
        launch.local("unused")
    with pytest.raises(ValueError, match="the ranks take the cards"):
        launch.local("unused", nproc=1, device="cuda")


def test_run_processes_stops_at_the_first_failure_and_the_deadline(
        tmp_path):
    exit_with = [sys.executable, "-c",
                 "import os, sys; sys.exit(int(os.environ['CODE']))"]
    assert launch.run_processes(exit_with, [{"CODE": "0"}] * 2, 60) == 0
    assert launch.run_processes(exit_with, [{"CODE": "0"}, {"CODE": "3"}],
                                60) == 3
    pid_file = tmp_path / "pid"
    sleeper = [sys.executable, "-c", "import os, time; open(%r, 'w').write("
               "str(os.getpid())); time.sleep(60)" % str(pid_file)]
    assert launch.run_processes(sleeper, [{}], timeout=1.5) == 124
    with pytest.raises(ProcessLookupError):  # killed and reaped
        os.kill(int(pid_file.read_text()), 0)


# ---------------------------------------------------------------------------
# Remote tooling under fake tools
# ---------------------------------------------------------------------------

FAKE = """#!{python}
import json, os, sys
with open({log!r}, "a") as fh:
    fh.write(json.dumps([os.path.basename(sys.argv[0])] + sys.argv[1:]) + "\\n")
"""


@pytest.fixture
def fake_tools(tmp_path, monkeypatch):
    """A directory of fakes that record their argv to ``calls.jsonl``, the
    only directory on PATH (with ``dirname``, which ``launch-pod`` runs);
    returns a function that reads and clears the record."""
    bin_dir, log = tmp_path / "bin", tmp_path / "calls.jsonl"
    os.makedirs(bin_dir)
    for tool in FAKE_TOOLS:
        path = bin_dir / tool
        path.write_text(FAKE.format(python=sys.executable, log=str(log)))
        path.chmod(0o755)
    os.symlink("/usr/bin/dirname" if os.path.exists("/usr/bin/dirname")
               else "/bin/dirname", bin_dir / "dirname")
    monkeypatch.setenv("PATH", str(bin_dir))

    def calls():
        if not log.exists():
            return []
        with open(log) as fh:
            out = [json.loads(line) for line in fh]
        log.unlink()
        return out
    return calls


def _jax(script, *args):
    path = os.path.join(ROOT, "scripts", script)
    cmd = ([sys.executable, path] if script == "remote-job"
           else ["/bin/bash", path])
    proc = subprocess.run(cmd + list(args), cwd=ROOT, capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def _as_port(calls):
    return json.loads(json.dumps(calls).replace("safelife_tpu",
                                                "safelife_torch"))


def test_remote_job_runs_the_jax_commands(fake_tools, capsys):
    argv = ["start", "inst", "job", "--zone", "us-z", "--", "--task",
            "append-still"]
    _jax("remote-job", *argv)
    want = _as_port(fake_tools())
    assert [c[0] for c in want] == ["rsync", "gcloud", "gcloud"]
    assert remote_job.main(argv) == 0
    assert fake_tools() == want
    for argv in (["resume", "inst", "job", "--zone", "us-z"],
                 ["ssh", "inst", "ls", "-l"]):
        _jax("remote-job", *argv)
        want = fake_tools()
        assert remote_job.main(argv) == 0
        assert fake_tools() == want

    # --nproc wraps train in launch local; --dry-run runs nothing.
    capsys.readouterr()
    assert remote_job.main(["start", "inst", "job", "--nproc", "2",
                            "--dry-run", "--", "--task", "append-still"]) == 0
    assert fake_tools() == []
    printed = capsys.readouterr().out
    assert ("python -m safelife_torch.scripts.launch local --nproc 2 "
            "~/job/data/job -- --task append-still") in printed
    assert printed.count("\n+ ") == 2 and printed.startswith("+ rsync")


def _train_part(command):
    """The ``python -m <pkg> train ...`` arguments of a start command."""
    words = shlex.split(command.split("&&", 1)[1])
    i = words.index("train")
    return words[i + 1:words.index(">", i)]


def test_launch_pod_syncs_and_trains_as_launch_pod(fake_tools, capsys):
    args = ["--task", "append-still", "--num-envs", "4096"]
    _jax("launch-pod", "tpu1", "us-z", "/data/run1", *args)
    want = _as_port(fake_tools())
    assert launch.main(["pod", "tpu1", "us-z", "/data/run1",
                        "--gpus-per-host", "1", "--", *args]) == 0
    got = fake_tools()
    assert [c[:3] for c in got] == [["gcloud", "compute", "scp"],
                                    ["gcloud", "compute", "ssh"]]
    # The same source and target (the remote folder named after the
    # package), the same train arguments.
    assert got[0][-2:] == want[0][-2:] == [ROOT, "tpu1:~/safelife_torch_job"]
    assert "--zone=us-z" in got[0] and "--zone=us-z" in got[1]
    (jax_cmd,) = [a[len("--command="):] for a in want[1]
                  if a.startswith("--command=")]
    (cmd,) = [a[len("--command="):] for a in got[1]
              if a.startswith("--command=")]
    assert _train_part(cmd) == _train_part(jax_cmd) == ["/data/run1", *args]
    assert cmd.startswith("cd ~/safelife_torch_job && ")

    capsys.readouterr()
    assert launch.main(["pod", "tpu1", "us-z", "/data/run1", "--dry-run",
                        "--", *args]) == 0
    assert fake_tools() == []
    assert capsys.readouterr().out.count("+ gcloud compute") == 2


def test_pod_ranks_for_two_hosts_of_two_cards():
    cmds = launch.pod_commands(["h1", "h2"], "z", "/data/run", ["--seed", "3"],
                               gpus_per_host=2, port=1234)
    assert [c[5:] for c in cmds[:2]] == [
        [launch.REPO, f"{h}:~/safelife_torch_job"] for h in ("h1", "h2")]
    ranks = []
    for host, cmd in zip(("h1", "h2"), cmds[2:]):
        assert cmd[:4] == ["gcloud", "compute", "ssh", host]
        script = cmd[-1][len("--command="):]
        assert script.startswith("cd ~/safelife_torch_job && ")
        assert script.endswith(" echo started")
        for part in script.split(" && ", 1)[1].split(" & ")[:-1]:
            words = shlex.split(part)
            env = dict(w.split("=", 1) for w in words[:3])
            assert words[3:9] == ["nohup", "python", "-m", "safelife_torch",
                                  "train", "/data/run"]
            assert words[9:] == ["--seed", "3", ">",
                                 f"train-{host}-{env['SAFELIFE_PROC_ID']}.log",
                                 "2>&1"]
            ranks.append((host, env))
    assert ranks == [(h, {"SAFELIFE_COORDINATOR": "h1:1234",
                          "SAFELIFE_NUM_PROCS": "4",
                          "SAFELIFE_PROC_ID": str(r)})
                     for h, r in (("h1", 0), ("h1", 1), ("h2", 2),
                                  ("h2", 3))]


# ---------------------------------------------------------------------------
# The two-rank job (last: it ran while the tests above did)
# ---------------------------------------------------------------------------

def test_two_ranks_train_as_two_data_shards(launched, monkeypatch):
    """Two gloo ranks of ``train``: one checkpoint, one config, one video
    and one scalar stream (rank 0's), and the parameters of one process
    with ``PPOConfig(data_shards=2)``, not those of one with
    ``data_shards=1`` (all three with the float32 net)."""
    logdir, out = launched["logdir"], launched["out"]
    assert "rank 0/2, gloo on cpu" in out and "rank 1/2, gloo on cpu" in out
    got = _checkpoint(logdir)
    step = got["counters"]["num_steps"]
    assert sorted(os.listdir(logdir)) == sorted([
        "checkpoints", "config.json", f"episode-{step}.gif",
        f"episode-{step}.npz", "scalars.jsonl", "training.yaml"])
    with open(os.path.join(logdir, "scalars.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    keys = [(r["tag"], r["step"]) for r in records]
    assert len(keys) == len(set(keys)) > 0  # one writer

    names = {}
    exec(FLOAT32_NET, names)
    monkeypatch.setattr(driver, "SafeLifeCNN", names["Float32CNN"])
    nets = {}
    for shards in (2, 1):
        want = _trainer(launched["archive"],
                        ppo.PPOConfig(data_shards=shards))
        want.train()
        assert want.net.compute_dtype == torch.float32
        assert step == want.global_step()
        assert got["update_step"] == want.train_state.update_step
        nets[shards] = dict(want.net.state_dict(),
                            spe=want.train_state.spe.detach())
    got = dict(got["net"], spe=got["spe"])
    assert got.keys() == nets[2].keys()
    err = {shards: max((got[k] - v).abs().max().item()
                       for k, v in net.items())
           for shards, net in nets.items()}
    for k, v in nets[2].items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=NET_ATOL, err_msg=k)
    assert err[1] > 10 * NET_ATOL, err  # the control fails the comparison


def test_task_ranks_train_on_rank_0s_bank(job, task_launched):
    """``train --task`` as two ranks: rank 0 alone builds the curriculum's
    bank and both train on it to equal parameters; rank 0 alone writes
    its checkpoint, evaluation and video; both leave the group."""
    first, second = task_launched
    assert first["made"] == ["append-still-easy"] and second["made"] == []
    assert first["bank"].keys() == second["bank"].keys()
    for k, v in first["bank"].items():
        np.testing.assert_array_equal(second["bank"][k], v, err_msg=k)
    assert len(first["bank"]["agent_col"]) == TASK_LEVELS
    assert first["eval_suite"] == second["eval_suite"] == "append-still"
    assert first["step"] == second["step"] >= STEPS
    _assert_net_equal(second["params"], first["params"])
    assert first["left"] and second["left"]
    files = first["files"]
    assert f"checkpoints/{first['step']}.pt" in files
    assert f"episode-{first['step']}.gif" in files and "eval.yaml" in files
    with open(os.path.join(job["task"], "run0", "eval.yaml")) as fh:
        assert "performance" in fh.read()
    assert second["files"] == []
    assert not os.path.exists(os.path.join(job["task"], "run1"))


def test_run_tb_summarizes_the_scalar_stream(launched, tmp_path, monkeypatch,
                                             capsys):
    """Without the ``tensorboard`` program ``run_tb`` prints the last value
    of each tag of each run's ``scalars.jsonl``."""
    monkeypatch.setenv("PATH", str(tmp_path))
    run_tb.main([launched["logdir"], str(tmp_path / "no-such-run")])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "tensorboard not installed; summarizing scalars.jsonl " \
                     "instead"
    with open(os.path.join(launched["logdir"], "scalars.jsonl")) as fh:
        last = {}
        for line in fh:
            rec = json.loads(line)
            last[rec["tag"]] = rec
    assert out[2] == f"{launched['logdir']}:"
    rows = out[3:]
    assert len(rows) == len(last)
    for row, tag in zip(rows, sorted(last)):
        assert row.split() == [tag, f"{last[tag]['value']:.4f}", "(step",
                               f"{last[tag]['step']})"]


if __name__ == "__main__":  # one rank of the task job
    _task_rank(sys.argv[1])
