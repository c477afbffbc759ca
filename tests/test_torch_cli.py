"""``python -m safelife_torch`` on the CPU, in process through
``safelife_torch.__main__.main``: ``print`` and ``render`` (a level, a
trajectory) against the JAX package's output, a tiny ``train`` on a
synthetic archive through ``--levels`` that writes its checkpoint and
episode video, ``bench`` of that logdir, and ``selftest``; and the
procgen commands against the JAX package's under one numpy seed: ``new``
(the printed level, the saved file), ``gen-benchmarks`` (in process and
on the spawn pool, the archive loaded by both packages), ``train --task``
(one tiny batch on the curriculum's first bank, which equals the JAX
package's ``gen_bank``), and ``play`` / ``print`` of a yaml parameter file
(``train``, ``bench`` and ``selftest`` without ``--device`` on a box
without CUDA: ``tests/test_torch_imports.py``).
The trainer's and the bench's time limit is cut to 12 steps for speed:
this file tests the command line's wiring, the paths behind it have
tests of their own.
"""

import functools
import json
import os
import shutil

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from safelife_torch import __main__ as cli
from safelife_torch import benchmarking
from safelife_torch.game import SafeLifeGame
from safelife_torch.levels import synth
from safelife_torch.levels.iterator import combine_levels
from safelife_torch.training import driver
from safelife_tpu import __main__ as jax_cli

torch.set_num_threads(1)

TIME_LIMIT = 12


@pytest.fixture
def archive(tmp_path):
    """Four synthetic 13x13 levels combined into one archive."""
    os.makedirs(tmp_path / "levels")
    for i in range(4):
        lv = synth.simple_level(13, 13, seed=i)
        game = SafeLifeGame(board_size=None)
        game.deserialize({
            "board": lv["board"], "goals": lv["goals"],
            "agent_loc": (int(lv["agent_col"]), int(lv["agent_row"])),
            "orientation": int(lv["orientation"]),
            "spawn_prob": float(lv["spawn_prob"]),
            "min_performance": float(lv["min_performance"])})
        game.save(str(tmp_path / "levels" / f"level-{i}.npz"))
    return combine_levels(str(tmp_path / "levels"))


def test_print_matches_jax(capsys):
    cli.main(["print", "puzzles/01*"])
    got = capsys.readouterr().out
    jax_cli.main(["print", "puzzles/01*"])
    assert got == capsys.readouterr().out
    assert "\x1b[" in got and got.count("\n") > 10


def test_render_level_and_trajectory_match_jax(tmp_path, capsys):
    lv = synth.simple_level(13, 13, seed=1)
    boards = np.stack([np.roll(lv["board"], t, axis=1) for t in range(5)])
    outputs = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        np.savez(tmp_path / f"{name}-level.npz", board=lv["board"],
                 goals=lv["goals"])
        np.savez(tmp_path / f"{name}-traj.npz", board=boards,
                 goals=np.stack([lv["goals"]] * 5),
                 orientation=np.arange(5) % 4)
        main(["render", str(tmp_path / f"{name}-*.npz")])
        outputs[name] = capsys.readouterr().out
        assert os.path.exists(tmp_path / f"{name}-level.png")
        assert os.path.exists(tmp_path / f"{name}-traj.gif")
    assert outputs["port"].count(" -> ") == 2
    np.testing.assert_array_equal(imageio.imread(tmp_path / "port-level.png"),
                                  imageio.imread(tmp_path / "jax-level.png"))
    got = imageio.mimread(tmp_path / "port-traj.gif")
    want = imageio.mimread(tmp_path / "jax-traj.gif")
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[..., :3], w[..., :3])


def test_train_bench_render_selftest(tmp_path, archive, monkeypatch, capsys):
    monkeypatch.setattr(driver, "TrainerConfig", functools.partial(
        driver.TrainerConfig, time_limit=TIME_LIMIT))
    monkeypatch.setattr(benchmarking, "run_benchmark", functools.partial(
        benchmarking.run_benchmark, time_limit=TIME_LIMIT))
    run = str(tmp_path / "run")
    writers = []
    make_writer = driver.make_summary_writer

    def tracked_writer(logdir):
        writers.append(make_writer(logdir))
        return writers[-1]

    monkeypatch.setattr(driver, "make_summary_writer", tracked_writer)
    try:
        cli.main(["train", run, "--levels", archive, "--num-envs", "4",
                  "--steps", "160", "--view", "17", "--device", "cpu"])
    finally:
        for w in writers:
            w.close()  # leave no event-file thread behind
    files = os.listdir(run)
    assert "config.json" in files and os.listdir(os.path.join(run,
                                                              "checkpoints"))
    step = max(int(f[:-3]) for f in os.listdir(os.path.join(run,
                                                            "checkpoints")))
    assert {f"episode-{step}.npz", f"episode-{step}.gif"} <= set(files)
    with np.load(os.path.join(run, f"episode-{step}.npz")) as data:
        frames = len(data["board"])
    assert 1 <= frames <= TIME_LIMIT

    capsys.readouterr()
    cli.main(["bench", archive, "--policy", run, "--side-effects", "4",
              "--device", "cpu"])
    line = capsys.readouterr().out
    assert line.startswith("levels=4 ") and "mean_side_effects=" in line

    os.remove(os.path.join(run, f"episode-{step}.gif"))
    cli.main(["render", os.path.join(run, f"episode-{step}.npz")])
    gif = os.path.join(run, f"episode-{step}.gif")
    assert len(imageio.mimread(gif)) == frames

    cli.main(["selftest", "--device", "cpu"])
    assert "integrity OK on the CPU" in capsys.readouterr().out


def test_train_gtrxl_checkpoint_load_and_bench(tmp_path, archive,
                                               monkeypatch):
    """``train --algo gtrxl`` (the core cut to 2 layers of 32 over a
    memory of 8 for the CPU) writes its net's name, a checkpoint that
    ``load_policy`` rebuilds as a recurrent policy, and that policy plays
    two levels through ``run_benchmark``."""
    from safelife_torch.training.model import SafeLifeGTrXLNet
    monkeypatch.setattr(driver, "TrainerConfig", functools.partial(
        driver.TrainerConfig, time_limit=TIME_LIMIT))
    monkeypatch.setattr(driver, "SafeLifeGTrXLNet", functools.partial(
        SafeLifeGTrXLNet, layers=2, d_model=32, heads=2, head_dim=16,
        mlp=64, memory=8))
    monkeypatch.setattr(driver, "make_summary_writer", lambda logdir: None)
    run = str(tmp_path / "run")
    cli.main(["train", run, "--levels", archive, "--num-envs", "4",
              "--steps", "160", "--view", "17", "--algo", "gtrxl",
              "--device", "cpu"])
    with open(os.path.join(run, "config.json")) as fh:
        cfg = json.load(fh)
    assert cfg["net"] == "SafeLifeGTrXLNet" and cfg["recurrent"]
    policy, view = driver.load_policy(run, device="cpu")
    assert policy.recurrent and isinstance(policy.net, SafeLifeGTrXLNet)
    os.makedirs(tmp_path / "two")
    for i in range(2):
        shutil.copy(tmp_path / "levels" / f"level-{i}.npz",
                    tmp_path / "two")
    two = combine_levels(str(tmp_path / "two"))
    results = benchmarking.run_benchmark(
        two, policy, view_shape=view, time_limit=TIME_LIMIT,
        side_effect_samples=4, device="cpu")
    assert len(results["length"]) == 2


@pytest.mark.parametrize("recurrent", [False, True])
def test_config_json_without_a_net_name_still_loads(tmp_path, recurrent):
    """A logdir written before ``config.json`` named its net: the CNN or
    the LSTM by ``recurrent``."""
    from safelife_torch.training import model
    cls = model.SafeLifeLSTMNet if recurrent else model.SafeLifeCNN
    net = cls(view_shape=(17, 17))
    os.makedirs(tmp_path / "checkpoints")
    torch.save({"net": net.state_dict()}, tmp_path / "checkpoints" / "8.pt")
    with open(tmp_path / "config.json", "w") as fh:
        json.dump({"view_shape": [17, 17], "in_channels": 15, "n_gamma": 1,
                   "num_actions": 9, "time_limit": 12,
                   "recurrent": recurrent}, fh)
    policy, view = driver.load_policy(str(tmp_path), device="cpu")
    assert type(policy.net) is cls and view == (17, 17)
    assert getattr(policy, "recurrent", False) == recurrent


def _in_dir(monkeypatch, path):
    os.makedirs(path, exist_ok=True)
    monkeypatch.chdir(path)
    (path / "levels.yaml").write_text("later_regions: append easy\n")


@pytest.mark.parametrize("argv", [
    ["new", "append-dynamic", "--seed", "4"],
    ["new", "append-still", "--seed", "3", "--save", "lvl.npz"],
    ["gen-benchmarks", "out", "--tasks", "append-still", "--num-levels",
     "3", "--workers", "0"],
    ["gen-benchmarks", "out", "--tasks", "append-still", "--num-levels",
     "3", "--workers", "2"],
    ["train", "run", "--task", "append-still", "--device", "cpu",
     "--num-envs", "4", "--steps", "16", "--view", "17"],
    ["play", "levels.yaml"], ["print", "levels.yaml"]])
def test_procgen_commands_match_jax(tmp_path, monkeypatch, capsys, argv):
    from safelife_torch.levels import iterator as titer
    from safelife_torch.levels import loader as tloader
    from safelife_tpu import procgen as jprocgen
    from safelife_tpu.interactive import play as jplay
    from safelife_tpu.levels import loader as jloader

    # A deadline for the spawned pool of ``--workers 2``.
    monkeypatch.setattr(titer, "WORKER_TIMEOUT_S", 120)
    if argv[0] == "train":
        _train_task(tmp_path, monkeypatch, argv, jprocgen)
        return
    played = {}
    for name, main, play_module in (("port", cli.main, None),
                                    ("jax", jax_cli.main, jplay)):
        _in_dir(monkeypatch, tmp_path / name)
        if argv[0] == "play":
            from safelife_torch.interactive import play as tplay
            module = tplay if play_module is None else play_module
            monkeypatch.setattr(
                module.GameLoop, "play",
                lambda self, game, name=name: played.setdefault(
                    name, game) and "QUIT")
        run = argv
        if name == "jax" and "--workers" in argv:
            # The JAX package's pool forks this process: compare the
            # archive, not the pool.
            run = argv[:-1] + ["0"]
        np.random.seed(21)
        main(run)
        played[name + "-out"] = capsys.readouterr().out

    if argv[0] == "play":
        np.testing.assert_array_equal(played["port"].board,
                                      played["jax"].board)
        np.testing.assert_array_equal(played["port"].goals,
                                      played["jax"].goals)
        return
    if argv[0] != "gen-benchmarks":
        assert played["port-out"].replace(
            str(tmp_path / "port"), "<dir>") == played["jax-out"].replace(
                str(tmp_path / "jax"), "<dir>")
        assert played["port-out"].count("\n") > 20
    if "--save" in argv:
        with np.load(tmp_path / "port" / "lvl.npz") as got, \
                np.load(tmp_path / "jax" / "lvl.npz") as want:
            for key in want.files:
                if key != "class":  # each package's own class name
                    np.testing.assert_array_equal(got[key], want[key])
    if argv[0] == "gen-benchmarks":
        archive = str(tmp_path / "port" / "out" / "append-still.npz")
        assert played["port-out"].strip() == os.path.join(
            "out", "append-still.npz")
        got = tloader.load_levels(archive)
        assert len(got) == 3
        want = jloader.load_levels(archive)
        for g, w in zip(got, want):
            for key in w:
                np.testing.assert_array_equal(g[key], w[key])
        if argv[-1] == "0":  # in process: the JAX package's own levels
            jax_archive = str(tmp_path / "jax" / "out" / "append-still.npz")
            for g, w in zip(got, jloader.load_levels(jax_archive)):
                np.testing.assert_array_equal(g["board"], w["board"])
                np.testing.assert_array_equal(g["goals"], w["goals"])


def _train_task(tmp_path, monkeypatch, argv, jprocgen):
    """``train --task``: one tiny batch on the curriculum's first bank (4
    levels), evaluated on the frozen suite at its end."""
    from safelife_torch.training import curricula

    monkeypatch.chdir(tmp_path)
    trainers = []
    make = curricula.make_curriculum_trainer

    def tracked(*args, **kw):
        trainer, total = make(*args, bank_levels=4, time_limit=TIME_LIMIT,
                              record_videos=False,
                              eval_side_effect_samples=4, **kw)
        trainers.append(trainer)
        return trainer, total

    monkeypatch.setattr(curricula, "make_curriculum_trainer", tracked)
    try:
        cli.main(argv)
    finally:
        for t in trainers:
            if t.writer:
                t.writer.close()  # leave no event-file thread behind
    trainer, = trainers
    want = jprocgen.gen_bank("append-still-easy", num_levels=4, seed=0)
    got = trainer.bank.to_numpy()
    for field in ("board", "goals", "agent_row", "agent_col",
                  "min_performance", "possible0"):
        np.testing.assert_array_equal(
            got[field], np.asarray(getattr(want, field)), err_msg=field)
    assert trainer.cfg.eval_suite == "append-still"
    assert trainer.global_step() >= 16
    assert os.listdir(tmp_path / "run" / "checkpoints")
    with open(tmp_path / "run" / "eval.yaml") as fh:
        assert "performance" in fh.read()
