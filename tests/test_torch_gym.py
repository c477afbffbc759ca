"""The port's gym adapter and level iterator against the JAX package on
the CPU: ``SafeLifeGymEnv`` over ``safelife_loader`` on append-still with
the same seeded actions (observations, rewards, terminations, the
performance info and both renders equal over several episodes), the
iterator's static files, repeat and shuffle, ``combine_levels`` /
``expand_levels`` against the JAX package's archives; and the procgen
entry points (the default iterator, task names, yaml and json files,
``register``'s tasks through ``gymnasium.make``, ``gen_many`` and
``gen_benchmarks``) against the JAX package's under one numpy seed.  The
JAX side always runs with ``num_workers=0``: its pool forks the test
process.  The port's pool spawns its workers; with one worker it
continues this process's numpy stream, so it gives the JAX package's
in-process levels.
"""

import os

import numpy as np
import pytest
import torch

from safelife_torch import cells as C
from safelife_torch import gym_env as tgym
from safelife_torch.levels import iterator as titer
from safelife_tpu import gym_env as jgym
from safelife_tpu.levels import iterator as jiter

torch.set_num_threads(1)

SUITE = "benchmarks/v1.0/append-still.npz"


def test_gym_env_matches_jax():
    envs = [tgym.SafeLifeGymEnv(titer.safelife_loader(SUITE, repeat=True),
                                view_shape=(15, 15), time_limit=40),
            jgym.SafeLifeGymEnv(jiter.safelife_loader(SUITE, repeat=True,
                                                      num_workers=0),
                                view_shape=(15, 15), time_limit=40)]
    obs = [env.reset(seed=0)[0] for env in envs]
    assert obs[0].shape == (15, 15, 15) and obs[0].dtype == np.uint8
    np.testing.assert_array_equal(*obs)
    rng = np.random.RandomState(0)
    episodes = 0
    for t in range(130):
        a = rng.randint(9)
        (o1, r1, te1, tr1, i1), (o2, r2, te2, tr2, i2) = (
            env.step(a) for env in envs)
        np.testing.assert_array_equal(o1, o2, f"step {t}")
        assert (r1, te1, tr1) == (r2, te2, tr2), t
        assert type(r1) is float and type(te1) is bool
        for k in ("performance", "episode_reward", "times_up", "title"):
            assert i1[k] == i2[k], (k, t)
        np.testing.assert_array_equal(i1["board"], i2["board"])
        if te1 or tr1:
            episodes += 1
            for env in envs:
                env.reset()
    assert episodes >= 3
    assert envs[0].render() == envs[1].render()
    for env in envs:
        env.render_mode = "rgb_array"
    np.testing.assert_array_equal(envs[0].render(), envs[1].render())
    assert envs[0].action_space.n == 9
    assert envs[0].observation_space.shape == (15, 15, 15)


def assert_same_game(got, want):
    np.testing.assert_array_equal(got.board, want.board)
    np.testing.assert_array_equal(got.goals, want.goals)
    assert (got.file_name, got.agent_loc, got.orientation, got.spawn_prob,
            got.min_performance) == (want.file_name, want.agent_loc,
                                     want.orientation, want.spawn_prob,
                                     want.min_performance)


@pytest.mark.parametrize("task", [None, "append-still-easy"])
def test_gym_default_env_and_registered_task_match_jax(task):
    """The default env (procgen from the default parameters) and a
    registered task made through gymnasium, each on the port's one-worker
    spawn pool, against the JAX env on the same levels in process."""
    import gymnasium
    if task is None:
        env = tgym.SafeLifeGymEnv(view_shape=(15, 15), time_limit=30)
    else:
        env_id = f"safelife-{task}-v1"
        saved = dict(gymnasium.registry)
        try:
            # Another package may have registered the same id here.
            gymnasium.registry.pop(env_id, None)
            tgym.register(tasks=(task,))
            env = gymnasium.make(env_id, view_shape=(15, 15),
                                 time_limit=30).unwrapped
        finally:
            gymnasium.registry.clear()
            gymnasium.registry.update(saved)
    assert isinstance(env, tgym.SafeLifeGymEnv)
    want = jgym.SafeLifeGymEnv(
        jiter.safelife_loader(*([task] if task else []), num_workers=0),
        view_shape=(15, 15), time_limit=30)
    try:
        np.random.seed(11)
        obs = env.reset()[0]
        np.random.seed(11)
        np.testing.assert_array_equal(obs, want.reset()[0])
        assert_same_game(env.game, want.game)
        if env.game.is_stochastic:
            return  # the pool's game carries the worker's spawn stream
        rng = np.random.RandomState(0)
        for t in range(20):
            a = rng.randint(9)
            (o1, r1, te1, tr1, _), (o2, r2, te2, tr2, _) = (
                e.step(a) for e in (env, want))
            np.testing.assert_array_equal(o1, o2, f"step {t}")
            assert (r1, te1, tr1) == (r2, te2, tr2), t
    finally:
        env.level_iterator.close()  # stops the worker pool


def test_loader_static_levels_repeat_and_shuffle():
    games = list(titer.safelife_loader(SUITE))
    want = list(jiter.safelife_loader(SUITE, num_workers=0))
    assert len(games) == len(want) == 100
    for g, w in zip(games, want):
        np.testing.assert_array_equal(g.board, w.board)
        np.testing.assert_array_equal(g.goals, w.goals)
        assert (g.file_name, g.agent_loc, g.orientation, g.spawn_prob,
                g.min_performance) == (w.file_name, w.agent_loc,
                                       w.orientation, w.spawn_prob,
                                       w.min_performance)
    once = [g.file_name for g in titer.safelife_loader("puzzles/0*")]
    assert len(once) > 1
    assert [g.file_name for g in titer.safelife_loader(
        "puzzles/0*", repeat=2)] == once * 2
    forever = titer.safelife_loader("puzzles/01*", repeat=True)
    assert len({next(forever).file_name for _ in range(5)}) == 1
    shuffled = [g.file_name for g in
                titer.safelife_loader("puzzles", shuffle=True)]
    assert sorted(shuffled) == sorted(
        g.file_name for g in titer.safelife_loader("puzzles"))


@pytest.mark.parametrize("paths", [(), ("append-still-easy",),
                                   ("levels.yaml",), ("levels.json",)])
def test_loader_procgen_entries_match_jax(tmp_path, monkeypatch, paths):
    """Procgen entries in process: the default parameters, a preset, and
    yaml / json parameter files; 'auto' repeats a single procgen entry."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "levels.yaml").write_text(
        "later_regions: build easy\nboard_shape: [14, 14]\n")
    (tmp_path / "levels.json").write_text(
        '{"later_regions": "prune easy", "min_performance": 0.25}\n')
    games = []
    for module in (titer, jiter):
        np.random.seed(5)
        loader = module.safelife_loader(*paths, num_workers=0)
        games.append([next(loader) for _ in range(3)])
    for got, want in zip(*games):
        assert_same_game(got, want)
        assert (got.board & C.AGENT).any()
    assert not np.array_equal(games[0][0].board, games[0][1].board)


def test_loader_spawn_pool_and_archive_utilities(tmp_path):
    """Two spawned workers reseed every level; gen_many and gen_benchmarks
    in process equal the JAX package's, and their archives load."""
    pool = titer.safelife_loader("append-still-easy", num_workers=2,
                                 max_queue=2)
    try:
        games = [next(pool) for _ in range(3)]
    finally:
        pool.close()
    assert all((g.board & C.AGENT).any() for g in games)
    assert not (np.array_equal(games[0].board, games[1].board)
                and np.array_equal(games[1].board, games[2].board))

    out = {}
    for name, module in (("port", titer), ("jax", jiter)):
        np.random.seed(8)
        module.gen_many("append-still", str(tmp_path / name / "many"), 3,
                        num_workers=0)
        np.random.seed(8)
        out[name] = module.gen_benchmarks(
            str(tmp_path / name / "suites"), tasks=["prune-still"],
            num_levels=2, num_workers=0)
        assert sorted(os.listdir(tmp_path / name / "many")) == [
            f"many-{k}.npz" for k in (1, 2, 3)]
    for f in os.listdir(tmp_path / "port" / "many"):
        with np.load(tmp_path / "port" / "many" / f) as got, \
                np.load(tmp_path / "jax" / "many" / f) as want:
            assert got.files == want.files
            for key in want.files:
                if key != "class":  # each package's own class name
                    np.testing.assert_array_equal(got[key], want[key])
    with np.load(out["port"][0]) as got, np.load(out["jax"][0]) as want:
        for field in want["levels"].dtype.fields:
            np.testing.assert_array_equal(got["levels"][field],
                                          want["levels"][field])
    assert len(list(titer.safelife_loader(out["port"][0]))) == 2


def test_combine_and_expand_levels_match_jax(tmp_path):
    outputs = {}
    for name, module in (("port", titer), ("jax", jiter)):
        directory = module.expand_levels(
            str(_copy(SUITE, tmp_path / name / "suite.npz")))
        assert len(os.listdir(directory)) == 100
        outputs[name] = module.combine_levels(directory)
    with np.load(outputs["port"]) as got, np.load(outputs["jax"]) as want:
        assert got["levels"].dtype == want["levels"].dtype
        for field in got["levels"].dtype.fields:
            np.testing.assert_array_equal(got["levels"][field],
                                          want["levels"][field])
    games = list(titer.safelife_loader(outputs["port"]))
    assert len(games) == 100


def _copy(src, dst):
    from safelife_torch.levels import loader
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    with open(next(loader.find_files(src)), "rb") as fh:
        data = fh.read()
    with open(dst, "wb") as fh:
        fh.write(data)
    return dst
