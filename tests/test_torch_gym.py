"""The port's gym adapter and level iterator against the JAX package on
the CPU: ``SafeLifeGymEnv`` over ``safelife_loader`` on append-still with
the same seeded actions (observations, rewards, terminations, the
performance info and both renders equal over several episodes), the
iterator's static files, repeat and shuffle, ``combine_levels`` /
``expand_levels`` against the JAX package's archives; the procgen entry
points (the default iterator, task names, yaml files, ``register``'s
tasks through ``gymnasium.make``) raise naming A6.
"""

import os

import numpy as np
import pytest
import torch

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


def test_gym_env_defaults_and_register_reach_the_a6_error():
    import gymnasium
    with pytest.raises(NotImplementedError, match="A6"):
        tgym.SafeLifeGymEnv()
    ids = ("safelife-append-still-easy-v1", "safelife-prune-still-v1")
    saved = dict(gymnasium.registry)
    try:
        # Another package may have registered the same ids in this process.
        for env_id in ids:
            gymnasium.registry.pop(env_id, None)
        tgym.register(tasks=("append-still-easy", "prune-still"))
        for env_id in ids:
            with pytest.raises(NotImplementedError, match="A6"):
                gymnasium.make(env_id)
    finally:
        gymnasium.registry.clear()
        gymnasium.registry.update(saved)


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
def test_loader_procgen_entries_raise_naming_a6(tmp_path, monkeypatch,
                                                 paths):
    monkeypatch.chdir(tmp_path)
    for name in ("levels.yaml", "levels.json"):
        (tmp_path / name).write_text("{}\n")
    with pytest.raises(NotImplementedError, match="A6"):
        titer.safelife_loader(*paths)
    for fn in (lambda: titer.gen_many("append-still", "out", 3),
               lambda: titer.gen_benchmarks("out", num_levels=3)):
        with pytest.raises(NotImplementedError, match="A6"):
            fn()
    assert not os.path.exists(tmp_path / "out")


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
