"""The port's episode recording against the JAX package on the CPU:
``record_episode`` on spawnless banks (a synthetic bank and the first
levels of the packaged append-still) with a deterministic policy that both
packages compute exactly, an episode cut by its time limit and one cut by
``max_steps``, so boards, goals, orientations, the reward and the length
must be equal; a recurrent policy's carry threaded the same way on both
sides; and a CPU ``Trainer`` with ``record_videos`` writing
``episode-<step>.npz`` and ``.gif`` after each checkpoint.  Every
comparison is exact.
"""

import functools
import os

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safelife_torch.env.env import BatchedSafeLifeEnv as TorchEnv
from safelife_torch.env.env import EnvConfig as TorchConfig
from safelife_torch.levels import loader as tloader
from safelife_torch.levels import synth as tsynth
from safelife_torch.metrics import recording as TR
from safelife_torch.render import graphics as TG
from safelife_torch.training import driver as tdriver
from safelife_torch.training import ppo as tppo
from safelife_tpu.env.env import BatchedSafeLifeEnv as JaxEnv
from safelife_tpu.env.env import EnvConfig as JaxConfig
from safelife_tpu.levels import loader as jloader
from safelife_tpu.levels import synth as jsynth
from safelife_tpu.metrics import recording as JR

torch.set_num_threads(1)

VIEW = (15, 15)
# (time limit, max_steps): the episode ends at its time limit inside
# max_steps, and max_steps ends the recording first.
LIMITS = ((50, 60), (1000, 30))


def _hash(obs, xp):
    c = obs.shape[-1]
    if xp is jnp:
        return (obs.astype(jnp.int32) * (1 + jnp.arange(c))).sum((1, 2, 3))
    weights = 1 + torch.arange(c, dtype=torch.int32, device=obs.device)
    return (obs.to(torch.int32) * weights).sum((1, 2, 3))


def jax_policy(obs, key):
    return _hash(obs, jnp) % 9


def hash_policy(obs, generator=None):
    """The same deterministic function of the observation as
    :func:`jax_policy`."""
    return _hash(obs, torch) % 9


class JaxRecurrent:
    """A deterministic recurrent policy in the JAX package's form
    (``raw(params, obs, carry, key) -> (action, carry)``)."""
    recurrent = True
    params = None

    @staticmethod
    def init_carry(batch):
        return jnp.zeros((batch,), jnp.int32)

    @staticmethod
    def raw(params, obs, carry, key):
        carry = (carry * 7 + _hash(obs, jnp)) % 1009
        return (carry + _hash(obs, jnp)) % 9, carry


def torch_recurrent(obs, carry, generator=None):
    carry = (carry * 7 + _hash(obs, torch)) % 1009
    return (carry + _hash(obs, torch)) % 9, carry


torch_recurrent.recurrent = True
torch_recurrent.init_carry = lambda batch: torch.zeros(batch,
                                                       dtype=torch.int32)


@functools.lru_cache(maxsize=None)
def _banks(name):
    if name == "synth":
        return (jsynth.synth_bank(3, h=13, w=13),
                tsynth.synth_bank(3, h=13, w=13, device="cpu"))
    path = "benchmarks/v1.0/append-still"
    return (jloader.build_bank(jloader.load_levels(path)[:3]),
            tloader.build_bank(tloader.load_levels(path)[:3], device="cpu"))


@functools.lru_cache(maxsize=None)
def _both(name, limits, recurrent=False):
    time_limit, max_steps = limits
    jbank, tbank = _banks(name)
    want = JR.record_episode(
        JaxEnv(JaxConfig(view_shape=VIEW, time_limit=time_limit)), jbank,
        JaxRecurrent() if recurrent else jax_policy, jax.random.PRNGKey(0),
        level_idx=1, max_steps=max_steps)
    got = TR.record_episode(
        TorchEnv(TorchConfig(view_shape=VIEW, time_limit=time_limit),
                 device="cpu"), tbank,
        torch_recurrent if recurrent else hash_policy,
        torch.Generator().manual_seed(0), level_idx=1, max_steps=max_steps)
    return got, want


def _assert_equal(got, want):
    for k in ("board", "goals", "orientation"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("reward", "length", "level_idx"):
        assert got[k] == want[k], (k, got[k], want[k])


@pytest.mark.parametrize("limits", LIMITS)
@pytest.mark.parametrize("name", ["synth", "append-still"])
def test_record_episode_matches_jax(name, limits):
    got, want = _both(name, limits)
    _assert_equal(got, want)
    time_limit, max_steps = limits
    assert got["length"] == min(time_limit + 1, max_steps)
    # The agent moved, so the frames are not all the same.
    assert len({(b.tobytes(), o) for b, o in
                zip(got["board"], got["orientation"])}) > 1


def test_recurrent_record_episode_matches_jax():
    got, want = _both("synth", LIMITS[0], recurrent=True)
    _assert_equal(got, want)
    plain, _ = _both("synth", LIMITS[0])
    assert not np.array_equal(got["orientation"], plain["orientation"])


def test_save_trajectory_writes_npz_and_gif(tmp_path):
    got, _ = _both("append-still", LIMITS[1])
    files = TR.save_trajectory(got, str(tmp_path / "ep"))
    assert files == [str(tmp_path / "ep.npz"), str(tmp_path / "ep.gif")]
    frames = imageio.mimread(files[1])
    assert len(frames) == got["length"]
    for t in (0, got["length"] - 1):
        np.testing.assert_array_equal(
            frames[t][..., :3], TG.render_board(
                got["board"][t], got["goals"][t], got["orientation"][t]))


@pytest.mark.parametrize("recurrent", [False, True])
def test_trainer_records_a_video_after_each_checkpoint(tmp_path, recurrent):
    bank = tsynth.synth_bank(4, h=13, w=13, device="cpu")
    tc = tdriver.TrainerConfig(
        num_envs=8, total_steps=64, report_every=32, save_every=32,
        view_shape=(17, 17), time_limit=10, logdir=str(tmp_path),
        recurrent=recurrent)
    assert tc.record_videos  # the default
    pc = tppo.PPOConfig(steps_per_env=4, num_minibatches=2,
                        epochs_per_batch=2)
    tr = tdriver.Trainer(tc, pc, bank=bank, device="cpu")
    try:
        tr.train()
    finally:
        tr.writer.close()  # leave no event-file thread behind
    assert sorted(f for f in os.listdir(tmp_path)
                  if f.startswith("episode-")) == [
        "episode-32.gif", "episode-32.npz", "episode-64.gif",
        "episode-64.npz"]
    path = str(tmp_path / "episode-64.npz")
    with np.load(path) as data:
        boards = data["board"]
        assert boards.shape[1:] == (13, 13) and boards.dtype == np.uint16
        assert 1 <= len(boards) <= tc.time_limit
        assert data["goals"].shape == boards.shape
        assert data["orientation"].shape == (len(boards),)
    assert len(imageio.mimread(str(tmp_path / "episode-64.gif"))) == len(
        boards)
    os.remove(str(tmp_path / "episode-64.gif"))
    assert TG.render_file(path) == str(tmp_path / "episode-64.gif")
    assert len(imageio.mimread(str(tmp_path / "episode-64.gif"))) == len(
        boards)
