"""The port's data-parallel training (``safelife_torch.parallel`` and
``PPOConfig.data_shards``) on the CPU.

* Data shards against JAX: for JAX's per-shard permutations of one key,
  the port's minibatch k holds the environments of JAX's shuffle +
  ``dynamic_slice_in_dim`` + ``swapaxes`` path in the same order, and its
  loss and gradients (feed-forward and recurrent) are within ``LOSS_TOL``
  of ``ppo_loss`` / ``ppo_loss_recurrent``.
* One process against shards: a sharded env draws the whole batch's
  numbers and keeps its rows, so its states, spawns, level picks and
  actions are bit for bit the rows of the whole batch's; the Philox draw
  at an offset of k is rows [k, k + n) of the whole field.
* Two gloo ranks (``torch_ranks.py``, started through ``initialize`` and
  the SAFELIFE_* variables): a ``Trainer(mesh=)`` keeps parameters
  bit-equal across ranks with 8 environments a rank and a global step,
  checkpoints on rank 0 and restores on both; each rank's rollout is bit
  for bit its shard of the one-process rollout; the global-mean loss terms
  give the one-process gradient where the ranks' own means would not;
  ``collective_stats`` shows flat per-rank FLOPs and only the gradient
  crossing ranks; the halo exchange equals the JAX package's CA.
* ``dp_efficiency_model`` against hand-computed values, ``scaling_report``,
  ``PhaseTimer`` and ``trace``.

Tolerances: loss and gradients rtol 1e-4, atol 1e-6 (float32, the two
sides sum in other orders); the net's outputs on a shard against the
whole batch rtol 1e-5, atol 1e-6 (a convolution of fewer rows may sum in
another order); one-process against two-rank parameters after 8 Adam steps
of a float32 net atol 1e-5; everything else bit for bit.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from safelife_torch.env import wrappers as TW
from safelife_torch.env.env import BatchedSafeLifeEnv, EnvConfig
from safelife_torch.levels import synth
from safelife_torch.ops import rng
from safelife_torch.parallel import distributed, mesh as pmesh
from safelife_torch.training import driver, ppo
from safelife_torch.utils import profiling
from safelife_tpu.training import ppo as jppo

torch.set_num_threads(1)

LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
NET_TOL = dict(rtol=1e-5, atol=1e-6)
T, B, NM = 3, 16, 2


def _mesh(rank=0, world=1):
    """A mesh without a process group (collectives at world 1 are the
    identity; at world 2 only the slicing is used)."""
    return pmesh.DataMesh(rank=rank, world_size=world,
                          device=torch.device("cpu"))


def _jax_perms(shards, local, seed=7):
    """JAX's per-shard permutations of one epoch key (ppo.py's vmap over
    ``jax.random.split(key_e, S)``)."""
    return np.array(jax.vmap(lambda k: jax.random.permutation(k, local))(
        jax.random.split(jax.random.PRNGKey(seed), shards)))


def _jax_minibatch(x, perm, k, mb):
    """JAX's train_batch path for one leaf (T, B, ...): split into shards,
    shuffle each shard, slice minibatch k, shard axis to the front."""
    shards, local = perm.shape
    x = jnp.asarray(x).reshape((x.shape[0], shards, local) + x.shape[2:])
    idx = jnp.asarray(perm).reshape((1, shards, local) + (1,) * (x.ndim - 3))
    shuffled = jnp.take_along_axis(x, idx, axis=2)
    return jax.lax.dynamic_slice_in_dim(
        shuffled, k * mb, mb, axis=2).swapaxes(0, 1)


def _jax_recurrent_minibatch(x, perm, k, mb):
    """JAX's RecurrentPPO path: the same slice, (S, mb) merged shard-major
    into the env axis."""
    shards, local = perm.shape
    x = jnp.asarray(x).reshape((x.shape[0], shards, local) + x.shape[2:])
    idx = jnp.asarray(perm).reshape((1, shards, local) + (1,) * (x.ndim - 3))
    shuffled = jnp.take_along_axis(x, idx, axis=2)
    return jax.lax.dynamic_slice_in_dim(
        shuffled, k * mb, mb, axis=2).reshape(
            (x.shape[0], shards * mb) + x.shape[3:])


@pytest.mark.parametrize("shards", [2, 4])
def test_minibatch_rows_match_jax(shards):
    local = B // shards
    mb = local // NM
    perm = _jax_perms(shards, local)
    env_ids = np.broadcast_to(np.arange(B), (T, B)).copy()
    seen = []
    for k in range(NM):
        want = np.asarray(_jax_minibatch(env_ids, perm, k, mb))  # (S, T, mb)
        assert (want == want[:, :1]).all()  # whole environments
        rows = ppo.minibatch_rows(torch.as_tensor(perm), k, mb)
        np.testing.assert_array_equal(rows.numpy(), want[:, 0].reshape(-1))
        recurrent = np.asarray(_jax_recurrent_minibatch(env_ids, perm, k, mb))
        np.testing.assert_array_equal(rows.numpy(), recurrent[0])
        seen.extend(rows.tolist())
    assert sorted(seen) == list(range(B))  # an epoch takes every env once


def _batch(seed=1, n_gamma=1):
    rng_ = np.random.RandomState(seed)
    return dict(
        logits=rng_.normal(size=(T, B, 9)).astype(np.float32) * 2,
        values=rng_.normal(size=(T, B, n_gamma)).astype(np.float32),
        action=rng_.randint(0, 9, (T, B)).astype(np.int32),
        old_pi=rng_.uniform(0.05, 0.5, (T, B)).astype(np.float32),
        old_value=rng_.normal(0, 0.2, (T, B, n_gamma)).astype(np.float32),
        returns=rng_.normal(size=(T, B, n_gamma)).astype(np.float32),
        advantages=rng_.normal(size=(T, B, n_gamma)).astype(np.float32),
        done=rng_.random_sample((T, B)) < 0.3)


class _JaxGiven:
    """A stand-in for the flax net: ``obs`` are flat row ids ``t * B + b``
    and its params are the rows' outputs."""

    @staticmethod
    def apply(params, obs, carry=None):
        out = params["logits"][obs], params["values"][obs]
        return out if carry is None else (carry, out)


class _Given(torch.nn.Module):
    """The port's stand-in: the same, feed-forward (``net(ids)``) and
    recurrent (``features``, ``cell``, ``heads``; the carry passes
    through)."""

    def __init__(self, logits, values):
        super().__init__()
        self.logits = torch.nn.Parameter(torch.as_tensor(logits).reshape(
            -1, logits.shape[-1]))
        self.values = torch.nn.Parameter(torch.as_tensor(values).reshape(
            -1, values.shape[-1]))

    def forward(self, ids):
        return self.logits[ids], self.values[ids]

    def features(self, ids):
        return ids.reshape(-1, 1).to(torch.float32)

    def cell(self, x, carry):
        return carry, x

    def heads(self, hidden):
        return self(hidden[..., 0].to(torch.int64))


# The loss options whose terms are not linear in the minibatch's means
# (the entropy clip with a gradient, the per-batch value rescaling); the
# others are held by tests/test_torch_training.py on unsharded batches.
_LOSS_OPTIONS = dict(value_grad_rescaling="per_batch", entropy_grad=True,
                     entropy_clip=0.6)


@pytest.mark.parametrize("recurrent", [False, True])
@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_minibatch_loss_matches_jax(shards, recurrent):
    """Minibatch 1 of the port's data-shard path against JAX's, through
    ``ppo_loss`` (or ``ppo_loss_recurrent``): loss and gradients."""
    options = _LOSS_OPTIONS
    local = B // shards
    mb = local // NM
    k = 1
    d = _batch()
    perm = _jax_perms(shards, local)
    ids = (np.arange(T)[:, None] * B + np.arange(B)[None]).astype(np.int32)
    jcfg = jppo.PPOConfig(data_shards=shards, num_minibatches=NM, **options)
    cfg = ppo.PPOConfig(data_shards=shards, num_minibatches=NM, **options)
    names = ("action", "old_pi", "old_value", "returns", "advantages")
    jparams = {"net": {"logits": jnp.asarray(d["logits"].reshape(T * B, 9)),
                       "values": jnp.asarray(d["values"].reshape(T * B, 1))},
               "spe": jnp.float32(0.7)}
    rows = ppo.minibatch_rows(torch.as_tensor(perm), k, mb)
    net = _Given(d["logits"], d["values"])
    spe = torch.nn.Parameter(torch.tensor(0.7))
    if recurrent:
        cut = lambda x: _jax_recurrent_minibatch(x, perm, k, mb)  # noqa: E731
        carry = np.zeros((B, 1), np.float32)
        jcarry = (jnp.asarray(carry[rows.numpy()]),) * 2
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(
            functools.partial(jppo.ppo_loss_recurrent, jcfg, _JaxGiven),
            has_aux=True))(jparams, cut(ids), cut(d["done"]), jcarry,
                           *(cut(d[n]) for n in names))
        tcarry = (torch.as_tensor(carry)[rows],) * 2
        loss, _ = ppo.ppo_loss_recurrent(
            cfg, net, spe, torch.as_tensor(ids)[:, rows],
            torch.as_tensor(d["done"])[:, rows], tcarry,
            *(torch.as_tensor(d[n])[:, rows] for n in names))
    else:
        cut = lambda x: _jax_minibatch(x, perm, k, mb)  # noqa: E731
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(
            functools.partial(jppo.ppo_loss, jcfg, _JaxGiven),
            has_aux=True))(jparams, cut(ids), *(cut(d[n]) for n in names))
        loss, _ = ppo.ppo_loss(cfg, net, spe, torch.as_tensor(ids)[:, rows],
                               *(torch.as_tensor(d[n])[:, rows]
                                 for n in names))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    for name in ("logits", "values"):
        np.testing.assert_allclose(
            getattr(net, name).grad.numpy(),
            np.asarray(jgrads["net"][name]), err_msg=name, **LOSS_TOL)
    np.testing.assert_allclose(spe.grad.item(), float(jgrads["spe"]),
                               **LOSS_TOL)


# ---------------------------------------------------------------------------
# Shards in one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env0", [0, 3, 7])
def test_spawn_words_at_an_offset_are_rows_of_the_whole_field(env0):
    seed = torch.tensor([12345], dtype=torch.int32)
    whole = rng.spawn_words(seed, (5, 6, 11), "cpu")
    part = rng.spawn_words(seed, (5, 6, 4), "cpu", env0=env0)
    assert torch.equal(part, whole[..., env0:env0 + 4])
    probs = torch.linspace(0, 1, 11)
    f24 = rng.spawn_field24(seed, probs, (5, 6, 11))
    fb, fg = rng.spawn_field_pair(seed, probs, (5, 6, 11))
    sl = slice(env0, env0 + 4)
    assert torch.equal(rng.spawn_field24(seed, probs[sl], (5, 6, 4), env0),
                       f24[..., sl])
    got = rng.spawn_field_pair(seed, probs[sl], (5, 6, 4), env0)
    assert torch.equal(got[0], fb[..., sl])
    assert torch.equal(got[1], fg[..., sl])


def _fields(state, ts=None):
    """Every tensor of the step's TimeStep (bar the pre-reset state) and
    of the wrapped state, by name."""
    out = {} if ts is None else {
        f"ts.{f.name}": getattr(ts, f.name)
        for f in dataclasses.fields(ts) if f.name != "state_before_reset"}
    while isinstance(state, TW.WrapperState):
        out.update({f"extra.{k}": v for k, v in state.extra.items()
                    if isinstance(v, torch.Tensor)})
        state = state.inner
    out.update({f"state.{f.name}": getattr(state, f.name)
                for f in dataclasses.fields(state)})
    return out


def _assert_rows(got, whole, r, n, what):
    """``got``'s tensors are rows [r * n, (r + 1) * n) of ``whole``'s along
    the batch axis (leading in a TimeStep, trailing in a state); of the
    scalars only the global step counter is compared (the episode
    counters are the shard's own)."""
    for name, v in whole.items():
        if v.dim() == 0:
            if name == "state.num_steps":
                assert torch.equal(got[name], v), (what, name)
            continue
        axis = 0 if name.startswith("ts.") else v.dim() - 1
        assert torch.equal(got[name], v.narrow(axis, r * n, n)), (what, name)


@pytest.mark.parametrize("bank_kind", ["spawnless", "spawners", "kernel"])
def test_shards_step_as_rows_of_the_whole_batch(bank_kind):
    """The training stack with ``shard=(r, 2)`` against the whole batch in
    one process, from the same generator seeds: the reset (and
    ``shard_env`` of the whole reset), the fresh levels, and 12 steps
    with resets (plain spawn draws, or the kernels' Philox fields at the
    shard's offset), bit for bit per shard."""
    cfg = driver.TrainerConfig(view_shape=(9, 9), time_limit=4,
                               impact_penalty=0.5)
    bank = synth.synth_bank(4, h=13, w=13, device="cpu",
                            spawners=bank_kind != "spawnless")
    whole_batch = 12
    actions = torch.as_tensor(np.random.RandomState(0).randint(
        0, 9, (12, whole_batch)))
    runs = []
    for shard in ((0, 1), (0, 2), (1, 2)):
        env = driver.make_training_env(cfg, "cpu", shard=shard)
        core = TW.unwrap_env(env)
        batch = whole_batch // shard[1]
        first = shard[0] * batch
        gen = torch.Generator().manual_seed(3)
        state = env.reset_all(bank, batch, gen)
        fresh = core.sample_fresh_levels(bank, batch, gen)
        steps, s = [], state
        for t in range(12):
            kw = {}
            if bank_kind == "kernel":
                kw = dict(zip(("spawn_board", "spawn_goals"),
                              core.kernel_spawn_fields(
                                  TW.unwrap(s), bank, core.step_seed(gen))))
            s, ts = env.step(s, bank, actions[t, first:first + batch], gen,
                             fresh_levels=fresh, **kw)
            steps.append(_fields(s, ts))
        runs.append((state, fresh, steps))
    whole, wfresh, wsteps = runs[0]
    assert any(bool(f["ts.done"].any()) for f in wsteps)  # resets
    n = whole_batch // 2
    for r, (state, fresh, steps) in enumerate(runs[1:]):
        _assert_rows(_fields(state), _fields(whole), r, n, "reset")
        _assert_rows(_fields(pmesh.shard_env(_mesh(r, 2), whole)),
                     _fields(whole), r, n, "shard_env")
        assert torch.equal(fresh[0], wfresh[0][r * n:(r + 1) * n])
        for t, (got, full) in enumerate(zip(steps, wsteps)):
            _assert_rows(got, full, r, n, f"step {t}")


def test_sample_actions_shard_draws_its_rows():
    logits = torch.randn(12, 9, generator=torch.Generator().manual_seed(0))
    whole = ppo.sample_actions(logits, torch.Generator().manual_seed(5))
    for r in range(3):
        part = ppo.sample_actions(logits[r * 4:(r + 1) * 4],
                                  torch.Generator().manual_seed(5), (r, 3))
        assert torch.equal(part, whole[r * 4:(r + 1) * 4])


def test_one_process_and_a_rank_take_the_same_minibatches():
    """``data_shards=2`` in one process takes each minibatch from both
    shards' permutations, shard-major; rank 1 of two draws the same
    permutations, takes its shard's half of each minibatch, and its
    generator ends in step with the one process's."""
    tr = driver.Trainer(*torch_ranks.trainer_configs(), bank=synth.synth_bank(
        4, h=13, w=13, device="cpu"), device="cpu")
    params = tr.train_state.optimizer.params

    def epochs(learner, batch):
        taken, gen = [], torch.Generator().manual_seed(1)
        learner._epochs(tr.train_state, batch, lambda idx: (
            taken.append(idx) or (sum(p.sum() * 0 for p in params), {})),
            gen)
        return taken, gen.get_state()

    taken, state = epochs(tr.ppo, 16)
    assert len(taken) == 4 and all(len(i) == 8 for i in taken)
    for epoch in (taken[:2], taken[2:]):
        assert sorted(torch.cat(epoch).tolist()) == list(range(16))
        for idx in epoch:  # four of each shard, shard-major
            assert (idx[:4] < 8).all() and (idx[4:] >= 8).all()
    mesh = _mesh(1, 2)
    mesh.average_gradients = lambda params: None  # no group: the steps alone
    rank_taken, rank_state = epochs(ppo.PPO(tr.ppo_cfg, tr.env, mesh=mesh), 8)
    assert torch.equal(rank_state, state)
    for got, want in zip(rank_taken, taken):
        assert torch.equal(got + 8, want[4:])


def test_mesh_of_one_process_and_initialize(monkeypatch):
    mesh = pmesh.make_mesh(device="cpu")
    assert (mesh.rank, mesh.world_size, mesh.group) == (0, 1, None)
    assert mesh.shape == {"data": 1, "model": 1}
    x = torch.arange(4.0)
    assert mesh.all_reduce(x) is x and mesh.all_gather(x) is x
    assert mesh.broadcast_object({"a": 1}) == {"a": 1}
    assert not mesh.collective_bytes
    with pytest.raises(ValueError):
        pmesh.make_mesh(n_data=2, device="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        _mesh(0, 2).all_reduce(x)
    for k in ("SAFELIFE_COORDINATOR", "SAFELIFE_NUM_PROCS",
              "SAFELIFE_PROC_ID"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False
    # Without a card and without a device, nothing falls back to the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed.initialize("127.0.0.1:1", 1, 0)
    with pytest.raises(ValueError, match="divide"):
        driver.Trainer(driver.TrainerConfig(num_envs=5), mesh=_mesh(1, 2),
                       device="cpu")


def test_layout_tables():
    bank = synth.synth_bank(2, h=13, w=13, device="cpu")
    state = BatchedSafeLifeEnv(EnvConfig(), device="cpu").reset_all(bank, 4)
    specs = pmesh.env_state_shardings(state)
    assert specs["board"] == 2 and specs["agent_row"] == 0
    assert specs["exit_row"] == 1 and specs["num_steps"] is None
    assert set(pmesh.bank_shardings(_mesh(), bank).values()) == {None}
    obs = torch.zeros(4, 3, 3, 2)
    part = pmesh.shard_batch_leading(_mesh(1, 2), {"obs": obs, "c": (obs,)})
    assert part["obs"].shape == (2, 3, 3, 2) and part["c"][0].shape[0] == 2


# ---------------------------------------------------------------------------
# Two gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return torch_ranks.run_ranks("train", tmp_path_factory.mktemp("ranks"))


def test_two_rank_trainer_keeps_parameters_equal(ranks):
    r0, r1 = ranks
    assert r0["world"] == r1["world"] == 2
    assert r0["params"].keys() == r1["params"].keys()
    for k, v in r0["params"].items():
        assert torch.equal(v, r1["params"][k]), k
    assert torch.equal(r0["spe"], r1["spe"])
    for k, v in r0["recurrent_params"].items():  # the recurrent trainer's
        assert torch.equal(v, r1["recurrent_params"][k]), k
    assert r0["recurrent_carry"] == (torch_ranks.TRAIN_ENVS // 2, 512)
    # Boards sharded: 8 of the 16 environments a rank; the step is global.
    steps = torch_ranks.TRAIN_BATCHES * torch_ranks.TRAIN_ENVS * 4
    for r in ranks:
        assert r["board_shape"] == (13, 13, torch_ranks.TRAIN_ENVS // 2)
        assert r["global_step"] == steps
        assert [s for s, _ in r["reports"]] == [64, 128]
    # The gathered reports: the same global numbers on both ranks.
    for (s0, m0), (s1, m1) in zip(r0["reports"], r1["reports"]):
        for k in m0:
            np.testing.assert_array_equal(m0[k], m1[k], err_msg=k)


def test_two_rank_trainer_matches_one_process(ranks):
    """The ranks' levels are the halves of the one-process ``data_shards=2``
    run's, and the parameters agree with its parameters within atol 1e-5
    (the same minibatches; the float32 gradient is summed in another
    order)."""
    tc, pc = torch_ranks.trainer_configs()
    tr = driver.Trainer(tc, pc, bank=synth.synth_bank(4, h=13, w=13,
                                                      device="cpu"),
                        net=torch_ranks.trainer_net(), device="cpu")
    level0 = TW.unwrap(tr.env_state).level_idx
    assert torch.equal(torch.cat([r["level0"] for r in ranks]), level0)
    assert not torch.equal(ranks[0]["level0"], ranks[1]["level0"])
    tr.train(total_steps=torch_ranks.TRAIN_BATCHES
             * torch_ranks.TRAIN_ENVS * pc.steps_per_env)
    for k, v in tr.net.state_dict().items():
        np.testing.assert_allclose(ranks[0]["params"][k].numpy(), v.numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_two_rank_checkpoint_restores_on_every_rank(ranks):
    """Rank 0 wrote the checkpoints and the evaluations (4 levels at steps
    64 and 128), each behind a barrier; both ranks restore."""
    for r in ranks:
        assert r["checkpoints"] == ["128.pt", "64.pt"]
        assert r["eval_records"] == 2 * 4
        assert r["restored"] and r["restored_step"] == 128
        for k, v in r["params"].items():
            assert torch.equal(r["restored_params"][k], v), k


def test_two_rank_bank_switch_and_refresh(ranks):
    """The schedule's switch after batch 1 and the refresh made on rank 0's
    thread after batch 2 and swapped in at batch 3's report: the ranks'
    factories draw different levels, yet both ranks hold rank 0's first
    and then its second bank, bit for bit, with parameters bit-equal and
    the global step global."""
    make = torch_ranks.curriculum_factory(0)
    first, second = make().to_numpy(), make().to_numpy()
    other = torch_ranks.curriculum_factory(1)().to_numpy()
    assert not np.array_equal(first["board"], other["board"])
    assert not np.array_equal(first["board"], second["board"])
    stages = [r["curriculum"] for r in ranks]
    for k, want in enumerate((None, first, second)):
        s0, s1 = stages[0][k], stages[1][k]
        assert s0["step"] == s1["step"] == (k + 1) * torch_ranks.TRAIN_ENVS * 4
        assert (s0["refreshing"], s1["refreshing"]) == (k == 1, False)
        for name, v in s0["bank"].items():
            np.testing.assert_array_equal(s1["bank"][name], v, err_msg=name)
            if want is not None:
                np.testing.assert_array_equal(v, want[name], err_msg=name)
        for name, v in s0["params"].items():
            assert torch.equal(v, s1["params"][name]), (k, name)
    assert not np.array_equal(stages[0][0]["bank"]["board"], first["board"])


@pytest.mark.parametrize("spawners", [False, True])
def test_two_rank_rollouts_are_shards_of_one_process(ranks, spawners):
    tc, _ = torch_ranks.trainer_configs()
    whole = torch_ranks.rollout_case(spawners, driver.make_training_env(
        tc, "cpu"))
    assert whole["done"].any()
    if spawners:  # spawns fired somewhere along the way
        assert not torch.equal(whole["obs"][0], whole["obs"][-1])
    for r, got in enumerate(r["rollout." + str(spawners)] for r in ranks):
        for name, v in whole.items():
            axis = 0 if name in ("level0", "final_obs") else 1
            want = v.narrow(axis, 8 * r, 8)
            if name in ("old_pi", "value"):
                np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                           err_msg=name, **NET_TOL)
            else:
                assert torch.equal(got[name], want), (r, name)
    assert not torch.equal(ranks[0][f"rollout.{spawners}"]["obs"],
                           ranks[1][f"rollout.{spawners}"]["obs"])


@pytest.mark.parametrize("case", list(torch_ranks.MEAN_CASES))
def test_global_mean_terms_give_the_one_process_gradient(ranks, case):
    """Rank 0's peaked rows and rank 1's flat rows straddle the entropy
    clip (or scale the value loss per batch): the ranks' averaged
    gradients equal the one-process gradient of the whole minibatch within
    LOSS_TOL, and the ranks' own means would not have."""
    _, _, _, perms = torch_ranks.mean_case_data()
    rows = ppo.minibatch_rows(torch.as_tensor(perms), 0,
                              torch_ranks.MEAN_B // 2 // torch_ranks.MEAN_MB)
    loss, want = torch_ranks.mean_case_grads(case, rows, None)
    got = ranks[0][f"mean.{case}"]
    for g0, g1 in zip(got[1], ranks[1][f"mean.{case}"][1]):
        assert torch.equal(g0, g1)
    np.testing.assert_allclose(got[0].item(), loss.item(), **LOSS_TOL)
    for g, w in zip(got[1], want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **LOSS_TOL)
    naive = [(a + b) / 2 for a, b in zip(ranks[0][f"naive.{case}"][1],
                                         ranks[1][f"naive.{case}"][1])]
    assert any(not np.allclose(n.numpy(), w.numpy(), **LOSS_TOL)
               for n, w in zip(naive, want))


def test_two_rank_halo_exchange(ranks):
    """advance_board_sharded on the two ranks (``tests/test_halo.py``'s
    cases) against the JAX package's CA on the whole board, bit for bit;
    two uint16 rows received a step (one step of the 32-wide soup, four of
    the 16-wide blinkers)."""
    from test_torch_halo import jax_advance
    board, spawn = torch_ranks.halo_soup()
    blinkers = torch_ranks.blinkers()
    for r in ranks:
        np.testing.assert_array_equal(r["halo"]["soup"].numpy(),
                                      jax_advance(board, spawn))
        np.testing.assert_array_equal(
            r["halo"]["blinkers"].numpy(),
            jax_advance(blinkers, torch.zeros_like(blinkers, dtype=bool), 4))
        assert r["halo"]["bytes"]["collective-permute"] == 2 * 64 + 4 * 2 * 32


def test_two_rank_collective_stats(ranks):
    one = torch_ranks.update_stats(pmesh.make_mesh(device="cpu"),
                                   torch_ranks.TRAIN_ENVS)
    assert one["collective_bytes"] == {}  # one process, no group
    for r in ranks:
        stats = r["stats"]
        assert stats["flops"] == pytest.approx(one["flops"], rel=0.10)
        param_bytes = 4 * r["n_params"]
        ar = stats["collective_bytes"].get("all-reduce", 0)
        assert param_bytes <= ar <= 1.5 * param_bytes
        other = sum(v for k, v in stats["collective_bytes"].items()
                    if k != "all-reduce")
        assert other < 100_000
        assert stats["bytes_accessed"] is None


# ---------------------------------------------------------------------------
# The efficiency model, the scaling harness, the profiler
# ---------------------------------------------------------------------------

def test_dp_efficiency_model_by_hand():
    assert distributed.dp_efficiency_model(1, 1e12, 1e9) == 1.0
    # t_c = 1e12 / (1e14 * 0.5) = 0.02 s; t_comm = 2 * 1/2 * 1e9 / 1e10
    # = 0.1 s.
    assert distributed.dp_efficiency_model(
        2, 1e12, 1e9, peak_flops=1e14, link_bw=1e10, util=0.5) == \
        pytest.approx(0.02 / 0.12)
    # The H100 defaults: t_c = 989e12 * 0.4 / (989e12 * 0.4) = 1 s and
    # t_comm = 2 * 7/8 * (4.5e11 * 8 / 14) / 4.5e11 = 1 s.
    assert distributed.dp_efficiency_model(
        8, 989e12 * 0.4, 4.5e11 * 8 / 14) == pytest.approx(0.5)


def test_scaling_report_harness():
    rep = distributed.scaling_report(
        lambda x: (x * 2 + 1).sum(), [1, 2],
        make_args=lambda n: (torch.ones((n, 64)),), repeats=2)
    assert [r["devices"] for r in rep] == [1, 2]
    assert all(r["time"] > 0 and "efficiency" in r for r in rep)
    assert rep[0]["efficiency"] == 1.0


def test_phase_timer_and_trace(tmp_path):
    timer = profiling.PhaseTimer()
    with profiling.trace(str(tmp_path)) as prof:
        for _ in range(2):
            with timer.phase("matmul", block=True) as out:
                out.append(torch.ones(64, 64) @ torch.ones(64, 64))
        with timer.phase("sum", result=torch.ones(8).sum(), block=True):
            pass
    summary = timer.summary()
    assert list(summary) == ["matmul", "sum"]
    assert summary["matmul"]["count"] == 2 and summary["sum"]["count"] == 1
    assert all(v["total_s"] >= 0 for v in summary.values())
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1
    with open(tmp_path / traces[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in prof.key_averages())
