"""The port's PPO learner against the JAX learner on the CPU: GAE, the loss
and its gradients under every loss option, clipped Adam updates, the
training slice as a whole (a JAX rollout replayed through the port's
wrapped env and net, then GAE, one minibatch's gradients and an Adam
step), the action sampler, and a tiny ``Trainer`` run end to end.

Tolerances (float32 on both sides; the two sides sum in other orders):
GAE rtol 1e-6; loss and gradients rtol 1e-4, atol 1e-6; parameters after
Adam steps atol 1e-6; logits, values and pi_old of the rollout rtol 1e-5,
atol 1e-6.  The environment's side of the rollout is bit for bit.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from safelife_torch.env import wrappers as TW
from safelife_torch.levels import loader as tloader
from safelife_torch.levels import synth as tsynth
from safelife_torch.training import driver as tdriver
from safelife_torch.training import model as tmodel
from safelife_torch.training import ppo as tppo
from safelife_tpu.env import wrappers as JW
from safelife_tpu.env.env import BatchedSafeLifeEnv as JaxEnv
from safelife_tpu.env.env import EnvConfig as JaxConfig
from safelife_tpu.levels import loader as jloader
from safelife_tpu.training import model as jmodel
from safelife_tpu.training import ppo as jppo

torch.set_num_threads(1)

T, B = 4, 8
VIEW = (17, 17)
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)


def _cfgs(n_gamma, **kw):
    """The same PPOConfig for both packages."""
    if n_gamma == 2:
        kw = dict(gamma=(0.97, 0.8), policy_discount_weights=(1.0, 0.5),
                  value_discount_weights=(1.0, 2.0), **kw)
    return jppo.PPOConfig(**kw), tppo.PPOConfig(**kw)


def _net_pair(n_gamma, view=VIEW):
    """A float32 flax net and its port with the same weights."""
    jnet = jmodel.SafeLifeCNN(n_gamma=n_gamma, compute_dtype=jnp.float32)
    params = jax.device_get(jax.jit(jnet.init)(
        jax.random.PRNGKey(5), jnp.zeros((1, *view, 15), jnp.uint8)))
    net = tmodel.SafeLifeCNN(view_shape=view, n_gamma=n_gamma,
                             compute_dtype=torch.float32)
    net.load_state_dict(tmodel.params_from_flax(net, params))
    return jnet, params, net


def _t(x):
    return torch.as_tensor(np.array(x))


def _jax_loss_and_grads(jcfg, jnet, jparams, *batch):
    """JAX's ((loss, metrics), grads) of ppo_loss, jitted (one compile
    instead of one per op)."""
    return jax.device_get(jax.jit(jax.value_and_grad(
        lambda p, *b: jppo.ppo_loss(jcfg, jnet, p, *b), has_aux=True))(
            jparams, *batch))


def _jax_adam_step(tx, grads, opt_state, params):
    """optax's update and apply, jitted; returns (params, opt_state)."""
    @jax.jit
    def step(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state
    return step(grads, opt_state, params)


def _assert_grads(net, spe, jgrads, **tol):
    """The port's gradients against JAX's, every parameter and spe."""
    want = tmodel.params_from_flax(net, jgrads["net"])
    got = dict(net.named_parameters())
    assert want.keys() == got.keys()
    for name, g in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(),
                                   err_msg=name, **tol)
    np.testing.assert_allclose(spe.grad.numpy(), np.asarray(jgrads["spe"]),
                               err_msg="spe", **tol)


# ---------------------------------------------------------------------------
# GAE, the loss, Adam
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_gamma", [1, 2])
def test_compute_gae_matches_jax(n_gamma):
    jcfg, cfg = _cfgs(n_gamma, reward_clip=2.0)
    rng = np.random.RandomState(n_gamma)
    reward = rng.normal(0, 2, (T, B)).astype(np.float32)  # some clipped
    done = rng.random_sample((T, B)) < 0.3
    value = rng.normal(size=(T + 1, B, n_gamma)).astype(np.float32)
    want = jax.device_get(jppo.compute_gae(jcfg, reward, done, value))
    got = tppo.compute_gae(cfg, _t(reward), _t(done), _t(value))
    for g, w, name in zip(got, want, ("returns", "advantages")):
        assert g.shape == (T, B, n_gamma)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-7,
                                   err_msg=name)


class _Given:
    """A stand-in for the flax net in ``jppo.ppo_loss``: its params are
    its outputs (logits, values), so the loss's gradient reaches them."""

    @staticmethod
    def apply(outputs, obs):
        return outputs


@functools.lru_cache(maxsize=None)
def _loss_case(n_gamma):
    """Flax params, a batch (obs, action, old_pi, old_value, returns,
    advantages) and the flax net's outputs on it with their VJP: the 16
    loss options' cases share one forward and backward of the net."""
    jnet, params, _ = _net_pair(n_gamma)
    rng = np.random.RandomState(n_gamma)
    batch = ((rng.random_sample((T, B, *VIEW, 15)) < 0.2).astype(np.uint8),
             rng.randint(0, 9, (T, B)).astype(np.int32),
             # pi/pi_old from 0.2 to 2: both sides of the clip.
             rng.uniform(0.05, 0.5, (T, B)).astype(np.float32),
             rng.normal(0, 0.2, (T, B, n_gamma)).astype(np.float32),
             rng.normal(size=(T, B, n_gamma)).astype(np.float32),
             rng.normal(size=(T, B, n_gamma)).astype(np.float32))
    outputs, vjp = jax.vjp(lambda p: jnet.apply(p, batch[0]), params)
    return params, batch, outputs, jax.jit(vjp)


@pytest.mark.parametrize("entropy_grad", [False, True])
@pytest.mark.parametrize("rectifier", ["relu", "elu"])
@pytest.mark.parametrize("rescaling",
                         [False, "smooth", "per_batch", "per_state"])
def test_ppo_loss_and_gradients_match_jax(rescaling, rectifier,
                                          entropy_grad):
    """``jppo.ppo_loss`` itself, its gradient reaching the net's params by
    the chain rule through the net's VJP."""
    n_gamma = 2 if entropy_grad else 1
    jcfg, cfg = _cfgs(n_gamma, value_grad_rescaling=rescaling,
                      policy_rectifier=rectifier, entropy_grad=entropy_grad,
                      rescale_policy_eps=rectifier == "relu")
    params, batch, outputs, vjp = _loss_case(n_gamma)
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        jppo.ppo_loss, argnums=2, has_aux=True)(
            jcfg, _Given, {"net": outputs, "spe": jnp.float32(0.7)}, *batch)
    jgrads = jax.device_get({"net": vjp(jgrads["net"])[0],
                             "spe": jgrads["spe"]})
    net = tmodel.SafeLifeCNN(view_shape=VIEW, n_gamma=n_gamma,
                             compute_dtype=torch.float32)
    net.load_state_dict(tmodel.params_from_flax(net, params))
    spe = torch.nn.Parameter(torch.tensor(0.7))
    loss, metrics = tppo.ppo_loss(cfg, net, spe, *map(_t, batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    assert metrics.keys() == jmetrics.keys()
    for k, v in metrics.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jmetrics[k]),
                                   err_msg=k, **LOSS_TOL)
    _assert_grads(net, spe, jgrads, **LOSS_TOL)


@pytest.mark.parametrize("lr_decay_steps", [0, 2])
def test_clipped_adam_matches_optax(lr_decay_steps):
    """Three updates on the same gradients: the first below the clip, the
    second far above it, the third below."""
    jcfg, cfg = _cfgs(1, learning_rate=1e-2, lr_decay_steps=lr_decay_steps,
                      lr_final_frac=0.25)
    rng = np.random.RandomState(3)
    shapes = {"w": (5, 4), "b": (4,), "spe": ()}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    tx = jppo.make_optimizer(jcfg)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    opt = tppo.make_optimizer(cfg, tparams.values())
    norms = []
    for scale in (0.05, 20.0, 0.1):
        grads = {k: (scale * rng.normal(size=s)).astype(np.float32)
                 for k, s in shapes.items()}
        norms.append(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                 for g in grads.values())))
        jparams, opt_state = _jax_adam_step(
            tx, jax.tree.map(jnp.asarray, grads), opt_state, jparams)
        for k, p in tparams.items():
            p.grad = _t(grads[k]).clone()
        opt.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[k]), rtol=0,
                                       atol=1e-6, err_msg=f"{scale}: {k}")
    assert norms[0] < cfg.max_gradient_norm < norms[1]
    assert opt.count == 3
    assert opt.lr(0) == cfg.learning_rate
    assert opt.lr(5) == pytest.approx(
        cfg.learning_rate * (cfg.lr_final_frac if lr_decay_steps else 1))


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------

def _core(env):
    while hasattr(env, "env"):
        env = env.env
    return env


def _training_stack(W, env):
    env = W.MovementBonusWrapper(env, movement_bonus=0.1)
    env = W.SideEffectPenaltyWrapper(env, penalty_coef=0.5,
                                     min_performance=0.01)
    return W.ContinuingWrapper(env)


def test_training_slice_matches_jax():
    """A JAX rollout (plain env, float32 net) on append-still, its actions
    and fresh levels replayed through the port; then GAE, one minibatch's
    loss and gradients, and the Adam step on them."""
    suite, view, time_limit = "benchmarks/v1.0/append-still", (33, 33), 3
    jcfg, cfg = _cfgs(1, steps_per_env=T, num_minibatches=2)
    jbank = jloader.load_bank(suite)
    bank = tloader.load_bank(suite, device="cpu")
    jenv = _training_stack(JW, JaxEnv(JaxConfig(
        view_shape=view, time_limit=time_limit, use_pallas=False)))
    env = tdriver.make_training_env(tdriver.TrainerConfig(
        view_shape=view, time_limit=time_limit, impact_penalty=0.5),
        device="cpu")
    jnet, params, net = _net_pair(1, view)
    start = np.random.RandomState(4).randint(0, bank.num_levels, B)
    jstate = jenv.reset_to_levels(jbank, jnp.asarray(start))
    state = env.reset_to_levels(bank, start)

    key = jax.random.PRNGKey(11)
    jparams = {"net": params, "spe": jnp.float32(1.0)}
    jstate1, jobs1, jtraj, jeps = jax.device_get(jppo.rollout(
        jcfg, jnet, jenv, jbank, jparams, jstate, jenv.observe(jstate), key))
    # The rollout's fresh levels, drawn as jppo.rollout draws them.
    fresh_idx = np.array(_core(jenv).sample_fresh_levels(
        jbank, B, jax.random.split(key)[1])[0])
    state1, obs1, traj, eps = tppo.rollout(
        cfg, net, env, bank, state, env.observe(state),
        actions=_t(jtraj.action),
        fresh=_core(env).fresh_levels(bank, fresh_idx))

    # The environment's side, bit for bit.
    np.testing.assert_array_equal(traj.action.numpy(), jtraj.action)
    for name in ("obs", "reward", "done"):
        np.testing.assert_array_equal(getattr(traj, name).numpy(),
                                      getattr(jtraj, name), err_msg=name)
    np.testing.assert_array_equal(obs1.numpy(), jobs1)
    assert eps.keys() == jeps.keys()
    for name in eps:
        np.testing.assert_array_equal(eps[name].numpy(), jeps[name],
                                      err_msg=name)
    assert jtraj.done.any() and jeps["done"].any()  # resets on the way
    # The net's side.
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(traj.old_pi.numpy(), jtraj.old_pi, **tol)
    np.testing.assert_allclose(traj.value.numpy(), jtraj.value, **tol)
    with torch.no_grad():
        logits, _ = net(traj.obs)
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(jax.jit(jnet.apply)(params, jtraj.obs)[0]),
        **tol)

    # GAE, then one minibatch of half the environments.
    jret, jadv = jax.device_get(jppo.compute_gae(
        jcfg, jtraj.reward, jtraj.done, jtraj.value))
    ret, adv = tppo.compute_gae(cfg, traj.reward, traj.done, traj.value)
    np.testing.assert_allclose(ret.numpy(), jret, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(adv.numpy(), jadv, rtol=1e-5, atol=1e-6)
    idx = np.random.RandomState(2).permutation(B)[:B // 2]
    jmb = [x[:, idx] for x in (jtraj.obs, jtraj.action, jtraj.old_pi,
                               jtraj.value[:-1], jret, jadv)]
    (jloss, _), jgrads = _jax_loss_and_grads(jcfg, jnet, jparams, *jmb)
    ts = tppo.init_train_state(cfg, net)
    mb = [x[:, torch.as_tensor(idx)] for x in (
        traj.obs, traj.action, traj.old_pi, traj.value[:-1], ret, adv)]
    loss, _ = tppo.ppo_loss(cfg, net, ts.spe, *mb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    _assert_grads(net, ts.spe, jgrads, **LOSS_TOL)

    tx = jppo.make_optimizer(jcfg)
    jparams, _ = jax.device_get(_jax_adam_step(tx, jgrads, tx.init(jparams),
                                               jparams))
    ts.optimizer.step()
    want = tmodel.params_from_flax(net, jparams["net"])
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(ts.spe.item(), float(jparams["spe"]),
                               rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# The sampler and the trainer
# ---------------------------------------------------------------------------

def test_sample_actions_follows_softmax():
    logits = torch.tensor([0.0, 1.0, -1.0, 2.0, 0.5, -3.0, 0.0, 1.5, -0.5])
    n = 40_000
    draw = lambda seed: tppo.sample_actions(  # noqa: E731
        logits.expand(n, -1), torch.Generator().manual_seed(seed))
    actions = draw(0)
    assert actions.shape == (n,) and actions.dtype == torch.int64
    p = torch.softmax(logits, 0).double().numpy()
    counts = np.bincount(actions.numpy(), minlength=9)
    sigma = np.sqrt(n * p * (1 - p))
    assert np.all(np.abs(counts - n * p) <= 5 * sigma), (counts, n * p)
    assert torch.equal(draw(0), actions)
    assert not torch.equal(draw(1), actions)


def _tiny_trainer(logdir=None, **kw):
    bank = tsynth.synth_bank(4, h=13, w=13, device="cpu")
    tc = tdriver.TrainerConfig(
        num_envs=8, total_steps=64, report_every=32, save_every=32,
        view_shape=VIEW, time_limit=5, logdir=logdir, record_videos=False,
        **kw)
    pc = tppo.PPOConfig(steps_per_env=4, num_minibatches=2,
                        epochs_per_batch=2)
    return tdriver.Trainer(tc, pc, bank=bank, device="cpu")


def test_tiny_trainer_trains_logs_and_round_trips(tmp_path):
    tr = _tiny_trainer(str(tmp_path))
    before = {k: v.clone() for k, v in tr.net.state_dict().items()}
    seen = []
    tr.train(progress_fn=lambda step, m: seen.append((step, m)))
    assert tr.global_step() == 64 and tr.train_state.update_step == 2
    assert [s for s, _ in seen] == [32, 64]
    for _, m in seen:
        for k, v in m.items():
            assert np.all(np.isfinite(v)), k
    after = tr.net.state_dict()
    assert any(not torch.equal(before[k], after[k]) for k in after)
    assert tr.train_state.spe.item() != 1.0
    assert all(torch.isfinite(v).all() for v in after.values())
    # Logs: episode records, scalars, the run config.
    assert tr.episode_logger.num_episodes > 0
    text = (tmp_path / "training.yaml").read_text()
    assert text.startswith("- {name: ") and "side_effects: " in text
    assert any(f.startswith("events.out") or f == "scalars.jsonl"
               for f in os.listdir(tmp_path))
    assert json.loads((tmp_path / "config.json").read_text())[
        "view_shape"] == list(VIEW)
    assert not (tmp_path / "active_job.txt").exists()
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["32.pt", "64.pt"]

    # A fresh trainer restores the weights, spe, optimizer and counters.
    tr2 = _tiny_trainer(str(tmp_path))
    assert tr2.restore_checkpoint()
    assert tr2.global_step() == 64 and tr2.train_state.update_step == 2
    for k, v in tr.net.state_dict().items():
        assert torch.equal(tr2.net.state_dict()[k], v), k
    assert tr2.train_state.spe.item() == tr.train_state.spe.item()
    assert tr2.train_state.optimizer.count == 8
    tr2.train(total_steps=96)
    assert tr2.global_step() == 96
    assert sorted(os.listdir(tmp_path / "checkpoints")) == [
        "32.pt", "64.pt", "96.pt"]

    own = tr2.policy_fn()(tr2.obs, torch.Generator().manual_seed(0))
    policy, view = tdriver.load_policy(str(tmp_path), device="cpu")
    assert view == VIEW
    actions = policy(tr2.obs, torch.Generator().manual_seed(0))
    assert actions.shape == (8,) and int(actions.max()) < 9
    assert torch.equal(actions, own)  # the same weights, the same draw
    for k, v in tr2.net.state_dict().items():
        assert torch.equal(policy.net.state_dict()[k], v), k


def test_tiny_trainer_switches_and_refreshes_banks():
    """A curriculum step swaps the bank and resets every env, keeping the
    global step; endless levels then regenerate the bank from the same
    factory on a thread and swap it in between batches."""
    made = []

    def factory():
        made.append(tsynth.synth_bank(3, h=13, w=13, device="cpu"))
        return made[-1]

    tr = _tiny_trainer(fresh_levels_every=32)
    tr.bank_schedule = [(32, factory)]
    tr.train(total_steps=64)
    assert tr.global_step() == 64 and not tr.bank_schedule
    assert tr.bank is made[0]  # switched after the first batch
    thread, _ = tr._refresher  # started after the second
    thread.join(timeout=60)
    assert not thread.is_alive()
    tr._maybe_refresh_bank(64)
    assert len(made) == 2 and tr.bank is made[1] and tr._refresher is None


@pytest.mark.parametrize("kw,item", [
    (dict(eval_suite="append-still"), None),
    (dict(record_videos=True, logdir="{tmp}", time_limit=12), None),
    (dict(recurrent=True), None),
])
def test_trainer_refuses_unported_options(tmp_path, kw, item):
    """Frozen-suite evaluation, episode videos and the recurrent policy,
    each once refused here as unported, are taken: the Trainer is built,
    and with ``record_videos`` and a logdir it records an episode."""
    bank = tsynth.synth_bank(2, h=13, w=13, device="cpu")
    kw = {k: str(tmp_path) if v == "{tmp}" else v for k, v in kw.items()}
    cfg = tdriver.TrainerConfig(num_envs=8, view_shape=VIEW,
                                **{"record_videos": False, **kw})
    if item is None:
        trainer = tdriver.Trainer(cfg, bank=bank, device="cpu")
        assert (trainer.carry is not None) == cfg.recurrent
        if cfg.record_videos:
            trainer.writer.close()  # leave no event-file thread behind
            trainer.maybe_record_video()
            assert sorted(f for f in os.listdir(tmp_path)
                          if f.startswith("episode-")) == [
                "episode-0.gif", "episode-0.npz"]
        return
    with pytest.raises(NotImplementedError, match=item):
        tdriver.Trainer(cfg, bank=bank, device="cpu")


@pytest.mark.parametrize("shards,num_minibatches,error,recurrent", [
    (2, 2, None, False), (2, 2, None, True), (3, 2, "data shards", False),
    (2, 3, "minibatches", False)])
def test_data_shards_train_in_one_process(shards, num_minibatches, error,
                                          recurrent):
    """``data_shards`` trains in one process, feed-forward and recurrent
    (the shards' minibatches, see tests/test_torch_parallel.py); a batch
    that does not divide into the shards, or a shard that does not divide
    into the minibatches, raises."""
    tc = tdriver.TrainerConfig(num_envs=8, view_shape=VIEW, time_limit=5,
                               report_every=32, record_videos=False,
                               recurrent=recurrent)
    pc = tppo.PPOConfig(steps_per_env=4, num_minibatches=num_minibatches,
                        epochs_per_batch=2, data_shards=shards)
    tr = tdriver.Trainer(tc, pc, device="cpu",
                         bank=tsynth.synth_bank(2, h=13, w=13, device="cpu"))
    before = {k: v.clone() for k, v in tr.net.named_parameters()
              if v.requires_grad}
    if error:
        with pytest.raises(ValueError, match=error):
            tr.train(total_steps=32)
        return
    seen = []
    tr.train(total_steps=64, progress_fn=lambda s, m: seen.append(m))
    assert tr.global_step() == 64 and tr.train_state.update_step == 2
    assert tr.train_state.optimizer.count == 2 * 2 * num_minibatches
    for m in seen:
        for k, v in m.items():
            assert np.all(np.isfinite(v)), k
    after = dict(tr.net.named_parameters())
    assert all(not torch.equal(v, after[k]) for k, v in before.items())
