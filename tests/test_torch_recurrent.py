"""The port's recurrent policy and learner against the JAX package on the
CPU: the plain LSTM step against ``nn.LSTMCell``, ``SafeLifeLSTMNet`` with
flax weights carried across by ``params_from_flax``, the recurrent PPO
loss and its gradients against JAX's ``value_and_grad``, and one
``RecurrentPPO.train_batch`` on a synthetic bank.

Tolerances: the LSTM step against ``nn.LSTMCell`` rtol 1e-5, atol 1e-6
(the same float32 sums in other orders); the net in float32 (logits,
values and carry) rtol 1e-5, atol 1e-5; its bfloat16 trunk rtol 3e-2,
atol 2e-2 (8 significant bits, rounded at other points on the two sides);
the loss, its metrics and gradients rtol 1e-4, atol 1e-6, as for the
feed-forward loss.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safelife_torch.env.env import BatchedSafeLifeEnv, EnvConfig
from safelife_torch.levels import synth as tsynth
from safelife_torch.training import model as tmodel
from safelife_torch.training import ppo as tppo
from safelife_tpu.training import model as jmodel
from safelife_tpu.training import ppo as jppo

torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=3e-2, atol=2e-2)
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)


def _obs(view, batch, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.random_sample((*batch, *view, 15)) < 0.2).astype(np.uint8)


def _carry(batch, seed=1):
    rng = np.random.RandomState(seed)
    return tuple(rng.normal(0, 0.5, (batch, 512)).astype(np.float32)
                 for _ in range(2))


@functools.lru_cache(maxsize=None)
def _flax_params(view, n_gamma):
    jnet = jmodel.SafeLifeLSTMNet(n_gamma=n_gamma)
    return jax.device_get(jax.jit(jnet.init)(
        jax.random.PRNGKey(3), jnp.zeros((1, *view, 15), jnp.uint8),
        jmodel.SafeLifeLSTMNet.initial_carry(1)))


def _pair(view, n_gamma=1, dtype=torch.float32):
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jnet = jmodel.SafeLifeLSTMNet(n_gamma=n_gamma, compute_dtype=jdtype)
    params = _flax_params(view, n_gamma)
    net = tmodel.SafeLifeLSTMNet(view_shape=view, n_gamma=n_gamma,
                                 compute_dtype=dtype)
    net.load_state_dict(tmodel.params_from_flax(net, params))
    return jnet, params, net


def test_lstm_step_matches_lstm_cell():
    gen = torch.Generator().manual_seed(0)
    cell = torch.nn.LSTMCell(40, 512)
    with torch.no_grad():
        for p in cell.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    x = torch.randn((6, 40), generator=gen)
    c, h = (torch.randn((6, 512), generator=gen) for _ in range(2))
    (c2, h2), out = tmodel.lstm_step(x, (c, h), cell.weight_ih,
                                     cell.weight_hh, cell.bias_ih,
                                     cell.bias_hh)
    with torch.no_grad():
        want_h, want_c = cell(x, (h, c))
    torch.testing.assert_close(h2, want_h, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(c2, want_c, rtol=1e-5, atol=1e-6)
    assert out is h2


@pytest.mark.parametrize("view", [(17, 17), (33, 33)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_lstm_net_matches_flax(view, dtype):
    jnet, params, net = _pair(view, dtype=dtype)
    obs, carry = _obs(view, (4,)), _carry(4)
    (want_c, want_h), (want_logits, want_values) = jax.device_get(
        jax.jit(jnet.apply)(params, obs, carry))
    with torch.no_grad():
        (c, h), (logits, values) = net(torch.as_tensor(obs),
                                       tuple(map(torch.as_tensor, carry)))
    assert logits.shape == (4, 9) and values.shape == (4, 1)
    assert c.shape == h.shape == (4, 512)
    assert all(t.dtype == torch.float32 for t in (c, h, logits, values))
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for got, want, name in ((logits, want_logits, "logits"),
                            (values, want_values, "values"),
                            (c, want_c, "c"), (h, want_h, "h")):
        np.testing.assert_allclose(got.numpy(), want, err_msg=name, **tol)
    if dtype == torch.float32:
        # The cell is nn.LSTMCell, held to the plain step on the trunk's
        # features.
        x = torch.as_tensor(obs).permute(0, 3, 1, 2).float()
        for conv in net.convs:
            x = torch.relu(conv(x))
        feats = x.permute(0, 2, 3, 1).reshape(4, -1)
        cell = net.lstm
        (c2, h2), _ = tmodel.lstm_step(
            feats, tuple(map(torch.as_tensor, carry)), cell.weight_ih,
            cell.weight_hh, cell.bias_ih, cell.bias_hh)
        torch.testing.assert_close(c2.detach(), c, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(h2.detach(), h, rtol=1e-5, atol=1e-6)


def test_lstm_params_round_trip_and_init():
    _, params, net = _pair((17, 17))
    back = tmodel.params_to_flax(net)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    jax.tree.map(np.testing.assert_array_equal, back, params)
    fresh = tmodel.SafeLifeLSTMNet(view_shape=(17, 17),
                                   generator=torch.Generator().manual_seed(1))
    assert not fresh.lstm.bias_ih.requires_grad
    assert not fresh.lstm.bias_ih.any() and not fresh.lstm.bias_hh.any()
    for gate in fresh.lstm.weight_hh.detach().chunk(4):
        torch.testing.assert_close(gate @ gate.T, torch.eye(512), rtol=0,
                                   atol=1e-4)
    carry = fresh.initial_carry(3)
    assert [tuple(t.shape) for t in carry] == [(3, 512)] * 2
    assert not any(t.any() for t in carry)


@pytest.mark.parametrize("rescaling",
                         [False, "smooth", "per_batch", "per_state"])
def test_ppo_loss_recurrent_and_gradients_match_jax(rescaling):
    """T = 3 steps of M = 4 environments, episodes ending mid-sequence:
    the replay zeroes those rows of the carry.  The reference's recurrent
    loss applies only the 'smooth' value rescaling; the port's follows."""
    t_len, m, view = 3, 4, (17, 17)
    jnet, params, net = _pair(view)
    rng = np.random.RandomState(2)
    done = np.zeros((t_len, m), bool)
    done[1, 0] = done[0, 2] = done[1, 3] = True
    batch = (_obs(view, (t_len, m), seed=4), done, _carry(m, seed=5),
             rng.randint(0, 9, (t_len, m)).astype(np.int32),
             rng.uniform(0.05, 0.5, (t_len, m)).astype(np.float32),
             rng.normal(0, 0.2, (t_len, m, 1)).astype(np.float32),
             rng.normal(size=(t_len, m, 1)).astype(np.float32),
             rng.normal(size=(t_len, m, 1)).astype(np.float32))
    jcfg = jppo.PPOConfig(value_grad_rescaling=rescaling)
    cfg = tppo.PPOConfig(value_grad_rescaling=rescaling)
    jparams = {"net": params, "spe": jnp.float32(0.7)}
    (jloss, jmetrics), jgrads = jax.device_get(jax.jit(jax.value_and_grad(
        lambda p, *b: jppo.ppo_loss_recurrent(jcfg, jnet, p, *b),
        has_aux=True))(jparams, *batch))

    spe = torch.nn.Parameter(torch.tensor(0.7))
    obs, done_t, carry0, *rest = batch
    loss, metrics = tppo.ppo_loss_recurrent(
        cfg, net, spe, torch.as_tensor(obs), torch.as_tensor(done_t),
        tuple(map(torch.as_tensor, carry0)), *map(torch.as_tensor, rest))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    assert metrics.keys() == jmetrics.keys()
    for k, v in metrics.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jmetrics[k]),
                                   err_msg=k, **LOSS_TOL)
    want = tmodel.params_from_flax(net, jgrads["net"])
    for name, p in net.named_parameters():
        if name == "lstm.bias_ih":  # zero in flax, not trained
            assert p.grad is None
            continue
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **LOSS_TOL)
    np.testing.assert_allclose(spe.grad.numpy(), np.asarray(jgrads["spe"]),
                               err_msg="spe", **LOSS_TOL)


def test_recurrent_train_batch_on_synth_bank():
    bank = tsynth.synth_bank(2, h=13, w=13, device="cpu")
    env = BatchedSafeLifeEnv(EnvConfig(view_shape=(17, 17), time_limit=3),
                             device="cpu")
    cfg = tppo.PPOConfig(steps_per_env=4, num_minibatches=2,
                         epochs_per_batch=1)
    gen = torch.Generator().manual_seed(0)
    net = tmodel.SafeLifeLSTMNet(view_shape=(17, 17), generator=gen)
    ts = tppo.init_train_state(cfg, net)
    assert all(p is not net.lstm.bias_ih for p in ts.optimizer.params)
    state = env.reset_all(bank, 8, gen)
    obs = env.observe(state)
    carry = net.initial_carry(8)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    ppo = tppo.RecurrentPPO(cfg, env)
    state, obs, carry, metrics = ppo.train_batch(ts, state, obs, carry,
                                                 bank, gen)
    for k in ("policy_loss", "value_loss", "entropy", "mean_reward"):
        assert torch.isfinite(metrics[k]).all(), k
    after = net.state_dict()
    changed = {k for k in after if not torch.equal(before[k], after[k])}
    assert changed == set(after) - {"lstm.bias_ih"}, changed
    assert ts.update_step == 1 and ts.spe.item() != 1.0
    # Every episode runs out of time on the rollout's last step (length 4
    # > time_limit 3): the carry the rollout hands on is zero, and the
    # carry it started from was not.
    done = metrics["episodes"]["done"]
    assert done[-1].all() and not done[:-1].any()
    assert not any(c.any() for c in carry)
    (c1, h1), _ = net(obs, net.initial_carry(8))
    assert h1.abs().sum(-1).gt(0).all()
