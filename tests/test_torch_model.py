"""The port's policy/value network against the JAX model: the same flax
weights carried across by ``params_from_flax``, the same observations,
float32 on both sides within 1e-5 and bfloat16 on both sides within the
tolerance stated below; the weights round-trip through
``params_to_flax``; and the smallest view the trunk accepts."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safelife_torch.training import model as tmodel
from safelife_tpu.training import model as jmodel

torch.set_num_threads(1)

# The trunk in bfloat16 on both sides: 8 significant bits, and the two
# sides round the convolutions' and the dense layer's sums at different
# points (measured: 1.6e-4 on values of magnitude 0.9, 1e-6 on logits of
# 0.01, at 33x33; bf16 against float32 differs by 3e-3 on the same values).
BF16_ATOL = 1e-3
BF16_RTOL = 1e-2


@functools.lru_cache(maxsize=None)
def _flax_params(view, n_gamma):
    """``SafeLifeCNN().init`` params as numpy (jitted: one compile instead
    of an op-by-op init)."""
    jnet = jmodel.SafeLifeCNN(n_gamma=n_gamma)
    return jax.device_get(jax.jit(jnet.init)(
        jax.random.PRNGKey(3), jnp.zeros((1, *view, 15), jnp.uint8)))


def _pair(view, n_gamma, dtype):
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jnet = jmodel.SafeLifeCNN(n_gamma=n_gamma, compute_dtype=jdtype)
    params = _flax_params(view, n_gamma)
    net = tmodel.SafeLifeCNN(view_shape=view, n_gamma=n_gamma,
                             compute_dtype=dtype)
    net.load_state_dict(tmodel.params_from_flax(net, params))
    return jnet, params, net


def _obs(view, batch=(16,), seed=0):
    rng = np.random.RandomState(seed)
    return (rng.random_sample((*batch, *view, 15)) < 0.2).astype(np.uint8)


@pytest.mark.parametrize("view,n_gamma", [((33, 33), 1), ((17, 17), 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_forward_matches_flax(view, n_gamma, dtype):
    jnet, params, net = _pair(view, n_gamma, dtype)
    # Leading batch dims are flattened: (T, B, ...) as in the loss.
    obs = _obs(view, batch=(2, 8))
    want_logits, want_values = jax.device_get(
        jax.jit(jnet.apply)(params, obs))
    with torch.no_grad():
        logits, values = net(torch.as_tensor(obs))
    assert logits.shape == (2, 8, 9) and values.shape == (2, 8, n_gamma)
    assert logits.dtype == values.dtype == torch.float32
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=BF16_RTOL, atol=BF16_ATOL))
    np.testing.assert_allclose(logits.numpy(), want_logits, **tol)
    np.testing.assert_allclose(values.numpy(), want_values, **tol)


def test_params_round_trip_through_flax():
    _, params, net = _pair((17, 17), 2, torch.float32)
    back = tmodel.params_to_flax(net)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    jax.tree.map(np.testing.assert_array_equal, back, params)
    # The port's own init carries to flax and back unchanged.
    fresh = tmodel.SafeLifeCNN(view_shape=(21, 25), n_gamma=2,
                               generator=torch.Generator().manual_seed(1))
    again = tmodel.SafeLifeCNN(view_shape=(21, 25), n_gamma=2)
    again.load_state_dict(tmodel.params_from_flax(
        again, tmodel.params_to_flax(fresh)))
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(again.state_dict()[k], v, rtol=0, atol=0)
    with pytest.raises(ValueError, match="Dense_0"):
        small = tmodel.SafeLifeCNN(view_shape=(21, 21), n_gamma=2)
        small.load_state_dict(tmodel.params_from_flax(small, params))


def test_orthogonal_init_scales():
    net = tmodel.SafeLifeCNN(generator=torch.Generator().manual_seed(0))
    for layer, gain in ((net.convs[0], 2 ** 0.5), (net.dense, 2 ** 0.5),
                        (net.policy, 0.01), (net.value, 1.0)):
        w = layer.weight.detach().reshape(layer.weight.shape[0], -1)
        # Orthonormal rows (or columns, whichever are fewer), times gain.
        gram = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
        torch.testing.assert_close(gram / gain ** 2,
                                   torch.eye(gram.shape[0]),
                                   rtol=0, atol=1e-4)
        assert not layer.bias.any()


def test_min_view_for_net():
    assert tmodel.min_view_for_net() == jmodel.min_view_for_net() == (17, 17)
    assert tmodel.feature_shape((17, 17)) == (1, 1)
    assert tmodel.feature_shape((33, 33)) == (5, 5)
    for view in ((16, 16), (17, 16), (15, 15)):
        with pytest.raises(ValueError, match="too small"):
            tmodel.SafeLifeCNN(view_shape=view)
