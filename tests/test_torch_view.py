"""The plain versions of the view kernel's two epilogues and of the
observation sum against the JAX package, bit for bit, on seeded numpy
inputs:

* ``unpack_channels_plain`` against ``safelife_tpu.ops.obs.unpack_channels``
  (the XLA part of the jitted step after the advance kernel), any channel
  list: order, gaps and bit 15 included;
* ``transpose_view_plain`` against ``jnp.transpose(view, (2, 0, 1))``;
* ``obs_sum_plain`` against the JAX bench's consumer,
  ``x.astype(jnp.int32).sum()``.

On a CPU tensor the wrappers ``unpack_channels``, ``transpose_view`` and
``obs_sum`` run these plain versions; ``chip_smoke.py`` holds the kernels
to them on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safelife_torch.ops import obs as tobs
from safelife_tpu.ops import obs as jobs

# The tensors here are small.  One thread keeps torch from leaving an
# OpenMP pool in the test process that slows the JAX tests run after it.
torch.set_num_threads(1)

CHANNELS = (tuple(range(15)), (0, 3, 12), (14, 2, 7), tuple(range(16)))
VIEWS = ((15, 15), (7, 9))
BATCHES = (7, 33, 64)


def _view(seed, vh, vw, b):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 2**16, (vh, vw, b)).astype(np.uint16)


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("vh,vw", VIEWS)
@pytest.mark.parametrize("channels", CHANNELS)
def test_unpack_channels_matches_jax(channels, vh, vw, b):
    view = _view(vh * 100 + b, vh, vw, b)
    want = np.asarray(jobs.unpack_channels(jnp.asarray(view), channels))
    got = tobs.unpack_channels_plain(torch.as_tensor(view), channels)
    assert got.dtype == torch.uint8 and got.shape == (b, vh, vw,
                                                      len(channels))
    np.testing.assert_array_equal(got.numpy(), want)
    # The wrapper takes the plain version on a CPU tensor.
    np.testing.assert_array_equal(
        tobs.unpack_channels(torch.as_tensor(view), channels).numpy(), want)


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("vh,vw", VIEWS)
def test_transpose_view_matches_jax(vh, vw, b):
    view = _view(vh * 1000 + b, vh, vw, b)
    want = np.asarray(jnp.transpose(jnp.asarray(view), (2, 0, 1)))
    got = tobs.transpose_view_plain(torch.as_tensor(view))
    assert got.dtype == torch.uint16 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tobs.transpose_view(torch.as_tensor(view)).numpy(), want)


@pytest.mark.parametrize("n", [1, 4097, 15 * 15 * 15 * 64 + 3])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_obs_sum_matches_jax_bench(dtype, n):
    x = np.random.RandomState(n).randint(
        0, np.iinfo(dtype).max + 1, n).astype(dtype)
    want = np.asarray(jnp.asarray(x).astype(jnp.int32).sum())
    for t in (torch.as_tensor(x), torch.as_tensor(x)[1:]):
        got = tobs.obs_sum(t)
        assert got.dtype == torch.int32 and got.dim() == 0
    np.testing.assert_array_equal(tobs.obs_sum(torch.as_tensor(x)).numpy(),
                                  want)
    np.testing.assert_array_equal(
        tobs.obs_sum_plain(torch.as_tensor(x)[1:]).numpy(),
        np.asarray(jnp.asarray(x[1:]).astype(jnp.int32).sum()))


def test_obs_sum_wraps_as_int32():
    """A sum past 2**31 wraps as torch's and JAX's int32 sums do."""
    x = np.full(2**24 + 5, 255, np.uint8)
    want = np.asarray(jnp.asarray(x).astype(jnp.int32).sum())
    assert int(want) < 0
    np.testing.assert_array_equal(tobs.obs_sum(torch.as_tensor(x)).numpy(),
                                  want)
