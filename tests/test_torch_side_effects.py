"""The port's side-effect scoring against the JAX package on the CPU: the
exact EMD cases of ``tests/test_side_effects.py``, canonical keys and
occupancy, the batched co-evolution bit for bit on spawnless boards (where
no spawn draw fires, so the two packages' random fields cannot differ),
the Sinkhorn EMD against JAX's and against the exact LP, the batched
scores end to end, and the host ``side_effect_score`` with the same numpy
random field on both sides.

Tolerances: Sinkhorn against JAX's rtol 1e-4, atol 1e-6 (200 float32
iterations on both sides, summed in other orders); against the exact LP
rel 0.05, abs 0.02, as the JAX package's own test; the host score (the
same numpy arithmetic and LP on both sides) rtol 1e-9.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safelife_torch import cells as C
from safelife_torch import side_effects as se
from safelife_torch.levels import loader as tloader
from safelife_tpu import side_effects as jse

torch.set_num_threads(1)

SINKHORN_TOL = dict(rtol=1e-4, atol=1e-6)


# --- exact EMD ----------------------------------------------------------------

def _emd_case(name):
    a, b = np.zeros((10, 10)), np.zeros((10, 10))
    if name == "identical":
        a = np.random.RandomState(0).rand(8, 8)
        return a, a.copy(), {}, 0.0
    if name == "move":
        a[2, 2], b[2, 5] = 1.0, 1.0  # manhattan distance 3
        return a, b, {}, np.tanh(3 / 5.0)
    if name == "torus":
        a[0, 0], b[0, 9] = 1.0, 1.0  # distance 1 across the wrap
        return a, b, {}, np.tanh(1 / 5.0)
    if name == "no_wrap":
        a[0, 0], b[0, 9] = 1.0, 1.0
        return a, b, dict(wrap_x=False), np.tanh(9 / 5.0)
    # One unit must vanish: a pure extra-mass penalty of 1.0.
    a[1, 1], b[1, 1] = 2.0, 1.0
    return a, b, {}, 1.0


@pytest.mark.parametrize("name", ["identical", "move", "torus", "no_wrap",
                                  "extra_mass"])
def test_emd_matches_jax(name):
    a, b, kw, expected = _emd_case(name)
    got = se.earth_mover_distance(a, b, **kw)
    assert got == pytest.approx(expected, rel=1e-6, abs=1e-12)
    assert got == jse.earth_mover_distance(a, b, **kw)


# --- canonicalization and occupancy -------------------------------------------

def test_canonical_keys_match_jax():
    cells = np.arange(1 << 16, dtype=np.uint16)
    np.testing.assert_array_equal(se.canonical_key(cells),
                                  jse.canonical_key(cells))
    assert se.canonical_key(C.LIFE | C.COLOR_R) == \
        se.canonical_key(C.HARD_LIFE | C.COLOR_R)
    assert se.canonical_key(C.SPAWNER | C.COLOR_G) == (C.SPAWNER | C.COLOR_G)
    assert se.canonical_key(C.HARD_SPAWNER | C.COLOR_G) == 0
    for cell in (C.WALL, C.LEVEL_EXIT, C.TREE):
        assert se.canonical_key(cell) == 0
    assert se.DEFAULT_TRACKED == jse.DEFAULT_TRACKED


def test_occupancy_matches_jax():
    rng = np.random.RandomState(0)
    board = rng.randint(0, 1 << 16, (6, 7, 5)).astype(np.uint16)
    board[1, 1, 0] = C.LIFE | C.COLOR_R
    board[2, 2, 0] = C.HARD_LIFE | C.COLOR_R  # the same canonical key
    board[3, 3, 1] = C.SPAWNER
    got = se.occupancy(torch.as_tensor(board), se.DEFAULT_TRACKED)
    want = np.asarray(jse.occupancy(jnp.asarray(board), jse.DEFAULT_TRACKED))
    assert got.dtype == torch.bool and got.shape == (16, 6, 7, 5)
    np.testing.assert_array_equal(got.numpy(), want)
    k = se.DEFAULT_TRACKED.index(C.LIFE | C.COLOR_R)
    assert got[k, :, :, 0].sum() >= 2


# --- the batched co-evolution ---------------------------------------------------

def _episode_ends(num_levels=6):
    """append-still's first levels (spawnless) and a disturbed copy: the
    initial and final boards of six episodes of 0 to 12 steps."""
    bank = tloader.load_bank("benchmarks/v1.0/append-still", device="cpu")
    init = bank.board.numpy()[..., :num_levels].copy()
    final = init.copy()
    final[5:9, 5:9, :] = 0
    final[12, 3:6, 1] = C.LIFE | C.COLOR_G
    steps = np.array([3, 0, 7, 12, 5, 1], np.int32)[:num_levels]
    return init, final, np.zeros(num_levels, np.float32), steps


def test_accumulate_distributions_bit_equal_to_jax():
    init, final, spawn_prob, steps = _episode_ends()
    want = jax.device_get(jse.accumulate_distributions(
        *map(jnp.asarray, (init, final, spawn_prob, steps)), 10,
        jax.random.PRNGKey(0), catch_up_steps=12))
    got = se.accumulate_distributions(
        *map(torch.as_tensor, (init, final, spawn_prob, steps)), 10,
        torch.Generator().manual_seed(0), catch_up_steps=12)
    for g, w, name in zip(got, want, ("action", "inaction")):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert got[0].sum() > 0


def test_batched_scores_match_jax():
    init, final, spawn_prob, steps = _episode_ends()
    want = jax.device_get(jse.side_effect_score_batched(
        *map(jnp.asarray, (init, final, spawn_prob, steps)),
        jax.random.PRNGKey(0), num_samples=10, catch_up_steps=12))
    got = se.side_effect_score_batched(
        *map(torch.as_tensor, (init, final, spawn_prob, steps)),
        torch.Generator().manual_seed(0), num_samples=10, catch_up_steps=12)
    for g, w, name in zip(got, want, ("scores", "mass")):
        assert g.shape == (16, 6)
        np.testing.assert_allclose(g.numpy(), w, err_msg=name,
                                   **SINKHORN_TOL)
    assert want[0].max() > 1.0  # the disturbed boards score


# --- Sinkhorn -------------------------------------------------------------------

def _distributions(rng, n, rows, points=5):
    out = np.zeros((rows, n), np.float32)
    for r in range(rows):
        out[r, rng.choice(n, points, replace=False)] = rng.rand(points)
    return out


def test_sinkhorn_matches_jax():
    rng = np.random.RandomState(1)
    h, w = 9, 8
    cost = se.torus_distances((h, w))
    np.testing.assert_array_equal(cost, jse.torus_distances((h, w)))
    a, b = (_distributions(rng, h * w, 12) for _ in range(2))
    a[3] = 0.0                  # empty against mass: all penalty
    b[5] = a[5]                 # identical
    b[7] *= 3.0                 # unequal masses
    want = np.asarray(jse.sinkhorn_emd(jnp.asarray(a), jnp.asarray(b),
                                       cost))
    got = se.sinkhorn_emd(torch.as_tensor(a), torch.as_tensor(b), cost)
    assert got.dtype == torch.float32 and got.shape == (12,)
    np.testing.assert_allclose(got.numpy(), want, **SINKHORN_TOL)
    # Batched over leading dims: (K, B, N) as the scorer calls it.
    got3 = se.sinkhorn_emd(torch.as_tensor(a).reshape(3, 4, -1),
                           torch.as_tensor(b).reshape(3, 4, -1), cost)
    np.testing.assert_allclose(got3.reshape(-1).numpy(), want,
                               **SINKHORN_TOL)


def test_sinkhorn_matches_exact():
    rng = np.random.RandomState(3)
    h = w = 8
    cost = se.torus_distances((h, w))
    for trial in range(4):
        a, b = (_distributions(rng, h * w, 1)[0].astype(np.float64)
                for _ in range(2))
        exact = se.earth_mover_distance(a.reshape(h, w), b.reshape(h, w))
        approx = float(se.sinkhorn_emd(torch.as_tensor(a),
                                       torch.as_tensor(b), cost, iters=500))
        assert approx == pytest.approx(exact, rel=0.05, abs=0.02), trial


def test_sinkhorn_restores_matmul_flags():
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with torch.autocast("cpu", dtype=torch.bfloat16):
            got = se.sinkhorn_emd(torch.ones(1, 4), torch.ones(1, 4),
                                  se.torus_distances((2, 2)))
        assert got.dtype == torch.float32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


# --- end to end -----------------------------------------------------------------

def test_no_interference_scores_zero():
    """An untouched deterministic board: action == inaction, all scores 0."""
    board = np.zeros((12, 12, 2), np.uint16)
    board[2:4, 2:4, :] = C.LIFE | C.COLOR_R  # a block, a still life
    init = torch.as_tensor(board)
    scores, mass = se.side_effect_score_batched(
        init, init, torch.zeros(2), torch.zeros(2, dtype=torch.int32),
        torch.Generator().manual_seed(0), num_samples=20, catch_up_steps=8)
    np.testing.assert_allclose(scores.numpy(), 0.0, atol=1e-3)
    k = se.DEFAULT_TRACKED.index(C.LIFE | C.COLOR_R)
    np.testing.assert_allclose(mass[k].numpy(), 4.0, atol=1e-5)


def test_destroyed_pattern_scores_nonzero():
    """Wiping out a still life shows up as a side effect of its colour."""
    init = np.zeros((12, 12, 1), np.uint16)
    init[2:4, 2:4, 0] = C.LIFE | C.COLOR_G
    scores, _ = se.side_effect_score_batched(
        torch.as_tensor(init), torch.zeros_like(torch.as_tensor(init)),
        torch.zeros(1), torch.tensor([5], dtype=torch.int32),
        torch.Generator().manual_seed(0), num_samples=20, catch_up_steps=8)
    k = se.DEFAULT_TRACKED.index(C.LIFE | C.COLOR_G)
    s = scores.numpy().copy()
    # 4 units of mass vanished: a penalty of about 4, no transport.
    assert s[k, 0] == pytest.approx(4.0, rel=0.05)
    s[k, 0] = 0
    np.testing.assert_allclose(s, 0.0, atol=1e-3)


def test_host_score_matches_jax():
    """A game-like object with spawners (so the draws matter), scored by
    both packages from the same numpy random stream."""
    init = np.zeros((10, 11), np.uint16)
    init[2:4, 2:4] = C.LIFE | C.COLOR_G
    init[6, 6] = C.SPAWNER | C.COLOR_R
    init[7, 2:5] = C.LIFE                      # a blinker
    final = init.copy()
    final[2:4, 2] = 0                          # half the block destroyed
    final[1, 8] = C.LIFE | C.COLOR_B
    game = types.SimpleNamespace(board=final, spawn_prob=0.3, num_steps=4,
                                 _init_data={"board": init})
    got = se.side_effect_score(game, num_samples=30,
                               rng=np.random.RandomState(7))
    want = jse.side_effect_score(game, num_samples=30,
                                 rng=np.random.RandomState(7))
    assert got.keys() == want.keys() and len(got) >= 3
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9,
                                   err_msg=str(key))
    assert got[int(se.canonical_key(C.LIFE | C.COLOR_G))][0] > 0
