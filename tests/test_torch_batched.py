"""The port's batched annealer and level factories
(``safelife_torch.procgen.batched``) and ``levels/device_bank.py`` against
the JAX package on the CPU.

* Bit for bit: ``violation_field`` and ``oscillation_field`` at periods 1
  and 2 on soups with spawners (K5's plain version against
  ``life.advance_board``), ``_advance_patch`` on (28, P, P, B) patches,
  ``_partition_scaffolds`` under one numpy seed, and
  ``build_bank_from_arrays`` on a factory-shaped bank, every field.
* The annealer under the JAX package's own draws: the target Gumbel field
  and the 27-way pick derived from JAX's keys as ``gen_still_lifes``
  splits them (the pick first checked against ``jax.random.categorical``)
  and fed to the port through ``gumbel_field``: the boards after 50
  iterations at 16x16, B = 8 equal JAX's at period 1 and period 2.
* The annealer's ensembles on its own draws: still lifes at 16x16 (48
  boards, 2000 iterations) against the C++ annealer's with the gate of
  ``tests/test_procgen_distribution.py``, and the port's mirrors of
  ``tests/test_procgen.py``'s factory tests (append, prune, append-spawn).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_procgen_distribution as dist
from safelife_torch import cells as C
from safelife_torch.env.env import BatchedSafeLifeEnv, EnvConfig
from safelife_torch.levels import device_bank as tdb
from safelife_torch.ops import life_numpy
from safelife_torch.procgen import batched as tb
from safelife_torch.procgen import native as tn
from safelife_tpu.levels import device_bank as jdb
from safelife_tpu.procgen import batched as jb

torch.set_num_threads(1)

FLAGS = ("static_goals", "spawnless", "simple_goals", "spawn_simple_goals")
SOUP_FLAGS = (C.ALIVE, C.DESTRUCTIBLE, C.FROZEN, C.PRESERVING, C.INHIBITING,
              C.SPAWNING, C.EXIT, C.COLOR_R, C.COLOR_G, C.COLOR_B,
              C.PULLABLE)


def soup(rng, shape, flags=SOUP_FLAGS, density=0.12):
    board = np.zeros(shape, np.uint16)
    for f in flags:
        board |= np.uint16(f) * (rng.random(shape) < density).astype(
            np.uint16)
    # Dense life, so that the rule has work everywhere.
    return board | (rng.random(shape) < 0.35).astype(np.uint16)


def region(h=16, w=16):
    mask = np.zeros((h, w), bool)
    mask[3:h - 3, 3:w - 3] = True
    return mask


@pytest.mark.parametrize("period", [1, 2])
def test_violation_and_oscillation_fields_match_jax(period):
    rng = np.random.default_rng(period)
    for shape in ((26, 26, 5), (9, 13, 3)):
        board = soup(rng, shape)
        got = tb.violation_field(torch.as_tensor(board), period)
        want = jb.violation_field(jnp.asarray(board), period)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.any() and not got.all()
        got = tb.oscillation_field(torch.as_tensor(board), period)
        want = jb.oscillation_field(jnp.asarray(board), period)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.any() == (period > 1)


@pytest.mark.parametrize("p", [7, 11])
def test_advance_patch_matches_jax(p):
    rng = np.random.default_rng(p)
    patch = soup(rng, (28, p, p, 6), flags=(
        C.FROZEN, C.DESTRUCTIBLE, C.PRESERVING, C.INHIBITING, C.COLOR_G,
        C.PULLABLE))
    want = np.asarray(jb._advance_patch(jnp.asarray(patch)))
    got = tb._advance_patch(torch.as_tensor(patch.view(np.int16)))
    np.testing.assert_array_equal(got.numpy().view(np.uint16), want)
    # Two steps on the interior alone give the interior of two open steps.
    inner = slice(2, p - 2)
    tables = tb._rule_tables(torch.device("cpu"))
    twice = tb._advance_valid(tb._advance_valid(
        torch.as_tensor(patch.view(np.int16)), tables), tables)
    np.testing.assert_array_equal(
        twice.numpy().view(np.uint16),
        np.asarray(jb._advance_patch(jb._advance_patch(
            jnp.asarray(patch))))[:, inner, inner])


def test_partition_scaffolds_match_jax():
    for seed, regions in ((3, 3), (5, 4)):
        np.random.seed(seed)
        got = tb._partition_scaffolds(4, 26, 26, max_regions=regions)
        np.random.seed(seed)
        want = jb._partition_scaffolds(4, 26, 26, max_regions=regions)
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            assert got[key].dtype == want[key].dtype


def jax_fields(bank):
    return {f.name: jax.device_get(getattr(bank, f.name))
            for f in dataclasses.fields(bank)}


def test_build_bank_from_arrays_matches_jax():
    """A factory-shaped bank: scaffolds with player and exit, soup regions,
    goal colours, spawners in half the levels, one exit slot."""
    np.random.seed(9)
    sc = tb._partition_scaffolds(12, 26, 26)
    rng = np.random.default_rng(9)
    painted = soup(rng, (26, 26, 12), flags=(
        C.DESTRUCTIBLE, C.FROZEN, C.COLOR_R, C.COLOR_G, C.COLOR_B))
    inside = sc["slots"].any(axis=0)
    board = np.where(inside, painted, sc["board0"]).astype(np.uint16)
    board[..., :6] |= (np.uint16(C.SPAWNER) * (
        rng.random((26, 26, 6)) < 0.02) * inside[..., :6]).astype(np.uint16)
    goals = np.where(inside, soup(rng, (26, 26, 12), flags=(
        C.COLOR_G, C.COLOR_B)) & ~np.uint16(C.ALIVE), 0).astype(np.uint16)
    goals |= np.where(sc["buffer"], np.uint16(C.COLORS), 0).astype(np.uint16)
    spawn_prob = np.full(12, 0.3, np.float32)
    for kw in (dict(min_performance=0.5, spawn_prob=spawn_prob,
                    max_exits=1, static_goals=True),
               dict(min_performance=-1.0, max_exits=2, simple_goals=True),
               dict(min_performance=np.linspace(-0.5, 0.5, 12).astype(
                   np.float32), spawnless=True, spawn_simple_goals=True)):
        got = tdb.build_bank_from_arrays(
            torch.as_tensor(board), torch.as_tensor(goals),
            torch.as_tensor(sc["pr"]), torch.as_tensor(sc["pc"]),
            **{k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}).to_numpy()
        want = jax_fields(jdb.build_bank_from_arrays(
            jnp.asarray(board), jnp.asarray(goals), jnp.asarray(sc["pr"]),
            jnp.asarray(sc["pc"]), **kw))
        assert set(got) == set(want)
        for name, value in want.items():
            if name in FLAGS:
                assert got[name] == value, name
            else:
                np.testing.assert_array_equal(got[name], np.asarray(value),
                                              err_msg=name)
                assert got[name].dtype == np.asarray(value).dtype, name


def jax_draws(key, iters, hw, b):
    """The Gumbel fields JAX's gen_still_lifes draws at each iteration: the
    target field (k_cell) over the pick's (k_pick), as (iters, hw + 27, b)
    fields."""
    def fields(k):
        k_cell, k_pick = jax.random.split(k)
        return jnp.concatenate([jax.random.gumbel(k_cell, (hw, b)),
                                jax.random.gumbel(k_pick, (27, b))])
    return np.asarray(jax.jit(jax.vmap(fields))(
        jax.random.split(key, iters)))


def test_categorical_is_argmax_of_logits_plus_its_gumbel():
    key = jax.random.PRNGKey(3)
    logits = jnp.asarray(np.random.default_rng(3).normal(size=(27, 64)),
                         jnp.float32)
    logits = jnp.where(logits > 1.5, -1e30, logits)
    want = np.asarray(jax.random.categorical(key, logits, axis=0))
    got = (torch.as_tensor(np.asarray(logits))
           + torch.as_tensor(np.asarray(jax.random.gumbel(key, (27, 64)))))
    np.testing.assert_array_equal(got.argmax(0).numpy(), want)


@pytest.mark.parametrize("period", [1, 2])
def test_annealer_matches_jax_given_its_draws(period, monkeypatch):
    h = w = 16
    b, iters = 8, 50
    key = jax.random.PRNGKey(period)
    kw = dict(iters=iters, period=period, min_fill=0.15, temperature=0.45,
              cell_penalties=(0.0, (1.0, 20.0), 0.0, (1.0, 20.0)),
              osc_bonus=0.3)
    want, want_conv = jb.gen_still_lifes(key, jnp.asarray(region()),
                                         batch=b, **kw)
    draws = iter(jax_draws(key, iters, h * w, b))
    monkeypatch.setattr(tb, "gumbel_field",
                        lambda shape, gen: torch.as_tensor(next(draws)))
    got, conv = tb.gen_still_lifes(torch.Generator(), region(), b, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(conv.numpy(), np.asarray(want_conv))
    assert (got.numpy() != 0).sum() > 8 * b  # the boards grew


def test_annealer_ensemble_matches_native():
    """The port's annealer on its own draws against the C++ annealer's
    ensemble: the gate of test_procgen_distribution.py's
    test_device_annealer_matches_native_ensemble."""
    h = w = 16
    n = 48
    mask = region(h, w)
    gen_mask = np.where(mask, tn.NEW_CELL_MASK | tn.CAN_OSCILLATE_MASK
                        | tn.INCLUDE_VIOLATIONS_MASK, 0)
    halo = np.zeros_like(gen_mask)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            halo |= np.roll(gen_mask & 1, (di, dj), (0, 1))
    gen_mask = np.where((halo > 0) & (gen_mask == 0),
                        tn.INCLUDE_VIOLATIONS_MASK, gen_mask)
    native_boards = []
    for seed in range(n):
        try:
            native_boards.append(tn.gen_pattern(
                np.zeros((h, w), np.uint16), gen_mask.astype(np.int32),
                period=1, min_fill=0.15, temperature=0.45, rng=seed))
        except tn.BoardGenException:
            pass
    assert len(native_boards) >= 0.8 * n

    gen = torch.Generator().manual_seed(0)
    boards, conv = tb.gen_still_lifes(gen, mask, n, iters=2000,
                                      min_fill=0.15, temperature=0.45)
    boards, conv = boards.numpy(), conv.numpy()
    assert conv.mean() >= 0.8
    device_boards = [boards[..., i] for i in range(n) if conv[i]]
    for board in device_boards:
        assert (board[~mask] == 0).all()
        assert (board != 0).sum() >= 0.15 * mask.sum()
        np.testing.assert_array_equal(
            life_numpy.advance_board_reference(board, spawn_prob=0.0),
            board)
    dist.compare(dist._still_life_stats(native_boards),
                 dist._still_life_stats(device_boards),
                 "still-life-annealers")


def test_level_factory_append():
    """gen_build_levels: playable build-task banks (test_procgen.py's
    test_on_device_level_factory)."""
    bank, conv = tb.gen_build_levels(0, batch=16, iters=1200, device="cpu")
    conv = conv.numpy()
    assert conv.mean() >= 0.7
    board, goals = bank.board.numpy(), bank.goals.numpy()
    assert ((board & C.AGENT) != 0).sum(axis=(0, 1)).min() == 1
    assert ((board & C.EXIT) != 0).sum(axis=(0, 1)).min() == 1
    assert (((goals & C.ALIVE) != 0) & ((goals & C.COLOR_B) != 0)).any()
    assert (bank.possible0.numpy() > 0).all()
    assert bank.spawnless and not bank.static_goals

    env = BatchedSafeLifeEnv(EnvConfig(view_shape=(15, 15), time_limit=20),
                             device="cpu")
    gen = torch.Generator().manual_seed(1)
    state = env.reset_all(bank, 8, gen)
    for _ in range(25):
        actions = torch.randint(0, 9, (8,), generator=gen)
        state, ts = env.step(state, bank, actions, generator=gen)
    assert torch.isfinite(ts.reward).all()
    b0 = board[..., int(np.argmax(conv))]
    interior = np.zeros(b0.shape, bool)
    interior[3:-3, 3:-3] = True
    adv = life_numpy.advance_board_reference(b0, spawn_prob=0.0)
    np.testing.assert_array_equal(adv[interior], b0[interior])


def test_level_factory_prune_and_spawn():
    bank, conv = tb.gen_build_levels(3, batch=8, iters=1500, task="prune",
                                     device="cpu")
    assert conv.float().mean() >= 0.5
    board = bank.board.numpy()
    alive = (board & C.ALIVE) != 0
    assert (alive & ((board & C.COLOR_R) != 0)).any()
    assert (alive & ((board & C.COLOR_G) != 0)).any()
    assert (bank.possible0.numpy() > 0).all()

    bank, conv = tb.gen_build_levels(4, batch=8, iters=1200,
                                     task="append-spawn", device="cpu")
    board = bank.board.numpy()
    assert ((board & C.SPAWNING) != 0).sum(axis=(0, 1)).min() == 1
    assert (bank.spawn_prob.numpy() == np.float32(0.3)).all()
    assert not bank.spawnless
