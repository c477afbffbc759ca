"""The port's host procgen pipeline (``safelife_torch.procgen``: presets,
``generate``, the native annealer and labeller) against the JAX package on
the CPU, and its gates.

* Bit for bit under one ``np.random.seed``: ``gen_levels`` of every one of
  the 11 reference presets (2 levels, every field), ``load_params``,
  ``fix_random_values``, ``make_partitioned_regions``, ``build_fence``,
  ``stability_mask``, ``native.wrapped_label`` and ``native.gen_pattern``
  with a fixed ``rng=``.  The JAX package is imported before any level is
  drawn: importing JAX draws from numpy's global generator.
* The port's own mirrors of ``tests/test_procgen.py``'s host gates (still
  life, oscillator, mask, ``gen_game`` end to end, ``gen_bank`` into the
  port's env) and one archive gate of
  ``tests/test_procgen_distribution.py`` (append-still, 60 levels).
* The partitioned factory's archive gate on append-still (16 levels,
  1500 iterations), the case ``tests/test_procgen_distribution.py`` runs
  for the JAX factory; the other nine task specs run on the card
  (``chip_smoke.py`` phase 11).
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

import test_procgen_distribution as dist
from safelife_torch import cells as C
from safelife_torch import procgen as tp
from safelife_torch.env.env import BatchedSafeLifeEnv, EnvConfig
from safelife_torch.levels import loader as tloader
from safelife_torch.ops import life_numpy
from safelife_torch.procgen import batched as tb
from safelife_torch.procgen import generate as tg
from safelife_torch.procgen import native as tn
from safelife_torch.procgen import presets as tpresets
from safelife_tpu import procgen as jp
from safelife_tpu.procgen import generate as jg
from safelife_tpu.procgen import native as jn

torch.set_num_threads(1)

PRESETS = sorted(k for k in tpresets.TASKS if not k.endswith("-tiny"))
FULL = (tn.NEW_CELL_MASK | tn.CAN_OSCILLATE_MASK
        | tn.INCLUDE_VIOLATIONS_MASK)


def region_mask(h, w, pad=3):
    mask = np.zeros((h, w), np.int32)
    mask[pad:h - pad, pad:w - pad] = FULL
    border = ndimage.maximum_filter(mask > 0, size=3) & (mask == 0)
    mask[border] = tn.INCLUDE_VIOLATIONS_MASK
    return mask


def test_presets_are_the_reference_tables():
    from safelife_tpu.procgen import presets as jpresets
    assert len(PRESETS) == 11
    assert tpresets.TASKS == jpresets.TASKS
    assert tpresets.DEFAULTS == jpresets.DEFAULTS
    for task in PRESETS + [None, {"board_shape": [9, 9]}]:
        assert tp.load_params(task) == jp.load_params(task), task


@pytest.mark.parametrize("task", PRESETS)
def test_gen_levels_match_jax(task):
    got = tp.gen_levels(task, num_levels=2, seed=0)
    want = jp.gen_levels(task, num_levels=2, seed=0)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in g:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
            assert np.asarray(g[key]).dtype == np.asarray(w[key]).dtype


def test_host_helpers_match_jax():
    spec = {"a": {"uniform": [0.0, 2.0]}, "b": {"choices": {"x": 1, "y": 3}},
            "c": [1, {"choices": ["p", "q"]}], "d": 5}
    np.random.seed(1)
    got = [tg.fix_random_values(spec) for _ in range(20)]
    np.random.seed(1)
    assert got == [jg.fix_random_values(spec) for _ in range(20)]

    for shape, kw in (((20, 20), dict(max_regions=4, min_regions=2)),
                      ((26, 26), dict(max_regions=3, min_regions=2))):
        np.random.seed(7)
        got = tg.make_partitioned_regions(shape, **kw)
        np.random.seed(7)
        np.testing.assert_array_equal(
            got, jg.make_partitioned_regions(shape, **kw))
        for k in range(1, got.max() + 1):
            np.random.seed(k)
            fence = tg.build_fence(got == k)
            np.random.seed(k)
            np.testing.assert_array_equal(fence, jg.build_fence(got == k))

    rng = np.random.RandomState(3)
    data = (rng.rand(19, 23) < 0.35).astype(np.int32)
    got, n = tn.wrapped_label(data)
    want, m = jn.wrapped_label(data)
    assert n == m and n > 1
    np.testing.assert_array_equal(got, want)

    board = np.zeros((18, 18), np.uint16)
    board[2:4, 2:4] = C.LIFE
    board[9, 6:9] = C.LIFE
    board[14, 3:6] = C.LIFE | C.COLOR_G
    board[12:15, 12:15] = C.WALL
    for period in (1, 2, 6):
        np.testing.assert_array_equal(tg.stability_mask(board, period),
                                      jg.stability_mask(board, period))

    def anneal(native, seed, **kw):
        try:
            return native.gen_pattern(np.zeros((16, 16), np.uint16),
                                      region_mask(16, 16), rng=seed, **kw)
        except native.BoardGenException as e:
            return type(e).__name__

    for kw in (dict(period=1, min_fill=0.2),
               dict(period=2, min_fill=0.15, temperature=0.7,
                    osc_bonus=0.5)):
        outcomes = []
        for seed in range(6):
            got, want = anneal(tn, seed, **kw), anneal(jn, seed, **kw)
            assert type(got) is type(want), (kw, seed, got, want)
            np.testing.assert_array_equal(got, want)
            outcomes.append(isinstance(got, np.ndarray))
        assert sum(outcomes) >= 2, (kw, outcomes)


def test_native_still_life_is_stable():
    out = tn.gen_pattern(np.zeros((16, 16), np.uint16), region_mask(16, 16),
                         period=1, min_fill=0.2, rng=11)
    mask = region_mask(16, 16)
    assert (out != 0).sum() >= 0.2 * (mask & 1).sum() * 0.9
    np.testing.assert_array_equal(
        life_numpy.advance_board_reference(out, spawn_prob=0.0), out)
    assert (out[(mask & tn.NEW_CELL_MASK) == 0] == 0).all()


def test_native_oscillator_cycles():
    out = tn.gen_pattern(np.zeros((16, 16), np.uint16), region_mask(16, 16),
                         period=2, min_fill=0.15, temperature=0.7,
                         osc_bonus=0.5, rng=5)
    a1 = life_numpy.advance_board_reference(out, spawn_prob=0.0)
    a2 = life_numpy.advance_board_reference(a1, spawn_prob=0.0)
    np.testing.assert_array_equal(a2, out)
    assert (a1 != out).any()


def test_native_respects_mask_and_raises():
    mask = region_mask(16, 16)
    out = tn.gen_pattern(np.zeros((16, 16), np.uint16), mask, period=1,
                         min_fill=0.2, rng=3)
    assert (out[(mask & tn.NEW_CELL_MASK) == 0] == 0).all()
    with pytest.raises(tn.InsufficientAreaException):
        tn.gen_pattern(np.zeros((16, 16), np.uint16),
                       np.zeros((16, 16), np.int32), rng=0)
    with pytest.raises(ValueError):
        tn.gen_pattern(np.zeros((16, 16), np.uint16), mask[:8], rng=0)


@pytest.mark.parametrize("task", ["append-still", "prune-still",
                                  "append-spawn"])
def test_gen_game_end_to_end(task):
    game = tp.gen_game_from_file(task, seed=sum(map(ord, task)))
    assert (game.board & C.AGENT).any()
    assert (game.board & C.EXIT).any()
    assert (game.goals != 0).any()
    assert game.board[game.agent_loc[1], game.agent_loc[0]] & C.AGENT
    assert game.performance_ratio()[1] > 0


def test_gen_bank_feeds_the_port_env():
    bank = tp.gen_bank("append-still-easy", num_levels=3, seed=42,
                       device="cpu")
    want = jp.gen_levels("append-still-easy", num_levels=3, seed=42)
    np.testing.assert_array_equal(
        bank.board.numpy(), np.stack([lv["board"] for lv in want], -1))
    assert bank.static_goals and bank.spawnless
    env = BatchedSafeLifeEnv(EnvConfig(view_shape=(15, 15)), device="cpu")
    gen = torch.Generator().manual_seed(0)
    state = env.reset_all(bank, 4, gen)
    for _ in range(5):
        actions = torch.randint(0, 9, (4,), generator=gen)
        state, ts = env.step(state, bank, actions, generator=gen)
    assert torch.isfinite(ts.reward).all()


def test_host_pipeline_matches_reference_archive():
    """tests/test_procgen_distribution.py's archive gate on append-still
    (its first suite and seed), through the port's pipeline."""
    np.random.seed(123)
    gen = tp.gen_levels("append-still", num_levels=dist.N_GEN)
    ref = dist.ensemble_stats(tloader.load_levels(
        "benchmarks/v1.0/append-still"))
    got = dist.ensemble_stats(gen)
    dist.compare(ref, got, "append-still")
    assert (got["blue_goals"] > 0).mean() > 0.9
    assert (got["possible"] > 0).all()


def test_partitioned_factory_matches_reference_archive():
    """The batched multi-region factory on the CPU (host scaffolds, the
    port's annealer, ``build_bank_from_arrays``) against the append-still
    archive: the gates and invariants of
    ``tests/test_procgen_distribution.py``'s factory test."""
    n = 16
    bank, conv = tb.gen_partitioned_levels("append-still", num_levels=n,
                                           seed=5, iters=1500, device="cpu")
    conv = conv.numpy()
    assert conv.mean() >= 0.5, f"only {conv.mean():.2f} converged"
    board, goals = bank.board.numpy(), bank.goals.numpy()
    mp = bank.min_performance.numpy()
    gen = [dict(board=board[..., i], goals=goals[..., i],
                min_performance=float(mp[i])) for i in range(n) if conv[i]]
    got = dist.ensemble_stats(gen)
    dist.compare(dist.ensemble_stats(tloader.load_levels(
        "benchmarks/v1.0/append-still")), got, "factory/append-still")
    assert bank.static_goals and bank.spawnless and not bank.simple_goals
    assert ((board & C.AGENT) != 0).sum(axis=(0, 1)).tolist() == [1] * n
    assert ((board & C.EXIT) != 0).sum(axis=(0, 1)).tolist() == [1] * n
