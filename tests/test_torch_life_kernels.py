"""The plain versions of kernels K4-K8 (the CA rule variants) against the
TPU kernels run in interpret mode and against the general rule, bit for
bit, and the plain Philox spawn draws."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import safelife_tpu.cells as C
from safelife_torch.ops import life as tlife
from safelife_torch.ops import life_kernels, rng
from safelife_tpu.ops import life_pallas

# The tensors here are small.  One thread keeps torch from leaving an
# OpenMP pool in the test process that slows the JAX tests run after it.
torch.set_num_threads(1)

B = 128
INTERP = life_pallas.interpret_params()
FLAGS = [C.ALIVE, C.AGENT, C.PUSHABLE, C.DESTRUCTIBLE, C.FROZEN,
         C.PRESERVING, C.INHIBITING, C.EXIT, C.COLOR_R, C.COLOR_G, C.COLOR_B,
         C.PULLABLE]
# Goal boards the bank flags certify: simple (no PRESERVING, INHIBITING,
# SPAWNING or EXIT) and spawn-simple (SPAWNING allowed).
SIMPLE = [C.ALIVE, C.DESTRUCTIBLE, C.FROZEN, C.PUSHABLE, C.PULLABLE,
          C.COLOR_R, C.COLOR_G, C.COLOR_B]
SPAWN_SIMPLE = SIMPLE + [C.SPAWNING]


def soup(rng_, shape, flags=FLAGS, density=0.15):
    """Random boards with each of ``flags`` set at ``density``."""
    board = np.zeros(shape, np.uint16)
    for f in flags:
        board |= np.uint16(f) * (rng_.random(shape) < density).astype(
            np.uint16)
    return board


def spawnless_soup(rng_, shape, density=0.15):
    """Random boards with every flag except spawning."""
    return soup(rng_, shape, FLAGS, density)


def test_advance_spawnless_matches_pallas_interpret():
    rng_ = np.random.RandomState(41)
    board = spawnless_soup(rng_, (26, 26, 128))
    jb, tb = jnp.asarray(board), torch.as_tensor(board)
    for step in range(6):
        jb = life_pallas.advance_spawnless(jb, interpret=INTERP)
        tb = life_kernels.advance_spawnless(tb)
        assert tb.dtype == torch.uint16
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb),
                                      err_msg=f"step {step}")


def test_advance_spawnless_matches_general_rule():
    rng_ = np.random.RandomState(42)
    board = torch.as_tensor(spawnless_soup(rng_, (17, 23, 37), density=0.2))
    no_spawn = torch.zeros(board.shape, dtype=torch.bool)
    for step in range(6):
        want = tlife.advance_board(board, no_spawn)
        board = life_kernels.advance_spawnless_plain(board)
        assert torch.equal(board, want), f"step {step}"


def test_advance_with_field_matches_pallas_interpret():
    """K5: the full rule with a spawn field, spawners on the board."""
    rng_ = np.random.RandomState(43)
    board = soup(rng_, (26, 26, B), FLAGS + [C.SPAWNING])
    jb, tb = jnp.asarray(board), torch.as_tensor(board)
    for step in range(4):
        field = rng_.random(board.shape) < 0.35
        jb = life_pallas.advance_with_field(jb, jnp.asarray(field),
                                            interpret=INTERP)
        want = tlife.advance_board(tb, torch.as_tensor(field))
        tb = life_kernels.advance_with_field(tb, torch.as_tensor(field))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb),
                                      err_msg=f"step {step}")
        assert torch.equal(tb, want), f"step {step}: general rule"


def test_advance_simple_matches_pallas_interpret():
    """K6 on certified simple goal boards; the certification is
    inductive and the rule equals the general one there."""
    rng_ = np.random.RandomState(44)
    goals = soup(rng_, (26, 26, B), SIMPLE, 0.2)
    jg, tg = jnp.asarray(goals), torch.as_tensor(goals)
    no_spawn = torch.zeros(goals.shape, dtype=torch.bool)
    forbidden = C.PRESERVING | C.INHIBITING | C.SPAWNING | C.EXIT
    for step in range(4):
        jg = life_pallas.advance_simple(jg, interpret=INTERP)
        want = tlife.advance_board(tg, no_spawn)
        tg = life_kernels.advance_simple(tg)
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg),
                                      err_msg=f"step {step}")
        assert torch.equal(tg, want), f"step {step}: general rule"
        assert not (tg.numpy() & forbidden).any()


def test_advance_pair_spawnsimple_matches_pallas_interpret():
    """K7: a full-rule board and spawn-simple goals with given fields."""
    rng_ = np.random.RandomState(45)
    board = soup(rng_, (26, 26, B), FLAGS + [C.SPAWNING])
    goals = soup(rng_, (26, 26, B), SPAWN_SIMPLE, 0.2)
    jb, jg = jnp.asarray(board), jnp.asarray(goals)
    tb, tg = torch.as_tensor(board), torch.as_tensor(goals)
    for step in range(4):
        fb = rng_.random(board.shape) < 0.35
        fg = rng_.random(board.shape) < 0.35
        jb, jg = life_pallas.advance_pair_spawnsimple_with_fields(
            jb, jnp.asarray(fb), jg, jnp.asarray(fg), interpret=INTERP)
        tfb, tfg = torch.as_tensor(fb), torch.as_tensor(fg)
        want = (tlife.advance_board(tb, tfb), tlife.advance_board(tg, tfg))
        tb, tg = life_kernels.advance_pair_spawnsimple_with_fields(
            tb, tfb, tg, tfg)
        for got, jax_out, general, what in ((tb, jb, want[0], "board"),
                                            (tg, jg, want[1], "goals")):
            np.testing.assert_array_equal(got.numpy(), np.asarray(jax_out),
                                          err_msg=f"{what} step {step}")
            assert torch.equal(got, general), f"{what} step {step}"


def test_advance_both_matches_pallas_interpret():
    """K8 with per-lane spawn_prob 0 or 1: the interpret-mode TPU PRNG
    returns zero bits, so the TPU kernel spawns wherever p > 0, as Philox
    against a threshold of 2**16 does at p = 1."""
    rng_ = np.random.RandomState(46)
    board = soup(rng_, (26, 26, B), FLAGS + [C.SPAWNING])
    goals = soup(rng_, (26, 26, B), FLAGS + [C.SPAWNING])
    p = np.where(np.arange(B) % 2 == 0, 1.0, 0.0).astype(np.float32)
    jb, jg = jnp.asarray(board), jnp.asarray(goals)
    tb, tg = torch.as_tensor(board), torch.as_tensor(goals)
    tp = torch.as_tensor(p)
    for step in range(3):
        jb, jg = life_pallas.advance_both(jb, jg, jnp.asarray(p), seed=step,
                                          interpret=INTERP)
        tb, tg = life_kernels.advance_both(tb, tg, tp, step)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb),
                                      err_msg=f"board step {step}")
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg),
                                      err_msg=f"goals step {step}")


def test_philox_known_answers():
    """Philox4x32-10 against the Random123 known-answer vectors."""
    vectors = [
        ((0, 0, 0, 0), (0, 0),
         (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
        ((0xffffffff,) * 4, (0xffffffff,) * 2,
         (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
        ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
         (0xa4093822, 0x299f31d0),
         (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
    ]
    for counter, key, want in vectors:
        got = rng.philox4x32(
            tuple(torch.tensor([c], dtype=torch.int64) for c in counter),
            tuple(torch.tensor([k], dtype=torch.int64) for k in key))
        assert tuple(int(g) for g in got) == want


def _seed(s):
    return torch.tensor([s], dtype=torch.int32)


@pytest.mark.parametrize("seed,shape", [
    (7, (8, 1, 128)), (-5, (3, 5, 17)), (2**31 - 1, (26, 26, 4))])
def test_philox_words_plain_is_spawn_words(seed, shape):
    """T1's plain path: ``spawn_words`` as int32 bits, the field the spawn
    draws slice."""
    words = rng.philox_words(_seed(seed), shape)
    assert words.dtype == torch.int32 and tuple(words.shape) == shape
    assert torch.equal(words.to(torch.int64) & rng.MASK32,
                       rng.spawn_words(_seed(seed), shape, "cpu"))


@pytest.mark.parametrize("draw", ["u24", "pair"])
def test_spawn_draws(draw):
    """The same seed reproduces, seeds differ, the rate at p = 0.3 is
    within 5 sigma on the 8x8x256 fixture, p = 0 never and p = 1 always
    spawn."""
    shape = (8, 8, 256)

    def fields(seed, p):
        probs = torch.full((shape[2],), p, dtype=torch.float32)
        if draw == "u24":
            return (rng.spawn_field24(_seed(seed), probs, shape),)
        return rng.spawn_field_pair(_seed(seed), probs, shape)

    a, again, other = fields(0, 0.3), fields(0, 0.3), fields(1, 0.3)
    assert all(map(torch.equal, a, again))
    assert not any(map(torch.equal, a, other))
    sigma = (0.3 * 0.7 / a[0].numel()) ** 0.5
    for field in a:
        assert abs(field.double().mean().item() - 0.3) < 5 * sigma
    if draw == "pair":
        assert not torch.equal(a[0], a[1])  # the halves are not one field
    assert not any(f.any() for f in fields(2, 0.0))
    assert all(f.all() for f in fields(2, 1.0))


def test_spawn_draw_quantisation():
    """The thresholds are float32 products truncated to int32, and the
    fields equal the words' 24-bit and 16-bit slices against them."""
    probs = torch.tensor([0.0, 0.3, 0.5, 1.0, 1e-7], dtype=torch.float32)
    assert rng.threshold(probs, 24).tolist() == [
        0, int(np.float32(0.3) * np.float32(2**24)), 2**23, 2**24, 1]
    assert rng.threshold(probs, 16).tolist()[:4] == [
        0, int(np.float32(0.3) * np.float32(2**16)), 2**15, 2**16]
    shape = (5, 7, 5)
    words = rng.spawn_words(_seed(9), shape, "cpu")
    assert int(words.min()) >= 0 and int(words.max()) < 2**32
    u24 = rng.spawn_field24(_seed(9), probs, shape)
    assert torch.equal(u24, ((words >> 8) & 0xFFFFFF)
                       < rng.threshold(probs, 24))
    lo, hi = rng.spawn_field_pair(_seed(9), probs, shape)
    t16 = rng.threshold(probs, 16)
    assert torch.equal(lo, (words & 0xFFFF) < t16)
    assert torch.equal(hi, (words >> 16) < t16)


def test_advance_both_prng_check():
    """The bench's PRNG check through the plain K8 on the CPU."""
    from safelife_torch import bench
    rate = bench.check_prng(torch.device("cpu"))
    assert abs(rate - 0.3) < 0.05
