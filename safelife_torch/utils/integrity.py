"""Silent-corruption detection for the device compute path (the port's
counterpart of ``safelife_tpu.utils.integrity``).

A failing accelerator can keep running at full speed while it returns
wrong values for part of the computation: the JAX package met one whose
goal-scoring chain came back all zero while the CA advance stayed right,
so every prune task read as completed from the first random episode.
Nothing crashed.

The defence is a golden self-check.  A fixture of rich random boards is
built on the host, and every checked quantity is computed there by
independent numpy twins (:mod:`..ops.life_numpy`, the ``*_np`` scoring
twins, a numpy Philox).  :func:`check_device_integrity` reruns them
through the port's ops on the device: the CA advance, the point,
performance and possible-score chains, the side-effect count, the
full-range uint16 reset gather (plain indexing through ``bits16``, as
``LevelBank.take`` does) and, on CUDA, kernels K4 (the spawnless
advance) and T1 (the Philox word field).  Every checked op is integer
valued, so the comparison is bit for bit, and any mismatch raises
:class:`DeviceIntegrityError` with a field-by-field report.
:func:`check_bank_reset_integrity` runs the reset gather over a real
bank.  ``SAFELIFE_INTEGRITY=0`` turns both off.
"""

import logging
import os

import numpy as np
import torch

from .. import bits16, resolve_device
from .. import cells as C


class DeviceIntegrityError(RuntimeError):
    """The device returned values that disagree with host goldens."""


_B, _H, _W = 128, 26, 26
_FLAGS = np.array(
    [C.ALIVE, C.AGENT, C.PUSHABLE, C.DESTRUCTIBLE, C.FROZEN,
     C.PRESERVING, C.INHIBITING, C.EXIT,
     C.COLOR_R, C.COLOR_G, C.COLOR_B, C.PULLABLE], dtype=np.uint16)
# The Philox probe: seed 7, an (8, 128) tile of words (8 cells, 128
# environments), as the TPU's PRNG probe draws.
PROBE_SEED = 7
PROBE_SHAPE = (8, 1, 128)
# Device output -> the golden it is held to.
_GOLDEN_OF = {"adv_kernel": "adv"}

_fixture_cache = {}


def _enabled():
    return os.environ.get("SAFELIFE_INTEGRITY", "1") != "0"


def _soup(rng, shape, density=0.15):
    board = np.zeros(shape, np.uint16)
    for f in _FLAGS:
        board |= f * (rng.random(shape) < density).astype(np.uint16)
    return board


def _philox_words_np(seed, shape):
    """Philox4x32-10's first word at counter (r * W + c, b, 0, 0) and key
    (seed, 0), in uint64 numpy: the host twin of T1."""
    h, w, b = shape
    mask = np.uint64(0xFFFFFFFF)
    c0 = np.broadcast_to(np.arange(h * w, dtype=np.uint64).reshape(h, w, 1),
                         shape)
    c1 = np.broadcast_to(np.arange(b, dtype=np.uint64), shape)
    c2 = c3 = np.zeros(shape, np.uint64)
    k0, k1 = np.uint64(seed), np.uint64(0)
    for i in range(10):
        if i:
            k0 = (k0 + np.uint64(0x9E3779B9)) & mask
            k1 = (k1 + np.uint64(0xBB67AE85)) & mask
        p0 = np.uint64(0xD2511F53) * c0
        p1 = np.uint64(0xCD9E8D57) * c2
        c0, c1, c2, c3 = ((p1 >> np.uint64(32)) ^ c1 ^ k0, p1 & mask,
                          (p0 >> np.uint64(32)) ^ c3 ^ k1, p0 & mask)
    return c0.astype(np.uint32).view(np.int32)


def _build_fixture():
    """Host inputs and expected outputs for every checked device op (the
    same seed, sizes and goldens as the JAX package's guard)."""
    from ..ops import life_numpy, scoring

    rng = np.random.RandomState(20260817)
    board = _soup(rng, (_H, _W, _B))
    goals = _soup(rng, (_H, _W, _B), density=0.1)
    init_board = _soup(rng, (_H, _W, _B))
    baseline = rng.randint(-8, 9, _B).astype(np.int32)

    # The fixture holds no spawner, so the advance is deterministic.
    adv = np.stack([life_numpy.advance_board_reference(
        board[..., i], np.ones((_H, _W))) for i in range(_B)], axis=-1)

    pts = scoring.current_points_np(
        np.moveaxis(board, -1, 0), np.moveaxis(goals, -1, 0))
    perf = scoring.performance_score_np(
        np.moveaxis(board, -1, 0), np.moveaxis(goals, -1, 0))
    poss = scoring.possible_score_np(np.moveaxis(goals, -1, 0))

    # The side-effect count, restated in numpy.
    b = board & ~np.uint16(C.PLAYER)
    sb = init_board & ~np.uint16(C.PLAYER)
    exit_mask = (init_board & C.EXIT) != 0
    b = np.where(exit_mask, sb, b)
    red = np.uint16(C.ALIVE | C.COLOR_R)
    non = ((b == sb)
           | (((sb & red) == red) & ((b & red) != red))
           | (((goals & C.COLORS) == C.COLOR_B) & ((b & red) == C.ALIVE)))
    side = (~non).sum((0, 1)).astype(np.int32)

    # The reset gather over full-range uint16 values, so a lossy path
    # (one that rounds or drops high bits) fails bit for bit.
    gather_src = rng.randint(0, 1 << 16, (_H, _W, 100)).astype(np.uint16)
    gather_idx = rng.randint(0, 100, _B).astype(np.int32)
    gather_exp = gather_src[..., gather_idx]

    return dict(board=board, goals=goals, init_board=init_board,
                baseline=baseline, gather_src=gather_src,
                gather_idx=gather_idx,
                expected=dict(adv=adv, points=pts, completed=perf - baseline,
                              possible=poss - baseline, side=side,
                              gather=gather_exp,
                              philox=_philox_words_np(PROBE_SEED,
                                                      PROBE_SHAPE)))


def _device_outputs(board, goals, init_board, baseline, gather_src,
                    gather_idx):
    """The checked ops on the inputs' device; on CUDA also K4 and T1."""
    from ..ops import life, life_kernels, rng, scoring

    dev = board.device
    adv = life.advance_board(board, torch.zeros(board.shape, dtype=torch.bool,
                                                device=dev))
    completed, possible = scoring.performance_ratio(board, goals, baseline)
    out = dict(
        adv=adv,
        points=scoring.current_points(board, goals),
        completed=completed,
        possible=possible,
        side=scoring.side_effect_count(board, init_board, goals),
        gather=bits16(gather_src)[..., gather_idx.long()].view(torch.uint16),
        philox=rng.philox_words(
            torch.tensor([PROBE_SEED], dtype=torch.int32, device=dev),
            PROBE_SHAPE))
    if dev.type == "cuda":
        out["adv_kernel"] = life_kernels.advance_spawnless(board)
    return out


def _host(x):
    if x.dtype == torch.uint16:
        return bits16(x).cpu().numpy().view(np.uint16)
    return x.cpu().numpy()


def _device_name(device):
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def _fail(msg, raise_on_fail):
    if raise_on_fail:
        raise DeviceIntegrityError(msg)
    logging.getLogger(__name__).error(msg)
    return False


def check_device_integrity(device=None, raise_on_fail=True):
    """Compare the port's device ops against host goldens on ``device``
    (``cuda`` unless the caller passes another).

    Returns True when everything matches; on a mismatch raises
    :class:`DeviceIntegrityError` (or returns False with
    ``raise_on_fail=False``).  ``SAFELIFE_INTEGRITY=0`` disables it.
    """
    if not _enabled():
        return True
    device = resolve_device(device)
    if "fixture" not in _fixture_cache:
        _fixture_cache["fixture"] = _build_fixture()
    fx = _fixture_cache["fixture"]
    out = _device_outputs(*(torch.as_tensor(fx[k], device=device) for k in (
        "board", "goals", "init_board", "baseline", "gather_src",
        "gather_idx")))
    bad = []
    for k, got in out.items():
        got = _host(got)
        want = np.asarray(fx["expected"][_GOLDEN_OF.get(k, k)])
        if got.shape != want.shape or not np.array_equal(got, want):
            n = int((got != want).sum()) if got.shape == want.shape else -1
            bad.append(f"{k}: {n}/{want.size} values wrong "
                       f"(e.g. got {got.reshape(-1)[0]!r} "
                       f"want {want.reshape(-1)[0]!r})")
    if bad:
        return _fail(
            f"device integrity check FAILED on {_device_name(device)}: "
            + "; ".join(bad) + " -- the device is returning silently wrong "
            "results; results from this process are not trustworthy.",
            raise_on_fail)
    return True


def check_bank_reset_integrity(bank, sample=8, raise_on_fail=True):
    """The reset gather on a real level bank: ``bank.take`` of ``sample``
    levels on the bank's device against a host numpy take of the same
    levels, leaf by leaf, bit for bit."""
    if not _enabled():
        return True
    idx = np.linspace(0, bank.num_levels - 1, sample).astype(np.int32)
    dev = bank.take(torch.as_tensor(idx, device=bank.device)).to_numpy()
    host = bank.to_numpy()
    bad = [f"{name}: {int((np.asarray(got) != host[name][..., idx]).sum())}"
           " wrong"
           for name, got in dev.items()
           if isinstance(got, np.ndarray)
           and not np.array_equal(got, host[name][..., idx])]
    if bad:
        return _fail(
            f"bank reset-gather integrity FAILED on "
            f"{_device_name(bank.device)}: " + "; ".join(bad)
            + " -- level state is corrupted at reset; aborting.",
            raise_on_fail)
    return True
