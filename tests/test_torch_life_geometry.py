"""The launch geometry of the staged-slab kernels K4-K8
(``life_kernels.rule_geometry``) and S3 (``obs_micro.crop_geometry``):
slab widths, the streamed threshold and the 16-byte path, held on the CPU
to the kernels' limits in ``csrc/life_kernels.cu`` and
``csrc/obs_micro.cu``."""

import pytest
import torch

from safelife_torch.ops import _build
from safelife_torch.ops import life_kernels as lk
from safelife_torch.ops import obs_micro as om

# The tensors here are small.  One thread keeps torch from leaving an
# OpenMP pool in the test process that slows the JAX tests run after it.
torch.set_num_threads(1)

ONE_WORD = ("K4_advance_spawnless", "K6_advance_simple")
TWO_WORDS = ("K5_advance_with_field", "K7_advance_pair_fields",
             "K8_advance_both")
# Slab width by board side, None where no slab of 8 fits (streamed): the
# one-word rules stage 6 bytes an environment and cell, the full rule 10.
SLAB_WIDTH = {ONE_WORD: {26: 16, 40: 8, 53: 8, 60: 8, 64: 8},
              TWO_WORDS: {26: 16, 40: 8, 53: 8, 60: None, 64: None}}


@pytest.mark.parametrize("side", [26, 40, 53, 60, 64])
@pytest.mark.parametrize("kernel", ONE_WORD + TWO_WORDS)
def test_slab_width_by_board(kernel, side):
    """E is the widest slab that leaves two blocks an SM, else the widest
    that fits; the streamed variant where none fits."""
    want = SLAB_WIDTH[ONE_WORD if kernel in ONE_WORD else TWO_WORDS][side]
    geo = lk.rule_geometry(side, side, kernel, 4096)
    if want is None:
        assert not geo["staged"] and not geo["vector"]
        assert geo["threads"] == lk.RULE_STREAM_THREADS and geo["smem"] == 0
        return
    per_cell = 2 + lk.RULE_WORD_BYTES[kernel]
    assert geo["staged"] and geo["vector"]
    assert geo["envs"] == want
    assert geo["smem"] == side * side * want * per_cell
    assert geo["slots"] == min(side, lk.RULE_MAX_THREADS // want)
    assert geo["threads"] == want * geo["slots"] <= lk.RULE_MAX_THREADS
    assert (geo["smem"] + lk._RULE_STATIC_SMEM
            <= _build.SMEM_PER_BLOCK)
    wider = [e for e in lk.RULE_ENVS if e > want]
    for e in wider:
        smem = side * side * e * per_cell + lk._RULE_STATIC_SMEM
        assert smem > _build.SMEM_PER_BLOCK or _build.slab_blocks(smem) < 2


@pytest.mark.parametrize("kernel,side", [("K4_advance_spawnless", 69),
                                         ("K6_advance_simple", 69),
                                         ("K5_advance_with_field", 53),
                                         ("K7_advance_pair_fields", 53),
                                         ("K8_advance_both", 53)])
def test_streamed_threshold(kernel, side):
    """The largest square board a slab of 8 environments fits; one cell
    more a side takes the streamed variant, so every board steps."""
    assert lk.rule_geometry(side, side, kernel, 64)["staged"]
    assert not lk.rule_geometry(side + 1, side + 1, kernel, 64)["staged"]
    assert not lk.rule_geometry(3, 30000, kernel, 64)["staged"]


@pytest.mark.parametrize("b", [4096, 4097, 1001, 33, 7, 8])
def test_vector_path_needs_whole_groups(b):
    """16-byte accesses where B % 8 == 0 and the tensors are aligned; the
    2-byte path of the same kernel otherwise."""
    board = torch.zeros((26, 26, b), dtype=torch.uint16)
    buf = torch.zeros(board.numel() + 1, dtype=torch.uint16)
    shifted = buf[1:].view(board.shape)
    aligned = _build.vector_path(b, board)
    assert aligned == (b % 8 == 0)
    assert not _build.vector_path(b, board, shifted)
    for kernel in ONE_WORD + TWO_WORDS:
        assert lk.rule_geometry(26, 26, kernel, b, aligned)["vector"] == \
            aligned
        assert not lk.rule_geometry(26, 26, kernel, b, False)["vector"]
    assert om.crop_geometry(26, 26, b, aligned)["vector"] == aligned
    assert not om.crop_geometry(26, 26, b, False)["vector"]


@pytest.mark.parametrize("h,w", [(1, 1), (3, 5), (7, 3), (26, 26), (5, 70),
                                 (100, 9)])
def test_rule_slots_cover_rows_and_columns(h, w):
    """A thread of each slot takes columns, then rows, of its environment:
    every column and row is taken, within the block's threads."""
    for kernel in ONE_WORD + TWO_WORDS:
        geo = lk.rule_geometry(h, w, kernel, 4096)
        slots = geo["slots"]
        assert 1 <= slots and geo["threads"] <= lk.RULE_MAX_THREADS
        assert sorted(c for s in range(slots) for c in range(s, w, slots)) \
            == list(range(w))
        assert sorted(r for s in range(slots) for r in range(s, h, slots)) \
            == list(range(h))


@pytest.mark.parametrize("side,envs", [(15, 32), (26, 32), (60, 16),
                                       (90, 8), (120, 8), (121, None)])
def test_crop_slab_width(side, envs):
    """S3 stages the board only (2 bytes an environment and cell): E = 32
    at the scripts' 26x26, narrower slabs on larger boards, the streamed
    variant above 120x120."""
    geo = om.crop_geometry(side, side, 16384)
    if envs is None:
        assert not geo["staged"] and not geo["vector"]
        return
    assert geo["staged"] and geo["envs"] == envs
    assert geo["threads"] == om.CROP_THREADS
    assert geo["smem"] == side * side * envs * 2
    assert geo["smem"] + om._CROP_STATIC_SMEM <= _build.SMEM_PER_BLOCK
    assert _build.slab_blocks(geo["smem"] + om._CROP_STATIC_SMEM) >= (
        2 if envs > 8 else 1)
