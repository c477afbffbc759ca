"""The launch geometry of K2/K3 (``env_step_kernels.advance_geometry``:
staged slabs, or the streamed variant for boards no slab fits) and the
16-byte path test of K1 and K2/K3 (``vector_path``): the Python that
decides how ``csrc/env_step_kernels.cu`` is launched, held on the CPU to
the kernel's limits."""

import pytest
import torch

from safelife_torch.ops import env_step_kernels as esk

# The tensors here are small.  One thread keeps torch from leaving an
# OpenMP pool in the test process that slows the JAX tests run after it.
torch.set_num_threads(1)

DYNAMIC = ("simple", "spawn_simple", "general")


def cells_of_threads(h, w, geo):
    """The cells each thread of one environment takes in pass 1, as the
    kernel walks them: row segments s, s + slots, ... of ``seg`` cells."""
    seg, slots = geo["seg"], geo["slots"]
    per_row = -(-w // seg)
    out = []
    for s in range(slots):
        cells = []
        for item in range(s, h * per_row, slots):
            r, q = divmod(item, per_row)
            cells += [r * w + c for c in range(q * seg, min(q * seg + seg, w))]
        out.append(cells)
    return out


@pytest.mark.parametrize("rule", esk.RULES)
def test_main_shape_fits_every_rule(rule):
    """(26, 26) at the main batch: slabs of 16 environments, two blocks an
    SM, the 16-byte path.  The view takes no shared memory (it is gathered
    from the final slabs), so the 15x15 and 33x33 views launch with this
    geometry; chip_smoke.py holds both to the plain version on the card."""
    geo = esk.advance_geometry(26, 26, rule, 65536)
    slabs = 5 if rule in DYNAMIC else 4
    assert geo == dict(envs=16, slots=26, seg=26, threads=416,
                       smem=slabs * 26 * 26 * 16 * 2, blocks=2, staged=True,
                       vector=True)


@pytest.mark.parametrize("b", [1001, 7, 33, 4097])
def test_scalar_path_for_ragged_batches(b):
    for rule in esk.RULES:
        geo = esk.advance_geometry(26, 26, rule, b)
        assert not geo["vector"]
        assert geo["staged"] and geo["envs"] == 16


def test_vector_path_needs_aligned_tensors():
    board = torch.zeros((26, 26, 64), dtype=torch.uint16)
    buf = torch.zeros(board.numel() + 1, dtype=torch.uint16)
    shifted = buf[1:].view(board.shape)
    assert esk.vector_path(64, board, None)
    assert not esk.vector_path(64, board, shifted)
    assert not esk.vector_path(63, board)
    geo = esk.advance_geometry(26, 26, "static", 64,
                               esk.vector_path(64, board, shifted))
    assert not geo["vector"]
    assert esk.advance_geometry(26, 26, "static", 64, True)["vector"]


@pytest.mark.parametrize("envs", esk.ADVANCE_ENVS)
def test_every_slab_width_fits_the_main_shape(envs):
    geo = esk._slab_geometry(26, 26, "general", envs)
    assert geo["envs"] == envs
    assert geo["threads"] == {32: 416, 16: 416, 8: 208}[envs]
    assert geo["blocks"] == {32: 1, 16: 2, 8: 4}[envs]


@pytest.mark.parametrize("h,w", [(1, 1), (3, 5), (7, 3), (9, 40), (26, 26),
                                 (33, 33), (25, 64), (40, 40), (64, 17),
                                 (100, 9)])
@pytest.mark.parametrize("rule", ["static", "general"])
def test_geometry_within_kernel_limits(h, w, rule):
    """Within MAX_ENVS, MAX_THREADS, the 227 KB a block may use and the
    64-bit exit mask, and every cell of an environment taken by exactly
    one thread."""
    geo = esk.advance_geometry(h, w, rule, 4096)
    assert geo["staged"]
    assert geo["envs"] in esk.ADVANCE_ENVS
    assert geo["threads"] == geo["envs"] * geo["slots"]
    assert geo["threads"] <= esk.ADVANCE_MAX_THREADS
    assert 1 <= geo["seg"] <= 32
    assert geo["smem"] == (4 if rule == "static" else 5) * h * w * \
        geo["envs"] * 2
    assert geo["smem"] + esk._ADVANCE_STATIC_SMEM <= esk.SMEM_PER_BLOCK
    taken = cells_of_threads(h, w, geo)
    assert max(map(len, taken)) <= 64
    assert sorted(c for cells in taken for c in cells) == list(range(h * w))


def test_packed_sums_stay_in_range():
    """K2/K3 sum points * 2^16 + score and effect + possible * 2^16 in one
    int32 each over a row segment, then add the four halves to the
    environment's sums: the widest segment keeps every half in range
    (points within [-3, 5] a cell, the rest within [0, 1]), on every board
    width, staged or streamed."""
    seg = esk._MAX_SEG
    assert seg < 2**15 and (5 * seg + 1) * 2**16 < 2**31
    for w in (1, 26, 31, 32, 33, 64, 65, 200, 1000):
        for h in (1, 26, 64):
            assert esk.advance_geometry(h, w, "general", 64)["seg"] <= seg


@pytest.mark.parametrize("shape,envs", [((128, 128), None), ((60, 60), 32),
                                        ((26, 26), 12)])
def test_raises_where_no_slab_fits(shape, envs):
    """A slab width that does not fit the board (the smallest one on a
    128x128 board, 32 on a 60x60 board) or that the kernel does not take
    raises before any launch; the wrapper then takes a narrower slab, or
    the streamed variant, so every board steps."""
    with pytest.raises(ValueError):
        esk._slab_geometry(*shape, "general", envs or esk.ADVANCE_ENVS[-1])
    geo = esk.advance_geometry(*shape, "general", 4096)
    assert geo["staged"] == (shape == (26, 26))


@pytest.mark.parametrize("rule,side", [("static", 60), ("general", 53)])
def test_largest_staged_square(rule, side):
    """Four slabs of 8 environments fit up to 60x60 boards (static goal
    rules), five up to 53x53 (dynamic goal rules)."""
    assert esk.advance_geometry(side, side, rule, 4096)["staged"]
    assert not esk.advance_geometry(side + 1, side + 1, rule, 4096)["staged"]


@pytest.mark.parametrize("h,w", [(54, 54), (64, 64), (128, 128), (3, 4000),
                                 (300, 20)])
@pytest.mark.parametrize("rule", ["static", "general"])
def test_streamed_where_no_slab_fits(h, w, rule):
    """Boards too large for a slab of 8 environments take the streamed
    variant: 32 environments a block, no shared slabs, the 2-byte path,
    within the streamed block's threads, every cell of an environment
    taken by exactly one thread."""
    geo = esk.advance_geometry(h, w, rule, 4096)
    if (h, w) == (54, 54) and rule == "static":
        assert geo["staged"]
        return
    assert not geo["staged"] and not geo["vector"]
    assert geo["envs"] == esk.ADVANCE_ENVS[0] and geo["smem"] == 0
    assert geo["threads"] == geo["envs"] * geo["slots"]
    assert geo["threads"] <= esk.ADVANCE_MAX_THREADS
    taken = cells_of_threads(h, w, geo)
    assert sorted(c for cells in taken for c in cells) == list(range(h * w))
