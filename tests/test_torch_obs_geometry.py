"""The launch geometry of the view kernel (``obs.view_geometry``: S4 and
the observation unpack), of S5 (``obs_micro.nbsum_geometry``) and of the
observation sum (``obs.sum_blocks``), held on the CPU to the kernels'
limits in ``csrc/view_kernels.cu``, ``csrc/obs_micro.cu`` and
``csrc/obs_sum.cu``."""

import pytest
import torch

from safelife_torch.ops import _build
from safelife_torch.ops import obs
from safelife_torch.ops import obs_micro as om

# One thread keeps torch from leaving an OpenMP pool in the test process
# that slows the JAX tests run after it.
torch.set_num_threads(1)

VIEWS = ((15, 15), (7, 9), (1, 1), (26, 26), (33, 33), (38, 38), (39, 39),
         (60, 60), (120, 120), (128, 128))
CHANNELS = (None, tuple(range(15)), (0, 3, 12), (14, 2, 7), tuple(range(16)))
BATCHES = (65536, 4096, 1001, 33, 7)


def _unit(channels):
    return 2 if channels is None else len(channels)


@pytest.mark.parametrize("channels", CHANNELS)
@pytest.mark.parametrize("vh,vw", VIEWS)
def test_view_slab(vh, vw, channels):
    """E divides the block's threads, is a multiple of 16 wherever a slab
    of 16 fits, and no wider slab leaves two blocks an SM; the
    shared bytes fit 227 KB; the streamed variant exactly where no slab of
    8 fits."""
    cells = vh * vw
    geo = obs.view_geometry(vh, vw, 4096, channels)
    if obs.view_smem(cells, 8, channels) > _build.SMEM_PER_BLOCK:
        assert not geo["staged"] and not geo["vector"]
        assert not geo["bulk"] and geo["smem"] == 0
        assert geo["threads"] == obs.VIEW_STREAM_THREADS
        return
    assert geo["staged"] and geo["threads"] == obs.VIEW_THREADS
    e = geo["envs"]
    assert e in obs.VIEW_ENVS and obs.VIEW_THREADS % e == 0
    assert geo["smem"] == obs.view_smem(cells, e, channels)
    assert geo["smem"] <= _build.SMEM_PER_BLOCK
    assert geo["blocks"] == _build.slab_blocks(geo["smem"])
    if obs.view_smem(cells, 16, channels) <= _build.SMEM_PER_BLOCK:
        assert e % 16 == 0
    for wider in (w for w in obs.VIEW_ENVS if w > e):
        smem = obs.view_smem(cells, wider, channels)
        assert smem > _build.SMEM_PER_BLOCK or _build.slab_blocks(smem) < 2


def test_view_main_shape():
    """The step's unpack at 15x15 with 15 channels: 16 environments a
    block (54,000 output bytes, a multiple of 16), three blocks an SM;
    the KEEP epilogue 32 environments."""
    geo = obs.view_geometry(15, 15, 65536, tuple(range(15)))
    assert (geo["envs"], geo["smem"], geo["blocks"]) == (16, 68640, 3)
    assert geo["vector"] and geo["bulk"]
    assert obs.view_geometry(15, 15, 16384, None)["envs"] == 32


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("channels", CHANNELS)
@pytest.mark.parametrize("vh,vw", ((15, 15), (7, 9), (33, 33)))
def test_view_vector_paths(vh, vw, channels, b):
    """16-byte staging only where B % 8 == 0 and the view is aligned; the
    bulk copy only where a block's range, E * vh * vw * C bytes (2 a cell
    for KEEP), is a multiple of 16; narrow accesses of the same kernel
    otherwise."""
    for vector in (True, False):
        geo = obs.view_geometry(vh, vw, b, channels, vector)
        assert geo["vector"] == (vector and b % 8 == 0)
        assert geo["bulk"] == (
            geo["envs"] * vh * vw * _unit(channels) % 16 == 0)


def test_view_channels_checked():
    """The kernel takes 1 to 16 channels of bits 0-15: other lists raise
    before a launch (the plain version takes them on the CPU)."""
    view = torch.zeros((3, 3, 8), dtype=torch.uint16)
    for channels in ((), tuple(range(17)), (16,), (-1,)):
        with pytest.raises(ValueError, match="channels of bits"):
            obs.launch_view(view, channels, "test")


SIDES = (1, 2, 3, 5, 7, 26, 40, 41, 53, 69, 70, 72, 98, 99, 100, 120, 121,
         128)


@pytest.mark.parametrize("planes", om.PLANES)
@pytest.mark.parametrize("width", om.WIDTHS)
@pytest.mark.parametrize("side", SIDES)
def test_nbsum_slab(side, width, planes):
    """S5 stages 2 bytes of cells an environment, whatever the width and
    planes: the shared bytes fit 227 KB, E is the widest slab that leaves
    two blocks an SM, the parts of a row cover it without an empty one,
    the threads (a thread an environment at least) share every part of
    every row of each lane word evenly within the block's limit, and the
    streamed variant runs exactly where no slab of 8 fits."""
    geo = om.nbsum_geometry(side, side, 4096, width, planes)
    if side * side * 8 * 2 > _build.SMEM_PER_BLOCK:
        assert not geo["staged"] and not geo["vector"]
        assert geo["threads"] == om.NB_STREAM_THREADS and geo["smem"] == 0
        return
    assert geo["staged"] and geo["vector"]
    e = geo["envs"]
    assert e in om.NB_ENVS
    assert geo["smem"] == side * side * e * 2 <= _build.SMEM_PER_BLOCK
    for wider in (w for w in om.NB_ENVS if w > e):
        smem = side * side * wider * 2
        assert smem > _build.SMEM_PER_BLOCK or _build.slab_blocks(smem) < 2
    parts = geo["parts"]
    length = -(-side // parts)
    assert 1 <= parts <= side and (parts - 1) * length < side
    words = e // om._LANES[width]
    assert e <= geo["threads"] == words * geo["slots"] <= om.NB_MAX_THREADS
    walks = [len(range(s, side * parts, geo["slots"]))
             for s in range(geo["slots"])]
    assert sum(walks) == side * parts and max(walks) - min(walks) <= 1
    if parts > 1:
        assert words * side * parts // 2 < om.NB_MIN_THREADS


def test_nbsum_main_shape():
    """26x26 boards: 32 environments a block (5 blocks an SM by shared
    memory), 416 threads at every width: 13 threads of two rows each per
    int32 lane, 26 of a row per uint16 pair, 52 of half a row per uint8
    quad."""
    for width, slots, parts in (("int32", 13, 1), ("uint16", 26, 1),
                                ("uint8", 52, 2)):
        for planes in om.PLANES:
            geo = om.nbsum_geometry(26, 26, 16384, width, planes)
            assert (geo["envs"], geo["blocks"], geo["threads"]) == (32, 5,
                                                                    416)
            assert (geo["slots"], geo["parts"]) == (slots, parts)


@pytest.mark.parametrize("b", [16384, 65536, 1004, 1001, 8, 7])
def test_nbsum_vector_path(b):
    """16-byte staging where B % 8 == 0 and the board is aligned; the
    2-byte path of the same kernel otherwise."""
    for width in om.WIDTHS:
        for planes in om.PLANES:
            assert om.nbsum_geometry(26, 26, b, width, planes)["vector"] == (
                b % 8 == 0)
            assert not om.nbsum_geometry(26, 26, b, width, planes,
                                         False)["vector"]


@pytest.mark.parametrize("nbytes", [1, 15, 16, 16385, 2**20,
                                    65536 * 15 * 15 * 15, 2**33])
def test_sum_blocks(nbytes):
    """At least one block, at most SUM_BLOCKS_PER_SM an SM, and enough
    threads for every 16-byte vector with SUM_UNROLL in flight up to the
    cap."""
    blocks = obs.sum_blocks(nbytes)
    cap = obs.SUM_BLOCKS_PER_SM * _build.SM_COUNT
    assert 1 <= blocks <= cap
    per_block = obs.SUM_THREADS * obs.SUM_UNROLL * 16
    assert blocks == cap or blocks * per_block >= nbytes
