"""The observation and stencil micro-experiments of ``scripts/obs_micro.py``
as hand-written CUDA kernels (``csrc/obs_micro.cu``), each with its plain
PyTorch version:

* S3 :func:`view_crop`: the agent-centred torus crop of ``(H, W, B)``
  uint16 boards, ``v[i, j, b] = x[(i + rs_b) % H, (j + cs_b) % W, b]``,
  with the shifts in ``si`` rows 0 and 1 (``make_roll_kernel``);
* S4 :func:`view_transpose`: ``(vh, vw, B)`` -> ``(B, vh, vw)``
  (``make_transpose_kernel``), in ``csrc/view_kernels.cu``;
* S5 :func:`nb_sum_planes`: ``sum_p nb3x3(x + p)`` on the torus over
  ``planes`` planes at the width of ``dtype``, wrapping there
  (``make_nbsum_kernel``).

``compute`` (S3, S4) and ``dtype`` (S5) name the variants the script
times: the width the kernel holds its values at.  They leave S3's and
S4's results unchanged; S5 wraps at the width.  S4 is the KEEP epilogue
of the view kernel that also unpacks the step's observation
(:func:`.obs.launch_view`), which holds the tile as uint16 words for both
``compute`` variants.  The wrappers launch the kernels on CUDA tensors
(S3 and S5 with the staged slabs of :func:`crop_geometry` and
:func:`nbsum_geometry`) and run the plain versions on CPU tensors.
"""

import torch

from .. import bits16
from . import _build
from .life import nb_sum
from .obs import launch_view

COMPUTES = ("int32", "uint16")
WIDTHS = ("int32", "uint16", "uint8")
PLANES = (1, 4)
VIEW = (15, 15)
# The bits S5's result keeps (the int32 variant stores its sum as uint16)
# and the environments one 32-bit word of the kernel holds.
_MASK = {"int32": 0xFFFF, "uint16": 0xFFFF, "uint8": 0xFF}
_LANES = {"int32": 1, "uint16": 2, "uint8": 4}


def _check(values, allowed, what):
    if values not in allowed:
        raise ValueError(f"{what} must be one of {allowed}, not {values!r}")


# ---------------------------------------------------------------------------
# S3: the view crop
# ---------------------------------------------------------------------------

def view_crop_plain(x, si, compute="int32", view=VIEW):
    """The plain version of S3: one advanced-indexing gather."""
    _check(compute, COMPUTES, "compute")
    h, w, b = x.shape
    vh, vw = view
    dev = x.device
    rows = torch.remainder(si[0][None, :] + torch.arange(vh, device=dev)[:, None],
                           h)
    cols = torch.remainder(si[1][None, :] + torch.arange(vw, device=dev)[:, None],
                           w)
    lanes = torch.arange(b, device=dev)
    return bits16(x)[rows[:, None, :].long(), cols[None, :, :].long(),
                     lanes].view(torch.uint16)


# S3's launch limits, which csrc/obs_micro.cu checks (CROP_MAX_ENVS,
# CROP_THREADS): staged slab widths E, widest first, and threads a staged
# block; the kernel's static shared array holds two shifts an environment.
CROP_ENVS = (32, 16, 8)
CROP_THREADS = 256
_CROP_STATIC_SMEM = 2 * 4 * CROP_ENVS[0]


def crop_geometry(h, w, b, vector=True):
    """The launch geometry of S3 on (``h``, ``w``, ``b``) boards.

    A staged block keeps the board's slab of E environments in shared
    memory (``smem`` bytes) and gathers their views from it; E is the
    widest of :data:`CROP_ENVS` that leaves room for two blocks on an SM.
    ``vector`` is the 16-byte path (:func:`_build.vector_path` of board and
    view), kept only where ``b % 8 == 0``.  Where no slab of 8 fits, the
    streamed variant reads the board in device memory (``staged`` false).

    Returns a dict of envs, threads, smem, blocks (None when streamed),
    staged and vector.
    """
    slab = _build.pick_slab(h * w, 2, CROP_ENVS, _CROP_STATIC_SMEM)
    if slab is None:
        return dict(envs=1, threads=128, smem=0, blocks=None, staged=False,
                    vector=False)
    return dict(slab, threads=CROP_THREADS, staged=True,
                vector=bool(vector and b % 8 == 0))


def view_crop(x, si, compute="int32", view=VIEW):
    """The ``view`` crop of ``(H, W, B)`` uint16 boards at the shifts in
    ``si`` (2, B) int32: kernel S3 on CUDA, the plain version on the
    CPU."""
    if x.device.type == "cpu":
        return view_crop_plain(x, si, compute, view)
    _check(compute, COMPUTES, "compute")
    _build.check_cuda(x, si, dtypes=(torch.uint16, torch.int32))
    h, w, b = x.shape
    vh, vw = view
    if si.shape != (2, b):
        raise ValueError(f"si must be (2, {b}), not {tuple(si.shape)}")
    out = torch.empty((vh, vw, b), dtype=torch.uint16, device=x.device)
    geo = crop_geometry(h, w, b, _build.vector_path(b, x, out))
    if b:
        _build.launch(f"S3_view_crop[{compute}]", "obs_micro", "sl_view_crop",
                      x.data_ptr(), si.data_ptr(), out.data_ptr(), h, w, b,
                      vh, vw, COMPUTES.index(compute), geo["envs"],
                      int(geo["vector"]), int(geo["staged"]))
    return out


# ---------------------------------------------------------------------------
# S4: the view transpose
# ---------------------------------------------------------------------------

def view_transpose_plain(v, compute="int32"):
    """The plain version of S4: ``permute(2, 0, 1).contiguous()``."""
    _check(compute, COMPUTES, "compute")
    return bits16(v).permute(2, 0, 1).contiguous().view(torch.uint16)


def view_transpose(v, compute="int32"):
    """``(vh, vw, B)`` uint16 -> contiguous ``(B, vh, vw)``: kernel S4 (the
    view kernel's KEEP epilogue) on CUDA, the plain version on the CPU."""
    if v.device.type == "cpu":
        return view_transpose_plain(v, compute)
    _check(compute, COMPUTES, "compute")
    return launch_view(v, None, f"S4_view_transpose[{compute}]")


# ---------------------------------------------------------------------------
# S5: the neighbour sum over planes
# ---------------------------------------------------------------------------

def nb_sum_planes_plain(x, dtype="int32", planes=1):
    """The plain version of S5: int32 arithmetic, then the bits the
    ``dtype`` keeps (addition wraps the same way at any width)."""
    _check(dtype, WIDTHS, "dtype")
    xi = x.to(torch.int32)
    acc = sum(nb_sum(xi + p) for p in range(planes))
    return (acc & _MASK[dtype]).to(torch.uint16)


# S5's launch limits, which csrc/obs_micro.cu checks (NB_MAX_ENVS,
# NB_MAX_THREADS): staged slab widths E, widest first, and threads a
# block; the streamed variant runs NB_STREAM_THREADS lane words a block.
NB_ENVS = (32, 16, 8)
NB_MAX_THREADS = 512
NB_STREAM_THREADS = 128
# The threads a staged block is given at least, where its rows allow: a
# row is walked in parts until the block's lane words and parts reach it.
NB_MIN_THREADS = 256


def nbsum_geometry(h, w, b, width, planes, vector=True):
    """The launch geometry of S5 on (``h``, ``w``, ``b``) boards at
    ``width`` (one of :data:`WIDTHS`) over ``planes`` planes.

    A staged block keeps E environments' cells (2 bytes each) in shared
    memory, ``smem`` bytes; E is the widest of :data:`NB_ENVS` that leaves
    room for two blocks on an SM.  Each lane word (a 32-bit word of 1, 2
    or 4 environments) walks its rows in ``parts`` parts a row, the fewest
    of 1, 2, 4, ... that give the block :data:`NB_MIN_THREADS` threads (as
    many as the row's width leaves non-empty); ``slots`` threads a lane
    word share its ``h * parts`` walks evenly, and the block has a thread
    an environment at least (each stages the slab).
    ``vector`` is 16-byte staging (:func:`_build.vector_path` of the
    board), kept only where ``b % 8 == 0``.  Where no slab of 8 fits, the
    streamed variant walks the board in device memory (``staged`` false).

    Returns a dict of envs, slots, parts, threads, smem, blocks (None when
    streamed), staged and vector.
    """
    _check(width, WIDTHS, "width")
    _check(planes, PLANES, "planes")
    slab = _build.pick_slab(h * w, 2, NB_ENVS, 0)
    if slab is None:
        return dict(envs=_LANES[width], slots=1, parts=1,
                    threads=NB_STREAM_THREADS, smem=0, blocks=None,
                    staged=False, vector=False)
    words = slab["envs"] // _LANES[width]
    parts = 1
    while words * h * parts < NB_MIN_THREADS and 2 * parts <= w:
        parts *= 2
    parts = -(-w // -(-w // parts))  # no part left empty
    walks = h * parts
    per_thread = -(-walks // (NB_MAX_THREADS // words))
    # A thread an environment at least: the slab is staged by every thread.
    slots = max(-(-walks // per_thread), _LANES[width])
    return dict(slab, slots=slots, parts=parts, threads=words * slots,
                staged=True, vector=bool(vector and b % 8 == 0))


def nb_sum_planes(x, dtype="int32", planes=1):
    """``sum_p nb3x3(x + p)`` of ``(H, W, B)`` uint16 boards at the width
    of ``dtype``, as uint16: kernel S5 on CUDA, the plain version on the
    CPU."""
    if x.device.type == "cpu":
        return nb_sum_planes_plain(x, dtype, planes)
    _check(dtype, WIDTHS, "dtype")
    _check(planes, PLANES, "planes")
    _build.check_cuda(x, dtypes=(torch.uint16,))
    h, w, b = x.shape
    if b % _LANES[dtype]:
        raise ValueError(f"the {dtype} variant holds {_LANES[dtype]} "
                         f"environments a word: B={b} must be a multiple")
    out = torch.empty_like(x)
    geo = nbsum_geometry(h, w, b, dtype, planes, _build.vector_path(b, x))
    if b:
        _build.launch(f"S5_nb_sum[{dtype}x{planes}]", "obs_micro",
                      "sl_nb_sum_planes", x.data_ptr(), out.data_ptr(), h, w,
                      b, WIDTHS.index(dtype), planes, geo["envs"],
                      geo["slots"], geo["parts"], int(geo["vector"]),
                      int(geo["staged"]))
    return out
