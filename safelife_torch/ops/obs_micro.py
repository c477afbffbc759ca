"""The observation and stencil micro-experiments of ``scripts/obs_micro.py``
as hand-written CUDA kernels (``csrc/obs_micro.cu``), each with its plain
PyTorch version:

* S3 :func:`view_crop`: the agent-centred torus crop of ``(H, W, B)``
  uint16 boards, ``v[i, j, b] = x[(i + rs_b) % H, (j + cs_b) % W, b]``,
  with the shifts in ``si`` rows 0 and 1 (``make_roll_kernel``);
* S4 :func:`view_transpose`: ``(vh, vw, B)`` -> ``(B, vh, vw)``
  (``make_transpose_kernel``);
* S5 :func:`nb_sum_planes`: ``sum_p nb3x3(x + p)`` on the torus over
  ``planes`` planes at the width of ``dtype``, wrapping there
  (``make_nbsum_kernel``).

``compute`` (S3, S4) and ``dtype`` (S5) name the variants the script
times: the width the kernel holds its values at.  They leave S3's and
S4's results unchanged; S5 wraps at the width.  The wrappers launch the
kernels on CUDA tensors and run the plain versions on CPU tensors.
"""

import torch

from .. import bits16
from . import _build
from .life import nb_sum

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
    if b:
        _build.launch(f"S3_view_crop[{compute}]", "obs_micro", "sl_view_crop",
                      x.data_ptr(), si.data_ptr(), out.data_ptr(), h, w, b,
                      vh, vw, COMPUTES.index(compute))
    return out


# ---------------------------------------------------------------------------
# S4: the view transpose
# ---------------------------------------------------------------------------

def view_transpose_plain(v, compute="int32"):
    """The plain version of S4: ``permute(2, 0, 1).contiguous()``."""
    _check(compute, COMPUTES, "compute")
    return bits16(v).permute(2, 0, 1).contiguous().view(torch.uint16)


def view_transpose(v, compute="int32"):
    """``(vh, vw, B)`` uint16 -> contiguous ``(B, vh, vw)``: kernel S4 on
    CUDA, the plain version on the CPU."""
    if v.device.type == "cpu":
        return view_transpose_plain(v, compute)
    _check(compute, COMPUTES, "compute")
    _build.check_cuda(v, dtypes=(torch.uint16,))
    vh, vw, b = v.shape
    out = torch.empty((b, vh, vw), dtype=torch.uint16, device=v.device)
    if v.numel():
        _build.launch(f"S4_view_transpose[{compute}]", "obs_micro",
                      "sl_view_transpose", v.data_ptr(), out.data_ptr(),
                      vh * vw, b, COMPUTES.index(compute))
    return out


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
    if b:
        _build.launch(f"S5_nb_sum[{dtype}x{planes}]", "obs_micro",
                      "sl_nb_sum_planes", x.data_ptr(), out.data_ptr(), h, w,
                      b, WIDTHS.index(dtype), planes)
    return out
