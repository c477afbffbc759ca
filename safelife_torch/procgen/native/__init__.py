"""ctypes bindings for the native procgen core (``safelife_native.cpp``, a
copy of the JAX package's; port of ``safelife_tpu.procgen.native``).

The shared library is compiled with ``g++`` on first use into
``safelife_torch/build/`` under a hash of its source and flags, written to
a temporary name and renamed into place, so concurrent first uses never
load a half-written file.  Its file name is the port's own, so the port's
and the JAX package's libraries load side by side in one process.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "safelife_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build")
# The JAX package's flags: the same source and flags give the same levels.
_GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
_LOCK = threading.Lock()
_LIB = None

NEW_CELL_MASK = 1
CAN_OSCILLATE_MASK = 2
INCLUDE_VIOLATIONS_MASK = 4

MAX_ITER_ERROR = -1
AREA_TOO_SMALL_ERROR = -3


class BoardGenException(Exception):
    pass


class MaxIterException(BoardGenException):
    pass


class InsufficientAreaException(BoardGenException):
    pass


def _build_library():
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(
            " ".join(_GXX_FLAGS).encode() + fh.read()).hexdigest()
    path = os.path.join(_BUILD_DIR, f"procgen-native-{digest[:16]}.so")
    if not os.path.exists(path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        proc = subprocess.run(["g++", *_GXX_FLAGS, _SRC, "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed for safelife_native.cpp:\n{proc.stderr}")
        os.replace(tmp, path)
    return path


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(_build_library())
            u16p = np.ctypeslib.ndpointer(np.uint16, flags="C")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
            lib.slt_advance_board.argtypes = [
                u16p, u16p, ctypes.c_int, ctypes.c_int,
                ctypes.c_double, ctypes.c_uint64]
            lib.slt_advance_board.restype = None
            lib.slt_wrapped_label.argtypes = [
                i32p, ctypes.c_int, ctypes.c_int]
            lib.slt_wrapped_label.restype = ctypes.c_int
            lib.slt_gen_pattern.argtypes = [
                u16p, i32p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_double, ctypes.c_double, ctypes.c_double,
                ctypes.c_double,
                np.ctypeslib.ndpointer(np.float64, flags="C"),
                ctypes.c_uint64]
            lib.slt_gen_pattern.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def advance_board(board, spawn_prob=0.0, rng_seed=0):
    """Host CA step (C++); deterministic when spawn_prob == 0."""
    board = np.ascontiguousarray(board, np.uint16)
    out = np.empty_like(board)
    _lib().slt_advance_board(
        board, out, board.shape[0], board.shape[1],
        float(spawn_prob), int(rng_seed))
    return out


def wrapped_label(data):
    """Toroidal 8-connected labeling -> (labels, num_labels)."""
    labels = np.ascontiguousarray(data, np.int32).copy()
    n = _lib().slt_wrapped_label(labels, labels.shape[0], labels.shape[1])
    return labels, n


def gen_pattern(board, mask, period=1, seeds=None, max_iter=40,
                min_fill=0.2, temperature=0.5, osc_bonus=0.3,
                alive=(0.0, 0.0), wall=(100.0, 100.0), tree=(100.0, 100.0),
                rng=None, **ignored):
    """Grow a still life / oscillator in the masked region (annealing).

    Mirrors the reference binding (``module.c:129-230``): the input board is
    copied into a (period, H, W) stack whose deeper layers are pre-advanced,
    the annealer runs until the masked region has no rule violations and
    meets ``min_fill``, and layer 0 is returned.  Penalties are (value at
    density 0, value at density 1) pairs, converted to base+slope.  The
    annealer's seed is ``rng`` when it is an int, else a draw from numpy's
    global generator.
    """
    board = np.ascontiguousarray(board, np.uint16)
    mask = np.ascontiguousarray(mask, np.int32)
    h, w = board.shape
    if h < 3 or w < 3:
        raise ValueError("Board must be at least 3x3.")
    if period <= 0:
        raise ValueError("Pattern period must be larger than 0.")
    if mask.shape != (h, w):
        raise ValueError(f"mask shape {mask.shape} is not the board's "
                         f"{(h, w)}")
    if seeds is None:
        seeds_arr, seeds_ptr = None, None
    else:
        seeds_arr = np.ascontiguousarray(seeds, np.int32)
        if seeds_arr.shape != (h, w):
            raise ValueError(f"seeds shape {seeds_arr.shape} is not the "
                             f"board's {(h, w)}")
        seeds_ptr = seeds_arr.ctypes.data_as(ctypes.c_void_p)

    stack = np.empty((period, h, w), np.uint16)
    stack[0] = board
    for i in range(1, period):
        stack[i] = advance_board(stack[i - 1])

    cp = np.empty(8, np.float64)
    for i, (base, at1) in enumerate(
            [(0.0, 0.0), tuple(wall), tuple(alive), tuple(tree)]):
        cp[2 * i] = base
        cp[2 * i + 1] = at1 - base
    seed_val = (rng if isinstance(rng, (int, np.integer)) else None)
    if seed_val is None:
        seed_val = int(np.random.randint(0, 2**63 - 1))

    err = _lib().slt_gen_pattern(
        stack, mask, seeds_ptr, period, h, w,
        float(max_iter), float(min_fill), float(temperature),
        float(osc_bonus), cp, int(seed_val))
    if err == MAX_ITER_ERROR:
        raise MaxIterException("Max-iter hit. Aborting!")
    if err == AREA_TOO_SMALL_ERROR:
        raise InsufficientAreaException(
            "The unmasked area was too small to generate a pattern.")
    if err != 0:
        raise BoardGenException(f"pattern generation failed ({err})")
    return stack[0].copy()
