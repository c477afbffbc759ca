"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` file is compiled on first use by its own ``nvcc``
process, all of them started together, into a shared library with a plain
C interface under ``safelife_torch/build/`` (listed in ``.gitignore``).
A library's name carries a hash of its sources and flags, so an edited
source is rebuilt and a current one is reused.

The C functions take device pointers, sizes and the CUDA stream, launch
on that stream, allocate nothing, and return ``cudaGetLastError()``;
:func:`launch` raises when that is not 0 and counts each launch.
"""

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from ..utils.profiling import span

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# Library -> C function -> argument types.  Every pointer and the stream
# (last argument) are c_void_p: a plain int would cut them to 32 bits.
SIGNATURES = {
    # The rule kernels: pointers, H, W, B, then the geometry (envs, slots,
    # vector, staged) and the stream.
    "life_kernels": {
        "sl_advance_spawnless": (_P, _P) + (_I,) * 7 + (_P,),
        "sl_advance_with_field": (_P, _P, _P) + (_I,) * 7 + (_P,),
        "sl_advance_simple": (_P, _P) + (_I,) * 7 + (_P,),
        "sl_advance_pair_fields": (_P,) * 6 + (_I,) * 7 + (_P,),
        "sl_advance_both": (_P,) * 6 + (_I,) * 7 + (_P,),
    },
    "env_step_kernels": {
        "sl_action": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
        "sl_action_block": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
        "sl_advance": (_P, _P, _P, _P, _P,         # seed, si, sf, act_i, obs_i
                       _P, _P, _P, _P, _P, _P,     # board, goals, init, fresh
                       _P, _P, _P, _P, _P,         # outputs
                       _I, _I, _I, _I, _I, _I, _I, _I,  # H .. remove_white
                       _I, _I,                     # rule, draw
                       _I, _I, _I, _I, _I,         # geometry
                       _I, _P),                    # env0, stream
    },
    "obs_micro": {
        "sl_view_crop": (_P, _P, _P) + (_I,) * 9 + (_P,),
        "sl_nb_sum_planes": (_P, _P) + (_I,) * 10 + (_P,),
    },
    # view, out, vh, vw, B, C, the channels' bits, then the geometry
    # (envs, vector, bulk, staged) and the stream.
    "view_kernels": {
        "sl_view": (_P, _P) + (_I,) * 4 + (ctypes.c_ulonglong,) + (_I,) * 4
                   + (_P,),
    },
    "obs_sum": {
        "sl_obs_sum": (_P, ctypes.c_longlong, _I, _I, _P, _P),
    },
    "philox_words": {
        "sl_philox_words": (_P, _P, _I, _I, _I, _P),
        "sl_philox_floor": (_P, _P, _I, _I, _I, _P),
    },
}

# Shared memory on the H100: the most a block may use (227 KB), and an SM's
# (228 KB, of which each resident block reserves 1 KB).  The staged
# kernels size their slabs against these.
SMEM_PER_BLOCK = 232448
SMEM_PER_SM = 233472
SMEM_RESERVED = 1024
# Its streaming multiprocessors.
SM_COUNT = 132

# Kernel name -> launches so far; wrappers add one where they launch.
LAUNCHES = collections.Counter()

_lock = threading.Lock()
_libs = {}


def _nvcc():
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _library_path(name):
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in sorted(os.listdir(CSRC)):
        if fname == name + ".cu" or fname.endswith(".cuh"):
            with open(os.path.join(CSRC, fname), "rb") as f:
                digest.update(fname.encode() + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build_all():
    """Compile every library that is missing, one ``nvcc`` per source, all
    in parallel.  Returns {name: (path, nvcc output)}, the output kept
    beside each library for a later call (a library without it is built
    again); raises on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {}
    for name in SIGNATURES:
        path = _library_path(name)
        if os.path.exists(path) and os.path.exists(path + ".log"):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        jobs[name] = (path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (path, tmp, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
        with open(path + ".log", "w") as f:
            f.write(out)
        os.replace(tmp, path)
    built = {}
    for name in SIGNATURES:
        path = _library_path(name)
        with open(path + ".log") as f:
            built[name] = (path, f.read())
    return built


def library(name):
    """The loaded library ``name``, built first if needed."""
    with _lock:
        if name not in _libs:
            with span("setup.kernels"):
                path = _library_path(name)
                if not os.path.exists(path):
                    build_all()
                lib = ctypes.CDLL(path)
                for fn, argtypes in SIGNATURES[name].items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                _libs[name] = lib
        return _libs[name]


def ptr(t):
    """Device pointer of a tensor, or NULL for None."""
    return None if t is None else t.data_ptr()


def launch(kernel, lib, fn, *args):
    """Call C function ``fn`` of library ``lib`` on the current stream;
    raise if the launch failed, else count it under ``kernel``."""
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(lib), fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn} failed to launch: CUDA error {err}")
    LAUNCHES[kernel] += 1


def vector_path(b, *tensors):
    """Whether the kernels move (H, W, ``b``) boards in 16-byte vectors: 8
    environments of a cell are 16 bytes, aligned where ``b % 8 == 0`` and
    every tensor starts on a 16-byte boundary.  Otherwise the same kernels
    take 2-byte accesses."""
    return b % 8 == 0 and all(
        t.data_ptr() % 16 == 0 for t in tensors if t is not None)


def slab_blocks(smem):
    """Resident blocks an SM holds by shared memory, each using ``smem``
    bytes."""
    return SMEM_PER_SM // (smem + SMEM_RESERVED)


def widest_slab(fits):
    """Of the launch geometries that fit (dicts with ``envs`` and
    ``blocks``), the widest slab that leaves room for two blocks on an SM,
    so that one block's staging overlaps another's work; else the widest."""
    return max(fits, key=lambda g: (min(g["blocks"], 2), g["envs"]))


def pick_slab(cells, per_cell, widths, static_smem):
    """The staged slab of a kernel that holds ``per_cell`` bytes of shared
    memory an environment and board cell (``cells`` a board) beside
    ``static_smem`` bytes of static arrays: {envs, smem, blocks} of the
    :func:`widest_slab` of ``widths`` that fits a block, or None."""
    fits = []
    for e in widths:
        smem = cells * e * per_cell
        if smem + static_smem <= SMEM_PER_BLOCK:
            fits.append(dict(envs=e, smem=smem,
                             blocks=slab_blocks(smem + static_smem)))
    return widest_slab(fits) if fits else None


def check_cuda(*tensors, dtypes):
    """Raise unless every tensor is a contiguous tensor on one CUDA device
    with the dtype given for it."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, not {dev}")
    for t, dt in zip(tensors, dtypes):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                f"kernel input must be contiguous {dt} on {dev}; got "
                f"{t.dtype} on {t.device}, contiguous={t.is_contiguous()}")
