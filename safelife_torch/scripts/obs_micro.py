"""Micro-experiments for the observation path on the card (the port of
``scripts/obs_micro.py``: S3-S5 of ``ops/obs_micro.py``).

    python -m safelife_torch.scripts.obs_micro

a) the agent-centred crop held at int32 or uint16 (the TPU script's
   "barrel roll" rows; here a gather), the sum of the view fed back into
   the board;
b) the (vh * vw, B) view transpose held at int32 or uint16 in shared
   memory, the sum of each transposed view fed back; the TPU script's
   XLA-transpose row is ``permute(2, 0, 1).contiguous()`` here, PyTorch's
   own copy kernel;
c) the 3x3 torus neighbour sum at int32, uint16 and uint8 width, over one
   or four planes, the output fed back;
d) the full env step with the default observation.

Rows print their names as in the TPU script, with the time per chained
iteration.
"""

import torch

from .. import resolve_device
from ..env.env import BatchedSafeLifeEnv, EnvConfig
from ..levels import loader
from ..ops import obs_micro as om
from . import add_u16, env_loop, timeit

B = 16384
STEPS = 64
ROLLOUT = 16
H = W = 26
VH = VW = 15
NB_SUM_ROWS = (("nb_sum i32 x1", "int32", 1), ("nb_sum i32 x4", "int32", 4),
               ("nb_sum u16 x1", "uint16", 1), ("nb_sum u8  x1", "uint8", 1),
               ("nb_sum u8  x4", "uint8", 4))


def roll_loop(compute):
    """S3 chained: x += the sum of each environment's view."""
    def run(x, si):
        for _ in range(STEPS):
            v = om.view_crop(x, si, compute, (VH, VW))
            x = add_u16(x, v.to(torch.int32).sum((0, 1)))
        return x
    return run


def transpose_loop(compute):
    """S4 chained: v += the sum of each transposed view."""
    def run(v):
        for _ in range(STEPS):
            t = om.view_transpose(v, compute)
            v = add_u16(v, t.to(torch.int32).sum((1, 2)))
        return v
    return run


def library_transpose_loop(v):
    """The S4 loop through PyTorch's permute-and-copy."""
    for _ in range(STEPS):
        t = v.view(torch.int16).permute(2, 0, 1).contiguous()
        v = add_u16(v, t.view(torch.uint16).to(torch.int32).sum((1, 2)))
    return v


def nbsum_loop(dtype, planes=1):
    """S5 chained: the output is the next input."""
    def run(x):
        for _ in range(STEPS):
            x = om.nb_sum_planes(x, dtype, planes)
        return x
    return run


def main(device=None):
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    x = torch.randint(0, 2**15, (H, W, B), generator=gen, device=dev,
                      dtype=torch.int32).to(torch.uint16)
    si = torch.randint(0, H, (2, B), generator=gen, device=dev,
                       dtype=torch.int32)
    rows = {}
    rows["barrel roll i32"] = timeit("barrel roll i32", STEPS, dev,
                                     roll_loop("int32"), x, si)
    rows["barrel roll u16"] = timeit("barrel roll u16", STEPS, dev,
                                     roll_loop("uint16"), x, si)

    xs = (x.to(torch.int32) & 15).to(torch.uint16)  # small values
    for name, dtype, planes in NB_SUM_ROWS:
        rows[name] = timeit(name, STEPS, dev, nbsum_loop(dtype, planes), xs)

    v = torch.randint(0, 2**15, (VH, VW, B), generator=gen, device=dev,
                      dtype=torch.int32).to(torch.uint16)
    rows["in-kernel transpose i32"] = timeit(
        "in-kernel transpose i32", STEPS, dev, transpose_loop("int32"), v)
    rows["in-kernel transpose u16"] = timeit(
        "in-kernel transpose u16", STEPS, dev, transpose_loop("uint16"), v)
    rows["permute transpose (15,15,B)->(B,15,15)"] = timeit(
        "permute transpose (15,15,B)->(B,15,15)", STEPS, dev,
        library_transpose_loop, v)

    bank = loader.load_bank("benchmarks/v1.0/append-still", device=dev)
    env = BatchedSafeLifeEnv(EnvConfig(view_shape=(15, 15)), device=dev)
    rows["step obs default"] = timeit(
        "step obs default", STEPS, dev,
        *env_loop(env, bank, B, STEPS, ROLLOUT))
    return rows


if __name__ == "__main__":
    main()
