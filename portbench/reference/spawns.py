"""Spawn draws of SafeLife on the card: Philox4x32-10 keyed by a step's
seed, in plain PyTorch.

A frozen copy of the generator that the card's env step draws spawns
from: the counter is (cell ``r * W + c``, environment index in the whole
batch, 0, 0), the key is (seed, 0), and the first output word is the cell's
draw.  The 24-bit draw compares ``(word >> 8) & 0xFFFFFF`` with
``int32(float32(p) * 2**24)``; the paired draw takes the low 16 bits for
the board and the high 16 for the goal board, against
``int32(float32(p) * 2**16)``.  The step's seed is one int32 drawn with
``torch.randint(0, 2**31 - 1, (1,))`` from the run's generator right after
the policy's draw.
"""

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK = 0xFFFFFFFF


def _mulhilo(m, x):
    mh, ml = m >> 16, m & 0xFFFF
    xh, xl = x >> 16, x & 0xFFFF
    low = ml * xl + ((mh * xl + ml * xh) << 16)
    return mh * xh + (low >> 32), low & MASK


def words(seed, shape, device):
    """(H, W, B) int64 words in ``[0, 2**32)`` of the step ``seed``."""
    h, w, b = shape
    c0 = torch.arange(h * w, dtype=torch.int64, device=device).reshape(h, w, 1)
    c1 = torch.arange(b, dtype=torch.int64, device=device).reshape(1, 1, b)
    c2 = c3 = 0
    k0 = torch.as_tensor(seed, device=device).reshape(1).to(torch.int64) & MASK
    k1 = 0
    for i in range(10):
        if i:
            k0, k1 = (k0 + W0) & MASK, (k1 + W1) & MASK
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0


def fields(seed, spawn_prob, shape, static_goals):
    """(board, goals) bool spawn fields of one step: the 24-bit draw for
    the board where the goals are static, else the paired draw."""
    word = words(seed, shape, spawn_prob.device)
    p = spawn_prob.to(torch.float32)
    if static_goals:
        board = ((word >> 8) & 0xFFFFFF) < (p * float(1 << 24)).to(torch.int32)
        return board, torch.zeros_like(board)
    t = (p * float(1 << 16)).to(torch.int32)
    return (word & 0xFFFF) < t, (word >> 16) < t


def step_seed(generator, device):
    return torch.randint(0, 2**31 - 1, (1,), generator=generator,
                         device=device, dtype=torch.int32)
