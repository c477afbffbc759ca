"""The spawn draw: Philox4x32-10, counter-based, in plain PyTorch.

This replaces the TPU's in-core PRNG of ``safelife_tpu.ops.life_pallas``
(``_spawn_field``, ``_spawn_field_pair``).  The key is the step's seed and
the counter is (cell index ``r * W + c``, environment index, 0, 0), so a
cell's random word depends on neither the launch geometry nor on which
cells were drawn before it: a kernel may draw only where the CA rule reads
the draw and still equal the full fields computed here.
``csrc/philox.cuh`` is the same generator as a device function.

The TPU's quantisation is kept exactly:

* the 24-bit draw is ``(word >> 8) & 0xFFFFFF`` against
  ``int32(float32(p) * 2**24)``;
* the paired draw takes the low and the high 16 bits of one word against
  ``int32(float32(p) * 2**16)``, the low half for the board and the high
  half for the goal board.

So ``p = 0`` never spawns and ``p = 1`` always does where a cell is
eligible.  Torch has no unsigned 32-bit multiply-high and a 32x32-bit
product overflows int64, so each product is split into 16-bit halves;
all words are int64 tensors holding values in ``[0, 2**32)``.

:func:`philox_words` is the word field itself as a kernel (T1,
``csrc/philox_words.cu``), the counterpart of the TPU's in-core PRNG
probe.
"""

import torch

from . import _build

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF
ROUNDS = 10


def _mulhilo(m, x):
    """The high and low 32-bit words of ``m * x`` for a 32-bit constant
    ``m`` and an int64 tensor ``x`` of values in ``[0, 2**32)``."""
    mh, ml = m >> 16, m & 0xFFFF
    xh, xl = x >> 16, x & 0xFFFF
    # Every partial product is below 2**33, the low sum below 2**50.
    low = ml * xl + ((mh * xl + ml * xh) << 16)
    return mh * xh + (low >> 32), low & MASK32


def philox4x32(counter, key):
    """Philox4x32-10 of four counter words and two key words (int64
    tensors or ints, values in ``[0, 2**32)``, broadcast together);
    returns the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for i in range(ROUNDS):
        if i:
            k0 = (k0 + W0) & MASK32
            k1 = (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def spawn_words(seed, shape, device):
    """The (H, W, B) int64 field of random words for the step ``seed``
    (an int32 tensor of one element, read on the device, never on the
    host): the first output word of Philox at counter (r * W + c, b, 0, 0)
    and key (seed, 0)."""
    h, w, b = shape
    cell = torch.arange(h * w, dtype=torch.int64, device=device).reshape(
        h, w, 1)
    env = torch.arange(b, dtype=torch.int64, device=device).reshape(1, 1, b)
    key0 = torch.as_tensor(seed, device=device).reshape(1).to(
        torch.int64) & MASK32
    return philox4x32((cell, env, 0, 0), (key0, 0))[0]


def _as_i32(words):
    """int64 words in ``[0, 2**32)`` -> int32 tensors of the same bits."""
    return (words - ((words >> 31) << 32)).to(torch.int32)


def philox_words_plain(seed, shape):
    """The plain version of T1: :func:`spawn_words` as int32 bits."""
    return _as_i32(spawn_words(seed, shape, seed.device))


def philox_words(seed, shape):
    """The (H, W, B) int32 field of Philox words for ``seed`` (an int32
    tensor of one element, whose device picks the path): kernel T1 on
    CUDA, the plain version on the CPU."""
    if seed.device.type == "cpu":
        return philox_words_plain(seed, shape)
    _build.check_cuda(seed, dtypes=(torch.int32,))
    h, w, b = shape
    if seed.numel() != 1 or h * w > 65535:
        raise ValueError(f"T1 takes one seed and at most 65535 cells per "
                         f"board, not {seed.numel()} and {h * w}")
    out = torch.empty((h, w, b), dtype=torch.int32, device=seed.device)
    if out.numel():
        _build.launch("T1_philox_words", "philox_words", "sl_philox_words",
                      seed.data_ptr(), out.data_ptr(), h, w, b)
    return out


def threshold(spawn_prob, bits):
    """Per-environment thresholds ``int32(float32(p) * 2**bits)``,
    truncated as the TPU kernel's ``astype(int32)``."""
    return (spawn_prob.to(torch.float32) * float(1 << bits)).to(torch.int32)


def spawn_field24(seed, spawn_prob, shape):
    """One (H, W, B) bool spawn field: the 24-bit draw against
    ``spawn_prob`` (B,) (``life_pallas._spawn_field``)."""
    words = spawn_words(seed, shape, spawn_prob.device)
    return ((words >> 8) & 0xFFFFFF) < threshold(spawn_prob, 24)


def spawn_field_pair(seed, spawn_prob, shape):
    """Two (H, W, B) bool spawn fields from one draw: the low 16 bits of
    each word for the board, the high 16 bits for the goal board
    (``life_pallas._spawn_field_pair``)."""
    words = spawn_words(seed, shape, spawn_prob.device)
    thresh = threshold(spawn_prob, 16)
    return (words & 0xFFFF) < thresh, (words >> 16) < thresh
