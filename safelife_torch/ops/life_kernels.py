"""The CA rule variants of ``safelife_tpu.ops.life_pallas``, each as plain
PyTorch and as a hand-written CUDA kernel.

The rule needs, per cell, counts over its 3x3 torus neighbourhood: live
cells, three colour weights (live cells once, spawners twice), live
destructible parents, and the presence of PRESERVING, INHIBITING and
SPAWNING cells.  The TPU packs those counts into int32 words of 4- and
5-bit fields so that one neighbour sum gives many of them; the plain
versions here repeat that packing function by function, in int32:

* ``_advance_spawnless``: a board without spawners, one word (K4);
* ``_advance_block`` with spawn: the full rule with a spawn field (K5);
* ``_advance_goals_simple``: a goal board free of PRESERVING, INHIBITING,
  SPAWNING and EXIT (K6), and ``_advance_with_simple_goals`` which lets the
  board's presence fields ride the goal word (the rule of K2 on the
  ``*-dynamic`` suites and navigation);
* ``_advance_pair_spawnsimple``: a board and a goal board with spawners
  but no PRESERVING, INHIBITING or EXIT, two words (K7);
* ``_advance_pair``: two full-rule boards sharing one presence word (K8,
  with the paired 16-bit spawn draw of :mod:`.rng`).

Each specialised rule equals the full rule (:func:`.life.advance_board`)
on the boards its bank flag certifies.  The wrappers launch the kernels of
``csrc/life_kernels.cu`` on CUDA tensors, with the geometry of
:func:`rule_geometry`, and run the plain versions on CPU tensors; the
``*_plain`` functions run the plain versions on any device.
"""

import torch

from .. import cells as C
from . import _build, rng
from .life import nb_sum


def _fold_ge2(counts, mask):
    """OR-fold each masked count field's bits-above-unit onto its base bit:
    after this, ``m & (1 << base)`` tests "field value >= 2"."""
    m = (counts >> 1) & mask
    m = m | (m >> 2)
    return m | (m >> 1)


def _pis_word(board, shift=0, spawning=True):
    """PRESERVING/INHIBITING(/SPAWNING) presence deposits as 4-bit count
    fields at bits ``shift``/``shift+4``(/``shift+8``): the three flag bits
    are adjacent, so one multiply spreads them to 4-bit spacing."""
    pis3 = (board >> C.PRESERVING_BIT) & (7 if spawning else 3)
    return ((pis3 * 0x49) & 0x111) << shift


def _pis_predicates(counts, shift, spawning=True):
    """Presence predicates from a summed :func:`_pis_word` at ``shift``."""
    preserved = ((counts >> shift) & 15) != 0
    inhibited = ((counts >> (shift + 4)) & 15) != 0
    near_spawner = ((counts >> (shift + 8)) & 15) != 0 if spawning else None
    return preserved, inhibited, near_spawner


def _advance_core(board, spawn, preserved, inhibited, near_spawner):
    """The CA rule on an int32 board given its presence predicates;
    ``spawn=None`` is the rule without spawners (colour weight = alive)."""
    alive = board & 1
    if spawn is None:
        cw = alive
    else:
        cw = alive + 2 * ((board >> C.SPAWNING_BIT) & 1)
    # Colour bits spread to 5-bit spacing (r@0, g@5, b@10) with one
    # multiply, then weighted by cw in one more.
    c3 = (board >> C.COLOR_BIT) & 7
    spread = (c3 * 0x111) & 0x421
    has_d = ((board >> C.DESTRUCTIBLE_BIT) | (board >> C.EXIT_BIT)) & 1
    counts = nb_sum(alive + ((spread * cw) << 5) + ((has_d * alive) << 20))
    n_alive = counts & 31
    m = (counts >> 1) & ((15 << 5) | (15 << 10) | (15 << 15) | (15 << 20))
    m = m | (m >> 2)
    m = m | (m >> 1)
    t = m & ((1 << 5) | (1 << 10) | (1 << 15))
    inherit = ((t >> 4) * 0x111) & C.COLORS

    zero = torch.zeros_like(board)
    is_alive = alive != 0
    frozen = (board & C.FROZEN) != 0
    three = n_alive == 3
    survives = frozen | preserved | three | (n_alive == 4)
    born = three & ~frozen & ~inhibited
    born_cell = C.ALIVE | inherit | ((m >> 17) & C.DESTRUCTIBLE)
    if spawn is None:
        return torch.where(is_alive, torch.where(survives, board, zero),
                           torch.where(born, born_cell, board))
    spawned = ~frozen & ~inhibited & ~born & near_spawner & spawn
    spawn_cell = (C.ALIVE | C.DESTRUCTIBLE) | inherit
    return torch.where(
        is_alive, torch.where(survives, board, zero),
        torch.where(born, born_cell, torch.where(spawned, spawn_cell, board)))


# ---------------------------------------------------------------------------
# Single-word full-rule packings (life_pallas.py:129-152): 4-bit fields for a
# spawnless board, 5-bit colour fields for a spawner board.  No field's 3x3
# sum carries into the next.
# ---------------------------------------------------------------------------

def _pack_full4(board):
    """Spawnless full-rule board -> one 28-bit count word (4-bit fields)."""
    alive = board & 1
    c3 = (board >> C.COLOR_BIT) & 7
    spread = (c3 * 0x49) & 0x111                      # r@0, g@4, b@8
    has_d = ((board >> C.DESTRUCTIBLE_BIT) | (board >> C.EXIT_BIT)) & 1
    pi2 = (board >> C.PRESERVING_BIT) & 3
    # pi deposit: partial products of 2^20 + 2^23 land uniquely on {20, 24}.
    return (alive + ((spread * alive) << 4) + ((has_d * alive) << 16)
            + ((pi2 * 0x900000) & 0x1100000))


def _extract4(counts):
    n_alive = counts & 15
    m = _fold_ge2(counts, (7 << 4) | (7 << 8) | (7 << 12) | (7 << 16))
    t = m & ((1 << 4) | (1 << 8) | (1 << 12))
    inherit = ((t >> 3) * 0x124) & C.COLORS
    born_d = (m >> 13) & C.DESTRUCTIBLE
    preserved = ((counts >> 20) & 15) != 0
    inhibited = ((counts >> 24) & 15) != 0
    return n_alive, inherit, born_d, preserved, inhibited


def _pack_full5(board, with_pi=True):
    """Spawner full-rule board -> one 31-bit count word (5-bit colours;
    spawner presence is not included: it rides a partner word)."""
    alive = board & 1
    cw = alive + 2 * ((board >> C.SPAWNING_BIT) & 1)
    c3 = (board >> C.COLOR_BIT) & 7
    spread = (c3 * 0x1110) & 0x4210                   # r@4, g@9, b@14
    has_d = ((board >> C.DESTRUCTIBLE_BIT) | (board >> C.EXIT_BIT)) & 1
    word = alive + spread * cw + ((has_d * alive) << 19)
    if with_pi:
        pi2 = (board >> C.PRESERVING_BIT) & 3
        # pi deposit: partial products of 2^23 + 2^26 land on {23, 27}.
        word = word + ((pi2 * 0x4800000) & 0x8800000)
    return word


def _extract5(counts, with_pi=True):
    n_alive = counts & 15
    m = _fold_ge2(counts, (15 << 4) | (15 << 9) | (15 << 14) | (7 << 19))
    t = m & ((1 << 4) | (1 << 9) | (1 << 14))
    inherit = ((t >> 4) * 0x222) & C.COLORS
    born_d = (m >> 16) & C.DESTRUCTIBLE
    if not with_pi:
        return n_alive, inherit, born_d, None, None
    preserved = ((counts >> 23) & 15) != 0
    inhibited = ((counts >> 27) & 15) != 0
    return n_alive, inherit, born_d, preserved, inhibited


def _core_full(board, spawn, n_alive, inherit, born_d, preserved, inhibited,
               near_spawner):
    """The CA rule given extracted neighbourhood quantities;
    ``preserved``/``inhibited`` are None where the flag certifies them
    absent, ``spawn`` None where nothing spawns."""
    zero = torch.zeros_like(board)
    is_alive = (board & 1) != 0
    frozen = (board & C.FROZEN) != 0
    three = n_alive == 3
    survives = frozen | three | (n_alive == 4)
    if preserved is not None:
        survives = survives | preserved
    born = three & ~frozen
    if inhibited is not None:
        born = born & ~inhibited
    born_cell = C.ALIVE | inherit | born_d
    if spawn is None:
        return torch.where(is_alive, torch.where(survives, board, zero),
                           torch.where(born, born_cell, board))
    spawned = ~frozen & ~born & near_spawner & spawn
    if inhibited is not None:
        spawned = spawned & ~inhibited
    spawn_cell = (C.ALIVE | C.DESTRUCTIBLE) | inherit
    return torch.where(
        is_alive, torch.where(survives, board, zero),
        torch.where(born, born_cell, torch.where(spawned, spawn_cell, board)))


def _advance_spawnless(board):
    """Full-rule advance of an int32 spawnless board in ONE neighbor-sum."""
    return _core_full(board, None, *_extract4(nb_sum(_pack_full4(board))),
                      near_spawner=None)


def _advance_block(board, spawn):
    """Standalone full-rule advance of one int32 board: the one-word
    spawnless packing, or with spawn the rule word plus a presence word."""
    if spawn is None:
        return _advance_spawnless(board)
    p, i, s = _pis_predicates(nb_sum(_pis_word(board, 0, spawning=True)), 0)
    return _advance_core(board, spawn, p, i, s)


def _advance_goals_simple(goals, extra=None):
    """The CA rule on a certified simple goal board (no PRESERVING,
    INHIBITING, SPAWNING or EXIT anywhere; the certification is
    inductive): nothing is preserved, inhibited or spawned, and the
    destructible count needs only the DESTRUCTIBLE bit.  ``extra`` rider
    fields (bits 20 and up) are summed along; then the counts are
    returned too."""
    alive = goals & 1
    c3 = (goals >> C.COLOR_BIT) & 7
    spread = (c3 * 0x49) & 0x111           # color bits at r@0, g@4, b@8
    has_d = (goals >> C.DESTRUCTIBLE_BIT) & alive
    packed = alive + ((spread * alive) << 4) + (has_d << 16)
    if extra is not None:
        packed = packed | extra
    counts = nb_sum(packed)
    n_alive = counts & 15
    m = (counts >> 1) & ((7 << 4) | (7 << 8) | (7 << 12) | (7 << 16))
    m = m | (m >> 1)
    m = m | (m >> 1)
    t = m & ((1 << 4) | (1 << 8) | (1 << 12))
    inherit = ((t >> 3) * 0x124) & C.COLORS

    is_alive = alive != 0
    frozen = (goals & C.FROZEN) != 0
    three = n_alive == 3
    survives = frozen | three | (n_alive == 4)
    born = three & ~frozen
    born_cell = C.ALIVE | inherit | ((m >> 13) & C.DESTRUCTIBLE)
    out = torch.where(
        is_alive, torch.where(survives, goals, torch.zeros_like(goals)),
        torch.where(born, born_cell, goals))
    return out if extra is None else (out, counts)


def _advance_with_simple_goals(board, spawn, goals):
    """Advance a full-rule board and its certified simple goal board; the
    board's presence fields ride the goal word's free bits 20/24/28.

    The spawning field reaches bit 31, the sign bit of int32.  Torch's
    int32 addition wraps as JAX's does (two's complement, bitwise exact),
    every field stays <= 9, and each extraction masks after the shift, so
    the arithmetic shift of a negative word is harmless."""
    spawning = spawn is not None
    extra = _pis_word(board, 20, spawning=spawning)
    goals_out, counts = _advance_goals_simple(goals, extra)
    p, i, s = _pis_predicates(counts, 20, spawning=spawning)
    return _advance_core(board, spawn, p, i, s), goals_out


def _advance_pair_spawnsimple(board, spawn_b, goals, spawn_g):
    """Advance a full-rule board and a spawn-simple goal board (spawners,
    but no PRESERVING, INHIBITING or EXIT) with two neighbour sums: both
    boards' spawner presence rides the goal word's bits 23 and 27."""
    wb = _pack_full5(board, with_pi=True)
    s_g = (goals >> C.SPAWNING_BIT) & 1
    s_b = (board >> C.SPAWNING_BIT) & 1
    wg = _pack_full5(goals, with_pi=False) + (s_g << 23) + (s_b << 27)
    cb = nb_sum(wb)
    cg = nb_sum(wg)
    near_g = ((cg >> 23) & 15) != 0
    near_b = ((cg >> 27) & 15) != 0
    new_b = _core_full(board, spawn_b, *_extract5(cb, with_pi=True), near_b)
    na, inh, bd, _, _ = _extract5(cg, with_pi=False)
    new_g = _core_full(goals, spawn_g, na, inh, bd, None, None, near_g)
    return new_b, new_g


def _advance_pair(board, spawn_b, goals, spawn_g):
    """Advance two full-rule boards with one shared presence word: the
    board's fields at bits 0-11, the goals' at 12-23."""
    sb = spawn_b is not None
    sg = spawn_g is not None
    word = _pis_word(board, 0, spawning=sb) | _pis_word(goals, 12,
                                                        spawning=sg)
    counts = nb_sum(word)
    pb, ib, nsb = _pis_predicates(counts, 0, spawning=sb)
    pg, ig, nsg = _pis_predicates(counts, 12, spawning=sg)
    return (_advance_core(board, spawn_b, pb, ib, nsb),
            _advance_core(goals, spawn_g, pg, ig, nsg))


# ---------------------------------------------------------------------------
# Plain versions and wrappers of K4-K8.
# ---------------------------------------------------------------------------

def _i32(x):
    return x.to(torch.int32)


def _u16(x):
    return x.to(torch.uint16)


def advance_spawnless_plain(board):
    """The plain version of kernel K4: uint16 boards in and out, on any
    device."""
    return _u16(_advance_spawnless(_i32(board)))


def advance_with_field_plain(board, spawn):
    """The plain version of K5: the full rule with a bool spawn field."""
    return _u16(_advance_block(_i32(board), spawn.to(torch.bool)))


def advance_simple_plain(goals):
    """The plain version of K6: the certified simple goal rule."""
    return _u16(_advance_goals_simple(_i32(goals)))


def advance_pair_spawnsimple_with_fields_plain(board, spawn_b, goals,
                                               spawn_g):
    """The plain version of K7: board and spawn-simple goals with given
    bool spawn fields."""
    new_b, new_g = _advance_pair_spawnsimple(
        _i32(board), spawn_b.to(torch.bool), _i32(goals),
        spawn_g.to(torch.bool))
    return _u16(new_b), _u16(new_g)


def _seed_tensor(seed, device):
    return torch.as_tensor(seed, device=device).reshape(1).to(torch.int32)


def advance_both_plain(board, goals, spawn_prob, seed):
    """The plain version of K8: the general pair with the paired 16-bit
    Philox draw of step ``seed``."""
    spawn_b, spawn_g = rng.spawn_field_pair(
        _seed_tensor(seed, board.device), spawn_prob, board.shape)
    new_b, new_g = _advance_pair(_i32(board), spawn_b, _i32(goals), spawn_g)
    return _u16(new_b), _u16(new_g)


# The rule kernels' launch limits, which csrc/life_kernels.cu checks
# (MAX_ENVS, MAX_THREADS, STREAM_THREADS): staged slab widths E, widest
# first; threads a staged block; environments a streamed block.
RULE_ENVS = (32, 16, 8)
RULE_MAX_THREADS = 512
RULE_STREAM_THREADS = 128
# Bytes of the count word each kernel's rule sums (SpawnlessRule and
# SimpleRule one int32, FullRule two): a staged block holds a slab of
# words beside the 16-bit slab of the board it advances.
RULE_WORD_BYTES = {"K4_advance_spawnless": 4, "K5_advance_with_field": 8,
                   "K6_advance_simple": 4, "K7_advance_pair_fields": 8,
                   "K8_advance_both": 8}
# The kernel's static shared array: a spawn threshold per environment.
_RULE_STATIC_SMEM = 4 * RULE_ENVS[0]


def rule_geometry(h, w, kernel, b, vector=True):
    """The launch geometry of ``kernel`` (a key of :data:`RULE_WORD_BYTES`)
    on (``h``, ``w``, ``b``) boards.

    A staged block advances a slab of E environments, one board at a time:
    the board's cells (2 bytes) and their vertical sums (a count word) in
    shared memory, ``smem`` bytes.  ``slots`` threads an environment take
    its columns (the sums), then its rows (the rule).  E is the widest of
    :data:`RULE_ENVS` that leaves room for two blocks on an SM, else the
    widest that fits.  ``vector`` is the 16-byte path
    (:func:`_build.vector_path` of the tensors), kept only where ``b % 8 ==
    0``.  Where no slab fits, the streamed variant runs instead: 128
    environments a block, one thread per environment and row, on the
    boards in device memory (``staged`` false).

    Returns a dict of envs, slots, threads, smem, blocks (resident blocks
    an SM holds by shared memory; None when streamed), staged and vector.
    """
    slab = _build.pick_slab(h * w, 2 + RULE_WORD_BYTES[kernel], RULE_ENVS,
                            _RULE_STATIC_SMEM)
    if slab is None:
        return dict(envs=RULE_STREAM_THREADS, slots=1,
                    threads=RULE_STREAM_THREADS, smem=0, blocks=None,
                    staged=False, vector=False)
    slots = min(max(h, w), RULE_MAX_THREADS // slab["envs"])
    return dict(slab, slots=slots, threads=slab["envs"] * slots, staged=True,
                vector=bool(vector and b % 8 == 0))


def _launch(kernel, fn, tensors, h, w, b):
    _build.check_cuda(*tensors, dtypes=tuple(t.dtype for t in tensors))
    # The boards (uint16) move in vectors; fields, seed and probabilities
    # are read where the rule asks.
    boards = (t for t in tensors if t.dtype == torch.uint16)
    geo = rule_geometry(h, w, kernel, b, _build.vector_path(b, *boards))
    if b:
        _build.launch(kernel, "life_kernels", fn,
                      *(t.data_ptr() for t in tensors), h, w, b, geo["envs"],
                      geo["slots"], int(geo["vector"]), int(geo["staged"]))


def _check_boards(*boards):
    _build.check_cuda(*boards, dtypes=(torch.uint16,) * len(boards))
    if any(x.shape != boards[0].shape for x in boards):
        raise ValueError("all boards must share one (H, W, B) shape")
    return boards[0].shape


def _check_fields(shape, *fields):
    _build.check_cuda(*fields, dtypes=(torch.bool,) * len(fields))
    if any(f.shape != shape for f in fields):
        raise ValueError(f"spawn fields must have the boards' shape {shape}")


def advance_spawnless(board):
    """Advance spawner-free ``(H, W, B)`` uint16 boards one CA step.

    Equal to ``life.advance_board`` with a never-firing spawn field on
    such boards.  A CUDA tensor goes through kernel K4; a CPU tensor
    through the plain version.
    """
    if board.device.type == "cpu":
        return advance_spawnless_plain(board)
    h, w, b = _check_boards(board)
    out = torch.empty_like(board)
    _launch("K4_advance_spawnless", "sl_advance_spawnless", (board, out),
            h, w, b)
    return out


def advance_with_field(board, spawn):
    """Advance ``(H, W, B)`` uint16 boards one step of the full rule with
    a given bool spawn field (``life_pallas.advance_with_field``): kernel
    K5 on CUDA, the plain version on the CPU."""
    if board.device.type == "cpu":
        return advance_with_field_plain(board, spawn)
    h, w, b = _check_boards(board)
    _check_fields(board.shape, spawn)
    out = torch.empty_like(board)
    _launch("K5_advance_with_field", "sl_advance_with_field",
            (board, spawn, out), h, w, b)
    return out


def advance_simple(goals):
    """Advance certified simple goal boards one step
    (``life_pallas.advance_simple``): kernel K6 on CUDA, the plain
    version on the CPU."""
    if goals.device.type == "cpu":
        return advance_simple_plain(goals)
    h, w, b = _check_boards(goals)
    out = torch.empty_like(goals)
    _launch("K6_advance_simple", "sl_advance_simple", (goals, out), h, w, b)
    return out


def advance_pair_spawnsimple_with_fields(board, spawn_b, goals, spawn_g):
    """Advance a board and its spawn-simple goal board with given bool
    spawn fields (``life_pallas.advance_pair_spawnsimple_with_fields``):
    kernel K7 on CUDA, the plain version on the CPU."""
    if board.device.type == "cpu":
        return advance_pair_spawnsimple_with_fields_plain(
            board, spawn_b, goals, spawn_g)
    h, w, b = _check_boards(board, goals)
    _check_fields(board.shape, spawn_b, spawn_g)
    out_b, out_g = torch.empty_like(board), torch.empty_like(goals)
    _launch("K7_advance_pair_fields", "sl_advance_pair_fields",
            (board, spawn_b, goals, spawn_g, out_b, out_g), h, w, b)
    return out_b, out_g


def advance_both(board, goals, spawn_prob, seed):
    """Advance board and goals one step of the general pair rule with the
    paired 16-bit Philox spawn draw of step ``seed`` (an int or an int32
    tensor; ``life_pallas.advance_both``).  ``spawn_prob`` is (B,)
    float32.  Kernel K8 on CUDA, the plain version on the CPU."""
    if board.device.type == "cpu":
        return advance_both_plain(board, goals, spawn_prob, seed)
    h, w, b = _check_boards(board, goals)
    seed = _seed_tensor(seed, board.device)
    spawn_prob = spawn_prob.to(torch.float32).contiguous()
    if spawn_prob.shape != (b,):
        raise ValueError(f"spawn_prob must be ({b},), not {spawn_prob.shape}")
    out_b, out_g = torch.empty_like(board), torch.empty_like(goals)
    _launch("K8_advance_both", "sl_advance_both",
            (seed, spawn_prob, board, goals, out_b, out_g), h, w, b)
    return out_b, out_g
