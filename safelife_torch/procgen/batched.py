"""Batched pattern synthesis on the device: B annealing chains in lockstep
(port of ``safelife_tpu.procgen.batched``).

The reference's pattern generator is a sequential simulated annealer with
incremental violation bookkeeping (``gen_board.c``; the C++ copy in
:mod:`safelife_torch.procgen.native`).  The batched annealer runs one
proposal round for EVERY board per iteration:

  1. one full-board violation field (``advance(board) != board``, the full
     CA rule with a spawn field that never fires: kernel K5 on the card)
     drives Gumbel-max sampling of a target cell per board (violating
     cells first; any in-mask cell when under-filled),
  2. a (P, P) patch around each target is gathered (cell flips only affect
     violations within +-(period + 1), so the patch holds every needed
     neighbour),
  3. all 27 candidates (3 alternative cell types x the 3x3 neighbourhood,
     the reference's extended-neighbourhood proposal set) are scored on the
     patch with the reference's density-dependent type and fill
     penalties: one (28, P, P, B) stack, the current patch first, built by
     one scatter and advanced as one batch,
  4. one Boltzmann pick per board is scattered back; converged boards
     (violation-free and filled) freeze.

The proposal scoring is distribution-identical to the reference's
"cumulative" type-cycle bookkeeping (``gen_board.c:438-455``): the
reference's per-swap deltas telescope to ``violations(board with
cell=type_j) - violations(current board)``, the independent delta scored
here.  The JAX package's annealer is the same algorithm in XLA; this one
is eager PyTorch, its only kernel K5, and it draws every Gumbel field
through :func:`gumbel_field` from a ``torch.Generator`` on the device.
Given the JAX package's draws it gives the JAX package's boards bit for
bit: the two penalty terms that XLA contracts into a fused multiply-add
are computed here as one (:func:`_fma`).

Two level factories build on the annealer:

* :func:`gen_build_levels`: single-region banks (smoke and bench);
* :func:`gen_partitioned_levels`: the task distribution: host-side region
  partitioning, fences and player/exit aprons in numpy
  (:func:`_partition_scaffolds`), then per-region board and goal pattern
  layers annealed on the device with the reference's layer semantics
  (:data:`_TASK_SPECS`).

Both return ``(LevelBank, converged)`` built on the device by
:func:`safelife_torch.levels.device_bank.build_bank_from_arrays`.
"""

import numpy as np
import torch

from .. import bits16, resolve_device
from .. import cells as C
from ..ops.life_kernels import advance_with_field

# Proposal cell types, indexed like the reference annealer:
# empty, wall, life, tree (gen_board.c cell_type_array).
TYPE_CELLS = (0, C.FROZEN, C.ALIVE | C.DESTRUCTIBLE, C.FROZEN | C.ALIVE)


def gumbel_field(shape, generator):
    """Standard Gumbel draws ``-log(-log(u))``, u uniform in (0, 1) as the
    JAX package draws them, of ``shape`` on the generator's device.  Every
    random choice of the annealer and of the factories' placements goes
    through here (tests replace it)."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    # A draw of exactly 0 gives -inf, a field entry never picked.
    return u.log_().neg_().log_().neg_()


def _fma(a, b, c):
    """float32 ``a * b + c`` rounded once, as XLA's contracted
    multiply-add: the product of two float32 values is exact in float64."""
    return (a.to(torch.float64) * b + c).to(torch.float32)


def _zeros_field(board):
    return torch.zeros(board.shape, dtype=torch.bool, device=board.device)


def _cycle(board, period, zeros):
    """``board`` advanced ``period`` steps of the full rule with the spawn
    field ``zeros``: kernel K5 on the card, its plain version on the
    CPU."""
    for _ in range(period):
        board = advance_with_field(board, zeros)
    return board


def violation_field(board, period=1):
    """(H, W, B) bool: cells where advancing ``period`` steps of the full
    rule (spawners included, a spawn field that never fires) does not
    return the uint16 board to itself: the reference's check_for_violation
    over a full cycle (still life for period 1, oscillator otherwise)."""
    return bits16(_cycle(board, period, _zeros_field(board))) != bits16(board)


def oscillation_field(board, period):
    """(H, W, B) bool: cells whose ALIVE bit changes within the period
    (the reference's oscillation bitmask, gen_board.c), through K5."""
    zeros = _zeros_field(board)
    start = bits16(board)
    osc = torch.zeros(board.shape, dtype=torch.bool, device=board.device)
    b = board
    for _ in range(max(period - 1, 0)):
        b = advance_with_field(b, zeros)
        osc |= ((bits16(b) ^ start) & C.ALIVE) != 0
    return osc


def _rule_tables(device):
    """The lookup tables of :func:`_advance_valid` (int16, on ``device``).

    ``word[x & 0x61]`` (ALIVE, PRESERVING, INHIBITING): a cell's deposit
    into the neighbour-count word, live at bit 0, PRESERVING at bit 4,
    INHIBITING at bit 8 (4-bit fields: nine cells never carry).  ``rule[(x & 0x11) << 12 | counts]``:
    the new cell for a cell's ALIVE and FROZEN bits and its 3x3 counts,
    -1 where the cell stays as it is: the spawn-free, colour-free
    still-life rule (proposal types carry no colours)."""
    k = np.arange((C.ALIVE | C.PRESERVING | C.INHIBITING) + 1)
    word = (k & 1) | (((k >> C.PRESERVING_BIT) & 1) << 4) \
        | (((k >> C.INHIBITING_BIT) & 1) << 8)
    idx = np.arange(18 << 12)
    counts, key = idx & 0xFFF, idx >> 12
    alive = (key & C.ALIVE) != 0
    frozen = (key & C.FROZEN) != 0
    n_alive = counts & 15
    preserved = (counts & 0xF0) != 0
    inhibited = (counts & 0xF00) != 0
    survives = frozen | preserved | (n_alive == 3) | (n_alive == 4)
    born = (n_alive == 3) & ~frozen & ~inhibited
    rule = np.where(alive, np.where(survives, -1, 0),
                    np.where(born, C.ALIVE | C.DESTRUCTIBLE, -1))
    return (torch.as_tensor(word, dtype=torch.int16, device=device),
            torch.as_tensor(rule, dtype=torch.int16, device=device))


def _lookup(table, idx):
    """``table[idx]`` for an integer ``idx`` of any shape, by
    ``index_select`` (several times faster than indexing on the CPU)."""
    return table.index_select(0, idx.reshape(-1)).view(idx.shape)


def _advance_valid(x, tables):
    """The CA step of the (n - 2, n - 2) inner cells of (..., n, n, B) int16
    patches (axes -3, -2), from their full 3x3 neighbourhoods in ``x``,
    through the :func:`_rule_tables` ``tables``."""
    word_of, rule = tables
    n = x.shape[-2]
    word = _lookup(word_of,
                   (x & (C.ALIVE | C.PRESERVING | C.INHIBITING)).int())
    r = word[..., 0:n - 2, :] + word[..., 1:n - 1, :] + word[..., 2:n, :]
    counts = r[..., 0:n - 2, :, :] + r[..., 1:n - 1, :, :] + r[..., 2:n, :, :]
    cells = x[..., 1:n - 1, 1:n - 1, :]
    new = _lookup(rule, ((cells & (C.ALIVE | C.FROZEN)).int() << 12) + counts)
    return torch.where(new < 0, cells, new)


def _advance_patch(patch):
    """CA advance on (..., P, P, B) int16 patches with OPEN boundaries
    (zero outside), the rule of :func:`_rule_tables`.  Only the interior
    is meaningful: after k steps, the cells within k of the edge.  The
    annealer steps the valid interior alone, which gives the same
    interior."""
    return _advance_valid(torch.nn.functional.pad(patch, (0, 0, 1, 1, 1, 1)),
                          _rule_tables(patch.device))


def _dilate(m):
    """3x3 torus dilation of (H, W, ...) bool masks."""
    r = m | torch.roll(m, 1, 0) | torch.roll(m, -1, 0)
    return r | torch.roll(r, 1, 1) | torch.roll(r, -1, 1)


# A cell's proposal type (empty, wall, life, tree) from its ALIVE and
# FROZEN bits, ``x & 0x11``: the types of the annealer's candidates.
_TYPE_KEY = (0, C.FROZEN, C.ALIVE, C.ALIVE | C.FROZEN)


def gen_still_lifes(generator, mask, batch, board=None, iters=2000,
                    min_fill=0.2, temperature=0.5,
                    cell_penalties=(0.0, 100.0, 0.0, 100.0), period=1,
                    osc_bonus=0.3):
    """Synthesize ``batch`` still lifes (period 1) or oscillators (period
    >= 2, scored with the reference's oscillation bonus) inside ``mask`` on
    the device of ``generator``, which draws every Gumbel field.

    mask: (H, W) or (H, W, B) bool — where new cells may be placed.
    board: (H, W, B) uint16 to grow on (default empty).  Cell penalties are
    (value at density 0, value at density 1) pairs or scalars for empty,
    wall, life and tree.
    Returns (boards, converged): (H, W, B) uint16 and (B,) bool.
    """
    dev = generator.device
    P = 4 * period + 3  # proposals +-1, viol band +-(p+1), stencil +-p
    half = P // 2
    mask = torch.as_tensor(mask, device=dev).to(torch.bool)
    if mask.ndim == 2:
        mask = mask[..., None].expand(*mask.shape, batch)
    h, w, b = mask.shape
    hw = h * w
    work = (torch.zeros((h, w, b), dtype=torch.int16, device=dev)
            if board is None else bits16(board.to(dev)).clone())
    flat = work.view(hw, b)
    area = mask.reshape(hw, b).sum(0).to(torch.float32)
    min_fill_cells = area * min_fill
    fill_scale = torch.clamp_min(min_fill_cells, 1.0)
    beta = 1.0 / temperature
    pen_pairs = [(p, p) if np.isscalar(p) else tuple(p)
                 for p in cell_penalties]
    if len(pen_pairs) != 4:
        raise ValueError("cell_penalties needs empty, wall, life, tree")
    pen_v0 = torch.tensor([[float(np.float32(v0))] for v0, _ in pen_pairs[1:]],
                          dtype=torch.float32, device=dev)
    pen_dv = torch.tensor([[float(np.float32(v1 - v0))]
                           for v0, v1 in pen_pairs[1:]],
                          dtype=torch.float32, device=dev)

    # Violations count on the mask PLUS its 1-cell border: patterns may not
    # leak births outside their region (the reference's border
    # INCLUDE_VIOLATIONS_MASK, proc_gen.py:286-294).
    viol_mask = _dilate(mask)
    flat_mask = mask.reshape(hw, b)
    flat_vmask = viol_mask.reshape(hw, b)
    tables = _rule_tables(dev)

    def t(x, dtype=torch.int64):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    # Patch cell k = (i, j) of a patch centred on board cell c sits at
    # board cell nbr[k, c]: (row(c) - half + i, col(c) - half + j) on the
    # torus.
    rows, cols = np.divmod(np.arange(hw), w)
    off = np.arange(P) - half
    nbr = t(((rows[None, None] + off[:, None, None]) % h) * w
            + (cols[None, None] + off[None, :, None]) % w).view(P * P, hw)
    # The 27 candidates, in the JAX package's order: each cell of the
    # central 3x3 (rows then columns), then the three types after its own:
    # their patch cells, and their types from the cell's ALIVE and FROZEN
    # bits (``next_type[key + 18 * (step - 1)]``).
    centre = np.array([(half + dr) * P + half + dc
                       for dr in (-1, 0, 1) for dc in (-1, 0, 1)])
    cand_pos = t(centre[np.repeat(np.arange(9), 3)])
    steps = np.tile(np.arange(1, 4), 9)
    type_of = np.zeros(18, np.int64)
    type_of[list(_TYPE_KEY)] = np.arange(4)
    next_type = t(np.concatenate([(type_of + j) % 4 for j in (1, 2, 3)]))
    step_off = t(18 * (steps[:, None] - 1))
    type_cells = t(TYPE_CELLS, torch.int16)
    keys3 = t(np.array(_TYPE_KEY[1:])[:, None, None], torch.int16)
    inner = slice(half - (period + 1), half + period + 2)

    def patch_metrics(stack, vmask, mask):
        """(violations, oscillating cells) on the inner (2p + 3)^2 window
        of each (P, P, B) patch of the (28, P, P, B) stack, with the
        window's masks.  Step k is computed on the cells within P - k of
        the edge, the window after the last step."""
        start = stack[..., inner, inner, :]
        adv = stack
        osc = None
        for k in range(1, period + 1):
            adv = _advance_valid(adv, tables)
            if period > 1:
                at = slice(period - k, period - k + 2 * period + 3)
                moved = ((adv[..., at, at, :] ^ start) & C.ALIVE) != 0
                osc = moved if osc is None else osc | moved
        n_viol = ((adv != start) & vmask).sum(dim=(-3, -2))
        if period == 1:
            return n_viol, None
        return n_viol, (osc & mask).sum(dim=(-3, -2))

    zeros = _zeros_field(work)

    def stats(work):
        board = work.view(torch.uint16)
        viol = ((bits16(_cycle(board, period, zeros)) != work).view(hw, b)
                & flat_vmask)
        n_viol = viol.sum(0)
        occ = (flat != 0) & flat_mask
        filled = occ.sum(0).to(torch.float32)
        return viol, n_viol, occ, filled

    for _ in range(iters):
        viol_full, n_viol, occ, filled = stats(work)
        done = (n_viol == 0) & (filled >= min_fill_cells)

        # Sample a target: a violating cell if any, else any in-mask cell.
        g = gumbel_field((hw + 27, b), generator)
        want = torch.where(n_viol > 0, viol_full, flat_mask)
        target = torch.where(want, g[:hw], -1e30).argmax(0)
        idx = nbr.index_select(1, target)                    # (P*P, B)
        patch = torch.gather(flat, 0, idx)
        vmask_p = torch.gather(flat_vmask, 0, idx).view(P, P, b)
        mask_p = torch.gather(flat_mask, 0, idx)

        # Per-lane density-dependent penalties for empty/wall/life/tree
        # (gen_board.c / the C++ copy: penalty_j = v0_j + (v1_j - v0_j) *
        # density_j, density_j = #cells of type j / #non-empty, over the
        # mask).  The empty penalty 20 (1 - t) is 0 from t = 1 on.
        tq = filled / fill_scale
        empty_pen = torch.where(tq < 0.9, 2.0,
                                ((1.0 - tq) * 20.0).clamp_min(0.0))
        counts = (((flat & (C.ALIVE | C.FROZEN)) == keys3) & occ).sum(1)
        density = counts / (filled + 1.0)                    # (3, B)
        type_pens = torch.cat(
            [empty_pen[None], _fma(pen_dv, density, pen_v0)])  # (4, B)

        # The 27 candidates: 3 alternative types at each cell of the
        # central 3x3, one scatter into a (28, P*P, B) stack whose row 0
        # is the current patch.
        key = (patch.index_select(0, cand_pos) & (C.ALIVE | C.FROZEN)).long()
        cand_type = _lookup(next_type, key + step_off)       # (27, B)
        cand_cells = _lookup(type_cells, cand_type)
        pens = torch.gather(type_pens, 0, cand_type)
        in_mask = mask_p.index_select(0, cand_pos)
        stack = patch.unsqueeze(0).repeat(28, 1, 1)
        stack[1:].scatter_(1, cand_pos[:, None, None].expand(27, 1, b),
                           cand_cells[:, None, :])
        n_viol_p, n_osc = patch_metrics(
            stack.view(28, P, P, b), vmask_p[inner, inner],
            mask_p.view(P, P, b)[inner, inner])
        dv = (n_viol_p[1:] - n_viol_p[0]).to(torch.float32)  # (27, B)
        if period > 1:
            dosc = (n_osc[1:] - n_osc[0]).to(torch.float32)
            dv = _fma(dosc, -np.float32(osc_bonus).item(), dv)
        log_probs = torch.where(in_mask, (dv + pens) * -beta, -1e30)
        pick = (log_probs + g[hw:]).argmax(0, keepdim=True)  # (1, B)

        pos = cand_pos[pick]
        new_cell = torch.where(done, torch.gather(patch, 0, pos),
                               torch.gather(cand_cells, 0, pick))
        flat.scatter_(0, torch.gather(idx, 0, pos), new_cell)

    viol_full, n_viol, _, filled = stats(work)
    converged = (n_viol == 0) & (filled >= min_fill_cells)
    return work.view(torch.uint16), converged


# ---------------------------------------------------------------------------
# Single-region level factory
# ---------------------------------------------------------------------------

def _onehot(rr, cc, r, c):
    """(H, W, B) bool: True at (r[b], c[b]) of each board."""
    return (rr == r[None, None, :]) & (cc == c[None, None, :])


def _gumbel_pick(allowed, generator):
    """Per column of (N, B) bool ``allowed``: the index of a uniform pick
    among its True entries (Gumbel-max)."""
    g = gumbel_field(allowed.shape, generator)
    return torch.where(allowed, g, -1e30).argmax(0)


def gen_build_levels(seed, batch, h=14, w=14, iters=1500, min_fill=0.12,
                     goal_fill=0.15, min_performance=0.3, temperature=0.45,
                     task="append", device=None):
    """Generate a whole bank of single-region task levels on ``device``
    (``cuda`` unless the caller passes another), every draw from one
    generator seeded with ``seed``:

    * ``task="append"`` — a green still life plus a blue still-life goal
      pattern to recreate (the append-easy family),
    * ``task="prune"`` — a green still life to preserve (board AND goals)
      plus red distractor life to remove,
    * ``task="append-spawn"`` — append with a yellow spawner stirring the
      region (stochastic dynamics, spawn_prob 0.3).

    Returns (LevelBank, converged (B,) bool).
    """
    from ..levels.device_bank import build_bank_from_arrays

    if task not in ("append", "prune", "append-spawn"):
        raise ValueError(f"unknown single-region task {task!r}")
    dev = resolve_device(device)
    gen = torch.Generator(dev)
    gen.manual_seed(seed)
    # Interior pattern region with a 3-cell border buffer (2-cell walkway +
    # wall ring, mirroring the reference's region partition buffers).
    mask = torch.zeros((h, w), dtype=torch.bool, device=dev)
    mask[3:h - 3, 3:w - 3] = True

    boards, conv_b = gen_still_lifes(
        gen, mask, batch, iters=iters, min_fill=min_fill,
        temperature=temperature)
    pattern = boards.to(torch.int32)
    alive_b = (pattern & C.ALIVE) != 0
    board = torch.where(alive_b, pattern | C.COLOR_G, pattern)

    if task == "prune":
        # Second annealing run grows red distractors around the (frozen-
        # out) green pattern; both patterns end as one joint still life.
        mask2 = mask[..., None] & (pattern == 0)
        board2, conv_g = gen_still_lifes(
            gen, mask2, batch, board=boards, iters=iters,
            min_fill=goal_fill, temperature=temperature)
        grown = board2.to(torch.int32)
        new = (grown != pattern) & ((grown & C.ALIVE) != 0)
        board = torch.where(new, grown | C.COLOR_R, board)
        # Goals: the green pattern only (preserve it; removing red pays).
        goals = torch.where(alive_b, pattern | C.COLOR_G, 0)
    else:
        goal_pat, conv_g = gen_still_lifes(
            gen, mask, batch, iters=iters, min_fill=goal_fill,
            temperature=temperature)
        goal_pat = goal_pat.to(torch.int32)
        alive_g = (goal_pat & C.ALIVE) != 0
        goals = torch.where(alive_g, (goal_pat | C.COLOR_B) & ~C.SPAWNING, 0)

    # Wall ring just outside the region keeps patterns contained.
    ring = torch.zeros((h, w), dtype=torch.bool, device=dev)
    ring[2, 2:w - 2] = ring[h - 3, 2:w - 2] = True
    ring[2:h - 2, 2] = ring[2:h - 2, w - 3] = True
    board = torch.where(ring[..., None], C.WALL, board)

    # Player at a random outer-buffer cell; exit at the farthest buffer
    # cell (torus manhattan), per the reference's placement rule.
    buffer_mask = torch.zeros((h, w), dtype=torch.bool, device=dev)
    buffer_mask[:2, :] = buffer_mask[h - 2:, :] = True
    buffer_mask[:, :2] = buffer_mask[:, w - 2:] = True
    p_flat = _gumbel_pick(
        buffer_mask.reshape(h * w, 1).expand(h * w, batch), gen)
    pr, pc = p_flat // w, p_flat % w

    rr = torch.arange(h, device=dev)[:, None, None]
    cc = torch.arange(w, device=dev)[None, :, None]
    dr = (rr - pr[None, None, :]).abs()
    dc = (cc - pc[None, None, :]).abs()
    dist = torch.minimum(dr, h - dr) + torch.minimum(dc, w - dc)
    dist = torch.where(buffer_mask[..., None], dist, -1)
    e_flat = dist.reshape(h * w, batch).argmax(0)
    er, ec = e_flat // w, e_flat % w

    board = torch.where(_onehot(rr, cc, pr, pc), C.PLAYER, board)
    board = torch.where(_onehot(rr, cc, er, ec), C.LEVEL_EXIT | C.COLOR_R,
                        board)

    # White goals on the buffer (visual hint, reference gen_game).
    goals = torch.where(buffer_mask[..., None] & (goals == 0), C.COLORS,
                        goals)

    spawn_prob = torch.zeros(batch, dtype=torch.float32, device=dev)
    if task == "append-spawn":
        # One yellow spawner at a random in-region empty cell.
        empty = (board == 0) & mask[..., None]
        s_flat = _gumbel_pick(empty.reshape(h * w, batch), gen)
        board = torch.where(
            _onehot(rr, cc, s_flat // w, s_flat % w),
            C.SPAWNER | C.COLOR_R | C.COLOR_G, board)
        spawn_prob = torch.full((batch,), 0.3, dtype=torch.float32,
                                device=dev)

    bank = build_bank_from_arrays(
        board.to(torch.uint16), goals.to(torch.uint16), pr, pc,
        min_performance=min_performance, spawn_prob=spawn_prob,
        static_goals=False, spawnless=(task != "append-spawn"),
        max_exits=1)  # the factory places exactly one exit per level
    return bank, conv_b & conv_g


# ---------------------------------------------------------------------------
# Multi-region partitioned levels (the gen_game distribution).
# ---------------------------------------------------------------------------

MAX_REGIONS = 4


def _partition_scaffolds(batch, h, w, min_regions=2, max_regions=3):
    """Host-side level scaffolds: partition, fences, player/exit, aprons.

    Mirrors the host pipeline's pre-pattern stages (generate.gen_game:
    partition -> player + farthest exit -> 3x3 aprons -> per-region
    fences); the expensive annealing stays on device.  Uses numpy's
    global RNG like the host path (seed via np.random.seed).

    Returns dict of stacked numpy arrays:
      board0 (H, W, B) u16   — player + exit pre-painted (fences are
                               painted on device, per stack fence fraction)
      fence  (H, W, B) bool  — fence cells (part of fg AND bg)
      fence_slot (R, H, W, B) bool — fence cells per region slot
      slots  (R, H, W, B) bool — per-region workable masks
      buffer (H, W, B) bool  — unpainted buffer (for white goals)
      pr, pc (B,) int32      — player position
    """
    from . import generate as G

    board0 = np.zeros((h, w, batch), np.uint16)
    fence_all = np.zeros((h, w, batch), bool)
    fence_slot = np.zeros((MAX_REGIONS, h, w, batch), bool)
    slots = np.zeros((MAX_REGIONS, h, w, batch), bool)
    buffer_mask = np.zeros((h, w, batch), bool)
    pr = np.zeros(batch, np.int32)
    pc = np.zeros(batch, np.int32)

    for b in range(batch):
        regions = G.make_partitioned_regions(
            (h, w), min_regions=min_regions, max_regions=max_regions)
        board = np.zeros((h, w), np.uint16)

        buffer_flat = np.flatnonzero(regions == 0)
        ai, aj = divmod(int(buffer_flat[np.random.randint(
            len(buffer_flat))]), w)
        board[ai, aj] = C.PLAYER
        di = np.abs(np.arange(h)[:, None] - ai)
        dj = np.abs(np.arange(w)[None, :] - aj)
        dist = np.minimum(di, h - di) + np.minimum(dj, w - dj)
        dist = np.where(regions == 0, dist, -1)
        ei, ej = divmod(int(np.argmax(dist)), w)
        board[ei, ej] = C.LEVEL_EXIT | C.COLOR_R

        # 3x3 aprons: no region may touch the player or the exit.
        for ci, cj in ((ai, aj), (ei, ej)):
            rows = np.arange(ci - 1, ci + 2) % h
            cols = np.arange(cj - 1, cj + 2) % w
            regions[rows[:, None], cols[None, :]] = -1

        region_ids = [int(k) for k in np.unique(regions) if k > 0]
        fences = np.zeros((h, w), bool)
        for n, k in enumerate(region_ids[:MAX_REGIONS]):
            m = regions == k
            f = np.asarray(G.build_fence(m), bool)
            f &= (board == 0)  # never fence over the player/exit
            fences |= f
            slots[n, :, :, b] = m
            fence_slot[n, :, :, b] = f
        fence_all[:, :, b] = fences
        # The buffer is everything outside the regions — fences and the
        # player/exit cells included (gen_game's white-goal rule colors
        # every uncolored buffer cell).
        buffer_mask[:, :, b] = regions <= 0
        board0[:, :, b] = board
        pr[b], pc[b] = ai, aj
    return dict(board0=board0, fence=fence_all, fence_slot=fence_slot,
                slots=slots, buffer=buffer_mask, pr=pr, pc=pc)


# Region layer vocabulary for the partitioned painter: static per-task
# specs mirroring the presets.py named regions (reference _defaults.yaml
# named_regions).  Where the reference draws per-level 'choices' (region
# variant, fill bands, lattice color) we collapse to the archives'
# REALIZED ensemble: fills target realized means (our annealer stops
# growing at min_fill; the reference's retry loop lands mid-band) and the
# medium-vs-hard region choice becomes a per-level coin on the hard
# decoration (``hardened`` = (per-level prob, per-cell frac)).
#
# Layer keys: kind 'pattern'|'lattice'|'spawners'|'random'; color (u16,
# or 'gy' = per-level green/yellow coin); target 'board'|'goals'; period;
# fill/temp; wall/tree density-penalty pairs; movable (movable_walls
# frac); hardened; rate (spawner or fill density); osc (oscillation
# bonus); fence (fence fraction of the stack's first layer).
def _pat(color, target="board", period=1, fill=0.1, temp=0.5,
         wall=(1.0, 20.0), tree=(100.0, 100.0), movable=0.0,
         hardened=(0.0, 0.0), osc=0.0, fence=0.0):
    return dict(kind="pattern", color=color, target=target, period=period,
                fill=fill, temp=temp, wall=wall, tree=tree,
                movable=movable, hardened=hardened, osc=osc, fence=fence)


_APPEND_MED = (
    _pat(C.COLOR_G, fill=0.1, temp=0.5, tree=(1.0, 20.0), movable=0.3,
         fence=1.0),
    _pat(C.COLOR_B, target="goals", fill=0.05, temp=0.2, wall=(0.0, 20.0),
         movable=1.0),
)
_APPEND_DYN = (
    _pat(C.COLOR_G, period=2, fill=0.16, temp=0.5, tree=(1.0, 20.0),
         movable=0.1, osc=0.3, fence=1.0),
    _pat(C.COLOR_B, target="goals", period=2, fill=0.10, temp=0.8,
         wall=(0.0, 20.0), movable=1.0),
)
_PRUNE_MED = (
    _pat(C.COLOR_G, fill=0.1, temp=0.5, tree=(1.0, 20.0), movable=0.3,
         fence=1.0),
    _pat(C.COLOR_R, fill=0.05, temp=0.2, wall=(0.0, 20.0), movable=1.0),
)
# prune-still-hard later regions: choices ['prune medium', 'prune hard']
# (red fill bands 0.05-0.2 / 0.15-0.4, hard red is fully hardened).
_PRUNE_MED_HARD = (
    _pat(C.COLOR_G, fill=0.1, temp=0.5, tree=(1.0, 20.0), movable=0.2,
         fence=1.0),
    _pat(C.COLOR_R, fill=0.12, temp=0.35, wall=(0.0, 20.0), movable=1.0,
         hardened=(0.5, 1.0)),
)
# prune-dynamic later regions: choices ['prune dynamic medium', 'hard'].
_PRUNE_DYN = (
    _pat(C.COLOR_G, period=2, fill=0.10, temp=0.5, tree=(1.0, 20.0),
         movable=0.2, osc=0.3, fence=1.0),
    _pat(C.COLOR_R, period=2, fill=0.12, temp=0.6, wall=(0.0, 20.0),
         movable=1.0, hardened=(0.5, 1.0), osc=0.3),
)
# 'berry patch': green/yellow tree lattice + a loose green still layer +
# red removal targets.  Dynamic variant oscillates.
_BERRY = (
    dict(kind="lattice", color="gy", target="board", fence=(0.5, 1.0)),
    _pat(C.COLOR_G, fill=0.1, temp=0.5, wall=(100.0, 100.0)),
    _pat(C.COLOR_R, fill=0.15, temp=0.4, movable=1.0),
)
_BERRY_DYN = (
    dict(kind="lattice", color="gy", target="board", fence=(0.5, 1.0)),
    _pat(C.COLOR_G, period=2, fill=0.1, temp=0.5, wall=(0.5, 10.0),
         tree=(0.0, 20.0), osc=0.3),
    _pat(C.COLOR_R, period=2, fill=0.15, temp=0.5, movable=1.0, osc=0.3),
)
# 'empty spawner': fenced region holding only spawners (density 0.04).
_SPAWNER_EMPTY = (
    dict(kind="spawners", color=C.COLOR_R | C.COLOR_G, target="board",
         rate=0.04, fence=1.0),
)
_YELLOW = C.COLOR_R | C.COLOR_G
# 'spawner' (navigation's starting region): spawners + a yellow tree
# lattice + a period-0 ("unstable", no violation requirement) yellow life
# fill at 0.3 — the annealed period-0 layer reduces to a density fill
# (the spawners churn it at runtime anyway), expressed as kind='random'.
_NAV_SPAWNER = (
    dict(kind="spawners", color=_YELLOW, target="board", rate=0.04,
         fence=1.0),
    dict(kind="lattice", color=_YELLOW, target="board"),
    dict(kind="random", color=_YELLOW, target="board", rate=0.3),
)
# navigation later regions, per-level choice (reference navigation.yaml):
_JUNGLE = (
    dict(kind="lattice", color=C.COLOR_G, target="board"),
    _pat(C.COLOR_G, period=2, fill=0.25, tree=(0.0, 20.0), osc=0.3),
)
_SAVANNAH = (
    _pat(C.COLOR_G, period=2, fill=0.2, wall=(0.0, 20.0), osc=0.3),
)
# easy-curriculum regions (_defaults.yaml 'build easy' / 'prune easy').
_BUILD_EASY = (
    _pat(C.COLOR_B, target="goals", fill=0.1, temp=0.2, movable=0.5,
         fence=1.0),
)
_PRUNE_EASY = (
    _pat(C.COLOR_G, fill=0.05, temp=0.5, tree=(1.0, 20.0), movable=0.3,
         fence=1.0),
    _pat(C.COLOR_R, fill=0.05, temp=0.2, wall=(1.0, 20.0)),
)


# task -> dict(regions=max partition regions, start=starting-slot stack,
# later=later-slot stack, buffer='rubble'|None, min_perf=exit gate).
# A stack is a tuple of layer dicts, or a tuple of ALTERNATIVE stacks
# (the YAML 'choices') — then each level draws one alternative per slot.
# Partitioning min_regions is always 2 (presets.TASKS).
def _spec(regions, start, later, buffer=None, min_perf=0.5):
    def norm(s):  # a bare stack -> a 1-tuple of alternatives
        return (s,) if s and isinstance(s[0], dict) else tuple(s)
    return dict(regions=regions, start=norm(start), later=norm(later),
                buffer=buffer, min_perf=min_perf)


_TASK_SPECS = {
    "append-still": _spec(3, _APPEND_MED, _APPEND_MED),
    "append-still-easy": _spec(3, _APPEND_MED, (_APPEND_MED, _BUILD_EASY)),
    "append-dynamic": _spec(2, _APPEND_DYN, _APPEND_DYN),
    "append-spawn": _spec(3, _SPAWNER_EMPTY, _APPEND_MED),
    "prune-still": _spec(3, _PRUNE_MED, _PRUNE_MED),
    "prune-still-easy": _spec(4, (_PRUNE_MED, _PRUNE_EASY),
                              (_PRUNE_MED, _PRUNE_EASY)),
    "prune-still-hard": _spec(3, _BERRY, _PRUNE_MED_HARD),
    "prune-dynamic": _spec(3, _BERRY_DYN, _PRUNE_DYN),
    "prune-spawn": _spec(3, _SPAWNER_EMPTY, _PRUNE_MED),
    "navigation": _spec(2, _NAV_SPAWNER, (_JUNGLE, _SAVANNAH),
                        buffer="rubble", min_perf=-1.0),
}


def _host_lattice(h, w):
    """The default staggered tree lattice as a (H, W) numpy mask
    (generate._lattice_cells with spec=True: spacing 5)."""
    from .generate import _lattice_cells
    return np.asarray(_lattice_cells((h, w), True), bool)


def _paint_partitioned(generator, board0, fence_slot, slots, buffer_mask,
                       batch, task, iters=1200):
    """Device phase of :func:`gen_partitioned_levels`: per region slot,
    paint the task's layer stack (generate._RegionPainter semantics) on a
    shared int32 working board, every draw from ``generator``:

      * 'pattern' layers anneal a colored still/oscillating pattern
        (walls/trees per the density penalties); fresh live cells take
        the layer color, fresh walls take the movable decoration, fresh
        life may be hardened (DESTRUCTIBLE stripped).  target='goals'
        layers keep their color in the goal copy and put only their
        non-live cells (crates) on the board.
      * 'lattice' layers stamp the tree lattice (berry patches), with a
        per-level green/yellow color coin.
      * 'spawners' layers scatter spawners over the region interior
        (at least one per region, reference add_spawners).

    The fences painted by the scaffold take the first layer's
    movable_walls decoration (reference paint_layer: new_cells covers
    the fences).  Oscillating cells and their neighborhoods are frozen
    against later layers (run_pattern's CAN_OSCILLATE bookkeeping); the
    oscillation is found with one step of K5.
    Returns (board, goals) as (H, W, B) uint16 and converged (B,) bool.
    """
    dev = generator.device
    board = board0.to(torch.int32)
    h, w = board.shape[:2]
    shape = board.shape
    fg = board != 0
    bg = torch.zeros(shape, dtype=torch.bool, device=dev)
    keep_color = torch.zeros_like(bg)
    osc_forbid = torch.zeros_like(bg)
    conv_all = torch.ones(batch, dtype=torch.bool, device=dev)
    spec = _TASK_SPECS[task]
    lattice = torch.as_tensor(_host_lattice(h, w), device=dev)[..., None]

    def uniform():
        return torch.rand(shape, generator=generator, device=dev)

    def randint(n):
        return torch.randint(n, (batch,), generator=generator, device=dev)

    for r in range(spec["regions"]):
        alts = spec["start"] if r == 0 else spec["later"]
        # The YAML 'choices' between region stacks: one draw per level per
        # slot; each alternative's layers then apply only to its lanes
        # (the others see empty masks and no-op).
        lane_sel = [None] * len(alts)
        if len(alts) > 1:
            choice = randint(len(alts))
            lane_sel = [(choice == a)[None, None, :]
                        for a in range(len(alts))]

        for layers, lane in zip(alts, lane_sel):
            def gate(m, lane=lane):
                return m if lane is None else m & lane

            # Fences: per-cell coinflip at the stack's fence fraction
            # (reference add_fences; a tuple is the YAML per-level
            # 'choices' between fractions, e.g. berry patch [0.5, 1]).
            frac = layers[0].get("fence", 0.0)
            if frac:
                if isinstance(frac, tuple):
                    fracs = torch.tensor(frac, dtype=torch.float32,
                                         device=dev)
                    frac = fracs[randint(len(frac))][None, None, :]
                fc = gate(fence_slot[r]) & (board == 0) & (uniform() < frac)
                board = torch.where(fc, C.WALL, board)
                fg |= fc
                bg |= fc
                mov0 = layers[0].get("movable", 0.0)
                if mov0 > 0:
                    mw_f = fc & (uniform() < mov0)
                    board = torch.where(mw_f, board | C.MOVABLE, board)

            for layer in layers:
                avail = gate(slots[r] & (board == 0) & ~osc_forbid)
                color = layer["color"]
                if color == "gy":
                    coin = torch.rand(batch, generator=generator,
                                      device=dev) < 0.5
                    color = torch.where(coin, C.COLOR_G, C.COLOR_R | C.COLOR_G)
                    color = color.to(torch.int32)[None, None, :]

                if layer["kind"] == "spawners":
                    interior = avail & ~_dilate(~slots[r])
                    cells = interior & (uniform() < layer["rate"])
                    # Guarantee >= 1 spawner when the region exists
                    # (reference add_spawners).
                    flat_int = interior.reshape(h * w, batch)
                    none = ~cells.reshape(h * w, batch).any(0)
                    pick = _gumbel_pick(flat_int, generator)
                    forced = (torch.arange(h * w, device=dev)[:, None]
                              == pick[None, :]) & none[None, :] & flat_int
                    cells = cells | forced.reshape(shape)
                    board = torch.where(cells, color | C.SPAWNER, board)
                    fg |= cells
                    bg |= cells
                    continue

                if layer["kind"] == "lattice":
                    cells = lattice & avail
                    board = torch.where(cells, color | C.TREE, board)
                    fg |= cells
                    bg |= cells
                    continue

                if layer["kind"] == "random":
                    # A period-0 ("unstable") layer: density fill of plain
                    # life with no violation requirement (the reference
                    # anneals with INCLUDE_VIOLATIONS_MASK dropped, which
                    # converges to a penalty-only density fill;
                    # generate._RegionPainter.run_pattern).
                    cells = avail & (uniform() < layer["rate"])
                    board = torch.where(cells, color | C.LIFE, board)
                    fg |= cells
                    bg |= cells
                    continue

                # Annealed pattern layer.
                period = layer["period"]
                pens = ((0.0, 0.0), tuple(layer["wall"]), (0.0, 0.0),
                        tuple(layer["tree"]))
                grown, conv1 = gen_still_lifes(
                    generator, avail, batch, board=board.to(torch.uint16),
                    iters=iters, min_fill=layer["fill"],
                    temperature=layer["temp"], cell_penalties=pens,
                    period=period, osc_bonus=layer["osc"])
                board1 = grown.to(torch.int32)
                new = board1 != board
                alive_new = new & ((board1 & C.ALIVE) != 0)
                board1 = torch.where(alive_new, board1 | color, board1)
                if layer["movable"] > 0:
                    is_wall = new & ((board1 & ~C.COLORS) == C.WALL)
                    mw = is_wall & (uniform() < layer["movable"])
                    board1 = torch.where(mw, board1 | C.MOVABLE, board1)
                lvl_p, cell_f = layer["hardened"]
                if lvl_p > 0:
                    lanes = torch.rand(batch, generator=generator,
                                       device=dev) < lvl_p
                    hard = alive_new & lanes[None, None, :]
                    if cell_f < 1.0:
                        hard = hard & (uniform() < cell_f)
                    board1 = torch.where(hard, board1 & ~C.DESTRUCTIBLE,
                                         board1)
                if period > 1:
                    # Freeze the oscillators' neighborhoods against later
                    # layers: edits there would propagate into the cycle
                    # (generate._RegionPainter.run_pattern).
                    u16 = board1.to(torch.uint16)
                    nxt = bits16(advance_with_field(u16, _zeros_field(u16)))
                    osc = (nxt != 0) != (board1 != 0)
                    osc_forbid |= _dilate(osc)
                bg |= new
                if layer["target"] == "goals":
                    keep_color |= new
                    # Goal-layer walls still land on the board as crates;
                    # only its live cells are goal-only (mark_targets).
                    fg |= new & ~alive_new
                else:
                    fg |= new
                board = board1
                conv_all &= conv1

    if spec["buffer"] == "rubble":
        # navigation's 'rubble' buffer: black walls scattered over the
        # unpainted buffer at ~0.3 fill (the wall-bonus anneal of
        # _defaults.yaml 'rubble' converges to a wall density fill).
        rubble = buffer_mask & (board == 0) & (uniform() < 0.3)
        board = torch.where(rubble, C.WALL, board)
        fg |= rubble
        bg |= rubble

    final_board = torch.where(fg, board, 0)
    goals = torch.where(bg, board, 0) & ~C.SPAWNING
    goals = torch.where(keep_color, goals, goals & ~C.COLORS)
    # White buffer goals (visual hint, gen_game): every uncolored buffer
    # cell — fence copies included — gains the white color.
    white = buffer_mask & ((goals & C.COLORS) == 0)
    goals = torch.where(white, goals | C.COLORS, goals)
    return final_board.to(torch.uint16), goals.to(torch.uint16), conv_all


def gen_partitioned_levels(task, num_levels, seed=0, h=26, w=26,
                           iters=1200, device=None):
    """Generate a bank of multi-region levels from the task distribution
    (partition -> fence -> layered regions), annealing on ``device``
    (``cuda`` unless the caller passes another).  Supported tasks: all 8
    benchmark families (append/prune x still/still-hard/dynamic/spawn +
    navigation) plus the easy curriculum variants (append-still-easy,
    prune-still-easy), each mapped to its preset region stack
    (:data:`_TASK_SPECS`), including the per-level 'choices' between
    alternative region stacks.  ``seed`` seeds numpy's global generator
    for the scaffolds and the device generator for the painting.

    Returns (LevelBank, converged (B,) bool).  Cite: reference
    proc_gen.py:474-594 (gen_game) + levels/random/*.yaml.
    """
    from ..levels.device_bank import build_bank_from_arrays

    dev = resolve_device(device)
    spec = _TASK_SPECS[task]
    np.random.seed(seed)
    sc = _partition_scaffolds(num_levels, h, w,
                              max_regions=spec["regions"])
    gen = torch.Generator(dev)
    gen.manual_seed(seed)

    def put(x):
        return torch.as_tensor(x, device=dev)

    board, goals, conv = _paint_partitioned(
        gen, put(sc["board0"]), put(sc["fence_slot"]), put(sc["slots"]),
        put(sc["buffer"]), batch=num_levels, task=task, iters=iters)
    all_layers = [layer for stack in (spec["start"] + spec["later"])
                  for layer in stack]
    static_goals = all(layer.get("period", 1) == 1 for layer in all_layers)
    has_spawners = any(layer["kind"] == "spawners" for layer in all_layers)
    bank = build_bank_from_arrays(
        board, goals, put(sc["pr"]), put(sc["pc"]),
        min_performance=spec["min_perf"],
        spawn_prob=torch.full((num_levels,), 0.3, dtype=torch.float32,
                              device=dev) if has_spawners else None,
        static_goals=static_goals, spawnless=not has_spawners,
        simple_goals=not static_goals,
        max_exits=1)  # the factory places exactly one exit per level
    return bank, conv
