"""The environment step core as two kernels (counterpart of
``safelife_tpu.ops.env_step_pallas``).

:func:`fused_step` computes the hot path of ``BatchedSafeLifeEnv.step``:

* K1, action: decode the action, read the agent's four neighborhood
  cells, push / pull / exit / toggle (``csrc/env_step_kernels.cu``
  ``action_kernel``);
* K2/K3, advance: the CA advance, goal scoring, the exit gate and exit
  recolour, the side-effect count and, with ``time_limit > 0`` (K2), the
  auto-reset fold of the three boards and optionally the packed
  agent-centred view (``advance_kernel``).

Each kernel has a plain PyTorch version here that repeats its arithmetic
on tensors.  :func:`fused_step` launches the kernels on CUDA tensors and
runs the plain versions on CPU tensors; :func:`fused_step_plain` runs the
plain versions on any device, as the reference the kernels are held to.

K2/K3 inline the CA rule that the bank's flags pick (:data:`RULES`, with
the precedence of ``env_step_pallas.py:317-335``) and the spawn draw of
:mod:`.rng` (:data:`DRAWS`: none on spawnless banks, the paired 16-bit
draw where the goals spawn too, 24 bits for the board otherwise).
"""

import torch

from .. import bits16
from .. import cells as C
from . import _build, rng
from .agent import gather_cells, masked_set
from .life_kernels import (_advance_block, _advance_pair,
                           _advance_pair_spawnsimple,
                           _advance_with_simple_goals)
from .obs import combine_board_goals, exit_offsets, put_exits, recenter

# The CA rules of K2/K3 (csrc/env_step_kernels.cu enum Rule, in order):
# static goals without and with spawners, certified simple goals,
# spawn-simple goals, and the general pair.
RULES = ("static_spawnless", "static", "simple", "spawn_simple", "general")
# The spawn draws (csrc/philox.cuh enum Draw, in order).
DRAWS = ("none", "u24", "pair")

_DR = (-1, 0, 1, 0)
_DC = (0, 1, 0, -1)
# K2 assembles the views of a block of 32 environments in shared memory:
# 2 bytes per cell and environment, within 227 KB less its 1.5 KB of sums.
_MAX_VIEW_CELLS = (232448 - 1536) // 64

# Each goal-color row of the 8x8 point table packed into one int32: entry
# value+3 (in [0, 8]) in bits [4c, 4c+4).  csrc/safelife_rule.cuh holds
# the same constants.
_PACKED_ROWS = tuple(
    int(sum((int(v) + 3) << (4 * c) for c, v in enumerate(row)))
    for row in C.POINT_TABLE)


def _select_by_orient(o, table):
    out = torch.full_like(o, table[0])
    for k in (1, 2, 3):
        out = torch.where(o == k, table[k], out)
    return out


def _pts_cell(gc, cc):
    """point_table[gc, cc] per cell via select-tree row pick + shift."""
    R = [torch.tensor(r, dtype=torch.int32, device=gc.device)
         for r in _PACKED_ROWS]
    b0 = (gc & 1) != 0
    b1 = (gc & 2) != 0
    b2 = (gc & 4) != 0
    t01 = torch.where(b0, R[1], R[0])
    t23 = torch.where(b0, R[3], R[2])
    t45 = torch.where(b0, R[5], R[4])
    t67 = torch.where(b0, R[7], R[6])
    packed = torch.where(b2, torch.where(b1, t67, t45),
                         torch.where(b1, t23, t01))
    return ((packed >> (cc * 4)) & 15) - 3


# ---------------------------------------------------------------------------
# K1: action
# ---------------------------------------------------------------------------

def _apply_action(board, si):
    """Agent action execution on an int32 (H, W, B) board.

    Reads action, agent row/col, orientation, game_over and can_exit0 from
    ``si`` rows 0-5; returns ``(board', agent_row', agent_col',
    orientation', exited)``.
    """
    h, w, b = board.shape
    action, r0, c0, orient, game_over, can_exit0 = si[:6]
    is_move = (action >= 1) & (action <= 4) & (game_over == 0)
    is_toggle = (action >= 5) & (action <= 8) & (game_over == 0)
    new_orient = torch.where(is_move | is_toggle,
                             torch.remainder(action - 1, 4), orient)
    dr = _select_by_orient(new_orient, _DR)
    dc = _select_by_orient(new_orient, _DC)
    i0 = r0 * w + c0
    r1, c1 = torch.remainder(r0 + dr, h), torch.remainder(c0 + dc, w)
    i1 = r1 * w + c1
    i2 = torch.remainder(r0 - dr, h) * w + torch.remainder(c0 - dc, w)
    i3 = torch.remainder(r0 + 2 * dr, h) * w + torch.remainder(c0 + 2 * dc, w)

    flat = board.reshape(h * w, b).clone()
    v0, v1, v2, v3 = gather_cells(flat, torch.stack([i0, i1, i2, i3]))

    front_empty = v1 == 0
    front_exit = ~front_empty & ((v1 & C.EXIT) != 0) & (can_exit0 != 0)
    pushable = ~front_empty & ~front_exit & ((v1 & C.PUSHABLE) != 0)
    push_to_empty = pushable & (v3 == 0)
    push_out_exit = pushable & (v3 != 0) & ((v3 & C.EXIT) != 0)
    moved = is_move & (front_empty | push_to_empty | push_out_exit)
    exited = is_move & front_exit
    pulled = moved & ((v2 & C.PULLABLE) != 0)

    player_color = v0 & C.COLORS
    tgl_create = is_toggle & (v1 == 0)
    tgl_destroy = is_toggle & (v1 != 0) & ((v1 & C.DESTRUCTIBLE) != 0)

    zero = torch.zeros_like(v0)
    p1_val = torch.where(moved, v0,
                         torch.where(tgl_create, C.LIFE | player_color, zero))
    p0_val = torch.where(pulled, v2, zero)
    # The writes in the kernel's order; a later one wins where two land
    # on one cell (boards narrower than four cells).
    masked_set(flat, i3, v1, is_move & push_to_empty)
    masked_set(flat, i1, p1_val, moved | tgl_create | tgl_destroy)
    masked_set(flat, i2, zero, pulled)
    masked_set(flat, i0, p0_val, moved)
    return (flat.reshape(h, w, b), torch.where(moved, r1, r0),
            torch.where(moved, c1, c0), new_orient, exited)


def action_plain(si, board):
    """The plain version of K1: ``(board', act_i)`` with act_i rows agent
    row, agent col, orientation, exited (int32)."""
    out, ar, ac, orient, exited = _apply_action(board.to(torch.int32), si)
    return out.to(torch.uint16), torch.stack(
        [ar, ac, orient, exited.to(torch.int32)])


# K1's block widths in threads (csrc/env_step_kernels.cu sl_action_block).
ACTION_BLOCKS = (64, 128, 256, 512, 1024)


def apply_action(si, board, block=None):
    """K1 on a CUDA board, its plain version on a CPU board.

    ``block=None`` is the main path's 128-thread launch; a width from
    :data:`ACTION_BLOCKS` launches the same kernel at that block width
    (the block sweep, counted per width)."""
    if board.device.type == "cpu":
        return action_plain(si, board)
    _build.check_cuda(board, si, dtypes=(torch.uint16, torch.int32))
    if block is not None and block not in ACTION_BLOCKS:
        raise ValueError(f"K1 runs at block widths {ACTION_BLOCKS}, "
                         f"not {block}")
    h, w, b = board.shape
    if si.dim() != 2 or si.shape[0] < 6 or si.shape[1] != b:
        raise ValueError(f"K1 reads si rows 0-5 of (rows, {b}), not "
                         f"{tuple(si.shape)}")
    out = torch.empty_like(board)
    act_i = torch.empty((4, b), dtype=torch.int32, device=board.device)
    if b:
        ptrs = (si.data_ptr(), board.data_ptr(), out.data_ptr(),
                act_i.data_ptr(), h, w, b)
        if block is None:
            _build.launch("K1_action", "env_step_kernels", "sl_action", *ptrs)
        else:
            _build.launch(f"S2_action_block[{block}]", "env_step_kernels",
                          "sl_action_block", *ptrs, block)
    return out, act_i


# ---------------------------------------------------------------------------
# K2/K3: advance, scoring, exit recolour, side effects, fold, view
# ---------------------------------------------------------------------------

def pick_rule(static_goals, spawnless, simple_goals, spawn_simple_goals):
    """The CA rule of K2/K3 for the bank's flags, with the precedence of
    ``env_step_pallas.py:317-335``: static, simple, spawn-simple, general."""
    if static_goals:
        return "static_spawnless" if spawnless else "static"
    if simple_goals:
        return "simple"
    return "spawn_simple" if spawn_simple_goals else "general"


def pick_draw(rule, spawnless):
    """The spawn draw of ``rule`` (``env_step_pallas.py:303-316``): none on
    a spawnless bank, one word split between board and goals where the
    goals spawn too, 24 bits for the board otherwise."""
    if spawnless:
        return "none"
    return "pair" if rule in ("spawn_simple", "general") else "u24"


def _advance_rule(board, goals, rule, draw, seed, spawn_prob):
    """The CA advance of K2/K3 on int32 boards: ``(board', goals')``, the
    goals unchanged under the static rules."""
    spawn_b = spawn_g = None
    if draw == "u24":
        spawn_b = rng.spawn_field24(seed, spawn_prob, board.shape)
    elif draw == "pair":
        spawn_b, spawn_g = rng.spawn_field_pair(seed, spawn_prob, board.shape)
    if rule in ("static_spawnless", "static"):
        return _advance_block(board, spawn_b), goals
    if rule == "simple":
        return _advance_with_simple_goals(board, spawn_b, goals)
    if rule == "spawn_simple":
        return _advance_pair_spawnsimple(board, spawn_b, goals, spawn_g)
    return _advance_pair(board, spawn_b, goals, spawn_g)


def advance_plain(si, sf, act_i, obs_i, board1, goals, init_board, fresh,
                  time_limit, obs_view, remove_white_goals=True,
                  rule="static_spawnless", draw="none", seed=None):
    """The plain version of K2 (``time_limit > 0``) and K3.

    ``fresh`` is the (board, goals, init_board) of the fresh levels (fold
    only); ``obs_view`` (vh, vw) asks for the packed view (fold only);
    ``rule`` and ``draw`` are from :func:`pick_rule` and :func:`pick_draw`,
    ``seed`` the step's int32 seed tensor (read where ``draw`` is not
    "none").  Returns ``(board', goals', init_board' or None, view or None,
    out_i)`` with out_i rows points, perf_completed, perf_possible,
    can_exit1, side-effect count.
    """
    board, goals = _advance_rule(board1.to(torch.int32), goals.to(torch.int32),
                                rule, draw, seed, sf[0])
    dynamic = rule not in ("static_spawnless", "static")
    zero = torch.zeros_like(board)

    # ---- scoring (on the advanced goals) -----------------------------------
    alive = (board & 1) != 0
    gc = (goals >> C.COLOR_BIT) & 7
    pts_cell = _pts_cell(gc, (board >> C.COLOR_BIT) & 7)
    points = torch.where(alive, pts_cell, zero).sum((0, 1), dtype=torch.int32)
    frozen_immov = (board & (C.FROZEN | C.PUSHABLE | C.PULLABLE)) == C.FROZEN
    score = torch.where(alive & ~frozen_immov, torch.sign(pts_cell),
                        zero).sum((0, 1), dtype=torch.int32)
    comp = score - si[6]
    if dynamic:
        poss = ((gc != 0) & (gc != 7)).sum((0, 1), dtype=torch.int32) - si[6]
    else:
        # Static goals: the possible score is the live per-env value.
        poss = si[8]

    # ---- exit recolour -----------------------------------------------------
    min_perf = sf[1]
    ce1 = (min_perf < 0) | (comp.to(torch.float32)
                            >= min_perf * poss.to(torch.float32))
    init = init_board.to(torch.int32)
    exit_mask = (init & C.EXIT) != 0
    exit_cell = torch.where(ce1, C.LEVEL_EXIT | C.COLOR_R, C.LEVEL_EXIT)
    board = torch.where(exit_mask, exit_cell.to(torch.int32), board)

    # ---- side-effect cell count -------------------------------------------
    bb = board & ~C.PLAYER
    sb = init & ~C.PLAYER
    bb = torch.where(exit_mask, sb, bb)
    red_life = C.ALIVE | C.COLOR_R
    start_red = (sb & red_life) == red_life
    end_red = (bb & red_life) == red_life
    goal_cell = (goals & C.COLORS) == C.COLOR_B
    end_alive = (bb & red_life) == C.ALIVE
    non_effects = (bb == sb) | (start_red & ~end_red) | (goal_cell & end_alive)
    effect = (~non_effects).sum((0, 1), dtype=torch.int32)
    out_i = torch.stack([points, comp, poss, ce1.to(torch.int32), effect])

    if time_limit <= 0:
        return (board.to(torch.uint16), goals.to(torch.uint16), None, None,
                out_i)

    # ---- auto-reset fold --------------------------------------------------
    done = ((si[7] + 1 > time_limit) | (si[4] != 0) | (act_i[3] != 0))
    m = done[None, None, :]
    fresh_b, fresh_g, fresh_i = (x.to(torch.int32) for x in fresh)
    final_b = torch.where(m, fresh_b, board)
    final_g = torch.where(m, fresh_g, goals)
    final_i = torch.where(m, fresh_i, init)
    view = None
    if obs_view is not None:
        view = _view_plain(final_b, final_g, done, act_i, obs_i, ce1,
                           obs_view, remove_white_goals, dynamic)
    return (final_b.to(torch.uint16), final_g.to(torch.uint16),
            final_i.to(torch.uint16), view, out_i)


def _view_plain(final_b, final_g, done, act_i, obs_i, ce1, obs_view,
                remove_white_goals, dynamic):
    """Packed (vh, vw, B) view of the post-reset boards, exits projected.
    On static goals the exit pixels are built from per-environment values;
    on dynamic goals they are read from the final boards."""
    h, w, b = final_b.shape
    k = (obs_i.shape[0] - 3) // 8
    sel = lambda fresh, live: torch.where(done, fresh, live)  # noqa: E731
    ar = sel(obs_i[0], act_i[0])
    ac = sel(obs_i[1], act_i[1])
    rows = lambda base, stride=3: sel(  # noqa: E731
        obs_i[base + stride * k:base + stride * k + k], obs_i[base:base + k])
    exit_r, exit_c, exit_v = rows(2), rows(2 + k), rows(2 + 2 * k)

    combined = combine_board_goals(final_b, final_g, remove_white_goals)
    if dynamic:
        lanes = torch.arange(b, device=final_b.device)
        vals = bits16(combined)[exit_r.long(), exit_c.long(), lanes].view(
            combined.dtype)
    else:
        gcol = rows(2 + 6 * k, stride=1)
        if remove_white_goals:
            gcol = torch.where(gcol == 7, torch.zeros_like(gcol), gcol)
        gate = sel(obs_i[2 + 8 * k], ce1.to(torch.int32))
        vals = (C.LEVEL_EXIT | gate * C.COLOR_R | (gcol << (C.COLOR_BIT + 3)))
    view = recenter(combined, ar, ac, obs_view)
    jy, jx = exit_offsets(exit_r, exit_c, ar, ac, (h, w), obs_view)
    return put_exits(view, jy, jx, exit_v, vals)


def advance(si, sf, act_i, obs_i, board1, goals, init_board, fresh,
            time_limit, obs_view, remove_white_goals=True,
            rule="static_spawnless", draw="none", seed=None):
    """K2 (``time_limit > 0``) or K3 on CUDA boards, the plain version on
    CPU boards; arguments and results as :func:`advance_plain`."""
    if board1.device.type == "cpu":
        return advance_plain(si, sf, act_i, obs_i, board1, goals,
                             init_board, fresh, time_limit, obs_view,
                             remove_white_goals, rule, draw, seed)
    do_reset = time_limit > 0
    boards = (board1, goals, init_board) + (tuple(fresh) if do_reset else ())
    _build.check_cuda(*boards, dtypes=(torch.uint16,) * len(boards))
    _build.check_cuda(si, sf, dtypes=(torch.int32, torch.float32))
    h, w, b = board1.shape
    if any(x.shape != board1.shape for x in boards):
        raise ValueError("all boards must share one (H, W, B) shape")
    if obs_view is not None and not do_reset:
        raise ValueError("the view is emitted on the fold path only")
    if obs_view is not None and obs_view[0] * obs_view[1] > _MAX_VIEW_CELLS:
        raise ValueError(f"K2 holds views of up to {_MAX_VIEW_CELLS} cells "
                         f"in shared memory, not {obs_view}")
    if draw != "none":
        _build.check_cuda(board1, seed, dtypes=(torch.uint16, torch.int32))
    if do_reset:
        _build.check_cuda(act_i, dtypes=(torch.int32,))
    vh, vw = obs_view if obs_view is not None else (0, 0)
    num_exits = 0
    if obs_view is not None:
        _build.check_cuda(obs_i, dtypes=(torch.int32,))
        num_exits = (obs_i.shape[0] - 3) // 8
    out_board = torch.empty_like(board1)
    out_goals = torch.empty_like(board1)
    out_init = torch.empty_like(board1) if do_reset else None
    view = (torch.empty((vh, vw, b), dtype=torch.uint16, device=board1.device)
            if obs_view is not None else None)
    out_i = torch.empty((5, b), dtype=torch.int32, device=board1.device)
    fb, fg, fi = fresh if do_reset else (None, None, None)
    kernel = "K2_advance_fold" if do_reset else "K3_advance_noreset"
    if b:
        _build.launch(
            f"{kernel}[{rule}]", "env_step_kernels", "sl_advance",
            *map(_build.ptr, (seed if draw != "none" else None, si, sf,
                              act_i if do_reset else None, obs_i,
                              board1, goals, init_board, fb, fg, fi,
                              out_board, out_goals, out_init, view, out_i)),
            h, w, b, int(time_limit), vh, vw, num_exits,
            int(remove_white_goals), RULES.index(rule), DRAWS.index(draw))
    return out_board, out_goals, out_init, view, out_i


# ---------------------------------------------------------------------------
# The fused step
# ---------------------------------------------------------------------------

def kernel_args(board, goals, init_board, action, agent_row, agent_col,
                orientation, game_over, can_exit0, baseline_score,
                spawn_prob, min_performance, seed=None, static_goals=False,
                episode_length=None, fresh=None, time_limit=0,
                spawnless=False, simple_goals=False, spawn_simple_goals=False,
                obs_view=None, exit_row=None, exit_col=None, exit_valid=None,
                exit_gcol=None, remove_white_goals=True, perf_possible=None):
    """The arguments of K1 and K2/K3 for :func:`fused_step`'s arguments:
    the per-env values packed into the ``si`` (int32), ``sf`` (float32)
    and ``obs_i`` (int32) row tables the kernels read, the bank's rule and
    draw, and the step's seed as an int32 tensor on the boards' device."""
    if static_goals and perf_possible is None:
        raise ValueError("static_goals=True needs the live perf_possible")
    rule = pick_rule(static_goals, spawnless, simple_goals,
                     spawn_simple_goals)
    draw = pick_draw(rule, spawnless)
    b = board.shape[-1]
    dev = board.device
    if draw != "none" and seed is None:
        raise ValueError(f"the {rule} rule draws spawns: pass the seed")

    def i32(x):
        return torch.as_tensor(x, device=dev).to(torch.int32)

    zeros = torch.zeros(b, dtype=torch.int32, device=dev)
    si = torch.stack([
        i32(action), i32(agent_row), i32(agent_col), i32(orientation),
        i32(game_over), i32(can_exit0), i32(baseline_score),
        zeros if episode_length is None else i32(episode_length),
        zeros if perf_possible is None else i32(perf_possible)])
    sf = torch.stack([torch.as_tensor(spawn_prob, device=dev),
                      torch.as_tensor(min_performance, device=dev)]).to(
                          torch.float32)
    emit_obs = obs_view is not None and time_limit > 0
    obs_i = None
    if emit_obs:
        mp = fresh["min_performance"].to(torch.float32)
        fresh_ce0 = (mp < 0) | (
            0 >= mp * fresh["perf_possible"].to(torch.float32))
        obs_i = torch.cat([
            torch.stack([i32(fresh["agent_row"]), i32(fresh["agent_col"])]),
            i32(exit_row), i32(exit_col), i32(exit_valid),
            i32(fresh["exit_row"]), i32(fresh["exit_col"]),
            i32(fresh["exit_valid"]), i32(exit_gcol), i32(fresh["exit_gcol"]),
            i32(fresh_ce0)[None]])
    return dict(
        si=si, sf=sf, obs_i=obs_i, board=board, goals=goals,
        init_board=init_board,
        fresh=((fresh["board"], fresh["goals"], fresh["init_board"])
               if time_limit > 0 else None),
        time_limit=time_limit, obs_view=obs_view if emit_obs else None,
        remove_white_goals=remove_white_goals, rule=rule, draw=draw,
        seed=None if draw == "none" else i32(seed).reshape(1))


def run_kernels(args, plain=False):
    """K1 then K2/K3 on :func:`kernel_args`' output (their plain versions
    with ``plain``); returns :func:`fused_step`'s tuple."""
    board1, act_i = (action_plain if plain else apply_action)(
        args["si"], args["board"])
    out_board, out_goals, out_init, view, adv_i = (
        advance_plain if plain else advance)(
            args["si"], args["sf"], act_i, args["obs_i"], board1,
            args["goals"], args["init_board"], args["fresh"],
            args["time_limit"], args["obs_view"], args["remove_white_goals"],
            args["rule"], args["draw"], args["seed"])
    ret = (out_board, out_goals, act_i[0], act_i[1], act_i[2],
           act_i[3] != 0, adv_i[0], adv_i[1], adv_i[2], adv_i[3] != 0,
           adv_i[4])
    if args["time_limit"] > 0:
        ret += (out_init,)
    return ret + (view,) if view is not None else ret


def fused_step(*args, **kwargs):
    """Run the env-step core: K1 then K2/K3 on CUDA boards, the plain
    versions on CPU boards.  Boards are (H, W, B) uint16, per-env
    arguments (B,).

    With ``time_limit > 0`` the auto-reset select of the three boards is
    folded into the advance: pass ``episode_length`` and ``fresh`` (the
    fresh levels' fields).  With ``obs_view=(vh, vw)`` as well (pass the
    live exit tables), the packed agent-centred view is appended.

    Returns (board', goals', agent_row', agent_col', orientation', exited,
    points, perf_completed, perf_possible, can_exit1, side_effect_count
    [, init_board'][, obs_view_packed]).
    """
    return run_kernels(kernel_args(*args, **kwargs))


def fused_step_plain(*args, **kwargs):
    """:func:`fused_step` through the plain versions, on any device."""
    return run_kernels(kernel_args(*args, **kwargs), plain=True)
