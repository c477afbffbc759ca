"""Side-effect scoring: future cell-density divergence between action and
inaction trajectories (port of ``safelife_tpu.side_effects``).

Capability parity with ``safelife/side_effects.py`` (reference):

* ``side_effect_score`` simulates the game board forward from (a) the
  episode's final state and (b) the untouched initial state rolled forward
  the same number of steps, accumulates per-cell-type occupancy
  distributions over ``num_samples`` further steps, and scores each cell
  type by the earth-mover distance between the two distributions
  (``side_effects.py:95-161``).
* Cell canonicalization (``_add_cell_distribution``,
  ``side_effects.py:59-86``): "unchanging" cells (frozen, indestructible,
  immovable) are dropped; the destructible bit is stripped and re-added for
  life-like and spawner cells so destructible/indestructible variants merge;
  colors stay distinct; agent/empty cells are skipped.
* EMD (``earth_mover_distance``, ``side_effects.py:12-56``): torus
  manhattan metric, ``tanh(dist/5)`` cap, extra-mass penalty 1.0.

The batched path scores B episodes at once over a static set of tracked
cell types.  Its co-evolution (``catch_up_steps + 2 * num_samples`` CA
advances) runs kernel K5 (``life_kernels.advance_with_field``) on a CUDA
device, with spawn fields drawn by ``torch.rand`` from the caller's
generator, and the plain ``ops/life.advance_board`` on the CPU.  Its EMD
is entropic optimal transport (Sinkhorn) over the full grid, with a sink
node absorbing the mass imbalance, in float32 with TF32 off: the Gibbs
kernel ``exp(-cost / 0.02)`` reaches 2e-22, so a lower precision gives
another score.  The host path (:func:`side_effect_score`) solves the
exact transportation LP (scipy HiGHS) restricted to changed cells, as the
reference's pyemd call does.
"""

import contextlib

import numpy as np
import torch

from . import bits16
from . import cells as C
from .ops import life, life_kernels, life_numpy

MOVABLE = C.PUSHABLE | C.PULLABLE

# Default tracked canonical cell types: life and spawners in all 8 colors
# (the destructible bit is part of the canonical key, matching the
# reference's merge of destructible/indestructible variants).
TRACKED_LIFE = tuple((C.ALIVE | C.DESTRUCTIBLE) | (c << C.COLOR_BIT)
                     for c in range(8))
TRACKED_SPAWNERS = tuple(
    (C.FROZEN | C.SPAWNING | C.DESTRUCTIBLE) | (c << C.COLOR_BIT)
    for c in range(8))
DEFAULT_TRACKED = TRACKED_LIFE + TRACKED_SPAWNERS


def canonical_key(cell):
    """Canonical type key of a raw cell value (host helper, scalar/array)."""
    cell = np.asarray(cell, np.uint16)
    unchanging = (cell & (C.FROZEN | C.DESTRUCTIBLE | MOVABLE)) == C.FROZEN
    canon = (cell & ~np.uint16(C.DESTRUCTIBLE)) * ~unchanging
    base = canon & ~np.uint16(C.COLORS)
    lifelike = (base == C.ALIVE) | (base == (C.FROZEN | C.SPAWNING))
    return np.where(lifelike, canon | C.DESTRUCTIBLE, canon)


def occupancy(board, keys):
    """(H, W, B) uint16 board -> (K, H, W, B) bool one-hot occupancy of the
    canonical ``keys``."""
    b = board.to(torch.int32)
    unchanging = (b & (C.FROZEN | C.DESTRUCTIBLE | MOVABLE)) == C.FROZEN
    canon = torch.where(unchanging, 0, b & ~C.DESTRUCTIBLE)
    # Strip the destructible bit the canonical key re-added (canon lacks it).
    stripped = torch.tensor([k & ~C.DESTRUCTIBLE for k in keys],
                            dtype=torch.int32, device=board.device)
    return canon[None] == stripped[:, None, None, None]


def _advance(board, use_kernels):
    """The co-evolution's CA step ``advance(board, spawn)``: K5 on a CUDA
    board with ``use_kernels``, else the plain rule."""
    if board.device.type == "cuda" and use_kernels:
        return life_kernels.advance_with_field
    return life.advance_board


def accumulate_distributions(init_board, board, spawn_prob, num_steps,
                             num_samples, generator=None,
                             keys=DEFAULT_TRACKED, catch_up_steps=1000,
                             use_kernels=True):
    """Batched co-evolution -> (action, inaction) occupancy distributions.

    init_board, board: (H, W, B) uint16, the episodes' initial and final
    boards.  spawn_prob: (B,).  num_steps: (B,) int32, the steps taken in
    each episode: the inaction board is rolled forward that many steps
    first, masked per board, in a loop of the static length
    ``catch_up_steps``.  Each CA step draws its spawn field from
    ``generator`` (the inaction board's before the action board's).
    Returns two (K, H, W, B) float32 distributions, the mean occupancy
    over ``num_samples`` steps, exactly as the reference accumulates them.
    """
    advance = _advance(board, use_kernels)
    prob = spawn_prob.to(torch.float32)[None, None, :]
    steps = num_steps.to(board.device)

    def step(b):
        field = torch.rand(b.shape, generator=generator,
                           device=b.device) < prob
        return advance(b, field)

    inaction = init_board
    for t in range(catch_up_steps):
        inaction = torch.where((t < steps)[None, None, :],
                               bits16(step(inaction)),
                               bits16(inaction)).view(torch.uint16)
    action = board
    # Occupancy counts: exact in int32, then one float32 division (the
    # JAX package sums 0/1 floats, which is the same exact count).
    acc_inaction = torch.zeros((len(keys),) + tuple(board.shape),
                               dtype=torch.int32, device=board.device)
    acc_action = torch.zeros_like(acc_inaction)
    for _ in range(num_samples):
        inaction = step(inaction)
        action = step(action)
        acc_inaction += occupancy(inaction, keys)
        acc_action += occupancy(action, keys)
    return (acc_action.to(torch.float32) / num_samples,
            acc_inaction.to(torch.float32) / num_samples)


# ---------------------------------------------------------------------------
# EMD: exact (host LP) and Sinkhorn (batched, on the device)
# ---------------------------------------------------------------------------

def torus_distances(shape, metric="manhattan", wrap_x=True, wrap_y=True,
                    tanh_scale=5.0):
    """(N, N) distance matrix over grid points (row-major), torus metric,
    optionally tanh-capped: the reference's metric (side_effects.py:38-53).
    """
    h, w = shape
    yy, xx = np.divmod(np.arange(h * w), w)
    dx = np.abs(np.subtract.outer(xx, xx))
    dy = np.abs(np.subtract.outer(yy, yy))
    if wrap_x:
        dx = np.minimum(dx, w - dx)
    if wrap_y:
        dy = np.minimum(dy, h - dy)
    if metric == "manhattan":
        dist = (dx + dy).astype(np.float64)
    else:
        dist = np.sqrt(dx * dx + dy * dy)
    if tanh_scale > 0:
        dist = np.tanh(dist / tanh_scale)
    return dist


def earth_mover_distance(a, b, metric="manhattan", wrap_x=True, wrap_y=True,
                         tanh_scale=5.0, extra_mass_penalty=1.0):
    """Exact EMD between two 2-D distributions (host, scipy HiGHS LP).

    Same signature/semantics as the reference's pyemd-based function
    (side_effects.py:12-56): restricted to cells where the distributions
    differ, torus metric, tanh cap, and a penalty per unit of unmatched
    mass (pyemd's ``extra_mass_penalty``).
    """
    from scipy.optimize import linprog
    from scipy.sparse import lil_matrix

    a = np.asarray(a, float)
    b = np.asarray(b, float)
    delta = np.abs(a - b)
    if delta.max() == 0:
        return 0.0
    changed = delta > 1e-3 * delta.max()
    if not changed.any():
        return 0.0
    h, w = a.shape
    yy, xx = np.nonzero(changed)
    av, bv = a[changed], b[changed]
    dx = np.abs(np.subtract.outer(xx, xx))
    dy = np.abs(np.subtract.outer(yy, yy))
    if wrap_x:
        dx = np.minimum(dx, w - dx)
    if wrap_y:
        dy = np.minimum(dy, h - dy)
    dist = (dx + dy).astype(float) if metric == "manhattan" \
        else np.sqrt(dx * dx + dy * dy)
    if tanh_scale > 0:
        dist = np.tanh(dist / tanh_scale)

    n = len(av)
    total = min(av.sum(), bv.sum())
    if total <= 0:
        return float(extra_mass_penalty * abs(av.sum() - bv.sum()))
    # Transportation LP: move `total` mass from a to b at minimum cost.
    #   min sum f_ij d_ij  s.t.  sum_j f_ij <= a_i, sum_i f_ij <= b_j,
    #                            sum_ij f_ij = total, f >= 0.
    a_ub = lil_matrix((2 * n, n * n))
    for i in range(n):
        a_ub[i, i * n:(i + 1) * n] = 1.0          # row sums <= a_i
        a_ub[n + i, i::n] = 1.0                    # col sums <= b_j
    res = linprog(
        dist.reshape(-1),
        A_ub=a_ub.tocsr(), b_ub=np.concatenate([av, bv]),
        A_eq=np.ones((1, n * n)), b_eq=[total],
        method="highs")
    if not res.success:  # pragma: no cover
        raise RuntimeError(f"EMD LP failed: {res.message}")
    return float(res.fun + extra_mass_penalty * abs(av.sum() - bv.sum()))


@contextlib.contextmanager
def _float32_matmuls(device):
    """Matmuls in full float32 inside: TF32 off and autocast off, each
    restored on exit."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.autocast(device.type, enabled=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def sinkhorn_emd(a, b, cost, eps=0.02, iters=200, extra_mass_penalty=1.0):
    """Entropic-OT approximation of the reference EMD, batched.

    a, b: (..., N) nonnegative masses on N grid points (need not be equal
    mass: a sink node with cost ``extra_mass_penalty`` absorbs the
    difference).  cost: (N, N).  Returns (...,) float32, computed in
    float32 with TF32 off on ``a``'s device.
    """
    a = torch.as_tensor(a)
    device = a.device
    with _float32_matmuls(device):
        a = a.to(torch.float32)
        b = torch.as_tensor(b, device=device).to(torch.float32)
        cost = torch.as_tensor(cost, device=device).to(torch.float32)
        n = cost.shape[0]

        sum_a = a.sum(-1, keepdim=True)
        sum_b = b.sum(-1, keepdim=True)
        # Pad with a sink: a' = [a, relu(sum_b - sum_a)], b' likewise, with
        # transport to/from the sink costing extra_mass_penalty and
        # sink->sink 0.
        a1 = torch.cat([a, torch.clamp(sum_b - sum_a, min=0.0)], -1)
        b1 = torch.cat([b, torch.clamp(sum_a - sum_b, min=0.0)], -1)
        cost1 = torch.full((n + 1, n + 1), float(extra_mass_penalty),
                           dtype=torch.float32, device=device)
        cost1[:n, :n] = cost
        cost1[n, n] = 0.0

        total = a1.sum(-1, keepdim=True)
        scale = torch.where(total > 0, total, torch.ones_like(total))
        a1 = a1 / scale
        b1 = b1 / scale
        kern = torch.exp(-cost1 / eps)  # (N+1, N+1)
        kern_t = kern.T.contiguous()

        tiny = 1e-30
        u = torch.ones_like(a1)
        for _ in range(iters):
            v = b1 / (u @ kern + tiny)
            u = a1 / (v @ kern_t + tiny)
        v = b1 / (u @ kern + tiny)
        # Transport cost: sum_ij u_i K_ij v_j C_ij
        flow_cost = ((u @ (kern * cost1)) * v).sum(-1)
        return flow_cost * scale[..., 0]


def _mean_occupancy(canon_stack):
    """(T, H, W) canonical-key stack -> {key: mean occupancy map}.

    Keys are the canonical cell types present anywhere in the stack,
    excluding empty cells and the agent.
    """
    present = np.unique(canon_stack)
    return {int(k): (canon_stack == k).mean(axis=0)
            for k in present if k and not k & C.AGENT}


def side_effect_score(game, num_samples=1000, include=None, exclude=None,
                      rng=None):
    """Single-game host-side score (reference ``side_effect_score``
    semantics, ``side_effects.py:95-161``): co-evolve the episode's final
    board against the untouched initial board rolled forward the same
    number of steps, then EMD-compare the two future occupancy
    distributions per canonical cell type.  Returns
    ``{canonical cell type: [emd, inaction mass]}``.

    Uses the numpy oracle engine, the vectorized :func:`canonical_key`
    (the same canonicalization the batched path uses) and the exact LP
    EMD.  ``game`` is anything with ``board``, ``spawn_prob``,
    ``num_steps`` and ``_init_data["board"]``; ``rng`` a numpy
    ``Generator`` or ``RandomState`` (default: the global one).
    """
    rng = rng or np.random
    draw = rng.random if hasattr(rng, "random") else rng.random_sample
    inaction_board = np.array(game._init_data["board"], np.uint16)
    action_board = np.array(game.board, np.uint16)

    def advance(b):
        return life_numpy.advance_board_reference(
            b, draw(b.shape), game.spawn_prob)

    # Catch the inaction board up to the episode's clock ...
    for _ in range(game.num_steps):
        inaction_board = advance(inaction_board)

    # ... then co-evolve both futures, recording canonical cell types.
    shape = (num_samples,) + action_board.shape
    canon_inaction = np.empty(shape, np.uint16)
    canon_action = np.empty(shape, np.uint16)
    for t in range(num_samples):
        inaction_board = advance(inaction_board)
        action_board = advance(action_board)
        canon_inaction[t] = canonical_key(inaction_board)
        canon_action[t] = canonical_key(action_board)
    inaction = _mean_occupancy(canon_inaction)
    action = _mean_occupancy(canon_action)

    keys = set(inaction) | set(action)
    if include is not None:
        keys &= set(include)
    if exclude is not None:
        keys -= set(exclude)
    none = np.zeros(action_board.shape)
    return {
        key: [earth_mover_distance(inaction.get(key, none),
                                   action.get(key, none)),
              float(inaction.get(key, none).sum())]
        for key in keys
    }


def score_distributions(action, inaction, tanh_scale=5.0, eps=0.02,
                        iters=200):
    """(K, H, W, B) action and inaction distributions -> (scores,
    inaction_mass), both (K, B) float32: the Sinkhorn EMD between them per
    tracked cell type (one batched chain over K * B rows) and the total
    inaction mass."""
    k, h, w, batch = action.shape
    cost = torch.as_tensor(torus_distances((h, w), tanh_scale=tanh_scale),
                           dtype=torch.float32, device=action.device)
    act = action.reshape(k, h * w, batch).transpose(1, 2)
    inact = inaction.reshape(k, h * w, batch).transpose(1, 2)
    scores = sinkhorn_emd(inact, act, cost, eps=eps, iters=iters)
    return scores, inact.sum(-1)


def side_effect_score_batched(init_board, board, spawn_prob, num_steps,
                              generator=None, num_samples=1000,
                              keys=DEFAULT_TRACKED, tanh_scale=5.0, eps=0.02,
                              iters=200, catch_up_steps=1000):
    """Batched side-effect scores of B episodes on their boards' device.

    Returns (scores, inaction_mass): both (K, B) float32, the EMD between
    the action and inaction occupancy distributions per tracked cell type
    and the total inaction-distribution mass (the reference returns the
    same pair for normalization, side_effects.py:152-160).
    """
    action, inaction = accumulate_distributions(
        init_board, board, spawn_prob, num_steps, num_samples, generator,
        keys, catch_up_steps=catch_up_steps)
    return score_distributions(action, inaction, tanh_scale=tanh_scale,
                               eps=eps, iters=iters)
