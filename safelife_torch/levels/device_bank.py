"""Build LevelBanks from device tensors, with no host round trip (port of
``safelife_tpu.levels.device_bank``).

``loader.build_bank`` precomputes the reset-time fields in numpy, which
suits levels read from files; the banks of the level factories
(:mod:`safelife_torch.procgen.batched`) stay on their device end to end by
computing those fields with the tensor scoring ops instead.
"""

import torch

from .. import cells as C
from ..env.state import LevelBank, find_exits
from ..ops import scoring


def build_bank_from_arrays(board, goals, agent_row, agent_col,
                           orientation=None, spawn_prob=None,
                           min_performance=-1.0, max_exits=4,
                           static_goals=False, spawnless=False,
                           simple_goals=False, spawn_simple_goals=None):
    """Assemble a LevelBank from (H, W, N) uint16 tensors on the device of
    ``board``.

    ``static_goals`` / ``spawnless`` must be asserted by the caller: pass
    True only when every goal board is a spawner-free CA fixed point / no
    level contains spawners.
    """
    h, w, n = board.shape
    dev = board.device
    board = board.to(torch.uint16)
    goals = goals.to(device=dev, dtype=torch.uint16)
    if orientation is None:
        orientation = torch.ones(n, dtype=torch.int32, device=dev)
    if spawn_prob is None:
        spawn_prob = torch.zeros(n, dtype=torch.float32, device=dev)
    min_performance = torch.as_tensor(
        min_performance, dtype=torch.float32, device=dev).expand(n).clone()

    baseline = scoring.performance_score(board, goals)
    possible0 = scoring.possible_score(goals) - baseline
    points0 = scoring.current_points(board, goals)
    can_exit0 = (min_performance < 0) | (
        0 >= min_performance * possible0.to(torch.float32))
    er, ec, ev = find_exits(board, max_exits)
    flat_goals = goals.to(torch.int32).reshape(h * w, n)
    pos = (er * w + ec).to(torch.int64)                     # (K, N)
    exit_gcol = torch.where(
        ev, (torch.gather(flat_goals, 0, pos) >> C.COLOR_BIT) & 7, 0)

    def i32(x):
        return torch.as_tensor(x, device=dev).to(torch.int32)

    return LevelBank(
        board=board, goals=goals,
        agent_row=i32(agent_row), agent_col=i32(agent_col),
        orientation=i32(orientation),
        spawn_prob=torch.as_tensor(spawn_prob, device=dev).to(torch.float32),
        min_performance=min_performance,
        exit_row=er, exit_col=ec, exit_valid=ev,
        exit_gcol=exit_gcol.to(torch.int32),
        baseline_score=baseline, possible0=possible0, points0=points0,
        can_exit0=can_exit0, static_goals=bool(static_goals),
        spawnless=bool(spawnless), simple_goals=bool(simple_goals),
        # simple_goals implies the weaker spawn-simple certification.
        spawn_simple_goals=bool(simple_goals if spawn_simple_goals is None
                                else spawn_simple_goals))
