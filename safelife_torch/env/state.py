"""Environment state containers: dataclasses of batched tensors
(port of ``safelife_tpu.env.state``).

Boards are laid out ``(H, W, B)`` uint16 with the batch trailing; the exit
tables are ``(K, B)``.  Leaf names match the JAX package, so a bank or a
state fetched from it with ``jax.device_get`` carries across through
:meth:`LevelBank.from_numpy` / :meth:`EnvState.from_numpy`.
"""

import dataclasses

import numpy as np
import torch

from .. import bits16
from .. import cells as C


def _tensor_fields(cls):
    return [f.name for f in dataclasses.fields(cls) if f.type is torch.Tensor]


def _from_numpy(cls, arrays, device, **static):
    leaves = {name: torch.as_tensor(np.array(arrays[name]), device=device)
              for name in _tensor_fields(cls)}
    return cls(**leaves, **static)


def _to_numpy(obj):
    return {f.name: (getattr(obj, f.name).cpu().numpy()
                     if f.type is torch.Tensor else getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@dataclasses.dataclass(frozen=True)
class LevelBank:
    """A fixed set of levels resident on one device, stacked batch-trailing.

    Built from npz archives by :mod:`safelife_torch.levels.loader`.  All
    levels share a board shape.  Everything a reset needs that is a pure
    function of the level (exit locations, baseline score, initial points,
    the reset-time exit gate) is precomputed at build time, so a reset is
    a gather.
    """
    board: torch.Tensor        # (H, W, N) uint16
    goals: torch.Tensor        # (H, W, N) uint16
    agent_row: torch.Tensor    # (N,) int32
    agent_col: torch.Tensor    # (N,) int32
    orientation: torch.Tensor  # (N,) int32
    spawn_prob: torch.Tensor   # (N,) float32
    min_performance: torch.Tensor  # (N,) float32
    exit_row: torch.Tensor     # (K, N) int32 — exits in row-major order
    exit_col: torch.Tensor     # (K, N) int32
    exit_valid: torch.Tensor   # (K, N) bool
    exit_gcol: torch.Tensor    # (K, N) int32 — goal color at each exit cell
    baseline_score: torch.Tensor   # (N,) int32 — performance_score
    possible0: torch.Tensor    # (N,) int32 — possible_score - baseline
    points0: torch.Tensor      # (N,) int32 — current_points of the level
    can_exit0: torch.Tensor    # (N,) bool — exit gate open at reset
    # Bank-wide rule flags (see safelife_tpu.env.state.LevelBank): every
    # goal board is a spawner-free CA fixed point / no level holds a
    # spawner / goal boards are free of PRESERVING, INHIBITING, SPAWNING
    # and EXIT / goal boards are free of PRESERVING, INHIBITING and EXIT.
    static_goals: bool = False
    spawnless: bool = False
    simple_goals: bool = False
    spawn_simple_goals: bool = False

    @property
    def num_levels(self):
        return self.board.shape[-1]

    @property
    def device(self):
        return self.board.device

    def take(self, idx):
        """The levels at ``idx`` (B,): each tensor leaf indexed on its
        trailing axis, flags kept."""
        idx = idx.to(device=self.device, dtype=torch.long)
        return dataclasses.replace(self, **{
            name: bits16(getattr(self, name))[..., idx].view(
                getattr(self, name).dtype)
            for name in _tensor_fields(LevelBank)})

    @classmethod
    def from_numpy(cls, arrays, device):
        """A bank from a mapping of leaf name -> array and flag name ->
        bool (a JAX bank fetched with ``jax.device_get`` carries over
        field by field)."""
        return _from_numpy(cls, arrays, device, **{
            k: bool(arrays[k]) for k in (
                "static_goals", "spawnless", "simple_goals",
                "spawn_simple_goals")})

    def to_numpy(self):
        """Leaf name -> numpy array, plus the four flags as bools."""
        return _to_numpy(self)


@dataclasses.dataclass(frozen=True)
class EnvState:
    """Full state of B lockstep SafeLife environments."""
    # Live game state
    board: torch.Tensor        # (H, W, B) uint16
    goals: torch.Tensor        # (H, W, B) uint16
    agent_row: torch.Tensor    # (B,) int32
    agent_col: torch.Tensor    # (B,) int32
    orientation: torch.Tensor  # (B,) int32
    game_over: torch.Tensor    # (B,) bool  (agent exited / aborted)
    # Per-level constants (change only on reset)
    init_board: torch.Tensor   # (H, W, B) uint16 — side-effect baseline
    spawn_prob: torch.Tensor   # (B,) float32
    min_performance: torch.Tensor  # (B,) float32
    baseline_score: torch.Tensor   # (B,) int32
    exit_row: torch.Tensor     # (K, B) int32
    exit_col: torch.Tensor     # (K, B) int32
    exit_valid: torch.Tensor   # (K, B) bool
    exit_gcol: torch.Tensor    # (K, B) int32
    level_idx: torch.Tensor    # (B,) int32 — bank index being played
    # Episode bookkeeping
    points_last: torch.Tensor      # (B,) int32 — current_points
    perf_completed: torch.Tensor   # (B,) int32
    perf_possible: torch.Tensor    # (B,) int32
    episode_length: torch.Tensor   # (B,) int32
    episode_reward: torch.Tensor   # (B,) float32
    episode_done: torch.Tensor     # (B,) bool — previous step's done
    reset_count: torch.Tensor      # (B,) int32
    # Global counters
    episodes_started: torch.Tensor    # () int32
    episodes_completed: torch.Tensor  # () int32
    num_steps: torch.Tensor           # () int32

    @property
    def batch_size(self):
        return self.board.shape[-1]

    @property
    def device(self):
        return self.board.device

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)

    @classmethod
    def from_numpy(cls, arrays, device):
        """A state from a mapping of leaf name -> array (a JAX state
        fetched with ``jax.device_get`` carries over field by field)."""
        return _from_numpy(cls, arrays, device)

    def to_numpy(self):
        return _to_numpy(self)


def find_exits_np(board, max_exits):
    """Host (numpy) exit finder used at bank build time.

    board: (H, W) uint16 -> (K,) rows, cols, valid.
    """
    board = np.asarray(board)
    rr, cc = np.nonzero((board & C.EXIT) != 0)
    k = min(max_exits, len(rr))
    rows = np.zeros(max_exits, np.int32)
    cols = np.zeros(max_exits, np.int32)
    valid = np.zeros(max_exits, bool)
    rows[:k], cols[:k], valid[:k] = rr[:k], cc[:k], True
    return rows, cols, valid


def find_exits(board, max_exits):
    """Locate up to ``max_exits`` exit cells per board, in row-major order.

    board: (H, W, B) uint16 -> (K, B) rows, cols, valid.  Slots past the
    last exit hold the first non-exit cells in row-major order.
    """
    h, w, b = board.shape
    flat = ((board.to(torch.int32) & C.EXIT) != 0).reshape(h * w, b)
    idx = torch.arange(h * w, device=board.device, dtype=torch.int32)[:, None]
    # Distinct scores: exits above every non-exit, lower positions first.
    score = torch.where(flat, 2 * h * w - idx, h * w - idx)
    vals, pos = torch.topk(score.T, max_exits, dim=1)  # (B, K), descending
    valid = (vals > h * w).T
    pos = pos.T.to(torch.int32)
    return pos // w, pos % w, valid
