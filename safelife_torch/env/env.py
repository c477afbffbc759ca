"""The batched SafeLife environment on tensors (port of
``safelife_tpu.env.env``).

:meth:`BatchedSafeLifeEnv.step` advances B environments in lockstep:
agent actions, the CA advance of the board (and of the goal board on
dynamic suites), reward, exit gating and recolouring, episode bookkeeping,
auto-reset from a level bank on the same device, and the observation.

On a CUDA device with ``use_kernels`` the step runs through the kernels
of :mod:`safelife_torch.ops.env_step_kernels`; otherwise it runs the plain
tensor ops (``ops/agent.py``, ``ops/life.py``, ``ops/scoring.py``,
``ops/obs.py``), the reference semantics the kernels are held to.
"""

import dataclasses
from typing import Optional, Tuple

import torch

from .. import cells as C
from .. import bits16, resolve_device
from ..ops import agent as agent_ops
from ..ops import env_step_kernels, life, obs as obs_ops, scoring
from .state import EnvState, LevelBank

ACTION_NAMES = (
    "NULL",
    "MOVE UP", "MOVE RIGHT", "MOVE DOWN", "MOVE LEFT",
    "TOGGLE UP", "TOGGLE RIGHT", "TOGGLE DOWN", "TOGGLE LEFT",
)
NUM_ACTIONS = len(ACTION_NAMES)


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static environment configuration."""
    view_shape: Tuple[int, int] = (15, 15)
    output_channels: Optional[Tuple[int, ...]] = tuple(range(15))
    remove_white_goals: bool = True
    time_limit: int = 1000
    auto_reset: bool = True
    sequential_levels: bool = False  # round-robin bank order (benchmarking)
    points_on_level_exit: float = 1.0
    can_toggle_powers: bool = False
    can_toggle_colors: bool = False
    compute_obs: bool = True
    use_kernels: bool = True  # the CUDA kernels on a CUDA device


@dataclasses.dataclass(frozen=True)
class TimeStep:
    obs: Optional[torch.Tensor]   # (B, vh, vw, C) uint8, or None
    reward: torch.Tensor          # (B,) float32
    done: torch.Tensor            # (B,) bool
    times_up: torch.Tensor        # (B,) bool
    # Pre-reset episode stats (valid where done):
    episode_length: torch.Tensor  # (B,) int32
    episode_reward: torch.Tensor  # (B,) float32
    perf_completed: torch.Tensor  # (B,) int32
    perf_possible: torch.Tensor   # (B,) int32
    level_idx: torch.Tensor       # (B,) int32
    side_effect_count: Optional[torch.Tensor] = None  # (B,) int32, pre-reset
    # The post-step state BEFORE any auto-reset.  On the kernel path with
    # auto-reset its board and goals are already post-reset (the reset
    # select is folded into the kernel); the per-env values are pre-reset.
    state_before_reset: Optional[EnvState] = None


class BatchedSafeLifeEnv:
    """B lockstep environments on one device (``cuda`` unless the caller
    passes ``device="cpu"``)."""

    def __init__(self, config: EnvConfig = EnvConfig(), device=None):
        self.config = config
        self.device = resolve_device(device)

    def _check_device(self, *tensors):
        for t in tensors:
            if t.device != self.device:
                raise ValueError(
                    f"tensor on {t.device}, environment on {self.device}")

    # -- resets ----------------------------------------------------------

    def _next_level_idx(self, num_levels, batch, reset_count, generator):
        if self.config.sequential_levels:
            # env b plays levels b, b+B, b+2B, ... (round-robin eval order).
            rank = torch.arange(batch, dtype=torch.int32, device=self.device)
            return torch.remainder(rank + reset_count * batch, num_levels)
        return torch.randint(0, num_levels, (batch,), generator=generator,
                             device=self.device, dtype=torch.int32)

    def _fresh_state_fields(self, bank: LevelBank, idx):
        """Per-board fields of a freshly-reset state (no counters)."""
        self._check_device(bank.board)
        lv = bank.take(idx)
        init_board = lv.board
        # Exits are closed at reset unless immediately open.
        board = _recolor_exits(init_board, init_board, lv.can_exit0)
        batch = idx.shape[0]
        i32 = dict(dtype=torch.int32, device=self.device)
        return dict(
            board=board, goals=lv.goals,
            agent_row=lv.agent_row.to(torch.int32),
            agent_col=lv.agent_col.to(torch.int32),
            orientation=lv.orientation.to(torch.int32),
            game_over=torch.zeros(batch, dtype=torch.bool, device=self.device),
            init_board=init_board,
            spawn_prob=lv.spawn_prob.to(torch.float32),
            min_performance=lv.min_performance.to(torch.float32),
            baseline_score=lv.baseline_score,
            exit_row=lv.exit_row, exit_col=lv.exit_col,
            exit_valid=lv.exit_valid, exit_gcol=lv.exit_gcol,
            level_idx=idx.to(**i32),
            points_last=lv.points0,
            perf_completed=torch.zeros(batch, **i32),
            perf_possible=lv.possible0,
            episode_length=torch.zeros(batch, **i32),
            episode_reward=torch.zeros(batch, dtype=torch.float32,
                                       device=self.device),
            episode_done=torch.zeros(batch, dtype=torch.bool,
                                     device=self.device),
        )

    def _new_state(self, fields, batch):
        i32 = dict(dtype=torch.int32, device=self.device)
        return EnvState(
            reset_count=torch.ones(batch, **i32),
            episodes_started=torch.tensor(batch, **i32),
            episodes_completed=torch.tensor(0, **i32),
            num_steps=torch.tensor(0, **i32),
            **fields)

    def reset_all(self, bank: LevelBank, batch_size: int,
                  generator: Optional[torch.Generator] = None) -> EnvState:
        """Reset ``batch_size`` environments to levels drawn from the bank
        (or in round-robin order with ``sequential_levels``)."""
        idx = self._next_level_idx(
            bank.num_levels, batch_size,
            torch.zeros(batch_size, dtype=torch.int32, device=self.device),
            generator)
        return self._new_state(self._fresh_state_fields(bank, idx),
                               batch_size)

    def reset_to_levels(self, bank: LevelBank, idx) -> EnvState:
        """Deterministic reset: env b plays bank level ``idx[b]``."""
        idx = torch.as_tensor(idx, device=self.device).to(torch.int32)
        return self._new_state(self._fresh_state_fields(bank, idx),
                               idx.shape[0])

    def fresh_levels(self, bank: LevelBank, idx):
        """``(idx, fields)`` of the given levels, for ``step``'s
        ``fresh_levels``."""
        idx = torch.as_tensor(idx, device=self.device).to(torch.int32)
        return idx, self._fresh_state_fields(bank, idx)

    def sample_fresh_levels(self, bank: LevelBank, batch_size: int,
                            generator: Optional[torch.Generator] = None):
        """Pre-gather one random fresh level per env for the auto-resets
        of the coming steps (an env that resets twice in that time
        replays the same level)."""
        idx = torch.randint(0, bank.num_levels, (batch_size,),
                            generator=generator, device=self.device)
        return self.fresh_levels(bank, idx)

    # -- observations ----------------------------------------------------

    def observe(self, state: EnvState):
        return obs_ops.observe(
            state.board, state.goals, state.agent_row, state.agent_col,
            state.exit_row, state.exit_col, state.exit_valid,
            self.config.view_shape, self.config.output_channels,
            self.config.remove_white_goals)

    # -- step ------------------------------------------------------------

    def uses_kernels(self, spawn_board=None, spawn_goals=None):
        """True when :meth:`step` takes the kernel path."""
        cfg = self.config
        return (self.device.type == "cuda" and cfg.use_kernels
                and spawn_board is None and spawn_goals is None
                and not cfg.can_toggle_powers and not cfg.can_toggle_colors)

    def _fresh_for_step(self, state, bank, generator, fresh_levels):
        if fresh_levels is not None and not self.config.sequential_levels:
            return fresh_levels
        idx = self._next_level_idx(bank.num_levels, state.batch_size,
                                   state.reset_count, generator)
        return idx, self._fresh_state_fields(bank, idx)

    def fused_inputs(self, state: EnvState, bank: LevelBank, action,
                     fresh=None):
        """Keyword arguments of ``env_step_kernels.fused_step`` for this
        step; ``fresh`` is the fresh levels' fields (auto-reset only)."""
        cfg = self.config
        ce0 = scoring.can_exit(state.perf_completed, state.perf_possible,
                               state.min_performance)
        kernel_obs = cfg.auto_reset and cfg.compute_obs
        return dict(
            board=state.board, goals=state.goals,
            init_board=state.init_board, action=action,
            agent_row=state.agent_row, agent_col=state.agent_col,
            orientation=state.orientation, game_over=state.game_over,
            can_exit0=ce0, baseline_score=state.baseline_score,
            spawn_prob=state.spawn_prob,
            min_performance=state.min_performance,
            static_goals=bank.static_goals, spawnless=bank.spawnless,
            simple_goals=bank.simple_goals,
            spawn_simple_goals=bank.spawn_simple_goals,
            perf_possible=state.perf_possible,
            episode_length=state.episode_length, fresh=fresh,
            time_limit=cfg.time_limit if cfg.auto_reset else 0,
            obs_view=cfg.view_shape if kernel_obs else None,
            exit_row=state.exit_row, exit_col=state.exit_col,
            exit_valid=state.exit_valid, exit_gcol=state.exit_gcol,
            remove_white_goals=cfg.remove_white_goals)

    def step(self, state: EnvState, bank: LevelBank, action,
             generator: Optional[torch.Generator] = None,
             spawn_board=None, spawn_goals=None, fresh_levels=None):
        """Advance all B environments one step.

        ``spawn_board`` / ``spawn_goals`` replace the spawn draws with
        given boolean fields.  ``fresh_levels`` (from
        :meth:`sample_fresh_levels` or :meth:`fresh_levels`) supplies the
        levels of this step's auto-resets; without it they are drawn from
        ``generator``.
        """
        cfg = self.config
        self._check_device(state.board, bank.board)
        action = torch.as_tensor(action, device=self.device).to(torch.int32)
        prev_done = state.episode_done
        prev_over = state.game_over

        effect_count = None
        packed_view = None
        fresh = None
        if self.uses_kernels(spawn_board, spawn_goals):
            if cfg.auto_reset:
                idx, fresh = self._fresh_for_step(state, bank, generator,
                                                  fresh_levels)
            out = env_step_kernels.fused_step(
                **self.fused_inputs(state, bank, action, fresh))
            (board, goals, agent_row, agent_col, orientation, exited,
             points, comp1, poss1, ce1, effect_count) = out[:11]
            if cfg.auto_reset and cfg.compute_obs:
                packed_view = out[12]
            act = agent_ops.ActionResult(
                board=None, agent_row=agent_row, agent_col=agent_col,
                orientation=orientation, exited=exited,
                reward=exited.to(torch.float32) * cfg.points_on_level_exit)
        else:
            ce0 = scoring.can_exit(state.perf_completed, state.perf_possible,
                                   state.min_performance)
            act = agent_ops.execute_action(
                state.board, state.agent_row, state.agent_col,
                state.orientation, action, ce0, prev_over,
                cfg.points_on_level_exit,
                cfg.can_toggle_powers, cfg.can_toggle_colors)
            if spawn_board is None:
                spawn_board = self._spawn_field(state, generator)
            board = life.advance_board(act.board, spawn_board)
            if bank.static_goals:
                goals = state.goals
            else:
                if spawn_goals is None:
                    spawn_goals = self._spawn_field(state, generator)
                goals = life.advance_board(state.goals, spawn_goals)
            points = scoring.current_points(board, goals)
            comp1, poss1 = scoring.performance_ratio(
                board, goals, state.baseline_score)
            ce1 = scoring.can_exit(comp1, poss1, state.min_performance)
            board = _recolor_exits(board, state.init_board, ce1)
            effect_count = scoring.side_effect_count(
                board, state.init_board, goals)

        game_over = prev_over | act.exited
        reward = act.reward + (points - state.points_last).to(torch.float32)
        episode_length = state.episode_length + 1
        episode_reward = state.episode_reward + reward
        times_up = episode_length > cfg.time_limit
        done = times_up | game_over

        counted = ~prev_done
        mid = state.replace(
            board=board, goals=goals,
            agent_row=act.agent_row, agent_col=act.agent_col,
            orientation=act.orientation, game_over=game_over,
            points_last=points,
            perf_completed=comp1, perf_possible=poss1,
            episode_length=episode_length,
            episode_reward=episode_reward, episode_done=done,
            episodes_completed=state.episodes_completed
            + (done & counted).sum().to(torch.int32),
            num_steps=state.num_steps + counted.sum().to(torch.int32),
        )

        new_state = mid
        if cfg.auto_reset:
            if fresh is not None:
                # The kernel already reset the three boards; select only
                # the per-env leaves here.
                small = {k: v for k, v in fresh.items()
                         if k not in ("board", "goals", "init_board")}
                new_state = _select_reset(mid, small, done).replace(
                    init_board=out[11])
            else:
                _, fresh = self._fresh_for_step(state, bank, generator,
                                                fresh_levels)
                new_state = _select_reset(mid, fresh, done)
            new_state = new_state.replace(
                reset_count=mid.reset_count + done.to(torch.int32),
                episodes_started=mid.episodes_started
                + done.sum().to(torch.int32),
            )

        if packed_view is not None:
            if cfg.output_channels is not None:
                obs = obs_ops.unpack_channels(packed_view,
                                              cfg.output_channels)
            else:
                obs = obs_ops.transpose_view(packed_view)
        elif cfg.compute_obs:
            obs = self.observe(new_state)
        else:
            obs = None
        ts = TimeStep(
            obs=obs,
            reward=reward, done=done, times_up=times_up,
            episode_length=mid.episode_length,
            episode_reward=mid.episode_reward,
            perf_completed=comp1, perf_possible=poss1,
            level_idx=mid.level_idx,
            side_effect_count=effect_count,
            state_before_reset=mid,
        )
        return new_state, ts

    def _spawn_field(self, state, generator):
        u = torch.rand(state.board.shape, generator=generator,
                       device=self.device)
        return u < state.spawn_prob[None, None, :]


def _recolor_exits(board, init_board, open_):
    """Set exit cells to LEVEL_EXIT (+red when open).  Exit locations come
    from the initial board: exits are frozen and indestructible, so they
    never move during play."""
    exit_mask = (init_board.to(torch.int32) & C.EXIT) != 0
    cell = torch.where(open_, C.LEVEL_EXIT | C.COLOR_R, C.LEVEL_EXIT).to(
        torch.int16)
    return torch.where(exit_mask, cell[None, None, :],
                       bits16(board)).view(torch.uint16)


def _select_reset(mid: EnvState, fresh: dict, done):
    """Per-board select between mid-step state and freshly-reset fields."""
    updates = {}
    for name, new in fresh.items():
        old = getattr(mid, name)
        # All per-board leaves carry B on the trailing axis.
        shape = [1] * (old.dim() - 1) + [done.shape[0]]
        updates[name] = torch.where(done.reshape(shape), bits16(new),
                                    bits16(old)).view(old.dtype)
    return mid.replace(**updates)
