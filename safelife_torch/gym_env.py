"""Gymnasium-compatible single-env adapter + environment registration
(port of ``safelife_tpu.gym_env``).

Capability parity with the reference's gym surface
(``safelife/safelife_env.py``: ``SafeLifeEnv`` with ``step/reset/render/
seed`` and the ``SafeLifeEnv.register()`` gym ids, ``:211-226``), built on
the host game engine, numpy only.  The lockstep batched env
(:class:`safelife_torch.env.env.BatchedSafeLifeEnv`) is the training path;
this adapter exists for drop-in use with gym(nasium)-based tooling, and
works without gymnasium too (then it has no spaces).
"""

from typing import Optional

import numpy as np

from . import cells as C
from .env.env import ACTION_NAMES
from .game import SafeLifeGame
from .render.text import recenter_view, render_board


try:
    import gymnasium as _gymnasium
    _EnvBase = _gymnasium.Env
except ImportError:  # pragma: no cover
    _EnvBase = object


class SafeLifeGymEnv(_EnvBase):
    """gymnasium.Env-compatible SafeLife environment over a level iterator.

    Observation: agent-centered ``view_shape`` crop unpacked into
    ``output_channels`` binary planes (uint8), goal colors merged into bits
    12-14 — identical to the reference's ``get_obs``
    (``safelife_env.py:125-155``).
    """

    metadata = {"render_modes": ["ansi", "rgb_array"]}
    action_names = ACTION_NAMES

    def __init__(self, level_iterator=None, view_shape=(15, 15),
                 output_channels=tuple(range(15)), time_limit=1000,
                 remove_white_goals=True, render_mode="ansi"):
        if level_iterator is None:
            from .levels.iterator import safelife_loader
            level_iterator = safelife_loader()  # default procgen
        self.level_iterator = level_iterator
        self.view_shape = tuple(view_shape)
        self.output_channels = tuple(output_channels)
        self.time_limit = time_limit
        self.remove_white_goals = remove_white_goals
        self.render_mode = render_mode
        self.game: Optional[SafeLifeGame] = None
        self._episode_reward = 0.0
        self._rng = np.random.RandomState()

        try:
            import gymnasium
            self.action_space = gymnasium.spaces.Discrete(len(ACTION_NAMES))
            self.observation_space = gymnasium.spaces.Box(
                0, 1, shape=self.view_shape + (len(self.output_channels),),
                dtype=np.uint8)
        except ImportError:  # pragma: no cover
            self.action_space = self.observation_space = None

    # -- core API ----------------------------------------------------------

    def seed(self, seed=None):
        from .game import seed as seed_engine
        self._rng = np.random.RandomState(seed)
        if seed is not None:
            seed_engine(seed)
        return [seed]

    def get_obs(self):
        game = self.game
        board = game.board.astype(np.uint16)
        goals = game.goals & np.uint16(C.COLORS)
        if self.remove_white_goals:
            goals = goals * (goals != C.COLORS)
        combined = board + (goals << 3)
        center = (game.agent_loc[1], game.agent_loc[0])
        view = recenter_view(combined, self.view_shape, center,
                             game.exit_locs)
        shifts = np.asarray(self.output_channels, np.uint16)
        return ((view[..., None] >> shifts) & 1).astype(np.uint8)

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self.seed(seed)
        self.game = next(self.level_iterator)
        self.game.revert()
        self.game.update_exit_colors()
        self._episode_reward = 0.0
        return self.get_obs(), {}

    def step(self, action):
        game = self.game
        assert game is not None, "reset() before step()"
        start_points = game.current_points()
        reward = game.execute_action(ACTION_NAMES[int(action)])
        game.advance_board()
        reward += game.current_points() - start_points
        game.update_exit_colors()
        self._episode_reward += reward

        terminated = bool(game.game_over)
        truncated = game.num_steps > self.time_limit
        comp, poss = game.performance_ratio()
        info = {
            "board": game.board,
            "title": game.title,
            "performance": (comp, poss),
            "episode_reward": self._episode_reward,
            "times_up": truncated,
        }
        return self.get_obs(), float(reward), terminated, truncated, info

    def render(self):
        if self.render_mode == "rgb_array":
            from .render.graphics import render_game
            return render_game(self.game, self.view_shape)
        from .render.text import render_game
        return render_game(self.game, self.view_shape)

    def close(self):
        pass


def register(tasks=("append-still", "append-dynamic", "append-spawn",
                    "prune-still", "prune-still-hard", "prune-dynamic",
                    "prune-spawn", "navigation", "challenge",
                    "append-still-easy", "prune-still-easy")):
    """Register ``safelife-{task}-v1`` ids with gymnasium (reference:
    ``SafeLifeEnv.register()``, ``safelife_env.py:211-226``)."""
    import gymnasium

    def make_entry(task):
        def entry(**kwargs):
            from .levels.iterator import safelife_loader
            return SafeLifeGymEnv(safelife_loader(task), **kwargs)
        return entry

    for task in tasks:
        env_id = f"safelife-{task}-v1"
        if env_id not in gymnasium.registry:
            gymnasium.register(id=env_id, entry_point=make_entry(task))
