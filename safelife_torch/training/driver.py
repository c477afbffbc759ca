"""Training driver: env factory, train loop, checkpointing, frozen-suite
evaluation, logging (port of ``safelife_tpu.training.driver``).

Capability parity with ``training/safelife_ppo.py`` (SafeLife-specific
hyperparameters, wrapped env factory, checkpoint/restore incl. global
counters) and the outer loop of ``training/ppo.py:550-559``: the Python
loop calls :meth:`PPO.train_batch` (or :meth:`RecurrentPPO.train_batch`
with the LSTM carry), flushes episode logs at report time, checkpoints,
and evaluates the policy on a frozen suite (:meth:`Trainer.evaluate`).
Checkpoints and evaluations fall on grids of the global step: multiples
of ``save_every`` and of ``eval_every``.  The last batch is checkpointed
and evaluated unless that step was already.

Checkpoints are ``torch.save`` files under ``<logdir>/checkpoints/``: the
net's and the optimizer's state, ``spe``, the generator's state and the
global env counters.  On restore the env state is kept and the global
counters are resynced (the reference does the same for its
``global_counter``, ``safelife_ppo.py:88-106``).

Not ported yet, and refused with ``NotImplementedError`` when asked for:
episode videos (``record_videos`` with a ``logdir``, ROADMAP A4).
"""

import dataclasses
import glob
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..env.env import BatchedSafeLifeEnv, EnvConfig
from ..env import wrappers as W
from ..levels import loader
from ..metrics.logging import (
    EpisodeLogger, log_training_metrics, make_summary_writer)
from ..utils.integrity import (check_bank_reset_integrity,
                               check_device_integrity)
from .model import SafeLifeCNN, SafeLifeLSTMNet
from .ppo import (PPO, PPOConfig, RecurrentPPO, init_train_state,
                  sample_actions)

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    num_envs: int = 16
    total_steps: int = 6_000_000
    report_every: int = 25_000       # env steps between metric flushes
    save_every: int = 500_000        # env steps between checkpoints
    view_shape: Tuple[int, int] = (33, 33)
    time_limit: int = 1000
    impact_penalty: Any = 0.0        # schedulable
    min_performance: Any = 0.01      # schedulable
    movement_bonus: float = 0.1
    seed: int = 0
    logdir: Optional[str] = None
    max_checkpoints: int = 3
    record_videos: bool = True    # episode gif at each checkpoint (A4)
    # Periodic frozen-suite evaluation: a suite name / path / LevelBank;
    # None disables.  Results go to eval.yaml and eval/* scalars, with the
    # full EMD side-effect scores.  eval_every sets the cadence in env
    # steps (0 = save_every); the last batch is evaluated too.
    eval_suite: Any = None
    eval_every: int = 0
    eval_side_effect_samples: int = 250
    # Endless levels: regenerate the training bank every this many env
    # steps from the current bank factory (0 = fixed bank).  Generation
    # runs on a background thread; the swap happens between batches.
    fresh_levels_every: int = 0
    # Recurrent policy: CNN trunk + LSTM core trained with RecurrentPPO
    # (whole-env minibatches), the reference's optional LSTM path
    # (safelife_ppo.py:168-189).  The carry is threaded through rollouts
    # and reset at episode ends and bank switches.
    recurrent: bool = False


def make_training_env(cfg: TrainerConfig, device=None):
    """The reference's training wrapper stack (safelife_ppo.py:111-139):
    base env (33x33 view) -> MovementBonus -> SideEffectPenalty ->
    Continuing, on ``device`` (``cuda`` unless the caller passes another),
    with the CUDA kernels on."""
    env = BatchedSafeLifeEnv(EnvConfig(
        view_shape=cfg.view_shape, time_limit=cfg.time_limit), device=device)
    env = W.MovementBonusWrapper(env, movement_bonus=cfg.movement_bonus)
    env = W.SideEffectPenaltyWrapper(
        env, penalty_coef=cfg.impact_penalty,
        min_performance=cfg.min_performance)
    return W.ContinuingWrapper(env)


def _unported(cfg: TrainerConfig):
    if cfg.record_videos and cfg.logdir:
        raise NotImplementedError(
            "record_videos with a logdir: episode recording is ROADMAP "
            "item A4, not ported yet; pass record_videos=False")


def _next_on_grid(step, every):
    """The first multiple of ``every`` above ``step``."""
    return (step // every + 1) * every


def _host(tree):
    """Device tensors of a (nested) dict as numpy arrays."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.cpu().numpy() if isinstance(tree, torch.Tensor) else tree


class Trainer:
    """Owns the training loop for one PPO run on ``device`` (``cuda``
    unless the caller passes another)."""

    def __init__(self, trainer_cfg: TrainerConfig,
                 ppo_cfg: PPOConfig = PPOConfig(),
                 bank=None,
                 level_paths: Sequence[str] = (
                     "benchmarks/v1.0/append-still.npz",),
                 net=None, env=None, level_names=None,
                 bank_schedule=None, bank_factory=None, device=None):
        _unported(trainer_cfg)
        self.cfg = trainer_cfg
        self.ppo_cfg = ppo_cfg
        self.device = resolve_device(device)
        self.bank = bank if bank is not None else loader.load_bank(
            *level_paths, device=self.device)
        self.bank_factory = bank_factory  # regenerates the CURRENT bank
        self._refresher = None            # background bank-regen thread
        self.level_names = level_names
        self.env = env if env is not None else make_training_env(
            trainer_cfg, self.device)
        self.ppo = (RecurrentPPO if trainer_cfg.recurrent else PPO)(
            ppo_cfg, self.env)

        # Weights from a CPU generator (the same on every device), the
        # rollouts' and the resets' draws from one on the device.
        init = torch.Generator().manual_seed(trainer_cfg.seed)
        self.generator = torch.Generator(self.device)
        self.generator.manual_seed(trainer_cfg.seed)
        self.env_state = self.env.reset_all(
            self.bank, trainer_cfg.num_envs, self.generator)
        self.obs = self.env.observe(self.env_state)
        net_class = SafeLifeLSTMNet if trainer_cfg.recurrent else SafeLifeCNN
        self.net = (net or net_class(
            view_shape=trainer_cfg.view_shape, in_channels=self.obs.shape[-1],
            num_actions=9, n_gamma=ppo_cfg.n_gamma,
            generator=init)).to(self.device)
        self.train_state = init_train_state(ppo_cfg, self.net)
        # The LSTM carry of the training envs (None for the CNN).
        self.carry = (self.net.initial_carry(trainer_cfg.num_envs)
                      if trainer_cfg.recurrent else None)
        self.dead_start_evals = 0  # consecutive evals flagged dead

        if trainer_cfg.logdir:
            self._write_run_config()
        self.writer = make_summary_writer(trainer_cfg.logdir)
        self.episode_logger = EpisodeLogger(
            os.path.join(trainer_cfg.logdir, "training.yaml")
            if trainer_cfg.logdir else None,
            summary_writer=self.writer)
        self._steps_offset = 0  # counters restored from checkpoint
        self._next_refresh = trainer_cfg.fresh_levels_every
        # Curriculum: [(step_threshold, bank_factory), ...] sorted by step.
        # When the global step crosses a threshold, the level bank is
        # swapped and all envs reset (reference start-training's
        # spawn_loader curriculum, start-training:169-184).
        self.bank_schedule = sorted(bank_schedule or [], key=lambda x: x[0])

    def _write_run_config(self):
        """Persist what's needed to rebuild the policy from the logdir
        (see load_policy)."""
        os.makedirs(self.cfg.logdir, exist_ok=True)
        with open(os.path.join(self.cfg.logdir, "config.json"), "w") as fh:
            json.dump({
                "view_shape": list(self.cfg.view_shape),
                "in_channels": int(self.obs.shape[-1]),
                "n_gamma": self.ppo_cfg.n_gamma,
                "num_actions": 9,
                "time_limit": self.cfg.time_limit,
                "recurrent": self.cfg.recurrent,
            }, fh)

    # -- checkpointing -----------------------------------------------------

    def _checkpoint_dir(self):
        return (os.path.join(self.cfg.logdir, "checkpoints")
                if self.cfg.logdir else None)

    def global_step(self):
        return int(W.unwrap(self.env_state).num_steps) + self._steps_offset

    def save_checkpoint(self):
        root = self._checkpoint_dir()
        if root is None:
            return
        os.makedirs(root, exist_ok=True)
        core = W.unwrap(self.env_state)
        ts = self.train_state
        step = self.global_step()
        payload = {
            "net": self.net.state_dict(),
            "spe": ts.spe.detach(),
            "optimizer": ts.optimizer.state_dict(),
            "update_step": ts.update_step,
            "generator": self.generator.get_state(),
            "counters": {
                "num_steps": step,
                "episodes_started": int(core.episodes_started),
                "episodes_completed": int(core.episodes_completed),
            },
        }
        path = os.path.join(root, f"{step}.pt")
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)  # a crash leaves no torn file
        for old in _checkpoints(root)[:-self.cfg.max_checkpoints]:
            os.remove(old[1])
        logger.info("saved checkpoint at step %d", step)

    def restore_checkpoint(self, step=None):
        root = self._checkpoint_dir()
        found = dict(_checkpoints(root)) if root else {}
        if not found:
            return False
        step = step if step is not None else max(found)
        payload = torch.load(found[step], map_location=self.device,
                             weights_only=True)
        ts = self.train_state
        self.net.load_state_dict(payload["net"])
        with torch.no_grad():
            ts.spe.copy_(payload["spe"])
        ts.optimizer.load_state_dict(payload["optimizer"])
        ts.update_step = payload["update_step"]
        # (map_location moved the generator's CPU state to the device.)
        self.generator.set_state(payload["generator"].cpu())
        # Resync global counters into the env state (reference:
        # safelife_ppo.py:88-106).
        counters = payload["counters"]
        core = W.unwrap(self.env_state)
        i32 = dict(dtype=torch.int32, device=self.device)
        self._steps_offset = int(counters["num_steps"])
        core = core.replace(
            num_steps=torch.tensor(0, **i32),
            episodes_started=torch.tensor(counters["episodes_started"],
                                          **i32),
            episodes_completed=torch.tensor(counters["episodes_completed"],
                                            **i32))
        self.env_state = W.replace_core(self.env_state, core)
        logger.info("restored checkpoint from step %d", step)
        return True

    # -- training ----------------------------------------------------------

    def train(self, total_steps=None, progress_fn: Optional[Callable] = None):
        total = total_steps or self.cfg.total_steps
        next_report = 0
        next_save = _next_on_grid(self.global_step(), self.cfg.save_every)
        eval_every = self.cfg.eval_every or self.cfg.save_every
        next_eval = _next_on_grid(self.global_step(), eval_every)
        saved = None      # the step of the last checkpoint this call wrote
        evaluated = None  # the step of the last evaluation this call ran
        t0 = time.time()
        last_steps, last_t = self.global_step(), t0

        # Golden self-check of the device compute path before any training
        # signal is trusted, and at the end; the training bank itself is
        # probed through the real reset gather too (utils/integrity.py).
        check_device_integrity(self.device)
        check_bank_reset_integrity(self.bank)

        # Ops-level crash-resume marker (reference start-training:53-66:
        # active_job.txt lets a restarted box resume its run).
        marker = None
        if self.cfg.logdir:
            marker = os.path.join(self.cfg.logdir, "active_job.txt")
            with open(marker, "w") as fh:
                fh.write(f"{os.getpid()} step={self.global_step()}\n")

        pending_eps = []  # device-side episode stats, flushed at report time
        while self.global_step() < total:
            self._maybe_switch_bank()
            if self.carry is not None:
                (self.env_state, self.obs, self.carry,
                 metrics) = self.ppo.train_batch(
                    self.train_state, self.env_state, self.obs, self.carry,
                    self.bank, self.generator)
            else:
                self.env_state, self.obs, metrics = self.ppo.train_batch(
                    self.train_state, self.env_state, self.obs, self.bank,
                    self.generator)
            pending_eps.append(metrics.pop("episodes"))
            step = self.global_step()

            if step >= next_report:
                metrics = _host(metrics)
                eps = [_host(e) for e in pending_eps]
                pending_eps = []
                eps = {k: np.concatenate([e[k] for e in eps])
                       for k in eps[0]}
                self.episode_logger.log_batch(
                    eps, global_step=step, level_names=self.level_names)
                log_training_metrics(self.writer, metrics, step)
                now = time.time()
                sps = (step - last_steps) / max(now - last_t, 1e-9)
                last_steps, last_t = step, now
                if self.writer:
                    self.writer.add_scalar("perf/env_steps_per_sec", sps, step)
                logger.info(
                    "step %d/%d  reward=%.3f  entropy=%.3f  %.0f steps/s",
                    step, total, float(metrics["mean_reward"]),
                    float(metrics["entropy"]), sps)
                if progress_fn:
                    progress_fn(step, metrics)
                next_report = step + self.cfg.report_every

            self._maybe_refresh_bank(step)

            if step >= next_save:
                self.save_checkpoint()
                saved = step
                next_save = _next_on_grid(step, self.cfg.save_every)
            if step >= next_eval:
                self.evaluate()
                evaluated = step
                next_eval = _next_on_grid(step, eval_every)

        if self.global_step() != saved:
            self.save_checkpoint()
        if self.global_step() != evaluated:
            self.evaluate()  # final frozen-suite numbers
        check_device_integrity(self.device)  # a corrupted run must not
        if marker and os.path.exists(marker):  # finish quietly
            os.remove(marker)  # clean exit: no restart needed
        if self.writer:
            self.writer.flush()
        logger.info("training done: %d env steps in %.1fs",
                    self.global_step(), time.time() - t0)
        return self.train_state

    def _maybe_switch_bank(self):
        while self.bank_schedule and \
                self.global_step() >= self.bank_schedule[0][0]:
            _, factory = self.bank_schedule.pop(0)
            logger.info("curriculum: switching level bank at step %d",
                        self.global_step())
            if callable(factory):
                self.bank_factory = factory  # endless-levels regen source
            self.bank = factory() if callable(factory) else factory
            offset = self.global_step()
            self.env_state = self.env.reset_all(
                self.bank, self.cfg.num_envs, self.generator)
            self.obs = self.env.observe(self.env_state)
            if self.carry is not None:  # fresh episodes: fresh LSTM state
                self.carry = self.net.initial_carry(self.cfg.num_envs)
            # reset_all zeroes the global counters; fold them into offset
            self._steps_offset = offset

    def _maybe_refresh_bank(self, step):
        """Endless levels (reference: the safelife_loader generates forever,
        file_finder.py:143-201): regenerate the training bank from its
        factory every ``fresh_levels_every`` env steps on a background
        thread, swapping it in between batches.  Auto-resets gather from
        the bank each rollout, so a swap changes all FUTURE episodes
        without disturbing running ones."""
        if not self.cfg.fresh_levels_every or self.bank_factory is None:
            return
        if self._refresher is not None:
            thread, out = self._refresher
            if thread.is_alive():
                return
            self._refresher = None
            if "bank" in out:
                self.bank = out["bank"]
                logger.info("endless levels: fresh bank at step %d", step)
            return
        if step >= self._next_refresh:
            self._next_refresh = step + self.cfg.fresh_levels_every
            out = {}

            def gen():
                try:
                    out["bank"] = self.bank_factory()
                except Exception:  # a failed regeneration keeps the bank
                    logger.exception("bank regeneration failed")

            thread = threading.Thread(target=gen, daemon=True)
            thread.start()
            self._refresher = (thread, out)

    def evaluate(self):
        """Frozen-suite evaluation into the training stream: mean
        performance and full EMD side-effect scores on a held-out suite
        (reference RecordingSafeLifeWrapper logs per-episode side effects,
        env_wrappers.py:195-231; here the exact scoring runs on the eval
        suite at its cadence while every training episode logs its
        in-kernel side-effect cell count).  Returns run_benchmark's
        results, or None without an ``eval_suite``."""
        if self.cfg.eval_suite is None:
            return None
        from ..benchmarking import run_benchmark, summarize
        # Log no numbers a sick device fabricated.
        check_device_integrity(self.device)
        step = self.global_step()
        results = run_benchmark(
            self.cfg.eval_suite, self.policy_fn(),
            logfile=os.path.join(self.cfg.logdir, "eval.yaml")
            if self.cfg.logdir else None,
            generator=torch.Generator(self.device).manual_seed(
                self.cfg.seed + step),
            view_shape=self.cfg.view_shape,
            time_limit=self.cfg.time_limit,
            side_effect_samples=self.cfg.eval_side_effect_samples,
            device=self.device)
        perf = float(np.mean(results["performance"]))
        # Dead-start watchdog: a policy trained for a million steps that
        # scores exactly zero on a goal-bearing suite has never completed
        # a goal cell (one append-dynamic seed of the JAX package sat at
        # 0.000 for 2.5M steps before recovering).  Flag it loudly.
        # Suites without goals (possible == 0 by construction) are exempt.
        has_goals = bool(np.any(np.asarray(results["possible"]) > 0))
        dead = has_goals and perf == 0.0 and step >= 1_000_000
        if dead:
            self.dead_start_evals += 1
            logger.warning(
                "DEAD START: eval mean_perf is exactly 0.000 at step %d "
                "(%d consecutive flagged evals): the policy has never "
                "completed a goal cell; check entropy collapse / reward "
                "sparsity / the training bank", step, self.dead_start_evals)
        else:
            self.dead_start_evals = 0
        if self.writer:
            self.writer.add_scalar("eval/dead_start", float(dead), step)
            self.writer.add_scalar("eval/performance", perf, step)
            self.writer.add_scalar(
                "eval/reward", float(np.mean(results["reward"])), step)
            self.writer.add_scalar(
                "eval/length", float(np.mean(results["length"])), step)
            if "side_effects" in results:
                self.writer.add_scalar(
                    "eval/side_effects",
                    float(np.mean(results["side_effects"])), step)
        logger.info("eval @ %d: %s", step, summarize(results))
        return results

    def policy_fn(self):
        """Sampling policy of the trainer's net (its current weights at each
        call): ``policy(obs, generator=None) -> actions``, or for a
        recurrent net ``policy(obs, carry, generator=None) -> (actions,
        carry)`` with ``.recurrent`` and ``.init_carry``."""
        return _sampling_policy(self.net)


def _sampling_policy(net):
    if isinstance(net, SafeLifeLSTMNet):
        @torch.no_grad()
        def policy(obs, carry, generator=None):
            carry, (logits, _) = net(obs, carry)
            return sample_actions(logits, generator), carry
        policy.recurrent = True
        policy.init_carry = net.initial_carry
    else:
        @torch.no_grad()
        def policy(obs, generator=None):
            logits, _ = net(obs)
            return sample_actions(logits, generator)
    policy.net = net
    return policy


def _checkpoints(root):
    """[(step, path)] of the checkpoints under ``root``, oldest first."""
    found = [(int(os.path.basename(p)[:-3]), p)
             for p in glob.glob(os.path.join(root, "*.pt"))]
    return sorted(found)


def load_policy(logdir, device=None):
    """Rebuild a sampling policy from a training logdir's newest checkpoint
    on ``device`` (``cuda`` unless the caller passes another).

    Returns (policy, view_shape): ``policy(obs, generator=None) ->
    actions``, or for a recurrent run ``policy(obs, carry, generator=None)
    -> (actions, carry)`` with ``.recurrent`` and ``.init_carry``.
    """
    device = resolve_device(device)
    with open(os.path.join(logdir, "config.json")) as fh:
        run_cfg = json.load(fh)
    found = _checkpoints(os.path.join(logdir, "checkpoints"))
    if not found:
        raise FileNotFoundError(f"no checkpoints under {logdir}")
    payload = torch.load(found[-1][1], map_location=device, weights_only=True)
    view_shape = tuple(run_cfg["view_shape"])
    net_class = (SafeLifeLSTMNet if run_cfg.get("recurrent", False)
                 else SafeLifeCNN)
    net = net_class(view_shape=view_shape,
                    in_channels=run_cfg.get("in_channels", 15),
                    num_actions=run_cfg.get("num_actions", 9),
                    n_gamma=run_cfg.get("n_gamma", 1)).to(device)
    net.load_state_dict(payload["net"])
    net.eval()
    return _sampling_policy(net), view_shape
