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
``global_counter``, ``safelife_ppo.py:88-106``).  With ``record_videos``
every checkpoint is followed by one recorded episode of the current policy,
``<logdir>/episode-<step>.npz`` and its ``.gif``
(:meth:`Trainer.maybe_record_video`).

Data-parallel training (``Trainer(mesh=)``, a
``safelife_torch.parallel.mesh.DataMesh``): ``num_envs`` stays the whole
batch and each rank steps its block of ``num_envs / world`` environments
(``PPOConfig.data_shards`` must be the world size); the generators are
seeded alike and every draw takes the whole batch's shape, so the ranks
together step as one process with ``data_shards = world`` does.  The
gradient is averaged over the ranks before each clipped Adam step.
Parameters are broadcast from rank 0 at the start, after a restore and
after a bank switch, and banks are made on rank 0 and broadcast.  Episode
stats and metrics are gathered at report time only (every rank logs the
same global numbers), and so is the news that rank 0's background bank
refresh is ready; rank 0 writes the logs, checkpoints, evaluations and
videos, each followed by a barrier.
"""

import dataclasses
import glob
import io
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
from ..utils.profiling import setup_seconds, span, spanned
from .model import SafeLifeCNN, SafeLifeGTrXLNet, SafeLifeLSTMNet
from .ppo import (PPO, PPOConfig, RecurrentPPO, init_train_state,
                  sample_actions)

logger = logging.getLogger(__name__)

# The policies a run can name (``TrainerConfig.net``, ``config.json``):
# classes of this module, looked up by name when a net is made.
NETS = ("SafeLifeCNN", "SafeLifeLSTMNet", "SafeLifeGTrXLNet")
RECURRENT = ("SafeLifeLSTMNet", "SafeLifeGTrXLNet")


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
    record_videos: bool = True    # episode gif after each checkpoint
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
    # The policy's class name (``NETS``); None: SafeLifeLSTMNet where
    # ``recurrent``, else SafeLifeCNN.  SafeLifeGTrXLNet is recurrent.
    net: Optional[str] = None


def net_name(cfg: TrainerConfig):
    """The class name of ``cfg``'s policy, checked against ``recurrent``."""
    name = cfg.net or ("SafeLifeLSTMNet" if cfg.recurrent else "SafeLifeCNN")
    if name not in NETS:
        raise ValueError(f"unknown net {name!r}; one of {sorted(NETS)}")
    if (name in RECURRENT) != cfg.recurrent:
        raise ValueError(f"{name} with recurrent={cfg.recurrent}")
    return name


def make_training_env(cfg: TrainerConfig, device=None, shard=(0, 1)):
    """The reference's training wrapper stack (safelife_ppo.py:111-139):
    base env (33x33 view) -> MovementBonus -> SideEffectPenalty ->
    Continuing, on ``device`` (``cuda`` unless the caller passes another),
    with the CUDA kernels on; ``shard=(rank, world)`` for one rank's
    block of a data-parallel batch (see ``BatchedSafeLifeEnv``)."""
    env = BatchedSafeLifeEnv(EnvConfig(
        view_shape=cfg.view_shape, time_limit=cfg.time_limit), device=device,
        shard=shard)
    env = W.MovementBonusWrapper(env, movement_bonus=cfg.movement_bonus)
    env = W.SideEffectPenaltyWrapper(
        env, penalty_coef=cfg.impact_penalty,
        min_performance=cfg.min_performance)
    return W.ContinuingWrapper(env)


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
    unless the caller passes another; the mesh's device on a ``mesh``)."""

    @spanned("setup.trainer")
    def __init__(self, trainer_cfg: TrainerConfig,
                 ppo_cfg: PPOConfig = PPOConfig(),
                 bank=None,
                 level_paths: Sequence[str] = (
                     "benchmarks/v1.0/append-still.npz",),
                 net=None, env=None, level_names=None,
                 bank_schedule=None, bank_factory=None, device=None,
                 mesh=None):
        self.cfg = trainer_cfg
        self.ppo_cfg = ppo_cfg
        self.mesh = mesh
        self.rank, self.world_size = ((mesh.rank, mesh.world_size) if mesh
                                      else (0, 1))
        self.device = resolve_device(
            device if device is not None or mesh is None else mesh.device)
        if mesh is not None and self.device != mesh.device:
            raise ValueError(f"trainer on {self.device}, mesh on "
                             f"{mesh.device}")
        if trainer_cfg.num_envs % self.world_size:
            raise ValueError(f"{trainer_cfg.num_envs} environments do not "
                             f"divide over {self.world_size} ranks")
        # The environments this process steps.
        self.local_envs = trainer_cfg.num_envs // self.world_size
        if bank is None and self.rank == 0:
            bank = loader.load_bank(*level_paths, device=self.device)
        self.bank = self._replicate_bank(bank)
        self.bank_factory = bank_factory  # regenerates the CURRENT bank
        self._refresher = None  # rank 0's background bank-regen thread
        self.level_names = level_names
        self.env = env if env is not None else make_training_env(
            trainer_cfg, self.device, shard=(self.rank, self.world_size))
        if W.unwrap_env(self.env).shard != (self.rank, self.world_size):
            raise ValueError("the env must hold this rank's shard")
        self.ppo = (RecurrentPPO if trainer_cfg.recurrent else PPO)(
            ppo_cfg, self.env, mesh=mesh)

        # Weights from a CPU generator (the same on every device), the
        # rollouts' and the resets' draws from one on the device (seeded
        # alike on every rank).
        init = torch.Generator().manual_seed(trainer_cfg.seed)
        self.generator = torch.Generator(self.device)
        self.generator.manual_seed(trainer_cfg.seed)
        self.env_state = self.env.reset_all(
            self.bank, self.local_envs, self.generator)
        self.obs = self.env.observe(self.env_state)
        self.net = (net or globals()[net_name(trainer_cfg)](
            view_shape=trainer_cfg.view_shape, in_channels=self.obs.shape[-1],
            num_actions=9, n_gamma=ppo_cfg.n_gamma,
            generator=init)).to(self.device)
        self.train_state = init_train_state(ppo_cfg, self.net)
        self._replicate_params()
        # The recurrent carry of the training envs (None for the CNN).
        self.carry = (self._initial_carry() if trainer_cfg.recurrent
                      else None)
        self.dead_start_evals = 0  # consecutive evals flagged dead

        # Rank 0 writes the run's files.
        logdir = trainer_cfg.logdir if self.rank == 0 else None
        if logdir:
            self._write_run_config()
        self.writer = make_summary_writer(logdir)
        self.episode_logger = EpisodeLogger(
            os.path.join(logdir, "training.yaml") if logdir else None,
            summary_writer=self.writer)
        self._steps_offset = 0  # counters restored from checkpoint
        self._next_refresh = trainer_cfg.fresh_levels_every
        # Curriculum: [(step_threshold, bank_factory), ...] sorted by step.
        # When the global step crosses a threshold, the level bank is
        # swapped and all envs reset (reference start-training's
        # spawn_loader curriculum, start-training:169-184).
        self.bank_schedule = sorted(bank_schedule or [], key=lambda x: x[0])

    # -- the mesh ----------------------------------------------------------

    def _replicate_bank(self, bank):
        """Rank 0's ``bank`` on every rank (other ranks may pass None)."""
        if self.mesh is None:
            return bank
        from ..parallel.mesh import replicate_bank
        return replicate_bank(self.mesh, bank)

    def _replicate_params(self):
        """Rank 0's parameters and ``spe`` on every rank."""
        if self.mesh is not None:
            from ..parallel.mesh import replicate
            replicate(self.mesh, (self.net, self.train_state.spe))

    def _initial_carry(self):
        """The recurrent net's empty carry, with room for a rollout's
        steps where the carry keeps them."""
        return self.net.initial_carry(self.local_envs,
                                      self.ppo_cfg.steps_per_env)

    def _barrier(self):
        if self.mesh is not None:
            self.mesh.barrier()

    def _gather(self, metrics, episodes):
        """The report's metrics averaged over the ranks, its episode stats,
        (T * batches, B) each, gathered along the environments, on the
        host; and on a mesh of several ranks whether rank 0's fresh bank
        is ready, riding the metrics' all-reduce (None in one process,
        where the refresh reads its own thread).  The metrics, as float32,
        come back as one buffer: one copy however many there are."""
        episodes = {k: torch.cat([e[k] for e in episodes])
                    for k in episodes[0]}
        keys = sorted(metrics)
        parts = [metrics[k].detach().to(torch.float32).reshape(-1)
                 for k in keys]
        if self.world_size > 1:
            parts.append(torch.tensor([float(self._refresh_ready())],
                                      device=self.device))
        flat = torch.cat(parts)
        if self.world_size > 1:
            flat = self.mesh.all_reduce(flat)
            episodes = {k: self.mesh.all_gather(v, dim=1)
                        for k, v in episodes.items()}
        flat = flat.cpu().numpy()
        ready = None
        if self.world_size > 1:
            ready = bool(flat[-1] > 0)
            flat = flat[:-1] / np.float32(self.world_size)
        ends = np.cumsum([metrics[k].numel() for k in keys])[:-1]
        metrics = {k: v.reshape(metrics[k].shape)
                   for k, v in zip(keys, np.split(flat, ends))}
        return metrics, _host(episodes), ready

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
                "net": net_name(self.cfg),
            }, fh)

    # -- checkpointing -----------------------------------------------------

    def _checkpoint_dir(self):
        return (os.path.join(self.cfg.logdir, "checkpoints")
                if self.cfg.logdir else None)

    def global_step(self):
        return int(W.unwrap(self.env_state).num_steps) + self._steps_offset

    def save_checkpoint(self):
        """Rank 0 writes the checkpoint (the episode counters summed over
        the ranks), then every rank waits for it."""
        root = self._checkpoint_dir()
        if root is None:
            return
        core = W.unwrap(self.env_state)
        episodes = torch.stack([core.episodes_started,
                                core.episodes_completed]).to(torch.int64)
        if self.mesh is not None:
            self.mesh.all_reduce(episodes)
        if self.rank == 0:
            self._write_checkpoint(root, episodes.tolist())
        self._barrier()

    def _write_checkpoint(self, root, episodes):
        os.makedirs(root, exist_ok=True)
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
                "episodes_started": episodes[0],
                "episodes_completed": episodes[1],
            },
        }
        path = os.path.join(root, f"{step}.pt")
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)  # a crash leaves no torn file
        for old in _checkpoints(root)[:-self.cfg.max_checkpoints]:
            os.remove(old[1])
        logger.info("saved checkpoint at step %d", step)

    def restore_checkpoint(self, step=None):
        """Restore the newest checkpoint (or ``step``'s) of the logdir;
        returns whether there was one.  On a mesh rank 0 reads it and every
        rank loads its bytes: the ranks on other hosts need not hold the
        logdir (only rank 0 writes it)."""
        data = None
        root = self._checkpoint_dir()
        found = dict(_checkpoints(root)) if root and self.rank == 0 else {}
        if found:
            step = step if step is not None else max(found)
            with open(found[step], "rb") as fh:
                data = fh.read()
        if self.mesh is not None:
            data = self.mesh.broadcast_object(data)
        if data is None:
            return False
        payload = torch.load(io.BytesIO(data), map_location=self.device,
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
        # safelife_ppo.py:88-106).  The episode counters are the ranks'
        # sum: rank 0's state takes them, the others' start from 0.
        counters = payload["counters"]
        core = W.unwrap(self.env_state)
        i32 = dict(dtype=torch.int32, device=self.device)
        self._steps_offset = int(counters["num_steps"])
        own = self.rank == 0
        core = core.replace(
            num_steps=torch.tensor(0, **i32),
            episodes_started=torch.tensor(
                counters["episodes_started"] if own else 0, **i32),
            episodes_completed=torch.tensor(
                counters["episodes_completed"] if own else 0, **i32))
        self.env_state = W.replace_core(self.env_state, core)
        self._replicate_params()
        logger.info("restored checkpoint from step %d", self._steps_offset)
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
        with span("setup.guard"):
            check_device_integrity(self.device)
            check_bank_reset_integrity(self.bank)
        logger.info("set-up: %s", ", ".join(
            f"{name} {seconds:.2f} s" for name, seconds in
            setup_seconds(threading.get_ident()).items()))

        # Ops-level crash-resume marker (reference start-training:53-66:
        # active_job.txt lets a restarted box resume its run).
        marker = None
        if self.cfg.logdir and self.rank == 0:
            marker = os.path.join(self.cfg.logdir, "active_job.txt")
            with open(marker, "w") as fh:
                fh.write(f"{os.getpid()} step={self.global_step()}\n")

        pending_eps = []  # device-side episode stats, flushed at report time
        while self.global_step() < total:
            with span("train.switch_bank"):
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

            # The ranks of a mesh learn of a fresh bank at reports only.
            ready = False if self.world_size > 1 else None
            if step >= next_report:
                with span("train.report"):
                    with span("report.gather"):
                        metrics, eps, ready = self._gather(metrics,
                                                           pending_eps)
                    pending_eps = []
                    with span("report.log"):
                        self.episode_logger.log_batch(
                            eps, global_step=step,
                            level_names=self.level_names)
                        log_training_metrics(self.writer, metrics, step)
                        now = time.time()
                        sps = (step - last_steps) / max(now - last_t, 1e-9)
                        last_steps, last_t = step, now
                        if self.writer:
                            self.writer.add_scalar("perf/env_steps_per_sec",
                                                   sps, step)
                        logger.info(
                            "step %d/%d  reward=%.3f  entropy=%.3f  "
                            "%.0f steps/s", step, total,
                            float(metrics["mean_reward"]),
                            float(metrics["entropy"]), sps)
                if progress_fn:
                    progress_fn(step, metrics)
                next_report = step + self.cfg.report_every

            with span("train.refresh"):
                self._maybe_refresh_bank(step, ready)

            if step >= next_save:
                with span("train.checkpoint"):
                    self.save_checkpoint()
                with span("train.video"):
                    self.maybe_record_video()
                saved = step
                next_save = _next_on_grid(step, self.cfg.save_every)
            if step >= next_eval:
                with span("train.evaluate"):
                    self.evaluate()
                evaluated = step
                next_eval = _next_on_grid(step, eval_every)

        if self.global_step() != saved:
            with span("train.checkpoint"):
                self.save_checkpoint()
            with span("train.video"):
                self.maybe_record_video()
        if self.global_step() != evaluated:
            with span("train.evaluate"):
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
            bank = None
            if self.rank == 0:
                bank = factory() if callable(factory) else factory
            self.bank = self._replicate_bank(bank)
            offset = self.global_step()
            self.env_state = self.env.reset_all(
                self.bank, self.local_envs, self.generator)
            self.obs = self.env.observe(self.env_state)
            if self.carry is not None:  # fresh episodes: a fresh carry
                self.carry = self._initial_carry()
            # reset_all zeroes the global counters; fold them into offset
            self._steps_offset = offset
            self._replicate_params()

    def _refresh_ready(self):
        """Whether this rank's background regeneration has a bank ready
        (only rank 0 runs one; a failed one is dropped)."""
        if self._refresher is None or self._refresher[0].is_alive():
            return False
        if "bank" not in self._refresher[1]:
            self._refresher = None
            return False
        return True

    def _maybe_refresh_bank(self, step, ready=None):
        """Endless levels (reference: the safelife_loader generates forever,
        file_finder.py:143-201): rank 0 regenerates the training bank from
        its factory every ``fresh_levels_every`` env steps on a background
        thread, and the bank is swapped in between batches once every
        rank knows it is ``ready``: at once in one process, at the next
        report on a mesh of several ranks (the flag rides the report's
        all-reduce), then broadcast from rank 0.  Auto-resets gather from
        the bank each rollout, so a swap changes all FUTURE episodes
        without disturbing running ones.  ``ready`` None reads this
        process's own thread (one process only)."""
        if not self.cfg.fresh_levels_every or self.bank_factory is None:
            return
        if ready is None:
            ready = self._refresh_ready()
        if ready:
            bank = self._refresher[1]["bank"] if self.rank == 0 else None
            self._refresher = None
            self.bank = self._replicate_bank(bank)
            logger.info("endless levels: fresh bank at step %d", step)
        elif (self.rank == 0 and self._refresher is None
              and step >= self._next_refresh):
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
        results, or None without an ``eval_suite`` (and on ranks other
        than 0, which wait for rank 0's)."""
        if self.cfg.eval_suite is None:
            return None
        if self.rank != 0:
            self._barrier()
            return None
        results = self._evaluate()
        self._barrier()
        return results

    def _evaluate(self):
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

    def maybe_record_video(self):
        """With ``record_videos`` and a ``logdir``: one episode of the
        training env at B = 1 from a level drawn by a generator of seed
        ``seed + step`` (the training draws are left alone), with the
        current policy, for up to ``time_limit`` steps, saved as
        ``<logdir>/episode-<step>.npz`` and ``.gif`` by rank 0."""
        if not (self.cfg.record_videos and self.cfg.logdir):
            return
        if self.rank == 0:
            from ..metrics.recording import record_episode, save_trajectory
            step = self.global_step()
            generator = torch.Generator(self.device).manual_seed(
                self.cfg.seed + step)
            level_idx = int(torch.randint(
                0, self.bank.num_levels, (1,), generator=generator,
                device=self.device))
            env = self.env
            if W.unwrap_env(env).shard[1] > 1:  # one env, not a shard
                env = make_training_env(self.cfg, self.device)
            traj = record_episode(env, self.bank, self.policy_fn(),
                                  generator, level_idx=level_idx,
                                  max_steps=self.cfg.time_limit)
            save_trajectory(traj, os.path.join(
                self.cfg.logdir, f"episode-{step}"))
        self._barrier()

    def policy_fn(self):
        """Sampling policy of the trainer's net (its current weights at each
        call): ``policy(obs, generator=None) -> actions``, or for a
        recurrent net ``policy(obs, carry, generator=None) -> (actions,
        carry)`` with ``.recurrent`` and ``.init_carry``."""
        return _sampling_policy(self.net)


def _sampling_policy(net):
    if hasattr(net, "initial_carry"):
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
    name = run_cfg.get("net") or (
        "SafeLifeLSTMNet" if run_cfg.get("recurrent", False)
        else "SafeLifeCNN")
    if name not in NETS:
        raise ValueError(f"{logdir}: unknown net {name!r}")
    net = globals()[name](view_shape=view_shape,
                          in_channels=run_cfg.get("in_channels", 15),
                          num_actions=run_cfg.get("num_actions", 9),
                          n_gamma=run_cfg.get("n_gamma", 1)).to(device)
    net.load_state_dict(payload["net"])
    net.eval()
    return _sampling_policy(net), view_shape
