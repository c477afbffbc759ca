"""PPO training on a level suite: ``Trainer.train`` itself, timed.

Set-up builds one ``Trainer`` from the configuration's net (weights from
``--seed``) and the traffic's levels, and calls its ``train`` once; that
call runs the integrity guard, then batch after batch, each
``PPO.train_batch`` (or ``RecurrentPPO.train_batch``) with the episode
stats brought to the host at the report cadence.  The benchmark only
hooks the call: its first ``check_batches`` batches run with the env's
outputs recorded, the next ``warmup_batches`` warm up, and the window then
runs until the first batch to finish at or after ``--seconds``, where the
hook ends the call before another batch begins.  With ``--trace 1`` a profiled stretch of ``profile_batches``
follows in the same call.  Once it has ended the reference follows the
check batches and judges them.
"""

import contextlib
import time

import numpy as np
import torch

from portbench.harness import common, counts, judge, record, trace
from portbench.harness import weights as W
from portbench.reference import env as RE
from portbench.reference import replay


def make_net(ctx, device):
    """The configuration's net with the run's weights: (net, weights)."""
    from safelife_torch.training import model
    cfg = ctx.config
    weights = W.make(cfg, ctx.args.seed, device)
    net = getattr(model, cfg["net"])(
        view_shape=tuple(cfg["view_shape"]), in_channels=cfg["channels"],
        num_actions=cfg["num_actions"], n_gamma=cfg["n_gamma"],
        compute_dtype=getattr(torch, cfg["trunk_dtype"]),
        generator=torch.Generator().manual_seed(0)).to(device)
    net.load_state_dict(weights)
    return net, weights


def make_trainer(ctx, device, net, num_envs, bank=None):
    """The ``Trainer`` of the traffic's env on ``net``."""
    from safelife_torch.training.driver import Trainer, TrainerConfig
    from safelife_torch.training.ppo import PPOConfig
    cfg, tr = ctx.config, ctx.traffic
    ppo = {k: tuple(v) if isinstance(v, list) else v
           for k, v in cfg["ppo"].items()}
    return Trainer(
        TrainerConfig(num_envs=num_envs, view_shape=tuple(cfg["view_shape"]),
                      time_limit=tr["time_limit"],
                      impact_penalty=tr["impact_penalty"],
                      seed=ctx.args.seed, record_videos=False,
                      report_every=tr["report_every"],
                      recurrent=cfg["net"] == "SafeLifeLSTMNet"),
        PPOConfig(**ppo), bank=bank, level_paths=(tr["levels"],), net=net,
        device=device)


class Done(Exception):
    """Ends ``Trainer.train`` at a report, once the last phase is over."""


@contextlib.contextmanager
def _swapped(owner, attr, value):
    saved = getattr(owner, attr)
    setattr(owner, attr, value)
    try:
        yield
    finally:
        setattr(owner, attr, saved)


class Drive:
    """One call of ``trainer.train`` through the run's phases: ``check``
    batches recorded, ``warmup`` batches, the window (batches until the
    first to finish at or after ``seconds``; None: no window), then
    ``profile`` batches profiled.  A phase ends where the next batch
    starts, so each batch's report stays in it, and the call ends there
    too, before the next batch has begun."""

    def __init__(self, trainer, check, warmup=0, seconds=None, profile=0,
                 setup_clock=None):
        self.t = trainer
        self.device = trainer.device
        self.plan = [("check", check)] + [("warmup", warmup)] * bool(warmup)
        if seconds is not None:
            self.plan.append(("window", seconds))
            self.plan += [("profile", profile)] * bool(profile)
        self.setup_clock = setup_clock
        self.phase, self.index, self.count = None, -1, 0
        self.stack = contextlib.ExitStack()
        self.ends, self.failed = [], 0
        # A traced run (one with a profiled stretch) spans its window too.
        self.spans = trace.Spans(sync=True) if profile else None
        self.prof = None

    def run(self):
        """Drive the call; returns self."""
        ppo = self.t.ppo
        real = ppo.train_batch

        def train_batch(*a, **kw):
            self.before_batch()
            out = real(*a, **kw)
            self.count += 1
            if self.phase == "check":
                self.check.keep(out[-1])
            return out
        with _swapped(ppo, "train_batch", train_batch):
            try:
                self.t.train(total_steps=1 << 62, progress_fn=self.report)
            except Done:
                pass
            finally:
                self.stack.close()
        self.t = None
        return self

    def done(self):
        """Whether the current phase has run its course."""
        if self.phase == "window":
            return time.perf_counter() - self.t0 >= self.goal
        return self.phase is None or self.count >= self.goal

    def before_batch(self):
        if self.phase == "window":
            self.ends.append(common.mark(self.device))
        if self.done():
            if self.phase == "window":
                common.sync(self.device)
                self.seconds = time.perf_counter() - self.t0
                self.batches = len(self.ends)
            self.enter(self.index + 1)
        if self.phase == "check":
            self.check.rec.begin()

    def enter(self, i):
        """Start phase ``i`` of the plan (past the end: end the call)."""
        self.stack.close()
        self.stack = contextlib.ExitStack()
        if i >= len(self.plan):
            self.phase = None
            raise Done
        self.index, (self.phase, self.goal) = i, self.plan[i]
        self.count = 0
        if self.phase == "check":
            self.check = CheckBatches(self.t, self.stack)
        elif self.phase == "window":
            if self.spans is not None:
                spans_on(self.stack, self.spans, self.t)
            common.sync(self.device)
            common.reset_peak(self.device)
            self.setup_s = self.setup_clock() if self.setup_clock else 0.0
            self.t0 = time.perf_counter()
            self.start = common.mark(self.device)
        elif self.phase == "profile":
            marks = trace.Spans(sync=False)
            spans_on(self.stack, marks, self.t)
            from safelife_torch.env.env import BatchedSafeLifeEnv
            self.stack.enter_context(marks.around(BatchedSafeLifeEnv, "step",
                                                  "env_step"))
            self.prof = self.stack.enter_context(trace.profiling())

    def report(self, step, metrics):
        """``progress_fn`` of the call: a window's report that is not a
        number counts its batch as failed."""
        if self.phase == "window" and not all(
                np.isfinite(np.asarray(v)).all() for v in metrics.values()):
            self.failed += 1

    def batch_ms(self):
        """Each window batch's time, between CUDA events where batches
        start."""
        return [common.ms_between(a, b)
                for a, b in zip([self.start] + self.ends[:-1], self.ends)]


class CheckBatches:
    """The first batches recorded: the env's outputs, each minibatch's
    loss, Adam's first moments after its first step, each batch's report
    and the parameters at the end."""

    def __init__(self, trainer, stack):
        from safelife_torch.env import wrappers
        from safelife_torch.env.wrappers import unwrap
        from safelife_torch.training import ppo as P
        self.t = trainer
        self.rec = record.recorder(wrappers.Wrapper)(trainer.ppo.env)
        self.start = dict(
            init_idx=unwrap(trainer.env_state).level_idx.to(torch.int64),
            init_digest=RE.digest(trainer.obs))
        opt = trainer.train_state.optimizer
        self.names = {id(p): k for k, p in trainer.net.named_parameters()}
        self.names[id(trainer.train_state.spe)] = "spe"
        self.prog = dict(batches=[], losses=[])
        prog = self.prog

        def keep_loss(fn):
            def loss(*a, **kw):
                total, terms = fn(*a, **kw)
                prog["losses"].append(total.detach().clone())
                return total, terms
            return loss

        def first_step(fn):
            def step():
                fn()
                prog.setdefault("exp_avg", self.moments())
            return step

        for owner, attr, value in (
                (trainer.ppo, "env", self.rec),
                (P, "ppo_loss", keep_loss(P.ppo_loss)),
                (P, "ppo_loss_recurrent", keep_loss(P.ppo_loss_recurrent)),
                (opt, "step", first_step(opt.step))):
            stack.enter_context(_swapped(owner, attr, value))
        stack.callback(self.finish)

    def moments(self):
        opt = self.t.train_state.optimizer
        state = opt.state_dict()["adam"]["state"]
        return {self.names[id(p)]: state[i]["exp_avg"].clone() if i in state
                else torch.zeros_like(p) for i, p in enumerate(opt.params)}

    def keep(self, metrics):
        """A batch's reported loss terms and means, and after the first
        batch the parameters."""
        self.prog["batches"].append({k: float(metrics[k].float().mean())
                                     for k in judge.LOSS_KEYS})
        self.prog.setdefault("params1", self.params())

    def params(self):
        t = self.t
        params = dict(t.net.named_parameters(), spe=t.train_state.spe)
        return {k: p.detach().clone() for k, p in params.items()}

    def finish(self):
        """Keep what the reference follows (``start``) and judges
        (``prog``), and let go of the trainer."""
        prog, t = self.prog, self.t
        prog.setdefault("exp_avg", self.moments())
        prog["losses"] = [float(x) for x in prog["losses"]]
        prog["params"] = self.params()
        self.start["batches"] = [
            dict(br, steps=[dict(st, action=st["action"].to(torch.int64))
                            for st in br["steps"]],
                 fresh_idx=br["fresh_idx"].to(torch.int64))
            for br in self.rec.batches]
        self.t = self.rec = None


def spans_on(stack, spans, trainer):
    """Span the program's rollout, GAE and update calls."""
    from safelife_torch.training import ppo as P
    for fn in ("rollout", "rollout_recurrent", "compute_gae"):
        stack.enter_context(spans.around(P, fn))
    stack.enter_context(spans.around(trainer.ppo, "update"))


def run(ctx):
    cfg, tr = ctx.config, ctx.traffic
    device = ctx.torch_device()
    net, weights = make_net(ctx, device)
    trainer = make_trainer(ctx, device, net, tr["envs"])
    drive = Drive(trainer, tr["check_batches"], tr["warmup_batches"],
                  ctx.args.seconds, tr["profile_batches"] * ctx.args.trace,
                  ctx.setup_clock)
    drive.run()
    check = drive.check
    del trainer

    samples = tr["envs"] * cfg["ppo"]["steps_per_env"]
    per_batch = counts.least_seconds(counts.train_flops(
        cfg, samples, cfg["ppo"]["epochs_per_batch"], samples + tr["envs"]))
    ctx.attempted, ctx.failed = drive.batches, drive.failed
    ctx.e2e.update(
        train_env_steps_per_s=drive.batches * samples / drive.seconds,
        train_batch_ms_p90=float(np.percentile(drive.batch_ms(), 90)),
        setup_s=drive.setup_s)
    ctx.device = common.device_info(device, 1, common.peak(device))
    ctx.raw.update(kind="train",
                   spans=dict(drive.spans.seconds) if drive.spans else {},
                   window=dict(units=drive.batches, seconds=drive.seconds,
                               least_seconds=per_batch))
    prof = drive.prof
    if prof is not None:
        lv = RE.load_levels(common.path(tr["levels"]))
        ctx.raw["profile"] = dict(prof, units=tr["profile_batches"])
        ctx.raw["env_step_bytes"] = counts.env_step_bytes(
            lv["board"].shape[:2], cfg["view_shape"], cfg["channels"],
            tr["envs"])
        ctx.device["busy_s"] = trace.busy(prof["device"], prof["window"])
        ctx.device["window_s"] = (prof["window"][1] - prof["window"][0]) * 1e-9
        ctx.breakdown = trace.breakdown(prof["device"], prof["window"],
                                        prof["spans"])

    common.empty_cache(device)
    limits = common.load_json(f"portbench/limits/{ctx.cell['name']}.json")
    ref = replay.train(cfg, tr, common.path(tr["levels"]), weights,
                       check.start, device)
    judge.decide(ctx, judge.train_readings(check.prog, ref, weights), limits)
