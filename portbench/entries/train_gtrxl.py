"""PPO training of the GTrXL policy: ``Trainer.train`` on
``SafeLifeGTrXLNet`` with ``RecurrentPPO``, driven as ``train`` drives
the other nets (``Drive``: check, warm-up, window, profile).

Beside ``train``'s numbers the run keeps the rollout's logits in the
check batches (the reference's rollout is compared with them) and the
update's first replay of each check batch (``replay_gap``: the first
minibatch, before the batch's first Adam step, replays its rows' segment
against the memory the rollout started from and has to give the
rollout's logits: a step and a replay that read the ring differently
part here, once the memory holds steps),
the memory's fill the reports carry in the window, and in the profiled
stretch the device ops launched inside the core's calls (``GTrXL.step``
and ``GTrXL.segment``, spanned ``portbench.gtrxl_core``).
"""

import traceback

import numpy as np
import torch

from portbench.entries import train as base
from portbench.harness import common, counts, judge, trace
from portbench.harness import gtrxl as HG
from portbench.reference import env as RE
from portbench.reference import follow
from portbench.reference import gtrxl as RG


def make_net(ctx, device):
    """The configuration's net with the run's weights: (net, weights)."""
    from safelife_torch.training import model
    cfg, core = ctx.config, ctx.config["core"]
    weights = HG.make(cfg, ctx.args.seed, device)
    net = getattr(model, cfg["net"])(
        view_shape=tuple(cfg["view_shape"]), in_channels=cfg["channels"],
        num_actions=cfg["num_actions"], n_gamma=cfg["n_gamma"],
        compute_dtype=getattr(torch, cfg["trunk_dtype"]),
        generator=torch.Generator().manual_seed(0), layers=core["layers"],
        d_model=core["d_model"], heads=core["heads"],
        head_dim=core["head_dim"], mlp=core["mlp"],
        memory=core["memory"]).to(device)
    net.load_state_dict(weights)
    return net, weights


def make_trainer(ctx, device, net, num_envs):
    """The ``Trainer`` of the traffic's env on ``net``, recurrent."""
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
                      report_every=tr["report_every"], recurrent=True,
                      net=cfg["net"]),
        PPOConfig(**ppo), level_paths=(tr["levels"],), net=net,
        device=device)


class Drive(base.Drive):
    """``train.Drive`` that keeps the check batches' rollout logits, the
    window's memory fill, and spans the core's calls in the profile."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.logits, self.fill, self.replay = [], [], []

    def run(self):
        """``train.Drive.run``, printing what a batch raised: the check
        batches' record would hide it as it closes."""
        ppo = self.t.ppo
        real = ppo.train_batch

        def told(*a, **kw):
            try:
                return real(*a, **kw)
            except Exception:
                traceback.print_exc()
                raise
        with base._swapped(ppo, "train_batch", told):
            return super().run()

    def enter(self, i):
        super().enter(i)
        if self.phase == "check":
            net = self.t.net
            real = net.forward

            def forward(obs, carry):
                carry, (logits, values) = real(obs, carry)
                self.logits.append(logits.detach().float().clone())
                return carry, (logits, values)
            self.stack.enter_context(base._swapped(net, "forward", forward))
            self._keep_first_replay()
        elif self.phase == "profile":
            from safelife_torch.training.gtrxl import GTrXL
            marks = trace.Spans(sync=False)
            for fn in ("step", "segment"):
                self.stack.enter_context(marks.around(GTrXL, fn,
                                                      "gtrxl_core"))

    def before_batch(self):
        super().before_batch()
        if self.phase == "check":
            self.replay.append({})

    def _keep_first_replay(self):
        """Keep each batch's first minibatch's rows and replayed logits."""
        from safelife_torch.training import ppo as P
        got = self.replay
        rows, forward = P.minibatch_rows, P.recurrent_forward

        def minibatch_rows(*a):
            idx = rows(*a)
            got[-1].setdefault("rows", idx.clone())
            return idx

        def recurrent_forward(*a):
            logits, values = forward(*a)
            got[-1].setdefault("logits", logits.detach().float().clone())
            return logits, values
        for attr, fn in (("minibatch_rows", minibatch_rows),
                         ("recurrent_forward", recurrent_forward)):
            self.stack.enter_context(base._swapped(P, attr, fn))

    def replay_gap(self, steps):
        """The widest gap over the check batches' first minibatches' steps
        between their replayed logits and the rollout's for their rows, as
        ``logit_gap`` measures it."""
        return max(follow.logit_gap(
            [got["logits"]], [rollout[:steps, got["rows"].to(rollout.device)]])
            for got, rollout in zip(self.replay, self.batch_logits(steps)))

    def report(self, step, metrics):
        super().report(step, metrics)
        if self.phase == "window" and "memory_fill" in metrics:
            self.fill.append(float(np.asarray(metrics["memory_fill"])))

    def batch_logits(self, steps):
        """The check batches' rollout logits, (T + 1, B, A) a batch."""
        calls = self.logits
        return [torch.stack(calls[i:i + steps + 1])
                for i in range(0, len(calls), steps + 1)]


def reference(cfg, tr, weights, check, device, precision="f32", fault=None):
    """The reference's run beside the check batches (``follow.train``)."""
    lrn = RG.learner(cfg, weights, precision, fault)
    return follow.train(cfg, tr, common.path(tr["levels"]), check.start,
                        device, lrn, carry=lrn.net.initial_carry(
                            tr["envs"], device), reset=lrn.net.reset,
                        precision=precision)


def readings(prog_logits, check, ref, weights, more=False, replay_gap=None):
    out = judge.train_readings(check.prog, ref, weights, more=more)
    out["logit_gap"] = follow.logit_gap(prog_logits, ref["logits"])
    if replay_gap is not None:
        out["replay_gap"] = replay_gap
    return out


def run(ctx):
    cfg, tr = ctx.config, ctx.traffic
    steps = cfg["ppo"]["steps_per_env"]
    device = ctx.torch_device()
    net, weights = make_net(ctx, device)
    trainer = make_trainer(ctx, device, net, tr["envs"])
    drive = Drive(trainer, tr["check_batches"], tr["warmup_batches"],
                  ctx.args.seconds, tr["profile_batches"] * ctx.args.trace,
                  ctx.setup_clock)
    drive.run()
    check, logits = drive.check, drive.batch_logits(steps)
    replay_gap = drive.replay_gap(steps)
    del trainer, net

    samples = tr["envs"] * steps
    per_batch = counts.least_seconds(HG.train_flops(cfg, tr["envs"]))
    ctx.attempted, ctx.failed = drive.batches, drive.failed
    ctx.e2e.update(
        train_env_steps_per_s=drive.batches * samples / drive.seconds,
        train_batch_ms_p90=float(np.percentile(drive.batch_ms(), 90)),
        setup_s=drive.setup_s)
    ctx.device = common.device_info(device, 1, common.peak(device))
    ctx.raw.update(kind="train",
                   spans=dict(drive.spans.seconds) if drive.spans else {},
                   window=dict(units=drive.batches, seconds=drive.seconds,
                               least_seconds=per_batch),
                   core_least_seconds=HG.core_least_seconds(cfg, tr["envs"]))
    if drive.fill:
        ctx.raw["memory_fill_pct"] = 100.0 * float(np.mean(drive.fill))
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
    ref = reference(cfg, tr, weights, check, device)
    judge.decide(ctx, readings(logits, check, ref, weights,
                               replay_gap=replay_gap), limits)
