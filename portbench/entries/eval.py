"""Frozen-suite evaluation: ``run_benchmark`` suite after suite, as
``Trainer.evaluate`` runs it at each checkpoint.

Set-up builds the configuration's net (weights from ``--seed``) inside a
``Trainer`` and takes its sampling policy (``Trainer.policy_fn()``),
loads the suite's bank once, runs the integrity guard once, and warms the
suite's shapes with a short suite.  The window runs whole suites, suite
``i`` with a generator seeded from ``--seed`` and ``i``, and ends with the
first to finish at or after ``--seconds``.  Once it has closed the
reference follows one suite of the window, drawn from the seed, and
judges its observations, records and side effects.  The suite is drawn
as the window runs (a reservoir of one): a suite that may be judged keeps
its steps, the others play with the bare policy.
"""

import contextlib
import random
import time

import torch

from portbench.entries.train import make_net, make_trainer
from portbench.harness import common, counts, judge, record, trace
from portbench.reference import env as RE
from portbench.reference import replay


def suite_seed(seed, i):
    return (seed * 1_000_003 + i) % (1 << 63)


def run(ctx):
    from safelife_torch.benchmarking import run_benchmark
    from safelife_torch.env.env import BatchedSafeLifeEnv
    from safelife_torch.levels import loader
    from safelife_torch.utils.integrity import (check_bank_reset_integrity,
                                                check_device_integrity)
    cfg, tr = ctx.config, ctx.traffic
    device = ctx.torch_device()
    net, weights = make_net(ctx, device)
    bank = loader.load_bank(tr["levels"], device=device)
    trainer = make_trainer(ctx, device, net, 1, bank=bank)
    policy = record.RecordingPolicy(trainer.policy_fn())
    check_device_integrity(device)
    check_bank_reset_integrity(bank)
    view = tuple(cfg["view_shape"])

    def suite(i, time_limit=tr["time_limit"],
              samples=tr["side_effect_samples"], keep=False):
        policy.begin(i, keep)
        gen = torch.Generator(device).manual_seed(suite_seed(ctx.args.seed, i))
        return run_benchmark(bank, policy, generator=gen, view_shape=view,
                             time_limit=time_limit,
                             side_effect_samples=samples, device=device)

    suite(-1, tr["warmup_time_limit"], tr["warmup_side_effect_samples"],
          keep=True)
    policy.suites.clear()
    pick, draw = None, random.Random(ctx.args.seed)
    common.sync(device)
    common.reset_peak(device)
    setup_s = ctx.setup_clock()

    results = []
    calls0 = policy.calls
    t0 = time.perf_counter()
    while True:
        i = len(results)
        if draw.random() * (i + 1) < 1:  # suite i replaces the one drawn
            policy.suites.pop(pick, None)
            pick = i
        results.append(suite(i, keep=pick == i))
        if time.perf_counter() - t0 >= ctx.args.seconds:
            break
    seconds = time.perf_counter() - t0
    levels = bank.num_levels
    calls = policy.calls - calls0

    prof = None
    if ctx.args.trace:
        marks = trace.Spans(sync=False)
        with contextlib.ExitStack() as stack:
            stack.enter_context(marks.around(BatchedSafeLifeEnv, "step",
                                             "env_step"))
            n = len(results)
            prof = trace.profile(lambda: suite(n))
    ctx.device = common.device_info(device, 1, common.peak(device))
    per_call = counts.least_seconds(counts.forward_flops(cfg)) * levels
    ctx.attempted = levels * len(results)
    ctx.failed = sum(int((~torch.isfinite(torch.as_tensor(
        r["side_effects"]))).sum()) for r in results)
    ctx.e2e.update(eval_levels_per_s=ctx.attempted / seconds, setup_s=setup_s)
    ctx.raw.update(
        kind="eval",
        suite_wall=[r["wall_time"] for r in results],
        side_effect=[sum(r["side_effect_time"]) for r in results],
        window=dict(units=len(results), seconds=seconds,
                    least_seconds=per_call * calls / len(results)))
    if prof is not None:
        lv = RE.load_levels(common.path(tr["levels"]))
        ctx.raw["profile"] = dict(prof, units=1)
        ctx.raw["env_step_bytes"] = counts.env_step_bytes(
            lv["board"].shape[:2], view, cfg["channels"], levels)
        ctx.device["busy_s"] = trace.busy(prof["device"], prof["window"])
        ctx.device["window_s"] = (prof["window"][1] - prof["window"][0]) * 1e-9
        ctx.breakdown = trace.breakdown(prof["device"], prof["window"],
                                        prof["spans"])

    steps, prog = policy.suites[pick], results[pick]
    del trainer, bank, policy, results
    common.empty_cache(device)
    limits = common.load_json(f"portbench/limits/{ctx.cell['name']}.json")
    ref = replay.evaluate(cfg, tr, common.path(tr["levels"]), weights, steps,
                          device)
    judge.decide(ctx, judge.eval_readings(prog, ref), limits)
