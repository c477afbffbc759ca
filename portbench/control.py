"""The readings that the limits of ``correct`` are set from: the program's
on many seeds, the control's (the reference in the next precision down
put in the program's place) and planted faults', at a cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 ... \\
        [--control-seeds 3]

prints one JSON line a seed: the program's readings, and for the first
``--control-seeds`` seeds the control's and the faults'.  Training needs
no window: set-up's check batches give every reading.  The benchmark's
runs never run this.
"""

import argparse
import json
import os
import sys
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench.harness import common, judge  # noqa: E402
from portbench.reference import replay  # noqa: E402


def context(name, seed, place=None, traffic=None):
    bench = common.load_bench()
    cell = common.find(bench["workloads"], name, "workload")
    config = common.load_json(common.find(bench["configs"], cell["config"],
                                          "config")["file"])
    traffic = traffic or common.load_json(
        f"portbench/traffic/{cell['traffic']}.json")
    args = types.SimpleNamespace(workload=name, seed=seed, seconds=0.0,
                                 trace=0)
    return common.Context(args=args, bench=bench, cell=cell, config=config,
                          traffic=traffic, setup_clock=time.perf_counter,
                          place=place)


def train_readings(ctx, control):
    import torch
    from portbench.entries import train
    tr, cfg = ctx.traffic, ctx.config
    device = ctx.torch_device()
    net, weights = train.make_net(ctx, device)
    trainer = train.make_trainer(ctx, device, net, tr["envs"])
    check = train.Drive(trainer, tr["check_batches"]).run().check
    prog, rec = check.prog, check.start
    del trainer, net
    levels = common.path(tr["levels"])
    ref = replay.train(cfg, tr, levels, weights, rec, device)
    out = dict(program=judge.train_readings(prog, ref, weights, more=True))
    if control:
        for name, kw in (("control", dict(precision="low")),
                         ("half_batch", dict(fault="half_batch"))):
            other = replay.train(cfg, tr, levels, weights, rec, device, **kw)
            out[name] = judge.train_readings(other, ref, weights, more=True)
    torch.cuda.empty_cache() if device.type == "cuda" else None
    return out


def eval_readings(ctx, control):
    import torch
    from safelife_torch.benchmarking import run_benchmark
    from safelife_torch.levels import loader
    from portbench.entries import eval as E
    from portbench.entries import train
    from portbench.harness import record
    tr, cfg = ctx.traffic, ctx.config
    device = ctx.torch_device()
    net, weights = train.make_net(ctx, device)
    bank = loader.load_bank(tr["levels"], device=device)
    trainer = train.make_trainer(ctx, device, net, 1, bank=bank)
    policy = record.RecordingPolicy(trainer.policy_fn())
    policy.begin(0)
    gen = torch.Generator(device).manual_seed(E.suite_seed(ctx.args.seed, 0))
    prog = run_benchmark(bank, policy, generator=gen,
                         view_shape=tuple(cfg["view_shape"]),
                         time_limit=tr["time_limit"],
                         side_effect_samples=tr["side_effect_samples"],
                         device=device)
    steps = policy.suites[0]
    del trainer, net, bank, policy
    ref = replay.evaluate(cfg, tr, common.path(tr["levels"]), weights,
                          steps, device, control=control)
    out = dict(program=judge.eval_readings(prog, ref, more=True))
    if control:
        low = ref["control"]
        out["control"] = judge.eval_readings(
            {k: v.cpu().numpy() for k, v in low.items()
             if k != "action_gap"}, dict(ref, action_gap=low["action_gap"]),
            more=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    a = ap.parse_args()
    for i, seed in enumerate(a.seeds):
        ctx = context(a.workload, seed)
        t0 = time.perf_counter()
        read = (eval_readings if ctx.traffic["entry"] == "eval"
                else train_readings)
        out = read(ctx, i < a.control_seeds)
        print(json.dumps(dict(workload=a.workload, seed=seed,
                              seconds=time.perf_counter() - t0, **out)),
              flush=True)


if __name__ == "__main__":
    main()
