"""The readings that the limits of ``correct`` are set from, for the cells
whose entries ``control.py`` does not know: ``train_gtrxl`` and
``train_dp4``.  As ``control.py``: the program's readings on many seeds,
and for the first ``--control-seeds`` seeds the control's (the reference
in the next precision down in the program's place) and planted faults'.

    python3 portbench/control_more.py --workload <cell> --seeds 1 2 3 ... \\
        [--control-seeds 3]

The GTrXL cell's faults: in the reference, a ring read one step off
(``shift``), a memory kept across an episode's end (``no_reset``) and a
learner that leaves half the batch out; in the program, a replay or a
rollout step one ring slot off (``replay_off``, ``rollout_off``).  The
four-rank cell's, in the reference beside the program's four ranks: the
half batch, and the gradient exchange left out (``no_exchange``: rank 0's
shard alone makes each step's loss and gradient).  Only the check batches
run.  The benchmark's runs never run this.
"""

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import control  # noqa: E402
from portbench.harness import judge  # noqa: E402
from portbench.reference import follow  # noqa: E402


def _gtrxl_program(ctx, device, fault=None):
    """The program's check batches, a planted ``fault`` in its core:
    ``replay_off`` replays each segment one ring slot off, ``rollout_off``
    steps one slot off.  Returns (check, logits, replay_gap, weights)."""
    from unittest import mock
    from safelife_torch.training.gtrxl import GTrXL
    from portbench.entries import train_gtrxl as G
    tr, steps = ctx.traffic, ctx.config["ppo"]["steps_per_env"]
    name = {"replay_off": "segment", "rollout_off": "step"}.get(fault)
    patch = contextlib.nullcontext()
    if name:
        real = getattr(GTrXL, name)

        def off(self, *a):
            *rings, length, head = a[-1]
            return real(self, *a[:-1], (*rings, length,
                                        (head + 1) % rings[0].shape[1]))
        patch = mock.patch.object(GTrXL, name, off)
    with patch:
        net, weights = G.make_net(ctx, device)
        trainer = G.make_trainer(ctx, device, net, tr["envs"])
        drive = G.Drive(trainer, tr["check_batches"]).run()
    out = (drive.check, drive.batch_logits(steps), drive.replay_gap(steps),
           weights)
    del trainer, net, drive
    _empty(device)
    return out


def gtrxl_readings(ctx, more):
    from portbench.entries import train_gtrxl as G
    tr, cfg = ctx.traffic, ctx.config
    device = ctx.torch_device()
    check, logits, replay_gap, weights = _gtrxl_program(ctx, device)
    ref = G.reference(cfg, tr, weights, check, device)
    out = dict(program=G.readings(logits, check, ref, weights, more=True,
                                  replay_gap=replay_gap))
    if more:
        for name, kw in (("control", dict(precision="low")),
                         ("shift", dict(fault="shift")),
                         ("no_reset", dict(fault="no_reset"))):
            other = G.reference(cfg, tr, weights, check, device, **kw)
            out[name] = G.readings(other["logits"], AsCheck(other), ref,
                                   weights, more=True)
            del other
            _empty(device)
        lrn = G.RG.learner(cfg, weights)
        half = follow.train(cfg, tr, _levels(tr), check.start, device, lrn,
                            carry=lrn.net.initial_carry(tr["envs"], device),
                            reset=lrn.net.reset, fault="half_batch")
        out["half_batch"] = G.readings(half["logits"], AsCheck(half), ref,
                                       weights, more=True)
        del half, lrn
        _empty(device)
        for fault in ("replay_off", "rollout_off"):
            fcheck, flogits, fgap, _ = _gtrxl_program(ctx, device, fault)
            out[fault] = G.readings(flogits, fcheck, ref, weights, more=True,
                                    replay_gap=fgap)
    return out


def dp4_readings(ctx, more):
    from portbench.entries import train_dp4 as D
    tr, cfg = ctx.traffic, ctx.config
    world = tr["ranks"]
    ctx.args.seconds = None
    ctx.traffic = tr = dict(tr, warmup_batches=0)
    drive, weights, device, start = D.check_batches(ctx)
    _empty(device)
    ref = D.reference(cfg, tr, weights, start, device, world)
    out = dict(program=judge.train_readings(drive.check.prog, ref, weights,
                                            more=True))
    if more:
        for name, kw, exchange in (
                ("control", dict(precision="low"), True),
                ("half_batch", dict(fault="half_batch"), True),
                ("no_exchange", {}, False)):
            lrn = D.sharded.ShardedLearner(cfg, weights, world,
                                           kw.get("precision", "f32"),
                                           exchange=exchange)
            other = follow.train(cfg, tr, _levels(tr), start, device, lrn,
                                 **kw)
            out[name] = judge.train_readings(other, ref, weights, more=True)
            del other
            _empty(device)
    return out


class AsCheck:
    """A reference run in the program's place, as ``readings`` takes a
    program's check batches."""

    def __init__(self, run):
        self.prog = run


def _levels(tr):
    from portbench.harness import common
    return common.path(tr["levels"])


def _empty(device):
    import torch
    if device.type == "cuda":
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    a = ap.parse_args()
    for i, seed in enumerate(a.seeds):
        ctx = control.context(a.workload, seed)
        t0 = time.perf_counter()
        read = (gtrxl_readings if ctx.traffic["entry"] == "train_gtrxl"
                else dp4_readings)
        out = read(ctx, i < a.control_seeds)
        print(json.dumps(dict(workload=a.workload, seed=seed,
                              seconds=time.perf_counter() - t0, **out)),
              flush=True)


if __name__ == "__main__":
    main()
