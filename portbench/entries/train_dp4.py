"""PPO training on four cards: ``Trainer.train`` on a data mesh of four
ranks, one a card, NCCL's gradient all-reduce between them (``launch
local --nproc 4``'s job).

This process is rank 0: it starts ranks 1-3 as ``launch local --nproc
4`` starts its ranks, through ``launch.run_processes`` with the SAFELIFE_*
variables of ``launch.rank_env`` and a deadline, so that each joins the
group as ``train`` does; a rank that fails, or the deadline, ends the run
and what it started.  Every rank drives its ``Trainer.train`` through the
same phases as ``train`` (check, warm-up, window, profile); the window ends
on rank 0's clock, which the others follow through a gloo broadcast at
each batch's start, so that all ranks run the same batches.  Rank 0
times the window and profiles; the rate counts every rank's env steps.
The ranks hand their check batches' records to rank 0, whose reference
replays the four shards as one batch with the shards' minibatch rows
(``reference/sharded.py``).

    SAFELIFE_COORDINATOR=... SAFELIFE_NUM_PROCS=4 SAFELIFE_PROC_ID=R \
        python3 portbench/entries/train_dp4.py --ctx <json>

runs rank R (the ``--ctx`` file: the run's arguments, configuration,
traffic and output folder).
"""

import argparse
import contextlib
import json
import os
import sys
import tempfile
import threading
import time
import traceback
import types

import numpy as np
import torch

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from portbench.entries import train as base  # noqa: E402
from portbench.harness import common, counts, judge, trace  # noqa: E402
from portbench.reference import env as RE  # noqa: E402
from portbench.reference import follow, sharded  # noqa: E402

# Past this many seconds over the window's, every rank is killed.
DEADLINE_S = 300
# A collective waits this long for the other ranks before it fails.
COLLECTIVE_TIMEOUT_S = 300
# How often a started rank looks whether rank 0 is still there.
PARENT_POLL_S = 0.5


def rank_device(ctx, rank):
    return (torch.device(ctx.place) if ctx.place is not None
            else torch.device("cuda", rank))


def make_trainer(ctx, device, net, mesh, world):
    """The ``Trainer`` of one rank: ``world`` shards of the traffic's
    ``envs`` environments, ``data_shards`` the world size."""
    from safelife_torch.training.driver import Trainer, TrainerConfig
    from safelife_torch.training.ppo import PPOConfig
    cfg, tr = ctx.config, ctx.traffic
    ppo = {k: tuple(v) if isinstance(v, list) else v
           for k, v in cfg["ppo"].items()}
    return Trainer(
        TrainerConfig(num_envs=world * tr["envs"],
                      view_shape=tuple(cfg["view_shape"]),
                      time_limit=tr["time_limit"],
                      impact_penalty=tr["impact_penalty"],
                      seed=ctx.args.seed, record_videos=False,
                      report_every=tr["report_every"]),
        PPOConfig(**dict(ppo, data_shards=world)),
        level_paths=(tr["levels"],), net=net, device=device, mesh=mesh)


class RankDrive(base.Drive):
    """``train.Drive`` on one rank: the window's end is rank 0's, every
    rank runs the profiled batches and only rank 0 profiles (with the
    gradient all-reduce spanned ``portbench.allreduce``)."""

    def __init__(self, trainer, rank, group, *a, **kw):
        super().__init__(trainer, *a, **kw)
        self.rank, self.group = rank, group
        if rank:
            self.spans = None

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

    def done(self):
        if self.phase != "window":
            return super().done()
        import torch.distributed as dist
        flag = torch.tensor([int(self.rank == 0 and super().done())])
        dist.broadcast(flag, 0, group=self.group)
        return bool(flag)

    def enter(self, i):
        if self.rank and i < len(self.plan) and self.plan[i][0] == "profile":
            self.stack.close()
            self.stack = contextlib.ExitStack()
            self.index, (self.phase, self.goal) = i, self.plan[i]
            self.count = 0
            return
        super().enter(i)
        if self.phase == "profile":
            from safelife_torch.parallel.mesh import DataMesh
            self.stack.enter_context(trace.Spans(sync=False).around(
                DataMesh, "average_gradients", "allreduce"))


def run_rank(ctx, rank, world, coordinator=None):
    """Join the group (at ``coordinator``, or where the SAFELIFE_*
    variables say), drive this rank's ``Trainer.train``; returns the drive
    (its check batches' records) and the device."""
    import torch.distributed as dist
    from safelife_torch.parallel import distributed
    device = rank_device(ctx, rank)
    where = (coordinator, world, rank) if coordinator else ()
    distributed.initialize(*where, device=device,
                           timeout=COLLECTIVE_TIMEOUT_S)
    group = dist.new_group(backend="gloo")
    mesh = distributed.make_global_mesh(device)
    net, weights = base.make_net(ctx, device)
    trainer = make_trainer(ctx, device, net, mesh, world)
    tr = ctx.traffic
    drive = RankDrive(trainer, rank, group, tr["check_batches"],
                      tr["warmup_batches"], ctx.args.seconds,
                      tr["profile_batches"] * ctx.args.trace,
                      ctx.setup_clock).run()
    return drive, weights, device


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cpu(v) for v in tree]
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def merge(starts, device):
    """The ranks' check records (``CheckBatches.start``, rank order) as
    one batch's: environments joined in shard order, the generator's
    state rank 0's (every rank draws the whole batch's numbers)."""
    starts = [_to(s, device) for s in starts]
    cat = torch.cat
    out = dict(init_idx=cat([s["init_idx"] for s in starts]),
               init_digest=cat([s["init_digest"] for s in starts]),
               batches=[])
    for b, first in enumerate(starts[0]["batches"]):
        mine = [s["batches"][b] for s in starts]
        steps = [{k: cat([m["steps"][t][k] for m in mine])
                  for k in first["steps"][t]}
                 for t in range(len(first["steps"]))]
        out["batches"].append(dict(
            steps=steps, fresh_idx=cat([m["fresh_idx"] for m in mine]),
            gen_after=first["gen_after"].cpu()))
    return out


def start_ranks(ctx, world, coordinator, folder, deadline):
    """Ranks 1 .. world-1: this file under ``launch.rank_env``'s
    variables, run by ``launch.run_processes`` in a thread, which stops
    them at the ``deadline`` (seconds).  A rank that fails, or the
    deadline, ends this process with its code.  Returns the thread."""
    from safelife_torch.scripts import launch
    spec = dict(workload=ctx.args.workload, seed=ctx.args.seed,
                seconds=ctx.args.seconds, trace=ctx.args.trace,
                config=ctx.config, traffic=ctx.traffic, cell=ctx.cell,
                place=ctx.place, out=folder)
    path = os.path.join(folder, "ctx.json")
    with open(path, "w") as fh:
        json.dump(spec, fh)
    cmd = [sys.executable, os.path.abspath(__file__), "--ctx", path]
    envs = [launch.rank_env(coordinator, world, r) for r in range(1, world)]

    def watch():
        code = launch.run_processes(cmd, envs, deadline)
        if code:
            why = "the deadline passed" if code == 124 else "a rank failed"
            print(f"portbench: {why} (exit {code})", file=sys.stderr,
                  flush=True)
            os._exit(code)
    thread = threading.Thread(target=watch, daemon=True)
    thread.start()
    return thread


def reference(cfg, tr, weights, start, device, world, precision="f32",
              fault=None):
    """The reference's run beside the merged check batches."""
    lrn = sharded.ShardedLearner(cfg, weights, world, precision)
    ref = follow.train(cfg, tr, common.path(tr["levels"]), start, device,
                       lrn, precision=precision)
    return ref


def check_batches(ctx):
    """Run every rank's ``Trainer.train`` through the cell's phases;
    returns (rank 0's drive, weights, device, the merged check records)."""
    from safelife_torch.parallel import distributed
    from safelife_torch.scripts import launch
    world = ctx.traffic["ranks"]
    coordinator = f"127.0.0.1:{launch._free_port()}"
    with tempfile.TemporaryDirectory() as folder:
        ranks = start_ranks(ctx, world, coordinator, folder,
                            (ctx.args.seconds or 0) + DEADLINE_S)
        try:
            drive, weights, device = run_rank(ctx, 0, world, coordinator)
            # Every rank leaves the group together: NCCL's communicators
            # finalise collectively, so a rank that waited for the others
            # to exit first would wait for ever.
            distributed.shutdown()
        except BaseException:
            # The other ranks would wait in a collective: end them all.
            traceback.print_exc()
            sys.stderr.flush()
            os._exit(1)
        ranks.join()
        others = [torch.load(os.path.join(folder, f"rank{r}.pt"),
                             weights_only=False) for r in range(1, world)]
    drive.t = None
    start = merge([drive.check.start] + others, device)
    return drive, weights, device, start


def run(ctx):
    cfg, tr = ctx.config, ctx.traffic
    world = tr["ranks"]
    drive, weights, device, start = check_batches(ctx)
    samples = world * tr["envs"] * cfg["ppo"]["steps_per_env"]
    local = tr["envs"] * cfg["ppo"]["steps_per_env"]
    per_batch = counts.least_seconds(counts.train_flops(
        cfg, local, cfg["ppo"]["epochs_per_batch"], local + tr["envs"]))
    ctx.attempted, ctx.failed = drive.batches, drive.failed
    ctx.e2e.update(
        train_env_steps_per_s=drive.batches * samples / drive.seconds,
        train_batch_ms_p90=float(np.percentile(drive.batch_ms(), 90)),
        setup_s=drive.setup_s)
    ctx.device = common.device_info(device, world, common.peak(device))
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
    ref = reference(cfg, tr, weights, start, device, world)
    judge.decide(ctx, judge.train_readings(drive.check.prog, ref, weights),
                 limits)


def _exit_with_parent():
    """End this rank once the process that started it is gone (rank 0
    ends itself where the others would wait for it in a collective)."""
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(PARENT_POLL_S)
        os._exit(1)
    threading.Thread(target=watch, daemon=True).start()


def _rank_main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ctx", required=True)
    a = ap.parse_args(argv)
    _exit_with_parent()
    with open(a.ctx) as fh:
        spec = json.load(fh)
    args = types.SimpleNamespace(workload=spec["workload"], seed=spec["seed"],
                                 seconds=spec["seconds"], trace=spec["trace"])
    ctx = common.Context(args=args, bench={}, cell=spec["cell"],
                         config=spec["config"], traffic=spec["traffic"],
                         setup_clock=time.perf_counter, place=spec["place"])
    rank = int(os.environ["SAFELIFE_PROC_ID"])
    drive, _, _ = run_rank(ctx, rank, ctx.traffic["ranks"])
    torch.save(_cpu(drive.check.start),
               os.path.join(spec["out"], f"rank{rank}.pt"))
    from safelife_torch.parallel import distributed
    distributed.shutdown()


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
