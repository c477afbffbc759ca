"""The run: find the cell's files by name, check the card, run the entry,
read the metrics, print the result line."""

import argparse
import json
import os
import sys
import time

from . import common

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "safelife_tpu")


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules():
    """Loaded modules whose top-level name is one the benchmark keeps out."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def process_age(t_start):
    """Seconds since this process started (the kernel's start time; the
    interpreter's clock from the script's first line where there is none)."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        return (time.clock_gettime(time.CLOCK_BOOTTIME)
                - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter() - t_start


def main(argv, t_start):
    args = parse(argv)
    bench = common.load_bench()
    cell = common.find(bench["workloads"], args.workload, "workload")
    config = common.find(bench["configs"], cell["config"], "config")
    import torch
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark measures the card "
              "only", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    ctx = common.Context(
        args=args, bench=bench, cell=cell,
        config=common.load_json(config["file"]),
        traffic=common.load_json(
            os.path.join("portbench", "traffic", cell["traffic"] + ".json")),
        setup_clock=lambda: process_age(t_start))
    entry = common.load_module(
        os.path.join("portbench", "entries", ctx.traffic["entry"] + ".py"))
    entry.run(ctx)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    line = common.result_line(ctx)
    for name, value, limit in ctx.checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(line))
    return 0
