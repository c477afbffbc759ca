"""What every entry shares: the files found by name, the run's context and
the result line."""

import dataclasses
import importlib.util
import json
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def path(rel):
    return os.path.join(ROOT, rel)


def load_json(rel):
    with open(path(rel)) as fh:
        return json.load(fh)


def load_bench():
    return load_json("BENCHMARK.json")


def find(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"portbench: no {what} named {name!r} in BENCHMARK.json")


def load_module(rel):
    """The Python file ``rel`` (under the checkout) as a module; file names
    may hold dots, as metric names do."""
    name = "portbench_" + rel.replace("/", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path(rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Context:
    """One run: its arguments and files in, and what the entry measured
    out.  ``raw`` holds what the per-layer readers read."""
    args: Any
    bench: dict
    cell: dict
    config: dict
    traffic: dict
    setup_clock: Callable[[], float]
    e2e: Dict[str, float] = dataclasses.field(default_factory=dict)
    raw: Dict[str, Any] = dataclasses.field(default_factory=dict)
    checks: List[Tuple[str, float, Any]] = dataclasses.field(
        default_factory=list)
    correct: Optional[bool] = None
    attempted: int = 0
    failed: int = 0
    device: Dict[str, Any] = dataclasses.field(default_factory=dict)
    breakdown: Optional[dict] = None
    place: Optional[str] = None  # a device for the CPU tests; else the card

    def torch_device(self):
        import torch
        if self.place is not None:
            return torch.device(self.place)
        return torch.device("cuda", torch.cuda.current_device())


def metrics_of(bench, cell_name, kind):
    """The ``kind`` metrics ("end_to_end" or "per_layer") a cell reports:
    those that list it, and those that list no cells, where a per-layer
    metric's cell reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def result_line(ctx):
    """The run's JSON result: the cell's end-to-end metrics with
    ``--trace 0``, its per-layer metrics (those a reader found) with
    ``--trace 1``."""
    metrics = {}
    if ctx.args.trace:
        for m in metrics_of(ctx.bench, ctx.cell["name"], "per_layer"):
            reader = load_module(os.path.join("portbench", "metrics",
                                              m["name"] + ".py"))
            value = reader.read(ctx.raw)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in metrics_of(ctx.bench, ctx.cell["name"], "end_to_end"):
            metrics[m["name"]] = {"value": float(ctx.e2e[m["name"]]),
                                  "unit": m["unit"]}
    line = {"correct": bool(ctx.correct), "attempted": int(ctx.attempted),
            "failed": int(ctx.failed), "metrics": metrics,
            "device": ctx.device}
    if ctx.args.trace and ctx.breakdown:
        line["breakdown"] = ctx.breakdown
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in ctx.checks}
    return line


def device_info(device, count, peak_bytes):
    import torch
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return {"platform": "gpu" if device.type == "cuda" else "cpu",
            "kind": kind, "count": count, "memory_peak_bytes": peak_bytes}


# The card's clock and memory, with plain stand-ins on the CPU (tests).

def sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def mark(device):
    """A point in the device's stream: a CUDA event, or the host clock."""
    import time
    import torch
    if device.type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def ms_between(a, b):
    if isinstance(a, float):
        return (b - a) * 1e3
    return a.elapsed_time(b)


def reset_peak(device):
    import torch
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak(device):
    import torch
    return (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else 0)


def empty_cache(device):
    import torch
    if device.type == "cuda":
        torch.cuda.empty_cache()
