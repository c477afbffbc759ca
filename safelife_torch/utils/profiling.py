"""Profiling and tracing helpers (port of ``safelife_tpu.utils.profiling``).

The reference has no profiling support (SURVEY.md §5.1: only wall-clock
level times in interactive logs).  Here tracing is first-class: a
``torch.profiler`` trace context usable around any train or bench
section, and a phase timer whose results land in the metrics stream.
"""

import contextlib
import time

import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler


@contextlib.contextmanager
def trace(logdir):
    """Capture a ``torch.profiler`` trace of the host and, where a card is
    present, of the device; TensorBoard's profiler plugin reads the
    ``*.pt.trace.json`` file written under ``logdir`` (so does Perfetto)::

        with profiling.trace("/tmp/trace") as prof:
            trainer.ppo.train_batch(...)

    Yields the profiler (``prof.key_averages()`` sums time by op, and
    ``prof.events()`` lists each event, after the block)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, acc_events=True,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def wait(result):
    """Wait for the CUDA work behind ``result`` (a tensor or a tuple, list
    or dict of them): a synchronize of each CUDA tensor's device."""
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (tuple, list)):
        for x in result:
            wait(x)
    elif isinstance(result, torch.Tensor) and result.device.type == "cuda":
        torch.cuda.synchronize(result.device)


class PhaseTimer:
    """Accumulates wall-clock per named phase.  Device work is
    asynchronous, so with ``block=True`` a phase ends only when the CUDA
    work behind its results has: ``result`` given at entry, and whatever
    the body appends to the list the phase yields::

        with timer.phase("rollout", block=True) as out:
            out.append(ppo.rollout(...)[2].obs)
    """

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def phase(self, name, result=None, block=False):
        t0 = time.perf_counter()
        out = []
        yield out
        if block:
            wait([result, out])
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self):
        return {name: {"total_s": round(total, 4),
                       "mean_ms": round(1e3 * total / self.counts[name], 3),
                       "count": self.counts[name]}
                for name, total in sorted(self.totals.items())}
