"""Spans from the benchmark's side of the program's calls, and the
profiler's reading of a short steady stretch.

A span wraps a call of the program: with ``sync`` it ends with
``torch.cuda.synchronize()`` and times the call on the host clock; else it
is only a ``record_function`` range that labels the profile.  The profile
is read in memory (``kineto_results``), nothing is written to disk.
"""

import bisect
import collections
import contextlib
import sys
import time

import torch

PREFIX = "portbench."
WINDOW = PREFIX + "window"


class Spans:
    """Host durations of spans by name, and the patches that make them."""

    def __init__(self, sync):
        self.sync = sync
        self.seconds = collections.defaultdict(list)

    def wrap(self, name, fn):
        from torch.profiler import record_function

        def spanned(*args, **kw):
            with record_function(PREFIX + name):
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                if self.sync:
                    torch.cuda.synchronize()
                    self.seconds[name].append(time.perf_counter() - t0)
            return out
        return spanned

    @contextlib.contextmanager
    def around(self, owner, attr, name=None):
        """``owner.attr`` spanned as ``name`` inside the block."""
        fn = getattr(owner, attr)
        setattr(owner, attr, self.wrap(name or attr, fn))
        try:
            yield
        finally:
            setattr(owner, attr, fn)


def _classify(e):
    """Kind of a profiler event, read from its device and name (the
    event's own activity type is not in every PyTorch build): a span of
    the benchmark (``host_span`` or ``device_span``), a runtime call
    (``launch``), a device op (``kernel``, ``memcpy``, ``memset``), or
    ``other``."""
    name = e.name()
    on_device = e.device_type() != torch.autograd.DeviceType.CPU
    if name.startswith(PREFIX):
        return "device_span" if on_device else "host_span"
    if on_device:
        if name.startswith("Memcpy"):
            return "memcpy"
        if name.startswith("Memset"):
            return "memset"
        return "kernel"
    if name.startswith(("cuda", "cu")) and name != "cudaDeviceSynchronize":
        return "launch"
    return "other"


def profile(run):
    """Profile ``run()``; see ``profiling``."""
    with profiling() as out:
        run()
    return out


@contextlib.contextmanager
def profiling():
    """Profile the block (which ends with the device idle); the dict it
    yields holds, once the block has closed, what the readers read:
    device ops ``[(name, start_ns, end_ns, span, kind)]``, ``span`` the
    benchmark span that launched it (or None), the window ``(start_ns,
    end_ns)``, host spans ``[(name, start_ns, end_ns)]``."""
    from torch.profiler import ProfilerActivity, record_function
    out = {}
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield out
            torch.cuda.synchronize()
    out.update(_read(prof))


def _read(prof):
    host, gpu_spans, launches, device = [], [], {}, []
    for e in prof.profiler.kineto_results.events():
        kind = _classify(e)
        if kind == "host_span":
            host.append((e.name(), e.start_ns(), e.end_ns()))
        elif kind == "device_span":
            gpu_spans.append((e.name(), e.start_ns(), e.end_ns()))
        elif kind == "launch":
            launches[e.correlation_id()] = e.start_ns()
        elif kind != "other":
            device.append((e.name(), e.start_ns(), e.end_ns(),
                           e.correlation_id(), kind))
    window = next(((s, t) for n, s, t in host if n == WINDOW),
                  (min(d[1] for d in device), max(d[2] for d in device)))
    spans = [h for h in host if h[0] != WINDOW]
    by_host = SpanIndex(spans)
    by_device = SpanIndex([g for g in gpu_spans if g[0] != WINDOW])
    out = []
    for name, start, end, corr, kind in device:
        at = launches.get(corr)
        owner = (by_host.innermost(at) if at is not None
                 else by_device.innermost(start))
        out.append((name, start, end, owner, kind))
    out.sort(key=lambda d: d[1])
    print(f"portbench: profiled {len(device)} device ops, "
          f"{sum(o[3] is not None for o in out)} within a span, "
          f"{sum(c in launches for *_, c, _ in device)} linked to a launch, "
          f"{len(host)} host spans, {len(gpu_spans)} device spans",
          file=sys.stderr)
    return dict(device=out, window=window, spans=spans)


class SpanIndex:
    """Properly nested spans ``(name, start, end)``, searched for the
    innermost one holding a time."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda x: (x[1], -x[2]))
        self.starts = [x[1] for x in self.spans]
        self.parent, stack = [], []
        for i, (_, s, e) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][2] < s:
                stack.pop()
            self.parent.append(stack[-1] if stack else None)
            stack.append(i)

    def innermost(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        while i is not None and i >= 0:
            name, s, e = self.spans[i]
            if s <= t <= e:
                return name
            i = self.parent[i]
        return None


def busy(device, window):
    """Seconds of the window in which some device event ran."""
    lo, hi = window
    total, end = 0, lo
    for _, s, e, _, _ in device:
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total * 1e-9


def breakdown(device, window, spans, top=10):
    """The device's ten costliest ops by name and its ten longest idle gaps,
    each named by the benchmark span the host was in."""
    by_name = collections.Counter()
    for name, s, e, _, _ in device:
        by_name[name] += (e - s) * 1e-9
    gaps = []
    end = window[0]
    for _, s, e, _, _ in device:
        if s > end:
            gaps.append((s - end, end))
        end = max(end, e)
    if window[1] > end:
        gaps.append((window[1] - end, end))
    gaps.sort(reverse=True)
    index = SpanIndex(spans)
    return {"device_ops": [[n, t] for n, t in by_name.most_common(top)],
            "idle_gaps": [[index.innermost(at) or "outside spans", g * 1e-9]
                          for g, at in gaps[:top]]}
