"""Profiling and tracing helpers (port of ``safelife_tpu.utils.profiling``).

The reference has no profiling support (SURVEY.md §5.1: only wall-clock
level times in interactive logs).  Here tracing is first-class: a
``torch.profiler`` trace context usable around any train or bench
section, a phase timer whose results land in the metrics stream, and the
program's own spans.

Spans name the program's phases (``ppo.rollout``, ``update.minibatch``,
``train.report``, ``eval.steploop``, ...)::

    with profiling.span("ppo.update"):
        ...

A span records ``(name, start_ns, end_ns, parent, thread)`` while tracing
is on: while a ``torch.profiler`` profile runs (:func:`trace`, or any
other), or inside :func:`recording`.  Its times are on the clock of the
profile's host events (:data:`clock_ns`), so a span can be joined with
the profile's device ops; under a profiler it also opens a record
function of its name, which shows the phases in TensorBoard or Perfetto.
Off, a span is one flag read and a shared no-op context.  Spans named
``setup.*`` run once a process and record whether tracing is on or not
(:func:`setup_seconds`).  No span synchronises or reads the device.
"""

import collections
import contextlib
import functools
import threading
import time

import torch
from torch.autograd import profiler as _profiler
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

# The clock of the profiler's host events (CLOCK_REALTIME, in ns).
clock_ns = time.time_ns
# The newest spans kept; older ones are dropped and counted.
CAPACITY = 1 << 20

Span = collections.namedtuple("Span", "name start_ns end_ns parent thread")

# One deque a field of the records: strings and ints, which the garbage
# collector does not track.  A tuple kept a span set its passes off, and
# each pass cost a profiled suite a fifth of its time.
_records = tuple(collections.deque(maxlen=CAPACITY) for _ in Span._fields)
_dropped = 0
_recording = 0  # open recording() blocks
_lock = threading.Lock()  # the records, the drop count, _recording
_open = threading.local()  # .names: this thread's open recorded spans
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(logdir):
    """Capture a ``torch.profiler`` trace of the host and, where a card is
    present, of the device; TensorBoard's profiler plugin reads the
    ``*.pt.trace.json`` file written under ``logdir`` (so does Perfetto),
    with the program's spans on the host's rows::

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


def span(name):
    """A context that records the span ``name`` while tracing is on (and
    always for ``setup.*``); see the module's docstring."""
    if _recording or _profiler._is_profiler_enabled or \
            name.startswith("setup."):
        return _Span(name)
    return _OFF


def spanned(name):
    """Decorator: each call of the function is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


class _Span:
    __slots__ = ("name", "parent", "start", "fn")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        names = getattr(_open, "names", None)
        if names is None:
            names = _open.names = []
        self.parent = names[-1] if names else None
        names.append(self.name)
        # A record function of the profiler's own (function) scope: it
        # labels the host's rows and adds no event on the device's.
        self.fn = None
        if _profiler._is_profiler_enabled:
            self.fn = torch._C._profiler._RecordFunctionFast(self.name)
            self.fn.__enter__()
        self.start = clock_ns()
        return self

    def __exit__(self, *exc):
        end = clock_ns()
        if self.fn is not None:
            self.fn.__exit__(*exc)
        _open.names.pop()
        thread = threading.get_ident()
        global _dropped
        with _lock:
            if len(_records[0]) == CAPACITY:
                _dropped += 1
            for column, value in zip(_records, (self.name, self.start, end,
                                                self.parent, thread)):
                column.append(value)
        return False


@contextlib.contextmanager
def recording():
    """Record spans inside the block, with no profiler running (for
    operators and tests)."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def spans():
    """The recorded spans, oldest first, each a :class:`Span`."""
    with _lock:
        return [Span(*row) for row in zip(*_records)]


def dropped():
    """Spans dropped from the full buffer since the last :func:`clear`."""
    return _dropped


def clear():
    """Forget the recorded spans (``setup.*`` ones included)."""
    global _dropped
    with _lock:
        for column in _records:
            column.clear()
        _dropped = 0


def setup_seconds(thread):
    """Seconds in ``thread``'s top-level ``setup.*`` spans (those inside
    no other ``setup.*`` span), by name."""
    setup = sorted((s for s in spans() if s.name.startswith("setup.")
                    and s.thread == thread),
                   key=lambda s: (s.start_ns, -s.end_ns))
    out, outer = {}, None
    for s in setup:
        if outer is not None and s.end_ns <= outer.end_ns:
            continue
        outer = s
        out[s.name] = out.get(s.name, 0.0) + (s.end_ns - s.start_ns) * 1e-9
    return out


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
    """Accumulates wall-clock per named phase, each also a :func:`span`
    of its name.  Device work is asynchronous, so with ``block=True`` a
    phase ends only when the CUDA work behind its results has: ``result``
    given at entry, and whatever the body appends to the list the phase
    yields::

        with timer.phase("rollout", block=True) as out:
            out.append(ppo.rollout(...)[2].obs)
    """

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def phase(self, name, result=None, block=False):
        with span(name):
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
