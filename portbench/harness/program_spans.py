"""The program's own spans (``safelife_torch.utils.profiling``) joined with
the profiled stretch.

The program records its spans in memory while a profiler runs, on the
clock of the profile's host events.  After the entry has run, the readers
take the main thread's spans that lie in the profiled window and put each
device gap, or each pageable copy, on the innermost program span that
holds its start (the rule ``trace.breakdown`` names gaps by).  A program
without the tracer, or a run without a profile, gives None.
"""

import collections
import sys
import threading

from . import trace

# The spans whose idle a training batch's metrics read; the eval's
# breakdown names its two timed phases.
TOPS = {"train": ("ppo.rollout", "ppo.update", "train.report"),
        "eval": ("eval.steploop", "eval.scoring")}
OTHER, OUTSIDE = "other spans", "outside spans"

_said = set()


def _profiling():
    """The program's tracer, or None where the program has none."""
    try:
        from safelife_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "spans") else None


def program_spans(raw, kind):
    """``(profile, [(name, start_ns, end_ns)])``: the profiled stretch and
    the main thread's program spans inside its window; None where there
    is no profile or no span."""
    prof = raw.get("profile") if raw.get("kind") == kind else None
    tracer = _profiling()
    if prof is None or prof.get("window") is None or tracer is None:
        return None
    lo, hi = prof["window"]
    main = threading.main_thread().ident
    spans = [(s[0], s[1], s[2]) for s in tracer.spans()
             if s[4] == main and lo <= s[1] and s[2] <= hi]
    return (prof, spans) if spans else None


# The benchmark's own spans (profile events) around the program's.
ANCHORS = {"portbench.rollout": "ppo.rollout",
           "portbench.rollout_recurrent": "ppo.rollout",
           "portbench.compute_gae": "ppo.gae",
           "portbench.update": "ppo.update",
           "portbench.env_step": "env.step"}


def say_clock(prof, spans, kind):
    """Print how far each program span starts after the benchmark's span
    around the same call (a profile event): the two clocks' agreement."""
    us = []
    for outer, inner in ANCHORS.items():
        hs = sorted(h[1] for h in prof["spans"] if h[0] == outer)
        ps = sorted(p[1] for p in spans if p[0] == inner)
        if hs and len(hs) == len(ps):
            us += [(p - h) * 1e-3 for h, p in zip(hs, ps)]
    if us:
        us.sort()
        _say(("clock", kind), f"program spans start {us[0]:.1f} to "
             f"{us[-1]:.1f} us (median {us[len(us) // 2]:.1f}) after the "
             f"benchmark's profile events around the same {len(us)} calls")


def gaps(device, window):
    """The window's stretches with no device op, ``[(start_ns, ns)]``;
    they add up to the window less ``trace.busy``."""
    lo, hi = window
    out, end = [], lo
    for _, s, e, _, _ in device:
        s, e = min(max(s, lo), hi), min(max(e, lo), hi)
        if s > end:
            out.append((end, s - end))
        end = max(end, e)
    if hi > end:
        out.append((end, hi - end))
    return out


def idle_ms(raw, kind):
    """Device idle ms a unit by the ``TOPS`` span holding each gap's start,
    the rest under ``OTHER`` (another program span) and ``OUTSIDE``; None
    without program spans."""
    found = program_spans(raw, kind)
    if found is None:
        return None
    prof, spans = found
    say_clock(prof, spans, kind)
    tops = trace.SpanIndex([s for s in spans if s[0] in TOPS[kind]])
    every = trace.SpanIndex(spans)
    out = dict.fromkeys(TOPS[kind] + (OTHER, OUTSIDE), 0.0)
    inner = collections.Counter()
    for at, ns in gaps(prof["device"], prof["window"]):
        name = every.innermost(at)
        out[tops.innermost(at) or (OTHER if name else OUTSIDE)] += ns
        inner[name or OUTSIDE] += ns
    scale = 1e-6 / prof["units"]
    out = {k: v * scale for k, v in out.items()}
    lo, hi = prof["window"]
    busy = trace.busy(prof["device"], prof["window"])
    _say(("idle", kind), "device idle ms a unit by program span: "
         f"{_fmt(out)}; sum {sum(out.values()):.3f}, profile "
         f"{((hi - lo) * 1e-9 - busy) * 1e3 / prof['units']:.3f}; innermost: "
         + _fmt({k: v * scale for k, v in inner.most_common(12)}))
    return out


def pageable_copies(raw, kind):
    """The profile's pageable copies a unit, where the program's spans
    cover the profiled stretch; None without program spans.  Standard
    error lists every copy by the innermost span holding its start
    (reads of one value, ``item()``, go through pinned memory: they wait
    as long, and are listed, not counted).  A copy is counted whatever
    span holds it: the device's clock may sit a little off the host's,
    which moves a copy issued at a span's edge into its neighbour or out
    of every span, but not out of the stretch."""
    found = program_spans(raw, kind)
    if found is None:
        return None
    prof, spans = found
    say_clock(prof, spans, kind)
    every = trace.SpanIndex(spans)
    by = collections.Counter(
        (every.innermost(start), name)
        for name, start, _, _, op in prof["device"] if op == "memcpy")
    units = prof["units"]
    _say(("copies", kind), "copies a unit by program span: "
         + ", ".join(f"{span or OUTSIDE} {name} {n / units:g}"
                     for (span, name), n in by.most_common()))
    return sum(n for (_, name), n in by.items() if "Pageable" in name) / units


def untimed_ms(raw):
    """Ms a suite of the eval's window outside ``run_benchmark``'s two
    timers, from the same run (printed; None without a window)."""
    w = raw.get("window") if raw.get("kind") == "eval" else None
    if not w or not w["units"] or not raw.get("suite_wall"):
        return None
    timed = [a + b for a, b in zip(raw["suite_wall"], raw["side_effect"])]
    ms = 1e3 * (w["seconds"] - sum(timed)) / w["units"]
    _say(("untimed", "eval"), f"window {1e3 * w['seconds'] / w['units']:.1f}"
         f" ms a suite, {ms:.1f} ms of it outside wall_time and "
         "side_effect_time")
    return ms


def self_ms(raw, kind, outer, inner):
    """Ms a unit of the ``outer`` spans not inside any ``inner`` span
    that they hold; None where there is no ``outer`` span."""
    found = program_spans(raw, kind)
    if found is None:
        return None
    prof, spans = found
    outers = [s for s in spans if s[0] == outer]
    if not outers:
        return None
    ns = sum(e - s for _, s, e in outers)
    ns -= sum(e - s for name, s, e in spans if name in inner and any(
        o[1] <= s and e <= o[2] for o in outers))
    return ns * 1e-6 / prof["units"]


def setup_s(raw, kind):
    """Seconds of the main thread in top-level ``setup.*`` spans, in a
    traced run; None where the program has no set-up spans."""
    tracer = _profiling()
    if raw.get("kind") != kind or raw.get("profile") is None or tracer is None:
        return None
    main = threading.main_thread().ident
    got = tracer.setup_seconds(main)
    if not got:
        return None
    builds = sum(s[2] - s[1] for s in tracer.spans()
                 if s[0] == "setup.kernels" and s[4] == main) * 1e-9
    _say(("setup", kind), "set-up spans: " + _fmt(got, "s")
         + f"; setup.kernels {builds:.3f} s in all, nested ones included")
    return sum(got.values())


def _fmt(values, unit="ms"):
    return ", ".join(f"{k} {v:.3f} {unit}" for k, v in values.items())


def _say(key, text):
    if key not in _said:
        _said.add(key)
        print(f"portbench: {text}", file=sys.stderr)
