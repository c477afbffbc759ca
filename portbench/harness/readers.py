"""What the per-layer readers share: each reads ``raw`` (what the entry
measured) and returns a number, or None where it finds nothing to read."""

import statistics

from . import counts, trace


def span_ms(raw, kind, names):
    """Mean milliseconds a unit of the synchronised spans ``names``."""
    spans = raw.get("spans", {})
    if raw.get("kind") != kind or not any(spans.get(n) for n in names):
        return None
    units = raw["window"]["units"]
    return 1e3 * sum(sum(spans.get(n, ())) for n in names) / units


def kernels(raw, kind):
    prof = raw.get("profile")
    if raw.get("kind") != kind or prof is None:
        return None
    return prof


def device_ms(raw, kind, match):
    """Device milliseconds a unit in the profiled stretch of the device
    ops ``match(name)`` picks."""
    prof = kernels(raw, kind)
    if prof is None:
        return None
    ns = sum(e - s for name, s, e, _, _ in prof["device"] if match(name))
    return ns * 1e-6 / prof["units"] if ns else None


def launches(raw, kind):
    prof = kernels(raw, kind)
    if prof is None:
        return None
    n = sum(1 for d in prof["device"] if d[4] == "kernel")
    return n / prof["units"] if n else None


def idle_pct(raw, kind):
    prof = kernels(raw, kind)
    if prof is None or prof["window"] is None:
        return None
    lo, hi = prof["window"]
    return 100.0 * (1.0 - trace.busy(prof["device"], prof["window"])
                    / ((hi - lo) * 1e-9))


def env_step_roofline(raw, kind):
    """The env step's least time (its bytes at the peak bandwidth) over
    the device time of the kernels launched inside it, in %."""
    prof = kernels(raw, kind)
    if prof is None:
        return None
    calls = sum(1 for name, _, _ in prof["spans"]
                if name == "portbench.env_step")
    ns = sum(e - s for _, s, e, owner, _ in prof["device"]
             if owner == "portbench.env_step")
    if not calls or not ns:
        return None
    least = calls * raw["env_step_bytes"] / counts.PEAK_BYTES
    return 100.0 * least / (ns * 1e-9)


def mfu(raw, kind):
    """Model FLOPs of the window's units at the peaks over its time, %."""
    w = raw.get("window")
    if raw.get("kind") != kind or not w or not w["units"]:
        return None
    return 100.0 * w["units"] * w["least_seconds"] / w["seconds"]


def mean_ms(raw, kind, key):
    if raw.get("kind") != kind or not raw.get(key):
        return None
    return 1e3 * statistics.fmean(raw[key])
