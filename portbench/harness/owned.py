"""Device time of the ops a benchmark span launched: the profile links
each device op to the innermost ``portbench.`` span open where its
launch was (``trace.profiling``), as ``readers.env_step_roofline`` reads
the env step's kernels."""

from . import readers


def device_ms(raw, kind, span):
    """Device milliseconds a unit of the ops launched inside the
    benchmark span ``span`` (its name without the prefix); None where the
    profile has none."""
    prof = readers.kernels(raw, kind)
    if prof is None:
        return None
    owner = "portbench." + span
    ns = sum(e - s for _, s, e, o, _ in prof["device"] if o == owner)
    return ns * 1e-6 / prof["units"] if ns else None
