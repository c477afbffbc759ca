"""The GTrXL core's least time a batch (its model FLOPs at the bf16 peak;
a rollout step's the larger of those and its bytes at the peak
bandwidth: ``portbench/harness/gtrxl.py``) over the device time of the
ops launched inside its calls, in %."""

from portbench.harness import owned


def read(raw):
    ms = owned.device_ms(raw, "train", "gtrxl_core")
    least = raw.get("core_least_seconds")
    if ms is None or least is None:
        return None
    return 100.0 * least / (ms * 1e-3)
