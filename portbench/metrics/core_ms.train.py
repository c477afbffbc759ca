"""Device ms a training batch of the ops launched inside the GTrXL core's
calls (``GTrXL.step`` in the rollout, ``GTrXL.segment`` in the update's
forwards, spanned ``portbench.gtrxl_core``), from the profiled stretch."""

from portbench.harness import owned


def read(raw):
    return owned.device_ms(raw, "train", "gtrxl_core")
