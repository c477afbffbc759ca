"""The reader of the GTrXL core's key/value cache refreshes on a synthetic
profile: the program's ``gtrxl.kv_refresh`` spans in the profiled stretch
a unit, and nothing read where the stretch has no refresh."""

import threading

import pytest

from portbench.harness import common
from safelife_torch.utils import profiling

MAIN = threading.main_thread().ident
READER = "portbench/metrics/kv_refreshes_per_batch.train.py"


def span(name, start, end, thread=MAIN):
    return profiling.Span(name, start, end, None, thread)


def batch(at, refresh=True):
    """A GTrXL batch's spans from ``at``: three rollout steps, the first
    refreshing the cache, then the update."""
    out = [span("ppo.rollout", at, at + 300)]
    for i in range(3):
        out.append(span("gtrxl.core", at + 100 * i, at + 100 * i + 90))
        if refresh and i == 0:
            out.append(span("gtrxl.kv_refresh", at + 10, at + 40))
    return out + [span("ppo.update", at + 300, at + 900)]


def raw(units, kind="train"):
    return {"kind": kind, "profile": dict(device=[], spans=[], units=units,
                                          window=(0, 10000))}


@pytest.fixture
def recorded(monkeypatch):
    """The tracer's records replaced by ``recorded[:]``."""
    held = []
    monkeypatch.setattr(profiling, "spans", lambda: list(held))
    return held


def test_counts_the_refreshes_a_batch(recorded):
    read = common.load_module(READER).read
    recorded[:] = batch(0) + batch(1000) + [
        span("gtrxl.kv_refresh", 20000, 20010),          # after the window
        span("gtrxl.kv_refresh", 100, 110, thread=MAIN + 1)]
    assert read(raw(2)) == 1.0
    recorded[:] = batch(0) + batch(1000, refresh=False) + batch(2000)
    assert read(raw(3)) == pytest.approx(2 / 3)
    assert read(raw(2, kind="eval")) is None
    assert read({"kind": "train"}) is None


def test_nothing_without_a_gtrxl_span_or_a_refresh(recorded):
    read = common.load_module(READER).read
    recorded[:] = [span("ppo.rollout", 0, 300), span("ppo.update", 300, 900)]
    assert read(raw(1)) is None
    # A program whose core projects the rings at every step.
    recorded[:] = batch(0, refresh=False) + batch(1000, refresh=False)
    assert read(raw(2)) is None
