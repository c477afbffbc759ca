"""The readers of the program's spans on a synthetic profile: device gaps
and pageable copies put on the innermost program span holding their
start, the suite's rest, the set-up seconds, and nothing read from a
program without the tracer."""

import threading
import types

import pytest

from portbench.harness import common, program_spans, trace
from safelife_torch.utils import profiling

MAIN = threading.main_thread().ident
HTOD = "Memcpy HtoD (Pageable -> Device)"
DTOH = "Memcpy DtoH (Device -> Pageable)"
DTOD = "Memcpy DtoD (Device -> Device)"


def span(name, start, end, thread=MAIN):
    return profiling.Span(name, start, end, None, thread)


def op(start, end, name="kernel", kind="kernel"):
    return (name, start, end, None, kind)


TRAIN_SPANS = [
    span("ppo.train_batch", 1000, 71000),
    span("ppo.rollout", 1000, 30000),
    span("env.step", 5000, 10000),
    span("ppo.gae", 31000, 39000),
    span("ppo.update", 40000, 70000),
    span("update.minibatch", 41000, 69000),
    span("train.report", 75000, 90000),
    span("report.gather", 76000, 80000),
    span("ppo.rollout", 0, 1, thread=MAIN + 1),     # another thread
    span("ppo.update", 200000, 300000),             # after the window
]
TRAIN_OPS = [op(2000, 4000), op(12000, 31000), op(45000, 60000),
             op(62000, 63000, HTOD, "memcpy"), op(80000, 85000),
             op(78000, 79000, DTOH, "memcpy"), op(95000, 96000, DTOH,
                                                   "memcpy"),
             op(50000, 51000, DTOD, "memcpy")]


def profile(ops, window, units):
    return dict(device=sorted(ops, key=lambda d: d[1]), window=window,
                spans=[], units=units)


@pytest.fixture
def recorded(monkeypatch):
    """The tracer's records replaced by ``recorded[:]``."""
    held = []
    monkeypatch.setattr(profiling, "spans", lambda: list(held))
    return held


def train_raw():
    return {"kind": "train",
            "profile": profile(TRAIN_OPS, (0, 100000), units=2)}


def test_idle_by_program_span(recorded):
    recorded[:] = TRAIN_SPANS
    raw = train_raw()
    idle = program_spans.idle_ms(raw, "train")
    # Each gap goes whole to the span holding its start: [0, 2000)
    # outside (the batch starts at 1000), [4000, 12000) the rollout,
    # [31000, 45000) GAE (another span), [60000, 62000) and [63000, 78000)
    # the update's minibatch, [79000, 80000) and [85000, 95000) the
    # report, [96000, 100000) outside.
    ns = {"ppo.rollout": 8000, "ppo.update": 2000 + 15000,
          "train.report": 1000 + 10000, "other spans": 14000,
          "outside spans": 2000 + 4000}
    assert idle == pytest.approx({k: v * 1e-6 / 2 for k, v in ns.items()})
    prof = raw["profile"]
    total = (100000 * 1e-9 - trace.busy(prof["device"], prof["window"]))
    assert sum(idle.values()) == pytest.approx(total * 1e3 / 2)


def test_pageable_copies_in_the_stretch(recorded):
    recorded[:] = TRAIN_SPANS
    # HtoD in the update, DtoH in the report and DtoH at 95000, outside
    # every span (the device's clock may sit off the host's) are counted;
    # DtoD is not pageable.
    assert program_spans.pageable_copies(train_raw(), "train") == 1.5


def test_suite_rest(recorded):
    recorded[:] = [span("eval.suite", 0, 100000),
                   span("eval.steploop", 10000, 60000),
                   span("eval.done", 20000, 21000),
                   span("eval.scoring", 70000, 90000),
                   span("scoring.coevolve", 70000, 80000)]
    raw = {"kind": "eval", "profile": profile([op(0, 5)], (0, 100000), 1)}
    assert program_spans.self_ms(
        raw, "eval", "eval.suite", ("eval.steploop", "eval.scoring")) == \
        pytest.approx(30000 * 1e-6)
    assert program_spans.self_ms(raw, "eval", "eval.nothing", ()) is None
    raw.update(window=dict(units=2, seconds=10.0), suite_wall=[3.0, 3.5],
               side_effect=[1.0, 0.5])
    assert program_spans.untimed_ms(raw) == pytest.approx(1000.0)


def test_nothing_without_the_tracer_or_a_profile(recorded, monkeypatch):
    recorded[:] = TRAIN_SPANS
    assert program_spans.idle_ms({"kind": "train"}, "train") is None
    assert program_spans.idle_ms(train_raw(), "eval") is None
    assert program_spans.setup_s({"kind": "train"}, "train") is None
    recorded[:] = [span("ppo.rollout", 0, 1, thread=MAIN + 1)]
    assert program_spans.pageable_copies(train_raw(), "train") is None
    recorded[:] = TRAIN_SPANS
    monkeypatch.setattr(program_spans, "_profiling", lambda: None)
    for reader in (program_spans.idle_ms, program_spans.pageable_copies,
                   program_spans.setup_s):
        assert reader(train_raw(), "train") is None


def test_setup_seconds_of_the_main_thread():
    profiling.clear()
    try:
        with profiling.span("setup.trainer"):
            with profiling.span("setup.kernels"):
                pass
        with profiling.span("setup.guard"):
            pass
        got = profiling.setup_seconds(MAIN)
        assert program_spans.setup_s(train_raw(), "train") == pytest.approx(
            got["setup.trainer"] + got["setup.guard"])
    finally:
        profiling.clear()


def test_the_result_line_reads_the_new_metrics(recorded):
    recorded[:] = TRAIN_SPANS
    bench = common.load_bench()
    cell = common.find(bench["workloads"], "cnn-train-append-still-4096",
                       "workload")
    ctx = common.Context(args=types.SimpleNamespace(trace=1), bench=bench,
                         cell=cell, config={}, traffic={},
                         setup_clock=lambda: 0.0)
    ctx.raw = train_raw()
    got = common.result_line(ctx)["metrics"]
    assert got["rollout_idle_ms.train"]["value"] == pytest.approx(8000e-6 / 2)
    assert got["update_idle_ms.train"]["value"] == pytest.approx(17000e-6 / 2)
    assert got["report_idle_ms.train"]["value"] == pytest.approx(11000e-6 / 2)
    assert got["blocking_copies_per_batch.train"] == {"value": 1.5,
                                                      "unit": "copies"}
